"""The port's pipeshard dispatch modes against the JAX package's.

Mirrors ``tests/runtime/test_register_dispatch.py``,
``tests/runtime/test_overlap_dispatch.py`` (its artifact-bound timing test
excluded) and ``tests/pipeline_parallel/test_instruction_streams.py``.  The
five modes ("sequential", "registers", "threaded", "overlap", "auto") give
bit-identical losses and parameters to each other, and the JAX package's
at fp32 tolerance (rtol 1e-5, atol 1e-6: sums in another order); "auto"
chooses what JAX's ``_launch`` chooses on the same fixtures; the stream
partition, the race checker, the dataflow graph and the overlap schedule
give JAX's results on the same inputs.  On the CPU the stage graphs run as
they are (CUDA graphs are the card's, ``chip_smoke.py``).
"""
import functools
import logging
import random

import jax
import numpy as np
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import testing as jtesting
from alpa_tpu.global_env import global_config as jconfig
from alpa_tpu.pipeline_parallel import layer_construction as jlc
from alpa_tpu.pipeline_parallel import runtime_emitter as jre
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu_torch import (AutoLayerOption, ManualLayerOption,
                            PipeshardParallel, UniformStageOption)
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.pipeline_parallel import runtime_emitter as tre

MODES = ("sequential", "registers", "threaded", "overlap", "auto")


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Restore torch's global RNG so these tests leave other tests' draws
    alone."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _restore_dispatch_knobs():
    saved = dict(vars(global_config))
    jsaved = (jconfig.pipeline_dispatch_mode, jconfig.overlap_resharding,
              jconfig.debug_dispatch_races)
    yield
    vars(global_config).update(saved)
    (jconfig.pipeline_dispatch_mode, jconfig.overlap_resharding,
     jconfig.debug_dispatch_races) = jsaved
    alpa_tpu_torch.shutdown()


# ---- end to end: the MLP fixture of the JAX dispatch tests ----

def _jax_fixture(num_stages=4):
    """The JAX tests' fixture (batch 8, width 8, 4 auto layers, 2
    microbatches) on one device per stage, and its numpy weights."""
    state, batch = jtesting.create_mlp_train_state_and_batch(
        batch_size=8, input_dim=8, hidden_dim=8, output_dim=8, num_layers=4,
        manual_pipeline_layer=False)
    method = alpa_tpu.PipeshardParallel(
        num_micro_batches=2, layer_option=jlc.AutoLayerOption(layer_num=4),
        stage_option=jstage.ManualStageOption(
            forward_stage_layer_ids=[[i] for i in range(num_stages)]
            if num_stages == 4 else [[0, 1, 2, 3]],
            submesh_physical_shapes=[(1, 1)] * num_stages))
    return state, batch, method


def _jax_steps(mode, n_steps=3, num_stages=4):
    alpa_tpu.init("local")
    jconfig.pipeline_dispatch_mode = mode
    state, batch, method = _jax_fixture(num_stages)
    step = jtesting.get_mlp_train_step(method, use_value_and_grad=True)
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return losses, state, step.get_last_executable()


def _numpy_fixture():
    state, batch, _ = _jax_fixture()
    return (jax.tree_util.tree_map(np.asarray, state.params),
            {k: np.asarray(v) for k, v in batch.items()})


def _port_steps(mode, n_steps=3, num_stages=4, races=False):
    global_config._pipeline_dispatch_mode = mode
    global_config.debug_dispatch_races = races
    params, batch = _numpy_fixture()
    state, tbatch = ttesting.create_mlp_train_state_and_batch(
        batch_size=8, input_dim=8, hidden_dim=8, output_dim=8, num_layers=4,
        params=params, x=batch["x"], y=batch["y"])
    method = PipeshardParallel(
        devices=["cpu"] * num_stages, num_micro_batches=2,
        layer_option=AutoLayerOption(layer_num=4),
        stage_option=UniformStageOption(num_stages))
    step = ttesting.get_mlp_train_step(method, use_value_and_grad=True)
    losses = []
    for _ in range(n_steps):
        state, loss = step(state, tbatch)
        losses.append(float(loss))
    return losses, state, step.get_last_executable()


def test_modes_bit_identical_and_equal_jax():
    """Every mode, 3 SGD-momentum steps of the 4-stage MLP: losses and
    parameters bit-identical across modes; equal to the JAX package's
    register dispatch at rtol 1e-5, atol 1e-6; each mode reports itself
    ("auto" as overlap)."""
    runs = {mode: _port_steps(mode) for mode in MODES}
    ref_losses, ref_state, _ = runs["sequential"]
    for mode, (losses, state, ex) in runs.items():
        assert ex.last_dispatch_stats["mode"] == (
            "overlap" if mode == "auto" else mode)
        assert losses == ref_losses, mode
        for k, p in state.params.items():
            assert torch.equal(p, ref_state.params[k]), (mode, k)
    j_losses, j_state, _ = _jax_steps("registers")
    np.testing.assert_allclose(ref_losses, j_losses, rtol=1e-5)
    from alpa_tpu_torch.model.convert import mlp_params_from_flax
    ttesting.assert_allclose(
        ref_state.params,
        mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                    j_state.params)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("overlap_resharding", [True, False])
@pytest.mark.parametrize("num_stages", [4, 1])
def test_auto_picks_what_jax_picks(num_stages, overlap_resharding):
    """"auto" on the JAX tests' fixture: overlap with cross-mesh RESHARDs on
    more than one mesh and ``overlap_resharding`` on, registers otherwise
    (one mesh, or the knob off), as JAX's ``_launch`` chooses."""
    jconfig.overlap_resharding = overlap_resharding
    global_config.overlap_resharding = overlap_resharding
    _, _, j_ex = _jax_steps("auto", n_steps=1, num_stages=num_stages)
    _, _, t_ex = _port_steps("auto", n_steps=1, num_stages=num_stages)
    assert t_ex.last_dispatch_stats["mode"] == \
        j_ex.last_dispatch_stats["mode"] == (
            "overlap" if num_stages > 1 and overlap_resharding
            else "registers")


def test_overlap_request_without_cross_mesh_uses_registers(caplog):
    """"overlap" on one mesh warns once and takes register dispatch, as
    JAX's does; an unknown mode raises."""
    _, _, ex = _port_steps("overlap", n_steps=2, num_stages=1)
    assert ex.last_dispatch_stats["mode"] == "registers"
    assert sum("nothing to overlap" in r.message
               for r in caplog.records) == 1
    global_config._pipeline_dispatch_mode = "eager"
    with pytest.raises(ValueError, match="pipeline_dispatch_mode"):
        ex._dispatch_mode()


def test_lowering_covers_every_instruction_and_stats():
    """The register program covers every instruction (one op each, fewer
    with coalesced groups), counts them by opcode, and the overlap program
    shares its slot numbering and dataflow graph; the stats have JAX's
    keys."""
    _, _, ex = _port_steps("registers", n_steps=2)
    prog = ex._register_program
    assert prog.n_instructions == len(ex.instructions)
    assert len(prog.ops) <= prog.n_instructions
    if prog.n_coalesced_groups == 0:
        assert len(prog.ops) == prog.n_instructions
    assert set(prog.by_opcode) == {"RUN", "RESHARD", "FREE"}
    assert sum(prog.by_opcode.values()) == prog.n_instructions
    assert prog.num_slots > 0
    st = ex.last_dispatch_stats
    assert st["mode"] == "registers" and st["per_inst_us"] > 0
    assert st["n_instructions"] == len(ex.instructions)
    _, _, ex = _port_steps("overlap", n_steps=2)
    st = ex.last_dispatch_stats
    assert st["n_cross_mesh"] > 0
    assert 0 < st["n_launches"] <= st["n_cross_mesh"]
    assert 0 <= st["n_hoisted"] <= st["n_cross_mesh"]
    assert st["overlap_window"] >= 1
    assert 0.0 <= st["overlap_fraction"] <= 1.0
    ovl = ex._register_programs["overlap"][0]
    reg = ex._program("registers", *ex._eager_tables(), None)
    assert ovl.slot_of == reg.slot_of
    assert ovl.n_instructions == reg.n_instructions
    assert ovl.graph.preds == reg.graph.preds


def test_threaded_matches_sequential_and_is_clean_under_the_detector():
    """``test_instruction_streams``' threaded cases: the 2-stage manual-layer
    MLP, 4 microbatches, 3 steps under the race detector, no violation,
    losses and parameters bit-identical to sequential, every instruction in
    exactly one stream."""
    results = {}
    for mode in ("sequential", "threaded"):
        global_config._pipeline_dispatch_mode = mode
        global_config.debug_dispatch_races = mode == "threaded"
        state, batch = ttesting.create_mlp_train_state_and_batch(
            batch_size=64, num_layers=4, manual_pipeline_layer=True)
        method = PipeshardParallel(
            devices=["cpu"] * 2, num_micro_batches=4,
            layer_option=ManualLayerOption(),
            stage_option=UniformStageOption(num_stages=2))
        step = ttesting.get_mlp_train_step(method, use_value_and_grad=True)
        for _ in range(3):
            state, loss = step(state, batch)
        ex = step.get_last_executable()
        assert ex.last_dispatch_stats["mode"] == mode
        st = ex._instruction_streams
        assert sorted(i for s in st.streams for i in s) == \
            list(range(len(ex.instructions)))
        results[mode] = (float(loss), state.params)
    assert results["sequential"][0] == results["threaded"][0]
    for k, p in results["sequential"][1].items():
        assert torch.equal(p, results["threaded"][1][k])


def test_shared_input_writes_wait_for_every_mesh():
    """The tied-embedding case: one tensor placed on two meshes of one
    device and written in place by an apply-grad graph.  The stream
    partition maps its keys to one (``key_alias``), so the write waits for
    the other mesh's readers."""
    from alpa_tpu_torch.model import gpt_model as tgm
    cfg = tgm.GPTConfig(hidden_size=32, num_layers=2, num_heads=2,
                        seq_len=16, vocab_size=64, pipeline_boundary_every=1)
    model = tgm.GPTModel(cfg, device="cpu", param_dtype=torch.float32)
    tgm.init_random_(model, 0)
    state = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(model),
                                  params=dict(model.named_parameters()),
                                  tx=tmu.sgd(1e-2))
    ids = np.random.default_rng(0).integers(0, 64, (4, 16))

    def step(state, batch):
        loss, grads = alpa_tpu_torch.value_and_grad(
            lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    global_config._pipeline_dispatch_mode = "threaded"
    global_config.debug_dispatch_races = True
    pstep = alpa_tpu_torch.parallelize(step, method=PipeshardParallel(
        devices=["cpu"] * 2, num_micro_batches=2,
        layer_option=ManualLayerOption(),
        stage_option=UniformStageOption(2)))
    pstep(state, {"input_ids": ids, "labels": ids})
    ex = pstep.get_last_executable()
    # the tied embedding is the one input both meshes read
    assert len(ex._key_alias) == 1, ex._key_alias
    (wte, _, _), = ex._key_alias
    streams = ex._instruction_streams
    for i, inst in enumerate(ex.instructions):
        if inst.opcode != tre.PipelineInstType.RUN or \
                inst.executable not in ex.apply_execs:
            continue
        writes = {inst.input_keys[p] for p in inst.executable.donate_idx}
        if any(k[0] is wte for k in writes):
            readers = [j for j, other in enumerate(ex.instructions[:i])
                       if other.opcode == tre.PipelineInstType.RUN and
                       streams.stream_of[j] != streams.stream_of[i] and
                       any(k[0] is wte for k in other.input_keys)]
            assert readers and set(readers) <= _ancestors(streams, i)


def _ancestors(streams, i):
    """Every instruction ``i`` waits for, through dependencies and stream
    order."""
    pos = {j: (m, k) for m, s in enumerate(streams.streams)
           for k, j in enumerate(s)}
    seen, todo = set(), [i]
    while todo:
        j = todo.pop()
        m, k = pos[j]
        preds = set(streams.deps.get(j, ())) | (
            {streams.streams[m][k - 1]} if k else set())
        for p in preds - seen:
            seen.add(p)
            todo.append(p)
    return seen


# ---- the stream partition and the race checker, against JAX's ----

def _programs(mod):
    """The synthetic programs of ``test_instruction_streams``, built with
    ``mod``'s instruction classes."""
    PIT, PI = mod.PipelineInstType, mod.PipelineInstruction

    def run(stage, mb, mesh, ins, outs, donate=()):
        class _FakeExec:
            donate_idx = tuple(donate)

        inst = PI(PIT.RUN, stage_id=stage, micro_batch=mb, dst_mesh=mesh,
                  input_keys=list(ins), output_keys=list(outs))
        inst.executable = _FakeExec()
        return inst

    def reshard(key, src, dst):
        return PI(PIT.RESHARD, var_key=key, src_mesh=src, dst_mesh=dst)

    raw = [run(0, 0, 0, [("x", 0)], [("a", 0)]), reshard(("a", 0), 0, 1),
           run(1, 0, 1, [("a", 0)], [("b", 0)])]
    anti = [run(0, 0, 0, [("p", -1)], [("a", 0)]),
            reshard(("p", -1), 0, 1),
            run(1, 1, 0, [("p", -1)], [("c", 1)], donate=(0,)),
            PI(PIT.FREE, free_keys=[("a", 0, 0)])]
    back = [run(0, mb, mb % 3, [("x", mb)], [(f"y{mb}", mb)])
            for mb in range(9)]
    back.insert(4, reshard(("y0", 0), 0, 2))
    rng = random.Random(7)
    fuzz = []
    for i in range(40):
        c = rng.random()
        mesh = rng.randrange(3)
        key = (f"v{rng.randrange(6)}", rng.randrange(2))
        if c < 0.5:
            fuzz.append(run(i, key[1], mesh, [key],
                            [(f"v{rng.randrange(6)}", key[1])],
                            donate=(0,) if rng.random() < 0.2 else ()))
        elif c < 0.85:
            fuzz.append(reshard(key, mesh, rng.randrange(3)))
        else:
            fuzz.append(PI(PIT.FREE, free_keys=[(key[0], key[1], mesh)]))
    return {"raw": (raw, 2), "anti": (anti, 2), "back": (back, 3),
            "fuzz": (fuzz, 3)}


@pytest.mark.parametrize("name", ["raw", "anti", "back", "fuzz"])
def test_partition_streams_equal_jax(name):
    """Streams and dependencies of the port's
    ``partition_streams`` equal JAX's on the same program; every edge points
    backward and across streams; independent pairs
    (``instructions_independent``) agree too."""
    tinsts, n = _programs(tre)[name]
    jinsts, _ = _programs(jre)[name]
    t, j = tre.partition_streams(tinsts, n), jre.partition_streams(jinsts, n)
    assert t.streams == j.streams
    assert t.deps == j.deps
    assert t.stream_of == j.stream_of
    for i, deps in t.deps.items():
        assert all(d < i and t.stream_of[d] != t.stream_of[i] for d in deps)
    for a in range(len(tinsts)):
        for b in range(len(tinsts)):
            assert tre.instructions_independent(tinsts[a], tinsts[b]) == \
                jre.instructions_independent(jinsts[a], jinsts[b])


@pytest.mark.parametrize("case", ["write_read", "serialized", "reads"])
def test_race_checker_verdicts_equal_jax(case):
    """``DispatchRaceChecker``: a cross-stream write and read at once is a
    violation, the same accesses one after the other are not, nor are
    concurrent reads; the port's checker reports what JAX's reports."""
    verdicts = []
    for mod in (tre, jre):
        insts = _programs(mod)["raw"][0][:2]
        if case == "reads":
            insts = [insts[0], _programs(mod)["raw"][0][0]]
            insts[1].output_keys = [("b", 0)]
        chk = mod.DispatchRaceChecker(insts, {0: 0, 1: 1})
        if case == "serialized":
            chk.end(0, chk.begin(0))
            chk.end(1, chk.begin(1))
        else:
            a0 = chk.begin(0)
            a1 = chk.begin(1)
            chk.end(0, a0)
            chk.end(1, a1)
        verdicts.append(len(chk.violations))
        if chk.violations:
            with pytest.raises(RuntimeError, match="raced"):
                chk.check()
        else:
            chk.check()
    assert verdicts[0] == verdicts[1] == (1 if case == "write_read" else 0)


# ---- the dataflow graph and the overlap schedule ----

def _random_program(mod, rng, n_ops):
    """``test_overlap_dispatch``'s random SSA program over slots."""
    nodes, live, next_slot = [], [], [0]

    def new_slot():
        next_slot[0] += 1
        return next_slot[0] - 1

    for idx in range(n_ops):
        c = rng.random()
        if not live or c < 0.45:
            k = min(len(live), rng.randrange(0, 3))
            reads = tuple(rng.sample(live, k)) if k else ()
            kills = ()
            if reads and rng.random() < 0.3:
                kills = (reads[rng.randrange(len(reads))],)
                for s in kills:
                    live.remove(s)
            writes = tuple(new_slot() for _ in range(rng.randrange(1, 3)))
            live.extend(writes)
            nodes.append(mod.DataflowNode(idx, "RUN", reads=reads,
                                          writes=writes, kills=kills))
        elif c < 0.85:
            src = rng.choice(live)
            dst = new_slot()
            live.append(dst)
            edge = (rng.randrange(4), rng.randrange(4))
            nodes.append(mod.DataflowNode(idx, "RESHARD", reads=(src,),
                                          writes=(dst,), edge=edge,
                                          cross_mesh=edge[0] != edge[1]))
        else:
            k = rng.randrange(1, min(3, len(live)) + 1)
            slots = tuple(rng.sample(live, k))
            for s in slots:
                live.remove(s)
            nodes.append(mod.DataflowNode(idx, "FREE", kills=slots))
    return nodes


def _check_replay(nodes, graph, plan, window):
    issued, retired, inflight = set(), set(), []
    for kind, i in plan:
        node = nodes[i]
        if kind in ("exec", "launch"):
            assert i not in issued
            assert all(p in retired for p in graph.preds[i])
            issued.add(i)
        if kind == "exec":
            touched = set(node.writes) | set(node.kills)
            for t in inflight:
                assert not set(nodes[t].reads) & touched
                assert not set(nodes[t].writes) & (touched | set(node.reads))
            retired.add(i)
        elif kind == "launch":
            assert node.cross_mesh
            inflight.append(i)
            assert len(inflight) <= window
        else:
            inflight.remove(i)
            retired.add(i)
    assert not inflight and issued == set(range(len(nodes)))
    execs = [i for k, i in plan if k == "exec"]
    assert execs == sorted(execs)


@pytest.mark.parametrize("seed", range(5))
def test_overlap_schedule_equals_jax_and_keeps_its_invariants(seed):
    """Random programs (``test_fuzz_graph_replay_invariants``' generator,
    5 seeds x 5 programs of 40 ops): the port's dataflow graph has JAX's
    edges, passes its static check, and ``schedule_overlap`` returns JAX's
    plan for windows 1, 2, 3 and 5, which keeps every replay invariant."""
    for k in range(5):
        tnodes = _random_program(tre, random.Random(1234 + 5 * seed + k), 40)
        jnodes = _random_program(jre, random.Random(1234 + 5 * seed + k), 40)
        tg = tre.InstructionDataflowGraph.build(tnodes)
        jg = jre.InstructionDataflowGraph.build(jnodes)
        assert tg.preds == jg.preds and tg.succs == jg.succs
        tg.check()
        for window in (1, 2, 3, 5):
            plan, hoisted = tre.schedule_overlap(tg, window)
            assert (plan, hoisted) == jre.schedule_overlap(jg, window)
            _check_replay(tnodes, tg, plan, window)
            assert 0 <= hoisted <= tg.n_cross_mesh


def test_graph_edges_cover_donation_and_check_finds_a_missing_edge():
    """A donating RUN and a FREE wait for the transfer that reads or writes
    their slot (JAX's case); ``check`` raises on a graph with that edge
    dropped."""
    DN = tre.DataflowNode
    nodes = [DN(0, "RUN", writes=(0,)),
             DN(1, "RESHARD", reads=(0,), writes=(1,), edge=(0, 1),
                cross_mesh=True),
             DN(2, "RUN", reads=(0,), writes=(2,), kills=(0,)),
             DN(3, "FREE", kills=(1,))]
    g = tre.InstructionDataflowGraph.build(nodes)
    assert 1 in g.preds[2] and 1 in g.preds[3]
    plan, _ = tre.schedule_overlap(g, 4)
    pos = {step: p for p, step in enumerate(plan)}
    assert pos[("wait", 1)] < pos[("exec", 2)]
    broken = tre.InstructionDataflowGraph(
        g.nodes, [g.preds[0], g.preds[1], (0,), g.preds[3]], g.succs)
    with pytest.raises(RuntimeError, match="write-after-read"):
        broken.check()


def test_reshard_groups_hop_frees_as_jax():
    """Registers-mode coalescing: the RESHARDs of one edge form one group
    past the FREEs between them, and a RESHARD touching a hopped FREE's
    slot ends the group, as the JAX package's ``reshard_group_extent``
    decides."""
    from alpa_tpu.analysis.superopt import reshard_group_extent

    def rec(kind, **kw):
        r = {"kind": kind, "groupable": True}
        r.update(kw)
        return r

    recs = [rec("RESHARD", edge=(0, 1), ss=0, ds=1),
            rec("FREE", slots=(5,)),
            rec("RESHARD", edge=(0, 1), ss=2, ds=3),
            rec("FREE", slots=(6,)),
            rec("RESHARD", edge=(0, 1), ss=6, ds=7),
            rec("RUN")]
    assert tre.reshard_group_extent(recs, 0) == \
        reshard_group_extent(recs, 0) == ([0, 2], [1, 3], 1, 4)


def test_captured_step_input_rules():
    """When a captured step runs again (its CUDA graphs replayed) rather
    than being captured anew: an input the graphs read where it is must come
    back at its address; an input copied into a buffer whose new value the
    last step handed back (a view of that buffer) may come back as that
    view, or as any tensor once the caller no longer holds the view, but
    not as another tensor while the caller holds it (refilling the buffer
    would overwrite the value the caller holds).  ``mismatches`` names the
    inputs that break each rule."""
    import gc
    import weakref

    from alpa_tpu_torch.pipeline_parallel import pipeshard_executable as pe
    step = object.__new__(pe._CapturedStep)
    direct, buf = torch.ones(4), torch.zeros(3)
    step.direct = {(0, 0): pe._signature(direct)}
    step.feedback, step.handed = [(1, 2, buf)], {}
    fresh = torch.full((3,), 2.0)
    assert step.mismatches([direct, None, fresh]) == (set(), set())
    assert step.mismatches([direct.clone(), None, fresh]) == ({0}, set())
    handed = buf.detach()
    step.handed[2] = weakref.ref(handed)
    assert step.mismatches([direct, None, handed]) == (set(), set())
    assert step.mismatches([direct, None, fresh]) == (set(), {2})
    del handed
    gc.collect()
    assert step.mismatches([direct, None, fresh]) == (set(), set())


class _FakeGraph:
    """A CUDA graph's stand-in on the CPU: the capture runs the stage (as
    the capture's own outputs), the replay right after it does nothing,
    later replays run the stage again and copy its outputs where the
    capture's outputs are."""

    def __init__(self):
        self.run, self.outs, self.fresh = None, None, True

    def replay(self):
        if self.fresh:
            self.fresh = False
            return
        for o, new in zip(self.outs, self.run()):
            if o is not None and o.data_ptr() != new.data_ptr():
                o.copy_(new)


@pytest.fixture
def fake_cuda_graphs(monkeypatch):
    """The CUDA calls of the graph path mocked on the CPU: streams, events
    and pools do nothing, and each ``CapturedRun`` holds a ``_FakeGraph``
    (its outputs held, not viewed, since CPU memory is not a pool)."""
    import contextlib

    from alpa_tpu_torch.pipeline_parallel import pipeshard_executable as pe

    class Stream:
        device = torch.device("cpu")

        def __init__(self, *args):
            pass

        def wait_stream(self, other):
            pass

        def wait_event(self, event):
            pass

    class Event:
        def record(self, stream=None):
            pass

    init = pe.CapturedRun.__init__

    def fake_init(self, stage, args, pool, stream):
        init(self, stage, args, pool, stream)
        graph = _FakeGraph()
        graph.run = functools.partial(stage, list(args))
        graph.outs = [spec[1] if spec[0] == "pool" else None
                      for spec in self._out_specs]
        self.graph = graph

    for name, fake in (
            ("CUDAGraph", lambda: None),
            ("graph", lambda *a, **k: contextlib.nullcontext()),
            ("graph_pool_handle", lambda: (0, 0)), ("Stream", Stream),
            ("Event", Event), ("synchronize", lambda *a: None),
            ("current_stream", lambda *a: Stream()),
            ("stream", lambda s: contextlib.nullcontext()),
            ("device", lambda d: contextlib.nullcontext())):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(pe, "_view_of", lambda t: t)
    monkeypatch.setattr(pe, "_pool_bytes", lambda pools: 0)
    monkeypatch.setattr(pe.CapturedRun, "__init__", fake_init)


def _gpt_pipeshard_fixture():
    """A 4-layer GPT with Adam under 2 stages x 4 microbatches on the CPU:
    ``(batch, make_state, pstep)``; ``pstep()`` parallelizes a fresh step."""
    from alpa_tpu_torch.model import gpt_model as tgm
    cfg = tgm.GPTConfig(hidden_size=64, num_layers=4, num_heads=4,
                        seq_len=32, vocab_size=128, pipeline_boundary_every=2,
                        attention_impl="flash")
    ids = torch.as_tensor(np.random.default_rng(0).integers(0, 128, (8, 32)))
    batch = {"input_ids": ids, "labels": ids}

    def make_state():
        model = tgm.GPTModel(cfg, device="cpu", param_dtype=torch.float32)
        tgm.init_random_(model, 0)
        return tmu.TrainState.create(apply_fn=tmu.make_apply_fn(model),
                                     params=dict(model.named_parameters()),
                                     tx=tmu.adam(1e-3))

    def step(state, batch):
        loss, grads = alpa_tpu_torch.value_and_grad(
            lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    def pstep():
        return alpa_tpu_torch.parallelize(step, method=PipeshardParallel(
            devices=["cpu"] * 2, num_micro_batches=4,
            layer_option=ManualLayerOption(),
            stage_option=UniformStageOption(2)))
    return batch, make_state, pstep


def test_graph_path_captures_once_and_replays_in_every_mode(
        fake_cuda_graphs):
    """The graph path's bookkeeping on the CPU (``fake_cuda_graphs``): a
    4-layer GPT with Adam, 2 stages x 4 microbatches, its batch on the
    device.  The first call runs uncaptured, the second captures, and every
    later call in every mode replays that one capture, also after a step
    run uncaptured (``_capture = False``) in between; losses and parameters
    are bit-identical to the same steps uncaptured.  The
    donated Adam moments that the apply-grad does not write in place (JAX's
    partition decays stage 1's on mesh 0) come back in the buffers the step
    reads them from, so the caller's state round-trips without a
    capture.  Both meshes share their device's one pool, and every RUN
    waits for the last RUN on the other mesh's stream before it, whose
    memory the pool may lend it."""
    batch, make_state, make_step = _gpt_pipeshard_fixture()
    runs = {}
    for graphs in (False, True):
        pstep = make_step()
        state = make_state()
        ex, _ = pstep.get_executable(state, batch)
        ex._use_graphs = graphs
        losses, ran = [], []
        for mode in ("auto", "auto") + MODES + ("uncaptured", "auto"):
            global_config._pipeline_dispatch_mode = (
                "sequential" if mode == "uncaptured" else mode)
            ex._capture = mode != "uncaptured"
            state, loss = pstep(state, batch)
            losses.append(float(loss))
            ran.append(ex.last_dispatch_stats["mode"])
        runs[graphs] = (losses, state.params, ran, ex)
    losses, params, ran, ex = runs[True]
    assert ran[:2] == ["sequential", "capture"] and ex.capture_count == 1
    assert ran[2:] == ["sequential", "registers", "threaded", "overlap",
                       "overlap", "sequential", "overlap"]
    assert ex.last_dispatch_stats["recaptures"] == 0
    assert losses == runs[False][0]
    for k, p in params.items():
        assert torch.equal(p, runs[False][1][k]), k
    captured = ex._captured
    assert captured.feedback
    assert list(captured.pools) == [torch.device("cpu")]
    stream_of = ex.get_instruction_streams().stream_of
    last_run = {}
    for idx in sorted(captured.runs):
        for s, j in last_run.items():
            if s != stream_of[idx]:
                assert j in captured.reuse_deps[idx], (idx, j)
        last_run[stream_of[idx]] = idx
    assert len(last_run) == 2


def test_an_input_that_moves_is_copied_in_after_one_recapture(
        fake_cuda_graphs, caplog):
    """A state passed as a fresh copy at every call (its tensors at new
    addresses, where the graphs read them in place): the step is captured
    again once, with one warning and counted in ``last_dispatch_stats``;
    from then on the state is copied into the step's buffers and the later
    calls replay.  Losses and parameters are bit-identical to the same
    calls uncaptured."""
    from torch.utils import _pytree as pytree
    batch, make_state, make_step = _gpt_pipeshard_fixture()

    def fresh(state):
        return pytree.tree_map(lambda x: x.clone() if isinstance(
            x, torch.Tensor) else x, state)

    runs = {}
    for graphs in (False, True):
        pstep = make_step()
        state = make_state()
        ex, _ = pstep.get_executable(state, batch)
        ex._use_graphs = graphs
        losses, stats = [], []
        with caplog.at_level(logging.WARNING):
            for _ in range(6):
                state, loss = pstep(fresh(state), batch)
                losses.append(float(loss))
                stats.append(dict(ex.last_dispatch_stats))
        runs[graphs] = (losses, state.params, stats, ex)
    losses, params, stats, ex = runs[True]
    assert [s["mode"] for s in stats] == ["sequential", "capture", "capture",
                                          "overlap", "overlap", "overlap"]
    assert stats[-1]["captures"] == ex.capture_count == 2
    assert stats[-1]["recaptures"] == ex.recapture_count == 1
    assert caplog.text.count("captured again") == 1
    assert ex._copy_in and not ex._captured.direct
    assert losses == runs[False][0]
    for k, p in params.items():
        assert torch.equal(p, runs[False][1][k]), k


def test_state_read_from_buffers_is_handed_back_without_a_recapture(
        fake_cuda_graphs):
    """When the graphs read the donated state from the step's own buffers
    (as on two cards, where the warm-up writes the second stage's state
    into copies on its card, so no state input is handed back where it
    came from), each state output goes back into the buffer of the input
    at its own flat position, written in place or copied, and the state
    the caller passes back is those buffers: later calls replay the one
    capture, bit-identical to the same calls uncaptured."""
    batch, make_state, make_step = _gpt_pipeshard_fixture()
    runs = {}
    for graphs in (False, True):
        pstep = make_step()
        state = make_state()
        ex, _ = pstep.get_executable(state, batch)
        ex._use_graphs = graphs
        losses = []
        for k in range(5):
            if k == 1:
                ex._returned_inputs = set()
            state, loss = pstep(state, batch)
            losses.append(float(loss))
        runs[graphs] = (losses, state.params, ex)
    losses, params, ex = runs[True]
    assert ex.capture_count == 1 and ex.recapture_count == 0
    step = ex._captured
    assert all(j == i for j, i, _ in step.feedback)
    in_place = {i for _, i, buf in step.feedback
                if any(buf is b for _, _, b in step.copy_loads) and
                i in {ex._input_index[e.invars[p]] for e in ex.apply_execs
                      if e is not None for p in e.aliased.values()}}
    assert in_place
    assert losses == runs[False][0]
    for k, p in params.items():
        assert torch.equal(p, runs[False][1][k]), k
