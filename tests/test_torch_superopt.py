"""The port's certified superoptimizer against the JAX package's, and its
rewrites run on the CPU.

* On the same plan and the same analytic costs both packages search alike:
  the JAX package's instruction list of the 2-stage MLP is read into the
  port's instruction type (its values as fx-node-like keys of the same
  shapes and dtypes, its stages with the same donated inputs), both
  packages deoptimize it to the same order and their searches accept the
  same rewrite layout with the same simulated scores.
* A deoptimized port plan run under ``superopt_mode="auto"`` is searched,
  its rewrite accepted by the verdict gate, and the rewritten list run:
  losses and every parameter after 2 steps are bit-identical to the
  baseline plan's.  A second compile of the same plan replays the rewrite
  from the ``superopt`` cache namespace with zero search; "suggest"
  reports the rewrite and runs the baseline list.
* The registers-mode coalescer and the fusion family share one legality
  oracle, ``reshard_group_extent``, which caps a group at
  ``superopt_max_group``.
"""
import types

import numpy as np
import pytest
import torch

import alpa_tpu_torch
import torch_plan_pairs as pp
from alpa_tpu.analysis import superopt as jso
from alpa_tpu_torch import compile_cache
from alpa_tpu_torch.analysis import superopt as tso
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
    PipelineInstruction, PipelineInstType)
from alpa_tpu_torch.telemetry import calibration


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@pytest.fixture
def superopt():
    saved = (global_config.superopt_mode, global_config.superopt_max_group)
    compile_cache.reset_compile_cache()
    calibration.reset_calibration_store()
    yield global_config
    global_config.superopt_mode, global_config.superopt_max_group = saved
    compile_cache.reset_compile_cache()
    calibration.reset_calibration_store()


class _Key:
    """A value key of the port's kind: its value in ``meta["val"]``."""

    def __init__(self, val, name):
        self.meta = {"val": val}
        self.name = name

    def __repr__(self):
        return self.name


def _as_port(jax_insts):
    """The JAX package's instructions as the port's: each JAX value a key
    with its shape and dtype in ``meta["val"]``, each stage its donated
    inputs."""
    keys, stages = {}, {}

    def key(v):
        if id(v) not in keys:
            aval = v.aval
            keys[id(v)] = _Key(torch.empty(
                tuple(aval.shape), dtype=getattr(torch, str(aval.dtype)),
                device="meta"), str(v))
        return keys[id(v)]

    def stage(ex):
        if id(ex) not in stages:
            stages[id(ex)] = types.SimpleNamespace(
                donate_idx=tuple(getattr(ex, "donate_idx", ()) or ()))
        return stages[id(ex)]

    out = []
    for i in jax_insts:
        kind = PipelineInstType[i.opcode.name]
        if kind == PipelineInstType.RUN:
            out.append(PipelineInstruction(
                kind, stage_id=i.stage_id, micro_batch=i.micro_batch,
                input_keys=[(key(v), n) for v, n in i.input_keys],
                output_keys=[(key(v), n) for v, n in i.output_keys],
                dst_mesh=i.dst_mesh, info=i.info,
                executable=stage(i.executable)))
        elif kind == PipelineInstType.RESHARD:
            out.append(PipelineInstruction(
                kind, var_key=(key(i.var_key[0]), i.var_key[1]),
                src_mesh=i.src_mesh, dst_mesh=i.dst_mesh, info=i.info))
        else:
            out.append(PipelineInstruction(
                kind, free_keys=[(key(k[0]), k[1], k[2])
                                 for k in i.free_keys]))
    return out


@pytest.mark.parametrize("name", ["mlp2-1f1b", "mlp4-gpipe"])
def test_same_plan_same_costs_same_rewrite(superopt, name):
    jex, _ = pp.plan_pair(name)
    jinsts = list(jex.instructions)
    tinsts = _as_port(jinsts)
    n = jex.num_meshes
    jdeopt = jso.deoptimize_instructions(jinsts)
    tdeopt = tso.deoptimize_instructions(tinsts)
    order = [jinsts.index(i) for i in jdeopt]
    assert [tinsts.index(i) for i in tdeopt] == order
    jres = jso.superopt_search(jdeopt, n, jso._CostModel())
    tres = tso.superopt_search(tdeopt, n, tso._CostModel())
    def score(s):
        return (s.makespan_us, tuple(s.peak_bytes))

    assert tres[0] == jres[0]                      # the best layout
    assert score(tres[1]) == score(jres[1])        # the baseline's score
    assert score(tres[2]) == score(jres[2])        # the best score
    assert [(c[0], score(c[1])) for c in tres[4]] == \
        [(c[0], score(c[1])) for c in jres[4]]     # the gate's pool
    assert tres[4], "no admissible strict improvement"
    assert tres[2].makespan_us < tres[1].makespan_us


def _port_plan(name="mlp2-1f1b"):
    _, state, batch = pp.states(name)
    step = alpa_tpu_torch.parallelize(pp.steps(name)[1],
                                      method=pp.methods(name)[1])
    batch = pp.port_batch(batch)
    ex, _ = step.get_executable(state, batch)
    return step, ex, state, batch


def _two_steps(step, state, batch):
    losses = []
    for _ in range(2):
        state, loss = step(state, batch)
        losses.append(loss)
    return losses, state.params


def test_auto_recovers_a_deoptimized_plan_bitwise(superopt):
    step, ex, state, batch = _port_plan()
    want_losses, want = _two_steps(step, state, batch)

    superopt.superopt_mode = "auto"
    step, ex, state, batch = _port_plan()
    baseline = list(ex.instructions)
    ex._set_instructions(tso.deoptimize_instructions(baseline),
                         as_baseline=True)
    got_losses, got = _two_steps(step, state, batch)
    out = ex._superopt_outcome
    assert out is not None and out.accepted and out.searched
    assert not out.cache_hit
    assert out.critical_path_delta_us < 0 or out.peak_bytes_delta < 0
    assert out.fingerprint != out.baseline_fingerprint
    assert ex.instructions is out.instructions or \
        ex.instructions == list(out.instructions)
    for a, b in zip(got_losses, want_losses):
        assert torch.equal(a, b)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert ex.get_plan_verdict().ok
    assert "accepted=True" in ex.get_superopt_text()

    # a second compile of the same plan replays the rewrite: zero search
    step2, ex2, state2, batch2 = _port_plan()
    ex2._set_instructions(tso.deoptimize_instructions(list(
        ex2.instructions)), as_baseline=True)
    losses2, got2 = _two_steps(step2, state2, batch2)
    out2 = ex2._superopt_outcome
    assert out2.cache_hit and not out2.searched and out2.accepted
    assert out2.fingerprint == out.fingerprint
    assert ex2.get_plan_fingerprint() == ex.get_plan_fingerprint()
    for k in want:
        assert torch.equal(got2[k], want[k]), k
    stats = compile_cache.get_compile_cache().stats()["namespaces"]
    assert stats["superopt"]["hits"] >= 1


def test_suggest_reports_and_runs_the_baseline(superopt):
    superopt.superopt_mode = "suggest"
    step, ex, state, batch = _port_plan()
    deopt = tso.deoptimize_instructions(list(ex.instructions))
    ex._set_instructions(deopt, as_baseline=True)
    _two_steps(step, state, batch)
    out = ex._superopt_outcome
    assert out.accepted and out.mode == "suggest"
    assert ex.instructions == deopt


def test_the_coalescer_and_the_fusion_family_share_one_oracle(superopt):
    from alpa_tpu.analysis.superopt import \
        reshard_group_extent as jax_extent
    from alpa_tpu_torch.pipeline_parallel import runtime_emitter

    def rec(kind, **kw):
        r = {"kind": kind, "groupable": True}
        r.update(kw)
        return r

    recs = [rec("RESHARD", edge=(0, 1), ss=0, ds=1),
            rec("RESHARD", edge=(0, 1), ss=2, ds=3),
            rec("RESHARD", edge=(0, 1), ss=4, ds=5, groupable=False),
            rec("RESHARD", edge=(0, 1), ss=6, ds=7)]
    assert runtime_emitter.reshard_group_extent is tso.reshard_group_extent
    for cap in (0, 1, 2):
        assert tso.reshard_group_extent(recs, 0, max_members=cap) == \
            jax_extent(recs, 0, max_members=cap)
    # the 4-stage MLP's grouped weight RESHARDs split at the cap
    _, ex, _, _ = _port_plan("mlp4-1f1b")
    groups = {}
    for cap in (0, 1):
        superopt.superopt_max_group = cap
        prog = pp.port_lower(ex, ex.instructions)
        groups[cap] = prog.n_coalesced_groups
        assert prog.verdict.ok
    assert groups[0] > 0 and groups[1] == 0
    assert np.isfinite(float(groups[0]))
