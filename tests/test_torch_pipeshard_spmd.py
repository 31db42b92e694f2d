"""The two-level plan: pipeshard stages on submeshes of four devices, each
planned as the JAX package plans a stage, against the JAX package.

JAX runs ``PipeshardParallel`` on the test session's 8 virtual CPU
devices; the port on ``devices=["cpu"] * 8``.  Both split the mesh into two
stage meshes of four devices (``UniformStageOption(2)``, or
``get_3d_parallel_method(2, 2, 2, 2)``), from the same numpy weights and
batch, 2 microbatches, 1F1B.  Each stage of the port is planned by the
intra-op ILP (or, under ``enable_auto_sharding=False``, by the rules) and
run by the SPMD partitioner over its four devices; values move between
the meshes as tiles.  Tolerances, fp32, 2 SGD-momentum steps: losses rtol
1e-5, parameters 1e-5 of each tensor's largest |value| (sums over devices
and microbatches run in other orders).

The stages' input specs are compared as the tiles they put on each device
(so that a dim "sharded" over an axis of size 1 equals a replicated one),
per stage: the state leaves by path, the gradient accumulators (a backward
stage's; an apply-grad stage reads their sums) and the other values, each
as a sorted list of (shape, tiles): they are the same values on both
sides, in orders that may differ.  A backward stage's other inputs are
autograd's saved tensors, which are not JAX's residuals (ReLU saves its
output where JAX saves the mask ``x > 0``; the seed gradient reads the
loss for its shape; the layer norms save statistics and read their
parameters where JAX saves the normalised values), so their number
differs by design: they are held to one rule instead, that none is a view
of a stage input (ROADMAP C.6), and the backward's state to JAX's leaves.
``MLP_OPEN_DIFFERENCES`` and ``GPT_OPEN_DIFFERENCES`` name exactly the
stages whose specs differ from JAX's (none since ROADMAP C.5 and C.6 were
repaired and C.7 in the plan).
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state as flax_train_state
from jax.extend.core import Var as JaxVar

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import testing as jtesting
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.model import model_util as jmu
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.pipeline_parallel.layer_construction import \
    ManualLayerOption as JaxManualLayerOption
from alpa_tpu_torch import (AutoShardingOption, ManualLayerOption,
                            PipeshardParallel, UniformStageOption)
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.device_mesh import DistributedArray
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import (gpt_params_from_flax,
                                          mlp_params_from_flax)
from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import (
    MeshSharding, VirtualDistributedArray)

BATCH, DIM, LR = 16, 32, 1e-2
GPT = dict(hidden_size=64, num_layers=2, num_heads=2, seq_len=16,
           vocab_size=128)

#: (stage, "state", "accumulators" or "values") whose input specs differ
#: from JAX's, on the MLP: none.  Repaired (ROADMAP C.5, C.6): a backward
#: stage's in-place accumulator add is read as JAX's functional
#: ``add(g, acc)``, so the ILPs break the tie between a replicated and a
#: sharded accumulator alike; a backward stage reads the weight itself,
#: not the transpose a forward stage made of it (autograd's saved
#: ``t(W)``).
MLP_OPEN_DIFFERENCES = set()
#: on the 2-layer GPT, with either attention: none.  Repaired in the plan
#: (C.7): the hidden state entering the second stage is sharded on its
#: sequence dim, as JAX's ILP shards it, since the loss's reductions read
#: the rows a view merged as JAX's read its 3-D logits.  The partitioner
#: still runs a product on a merged ``B*S`` dim sharded on its outer part
#: only (ROADMAP A.3.2, "Also open"), so it reshards such a stage input
#: at its products; these specs are the ILP's plan, before that
GPT_OPEN_DIFFERENCES = {"reference": MLP_OPEN_DIFFERENCES,
                        "flash": MLP_OPEN_DIFFERENCES}


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _port_cluster():
    yield
    alpa_tpu_torch.shutdown()


@functools.lru_cache(maxsize=None)
def _jax_mlp():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    y = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    jmodel = jtesting.MLPModel(hidden_dim=DIM, output_dim=DIM, num_layers=4,
                               manual_pipeline_layer=True)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return jmodel, jax.tree_util.tree_map(np.asarray, params), x, y


def _mlp_states():
    jmodel, params, x, y = _jax_mlp()
    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        tx=optax.sgd(LR, momentum=0.9))
    t_state, _ = ttesting.create_mlp_train_state_and_batch(
        batch_size=BATCH, input_dim=DIM, hidden_dim=DIM, output_dim=DIM,
        num_layers=4, manual_pipeline_layer=True, params=params, x=x, y=y,
        tx=tmu.sgd(LR, momentum=0.9))
    return j_state, t_state, {"x": x, "y": y}


def _jax_mlp_step(state, batch):
    loss, grads = alpa_tpu.value_and_grad(lambda p: jnp.mean(
        (state.apply_fn(p, batch["x"]) - batch["y"]) ** 2))(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_mlp_step(state, batch):
    loss, grads = alpa_tpu_torch.value_and_grad(lambda p: torch.mean(
        (state.apply_fn(p, batch["x"]) - batch["y"]) ** 2))(state.params)
    return state.apply_gradients(grads=grads), loss


def _run(step, state, batch, steps=2):
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return state, losses


def _close(got, want, name=""):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * float(np.abs(want).max()),
                               err_msg=name)


def _tiles(shape, spec, mesh_shape):
    n = int(np.prod(mesh_shape))
    vda = VirtualDistributedArray.from_sharding(
        shape, MeshSharding(tuple(spec), tuple(mesh_shape), tuple(range(n))))
    return tuple(t.slices for t in vda.device_tiles)


def _jax_spec(partition_spec, ndim, names=("mesh0", "mesh1")):
    out = []
    for p in tuple(partition_spec):
        if p is None:
            out.append(())
        elif isinstance(p, str):
            out.append((names.index(p),))
        else:
            out.append(tuple(names.index(x) for x in p))
    return tuple(out + [()] * (ndim - len(out)))


def _port_key(jax_path):
    """(the port's path, whether its tensor is the transpose) of a JAX
    state leaf's path: flax ``Dense`` kernels are (in, out), ``Linear``
    weights (out, in) (``convert.py``)."""
    toks = [a or b or c for a, b, c in
            re.findall(r"\['([^']*)'\]|\.(\w+)|\[(\d+)\]", jax_path)]
    if toks[0] == "1":
        return f"[1]['{toks[1]}']", False
    if toks[1] == "step":
        return "[0].step", False
    if toks[1] == "params":
        kind, rest = None, toks[3:]
    else:
        kind, rest = toks[3], toks[5:]
    mods = []
    for t in rest[:-1]:
        m = re.fullmatch(r"h(\d+)", t) or re.fullmatch(r"Dense_(\d+)", t)
        mods.append((f"h.{m.group(1)}" if t.startswith("h")
                     else f"layers.{m.group(1)}") if m else t)
    leaf = rest[-1]
    name = {"kernel": "weight", "scale": "weight",
            "embedding": "weight"}.get(leaf, leaf)
    key = ".".join(mods + [name])
    if kind is None:
        return f"[0].params['{key}']", leaf == "kernel"
    return f"[0].opt_state[0]['{kind}']['{key}']", leaf == "kernel"


def _acc_keys(ex, paths):
    """Each accumulator, its sum and the gradient marker's output of an
    executable -> the port's path of the parameter whose gradient they
    carry ("loss" for the loss): the gradient marker passes the loss, then
    the gradients in the order of the parameters' ``paths``."""
    names = ["loss"] + list(paths)
    assert len(names) == len(ex.grad_pairs)
    out = {}
    for (pre, post), name in zip(ex.grad_pairs, names):
        out[post] = name
        if pre in ex.acc_info:
            acc, summed, _ = ex.acc_info[pre]
            out[acc] = out[summed] = name
    # the mean over microbatches that apply-grad reads in the marker
    # output's place
    if isinstance(ex, type(ex)) and hasattr(ex.grad_pairs[0][1], "users"):
        for post, name in list(out.items()):
            for u in getattr(post, "users", ()):
                if u.target is torch.ops.aten.div.Tensor:
                    out[u] = name
    else:
        for e in ex.apply_execs:
            for eqn in (e.comp.eqns if e is not None else ()):
                if eqn.primitive.name == "div" and eqn.invars[0] in out:
                    out[eqn.outvars[0]] = out[eqn.invars[0]]
    return out


def _stage_specs(jex, tex, jparams, tparams):
    """Per stage name, JAX's and the port's stage inputs: the state leaves
    and the accumulators by the port's path (a flax kernel's tiles
    transposed), the other values as a sorted list of (shape, tiles)."""
    kernels = {}
    jpaths = []
    for k, _ in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        key, transposed = _port_key("[0].params" + jax.tree_util.keystr(k))
        jpaths.append(key)
        kernels[key] = transposed
    jkeys = _acc_keys(jex, jpaths)
    tkeys = _acc_keys(tex, [f"[0].params['{n}']" for n in tparams])
    out = {}
    jexecs = jex.stage_execs + [e for e in jex.apply_execs if e is not None]
    texecs = tex.stage_execs + [e for e in tex.apply_execs if e is not None]
    # a value one apply-grad stage computes from a state leaf and another
    # reads (momentum x 0.9) is keyed by that leaf
    jpath = {v: p for e in jexecs for v, p in zip(e.invars, e._in_paths)
             if p}
    tpath = {v: p for e in texecs for v, p in zip(e.invars, e.in_paths)
             if p}
    for e in jex.apply_execs:
        for eqn in (e.comp.eqns if e is not None else ()):
            leaf = next((a for a in eqn.invars
                         if isinstance(a, JaxVar)
                         and a in jpath), None)
            if leaf is not None and eqn.outvars[0] not in jkeys:
                key, transposed = _port_key(jpath[leaf])
                jkeys[eqn.outvars[0]] = key + "*"
                kernels[key + "*"] = transposed
    for e in tex.apply_execs:
        for v in (e.invars if e is not None else ()):
            leaf = next((a for a in v.all_input_nodes if a in tpath), None)
            if leaf is not None and v not in tkeys:
                tkeys[v] = tpath[leaf] + "*"
    for je, te in zip(jexecs, texecs):
        assert je.name == te.name
        jshape = tuple(je.jax_mesh.devices.shape)
        jstate, jacc, jvals = {}, {}, []
        for v, sh, path in zip(je.invars, je.in_shardings, je._in_paths):
            shape = tuple(v.aval.shape)
            tiles = _tiles(shape, _jax_spec(sh.spec, len(shape)), jshape)
            key, transposed = _port_key(path) if path else \
                (jkeys.get(v), kernels.get(jkeys.get(v), False))
            if transposed:
                tiles = tuple(tuple(reversed(t)) for t in tiles)
            if path:
                jstate[key] = tiles
            elif key is not None:
                jacc[key] = tiles
            else:
                jvals.append((shape, tiles))
        tstate, tacc, tvals = {}, {}, []
        for v, sp, path in zip(te.invars, te.in_specs, te.in_paths):
            shape = tuple(v.meta["val"].shape)
            tiles = _tiles(shape, sp, tuple(te.logical_mesh.shape))
            if path:
                tstate[path] = tiles
            elif v in tkeys:
                tacc[tkeys[v]] = tiles
            else:
                tvals.append((shape, tiles))
        out[te.name] = ((jstate, jacc, sorted(jvals)),
                        (tstate, tacc, sorted(tvals)))
    return out


#: aten ops that only view their operand
_VIEW_OPS = {torch.ops.aten.t.default, torch.ops.aten.transpose.int,
             torch.ops.aten.permute.default, torch.ops.aten.view.default,
             torch.ops.aten._unsafe_view.default,
             torch.ops.aten.reshape.default,
             torch.ops.aten.unsqueeze.default, torch.ops.aten.squeeze.dim,
             torch.ops.aten.expand.default, torch.ops.aten.alias.default}


def _saved_input_views(tex):
    """Per backward stage of the port, the inputs that are a chain of
    views of a graph input or of another stage's input (autograd's saved
    ``t(W)``, ROADMAP C.6): the stage should read that input and view it
    itself."""
    execs = tex.stage_execs + [e for e in tex.apply_execs if e is not None]
    out = {}
    for e in tex.stage_execs:
        if not e.name.endswith("_bwd"):
            continue
        others = {v for o in execs if o is not e for v in o.invars}
        for v in e.invars:
            root = v
            while root.op == "call_function" and root.target in _VIEW_OPS:
                root = root.args[0]
            if root is not v and (root.op == "placeholder" or
                                  root in others):
                out.setdefault(e.name, []).append(str(v))
    return out


def _stage_input_bytes(tex):
    """Per stage of the port, the bytes of its inputs (whole values)."""
    return {e.name: sum(v.meta["val"].numel() * v.meta["val"].element_size()
                        for v in e.invars) for e in tex.stage_execs}


def _spec_differences(jex, tex, jparams, tparams):
    """(stage, "state", "accumulators" or "values") where the port's stage
    inputs differ from JAX's.  A backward stage's state: every leaf JAX's
    reads, under JAX's spec (the port's also reads the layer norms'
    parameters and the batch, which JAX's residuals replace).  Its values
    are autograd's saved tensors, not JAX's residuals (see the module
    docstring): not compared by spec, but none may be a view of a stage
    input (``_saved_input_views``)."""
    views = _saved_input_views(tex)
    differ = set()
    for name, (jside, tside) in _stage_specs(jex, tex, jparams,
                                             tparams).items():
        for kind, j, t in zip(("state", "accumulators", "values"),
                              jside, tside):
            if name.endswith("_bwd") and kind == "state":
                t = {k: v for k, v in t.items() if k in j}
            if name.endswith("_bwd") and kind == "values":
                if views.get(name):
                    differ.add((name, kind))
            elif j != t:
                differ.add((name, kind))
    return differ


def _mlp_methods(jax_option=None, port_option=None):
    jkw = ({} if jax_option is None else
           dict(default_auto_sharding_option=jax_option))
    tkw = ({} if port_option is None else
           dict(default_auto_sharding_option=port_option))
    return (alpa_tpu.PipeshardParallel(
        num_micro_batches=2, layer_option=JaxManualLayerOption(),
        stage_option=jstage.UniformStageOption(2), **jkw),
        PipeshardParallel(devices=["cpu"] * 8, num_micro_batches=2,
                          layer_option=ManualLayerOption(),
                          stage_option=UniformStageOption(2), **tkw))


def _compare_mlp(jmethod, tmethod):
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch = _mlp_states()
    jstep = alpa_tpu.parallelize(_jax_mlp_step, method=jmethod)
    tstep = alpa_tpu_torch.parallelize(_port_mlp_step, method=tmethod)
    j_state, j_losses = _run(jstep, j_state,
                             jax.tree_util.tree_map(jnp.asarray, batch))
    t_state, t_losses = _run(tstep, t_state, batch)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    want = mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                       j_state.params))
    got = ttesting.gather_tree(t_state.params)
    for name, w in want.items():
        _close(got[name].numpy(), w.numpy(), name)
    return jstep.get_last_executable(), tstep.get_last_executable(), \
        j_state, t_state


def test_mlp_two_stages_of_four_devices_equals_jax():
    jex, tex, j_state, t_state = _compare_mlp(*_mlp_methods())
    assert tex.num_meshes == 2 and tex.mesh_sizes == [4, 4]
    differ = _spec_differences(jex, tex, j_state.params, t_state.params)
    assert differ == MLP_OPEN_DIFFERENCES, differ ^ MLP_OPEN_DIFFERENCES
    stats = tex.last_dispatch_stats
    assert stats["meshes"] == ["spmd over 4 devices, uncaptured"] * 2
    # the state stays on its stage mesh between steps
    assert any(isinstance(p, DistributedArray)
               for p in t_state.params.values())
    assert tex.planned_resharding_bytes > 0
    assert tex.planned_resharding_bytes <= tex.naive_resharding_bytes
    assert tex.executed_resharding_bytes == 0   # one physical device


def test_backward_stage_takes_the_weight_not_its_saved_transpose(
        monkeypatch):
    """ROADMAP C.6: a backward stage reads each weight it needs itself,
    where autograd saved the forward stage's ``t(W)``, and views it in its
    own program (``computation._remake_views``); it then holds no more
    input bytes than with the saved views.  With the remaking switched
    off, the saved transposes come back as the backward stages' inputs
    (so the check sees them) and the weights leave their state."""
    from alpa_tpu_torch.pipeline_parallel import computation

    def stages():
        _, t_state, batch = _mlp_states()
        step = alpa_tpu_torch.parallelize(_port_mlp_step,
                                          method=_mlp_methods()[1])
        _run(step, t_state, batch, steps=1)
        ex = step.get_last_executable()
        reads = {e.name: {p for p in e.in_paths if "params" in p}
                 for e in ex.stage_execs if e.name.endswith("_bwd")}
        return _saved_input_views(ex), _stage_input_bytes(ex), reads

    views, nbytes, reads = stages()
    alpa_tpu_torch.shutdown()
    assert views == {}
    # each backward stage's layers past the first take the weight itself
    for name, layers in (("stage_0_bwd", [1]), ("stage_1_bwd", [2, 3])):
        for k in layers:
            assert f"[0].params['layers.{k}.weight']" in reads[name], name
    monkeypatch.setattr(computation, "_remake_views",
                        lambda *args: None)
    saved, saved_bytes, saved_reads = stages()
    assert set(saved) == {"stage_0_bwd", "stage_1_bwd"}
    assert all(t.startswith("t") for ts in saved.values() for t in ts)
    for name, got in nbytes.items():
        assert got <= saved_bytes[name], name
    assert reads["stage_1_bwd"] > saved_reads["stage_1_bwd"]


def test_3d_parallel_method_2222_equals_jax():
    """``get_3d_parallel_method(2, 2, 2, 2)`` (``tests/pipeline_parallel/
    test_pipeshard.py:89``): two stages, each on a (2, 2) logical mesh of
    its four devices, with every stage input replicated as the JAX
    package plans a stage without the ILP."""
    alpa_tpu.init(cluster="local")
    jmethod = alpa_tpu.get_3d_parallel_method(2, 2, 2, 2)
    tmethod = alpa_tpu_torch.get_3d_parallel_method(
        2, 2, 2, 2, devices=["cpu"] * 8)
    jex, tex, j_state, t_state = _compare_mlp(jmethod, tmethod)
    assert tex.mesh_sizes == [4, 4]
    for e in tex.stage_execs + [e for e in tex.apply_execs if e]:
        assert tuple(e.logical_mesh.shape) == (4, 1) and e.rule_based
        assert not any(any(sp) for sp in e.in_specs)
    for name, ((jstate, jacc, jvals), (tstate, tacc, tvals)) in \
            _stage_specs(jex, tex, j_state.params, t_state.params).items():
        for tiles in (list(jstate.values()) + list(tstate.values()) +
                      list(jacc.values()) + list(tacc.values()) +
                      [t for _, t in jvals + tvals]):
            assert len(set(tiles)) == 1, name   # every device holds all


def test_zero2_in_each_stage_shards_optimizer_state():
    """ZeRO-2 inside each stage (``tests/pipeline_parallel/
    test_zero_pipeshard.py``): the losses equal ZeRO off bit for bit, and
    each device holds a quarter of the optimizer state (the momentum),
    where with ZeRO off the ILP leaves some of it replicated.""" 
    _, t0, batch = _mlp_states()
    _, t2, _ = _mlp_states()
    off = alpa_tpu_torch.parallelize(_port_mlp_step, method=_mlp_methods(
        port_option=AutoShardingOption(zero_stage="0"))[1])
    on = alpa_tpu_torch.parallelize(_port_mlp_step, method=_mlp_methods(
        port_option=AutoShardingOption(zero_stage="2"))[1])
    t0, l0 = _run(off, t0, batch)
    t2, l2 = _run(on, t2, batch)
    assert l0 == l2

    def state_bytes(state):
        per_device, total = 0, 0
        for leaf in torch.utils._pytree.tree_leaves(state.opt_state):
            if isinstance(leaf, DistributedArray):
                per_device += leaf.shards[0].numel() * 4
                total += int(np.prod(leaf.shape)) * 4
            elif isinstance(leaf, torch.Tensor) and leaf.dim():
                per_device += leaf.numel() * 4
                total += leaf.numel() * 4
        return per_device, total

    _, total0 = state_bytes(t0)
    dev2, total2 = state_bytes(t2)
    assert total0 == total2 and dev2 * 4 == total2


@functools.lru_cache(maxsize=None)
def _flax_gpt():
    dummy = jnp.ones((BATCH // 2, GPT["seq_len"]), jnp.int32)
    model = jgm.GPTModel(jgm.GPTConfig(pipeline_boundary_every=1, **GPT))
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), dummy))


def _compare_gpt(attention_impl):
    """The narrow 2-layer GPT (a boundary after each block) in two stages
    of four devices, the ILP in each, 2 steps held to the JAX package's:
    both executables and the final states."""
    alpa_tpu.init(cluster="local")
    cfg = dict(attention_impl=attention_impl, pipeline_boundary_every=1,
               **GPT)
    params = _flax_gpt()
    jmodel = jgm.GPTModel(jgm.GPTConfig(**cfg))
    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        tx=optax.sgd(0.1, momentum=0.9))
    tcfg = tgm.GPTConfig(**cfg)
    tmodel = tgm.GPTModel(tcfg, device="cpu", param_dtype=torch.float32)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                                param_dtype=torch.float32))
    t_state = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(tmodel),
                                    params=dict(tmodel.named_parameters()),
                                    tx=tmu.sgd(0.1, momentum=0.9))
    rng = np.random.default_rng(0)
    batch = {n: rng.integers(0, GPT["vocab_size"], (BATCH // 2,
                                                    GPT["seq_len"]))
             for n in ("input_ids", "labels")}

    def jstep(state, batch):
        loss, grads = alpa_tpu.value_and_grad(
            lambda p: jmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    def tstep(state, batch):
        loss, grads = alpa_tpu_torch.value_and_grad(
            lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    jmethod, tmethod = _mlp_methods()
    jp = alpa_tpu.parallelize(jstep, method=jmethod)
    tp = alpa_tpu_torch.parallelize(tstep, method=tmethod)
    j_state, j_losses = _run(jp, j_state, {
        n: jnp.asarray(v, jnp.int32) for n, v in batch.items()})
    t_state, t_losses = _run(tp, t_state, {
        n: torch.from_numpy(v) for n, v in batch.items()})
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    want = gpt_params_from_flax(jax.tree_util.tree_map(
        np.asarray, j_state.params), tcfg, "cpu", param_dtype=torch.float32)
    got = ttesting.gather_tree(t_state.params)
    for name, w in want.items():
        _close(got[name].numpy(), w.numpy(), name)
    return jp.get_last_executable(), tp.get_last_executable(), j_state, \
        t_state


@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
def test_gpt_two_stages_of_four_devices_equals_jax(attention_impl):
    """The narrow GPT in two stages of four devices against the JAX
    package's (``_compare_gpt``); with the flash attention (JAX: its
    Pallas kernels in interpret mode; the port: the kernels' plain
    versions, run by each device on what its plan gives it)."""
    jex, tex, j_state, t_state = _compare_gpt(attention_impl)
    assert tex.mesh_sizes == [4, 4]
    differ = _spec_differences(jex, tex, j_state.params, t_state.params)
    want = GPT_OPEN_DIFFERENCES[attention_impl]
    assert differ == want, differ ^ want
    if attention_impl == "flash":
        for e in tex.stage_execs:
            ops = [str(n.target) for n in e.program.root.graph.nodes]
            kind = "flash_bwd" if "bwd" in e.name else "flash_fwd"
            assert sum(kind in o for o in ops) == 1, e.name
