"""The port's intra-op methods over several devices against the JAX
package's, on the CPU.

JAX runs on the virtual CPU devices of the test process
(``jax.devices()[:N]``) and the port on ``devices=["cpu"] * N`` (the SPMD
executor, ``shard_parallel/spmd_partition.py``), from the same numpy
weights and batch.  Tolerances, fp32, 2 steps: losses rtol 1e-5; parameters 1e-5 of
each tensor's largest |value| (sums over devices in another order),
except, with Adam, where m / sqrt(v) meets a gradient that is zero up to
rounding: elements whose step-0 gradient is below 1e-2 of their tensor's
largest are held to Adam's bound, 2 x lr x steps (``_check_params``).

* The MLP (``testing.py``'s fixture, non-square layers, Adam) under
  ``DataParallel``, ``Zero2Parallel``, ``Zero3Parallel`` and the ILP's
  ``ShardParallel`` on 4 devices and on a forced (2, 2) mesh: against
  JAX's same method and the port's one-device step; every state leaf's
  per-device shard shape equals the JAX executable's where the two specs
  agree; ``DataParallel``'s only collectives are all-reduces, of the
  gradients' bytes and the loss's 4 (``util.count_communication_primitives``
  counts one per gradient).
* Gradient accumulation (``ShardParallel(num_micro_batches=2)``) on 4
  devices, ``get_3d_parallel_method(1, 2, 2, 1)``, and a batch the mesh
  does not divide (replicated, as JAX's rules make it).
* The traced remat block reads the state's parameters in its
  recomputation (a repaired fault: it read the module's own, kept as
  constants of the trace).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax.training import train_state as flax_train_state

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import testing as jtesting
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import mlp_params_from_flax
from alpa_tpu_torch.util import count_communication_primitives
from test_torch_auto_sharding import _jax_spec, _port_key

LR = 1e-3
STEPS = 2
BATCH, IN, HIDDEN, OUT = 256, 16, 64, 32


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


def _check_params(got, want, grads):
    """``got`` against ``want`` ({name: array}) by the module docstring's
    rule; ``grads``: the step-0 gradients."""
    bound = 2 * LR * STEPS
    for name, w in want.items():
        g = np.abs(grads[name])
        small = g < 1e-2 * g.max()
        diff = np.abs(got[name] - w)
        assert diff[~small].max(initial=0) <= 1e-5 * np.abs(w).max(), name
        assert diff[small].max(initial=0) <= bound, name


def _mlp(batch_size=BATCH):
    """(JAX state, JAX batch, port state, port batch, step-0 gradients) of
    the MLP with Adam, from the same numbers."""
    jstate, jbatch = jtesting.create_mlp_train_state_and_batch(
        batch_size=batch_size, input_dim=IN, hidden_dim=HIDDEN,
        output_dim=OUT)
    jstate = flax_train_state.TrainState.create(
        apply_fn=jstate.apply_fn, params=jstate.params, tx=optax.adam(LR))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate, tbatch = ttesting.create_mlp_train_state_and_batch(
        batch_size=batch_size, input_dim=IN, hidden_dim=HIDDEN,
        output_dim=OUT, params=params, x=np.asarray(jbatch["x"]),
        y=np.asarray(jbatch["y"]), tx=tmu.adam(LR))
    grads = jax.grad(lambda p: jnp.mean(
        (jstate.apply_fn(p, jbatch["x"]) - jbatch["y"]) ** 2))(jstate.params)
    grads = {k: v.numpy() for k, v in mlp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, grads)).items()}
    return jstate, jbatch, tstate, tbatch, grads


def _jax_step(state, batch):
    loss, grads = alpa_tpu.value_and_grad(lambda p: jnp.mean(
        (state.apply_fn(p, batch["x"]) - batch["y"]) ** 2))(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_step(state, batch):
    loss, grads = alpa_tpu_torch.value_and_grad(lambda p: torch.mean(
        (state.apply_fn(p, batch["x"]) - batch["y"]) ** 2))(state.params)
    return state.apply_gradients(grads=grads), loss


def _run(step, state, batch):
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return state, losses


def _port_params(state):
    return {k: v.numpy() for k, v in
            ttesting.gather_tree(state.params).items()}


def _jax_params(state):
    return {k: v.numpy() for k, v in mlp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, state.params)).items()}


def _nontrivial(spec, mesh_shape):
    return tuple(tuple(a for a in axes if mesh_shape[a] > 1)
                 for axes in spec)


def _shard_shapes_agree(jstate, tstate, mesh_shape):
    """Every state leaf whose spec equals JAX's has JAX's shard shape;
    returns how many leaves were compared."""
    from jax.tree_util import keystr, tree_flatten_with_path
    from torch.utils import _pytree as pytree
    port = {pytree.keystr(p): x for p, x in
            pytree.tree_flatten_with_path((tstate,))[0]}
    compared = 0
    for path, leaf in tree_flatten_with_path((jstate,))[0]:
        if not hasattr(leaf, "sharding") or not leaf.ndim:
            continue
        key, transposed = _port_key(keystr(path))
        got = port.get(key)
        if not isinstance(got, alpa_tpu_torch.DistributedArray):
            continue
        want = _jax_spec(leaf.sharding.spec, leaf.ndim)
        if transposed:
            want = want[::-1]
        if _nontrivial(want, mesh_shape) != _nontrivial(got.spec,
                                                        mesh_shape):
            continue
        shape = tuple(leaf.addressable_shards[0].data.shape)
        assert tuple(got.shards[0].shape) == (shape[::-1] if transposed
                                              else shape), key
        compared += 1
    return compared


METHODS = {
    "DataParallel": lambda d: dict(method="DataParallel", devices=d),
    "Zero2Parallel": lambda d: dict(method="Zero2Parallel", devices=d),
    "Zero3Parallel": lambda d: dict(method="Zero3Parallel", devices=d),
    "ShardParallel": lambda d: dict(method="ShardParallel", devices=d),
    "ShardParallel-2x2": lambda d: dict(method="ShardParallel", devices=d,
                                        shape=(2, 2)),
}


def _make(pkg, spec):
    kw = {"devices": spec["devices"]}
    if "shape" in spec:
        kw["auto_sharding_option"] = pkg.AutoShardingOption(
            logical_mesh_shape=spec["shape"])
    return getattr(pkg, spec["method"])(**kw)


@pytest.mark.parametrize("name", sorted(METHODS))
def test_mlp_method_on_four_devices_equals_jax(name):
    jstate, jbatch, tstate, tbatch, grads = _mlp()
    jstep = alpa_tpu.parallelize(_jax_step, method=_make(
        alpa_tpu, METHODS[name](jax.devices()[:4])))
    tstep = alpa_tpu_torch.parallelize(_port_step, method=_make(
        alpa_tpu_torch, METHODS[name](["cpu"] * 4)))
    jstate, j_losses = _run(jstep, jstate, jbatch)
    tstate, t_losses = _run(tstep, tstate, tbatch)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    _check_params(_port_params(tstate), _jax_params(jstate), grads)
    ex = tstep.get_last_executable()
    assert len(ex.devices) == 4 and ex.program is not None
    mesh_shape = tuple(ex.plan["shape"])
    compared = _shard_shapes_agree(jstate, tstate, mesh_shape)
    assert compared > 0
    # the one-device step from the same numbers
    _, _, ostate, obatch, _ = _mlp()
    ostate, o_losses = _run(alpa_tpu_torch.parallelize(
        _port_step, method=alpa_tpu_torch.ShardParallel(devices=["cpu"])),
        ostate, obatch)
    np.testing.assert_allclose(t_losses, o_losses, rtol=1e-5)
    _check_params(_port_params(tstate), _port_params(ostate), grads)
    if name == "DataParallel":
        counts = ex.get_collective_counts()
        assert set(counts) == {"all_reduce"}
        grad_bytes = sum(v.numel() * 4 for v in
                         ttesting.gather_tree(tstate.params).values())
        assert counts["all_reduce"]["bytes"] == grad_bytes + 4
        assert counts["all_reduce"]["backend"] == "plain"
        n_grads = len(tstate.params)
        assert count_communication_primitives(
            ex, ignore_scalar_all_reduce=True) == (n_grads, n_grads, 0, 0, 0)
    if name.startswith("Zero"):
        # optimizer state sharded, gradients reduce-scattered into it
        mu = tstate.opt_state[0]["mu"]
        assert all(any(v.spec) for v in mu.values())
        assert "reduce_scatter" in ex.get_collective_counts()


def test_grad_accumulation_on_four_devices_equals_jax():
    jstate, jbatch, tstate, tbatch, grads = _mlp()
    jstep = alpa_tpu.parallelize(_jax_step, method=alpa_tpu.ShardParallel(
        devices=jax.devices()[:4], num_micro_batches=2))
    tstep = alpa_tpu_torch.parallelize(
        _port_step, method=alpa_tpu_torch.ShardParallel(
            devices=["cpu"] * 4, num_micro_batches=2))
    jstate, j_losses = _run(jstep, jstate, jbatch)
    tstate, t_losses = _run(tstep, tstate, tbatch)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    _check_params(_port_params(tstate), _jax_params(jstate), grads)
    ex = tstep.get_last_executable()
    assert type(ex).__name__ == "GradAccMeshExecutable"
    assert ex.spmd is not None and ex.num_micro_batches == 2
    # the gradients are reduced in the apply-grad part, once per step
    compute = [st.record.kind for st in ex.program.parts["compute"]
               if st.kind == "collective"]
    assert "all_reduce" not in compute and "reduce_scatter" not in compute


def test_3d_method_degenerate_shard_parallel_equals_jax():
    """``get_3d_parallel_method(1, 2, 2, 1)``: ``ShardParallel`` on a
    (2, 2) logical mesh planned by rules, over 4 devices."""
    alpa_tpu.init(cluster="local", devices=jax.devices()[:4])
    jstate, jbatch, tstate, tbatch, grads = _mlp()
    jmethod = alpa_tpu.get_3d_parallel_method(1, 2, 2, 1)
    tmethod = alpa_tpu_torch.get_3d_parallel_method(1, 2, 2, 1,
                                                    devices=["cpu"] * 4)
    assert tmethod.as_option.logical_mesh_shape == \
        jmethod.as_option.logical_mesh_shape == (2, 2)
    jstate, j_losses = _run(alpa_tpu.parallelize(_jax_step, method=jmethod),
                            jstate, jbatch)
    tstep = alpa_tpu_torch.parallelize(_port_step, method=tmethod)
    tstate, t_losses = _run(tstep, tstate, tbatch)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    _check_params(_port_params(tstate), _jax_params(jstate), grads)
    assert tuple(tstep.get_last_executable().plan["shape"]) == (2, 2)


def test_batch_not_divisible_by_the_mesh_is_replicated():
    """A batch of 6 rows on 4 devices: the batch stays replicated, as
    JAX's rules leave it, and the steps still equal JAX's."""
    jstate, jbatch, tstate, tbatch, grads = _mlp(batch_size=6)
    jstep = alpa_tpu.parallelize(_jax_step, method=alpa_tpu.DataParallel(
        devices=jax.devices()[:4]))
    tstep = alpa_tpu_torch.parallelize(
        _port_step, method=alpa_tpu_torch.DataParallel(devices=["cpu"] * 4))
    jstate, j_losses = _run(jstep, jstate, jbatch)
    tstate, t_losses = _run(tstep, tstate, tbatch)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    _check_params(_port_params(tstate), _jax_params(jstate), grads)
    ex = tstep.get_last_executable()
    batch_specs = [s for s, b in zip(ex.in_specs, ex.avals)
                   if tuple(b[0]) in ((6, IN), (6, OUT))]
    assert batch_specs and all(not any(s) for s in batch_specs)


def test_traced_remat_block_reads_the_state_parameters():
    """GPT's per-block remat under a trace: the recomputation reads the
    parameters passed in, not the module's own (no parameter constants in
    the traced step).  Two accumulating (traced) steps from a copy of the
    state, whose module keeps its initial weights, equal two eager steps
    from the state itself."""
    from alpa_tpu_torch.shard_parallel.solver import trace_flat
    cfg = tgm.GPTConfig(hidden_size=32, num_layers=2, num_heads=2,
                        seq_len=8, vocab_size=64, remat_blocks=True,
                        attention_impl="flash")
    model = tgm.GPTModel(cfg, device="cpu", param_dtype=torch.float32)
    tgm.init_random_(model, 0)

    def state(copy):
        params = {k: (p.detach().clone() if copy else p)
                  for k, p in model.named_parameters()}
        return tmu.TrainState.create(apply_fn=tmu.make_apply_fn(model),
                                     params=params,
                                     tx=tmu.sgd(1e-1, momentum=0.9))

    def step(st, batch):
        loss, grads = alpa_tpu_torch.value_and_grad(lambda p: tmu.gpt_lm_loss(
            st.apply_fn, p, batch))(st.params)
        return st.apply_gradients(grads=grads), loss

    rng = np.random.default_rng(0)
    batch = {n: torch.from_numpy(rng.integers(0, 64, (4, 8)))
             for n in ("input_ids", "labels")}

    class Capture(alpa_tpu_torch.ParallelMethod):
        donates_in_place = False

        def compile_executable(self, fun, *, avals, batch_invars,
                               donated_invars):
            self.traced = trace_flat(fun, avals, torch.device("cpu"))
            raise StopIteration

    cap = Capture()
    with pytest.raises(StopIteration):
        alpa_tpu_torch.parallelize(step, method=cap)(state(True), batch)
    assert not [n for n in cap.traced.graph.nodes if n.op == "get_attr"]
    runs = []
    for copy, method in ((True, alpa_tpu_torch.ShardParallel(
            devices=["cpu"], num_micro_batches=2)),
                         (False, alpa_tpu_torch.ShardParallel(
                             devices=["cpu"]))):
        st = state(copy)
        pstep = alpa_tpu_torch.parallelize(step, method=method)
        for _ in range(2):
            st, loss = pstep(st, batch)
        runs.append(ttesting.gather_tree(st.params))
    for k, want in runs[1].items():
        torch.testing.assert_close(runs[0][k], want, rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
