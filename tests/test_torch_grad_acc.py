"""Gradient accumulation: the port's ``ShardParallel(num_micro_batches=k)``
against the JAX package's.

The same numpy weights and batch go through both packages, each on one
device (JAX: one virtual CPU device; the port: the CPU), with Adam (lr
1e-3) for 2 steps, k in {2, 4}.  Tolerances, fp32: losses rtol 1e-5;
parameters 1e-5 of each tensor's largest |value| (sums over microbatches
in a different order), except where Adam's m / sqrt(v) meets a gradient
that is zero up to rounding (a step of up to lr with a sign the order of
sums decides): elements whose gradient is below 1e-2 of their tensor's
largest are held to Adam's bound, 2 x lr x steps, as ``chip_smoke.py``'s
``param_diffs`` holds them (the step-0 gradients: the port's, for the
GPT).  The GPT is narrow (hidden 64, 2 heads, seq
16, vocab 128, 2 layers, batch 8) with the flash attention: JAX runs its
Pallas kernels in interpret mode, the port the kernels' plain versions.
"""
import functools

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
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.model import model_util as jmu
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import (gpt_params_from_flax,
                                          mlp_params_from_flax)

LR = 1e-3
STEPS = 2
GPT = dict(hidden_size=64, num_layers=2, num_heads=2, seq_len=16,
           vocab_size=128)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


def _jax_method(k):
    return alpa_tpu.ShardParallel(devices=jax.devices()[:1],
                                  num_micro_batches=k)


def _port_method(k):
    return alpa_tpu_torch.ShardParallel(devices=["cpu"], num_micro_batches=k)


def _run(step, state, batch):
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return state, losses


def _check_params(got, want, grads):
    """``got`` against ``want`` ({name: array}) by the rule of the module
    docstring; ``grads``: the step-0 gradients."""
    bound = 2 * LR * STEPS
    for name, w in want.items():
        g = np.abs(grads[name])
        small = g < 1e-2 * g.max()
        diff = np.abs(got[name] - w)
        assert diff[~small].max(initial=0) <= 1e-5 * np.abs(w).max(), name
        assert diff[small].max(initial=0) <= bound, name


def _jax_step(state, batch, loss_fn):
    loss, grads = alpa_tpu.value_and_grad(
        lambda p: loss_fn(state.apply_fn, p, batch))(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_step(state, batch, loss_fn):
    loss, grads = alpa_tpu_torch.value_and_grad(
        lambda p: loss_fn(state.apply_fn, p, batch))(state.params)
    return state.apply_gradients(grads=grads), loss


def _mse(apply_fn, p, batch, mean=jnp.mean):
    return mean((apply_fn(p, batch["x"]) - batch["y"]) ** 2)


def _mlp_states():
    jstate, jbatch = jtesting.create_mlp_train_state_and_batch(
        batch_size=16, input_dim=16, hidden_dim=32, output_dim=16)
    jstate = flax_train_state.TrainState.create(
        apply_fn=jstate.apply_fn, params=jstate.params, tx=optax.adam(LR))
    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate, tbatch = ttesting.create_mlp_train_state_and_batch(
        batch_size=16, input_dim=16, hidden_dim=32, output_dim=16,
        params=params, x=np.asarray(jbatch["x"]), y=np.asarray(jbatch["y"]),
        tx=tmu.adam(LR))
    return jstate, jbatch, tstate, tbatch


@pytest.mark.parametrize("k", [2, 4])
def test_mlp_grad_acc_equals_jax(k):
    jstate, jbatch, tstate, tbatch = _mlp_states()
    j_grads = jax.grad(lambda p: _mse(jstate.apply_fn, p, jbatch))(
        jstate.params)
    jstep = alpa_tpu.parallelize(
        functools.partial(_jax_step, loss_fn=_mse), method=_jax_method(k))
    tstep = alpa_tpu_torch.parallelize(
        functools.partial(_port_step, loss_fn=functools.partial(
            _mse, mean=torch.mean)), method=_port_method(k))
    jstate, j_losses = _run(jstep, jstate, jbatch)
    tstate, t_losses = _run(tstep, tstate, tbatch)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    want = {k_: v.numpy() for k_, v in mlp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params)).items()}
    grads = {k_: v.numpy() for k_, v in mlp_params_from_flax(
        jax.tree_util.tree_map(np.asarray, j_grads)).items()}
    _check_params({k_: v.numpy() for k_, v in tstate.params.items()}, want,
                  grads)
    assert type(tstep.get_last_executable()).__name__ == \
        "GradAccMeshExecutable"


@functools.lru_cache(maxsize=None)
def _flax_gpt_params():
    dummy = jnp.ones((8, GPT["seq_len"]), jnp.int32)
    return jax.jit(jgm.GPTModel(jgm.GPTConfig(**GPT)).init)(
        jax.random.PRNGKey(0), dummy)


@pytest.mark.parametrize("remat", [False, True], ids=["remat-off",
                                                      "remat-on"])
@pytest.mark.parametrize("k", [2, 4])
def test_gpt_grad_acc_equals_jax(k, remat):
    """The narrow 2-layer GPT: losses, parameters after 2 Adam steps, and
    the flash ops of the compute-grad graph, which runs once per
    microbatch: a forward per block (two with remat: the backward
    recomputes the block) and a backward per block."""
    cfg = dict(attention_impl="flash", remat_blocks=remat, **GPT)
    # copies: the JAX step donates the arrays it is given
    params = jax.tree_util.tree_map(jnp.array, _flax_gpt_params())
    jmodel = jgm.GPTModel(jgm.GPTConfig(**cfg))
    jstate = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply, params=params, tx=optax.adam(LR))
    tcfg = tgm.GPTConfig(**cfg)
    tmodel = tgm.GPTModel(tcfg, device="cpu", param_dtype=torch.float32)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                                param_dtype=torch.float32))
    tstate = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(tmodel),
                                   params=dict(tmodel.named_parameters()),
                                   tx=tmu.adam(LR))
    rng = np.random.default_rng(0)
    batch = {n: rng.integers(0, GPT["vocab_size"], (8, GPT["seq_len"]))
             for n in ("input_ids", "labels")}
    jbatch = {n: jnp.asarray(v, jnp.int32) for n, v in batch.items()}
    tbatch = {n: torch.from_numpy(v) for n, v in batch.items()}
    _, t_grads = alpa_tpu_torch.value_and_grad(lambda p: tmu.gpt_lm_loss(
        tstate.apply_fn, p, tbatch))(tstate.params)
    jstep = alpa_tpu.parallelize(
        functools.partial(_jax_step, loss_fn=jmu.gpt_lm_loss),
        method=_jax_method(k))
    tstep = alpa_tpu_torch.parallelize(
        functools.partial(_port_step, loss_fn=tmu.gpt_lm_loss),
        method=_port_method(k))
    jstate, j_losses = _run(jstep, jstate, jbatch)
    tstate, t_losses = _run(tstep, tstate, tbatch)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    convert = functools.partial(gpt_params_from_flax, config=tcfg,
                                device="cpu", param_dtype=torch.float32)
    want = {n: v.numpy() for n, v in convert(
        jax.tree_util.tree_map(np.asarray, jstate.params)).items()}
    grads = {n: v.numpy() for n, v in t_grads.items()}
    _check_params({n: v.numpy() for n, v in tstate.params.items()}, want,
                  grads)
    ex = tstep.get_last_executable()
    ops = [str(n.target) for n in ex.compute_exec.module.graph.nodes]
    layers = GPT["num_layers"]
    assert ops.count("alpa_tpu_torch.flash_fwd.default") == \
        (2 if remat else 1) * layers
    assert ops.count("alpa_tpu_torch.flash_bwd.default") == layers
    assert ex.num_micro_batches == k


def test_donated_state_is_updated_in_place():
    """The apply-grad graph writes the new parameters and moments into the
    donated state's tensors; the old state is deleted."""
    _, _, tstate, tbatch = _mlp_states()
    def ptrs(state):
        """The parameters' and the Adam moments' storages."""
        moments = state.opt_state[0]
        return {x.data_ptr() for tree in (state.params, moments["mu"],
                                          moments["nu"])
                for x in tree.values()}

    before = ptrs(tstate)
    step = alpa_tpu_torch.parallelize(
        functools.partial(_port_step, loss_fn=functools.partial(
            _mse, mean=torch.mean)), method=_port_method(2))
    new, _ = step(tstate, tbatch)
    assert ptrs(new) == before
    with pytest.raises(RuntimeError, match="donated"):
        step(tstate, tbatch)


@pytest.mark.parametrize("method", ["3d", "data_parallel"])
def test_one_device_methods_accumulate(method):
    """``get_3d_parallel_method(4, 1, 1, 1)`` and
    ``DataParallel(num_micro_batches=4)`` run on one device and equal the
    eager full-batch step (losses rtol 1e-5, parameters by the rule
    above, against the eager step's own gradients)."""
    if method == "3d":
        make = alpa_tpu_torch.get_3d_parallel_method(4, 1, 1, 1,
                                                     devices=["cpu"])
    else:
        make = alpa_tpu_torch.DataParallel(devices=["cpu"],
                                           num_micro_batches=4)
    loss_fn = functools.partial(_port_step, loss_fn=functools.partial(
        _mse, mean=torch.mean))
    _, _, s_acc, batch = _mlp_states()
    _, _, s_ref, _ = _mlp_states()
    _, grads = alpa_tpu_torch.value_and_grad(lambda p: _mse(
        s_ref.apply_fn, p, batch, mean=torch.mean))(s_ref.params)
    acc = alpa_tpu_torch.parallelize(loss_fn, method=make)
    ref = alpa_tpu_torch.parallelize(
        loss_fn, method=alpa_tpu_torch.ShardParallel(devices=["cpu"]))
    s_acc, l_acc = _run(acc, s_acc, batch)
    s_ref, l_ref = _run(ref, s_ref, batch)
    np.testing.assert_allclose(l_acc, l_ref, rtol=1e-5)
    _check_params({n: v.numpy() for n, v in s_acc.params.items()},
                  {n: v.numpy() for n, v in s_ref.params.items()},
                  {n: v.numpy() for n, v in grads.items()})
    assert acc.get_last_executable().num_micro_batches == 4


def test_multi_device_mesh_raises_after_planning(monkeypatch):
    """On two devices the ILP plans the full-batch step once, and the step
    then runs over both devices with accumulation, equal to the
    one-device accumulating step (the name is the one from before the
    multi-device executor, when this compile raised)."""
    from alpa_tpu_torch.shard_parallel import solver
    planned = []
    real = solver.plan_auto_sharding

    def plan(*args, **kwargs):
        planned.append(real(*args, **kwargs))
        return planned[-1]

    monkeypatch.setattr(solver, "plan_auto_sharding", plan)
    body = functools.partial(_port_step, loss_fn=functools.partial(
        _mse, mean=torch.mean))
    runs = []
    for devices in (["cpu"], ["cpu"] * 2):
        _, _, tstate, tbatch = _mlp_states()
        step = alpa_tpu_torch.parallelize(
            body, method=alpa_tpu_torch.ShardParallel(devices=devices,
                                                      num_micro_batches=2))
        state, losses = _run(step, tstate, tbatch)
        runs.append((losses, ttesting.gather_tree(state.params)))
    assert len(planned) == 1 and planned[0][3] == (1, 2)
    ex = step.get_last_executable()
    assert ex.spmd is not None and len(ex.devices) == 2
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-5)
    for name, want in runs[0][1].items():
        np.testing.assert_allclose(runs[1][1][name].numpy(), want.numpy(),
                                   rtol=0, atol=1e-5 * float(
                                       want.abs().max()))


########################################
# JAX's four errors
########################################


def _mlp_step_raises(body, batch_size=16, k=2, match=""):
    _, _, tstate, tbatch = _mlp_states()
    if batch_size != 16:
        tbatch = {n: v[:batch_size] for n, v in tbatch.items()}
    step = alpa_tpu_torch.parallelize(body, method=_port_method(k))
    with pytest.raises(ValueError, match=match):
        step(tstate, tbatch)


def test_no_gradient_marker_raises():
    def body(state, batch):
        params = {n: p.detach().requires_grad_() for n, p in
                  state.params.items()}
        with torch.enable_grad():
            loss = _mse(state.apply_fn, params, batch, mean=torch.mean)
            grads = torch.autograd.grad(loss, list(params.values()))
        return state.apply_gradients(grads=dict(zip(params, grads))), loss

    _mlp_step_raises(body, match="gradient boundary")


def test_two_gradient_markers_raise():
    def body(state, batch):
        fn = functools.partial(_mse, mean=torch.mean)
        loss, g1 = alpa_tpu_torch.value_and_grad(
            lambda p: fn(state.apply_fn, p, batch))(state.params)
        _, g2 = alpa_tpu_torch.value_and_grad(
            lambda p: fn(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(
            grads={n: g1[n] + g2[n] for n in g1}), loss

    _mlp_step_raises(body, match="exactly one.*found 2 gradient markers")


def test_indivisible_batch_raises():
    _mlp_step_raises(functools.partial(_port_step, loss_fn=functools.partial(
        _mse, mean=torch.mean)), batch_size=6, k=4, match="not divisible")


@pytest.mark.parametrize("crossing", ["value", "output", "batch"])
def test_unmarked_values_crossing_the_marker_raise(crossing):
    def body(state, batch):
        extra = batch["x"].mean()
        loss, grads = alpa_tpu_torch.value_and_grad(
            lambda p: _mse(state.apply_fn, p, batch, mean=torch.mean))(
                state.params)
        new = state.apply_gradients(grads=grads)
        if crossing == "value":
            return new, loss + extra
        if crossing == "output":
            return new, loss, extra
        return new, loss + batch["y"].sum()

    match = {"value": "without passing through the gradient marker",
             "output": "bypasses the gradient marker",
             "batch": "batch argument is used after"}[crossing]
    _mlp_step_raises(body, match=match)
