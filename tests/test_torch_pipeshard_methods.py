"""The port's default layer option, ``get_3d_parallel_method``,
``LocalPipelineParallel`` and pipeshard donation against the JAX package's.

The same numpy weights and batch go through both packages (the MLP
fixture, 4 layers, batch 16).  JAX runs its pipeshard on the test
session's virtual CPU devices, one per stage; the port on ``["cpu"] * n``.
Tolerances, fp32: losses and parameters after 2 SGD-momentum steps rtol
1e-4, atol 1e-5 (sums over microbatches in another order), as
``test_torch_pipeshard.py`` holds them.  A donated state's apply-grad
writes its results into the donated storage: the values stay bit-identical
to a run without donation.
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
from alpa_tpu.device_mesh import get_global_cluster
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu_torch import (LocalPipelineParallel, ManualLayerOption,
                            PipeshardParallel, UniformStageOption,
                            get_3d_parallel_method)
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import mlp_params_from_flax
from alpa_tpu_torch.pipeline_parallel.layer_construction import \
    HEAVY_OPS

TOL = dict(rtol=1e-4, atol=1e-5)
BATCH, DIM = 16, 32


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Restore torch's global RNG so these tests leave other tests' draws
    alone."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _port_cluster():
    yield
    alpa_tpu_torch.shutdown()


def _pair(jax_tx=None, port_tx=None, manual=False):
    """(JAX state, port state, numpy batch) of the 4-layer MLP fixture from
    the same weights."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    y = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    jmodel = jtesting.MLPModel(hidden_dim=DIM, output_dim=DIM, num_layers=4,
                               manual_pipeline_layer=manual)
    params = jax.tree_util.tree_map(
        np.asarray, jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                         jnp.asarray(x)))
    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        tx=jax_tx or optax.sgd(1e-2, momentum=0.9))
    t_state, _ = ttesting.create_mlp_train_state_and_batch(
        batch_size=BATCH, input_dim=DIM, hidden_dim=DIM, output_dim=DIM,
        num_layers=4, manual_pipeline_layer=manual, params=params, x=x, y=y,
        tx=port_tx or tmu.sgd(1e-2, momentum=0.9))
    return j_state, t_state, {"x": x, "y": y}


def _jax_step(state, batch):
    loss, grads = alpa_tpu.value_and_grad(
        lambda p: jnp.mean((state.apply_fn(p, batch["x"]) - batch["y"]) ** 2)
    )(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_step(state, batch):
    loss, grads = alpa_tpu_torch.value_and_grad(
        lambda p: torch.mean((state.apply_fn(p, batch["x"]) - batch["y"]) ** 2)
    )(state.params)
    return state.apply_gradients(grads=grads), loss


def _run(step, state, batch, steps=2):
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return state, losses


def _assert_same_training(j_pstep, t_pstep, j_state, t_state, batch):
    j_state, j_losses = _run(j_pstep, j_state,
                             jax.tree_util.tree_map(jnp.asarray, batch))
    t_state, t_losses = _run(t_pstep, t_state, batch)
    np.testing.assert_allclose(t_losses, j_losses, **TOL)
    ttesting.assert_allclose(
        t_state.params,
        mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                    j_state.params)), **TOL)


def _jax_mesh(num_devices):
    alpa_tpu.init(cluster="local")
    return get_global_cluster().get_virtual_physical_mesh(
        num_devices_per_host=num_devices)


def _products_per_forward_stage(ex):
    return [sum(n.target in HEAVY_OPS for n in e.module.graph.nodes)
            for e in ex.stage_execs[:ex.num_fwd_stages]]


def test_default_layer_option_equals_jax_default():
    """``layer_option=None`` is JAX's default,
    ``AutoLayerOption(layer_num=min(8, #devices))``: on two devices, two
    automatic layers of two products each, and the steps equal JAX's."""
    j_state, t_state, batch = _pair()
    j_pstep = alpa_tpu.parallelize(_jax_step, method=alpa_tpu.PipeshardParallel(
        devices=_jax_mesh(2), num_micro_batches=2,
        stage_option=jstage.ManualStageOption([[0], [1]], [(1, 1)] * 2)))
    t_pstep = alpa_tpu_torch.parallelize(_port_step, method=PipeshardParallel(
        devices=["cpu"] * 2, num_micro_batches=2,
        stage_option=UniformStageOption(2)))
    _assert_same_training(j_pstep, t_pstep, j_state, t_state, batch)
    ex = t_pstep.get_last_executable()
    assert ex.num_fwd_stages == j_pstep.get_last_executable().num_fwd_stages
    assert _products_per_forward_stage(ex) == [2, 2]


def test_get_3d_parallel_method_equals_jax():
    """``get_3d_parallel_method(dp=1, op=1, pp=2)``: pipeshard over two
    one-device stages of ``AutoLayerOption(layer_num=2)``, 1F1B; the steps
    equal JAX's method's.  pp=1 degenerates into ``ShardParallel`` on a
    (dp, op) logical mesh, planned by rules, which runs over two devices
    and equals JAX's ``ShardParallel`` with the same option on two virtual
    devices; pp=2 with dp=2 puts each stage on a (2, 1) logical mesh of
    two devices, every stage input replicated as JAX plans a stage without
    the ILP, and trains as the serial step; the degrees must multiply to
    the device count."""
    j_state, t_state, batch = _pair()
    j_method = alpa_tpu.get_3d_parallel_method(
        num_micro_batches=2, data_parallel=1, operator_parallel=1,
        pipeline_parallel=2, devices=_jax_mesh(2))
    t_method = get_3d_parallel_method(
        num_micro_batches=2, data_parallel=1, operator_parallel=1,
        pipeline_parallel=2, devices=["cpu"] * 2)
    assert t_method.layer_option.layer_num == \
        j_method.layer_option.layer_num == 2
    assert t_method.stage_option.forward_stage_layer_ids == \
        j_method.stage_option.forward_stage_layer_ids
    assert [list(s) for s in t_method.stage_option.submesh_physical_shapes] \
        == [list(s) for s in j_method.stage_option.submesh_physical_shapes]
    _assert_same_training(alpa_tpu.parallelize(_jax_step, method=j_method),
                          alpa_tpu_torch.parallelize(_port_step,
                                                     method=t_method),
                          j_state, t_state, batch)
    shard = get_3d_parallel_method(1, 1, 1, 1, devices=["cpu"])
    assert isinstance(shard, alpa_tpu_torch.ShardParallel)
    assert isinstance(get_3d_parallel_method(
        1, 1, 1, 1, devices=["cpu"],
        allow_degenerate_into_shard_parallel=False), PipeshardParallel)
    two = get_3d_parallel_method(2, 2, 1, 1, devices=["cpu"] * 2)
    assert two.as_option.logical_mesh_shape == (2, 1)
    j_two = alpa_tpu.ShardParallel(
        devices=jax.devices()[:2], num_micro_batches=2,
        auto_sharding_option=alpa_tpu.get_3d_parallel_method(
            2, 2, 1, 1, devices=_jax_mesh(2)).as_option)
    j_state, t_state, batch = _pair()
    _assert_same_training(alpa_tpu.parallelize(_jax_step, method=j_two),
                          alpa_tpu_torch.parallelize(_port_step, method=two),
                          j_state, t_state, batch)
    wide = get_3d_parallel_method(2, 2, 1, 2, devices=["cpu"] * 4)
    assert wide.stage_option.submesh_logical_shapes == [(2, 1), (2, 1)]
    assert not wide.as_option.enable_auto_sharding
    _, t_state, batch = _pair()
    _, serial, _ = _pair()
    pstep = alpa_tpu_torch.parallelize(_port_step, method=wide)
    t_state, t_loss = pstep(t_state, batch)
    serial, s_loss = _port_step(serial, {k: torch.as_tensor(v)
                                         for k, v in batch.items()})
    np.testing.assert_allclose(float(t_loss), float(s_loss), rtol=1e-5)
    assert pstep.get_last_executable().mesh_sizes == [2, 2]
    with pytest.raises(ValueError, match="#devices"):
        get_3d_parallel_method(2, 1, 1, 3, devices=["cpu"] * 2)


def test_local_pipeline_parallel_equals_jax():
    """``LocalPipelineParallel`` runs the step's layer graphs (two automatic
    layers, their backward layers and the glue between them) in order on
    one device; the steps equal JAX's ``LocalPipelineParallel``."""
    j_state, t_state, batch = _pair()
    t_pstep = alpa_tpu_torch.parallelize(
        _port_step, method=LocalPipelineParallel(device="cpu"))
    _assert_same_training(
        alpa_tpu.parallelize(_jax_step,
                             method=alpa_tpu.LocalPipelineParallel()),
        t_pstep, j_state, t_state, batch)
    names = [c.name for c in t_pstep.get_last_executable().computations]
    assert names == ["layer_0", "layer_1", "glue_0", "layer_1_backward",
                     "layer_0_backward", "glue_1"]
    manual = alpa_tpu_torch.parallelize(_port_step, method=LocalPipelineParallel(
        device="cpu", layer_option=ManualLayerOption()))
    _, m_state, _ = _pair(manual=True)
    _, s_state, _ = _pair()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    m_state, m_losses = _run(manual, m_state, batch)
    s_state, s_losses = _run(_port_step, s_state, tb)
    np.testing.assert_allclose(m_losses, s_losses, **TOL)


def _adam_pipeshard():
    return PipeshardParallel(devices=["cpu"] * 2, num_micro_batches=2,
                             layer_option=alpa_tpu_torch.AutoLayerOption(
                                 layer_num=2),
                             stage_option=UniformStageOption(2))


def test_apply_grad_writes_donated_state_in_place():
    """Every donated state input that exactly one apply-grad graph reads is
    written by that graph (JAX's rule and use count): the new parameters
    and stage 0's Adam moments live in their inputs' storage, nothing is
    left to free early, and two Adam steps give bit-identical values to a
    run without donation."""
    _, donated, batch = _pair(optax.adam(1e-3), tmu.adam(1e-3))
    _, kept, _ = _pair(optax.adam(1e-3), tmu.adam(1e-3))
    ptr = {k: p.data_ptr() for k, p in donated.params.items()}
    mu_ptr = {k: m.data_ptr() for k, m in donated.opt_state[0]["mu"].items()}
    step = alpa_tpu_torch.parallelize(_port_step, method=_adam_pipeshard())
    plain = alpa_tpu_torch.parallelize(_port_step, method=_adam_pipeshard(),
                                       donate_argnums=())
    for _ in range(2):
        donated, loss = step(donated, batch)
        kept, plain_loss = plain(kept, batch)
        assert float(loss) == float(plain_loss)
    for got, want in zip(torch.utils._pytree.tree_leaves(donated),
                         torch.utils._pytree.tree_leaves(kept)):
        assert torch.equal(torch.as_tensor(got), torch.as_tensor(want))
    assert {k: p.data_ptr() for k, p in donated.params.items()} == ptr
    ex = step.get_last_executable()
    first = {k for k in mu_ptr if k.startswith("layers.0.")
             or k.startswith("layers.1.")}
    assert all(donated.opt_state[0]["mu"][k].data_ptr() == mu_ptr[k]
               for k in first)
    applies = [e for e in ex.apply_execs if e is not None]
    assert sum(len(e.aliased) for e in applies) == sum(ex.donated_invars)
    assert all(not e.free_after for e in applies)
    assert not any(e.aliased for e in plain.get_last_executable().apply_execs
                   if e is not None)


def test_pipeshard_loss_and_grads_step_keeps_the_moments():
    """A pipeshard step returning ``(loss, grads)`` donates the parameters
    only (JAX's auto donation), so the Adam moments keep their storage and
    the gradients equal the serial step's."""
    _, t_state, batch = _pair(optax.adam(1e-3), tmu.adam(1e-3))
    _, s_state, _ = _pair(optax.adam(1e-3), tmu.adam(1e-3))

    def grad_step(state, batch):
        return alpa_tpu_torch.value_and_grad(
            lambda p: torch.mean((state.apply_fn(p, batch["x"]) -
                                  batch["y"]) ** 2))(state.params)

    step = alpa_tpu_torch.parallelize(grad_step, method=_adam_pipeshard())
    flags = step.get_donated_invars(t_state, batch)
    loss, grads = step(t_state, batch)
    n_params = len(t_state.params)
    assert sum(flags) == n_params
    assert all(m.untyped_storage().nbytes() > 0
               for m in t_state.opt_state[0]["mu"].values())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want_loss, want = grad_step(s_state, tb)
    np.testing.assert_allclose(float(loss), float(want_loss), **TOL)
    ttesting.assert_allclose(grads, want, **TOL)


def test_a_donated_input_its_reader_does_not_overwrite_is_freed_after_it():
    """A step returning ``(loss, grads, norm)`` donates the parameters (the
    gradients match them); the apply-grad graph that reads them makes only
    the 0-d norm, so it writes none of them: each is freed right after that
    graph, and the outputs equal the serial step's."""
    _, t_state, batch = _pair(optax.adam(1e-3), tmu.adam(1e-3))
    _, s_state, _ = _pair(optax.adam(1e-3), tmu.adam(1e-3))

    def step(state, batch):
        loss, grads = alpa_tpu_torch.value_and_grad(
            lambda p: torch.mean((state.apply_fn(p, batch["x"]) -
                                  batch["y"]) ** 2))(state.params)
        norm = sum((p * p).sum() for p in state.params.values())
        return loss, grads, norm

    pstep = alpa_tpu_torch.parallelize(step, method=_adam_pipeshard())
    loss, grads, norm = pstep(t_state, batch)
    ex = pstep.get_last_executable()
    freed = [e.invars[i] for e in ex.apply_execs if e is not None
             for i in e.free_after]
    assert len(freed) == len(t_state.params) and not any(
        e.aliased for e in ex.apply_execs if e is not None)
    assert all(p.untyped_storage().nbytes() == 0
               for p in t_state.params.values())
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    want = step(s_state, tb)
    ttesting.assert_allclose((loss, grads, norm), want, **TOL)
