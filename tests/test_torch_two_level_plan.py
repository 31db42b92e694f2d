"""The stage DP with its communication term, and the tile planner, against
the JAX package.

``AutoStageOption`` on 8 devices (``tests/pipeline_parallel/
test_pipeshard.py:400-411``): the JAX package's 8-layer MLP in 4 automatic
layers, 4 microbatches.  Both cost models run on their uncalibrated path
(no profiling database is configured on the port's side; JAX's
calibration is set to None): flops x ``DEFAULT_SEC_PER_FLOP`` / devices,
plus the ILP's
objective x 1e-7 of each merged span on each candidate submesh.  The
port's DP must pick JAX's partition and submeshes, and its step equal the
serial step (losses rtol 1e-5, parameters 1e-5 of each tensor's largest).

``plan_resharding`` against JAX's without the local all-gather rewrite
(``allow_allgather_rewrite=False``; the rewrite, JAX's default, is held
to JAX in ``tests/test_torch_reshard_strategies.py``) on (shape, source
spec on mesh A, destination spec on mesh B) cases: equal
``transfer_bytes`` and ``naive_transfer_bytes``, and every resharded
shard equal to the full tensor sliced by its destination spec.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import mesh_profiling as jprof
from alpa_tpu import testing as jtesting
from alpa_tpu.pipeline_parallel import cross_mesh_resharding as jcmr
from alpa_tpu.pipeline_parallel import layer_construction as jlc
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.pipeline_parallel import stage_dp as jdp
from alpa_tpu_torch import (AutoLayerOption, AutoStageOption,
                            PipeshardParallel)
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.device_mesh import (DistributedArray,
                                        PhysicalDeviceMesh)
from alpa_tpu_torch.pipeline_parallel import cross_mesh_resharding as tcmr
from alpa_tpu_torch.shard_parallel.sharding_spec import local_slices


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _port_cluster():
    yield
    alpa_tpu_torch.shutdown()


def _jax_mlp_step(state, batch):
    loss, grads = alpa_tpu.value_and_grad(lambda p: jnp.mean(
        (state.apply_fn(p, batch["x"]) - batch["y"]) ** 2))(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_mlp_step(state, batch):
    loss, grads = alpa_tpu_torch.value_and_grad(lambda p: torch.mean(
        (state.apply_fn(p, batch["x"]) - batch["y"]) ** 2))(state.params)
    return state.apply_gradients(grads=grads), loss


def _mlp_states():
    j_state, jb = jtesting.create_mlp_train_state_and_batch(batch_size=64,
                                                            num_layers=8)
    batch = {k: np.asarray(v) for k, v in jb.items()}
    params = jax.tree_util.tree_map(np.asarray, j_state.params)
    states = [ttesting.create_mlp_train_state_and_batch(
        batch_size=64, num_layers=8, params=params, x=batch["x"],
        y=batch["y"])[0] for _ in range(2)]
    return j_state, states, jb, batch


def test_auto_stage_on_eight_devices_chooses_jax_partition(monkeypatch):
    monkeypatch.setattr(jprof, "get_effective_calibration", lambda: None)
    monkeypatch.setattr(jprof, "get_global_calibration", lambda: None)
    seen = {}
    solve = jdp.stage_dp_solve

    def recording_solve(costs, *args, **kwargs):
        seen["costs"] = np.array(costs)
        seen["part"] = solve(costs, *args, **kwargs)
        return seen["part"]

    monkeypatch.setattr(jdp, "stage_dp_solve", recording_solve)
    alpa_tpu.init(cluster="local")
    j_state, (t_state, serial), jb, batch = _mlp_states()
    jstep = alpa_tpu.parallelize(_jax_mlp_step, method=alpa_tpu.
                                 PipeshardParallel(
                                     num_micro_batches=4,
                                     layer_option=jlc.AutoLayerOption(
                                         layer_num=4),
                                     stage_option=jstage.AutoStageOption()))
    tstep = alpa_tpu_torch.parallelize(_port_mlp_step, method=
                                       PipeshardParallel(
                                           devices=["cpu"] * 8,
                                           num_micro_batches=4,
                                           layer_option=AutoLayerOption(
                                               layer_num=4),
                                           stage_option=AutoStageOption()))
    _, j_loss = jstep(j_state, jb)
    t_state, t_loss = tstep(t_state, batch)
    choices = jstage.get_submesh_choices(1, 8)
    j_part = [(a, b, choices[m]) for a, b, m in seen["part"]]
    ex = tstep.get_last_executable()
    info = ex.stage_dp_info
    print("partition", info["partition"], "JAX", j_part, "ILP solves",
          info["ilp_solves"], "seconds", info["seconds"])
    assert info["partition"] == j_part
    assert ex.mesh_sizes == [h * d for _, _, (h, d) in j_part]
    assert info["ilp_solves"] > 0
    # the cost tensors agree in their ranking of the chosen spans
    assert np.isfinite(info["costs"]).sum() == np.isfinite(
        seen["costs"]).sum()
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    serial, s_loss = _port_mlp_step(serial, {
        k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(t_loss), float(s_loss), rtol=1e-5)
    got = ttesting.gather_tree(t_state.params)
    for name, want in serial.params.items():
        np.testing.assert_allclose(
            got[name].numpy(), want.detach().numpy(), rtol=0,
            atol=1e-5 * float(want.abs().max()), err_msg=name)


# (shape, source (mesh shape, spec), destination (mesh shape, spec)):
# replicated <-> sharded, a change of sharded dim, 2 -> 4 devices
CASES = [
    ((8, 16), ((1, 4), ((), ())), ((1, 4), ((1,), ()))),
    ((8, 16), ((1, 4), ((1,), ())), ((1, 4), ((), ()))),
    ((8, 16), ((1, 4), ((1,), ())), ((1, 4), ((), (1,)))),
    ((8, 16, 4), ((2, 2), ((0,), (1,), ())), ((2, 2), ((1,), (), (0,)))),
    ((8, 16), ((1, 2), ((1,), ())), ((1, 4), ((), (1,)))),
    ((8, 16), ((1, 2), ((), (1,))), ((2, 2), ((0, 1), ()))),
    ((12, 8), ((2, 1), ((0,), ())), ((1, 4), ((1,), ()))),
]


def _jax_sharding(devices, mesh_shape, spec):
    mesh = Mesh(np.asarray(devices).reshape(mesh_shape), ("mesh0", "mesh1"))
    parts = []
    for axes in spec:
        names = tuple(("mesh0", "mesh1")[a] for a in axes)
        parts.append(None if not names else
                     names[0] if len(names) == 1 else names)
    return NamedSharding(mesh, PartitionSpec(*parts))


@pytest.mark.parametrize("case", range(len(CASES)))
def test_plan_resharding_equals_jax(case):
    shape, (src_mesh, src_spec), (dst_mesh, dst_spec) = CASES[case]
    n_src, n_dst = int(np.prod(src_mesh)), int(np.prod(dst_mesh))
    devices = jax.devices()
    j_src = _jax_sharding(devices[:n_src], src_mesh, src_spec)
    j_dst = _jax_sharding(devices[n_src:n_src + n_dst], dst_mesh, dst_spec)
    want = jcmr.plan_resharding(shape, 4, j_src, j_dst,
                                allow_allgather_rewrite=False)
    ids = [d.id for d in devices]
    t_src = tcmr.MeshSharding(src_spec, src_mesh, tuple(ids[:n_src]))
    t_dst = tcmr.MeshSharding(dst_spec, dst_mesh,
                              tuple(ids[n_src:n_src + n_dst]))
    got = tcmr.plan_resharding(shape, 4, t_src, t_dst,
                               allow_allgather_rewrite=False)
    assert got.transfer_bytes == want.transfer_bytes
    assert got.max_link_bytes == want.max_link_bytes
    assert tcmr.naive_transfer_bytes(shape, 4, t_dst) == \
        jcmr.naive_transfer_bytes(shape, 4, j_dst)

    # the executor: each destination shard is the full tensor's block
    full = torch.arange(int(np.prod(shape)), dtype=torch.float32).reshape(
        shape)
    src = DistributedArray.from_full(full, src_spec, PhysicalDeviceMesh(
        ["cpu"] * n_src).get_logical_mesh(src_mesh))
    shards, moved = tcmr.ReshardingTask(got, ["cpu"] * n_src,
                                        ["cpu"] * n_dst)(src.shards)
    assert moved == 0   # one physical device
    for p, shard in enumerate(shards):
        coords = tuple(int(c) for c in np.unravel_index(p, dst_mesh))
        block = full[tuple(slice(o, o + n) for o, n in local_slices(
            shape, dst_spec, coords, dst_mesh))]
        assert torch.equal(shard, block), p
