"""Replayable plans (``alpa_tpu_torch/parallel_plan.py``) against the JAX
package's.

``executable_to_plan`` of the two-level MLP (two stages of four CPU
devices) equals JAX's plan of the same step, field for field; the plan
``api`` keeps in the compile cache is that plan; and ``plan_to_method``
rebuilds a method whose executable replays it: the same plan, the same
plan fingerprint and the same losses.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import parallel_plan as jplan
from alpa_tpu_torch import parallel_plan as tplan
from alpa_tpu_torch.compile_cache import get_compile_cache, reset_compile_cache
from alpa_tpu_torch.pipeline_parallel.layer_construction import \
    ManualLayerOption

from test_torch_pipeshard_spmd import (_jax_mlp_step, _mlp_methods,
                                       _mlp_states, _port_mlp_step, _run)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _isolated():
    reset_compile_cache()
    yield
    reset_compile_cache()
    alpa_tpu_torch.shutdown()


def _plain(plan) -> dict:
    return dataclasses.asdict(plan)


def test_two_level_plan_equals_jax_and_replays():
    alpa_tpu.init(cluster="local")
    jmethod, tmethod = _mlp_methods()
    j_state, t_state, batch = _mlp_states()
    jstep = alpa_tpu.parallelize(_jax_mlp_step, method=jmethod)
    tstep = alpa_tpu_torch.parallelize(_port_mlp_step, method=tmethod)
    jstep(j_state, jax.tree_util.tree_map(jnp.asarray, batch))
    _, t_losses = _run(tstep, t_state, batch)
    jex, tex = jstep.get_last_executable(), tstep.get_last_executable()
    theirs = jplan.executable_to_plan(jex)
    ours = tplan.executable_to_plan(tex)
    assert _plain(ours) == _plain(theirs)
    assert ours.pipeline_plan.submesh_physical_shapes == [(1, 4), (1, 4)]
    assert ours.fingerprint() == tplan.executable_to_plan(tex).fingerprint()
    # the compile kept it in the cache (namespace "parallel_plan")
    assert tex.parallel_plan == ours
    assert get_compile_cache().stats()["namespaces"]["parallel_plan"][
        "puts"] == 1

    method = tplan.plan_to_method(ours, devices=["cpu"] * 8)
    method.layer_option = ManualLayerOption()
    _, t_state2, _ = _mlp_states()
    replay = alpa_tpu_torch.parallelize(_port_mlp_step, method=method)
    _, losses = _run(replay, t_state2, batch)
    rex = replay.get_last_executable()
    assert _plain(tplan.executable_to_plan(rex)) == _plain(ours)
    assert rex.get_plan_fingerprint() == tex.get_plan_fingerprint()
    np.testing.assert_allclose(losses, t_losses, rtol=1e-6)


def test_shard_plan_round_trip(tmp_path):
    """A sharded executable's plan: its mesh shape and input specs, saved
    and loaded, and the method it rebuilds plans the same specs."""
    from alpa_tpu_torch import ShardParallel, testing as ttesting
    state, batch = ttesting.create_mlp_train_state_and_batch(
        batch_size=16, input_dim=8, hidden_dim=8, output_dim=8,
        num_layers=2)
    step = ttesting.get_mlp_train_step(ShardParallel(devices=["cpu"] * 4),
                                       True)
    step(state, batch)
    ex = step.get_last_executable()
    plan = tplan.executable_to_plan(ex)
    assert plan.pipeline_plan is None
    assert plan.stage_plans[0].input_partition_specs == list(ex.in_specs)
    path = str(tmp_path / "plan.pkl")
    plan.save(path)
    loaded = tplan.ParallelPlan.load(path)
    assert loaded.fingerprint() == plan.fingerprint()
    method = tplan.plan_to_method(loaded, devices=["cpu"] * 4)
    state2, _ = ttesting.create_mlp_train_state_and_batch(
        batch_size=16, input_dim=8, hidden_dim=8, output_dim=8,
        num_layers=2)
    step2 = ttesting.get_mlp_train_step(method, True)
    step2(state2, batch)
    assert list(step2.get_last_executable().in_specs) == list(ex.in_specs)
