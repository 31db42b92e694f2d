"""The port's compile cache (``alpa_tpu_torch/compile_cache.py``): the JAX
package's unit cases on the port's cache, then the planners through it.

A warm ``plan_auto_sharding`` of the narrow MLP on (2, 2) replays the
cold one's plan with a hit; a warm stage DP replays its decision; the key
of a traced graph is stable over two traces; and a second process over
the same directory hits the disk tier and plans the same.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import alpa_tpu_torch
from alpa_tpu import compile_cache as jcc
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.compile_cache import (CompileCache, fingerprint_parts,
                                          get_compile_cache, graph_fingerprint,
                                          reset_compile_cache)
from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.shard_parallel import AutoShardingOption
from alpa_tpu_torch.shard_parallel import solver as tsolver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _fresh_cache():
    reset_compile_cache()
    yield
    reset_compile_cache()
    alpa_tpu_torch.shutdown()


# ---- the JAX package's unit cases (tests/runtime/test_compile_cache.py)

def test_fingerprint_stable_and_discriminating():
    assert fingerprint_parts(["a", "b"]) == fingerprint_parts(["a", "b"])
    assert fingerprint_parts(["a", "b"]) != fingerprint_parts(["ab"])
    assert fingerprint_parts(["a"]) != fingerprint_parts(["b"])


def test_fingerprint_masks_addresses():
    a = "fn=<function memoized at 0x7fb0765e3d90>"
    b = "fn=<function memoized at 0x7fb0765257e0>"
    assert fingerprint_parts([a]) == fingerprint_parts([b])


def test_memory_tier_lru():
    cache = CompileCache(cache_dir=None, memory_entries=2)
    for i in range(3):
        cache.put("ilp", f"ilp-k{i}", i)
    assert cache.get("ilp", "ilp-k0") is None
    assert cache.get("ilp", "ilp-k2") == 2
    s = cache.stats()["namespaces"]["ilp"]
    assert s["puts"] == 3 and s["hits"] == 1 and s["misses"] == 1


def test_disk_tier_roundtrip_and_promotion(tmp_path):
    d = str(tmp_path)
    CompileCache(cache_dir=d).put("ilp", "ilp-key", {"x": 1})
    cache2 = CompileCache(cache_dir=d)
    assert cache2.get("ilp", "ilp-key") == {"x": 1}
    assert cache2.stats()["namespaces"]["ilp"]["disk_hits"] == 1
    assert cache2.get("ilp", "ilp-key") == {"x": 1}
    assert cache2.stats()["namespaces"]["ilp"]["disk_hits"] == 1


def test_corrupt_disk_entry_is_a_miss(tmp_path):
    d = str(tmp_path)
    CompileCache(cache_dir=d).put("ilp", "ilp-bad", {"x": 1})
    path = os.path.join(d, "ilp-bad.pkl")
    with open(path, "wb") as f:
        f.write(b"not a pickle")
    assert CompileCache(cache_dir=d).get("ilp", "ilp-bad") is None
    assert not os.path.exists(path)


def test_clear_by_namespace_and_stats_equal_jax(tmp_path):
    caches = (CompileCache(cache_dir=str(tmp_path / "t")),
              jcc.CompileCache(cache_dir=str(tmp_path / "j")))
    for cache in caches:
        cache.put("ilp", "ilp-a", 1)
        cache.put("stage_dp", "stage_dp-b", 2)
        assert cache.clear(namespace="ilp") == 1
        assert cache.get("ilp", "ilp-a") is None
        assert cache.get("stage_dp", "stage_dp-b") == 2
        cache.record_solve_seconds("ilp", 1.5)
    ours, theirs = (c.stats() for c in caches)
    assert ours["namespaces"] == theirs["namespaces"]
    assert jcc.read_entry_format(str(tmp_path / "j" / "stage_dp-b.pkl")) == \
        jcc.CACHE_FORMAT_VERSION == 2
    from alpa_tpu_torch.compile_cache import read_entry_format
    assert read_entry_format(str(tmp_path / "t" / "stage_dp-b.pkl")) == 2


# ---- the planners through the cache

def _mlp_flat(batch_size=64, dim=32, layers=2):
    """(flat step, avals, paths, batch leaves) of the narrow MLP step."""
    from test_torch_auto_sharding import _port_flat
    state, batch = ttesting.create_mlp_train_state_and_batch(
        batch_size=batch_size, input_dim=dim, hidden_dim=dim, output_dim=dim,
        num_layers=layers)
    return _port_flat(ttesting.get_mlp_train_step(None, True), state, batch)


def _plan(flat, traced=None):
    fun, avals, paths, bidx = flat
    _, specs, (graph, choice), shape = tsolver.plan_auto_sharding(
        fun, avals, paths, bidx, PhysicalDeviceMesh(["cpu"] * 4),
        AutoShardingOption(logical_mesh_shape=(2, 2)), traced=traced)
    return {"shape": tuple(shape), "specs": repr(specs),
            "choice": [int(c) for c in choice]}, graph


def test_warm_plan_replays_the_cold_one():
    flat = _mlp_flat()
    cold, cold_graph = _plan(flat)
    stats = get_compile_cache().stats()["namespaces"]["ilp"]
    assert (stats["misses"], stats["hits"], stats["puts"]) == (1, 0, 1)
    warm, warm_graph = _plan(flat)
    stats = get_compile_cache().stats()["namespaces"]["ilp"]
    assert (stats["misses"], stats["hits"]) == (1, 1)
    assert warm == cold
    assert [dict(r, cached=True) for r in cold_graph.search] == \
        warm_graph.search
    # the same plan with the cache off
    global_config.compile_cache_enabled = False
    try:
        assert _plan(flat)[0] == cold
    finally:
        global_config.compile_cache_enabled = True


def test_key_is_stable_over_two_traces_and_moves_with_the_graph():
    flat = _mlp_flat()
    fun, avals, _, _ = flat
    a = tsolver.trace_flat(fun, avals, torch.device("cpu"))
    b = tsolver.trace_flat(fun, avals, torch.device("cpu"))
    assert graph_fingerprint(a) == graph_fingerprint(b)
    wider = _mlp_flat(dim=16)
    c = tsolver.trace_flat(wider[0], wider[1], torch.device("cpu"))
    assert graph_fingerprint(c) != graph_fingerprint(a)
    # a constant enters by its content
    g1 = torch.fx.experimental.proxy_tensor.make_fx(
        lambda x: x + torch.tensor([1.0, 2.0]))(torch.zeros(2))
    g2 = torch.fx.experimental.proxy_tensor.make_fx(
        lambda x: x + torch.tensor([1.0, 3.0]))(torch.zeros(2))
    assert graph_fingerprint(g1) != graph_fingerprint(g2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scalar_constants_plan_and_key_by_content(dtype):
    """make_fx keeps a scalar (a scale, a ``-inf`` mask value) as a 0-d
    ``_tensor_constant``: the planner keys it by its bytes, plans it, and
    replays the plan warm; another scale is another key."""

    def flat(scale):
        def fun(x, w):
            y = (x @ w) * torch.tensor(scale, dtype=dtype)
            return [torch.maximum(
                y, torch.tensor(float("-inf"), dtype=dtype)).sum()]
        return fun

    avals = [((8, 4), dtype), ((4, 4), dtype)]
    mesh = PhysicalDeviceMesh(["cpu"] * 4)
    option = AutoShardingOption(logical_mesh_shape=(2, 2))

    def plan(scale):
        traced = tsolver.trace_flat(flat(scale), avals, torch.device("cpu"))
        consts = [getattr(traced, n.target) for n in traced.graph.nodes
                  if n.op == "get_attr"]
        assert consts and all(c.dim() == 0 and c.dtype == dtype
                              for c in consts)
        _, specs, (_, choice), shape = tsolver.plan_auto_sharding(
            flat(scale), avals, ["x", "w"], [0], mesh, option,
            traced=traced)
        return (tuple(shape), repr(specs),
                [int(c) for c in choice]), graph_fingerprint(traced)

    cold, key_half = plan(0.5)
    warm, again = plan(0.5)
    _, key_quarter = plan(0.25)
    stats = get_compile_cache().stats()["namespaces"]["ilp"]
    assert warm == cold and again == key_half != key_quarter
    assert (stats["misses"], stats["hits"]) == (2, 1)


def test_stage_dp_decision_replays_from_the_cache():
    from test_torch_stage_dp import _mlp_states, _port_mlp_step
    from alpa_tpu_torch import (AutoLayerOption, AutoStageOption,
                                PipeshardParallel)

    def compile_once():
        step = alpa_tpu_torch.parallelize(
            _port_mlp_step, method=PipeshardParallel(
                devices=["cpu"] * 2, num_micro_batches=2,
                layer_option=AutoLayerOption(layer_num=2),
                stage_option=AutoStageOption()))
        _, loss = step(_mlp_states()[1], _mlp_states()[3])
        ex = step.get_last_executable()
        return ex, float(loss)

    ex1, loss1 = compile_once()
    ex2, loss2 = compile_once()
    stats = get_compile_cache().stats()["namespaces"]
    assert stats["stage_dp"]["hits"] == 1 and stats["stage_dp"]["puts"] == 1
    assert not ex1.stage_dp_info["cache_hit"] and \
        ex2.stage_dp_info["cache_hit"]
    assert ex2.stage_dp_info["partition"] == ex1.stage_dp_info["partition"]
    assert ex2.get_plan_fingerprint() == ex1.get_plan_fingerprint()
    assert loss2 == loss1
    assert stats["parallel_plan"]["puts"] == 2


def test_stage_dp_key_moves_with_the_profiling_database(tmp_path):
    """The stage-DP key holds the fit the DP prices with: the same
    database replays the decision; the database profiled again under
    the same name is a miss."""
    from test_torch_stage_dp import _mlp_states, _port_mlp_step, _prof_db
    from alpa_tpu_torch import (AutoLayerOption, AutoStageOption,
                                PipeshardParallel)
    db = str(tmp_path / "db.json")

    def compile_once():
        step = alpa_tpu_torch.parallelize(
            _port_mlp_step, method=PipeshardParallel(
                devices=["cpu"] * 2, num_micro_batches=2,
                layer_option=AutoLayerOption(layer_num=2),
                stage_option=AutoStageOption(
                    profiling_database_filename=db)))
        step(_mlp_states()[1], _mlp_states()[3])
        return step.get_last_executable().stage_dp_info

    _prof_db(db, "1x2-cpu-plain")
    first, same = compile_once(), compile_once()
    _prof_db(db, "1x2-cpu-plain", flops_per_s=5e9)
    again = compile_once()
    stats = get_compile_cache().stats()["namespaces"]["stage_dp"]
    assert first["calibrated"] and again["calibrated"]
    assert [first["cache_hit"], same["cache_hit"], again["cache_hit"]] == \
        [False, True, False]
    assert (stats["hits"], stats["puts"]) == (1, 2)


_CHILD = """
import json, sys
sys.path.insert(0, {tests!r})
import test_torch_compile_cache as t
from alpa_tpu_torch.compile_cache import get_compile_cache
plan, _ = t._plan(t._mlp_flat())
print(json.dumps({{"plan": plan,
                   "stats": get_compile_cache().stats()["namespaces"]}}))
"""


def test_a_second_process_hits_the_disk_tier(tmp_path):
    reset_compile_cache(CompileCache(cache_dir=str(tmp_path)))
    cold, _ = _plan(_mlp_flat())
    env = dict(os.environ, ALPA_TPU_CACHE_DIR=str(tmp_path),
               JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c",
         _CHILD.format(tests=os.path.join(REPO, "tests"))],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    child = json.loads(out.stdout.strip().splitlines()[-1])
    cold = json.loads(json.dumps(cold))
    assert child["plan"] == cold
    assert child["stats"]["ilp"]["disk_hits"] == 1
    assert child["stats"]["ilp"]["misses"] == 0
    assert np.isclose(child["stats"]["ilp"]["saved_seconds"],
                      get_compile_cache().stats()["namespaces"]["ilp"]
                      ["solve_seconds"], rtol=1e-3, atol=1e-3)
