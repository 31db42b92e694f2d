"""Calibration (``telemetry/calibration.py``) and mesh profiling
(``mesh_profiling.py``) of the port held to the JAX package's.

The same observations give the same store statistics, fingerprints and
entry JSON; the same profiling table gives the same fit, the same
calibrated collective costs (rtol 1e-9) and the same stage-cost seconds;
the stage DP with the same injected measured costs chooses JAX's
partition and submeshes on 8 CPU devices; ``profile_one_mesh`` runs on
CPU devices; and a table is only applied to meshes of the backend it was
measured over (the platform gate).
"""
import json
import os

import numpy as np
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import mesh_profiling as jprof
from alpa_tpu.device_mesh import LogicalDeviceMesh as JLogicalMesh
from alpa_tpu.global_env import global_config as jconfig
from alpa_tpu.pipeline_parallel import layer_construction as jlc
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.pipeline_parallel import stage_dp as jdp
from alpa_tpu.telemetry import calibration as jcal
from alpa_tpu_torch import (AutoLayerOption, AutoStageOption,
                            PipeshardParallel)
from alpa_tpu_torch import mesh_profiling as tprof
from alpa_tpu_torch.compile_cache import reset_compile_cache
from alpa_tpu_torch.device_mesh import (LogicalDeviceMesh,
                                        PhysicalDeviceMesh)
from alpa_tpu_torch.global_env import global_config as tconfig
from alpa_tpu_torch.telemetry import calibration as tcal

from test_torch_stage_dp import (_jax_mesh, _jax_mlp_step, _mlp_states,
                                 _port_mlp_step)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _isolated():
    reset_compile_cache()
    tcal.reset_calibration_store(tcal.CalibrationStore(None))
    jcal.reset_calibration_store(jcal.CalibrationStore(None))
    yield
    tcal.reset_calibration_store()
    jcal.reset_calibration_store()
    tprof.reset_global_calibration()
    reset_compile_cache()
    alpa_tpu_torch.shutdown()


OBSERVATIONS = [
    ("stage_run", "stage:stage_0_fwd", 120.0, 100.0, {"stage": "s0"}),
    ("stage_run", "stage:stage_0_fwd", 130.0, 100.0, None),
    ("stage_run", "stage:stage_0_fwd", 90.0, None, None),
    ("reshard_wire", "edge:0->1", 7.0, 2.0, {"src": "0", "dst": "1"}),
    ("reshard_wire", "edge:0->1", 9.5, 2.0, None),
    ("collective", "collective:all_reduce|bytes=2^20", 40.0, 35.0, None),
]


def _fill(mod, store):
    for kind, sig, v, modeled, meta in OBSERVATIONS:
        store.observe(kind, sig, v, modeled_us=modeled, meta=meta)
    for i in range(70):   # past the 64-sample reservoir
        store.observe("stage_run", "stage:stage_1_fwd", 10.0 + i % 7)
    store.set_modeled("stage_run", "stage:stage_1_fwd", 11.0)
    return store


def test_store_statistics_fingerprint_and_json_equal_jax(tmp_path):
    t = _fill(tcal, tcal.CalibrationStore(str(tmp_path / "t")))
    j = _fill(jcal, jcal.CalibrationStore(str(tmp_path / "j")))
    assert t.fingerprint() == j.fingerprint()
    assert [e.to_json() for e in t.entries()] == \
        [e.to_json() for e in j.entries()]
    for e_t, e_j in zip(t.entries(), j.entries()):
        assert (e_t.median_us, e_t.p90_us, e_t.ewma_us, e_t.count,
                e_t.drift_ratio) == (e_j.median_us, e_j.p90_us, e_j.ewma_us,
                                     e_j.count, e_j.drift_ratio)
    assert tcal.drift_table(t) == jcal.drift_table(j)
    assert tcal.format_calibration_report(t).replace(
        str(tmp_path / "t"), "D") == jcal.format_calibration_report(
        j).replace(str(tmp_path / "j"), "D")
    assert sorted(os.listdir(tmp_path / "t")) == \
        sorted(os.listdir(tmp_path / "j"))
    for name in os.listdir(tmp_path / "t"):
        with open(tmp_path / "t" / name) as a, \
                open(tmp_path / "j" / name) as b:
            assert json.load(a) == json.load(b)
    reloaded = tcal.CalibrationStore(str(tmp_path / "t"))
    assert reloaded.fingerprint() == t.fingerprint()
    assert tcal.collective_signature("all_gather", 3e6) == \
        jcal.collective_signature("all_gather", 3e6)
    assert tcal.wire_signature((4, 8), 4, "a", "b", "direct_p2p") == \
        jcal.wire_signature((4, 8), 4, "a", "b", "direct_p2p")


def test_replan_token_and_min_samples_equal_jax(monkeypatch):
    for mod, cfg in ((tcal, tconfig), (jcal, jconfig)):
        monkeypatch.setattr(cfg, "replan_mode", "off")
        assert mod.calibration_cache_token() is None
    tokens = []
    for mod, cfg in ((tcal, tconfig), (jcal, jconfig)):
        monkeypatch.setattr(cfg, "replan_mode", "suggest")
        monkeypatch.setattr(cfg, "calibration_min_samples", 3)
        store = _fill(mod, mod.get_calibration_store())
        tokens.append(mod.calibration_cache_token())
        assert store.measured_us("stage_run", "stage:stage_0_fwd") == \
            pytest.approx(120.0)
        store.observe("stage_run", "stage:new", 1.0)
        assert store.measured_us("stage_run", "stage:new") is None
    assert tokens[0] == tokens[1]


def _profile():
    """One profiling table, recorded alike in both packages' results."""
    t, j = tprof.MeshProfilingResult(), jprof.MeshProfilingResult()
    rng = np.random.default_rng(7)
    for res in (t, j):
        rng = np.random.default_rng(7)
        for n in (128, 512, 2048):
            res.record("dot", ("float32",), 2.0 * n ** 3,
                       2.0 * n ** 3 / rng.uniform(1e10, 1e11))
        for kind in tprof.COLLECTIVE_KINDS:
            for size in (1e3, 1e5, 1e7):
                res.record(kind, ("f32", 2), size,
                           rng.uniform(1e-5, 3e-5) + size / 5e9)
    return t, j


def test_fit_and_calibrated_costs_equal_jax():
    t_res, j_res = _profile()
    t_fit, j_fit = t_res.fit(), j_res.fit()
    assert t_fit.collective_ab == j_fit.collective_ab
    assert t_fit.dot_points == j_fit.dot_points
    ids = np.arange(8).reshape(2, 4)
    tm = LogicalDeviceMesh(None, ids, calibration=t_fit)
    jm = JLogicalMesh(None, ids, calibration=j_fit)
    assert tm.calibrated and jm.calibrated
    for axis in (0, 1):
        for nbytes in (1e3, 7e5, 3e8):
            for kind in ("all_gather", "all_reduce", "reduce_scatter",
                         "all_to_all"):
                assert getattr(tm, f"{kind}_cost")(nbytes, axis) == \
                    pytest.approx(getattr(jm, f"{kind}_cost")(nbytes, axis),
                                  rel=1e-9)
    assert t_res.to_json() == j_res.to_json()
    for f in (1e6, 5e8, 1e12):
        assert t_fit.sec_per_flop(f) == j_fit.sec_per_flop(f)


def test_estimate_stage_cost_seconds_under_a_calibration():
    """The port's stage cost under a calibration: the layers' flops at
    the fit's seconds per flop over the devices (JAX's formula, rtol
    1e-9), and with a measured stage time in the store under
    ``replan_mode`` the measured seconds, the estimate recorded beside
    it as JAX records it."""
    t_fit, j_fit = (r.fit() for r in _profile())
    _, t_state, _, batch = _mlp_states()
    step = alpa_tpu_torch.parallelize(_port_mlp_step, method=PipeshardParallel(
        devices=["cpu"], num_micro_batches=2,
        layer_option=AutoLayerOption(layer_num=2),
        stage_option=AutoStageOption()))
    step(t_state, batch)
    comps = step.get_last_executable().fwd_layer_comps
    flops = sum(sum(tprof.node_flops(n) for n in c.nodes) for c in comps)
    for n_dev in (1, 2):
        mesh = LogicalDeviceMesh(None, np.arange(n_dev).reshape(n_dev, 1),
                                 calibration=t_fit)
        got = tprof.estimate_stage_cost(comps, mesh, None, use_ilp=False)
        want = flops * j_fit.sec_per_flop(flops / n_dev) / n_dev
        assert got == pytest.approx(want, rel=1e-9)
    tconfig.replan_mode = "suggest"
    try:
        store = tcal.get_calibration_store()
        sig = tcal.stage_cost_signature(flops, 1)
        for _ in range(3):
            store.observe("stage_run", sig, 250.0)
        mesh = LogicalDeviceMesh(None, np.zeros((1, 1), int),
                                 calibration=t_fit)
        assert tprof.estimate_stage_cost(comps, mesh, None,
                                         use_ilp=False) == \
            pytest.approx(250e-6)
        assert store.get("stage_run", sig).modeled_us == pytest.approx(
            flops * j_fit.sec_per_flop(flops) * 1e6, rel=1e-9)
    finally:
        tconfig.replan_mode = "off"


def test_measured_stage_dp_chooses_jax_partition_on_8_devices(monkeypatch):
    """``profiling_mode="measured"`` on 8 CPU devices with the measured
    entries injected (the same seeded seconds in both packages' cost
    tensors): the same partition and submeshes as JAX's."""
    monkeypatch.setattr(jprof, "get_effective_calibration", lambda: None)
    monkeypatch.setattr(jprof, "get_global_calibration", lambda: None)

    def injected(costs, *args, **kwargs):
        rng = np.random.default_rng(11)
        L, _, M = costs.shape
        base = rng.uniform(0.5, 1.5, size=(L, M))
        for i in range(L):
            for j in range(i, L):
                for m in range(M):
                    costs[i, j, m] = base[i:j + 1, m].sum() / (1 + m) ** 0.8
        return costs.size

    monkeypatch.setattr(tprof, "refine_costs_measured", injected)
    monkeypatch.setattr(jprof, "refine_costs_measured", injected)
    seen = {}
    solve = jdp.stage_dp_solve

    def recording(costs, *args, **kwargs):
        seen["part"] = solve(costs, *args, **kwargs)
        return seen["part"]

    monkeypatch.setattr(jdp, "stage_dp_solve", recording)
    j_state, t_state, jb, batch = _mlp_states()
    j_step = alpa_tpu.parallelize(_jax_mlp_step, method=(
        alpa_tpu.PipeshardParallel(
            devices=_jax_mesh(8), num_micro_batches=2,
            layer_option=jlc.AutoLayerOption(layer_num=4),
            stage_option=jstage.AutoStageOption(profiling_mode="measured"))))
    j_step(j_state, jb)
    t_step = alpa_tpu_torch.parallelize(_port_mlp_step, method=(
        PipeshardParallel(
            devices=["cpu"] * 8, num_micro_batches=2,
            layer_option=AutoLayerOption(layer_num=4),
            stage_option=AutoStageOption(profiling_mode="measured"))))
    t_step(t_state, batch)
    info = t_step.get_last_executable().stage_dp_info
    choices = jstage.get_submesh_choices(1, 8)
    assert info["partition"] == [(a, b, choices[m])
                                 for a, b, m in seen["part"]]
    assert info["measured"] > 0
    assert t_step.get_last_executable().mesh_sizes == [
        choices[m][0] * choices[m][1] for _, _, m in seen["part"]]


def test_profile_one_mesh_on_cpu_devices(tmp_path):
    res = tprof.profile_one_mesh(["cpu"] * 2, sizes=(1 << 10, 1 << 14),
                                 dot_ns=(32, 64), repeat=2)
    fit = res.fit()
    assert set(fit.collective_ab) == set(tprof.COLLECTIVE_KINDS)
    assert all(a >= 0 and b > 0 for a, b in fit.collective_ab.values())
    assert len(fit.dot_points) == 2
    sig = tprof.mesh_signature(["cpu"] * 2)
    assert sig == "1x2-cpu-plain"
    db = tprof.ProfilingResultDatabase({sig: res})
    db.save(str(tmp_path / "db.json"))
    loaded = tprof.calibration_from_file(str(tmp_path / "db.json"))
    assert loaded.backend == "plain"
    assert loaded.collective_ab == fit.collective_ab
    assert tprof.calibration_from_file(str(tmp_path / "db.json"),
                                       "nccl") is None
    cluster = alpa_tpu_torch.device_mesh.DeviceCluster(["cpu"] * 2)
    db2 = tprof.profile_all(cluster, sizes=(1 << 10,), dot_ns=(32,),
                            repeat=1)
    assert list(db2.data) == [sig]


def test_platform_gate(monkeypatch):
    """An analytic NVLink table backfills distinct cards ("nccl") only;
    any other platform or backend gets the measured table as it is (None
    here), and a logical mesh takes the process calibration only where
    its backend matches."""
    from alpa_tpu_torch.telemetry import perf as tperf
    assert tprof.get_effective_calibration("cpu") is None
    assert tprof.get_effective_calibration("cuda", "plain") is None
    monkeypatch.setattr(tperf, "detect_gpu_generation",
                        lambda device=None: "h100-sxm")
    nccl = tprof.get_effective_calibration("cuda", "nccl")
    assert nccl.backend == "nccl"
    for kind in tprof.COLLECTIVE_KINDS:
        alpha, beta = nccl.alpha_beta(kind)
        assert beta == 1.0 / tperf.GPU_SPECS["h100-sxm"][
            "nvlink_bytes_per_s"]
    # JAX's own gate: the CPU gets the measured table untouched
    cal_cpu = jprof.get_effective_calibration(platform="cpu")
    assert cal_cpu is None or cal_cpu.collective_ab
    measured = tprof.profile_one_mesh(["cpu"] * 2, sizes=(1 << 10,),
                                      dot_ns=(32,), repeat=1).fit()
    measured.backend = "plain"
    tprof.set_global_calibration(measured)
    assert PhysicalDeviceMesh(["cpu"] * 2).get_logical_mesh(
        (1, 2)).calibration is measured
    measured.backend = "nccl"
    assert PhysicalDeviceMesh(["cpu"] * 2).get_logical_mesh(
        (1, 2)).calibration is None
    plain, over_nccl = (tcal.collective_signature("all_reduce", 1 << 20,
                                                  "h100-sxm", b)
                        for b in ("plain", "nccl"))
    assert plain != over_nccl and "backend=nccl" in over_nccl
    merged = tprof.merge_calibrations(
        tprof.CalibratedCostModel([], {"all_reduce": (1e-6, 1e-10)},
                                  "nccl"), nccl)
    assert merged.alpha_beta("all_reduce") == (1e-6, 1e-10)
    assert merged.alpha_beta("all_gather") == nccl.alpha_beta("all_gather")
