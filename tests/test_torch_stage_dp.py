"""The port's stage DP against the JAX package's.

The native solver (``alpa_tpu_torch/csrc/stage_dp.cc``, built with g++)
and the Python one must return the JAX package's partitions, identical, on
the random cost and memory tensors of
``tests/pipeline_parallel/test_stage_dp_validation.py`` in every inflight
mode.  ``AutoStageOption`` must choose JAX's partition on the fixtures: on one
device with the communication term off on both sides (JAX's cost model
pinned to the port's seconds-per-flop constant and its intra-op ILP made
to raise, which JAX's ``estimate_stage_cost`` takes as a zero
communication term), and on two devices with it on, both cost models on
their uncalibrated path.
The layers' product flops in the two cost tensors are equal.  The rest of
a layer's flops is not compared here: JAX's forward layer also holds the
linearization's residual ops (relu's mask, the square's derivative), which
autograd computes in the backward, about 6% of a layer of the 32-wide MLP.
"""
import numpy as np
import optax
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import mesh_profiling as jprof
from alpa_tpu import testing as jtesting
from alpa_tpu.device_mesh import get_global_cluster
from alpa_tpu.pipeline_parallel import layer_construction as jlc
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.pipeline_parallel import stage_dp as jdp
from alpa_tpu.shard_parallel import ilp as jilp
from alpa_tpu.util import jaxpr_eqn_flops
from alpa_tpu_torch import AutoLayerOption, AutoStageOption, PipeshardParallel
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.pipeline_parallel import stage_construction as tstage
from alpa_tpu_torch.pipeline_parallel import stage_dp as tdp
from alpa_tpu_torch.util import product_flops

MODES = ["1f1b", "gpipe", "1f1b_overlap_friendly", "inference"]


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Restore torch's global RNG so these tests leave other tests' draws
    alone."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _fresh_compile_cache():
    """A fresh memory-only compile cache per test: a plan cached by an
    earlier test in the process would skip the solves these tests watch."""
    from alpa_tpu_torch.compile_cache import reset_compile_cache
    reset_compile_cache()
    yield
    reset_compile_cache()


@pytest.fixture(autouse=True)
def _port_cluster():
    yield
    alpa_tpu_torch.shutdown()


def _instances():
    """The random instances of ``test_dp_matches_bruteforce_random``."""
    rng = np.random.RandomState(0)
    sizes = [1, 2, 4]
    for _ in range(25):
        L = int(rng.randint(2, 7))
        B = int(rng.randint(1, 9))
        C = rng.uniform(0.1, 1.0, size=(L, L, len(sizes)))
        for m in range(len(sizes)):
            for i in range(L):
                for j in range(i, L):
                    C[i, j, m] = C[i:j + 1, i:j + 1, m].diagonal().sum()
        C[rng.uniform(size=C.shape) < 0.1] = np.inf
        mem_param = rng.uniform(0.0, 1.0, size=C.shape)
        mem_act = rng.uniform(0.0, 0.5, size=C.shape)
        budget = float(rng.choice([0.0, 1.5, 3.0]))
        yield C, sizes, 4, B, mem_param, mem_act, budget


@pytest.mark.parametrize("mode", MODES)
def test_native_and_python_dp_equal_jax_on_the_validation_tensors(mode):
    """Every instance of the JAX package's validation test: the port's
    native solver, its Python solver, JAX's ``stage_dp_solve`` and JAX's
    ``_stage_dp_python`` return the same partition (or all None)."""
    code = tdp._INFLIGHT_MODES[mode]
    for n, (C, sizes, D, B, mp, ma, budget) in enumerate(_instances()):
        want = jdp.stage_dp_solve(C, sizes, D, B, mp, ma, budget, mode)
        args = (np.ascontiguousarray(C), np.asarray(sizes, np.int64), D, B,
                np.ascontiguousarray(mp), np.ascontiguousarray(ma), budget,
                code)
        assert jdp._stage_dp_python(*args) == want, n
        assert tdp.stage_dp_solve(C, sizes, D, B, mp, ma, budget,
                                  mode) == want, n
        assert tdp._stage_dp_python(*args) == want, n


def test_dp_positional_memory_and_linear_scaling_equal_jax():
    """The validation test's hand-made cases: the positional memory check
    (1F1B fits, GPipe does not) and the balanced 2 x (1, 8) solution under
    near-linear scaling."""
    C = np.full((2, 2, 1), np.inf)
    C[0, 0, 0] = C[1, 1, 0] = 1.0
    C[0, 1, 0] = 2.0
    mp, ma = np.zeros_like(C), np.ones_like(C)
    for mode in ("1f1b", "gpipe"):
        assert tdp.stage_dp_solve(C, [1], 1, 8, mp, ma, 2.5, mode) == \
            jdp.stage_dp_solve(C, [1], 1, 8, mp, ma, 2.5, mode)
    sizes = [1, 2, 4, 8]
    eff = {1: 1.0, 2: 0.95, 4: 0.95, 8: 0.95}
    C = np.zeros((8, 8, 4))
    for m, n in enumerate(sizes):
        for i in range(8):
            for j in range(i, 8):
                C[i, j, m] = (j - i + 1) / (n * eff[n])
    assert tdp.stage_dp_solve(C, sizes, 16, 64) == \
        jdp.stage_dp_solve(C, sizes, 16, 64) == [(0, 4, 3), (4, 8, 3)]


def test_native_solver_builds_with_gxx_and_reports_its_abi():
    lib = tdp.load_native()
    assert int(lib.stage_dp_abi_version()) == tdp._ABI_VERSION == 2
    assert tdp.load_native() is lib


@pytest.mark.parametrize("space", ["all", "power_of_two",
                                   "small_power_of_two"])
def test_submesh_choices_equal_jax(space):
    for hosts in range(1, 9):
        for per_host in (1, 2, 4, 8):
            assert tstage.get_submesh_choices(hosts, per_host, space) == \
                jstage.get_submesh_choices(hosts, per_host, space)
    with pytest.raises(ValueError):
        tstage.get_submesh_choices(1, 3)
    with pytest.raises(ValueError):
        tstage.get_submesh_choices(2, 2, "triangle")


class _Solved(Exception):
    """Ends a JAX compile once its stage DP has solved."""


@pytest.fixture
def jax_cost_model_without_comm(monkeypatch):
    """JAX's stage cost with one constant seconds-per-flop (the port's) and
    no communication term (its ILP raises, which ``estimate_stage_cost``
    takes as zero); records the cost tensor and layer computations each
    JAX solve sees."""
    monkeypatch.setattr(jprof, "get_effective_calibration", lambda: None)
    monkeypatch.setattr(jprof, "get_global_calibration", lambda: None)
    monkeypatch.setattr(jprof, "DEFAULT_SEC_PER_FLOP", tdp.SEC_PER_FLOP)

    def no_ilp(*args, **kwargs):
        raise RuntimeError("the intra-op ILP is off in this comparison")

    monkeypatch.setattr(jilp, "solve_strategy_graph", no_ilp)
    seen = {}
    solve, stage_dp = jdp.stage_dp_solve, jdp.auto_stage_dp

    def recording_solve(costs, *args, **kwargs):
        seen["costs"] = np.array(costs)
        seen["part"] = solve(costs, *args, **kwargs)
        if seen.get("stop_after_solve"):
            raise _Solved
        return seen["part"]

    def recording_dp(num_layers, vmesh, option, flops, comps, *args, **kw):
        seen["comps"] = comps
        return stage_dp(num_layers, vmesh, option, flops, comps, *args, **kw)

    monkeypatch.setattr(jdp, "stage_dp_solve", recording_solve)
    monkeypatch.setattr(jdp, "auto_stage_dp", recording_dp)
    return seen


@pytest.fixture
def port_stage_dp(monkeypatch):
    """Records the layer computations each port solve sees."""
    seen = {}
    stage_dp = tdp.auto_stage_dp

    def recording_dp(num_layers, vmesh, option, comps, *args, **kwargs):
        seen["comps"] = comps
        return stage_dp(num_layers, vmesh, option, comps, *args, **kwargs)

    monkeypatch.setattr(tdp, "auto_stage_dp", recording_dp)
    return seen


def _jax_partition(seen, num_devices):
    """JAX's recorded partition, with submesh shapes for its indices."""
    choices = jstage.get_submesh_choices(1, num_devices)
    return [(a, b, choices[m]) for a, b, m in seen["part"]]


def _jax_mesh(num_devices):
    alpa_tpu.init(cluster="local")
    return get_global_cluster().get_virtual_physical_mesh(
        num_devices_per_host=num_devices)


def _gpt_steps():
    """(JAX state, port state, JAX step, port step, batch) of a 4-layer GPT
    (hidden 64) with reference attention."""
    import jax
    import jax.numpy as jnp
    from flax.training import train_state as flax_train_state

    from alpa_tpu.model import gpt_model as jgm
    from alpa_tpu.model import model_util as jmu
    from alpa_tpu_torch.model import gpt_model as tgm
    from alpa_tpu_torch.model.convert import gpt_params_from_flax

    shape = dict(hidden_size=64, num_layers=4, num_heads=4, seq_len=32,
                 vocab_size=128)
    jmodel = jgm.GPTModel(jgm.GPTConfig(**shape))
    rng = np.random.default_rng(5)
    batch = {k: rng.integers(0, 128, (4, 32)) for k in ("input_ids",
                                                        "labels")}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb["input_ids"])
    tcfg = tgm.GPTConfig(**shape)
    tmodel = tgm.GPTModel(tcfg, device="meta", param_dtype=torch.float32)
    tmodel = tmodel.to_empty(device="cpu")
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                                param_dtype=torch.float32))
    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply, params=params, tx=optax.adam(1e-3))
    t_state = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(tmodel),
                                    params=dict(tmodel.named_parameters()),
                                    tx=tmu.adam(1e-3))

    def j_step(state, batch):
        loss, grads = alpa_tpu.value_and_grad(
            lambda p: jmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    def t_step(state, batch):
        loss, grads = alpa_tpu_torch.value_and_grad(
            lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    return j_state, t_state, j_step, t_step, jb, batch


def _mlp_states():
    """(JAX state, port state, JAX batch, numpy batch) of the 4-layer MLP
    fixture, from the same weights and batch."""
    import jax

    j_state, jb = jtesting.create_mlp_train_state_and_batch(batch_size=16,
                                                            num_layers=4)
    batch = {k: np.asarray(v) for k, v in jb.items()}
    t_state, _ = ttesting.create_mlp_train_state_and_batch(
        batch_size=16, num_layers=4,
        params=jax.tree_util.tree_map(np.asarray, j_state.params),
        x=batch["x"], y=batch["y"])
    return j_state, t_state, jb, batch


def _jax_product_flops(comp):
    return sum(jaxpr_eqn_flops(e) for e in comp.eqns
               if e.primitive.name in jlc.HEAVY_PRIMS)


@pytest.mark.parametrize("model", ["mlp", "gpt"])
def test_auto_stage_option_chooses_jax_partition(model,
                                                 jax_cost_model_without_comm,
                                                 port_stage_dp):
    """``AutoStageOption`` on one device with 4 auto layers and 2
    microbatches: the same partition as JAX's ``auto_stage_dp``, the same
    product flops per layer, a cost tensor of JAX's shape that holds the
    layers' flops x the seconds per flop, and the step's loss equal to
    JAX's (rtol 1e-5)."""
    if model == "mlp":
        j_state, t_state, jb, batch = _mlp_states()
        j_step, t_step = _jax_mlp_step, _port_mlp_step
    else:
        j_state, t_state, j_step, t_step, jb, batch = _gpt_steps()
    j_pstep = alpa_tpu.parallelize(j_step, method=alpa_tpu.PipeshardParallel(
        devices=_jax_mesh(1), num_micro_batches=2,
        layer_option=jlc.AutoLayerOption(layer_num=4),
        stage_option=jstage.AutoStageOption()))
    t_pstep = alpa_tpu_torch.parallelize(t_step, method=PipeshardParallel(
        devices=["cpu"], num_micro_batches=2,
        layer_option=AutoLayerOption(layer_num=4),
        stage_option=AutoStageOption()))
    _, j_loss = j_pstep(j_state, jb)
    _, t_loss = t_pstep(t_state, batch)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    info = t_pstep.get_last_executable().stage_dp_info
    assert info["partition"] == _jax_partition(
        jax_cost_model_without_comm, 1) == [(0, 4, (1, 1))]
    assert info["solver"].startswith("native")
    t_comps, j_comps = port_stage_dp["comps"], jax_cost_model_without_comm[
        "comps"]
    assert [sum(map(product_flops, c.nodes)) for c in t_comps] == \
        [_jax_product_flops(c) for c in j_comps]
    flops = info["layer_flops"]
    assert info["costs"].shape == jax_cost_model_without_comm["costs"].shape
    for i in range(4):
        for j in range(i, 4):
            assert info["costs"][i, j, 0] == \
                sum(flops[i:j + 1]) * tdp.SEC_PER_FLOP


def _jax_mlp_step(state, batch):
    import jax.numpy as jnp

    def loss_fn(params):
        return jnp.mean((state.apply_fn(params, batch["x"]) - batch["y"]) ** 2)

    loss, grads = alpa_tpu.value_and_grad(loss_fn)(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_mlp_step(state, batch):

    def loss_fn(params):
        return torch.mean((state.apply_fn(params, batch["x"]) -
                           batch["y"]) ** 2)

    loss, grads = alpa_tpu_torch.value_and_grad(loss_fn)(state.params)
    return state.apply_gradients(grads=grads), loss


def test_multi_device_optimum_raises_roadmap_a3(monkeypatch):
    """On two devices (where, without a communication term, the port once
    raised citing ROADMAP A.3 rather than run a stage of two devices):
    both stage DPs, with the communication term on their uncalibrated path
    (JAX's calibration set to None), choose the same partition, and the
    port's step runs it and equals JAX's (rtol 1e-5)."""
    monkeypatch.setattr(jprof, "get_effective_calibration", lambda: None)
    monkeypatch.setattr(jprof, "get_global_calibration", lambda: None)
    seen = {}
    solve = jdp.stage_dp_solve

    def recording_solve(costs, *args, **kwargs):
        seen["part"] = solve(costs, *args, **kwargs)
        return seen["part"]

    monkeypatch.setattr(jdp, "stage_dp_solve", recording_solve)
    j_state, t_state, jb, batch = _mlp_states()
    j_pstep = alpa_tpu.parallelize(_jax_mlp_step,
                                   method=alpa_tpu.PipeshardParallel(
                                       devices=_jax_mesh(2),
                                       num_micro_batches=2,
                                       layer_option=jlc.AutoLayerOption(
                                           layer_num=2),
                                       stage_option=jstage.AutoStageOption()))
    _, j_loss = j_pstep(j_state, jb)
    t_pstep = alpa_tpu_torch.parallelize(_port_mlp_step,
                                         method=PipeshardParallel(
                                             devices=["cpu"] * 2,
                                             num_micro_batches=2,
                                             layer_option=AutoLayerOption(
                                                 layer_num=2),
                                             stage_option=AutoStageOption()))
    _, t_loss = t_pstep(t_state, batch)
    info = t_pstep.get_last_executable().stage_dp_info
    assert info["partition"] == _jax_partition(seen, 2)
    assert info["ilp_solves"] == 3   # the (1, 2) submesh's three spans
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)


def _prof_db(path, backend_key, flops_per_s=5e10):
    """A profiling database of the two-device CPU mesh under the key
    ``backend_key``: a dot ladder at ``flops_per_s`` and every collective
    kind, fitted alike by both packages."""
    from alpa_tpu_torch import mesh_profiling as tprof
    res = tprof.MeshProfilingResult()
    for n in (64, 256, 1024):
        res.record("dot", ("float32",), 2.0 * n ** 3,
                   2.0 * n ** 3 / flops_per_s)
    for kind in tprof.COLLECTIVE_KINDS:
        for size in (1e3, 1e5, 1e7):
            res.record(kind, ("f32", 2, "plain"), size, 2e-5 + size / 4e9)
    db = tprof.ProfilingResultDatabase({backend_key: res})
    db.save(str(path))
    return str(path)


@pytest.mark.parametrize("field, value", [
    ("profiling_mode", "measured"),
    ("cached_compute_cost", "costs.npz"),
    ("profiling_database_filename", "db.json"),
    ("measured_candidates_limit", 3),
    ("measured_compile_workers", 1),
])
def test_auto_stage_fields_act_as_jax(field, value, tmp_path, monkeypatch):
    """Each field of ``AutoStageOption`` that the port once refused is
    taken and acts as JAX's does, on the 4-layer MLP in 2 auto layers over
    two CPU devices: measured profiling refines candidates (all of the
    shortlist, or ``measured_candidates_limit`` of it; one compile worker
    alike) and the step's loss equals JAX's; ``cached_compute_cost``
    writes the tensors and a second compile reads them back to the same
    partition; ``profiling_database_filename`` prices the cost tensor in
    the database's seconds, where both packages choose the same partition
    and costs within 1e-9 relative of JAX's fit."""
    from alpa_tpu_torch import mesh_profiling as tprof
    from alpa_tpu_torch.compile_cache import get_compile_cache
    monkeypatch.setattr(jprof, "get_effective_calibration", lambda: None)
    monkeypatch.setattr(jprof, "get_global_calibration", lambda: None)
    kw = {field: value}
    if field.startswith("measured_"):
        kw["profiling_mode"] = "measured"
    if field == "cached_compute_cost":
        kw[field] = str(tmp_path / value)
    if field == "profiling_database_filename":
        kw[field] = _prof_db(tmp_path / "port_db.json", "1x2-cpu-plain")
    j_state, _, jb, batch = _mlp_states()

    def port_step():
        step = alpa_tpu_torch.parallelize(_port_mlp_step,
                                          method=PipeshardParallel(
            devices=["cpu"] * 2, num_micro_batches=2,
            layer_option=AutoLayerOption(layer_num=2),
            stage_option=AutoStageOption(**kw)))
        _, loss = step(_mlp_states()[1], batch)
        return step.get_last_executable().stage_dp_info, float(loss)

    info, t_loss = port_step()
    if kw.get("profiling_mode") == "measured":
        n_short = len(tprof.shortlist_candidates(
            np.where(np.isfinite(info["costs"]), 1.0, np.inf), [1, 2], 2,
            10 ** 6))
        want = min(n_short, kw.get("measured_candidates_limit", 16))
        assert info["measured"] == want > 0
        assert np.isfinite(info["costs"]).sum() >= want
    if field == "cached_compute_cost":
        assert (tmp_path / value).exists() and not info["cost_cache_hit"]
        get_compile_cache().clear()
        again, _ = port_step()
        assert again["cost_cache_hit"]
        assert again["partition"] == info["partition"]
        np.testing.assert_array_equal(again["costs"], info["costs"])
    if field == "profiling_database_filename":
        assert info["calibrated"]
        jdb = tmp_path / "jax_db.json"
        jprof.ProfilingResultDatabase({"1x2-cpu": jprof.MeshProfilingResult
                                       .from_json(tprof.ProfilingResultDatabase
                                                  .load(kw[field])
                                                  .data["1x2-cpu-plain"]
                                                  .to_json())}).save(str(jdb))
        jcal = jprof.calibration_from_file(str(jdb))
        tcal = tprof.calibration_from_file(kw[field], "plain")
        assert tcal.collective_ab == jcal.collective_ab
        assert tcal.dot_points == jcal.dot_points
        for f in (1e6, 1e9, 1e12):
            assert tcal.sec_per_flop(f) == pytest.approx(
                jcal.sec_per_flop(f), rel=1e-9)
    seen = {}
    solve = jdp.stage_dp_solve

    def recording_solve(costs, *args, **kwargs):
        seen["part"] = solve(costs, *args, **kwargs)
        return seen["part"]

    monkeypatch.setattr(jdp, "stage_dp_solve", recording_solve)
    jkw = dict(kw)
    if field == "profiling_database_filename":
        jkw[field] = str(tmp_path / "jax_db.json")
    if field == "cached_compute_cost":
        jkw[field] = str(tmp_path / "jax_costs.npz")
    j_pstep = alpa_tpu.parallelize(_jax_mlp_step,
                                   method=alpa_tpu.PipeshardParallel(
                                       devices=_jax_mesh(2),
                                       num_micro_batches=2,
                                       layer_option=jlc.AutoLayerOption(
                                           layer_num=2),
                                       stage_option=jstage.AutoStageOption(
                                           **jkw)))
    _, j_loss = j_pstep(j_state, jb)
    np.testing.assert_allclose(t_loss, float(j_loss), rtol=1e-5)
    if kw.get("profiling_mode") != "measured":
        # measured times differ run to run; the modelled paths agree
        assert info["partition"] == _jax_partition(seen, 2)


def test_use_hlo_cost_model_chooses_exact_or_per_layer_costs():
    """``use_hlo_cost_model=False`` solves the ILP of every merged span
    (three on the (1, 2) submesh of 2 layers); on a search space above
    ``L * L * M = 256`` the default sums per-layer ILPs (one per layer and
    wide submesh), as the JAX package's ``auto_stage_dp`` does."""
    _, t_state, _, batch = _mlp_states()
    step = alpa_tpu_torch.parallelize(_port_mlp_step, method=PipeshardParallel(
        devices=["cpu"] * 2, num_micro_batches=2,
        layer_option=AutoLayerOption(layer_num=2),
        stage_option=AutoStageOption(use_hlo_cost_model=False)))
    step(t_state, batch)
    ex = step.get_last_executable()
    assert ex.stage_dp_info["ilp_solves"] == 3
    comps = ex.fwd_layer_comps
    info = {}
    option = AutoStageOption()
    costs = tdp.stage_cost_tensor(comps * 6, [(1, 1), (1, 2), (1, 4),
                                              (1, 8)], option,
                                  alpa_tpu_torch.AutoShardingOption(), info)
    assert info["ilp_solves"] == 12 * 3   # L = 12: 12 * 12 * 4 > 256
    assert np.allclose(costs[0, 11], 6 * costs[0, 1])


def test_memory_budget_and_imbalance_tolerance_follow_jax():
    """The memory tensors of the budgeted DP (the port's
    ``estimate_stage_memory_split``) and the imbalance cap, on one device:
    a budget below the one stage's need leaves no partition, and a
    generous one and a tolerance of 1 keep JAX's one-stage answer."""
    _, t_state, _, batch = _mlp_states()

    def run(option):
        step = alpa_tpu_torch.parallelize(
            _port_mlp_step, method=PipeshardParallel(
                devices=["cpu"], num_micro_batches=2,
                layer_option=AutoLayerOption(layer_num=2),
                stage_option=option), donate_argnums=())
        step(t_state, batch)
        return step.get_last_executable().stage_dp_info["partition"]

    assert run(AutoStageOption(memory_budget_per_device=1e9,
                               stage_imbalance_tolerance=1.0)) == \
        [(0, 2, (1, 1))]
    with pytest.raises(RuntimeError, match="no feasible partition"):
        run(AutoStageOption(memory_budget_per_device=1.0))
