"""The port's pipeshard inference path against the JAX package's.

Mirrors ``tests/pipeline_parallel/test_pipeshard.py``'s
``TestPipeshardInference`` and ``test_stage_dp_inflight_modes``: a
forward-only function under ``PipeshardParallel(pipeline_schedule=
"inference")`` returns JAX's output (rtol 2e-5, atol 1e-5, the JAX test's
tolerance) on the MLP fixture and on a 4-layer GPT's logits, with
``UniformStageOption`` and with ``AutoStageOption``; the stage DP's
inference objective (B = 4096, one microbatch in flight) gives JAX's
partitions; a scalar output with microbatching raises ``ValueError``; the
path donates nothing.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import testing as jtesting
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.pipeline_parallel import layer_construction as jlc
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.pipeline_parallel import stage_dp as jdp
from alpa_tpu_torch import (AutoLayerOption, AutoStageOption,
                            ManualLayerOption, PipeshardParallel,
                            UniformStageOption)
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.mesh_profiling import estimate_stage_memory_split
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from alpa_tpu_torch.pipeline_parallel import stage_dp as tdp

RTOL, ATOL = 2e-5, 1e-5


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


def _stage_options(kind, jax_devices=None):
    if kind == "uniform":
        return (jstage.UniformStageOption(num_stages=2),
                UniformStageOption(2), ["cpu"] * 2)
    return jstage.AutoStageOption(), AutoStageOption(), ["cpu"]


def _mlp():
    """The JAX test's fixture (batch 64, 4 layers) and the port's state on
    its weights."""
    state, batch = jtesting.create_mlp_train_state_and_batch(batch_size=64,
                                                             num_layers=4)
    np_batch = {k: np.asarray(v) for k, v in batch.items()}
    t_state, _ = ttesting.create_mlp_train_state_and_batch(
        batch_size=64, num_layers=4,
        params=jax.tree_util.tree_map(np.asarray, state.params),
        x=np_batch["x"], y=np_batch["y"])
    return state, batch, t_state, np_batch


@pytest.mark.parametrize("stages", ["uniform", "auto"])
def test_mlp_forward_only_equals_jax(stages):
    """``test_pipelined_forward_only`` (2 auto layers, 2 uniform stages) and
    ``test_auto_stage_inference_objective`` (4 auto layers,
    ``AutoStageOption``; the port's on one device): the port's output equals
    the JAX package's pipeshard output and its plain forward."""
    alpa_tpu.init(cluster="local")
    state, batch, t_state, np_batch = _mlp()
    j_stage, t_stage, devices = _stage_options(stages)
    layers = 2 if stages == "uniform" else 4

    @alpa_tpu.parallelize(method=alpa_tpu.PipeshardParallel(
        num_micro_batches=2, layer_option=jlc.AutoLayerOption(layer_num=layers),
        stage_option=j_stage, pipeline_schedule="inference"),
        batch_argnums=(1,))
    def j_forward(state, batch):
        return state.apply_fn(state.params, batch["x"])

    @alpa_tpu_torch.parallelize(method=PipeshardParallel(
        devices=devices, num_micro_batches=2,
        layer_option=AutoLayerOption(layer_num=layers),
        stage_option=t_stage, pipeline_schedule="inference"),
        batch_argnums=(1,))
    def t_forward(state, batch):
        return state.apply_fn(state.params, batch["x"])

    want = np.asarray(j_forward(state, batch))
    got = t_forward(t_state, np_batch).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(
        got, np.asarray(state.apply_fn(state.params, batch["x"])),
        rtol=RTOL, atol=ATOL)
    ex = t_forward.get_last_executable()
    assert not ex.has_bwd and not any(ex.apply_execs)
    assert ex.schedule.__class__.__name__ == "InferenceSchedule"
    if stages == "auto":
        info = ex.stage_dp_info
        assert info["objective"] == "inference"
        assert info["partition"] == [(0, 4, (1, 1))]


def test_scalar_output_with_microbatching_raises():
    """``test_scalar_output_with_microbatching_errors``: a scalar output
    of a pipelined forward-only function with 2 microbatches."""
    _, _, t_state, np_batch = _mlp()

    @alpa_tpu_torch.parallelize(method=PipeshardParallel(
        devices=["cpu"] * 2, num_micro_batches=2,
        layer_option=AutoLayerOption(layer_num=2),
        stage_option=UniformStageOption(2), pipeline_schedule="inference"),
        batch_argnums=(1,))
    def mean_out(state, batch):
        return torch.mean(state.apply_fn(state.params, batch["x"]))

    with pytest.raises(ValueError, match="scalar output"):
        mean_out(t_state, np_batch)


def test_inference_donates_nothing_and_runs_again():
    """The inference path donates nothing (``compile_executable.py:424``):
    the state stays usable, a second call gives the same output, and no
    storage is released."""
    _, _, t_state, np_batch = _mlp()
    method = PipeshardParallel(devices=["cpu"] * 2, num_micro_batches=4,
                               layer_option=AutoLayerOption(layer_num=2),
                               stage_option=UniformStageOption(2),
                               pipeline_schedule="inference")
    forward = alpa_tpu_torch.parallelize(
        lambda s, b: s.apply_fn(s.params, b["x"]), method=method)
    assert not any(forward.get_donated_invars(t_state, np_batch))
    first = forward(t_state, np_batch)
    second = forward(t_state, np_batch)
    assert torch.equal(first, second)
    assert all(p.untyped_storage().nbytes() > 0
               for p in t_state.params.values())


GPT_SHAPE = dict(hidden_size=64, num_layers=4, num_heads=4, seq_len=32,
                 vocab_size=128)


@pytest.mark.parametrize("layers", ["manual", "auto"])
@pytest.mark.parametrize("stages", ["uniform", "auto"])
def test_gpt_logits_equal_jax(layers, stages):
    """A 4-layer GPT (hidden 64, flash attention: Pallas in interpret mode
    on the JAX side, the plain version here), forward only, batch 4 in 2
    microbatches: the logits equal ``jax.jit`` of the JAX GPT on the same
    weights, with manual layers (a boundary every 2 blocks) or 2 auto
    layers, in 2 uniform stages or by ``AutoStageOption`` (one device)."""
    cfg = dict(GPT_SHAPE, attention_impl="flash",
               pipeline_boundary_every=2 if layers == "manual" else 0)
    jmodel = jgm.GPTModel(jgm.GPTConfig(**cfg))
    ids = np.random.default_rng(11).integers(0, GPT_SHAPE["vocab_size"],
                                             (4, GPT_SHAPE["seq_len"]))
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0),
                                  jnp.asarray(ids, jnp.int32))
    want = np.asarray(jax.jit(jmodel.apply)(params,
                                            jnp.asarray(ids, jnp.int32)))
    tcfg = tgm.GPTConfig(**cfg)
    model = tgm.GPTModel(tcfg, device="meta", param_dtype=torch.float32)
    model = model.to_empty(device="cpu")
    model.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                               param_dtype=torch.float32))
    state = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(model),
                                  params=dict(model.named_parameters()),
                                  tx=tmu.sgd(1e-2))
    _, t_stage, devices = _stage_options(stages)
    forward = alpa_tpu_torch.parallelize(
        lambda s, b: s.apply_fn(s.params, b["input_ids"]),
        method=PipeshardParallel(
            devices=devices, num_micro_batches=2,
            layer_option=(ManualLayerOption() if layers == "manual"
                          else AutoLayerOption(layer_num=2)),
            stage_option=t_stage, pipeline_schedule="inference"))
    got = forward(state, {"input_ids": ids}).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    ex = forward.get_last_executable()
    assert ex.get_instruction_counts()["RUN"] == 2 * ex.num_fwd_stages


def test_stage_dp_inflight_modes():
    """``test_stage_dp_inflight_modes`` on the port's solver: memory
    feasibility follows the schedule's in-flight profile (inference holds
    one microbatch per stage whatever B; GPipe stacks all B; the
    overlap-friendly schedule about twice 1F1B), and the port's native and
    Python solvers return JAX's partition mode by mode."""
    L, D, B = 4, 4, 4096
    C = np.full((L, L, 1), np.inf)
    for i in range(L):
        for j in range(i, L):
            C[i, j, 0] = (j - i + 1) * 1.0
    mem_p, mem_a, sizes = np.ones((L, L, 1)), np.full((L, L, 1), 2.0), [1]
    for mod in (tdp, jdp):
        assert mod.stage_dp_solve(C, sizes, D, B, mem_p, mem_a,
                                  mem_budget=3.0,
                                  inflight_mode="1f1b") is None
        part = mod.stage_dp_solve(C, sizes, D, B, mem_p, mem_a,
                                  mem_budget=3.0, inflight_mode="inference")
        assert part is not None and len(part) == 4
        assert mod.stage_dp_solve(C, sizes, D, 4, mem_p, mem_a,
                                  mem_budget=5.0,
                                  inflight_mode="gpipe") is None
        assert mod.stage_dp_solve(C, sizes, D, 100, mem_p, mem_a,
                                  mem_budget=9.0,
                                  inflight_mode="1f1b") is not None
        assert mod.stage_dp_solve(
            C, sizes, D, 100, mem_p, mem_a, mem_budget=9.0,
            inflight_mode="1f1b_overlap_friendly") is None
    for name, code in tdp._INFLIGHT_MODES.items():
        want = jdp.stage_dp_solve(C, sizes, D, 100, mem_p, mem_a,
                                  mem_budget=9.0, inflight_mode=name)
        assert tdp.stage_dp_solve(C, sizes, D, 100, mem_p, mem_a,
                                  mem_budget=9.0, inflight_mode=name) == want
        assert tdp._stage_dp_python(C, np.array(sizes), D, 100, mem_p,
                                    mem_a, 9.0, code) == want


def test_inference_objective_partitions_equal_jax():
    """The inference objective's DP (B -> 4096, "inference" in flight) on
    the JAX validation test's random cost and memory tensors: the port's
    partitions equal JAX's on every instance."""
    rng = np.random.RandomState(0)
    sizes = [1, 2, 4]
    for n in range(25):
        L = int(rng.randint(2, 7))
        C = rng.uniform(0.1, 1.0, size=(L, L, len(sizes)))
        for m in range(len(sizes)):
            for i in range(L):
                for j in range(i, L):
                    C[i, j, m] = C[i:j + 1, i:j + 1, m].diagonal().sum()
        C[rng.uniform(size=C.shape) < 0.1] = np.inf
        mem_p = rng.uniform(0.0, 1.0, size=C.shape)
        mem_a = rng.uniform(0.0, 0.5, size=C.shape)
        budget = float(rng.choice([0.0, 1.5, 3.0]))
        want = jdp.stage_dp_solve(C, sizes, 4, 4096, mem_p, mem_a, budget,
                                  "inference")
        assert tdp.stage_dp_solve(C, sizes, 4, 4096, mem_p, mem_a, budget,
                                  "inference") == want, n


def test_auto_stage_dp_takes_the_inference_objective(monkeypatch):
    """A forward-only function's stage DP solves with B = 4096 and the
    "inference" inflight mode, as JAX's ``auto_stage_dp`` with
    ``objective="inference"``; its memory estimate carries no optimizer
    state (a third of the training estimate's parameter term)."""
    seen = {}
    solve = tdp.stage_dp_solve

    def recording(costs, sizes, D, B, *args, **kwargs):
        seen["B"], seen["mode"] = B, kwargs.get("inflight_mode")
        return solve(costs, sizes, D, B, *args, **kwargs)

    monkeypatch.setattr(tdp, "stage_dp_solve", recording)
    _, _, t_state, np_batch = _mlp()
    forward = alpa_tpu_torch.parallelize(
        lambda s, b: s.apply_fn(s.params, b["x"]),
        method=PipeshardParallel(
            devices=["cpu"], num_micro_batches=2,
            layer_option=AutoLayerOption(layer_num=4),
            stage_option=AutoStageOption(memory_budget_per_device=1e12),
            pipeline_schedule="inference"))
    forward(t_state, np_batch)
    assert seen == {"B": 4096, "mode": "inference"}
    comps = forward.get_last_executable().fwd_layer_comps
    infer = estimate_stage_memory_split(comps, 1, "inference")
    train = estimate_stage_memory_split(comps, 1, "training")
    assert infer[1] == train[1] and train[0] == pytest.approx(3 * infer[0])
