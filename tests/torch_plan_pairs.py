"""Small pipeshard plans compiled by both packages from the same numpy
weights, for the plan-analysis parity tests (``test_torch_plan_verifier``,
``test_torch_model_check``, ``test_torch_numerics``,
``test_torch_equivalence``, ``test_torch_superopt``).

``plan_pair(name)`` compiles a plan once per test process and never runs
it: ``get_executable`` compiles, and both packages lower and verify a plan
when asked for its verdict.  The plans:

* ``"mlp2-gpipe"``, ``"mlp2-1f1b"``, ``"mlp4-gpipe"``, ``"mlp4-1f1b"``: the
  MLP pair of ``test_torch_pipeshard.py`` (the fixture MLP at 2 stages, one
  Dense layer per stage at 4) in stages of one device, 2 microbatches,
  SGD with momentum;
* ``"gpt"`` and ``"gpt-bf16"``: a 2-layer narrow GPT (hidden 64, 2 heads,
  sequence 16, vocab 128, reference attention, a boundary after each
  block) in two stages of one device, 2 microbatches, 1F1B, Adam, in fp32
  and in bf16 compute;
* ``"two-level"``: the fixture MLP in two stages of two devices each (the
  JAX package on its virtual CPU devices, the port on ``["cpu"] * 4``),
  2 microbatches, 1F1B, the ILP in each stage.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch
from flax.training import train_state as flax_train_state

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.model import model_util as jmu
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.pipeline_parallel.layer_construction import \
    ManualLayerOption as JaxManualLayerOption
from alpa_tpu_torch import (ManualLayerOption, PipeshardParallel,
                            UniformStageOption)
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import gpt_params_from_flax
from test_torch_pipeshard import _mlp_pair

GPT = dict(hidden_size=64, num_layers=2, num_heads=2, seq_len=16,
           vocab_size=128, attention_impl="reference",
           pipeline_boundary_every=1)
PLANS = ("mlp2-gpipe", "mlp2-1f1b", "mlp4-gpipe", "mlp4-1f1b", "gpt",
         "gpt-bf16", "two-level")


def _jax_mlp_step(state, batch):

    def loss_fn(params):
        out = state.apply_fn(params, batch["x"])
        return jnp.mean((out - batch["y"]) ** 2)

    loss, grads = alpa_tpu.value_and_grad(loss_fn)(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_mlp_step(state, batch):

    def loss_fn(params):
        out = state.apply_fn(params, batch["x"])
        return torch.mean((out - batch["y"]) ** 2)

    loss, grads = alpa_tpu_torch.value_and_grad(loss_fn)(state.params)
    return state.apply_gradients(grads=grads), loss


def _jax_gpt_step(state, batch):
    loss, grads = alpa_tpu.value_and_grad(
        lambda p: jmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_gpt_step(state, batch):
    loss, grads = alpa_tpu_torch.value_and_grad(
        lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
    return state.apply_gradients(grads=grads), loss


def methods(name: str):
    """(JAX method, port method) of a plan."""
    stages = 4 if name.startswith("mlp4") else 2
    schedule = "gpipe" if name.endswith("gpipe") else "1f1b"
    devices = 2 if name == "two-level" else 1
    jmethod = alpa_tpu.PipeshardParallel(
        num_micro_batches=2, layer_option=JaxManualLayerOption(),
        stage_option=jstage.ManualStageOption(
            forward_stage_layer_ids=[[i] for i in range(stages)],
            submesh_physical_shapes=[(1, devices)] * stages,
            submesh_logical_shapes=[(1, devices)] * stages),
        pipeline_schedule=schedule)
    tmethod = PipeshardParallel(
        devices=["cpu"] * (stages * devices), num_micro_batches=2,
        layer_option=ManualLayerOption(),
        stage_option=UniformStageOption(stages),
        pipeline_schedule=schedule)
    return jmethod, tmethod


def mlp_states(name: str):
    """(JAX state, port state, numpy batch) of an MLP plan."""
    return _mlp_pair(4 if name.startswith("mlp4") else 2,
                     optax.sgd(1e-2, momentum=0.9),
                     tmu.sgd(1e-2, momentum=0.9))


@functools.lru_cache(maxsize=None)
def _flax_gpt():
    model = jgm.GPTModel(jgm.GPTConfig(**GPT))
    dummy = jnp.ones((4, GPT["seq_len"]), jnp.int32)
    return jax.tree_util.tree_map(
        np.asarray, jax.jit(model.init)(jax.random.PRNGKey(0), dummy))


def gpt_states(dtype: str):
    """(JAX state, port state, numpy batch) of the narrow GPT."""
    params = _flax_gpt()
    jmodel = jgm.GPTModel(jgm.GPTConfig(**GPT, dtype=getattr(jnp, dtype)))
    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        tx=optax.adam(1e-3))
    tcfg = tgm.GPTConfig(**GPT, dtype=getattr(torch, dtype))
    tmodel = tgm.GPTModel(tcfg, device="cpu", param_dtype=torch.float32)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                                param_dtype=torch.float32))
    t_state = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(tmodel),
                                    params=dict(tmodel.named_parameters()),
                                    tx=tmu.adam(1e-3))
    rng = np.random.default_rng(0)
    batch = {n: rng.integers(0, GPT["vocab_size"], (4, GPT["seq_len"]))
             for n in ("input_ids", "labels")}
    return j_state, t_state, batch


def states(name: str):
    """(JAX state, port state, numpy batch) of a plan, made anew."""
    if name.startswith("gpt"):
        return gpt_states("bfloat16" if name.endswith("bf16") else
                          "float32")
    return mlp_states(name)


def steps(name: str):
    """(JAX step, port step) of a plan."""
    if name.startswith("gpt"):
        return _jax_gpt_step, _port_gpt_step
    return _jax_mlp_step, _port_mlp_step


def jax_batch(name, batch):
    dtype = jnp.int32 if name.startswith("gpt") else jnp.float32
    return {k: jnp.asarray(v, dtype) for k, v in batch.items()}


def port_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def plan_pair(name: str):
    """(JAX executable, port executable) of a plan, compiled once."""
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch = states(name)
    jstep, tstep = steps(name)
    jmethod, tmethod = methods(name)
    jex, _ = alpa_tpu.parallelize(jstep, method=jmethod).get_executable(
        j_state, jax_batch(name, batch))
    tex, _ = alpa_tpu_torch.parallelize(
        tstep, method=tmethod).get_executable(t_state, port_batch(batch))
    return jex, tex


def findings(verdict):
    """The verdict's findings as a set of (analysis, code)."""
    return {(f.analysis, f.code) for f in verdict.findings()}


def jax_lower(jex, instructions):
    """The JAX executable's registers-mode program of ``instructions``,
    lowered and verified through its own lowerer."""
    return jex._make_lowerer("registers")(list(instructions))


def port_lower(tex, instructions):
    """The port executable's registers-mode program of ``instructions``,
    lowered and verified through its own context."""
    import dataclasses
    context = dataclasses.replace(tex._plan_context(), plan_fingerprint=None)
    return tex._lower_for_analysis(list(instructions), "registers", context)


def _captured_model(module, lower):
    """(PlanModel, hooks, overlap window) of the program ``lower()``
    builds, caught at ``module.build_model`` with the compile cache off
    (a cached verdict would skip the model)."""
    got = []
    real = module.build_model

    def build(*args, **kwargs):
        model = real(*args, **kwargs)
        got.append(model)
        return model

    module.build_model = build
    try:
        prog = lower()
    finally:
        module.build_model = real
    return got[-1], list(prog.hooks), int(prog.overlap_window or 0)


@functools.lru_cache(maxsize=None)
def plan_models(name: str):
    """((JAX model, hooks, window), (port model, hooks, window)) of a
    plan's registers-mode program."""
    from alpa_tpu import compile_cache as jcc
    from alpa_tpu.analysis import plan_verifier as jpv
    from alpa_tpu_torch.analysis import plan_verifier as tpv
    from alpa_tpu_torch.global_env import global_config as tconfig
    jex, tex = plan_pair(name)
    real_enabled = jcc.cache_enabled
    jcc.cache_enabled = lambda: False
    try:
        jm = _captured_model(jpv, lambda: jax_lower(jex, jex.instructions))
    finally:
        jcc.cache_enabled = real_enabled
    old = tconfig.compile_cache_enabled
    tconfig.compile_cache_enabled = False
    try:
        tm = _captured_model(tpv, lambda: port_lower(tex, tex.instructions))
    finally:
        tconfig.compile_cache_enabled = old
    return jm, tm


def slot_population(model):
    """Per mesh, the multiset of (instance, shape, dtype, bytes) of its
    slots."""
    from collections import Counter
    out = {}
    for sm in model.slots.values():
        out.setdefault(sm.mesh, Counter())[
            (sm.instance, tuple(sm.shape), sm.dtype, sm.nbytes)] += 1
    return out


def verify_all(pv, model, hooks, window):
    """``verify_model`` of ``pv`` (either package's plan_verifier) with
    every analysis on, at the knobs' defaults."""
    return pv.verify_model(model, hooks=hooks, model_check=True,
                           overlap_window=window, numerics=True,
                           numerics_budget=0.05, equiv=True,
                           equiv_budget=100000)
