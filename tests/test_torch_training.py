"""The port's training path against the JAX package's.

The same fp32 weights (flax ``init_gpt_real``, converted with
``gpt_params_from_flax``) and the same numpy token ids go through both.
Attention is ``"flash"`` on both sides: JAX runs its Pallas kernels in
interpret mode, the port the kernels' plain PyTorch versions.
Tolerances: logits atol 1e-4 and losses rtol 1e-5 (O(1) values, summed in
different orders); gradients atol 2e-6, which is 2e-5 of the largest
gradient (about 0.1) at this size; optimizer updates rtol 1e-5;
parameters after Adam steps atol 3 x lr, since Adam's m/sqrt(v) turns a
gradient that is zero up to rounding noise into a step of about +-lr.
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
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.model import model_util as jmu
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import gpt_params_from_flax

SHAPE = dict(hidden_size=128, num_layers=2, num_heads=2, seq_len=64,
             vocab_size=256)
BATCH = 2
GRAD_ATOL = 2e-6


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return {"input_ids": rng.integers(0, SHAPE["vocab_size"],
                                      (BATCH, SHAPE["seq_len"])),
            "labels": rng.integers(0, SHAPE["vocab_size"],
                                   (BATCH, SHAPE["seq_len"]))}


@functools.lru_cache(maxsize=None)
def _flax_params():
    """fp32 flax parameters, made once (``init_gpt_real``'s, jitted).  The
    attention implementation and remat leave the parameter tree as it is,
    so init runs the reference attention; the arrays are immutable and
    safe to share."""
    dummy = jnp.ones((BATCH, SHAPE["seq_len"]), jnp.int32)
    return jax.jit(jgm.GPTModel(jgm.GPTConfig(**SHAPE)).init)(
        jax.random.PRNGKey(0), dummy)


def _models(**kw):
    """(jax model, flax params, port model with the same fp32 weights)."""
    jmodel = jgm.GPTModel(jgm.GPTConfig(attention_impl="flash", **SHAPE,
                                        **kw))
    params = _flax_params()
    tcfg = tgm.GPTConfig(attention_impl="flash", **SHAPE, **kw)
    tmodel = tgm.GPTModel(tcfg, device="cpu", param_dtype=torch.float32)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                                param_dtype=torch.float32))
    return jmodel, params, tmodel


def _as_port(tree):
    """A flax parameter-shaped tree (params or gradients) as the port's
    {name: tensor} dict."""
    cfg = tgm.GPTConfig(**SHAPE)
    return gpt_params_from_flax(tree, cfg, "cpu", param_dtype=torch.float32)


def _jax_batch(batch):
    return {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("remat", [
    pytest.param(dict(), id="remat-off"),
    pytest.param(dict(remat_blocks=True), id="remat-on"),
    pytest.param(dict(remat_blocks=True, remat_policy="dots"), id="dots"),
])
def test_logits_loss_and_grads_match_flax(remat):
    """Logits (atol 1e-4), loss (rtol 1e-5) and every parameter gradient
    (atol 2e-6) of ``gpt_lm_loss`` against flax."""
    jmodel, params, tmodel = _models(**remat)
    batch = _batch()
    jb, tb = _jax_batch(batch), _torch_batch(batch)
    j_loss, j_grads = jax.jit(jax.value_and_grad(
        lambda p: jmu.gpt_lm_loss(jmodel.apply, p, jb)))(params)
    apply_fn = tmu.make_apply_fn(tmodel)
    t_params = {k: p.detach() for k, p in tmodel.named_parameters()}
    t_loss, t_grads = alpa_tpu_torch.value_and_grad(
        lambda p: tmu.gpt_lm_loss(apply_fn, p, tb))(t_params)
    with torch.no_grad():
        logits = apply_fn(t_params, tb["input_ids"])
    np.testing.assert_allclose(
        logits.numpy(),
        np.asarray(jax.jit(jmodel.apply)(params, jb["input_ids"])),
        atol=1e-4, rtol=0)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    want = _as_port(j_grads)
    assert set(t_grads) == set(want)
    for name, g in t_grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


def test_return_hidden_with_chunked_cross_entropy_matches_jax():
    """``return_hidden`` + ``chunked_cross_entropy_loss`` in chunks of 48
    of 128 rows (a ragged last chunk): loss rtol 1e-5, gradients 2e-6."""
    jmodel, params, tmodel = _models()
    batch = _batch(seed=1)
    jb, tb = _jax_batch(batch), _torch_batch(batch)

    def j_loss_fn(p):
        hidden = jmodel.apply(p, jb["input_ids"], return_hidden=True)
        return jmu.chunked_cross_entropy_loss(
            hidden, p["params"]["wte"]["embedding"], jb["labels"],
            chunk_size=48)

    apply_fn = tmu.make_apply_fn(tmodel)

    def t_loss_fn(p):
        hidden = apply_fn(p, tb["input_ids"], return_hidden=True)
        assert hidden.shape == (BATCH, SHAPE["seq_len"],
                                SHAPE["hidden_size"])
        return tmu.chunked_cross_entropy_loss(hidden, p["wte.weight"],
                                              tb["labels"], chunk_size=48)

    j_loss, j_grads = jax.jit(jax.value_and_grad(j_loss_fn))(params)
    t_loss, t_grads = alpa_tpu_torch.value_and_grad(t_loss_fn)(
        {k: p.detach() for k, p in tmodel.named_parameters()})
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    # the dense loss of the same batch is the same number
    np.testing.assert_allclose(
        float(tmu.gpt_lm_loss(apply_fn, {k: p.detach() for k, p in
                                         tmodel.named_parameters()}, tb)),
        float(t_loss), rtol=1e-5)
    want = _as_port(j_grads)
    for name, g in t_grads.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   atol=GRAD_ATOL, rtol=0, err_msg=name)


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("name", ["create_adamw", "adam"])
def test_optimizer_matches_optax(name, inplace):
    """3 updates of ``create_adamw`` (global-norm clip that triggers on
    some steps, then AdamW) and of ``adam`` against the optax chains:
    parameters after each step at rtol 1e-5, atol 1e-7."""
    rng = np.random.default_rng(5)
    shapes = {"a": (4, 3), "b": (7,), "c": (2, 2, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32)
              for k, s in shapes.items()} for scale in (0.05, 2.0, 0.1)]
    if name == "adam":
        j_tx, t_tx = optax.adam(1e-2), tmu.adam(1e-2)
    else:
        j_tx = jmu.create_adamw(1e-2, weight_decay=0.1, grad_clip=1.0)
        t_tx = tmu.create_adamw(1e-2, weight_decay=0.1, grad_clip=1.0)
    j_params = {k: jnp.asarray(v) for k, v in params.items()}
    j_state = j_tx.init(j_params)
    t_params = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    t_state = t_tx.init(t_params)
    for g in grads:
        j_up, j_state = j_tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    j_state, j_params)
        j_params = optax.apply_updates(j_params, j_up)
        t_up, t_state = t_tx.update({k: torch.from_numpy(v)
                                     for k, v in g.items()},
                                    t_state, t_params, inplace)
        t_params = {k: p + t_up[k] for k, p in t_params.items()}
        for k in shapes:
            np.testing.assert_allclose(t_params[k].numpy(),
                                       np.asarray(j_params[k]), rtol=1e-5,
                                       atol=1e-7)


def test_parallelize_adam_steps_match_alpa_tpu():
    """3 Adam steps of the bench-shaped train step through the port's
    ``parallelize(ShardParallel)`` against ``alpa_tpu.parallelize`` on one
    device: losses step by step at rtol 1e-5, parameters after the steps
    at atol 3 x lr.  The donated state is updated in place and may not be
    passed again."""
    lr = 1e-3
    jmodel, params, tmodel = _models(remat_blocks=True)
    batch = _batch(seed=2)

    @alpa_tpu.parallelize(method=alpa_tpu.ShardParallel(
        devices=[jax.devices()[0]]), donate_argnums=(0,))
    def j_step(state, batch):

        def loss_fn(p):
            return jmu.gpt_lm_loss(state.apply_fn, p, batch)

        loss, grads = alpa_tpu.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    @alpa_tpu_torch.parallelize(method=alpa_tpu_torch.ShardParallel(
        devices=["cpu"]), donate_argnums=(0,))
    def t_step(state, batch):

        def loss_fn(p):
            return tmu.gpt_lm_loss(state.apply_fn, p, batch)

        loss, grads = alpa_tpu_torch.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply, params=params, tx=optax.adam(lr))
    t_state = tmu.TrainState.create(
        apply_fn=tmu.make_apply_fn(tmodel),
        params=dict(tmodel.named_parameters()), tx=tmu.adam(lr))
    first = t_state
    jb = _jax_batch(batch)
    for step in range(3):
        j_state, j_loss = j_step(j_state, jb)
        t_state, t_loss = t_step(t_state, batch)   # numpy in, as host data
        np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5,
                                   err_msg=f"step {step}")
    assert t_state.step == 3 and len(t_step._executable_cache) == 1
    assert t_step.get_last_executable() is not None
    # donated: updated in place, so the model's own storage moved too
    assert t_state.params["wte.weight"].data_ptr() == \
        tmodel.wte.weight.data_ptr()
    with pytest.raises(RuntimeError, match="donated"):
        t_step(first, batch)
    want = _as_port(j_state.params)
    for name, p in t_state.params.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=3 * lr, rtol=0, err_msg=name)
