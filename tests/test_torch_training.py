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


# ---- donation and argnums, against the JAX package ----

def _mlp_states_adam():
    """(JAX state, port state, JAX batch, numpy batch) of the MLP fixture
    with Adam (its moments have the parameters' shapes)."""
    from alpa_tpu import testing as jtesting
    from alpa_tpu_torch import testing as ttesting

    j_state, jb = jtesting.create_mlp_train_state_and_batch(batch_size=8)
    j_state = flax_train_state.TrainState.create(
        apply_fn=j_state.apply_fn, params=j_state.params,
        tx=optax.adam(1e-3))
    batch = {k: np.asarray(v) for k, v in jb.items()}
    t_state, _ = ttesting.create_mlp_train_state_and_batch(
        batch_size=8, params=jax.tree_util.tree_map(np.asarray,
                                                    j_state.params),
        x=batch["x"], y=batch["y"], tx=tmu.adam(1e-3))
    return j_state, t_state, jb, batch


def _mse(apply_fn, batch, xp):
    return lambda p: xp.mean((apply_fn(p, batch["x"]) - batch["y"]) ** 2)


STEP_KINDS = ("new_state_and_loss", "eval", "loss_and_grads")


def _steps(kind):
    """(JAX step, port step) of one kind: a train step returning the new
    state and the loss, an eval step returning the loss, and a step
    returning the loss and the gradients."""

    def make(api, xp):
        def step(state, batch):
            loss_fn = _mse(state.apply_fn, batch, xp)
            if kind == "eval":
                return loss_fn(state.params)
            loss, grads = api.value_and_grad(loss_fn)(state.params)
            if kind == "loss_and_grads":
                return loss, grads
            return state.apply_gradients(grads=grads), loss
        return step

    return make(alpa_tpu, jnp), make(alpa_tpu_torch, torch)


def _by_shape(avals, donated):
    """The donation flags of the state's leaves as a sorted list of
    (shape, donated): the two packages order a state's leaves differently
    (flax sorts dict keys, and a Dense kernel is the transpose of a
    Linear weight, of the same shape here)."""
    return sorted((tuple(a), bool(d)) for a, d in zip(avals, donated))


@pytest.mark.parametrize("kind", STEP_KINDS)
def test_auto_donation_equals_jax(kind):
    """``donate_argnums="auto"`` donates a state leaf where an output leaf
    not yet claimed has its shape and dtype, as the JAX package's
    ``_infer_donation`` does: everything for a train step, nothing for an
    eval step, the parameters (not the Adam moments) for a step returning
    the gradients.  An undonated state stays usable; a state with a donated
    leaf raises when passed again."""
    j_state, t_state, jb, batch = _mlp_states_adam()
    j_step, t_step = _steps(kind)
    j_pstep = alpa_tpu.parallelize(j_step, method=alpa_tpu.ShardParallel(
        devices=[jax.devices()[0]]))
    t_pstep = alpa_tpu_torch.parallelize(
        t_step, method=alpa_tpu_torch.ShardParallel(devices=["cpu"]))
    j_out = j_pstep(j_state, jb)
    j_donated = j_pstep.get_last_executable().donated_invars
    t_donated = t_pstep.get_donated_invars(t_state, batch)
    # the executable carries the seconds of the fake pass
    assert t_pstep.get_last_executable().donation_seconds > 0
    n_state = len(jax.tree_util.tree_leaves(j_state))
    j_shapes = [np.shape(x) for x in jax.tree_util.tree_leaves(j_state)]
    t_leaves = torch.utils._pytree.tree_leaves(t_state)
    t_shapes = [tuple(getattr(x, "shape", ())) for x in t_leaves]
    assert _by_shape(t_shapes, t_donated[:len(t_leaves)]) == \
        _by_shape(j_shapes, j_donated[:n_state])
    assert not any(t_donated[len(t_leaves):])   # the batch
    want = {"new_state_and_loss": len(t_leaves), "eval": 0,
            "loss_and_grads": len(t_state.params)}[kind]
    assert sum(t_donated) == want
    t_out = t_pstep(t_state, batch)
    j_loss = j_out if kind == "eval" else j_out[1 if kind ==
                                                 "new_state_and_loss" else 0]
    t_loss = t_out if kind == "eval" else t_out[1 if kind ==
                                                 "new_state_and_loss" else 0]
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    if kind == "eval":
        np.testing.assert_allclose(float(t_pstep(t_state, batch)),
                                   float(j_loss), rtol=1e-5)
    else:
        with pytest.raises(RuntimeError, match="donated"):
            t_pstep(t_state, batch)
    if kind == "loss_and_grads":
        # the moments were not donated: still live and unchanged
        assert all(m.untyped_storage().nbytes() > 0 and not m.any()
                   for m in t_state.opt_state[0]["mu"].values())


def test_tuple_argnums_equal_jax_grad():
    """``grad``/``value_and_grad`` with a tuple ``argnums`` return a tuple
    of gradient trees, as ``jax.grad`` does (fp32, rtol 1e-6), also with
    ``has_aux`` and inside a parallelized step."""
    rng = np.random.default_rng(4)
    w = {"a": rng.standard_normal((3, 4)).astype(np.float32),
         "b": rng.standard_normal(4).astype(np.float32)}
    x = rng.standard_normal((5, 3)).astype(np.float32)

    def f(w, x, xp):
        return xp.sum(xp.tanh(x @ w["a"] + w["b"]) ** 2)

    want = jax.grad(lambda w, x: f(w, x, jnp), argnums=(0, 1))(w, x)
    tw = {k: torch.from_numpy(v) for k, v in w.items()}
    tx = torch.from_numpy(x)
    got = alpa_tpu_torch.grad(lambda w, x: f(w, x, torch),
                              argnums=(0, 1))(tw, tx)
    assert isinstance(got, tuple) and len(got) == 2
    for g, j in ((got[0]["a"], want[0]["a"]), (got[0]["b"], want[0]["b"]),
                 (got[1], want[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-6)
    (val, aux), grads = alpa_tpu_torch.value_and_grad(
        lambda w, x: (f(w, x, torch), x.sum()), argnums=(1,),
        has_aux=True)(tw, tx)
    jval, jgrads = jax.value_and_grad(lambda w, x: f(w, x, jnp),
                                      argnums=(1,))(w, x)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-6)
    np.testing.assert_allclose(grads[0].numpy(), np.asarray(jgrads[0]),
                               rtol=1e-6, atol=1e-6)
    assert float(aux) == pytest.approx(float(x.sum()))

    @alpa_tpu_torch.parallelize(
        method=alpa_tpu_torch.ShardParallel(devices=["cpu"]))
    def step(w, x):
        return alpa_tpu_torch.grad(lambda w, x: f(w, x, torch),
                                   argnums=(0, 1))(w, x)

    par = step(tw, tx)
    np.testing.assert_allclose(par[1].numpy(), np.asarray(want[1]),
                               rtol=1e-6, atol=1e-6)
