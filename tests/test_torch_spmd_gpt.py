"""The 2-layer GPT at narrow width over 8 devices: the port's
``ShardParallel`` against the JAX package's, on the CPU.

JAX runs ``ShardParallel`` on the 8 virtual CPU devices of the test
process, the port on ``devices=["cpu"] * 8``, both on a forced logical
mesh, (2, 4) or (1, 8), from the same weights
(``convert.gpt_params_from_flax``) and batch, with the reference attention and with the flash attention (JAX:
its Pallas kernels in interpret mode; the port: the kernels' plain
versions, run by each device on its batch rows).  Two SGD steps (lr 0.1,
momentum 0.9): losses rtol 1e-5, parameters 1e-5 of each tensor's largest
|value| (the port's plan and JAX's may differ where they tie, and sums
over devices run in other orders).  SGD rather than Adam: Adam's
m / sqrt(v) turns a gradient at its rounding noise (a qkv bias's key
third) into a step of up to lr.
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
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import gpt_params_from_flax

GPT = dict(hidden_size=64, num_layers=2, num_heads=2, seq_len=16,
           vocab_size=128)
LR, STEPS, BATCH = 0.1, 2, 8


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@functools.lru_cache(maxsize=None)
def _flax_params():
    dummy = jnp.ones((BATCH, GPT["seq_len"]), jnp.int32)
    return jax.jit(jgm.GPTModel(jgm.GPTConfig(**GPT)).init)(
        jax.random.PRNGKey(0), dummy)


def _jax_step(state, batch):
    loss, grads = alpa_tpu.value_and_grad(
        lambda p: jmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_step(state, batch):
    loss, grads = alpa_tpu_torch.value_and_grad(
        lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
    return state.apply_gradients(grads=grads), loss


@pytest.mark.parametrize("shape", [(2, 4), (1, 8)])
@pytest.mark.parametrize("attention_impl", ["reference", "flash"])
def test_gpt_shard_parallel_on_eight_devices_equals_jax(attention_impl,
                                                        shape):
    cfg = dict(attention_impl=attention_impl, **GPT)
    # copies: the JAX step donates the arrays it is given
    params = jax.tree_util.tree_map(jnp.array, _flax_params())
    jmodel = jgm.GPTModel(jgm.GPTConfig(**cfg))
    jstate = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply, params=params,
        tx=optax.sgd(LR, momentum=0.9))
    tcfg = tgm.GPTConfig(**cfg)
    tmodel = tgm.GPTModel(tcfg, device="cpu", param_dtype=torch.float32)
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                                param_dtype=torch.float32))
    tstate = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(tmodel),
                                   params=dict(tmodel.named_parameters()),
                                   tx=tmu.sgd(LR, momentum=0.9))
    rng = np.random.default_rng(0)
    batch = {n: rng.integers(0, GPT["vocab_size"], (BATCH, GPT["seq_len"]))
             for n in ("input_ids", "labels")}
    jstep = alpa_tpu.parallelize(_jax_step, method=alpa_tpu.ShardParallel(
        devices=jax.devices(), auto_sharding_option=alpa_tpu.
        AutoShardingOption(logical_mesh_shape=shape)))
    tstep = alpa_tpu_torch.parallelize(
        _port_step, method=alpa_tpu_torch.ShardParallel(
            devices=["cpu"] * 8, auto_sharding_option=alpa_tpu_torch.
            AutoShardingOption(logical_mesh_shape=shape)))
    j_losses, t_losses = [], []
    jbatch = {n: jnp.asarray(v, jnp.int32) for n, v in batch.items()}
    tbatch = {n: torch.from_numpy(v) for n, v in batch.items()}
    for _ in range(STEPS):
        jstate, jloss = jstep(jstate, jbatch)
        tstate, tloss = tstep(tstate, tbatch)
        j_losses.append(float(jloss))
        t_losses.append(float(tloss))
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    want = gpt_params_from_flax(
        jax.tree_util.tree_map(np.asarray, jstate.params), tcfg, "cpu",
        param_dtype=torch.float32)
    got = ttesting.gather_tree(tstate.params)
    for name, w in want.items():
        np.testing.assert_allclose(got[name].numpy(), w.numpy(), rtol=0,
                                   atol=1e-5 * float(w.abs().max()),
                                   err_msg=name)
    ex = tstep.get_last_executable()
    assert tuple(ex.plan["shape"]) == shape and len(ex.devices) == 8
    if attention_impl == "flash":
        ops = [str(n.target) for n in ex.program.root.graph.nodes]
        assert ops.count("alpa_tpu_torch.flash_fwd.default") == \
            GPT["num_layers"]
