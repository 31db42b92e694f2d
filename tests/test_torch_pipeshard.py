"""The port's ``PipeshardParallel`` against the JAX package's.

The same numpy weights (the flax tree, converted) and the same numpy batch
go through both packages.  JAX runs its pipeshard on the test session's
virtual CPU devices with one device per stage mesh (``ManualStageOption``
with (1, 1) submeshes); the port runs on ``devices=["cpu"] * n``, one
physical device named once per stage.  Tolerances, fp32: MLP losses and
parameters after 2 steps rtol 1e-4, atol 1e-5 (sums over microbatches in a
different order); GPT loss rtol 1e-5 and parameters after 2 Adam steps
atol 3 x lr, as ``test_torch_training.py`` holds Adam steps (Adam's
m / sqrt(v) turns a gradient that is zero up to rounding into a step of
about +-lr).
"""
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn
from flax.training import train_state as flax_train_state

import alpa_tpu
import alpa_tpu_torch
from alpa_tpu import testing as jtesting
from alpa_tpu.model import gpt_model as jgm
from alpa_tpu.model import model_util as jmu
from alpa_tpu.pipeline_parallel import stage_construction as jstage
from alpa_tpu.pipeline_parallel.layer_construction import \
    ManualLayerOption as JaxManualLayerOption
from alpa_tpu.pipeline_parallel.layer_construction import \
    set_current_layer_option as jax_set_layer_option
from alpa_tpu.pipeline_parallel.primitive_def import \
    mark_pipeline_boundary as jax_mark_pipeline_boundary
from alpa_tpu.pipeline_parallel.primitive_def import pipeline_p
from alpa_tpu.pipeline_parallel.runtime_emitter import \
    partition_streams as jax_partition_streams
from alpa_tpu_torch import (ManualLayerOption, ManualStageOption,
                            PipeshardParallel, UniformStageOption)
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.model import gpt_model as tgm
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.model.convert import (gpt_params_from_flax,
                                          mlp_params_from_flax)
from alpa_tpu_torch.pipeline_parallel import compile_executable as tce
from alpa_tpu_torch.pipeline_parallel import primitive_def
from alpa_tpu_torch.pipeline_parallel.runtime_emitter import \
    PipelineInstType

MLP_TOL = dict(rtol=1e-4, atol=1e-5)
BATCH, DIM = 16, 32


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Restore torch's global RNG so these tests leave other tests' draws
    alone."""
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _port_cluster():
    yield
    alpa_tpu_torch.shutdown()


class JaxBoundaryMLP(fnn.Module):
    """A flax MLP with a pipeline boundary before every layer but the
    first: as many manual layers as Dense layers."""
    dims: tuple

    @fnn.compact
    def __call__(self, x):
        for i, dim in enumerate(self.dims):
            if i:
                jax_mark_pipeline_boundary()
            x = fnn.Dense(dim)(x)
            if i != len(self.dims) - 1:
                x = fnn.relu(x)
        return x


class BoundaryMLP(torch.nn.Module):
    """The port's counterpart of ``JaxBoundaryMLP``."""

    def __init__(self, dims, input_dim):
        super().__init__()
        sizes = [input_dim] + list(dims)
        self.layers = torch.nn.ModuleList(
            torch.nn.Linear(sizes[i], sizes[i + 1], device="meta")
            for i in range(len(dims)))

    def forward(self, x):
        for i, layer in enumerate(self.layers):
            if i:
                alpa_tpu_torch.mark_pipeline_boundary()
            x = layer(x)
            if i != len(self.layers) - 1:
                x = torch.relu(x)
        return x


@functools.lru_cache(maxsize=None)
def _jax_mlp(num_stages):
    """(flax model, its params as numpy arrays, x, y): the JAX fixture MLP
    (one boundary, 2 manual layers) for 2 stages, ``JaxBoundaryMLP`` for 4.
    Made once (a JAX step donates the arrays it is given, so each state
    gets arrays of its own)."""
    rng = np.random.default_rng(num_stages)
    x = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    y = rng.standard_normal((BATCH, DIM)).astype(np.float32)
    if num_stages == 2:
        jmodel = jtesting.MLPModel(hidden_dim=DIM, output_dim=DIM,
                                   num_layers=4, manual_pipeline_layer=True)
    else:
        jmodel = JaxBoundaryMLP(dims=(DIM,) * num_stages)
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jnp.asarray(x))
    return jmodel, jax.tree_util.tree_map(np.asarray, params), x, y


def _mlp_pair(num_stages, jax_tx, port_tx):
    """(jax state, port state, numpy batch) from the same weights."""
    jmodel, np_params, x, y = _jax_mlp(num_stages)
    j_state = flax_train_state.TrainState.create(
        apply_fn=jmodel.apply,
        params=jax.tree_util.tree_map(jnp.asarray, np_params), tx=jax_tx)
    if num_stages == 2:
        t_state, _ = ttesting.create_mlp_train_state_and_batch(
            batch_size=BATCH, input_dim=DIM, hidden_dim=DIM, output_dim=DIM,
            num_layers=4, manual_pipeline_layer=True, params=np_params,
            x=x, y=y, tx=port_tx)
    else:
        model = BoundaryMLP((DIM,) * num_stages, DIM).to_empty(device="cpu")
        model.load_state_dict(mlp_params_from_flax(np_params))
        t_state = tmu.TrainState.create(
            apply_fn=tmu.make_apply_fn(model),
            params=dict(model.named_parameters()), tx=port_tx)
    return j_state, t_state, {"x": x, "y": y}


def _jax_method(num_stages, num_micro_batches, schedule):
    return alpa_tpu.PipeshardParallel(
        num_micro_batches=num_micro_batches,
        layer_option=JaxManualLayerOption(),
        stage_option=jstage.ManualStageOption(
            forward_stage_layer_ids=[[i] for i in range(num_stages)],
            submesh_physical_shapes=[(1, 1)] * num_stages),
        pipeline_schedule=schedule)


def _port_method(num_stages, num_micro_batches, schedule):
    return PipeshardParallel(devices=["cpu"] * num_stages,
                             num_micro_batches=num_micro_batches,
                             layer_option=ManualLayerOption(),
                             stage_option=UniformStageOption(num_stages),
                             pipeline_schedule=schedule)


def _jax_step(state, batch):

    def loss_fn(params):
        out = state.apply_fn(params, batch["x"])
        return jnp.mean((out - batch["y"]) ** 2)

    loss, grads = alpa_tpu.value_and_grad(loss_fn)(state.params)
    return state.apply_gradients(grads=grads), loss


def _port_step(state, batch):

    def loss_fn(params):
        out = state.apply_fn(params, batch["x"])
        return torch.mean((out - batch["y"]) ** 2)

    loss, grads = alpa_tpu_torch.value_and_grad(loss_fn)(state.params)
    return state.apply_gradients(grads=grads), loss


def _run(step, state, batch, steps=2):
    losses = []
    for _ in range(steps):
        state, loss = step(state, batch)
        losses.append(float(loss))
    return state, losses


def _port_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _program(instructions, streams):
    """Per mesh stream (``partition_streams``), the (stage, microbatch)
    order of its RUNs; and the count of RESHARDs per (src, dst) mesh
    pair."""
    runs = [[(instructions[i].stage_id, instructions[i].micro_batch)
             for i in stream if instructions[i].opcode.name == "RUN"]
            for stream in streams.streams]
    reshards = {}
    for inst in instructions:
        if inst.opcode.name == "RESHARD":
            edge = (inst.src_mesh, inst.dst_mesh)
            reshards[edge] = reshards.get(edge, 0) + 1
    return runs, reshards


@pytest.mark.parametrize("num_stages", [2, 4])
@pytest.mark.parametrize("num_micro_batches", [1, 2, 4])
@pytest.mark.parametrize("schedule",
                         ["gpipe", "1f1b", "1f1b_overlap_friendly"])
def test_mlp_matches_jax_pipeshard_and_serial(schedule, num_micro_batches,
                                              num_stages):
    """Losses and every parameter after 2 SGD-momentum steps equal the JAX
    package's PipeshardParallel and the port's serial step; each mesh's
    instruction stream runs the same (stage, microbatch) sequence as JAX's,
    with as many RESHARDs per mesh pair."""
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch = _mlp_pair(
        num_stages, optax.sgd(1e-2, momentum=0.9),
        tmu.sgd(1e-2, momentum=0.9))
    _, serial_state, _ = _mlp_pair(num_stages, optax.sgd(1e-2, momentum=0.9),
                                   tmu.sgd(1e-2, momentum=0.9))
    j_pstep = alpa_tpu.parallelize(
        _jax_step, method=_jax_method(num_stages, num_micro_batches,
                                      schedule))
    t_pstep = alpa_tpu_torch.parallelize(
        _port_step, method=_port_method(num_stages, num_micro_batches,
                                        schedule))
    j_state, j_losses = _run(j_pstep, j_state,
                             jax.tree_util.tree_map(jnp.asarray, batch))
    t_state, t_losses = _run(t_pstep, t_state, batch)
    serial_state, s_losses = _run(_port_step, serial_state,
                                  _port_batch(batch))
    np.testing.assert_allclose(t_losses, j_losses, **MLP_TOL)
    np.testing.assert_allclose(t_losses, s_losses, **MLP_TOL)
    ttesting.assert_allclose(t_state.params, serial_state.params, **MLP_TOL)
    ttesting.assert_allclose(
        t_state.params,
        mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                    j_state.params)),
        **MLP_TOL)
    ours = t_pstep.get_last_executable()
    theirs = j_pstep.get_last_executable()
    assert ours.num_meshes == theirs.num_meshes == num_stages
    assert _program(ours.instructions, ours.get_instruction_streams()) == \
        _program(theirs.instructions, jax_partition_streams(
            theirs.instructions, num_stages))
    assert ours.executed_resharding_bytes == 0   # one physical device


def test_marker_sequence_equals_jax_jaxpr():
    """The (name, mark_type) sequence of the markers in the port's traced
    joint graph of the manual-layer MLP step equals the pipeline eqns of
    JAX's jaxpr, with as many operands each.  JAX names a backward marker
    ``<layer>_jvp_backward`` (its grad linearizes, then transposes); the
    port's autograd formula names it ``<layer>_backward``."""
    j_state, t_state, batch = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
    jax_set_layer_option(JaxManualLayerOption())
    try:
        jaxpr = jax.make_jaxpr(_jax_step)(
            j_state, jax.tree_util.tree_map(jnp.asarray, batch))
    finally:
        jax_set_layer_option(None)
    want = [(re.sub("_jvp_backward$", "_backward", e.params["name"]),
             e.params["mark_type"], len(e.invars))
            for e in jaxpr.jaxpr.eqns if e.primitive is pipeline_p]
    graph = _traced_graph(_port_step, t_state, _port_batch(batch))
    got = [(n.args[1], n.args[2], len(n.args[0])) for n in graph.nodes
           if primitive_def.is_marker(n)]
    assert got == want
    assert want[0][:2] == ("layer_0", "start") and want[-1][:2] == \
        ("grad", "grad")
    assert not any(primitive_def.is_boundary(n) for n in graph.nodes)


def _traced_graph(step, state, batch):
    """The port's joint graph of ``step`` as the pipeshard compiler traces
    it (one microbatch)."""
    graphs = []

    class Trace(alpa_tpu_torch.ParallelMethod):
        donates_in_place = False

        def compile_executable(self, fun, *, avals, batch_invars,
                               donated_invars):
            del donated_invars
            fake = tce._fake_inputs(avals, batch_invars, 1,
                                    torch.device("cpu"))
            graphs.append(tce.trace_train_step(fun, fake,
                                               ManualLayerOption()).graph)
            raise StopIteration

    with pytest.raises(StopIteration):
        alpa_tpu_torch.parallelize(step, method=Trace())(state, batch)
    return graphs[0]


def test_markers_are_no_ops_outside_a_pipeshard_trace(monkeypatch):
    """A ShardParallel step and plain value_and_grad call no marker op:
    not one clone is added to them."""
    calls = []
    real = primitive_def.pipeline_marker

    def counting(*args):
        calls.append(args[1:])
        return real(*args)

    monkeypatch.setattr(primitive_def, "pipeline_marker", counting)
    _, t_state, batch = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
    step = alpa_tpu_torch.parallelize(
        _port_step, method=alpa_tpu_torch.ShardParallel(devices=["cpu"]))
    step(t_state, _port_batch(batch))
    marked = primitive_def.mark_gradient({"g": torch.ones(2)})
    assert calls == [] and not primitive_def.tracing_active()
    assert torch.equal(marked["g"], torch.ones(2))
    # the same step traced by the pipeshard compiler does call it
    _, t_state, _ = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
    _traced_graph(_port_step, t_state, _port_batch(batch))
    assert calls


def test_global_norm_clipping_falls_back_to_a_mesh0_apply():
    """clip_by_global_norm reads every gradient and scales every one, so
    the apply partition is cyclic: apply-grad runs whole on mesh 0, and
    the step still equals JAX's pipeshard and the port's serial step."""
    alpa_tpu.init(cluster="local")
    j_tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-3))
    t_tx = tmu.chain(tmu.clip_by_global_norm(1.0), tmu.adam(1e-3))
    j_state, t_state, batch = _mlp_pair(2, j_tx, t_tx)
    _, serial_state, _ = _mlp_pair(2, j_tx, t_tx)
    j_pstep = alpa_tpu.parallelize(_jax_step,
                                   method=_jax_method(2, 2, "1f1b"))
    t_pstep = alpa_tpu_torch.parallelize(_port_step,
                                         method=_port_method(2, 2, "1f1b"))
    j_state, j_losses = _run(j_pstep, j_state,
                             jax.tree_util.tree_map(jnp.asarray, batch))
    t_state, t_losses = _run(t_pstep, t_state, batch)
    serial_state, s_losses = _run(_port_step, serial_state,
                                  _port_batch(batch))
    ex = t_pstep.get_last_executable()
    assert ex.apply_execs[0] is not None and ex.apply_execs[1] is None
    applies = [i for i in ex.instructions
               if i.opcode == PipelineInstType.RUN and i.stage_id == -1]
    assert [i.dst_mesh for i in applies] == [0]
    np.testing.assert_allclose(t_losses, j_losses, **MLP_TOL)
    np.testing.assert_allclose(t_losses, s_losses, **MLP_TOL)
    # Adam steps: parameters at atol 3 x lr (see the module docstring)
    ttesting.assert_allclose(t_state.params, serial_state.params, rtol=0,
                             atol=3e-3)
    ttesting.assert_allclose(
        t_state.params,
        mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                    j_state.params)),
        rtol=0, atol=3e-3)


GPT_SHAPE = dict(hidden_size=64, num_layers=4, num_heads=4, seq_len=32,
                 vocab_size=128)


def test_gpt_matches_jax_train_step():
    """A 4-layer GPT (hidden 64, 4 heads, a boundary every 2 blocks, flash
    attention: Pallas in interpret mode on the JAX side, the plain version
    here) under pipeshard, 2 stages x 2 microbatches, 1F1B, against
    ``jax.jit`` of the JAX GPT's train step on converted weights: losses
    over 2 Adam steps rtol 1e-5, parameters atol 3 x lr."""
    lr = 1e-3
    jmodel = jgm.GPTModel(jgm.GPTConfig(attention_impl="flash",
                                        pipeline_boundary_every=2,
                                        **GPT_SHAPE))
    rng = np.random.default_rng(3)
    batch = {k: rng.integers(0, GPT_SHAPE["vocab_size"],
                             (4, GPT_SHAPE["seq_len"]))
             for k in ("input_ids", "labels")}
    jb = {k: jnp.asarray(v, jnp.int32) for k, v in batch.items()}
    params = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb["input_ids"])

    def j_step(state, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    tcfg = tgm.GPTConfig(attention_impl="flash", pipeline_boundary_every=2,
                         **GPT_SHAPE)
    tmodel = tgm.GPTModel(tcfg, device="meta", param_dtype=torch.float32)
    tmodel = tmodel.to_empty(device="cpu")
    tmodel.load_state_dict(gpt_params_from_flax(params, tcfg, "cpu",
                                                param_dtype=torch.float32))

    def t_step(state, batch):
        loss, grads = alpa_tpu_torch.value_and_grad(
            lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    j_state, j_losses = _run(jax.jit(j_step),
                             flax_train_state.TrainState.create(
                                 apply_fn=jmodel.apply, params=params,
                                 tx=optax.adam(lr)), jb)
    pstep = alpa_tpu_torch.parallelize(t_step,
                                       method=_port_method(2, 2, "1f1b"))
    t_state, t_losses = _run(pstep, tmu.TrainState.create(
        apply_fn=tmu.make_apply_fn(tmodel),
        params=dict(tmodel.named_parameters()), tx=tmu.adam(lr)), batch)
    np.testing.assert_allclose(t_losses, j_losses, rtol=1e-5)
    want = gpt_params_from_flax(j_state.params, tcfg, "cpu",
                                param_dtype=torch.float32)
    for name, p in t_state.params.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(),
                                   atol=3 * lr, rtol=0, err_msg=name)
    ex = pstep.get_last_executable()
    # one flash forward op per block in each forward stage, one backward op
    # per block in each backward stage
    for e in ex.stage_execs:
        ops = [str(n.target) for n in e.module.graph.nodes]
        kind = "flash_bwd" if "bwd" in e.name else "flash_fwd"
        assert sum(kind in o for o in ops) == 2, e.name


def test_donation_frees_and_marks_the_old_state_deleted():
    """The donated state's storage is handed on: the apply-grad graph
    writes each new parameter into its old parameter's storage, as JAX
    donates a state input to the one apply computation that reads it; the
    other donated tensors are released.  Passing the state again raises."""
    _, t_state, batch = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
    pstep = alpa_tpu_torch.parallelize(_port_step,
                                       method=_port_method(2, 2, "1f1b"))
    old = t_state
    old_ptrs = {k: p.data_ptr() for k, p in old.params.items()}
    new, _ = pstep(t_state, batch)
    assert {k: p.data_ptr() for k, p in new.params.items()} == old_ptrs
    assert all(p.untyped_storage().nbytes() > 0
               for p in new.params.values())
    with pytest.raises(RuntimeError, match="donated"):
        pstep(old, batch)
    assert isinstance(new.step, torch.Tensor) and int(new.step) == 1
    pstep(new, batch)   # the returned state is live
    assert len(pstep._executable_cache) == 1   # int step and 0-d tensor


@pytest.mark.parametrize("kwargs, item", [
    (dict(default_auto_sharding_option=object()), "A.3"),
    (dict(stage_input_shardings=[None]), "A.3"),
], ids=["auto-sharding", "stage-input-shardings"])
def test_unported_options_raise_with_their_roadmap_item(kwargs, item):
    kw = dict(devices=["cpu"] * 2, layer_option=ManualLayerOption(),
              stage_option=UniformStageOption(2))
    kw.update(kwargs)
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        PipeshardParallel(**kw)


def _raises_at_compile(method, step, state, batch, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        alpa_tpu_torch.parallelize(step, method=method)(state, batch)


def test_inference_schedule_and_forward_only_function_raise():
    """The inference schedule with a gradient step raises ``ValueError``
    (it runs forward-only functions); a forward-only function under 1F1B
    takes the inference path (forward stages only, the "inference"
    schedule) and returns the serial forward (rtol 1e-6)."""
    _, t_state, batch = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
    with pytest.raises(ValueError, match="forward-only"):
        alpa_tpu_torch.parallelize(
            _port_step, method=_port_method(2, 1, "inference"))(t_state,
                                                                batch)

    def forward(state, batch):
        return state.apply_fn(state.params, batch["x"])

    step = alpa_tpu_torch.parallelize(forward,
                                      method=_port_method(2, 2, "1f1b"))
    out = step(t_state, batch)
    with torch.no_grad():
        want = t_state.apply_fn(t_state.params, torch.from_numpy(batch["x"]))
    np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-6)
    ex = step.get_last_executable()
    assert not ex.has_bwd and ex.get_instruction_counts()["RUN"] == 4


def test_multi_device_stage_and_gpt_remat_raise():
    """A stage mesh of two devices raises citing ROADMAP A.3; GPT's per-block
    remat inside a pipeshard trace runs, except with the "dots" policy,
    which raises citing A.5.3."""
    _, t_state, batch = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
    two_per_stage = PipeshardParallel(
        devices=["cpu"] * 4, layer_option=ManualLayerOption(),
        stage_option=ManualStageOption([[0], [1]], [(1, 2), (1, 2)]))
    _raises_at_compile(two_per_stage, _port_step, t_state, batch, "A.3")

    cfg = tgm.GPTConfig(remat_blocks=True, remat_policy="dots",
                        pipeline_boundary_every=2, **GPT_SHAPE)
    model = tgm.GPTModel(cfg, device="cpu", param_dtype=torch.float32)
    state = tmu.TrainState.create(apply_fn=tmu.make_apply_fn(model),
                                  params=dict(model.named_parameters()),
                                  tx=tmu.sgd(1e-2))
    ids = np.zeros((2, GPT_SHAPE["seq_len"]), np.int64)

    def step(state, batch):
        loss, grads = alpa_tpu_torch.value_and_grad(
            lambda p: tmu.gpt_lm_loss(state.apply_fn, p, batch))(state.params)
        return state.apply_gradients(grads=grads), loss

    _raises_at_compile(_port_method(2, 1, "1f1b"), step, state,
                       {"input_ids": ids, "labels": ids}, "A.5.3")


def test_manual_stage_option_groups_layers_as_jax():
    """``ManualStageOption`` putting the 4 manual layers of
    ``BoundaryMLP`` into 2 stages of 2 layers: the same losses, parameters
    and per-mesh program as JAX's with the same option."""
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch = _mlp_pair(
        4, optax.sgd(1e-2, momentum=0.9), tmu.sgd(1e-2, momentum=0.9))
    layer_ids, shapes = [[0, 1], [2, 3]], [(1, 1), (1, 1)]
    j_pstep = alpa_tpu.parallelize(
        _jax_step, method=alpa_tpu.PipeshardParallel(
            num_micro_batches=2, layer_option=JaxManualLayerOption(),
            stage_option=jstage.ManualStageOption(layer_ids, shapes)))
    t_pstep = alpa_tpu_torch.parallelize(_port_step, method=PipeshardParallel(
        devices=["cpu"] * 2, num_micro_batches=2,
        layer_option=ManualLayerOption(),
        stage_option=ManualStageOption(layer_ids, shapes)))
    j_state, j_losses = _run(j_pstep, j_state,
                             jax.tree_util.tree_map(jnp.asarray, batch))
    t_state, t_losses = _run(t_pstep, t_state, batch)
    np.testing.assert_allclose(t_losses, j_losses, **MLP_TOL)
    ttesting.assert_allclose(
        t_state.params,
        mlp_params_from_flax(jax.tree_util.tree_map(np.asarray,
                                                    j_state.params)),
        **MLP_TOL)
    ours, theirs = t_pstep.get_last_executable(), \
        j_pstep.get_last_executable()
    assert [e.name for e in ours.stage_execs] == \
        ["stage_0_fwd", "stage_1_fwd", "stage_0_bwd", "stage_1_bwd"]
    assert _program(ours.instructions, ours.get_instruction_streams()) == \
        _program(theirs.instructions, jax_partition_streams(
            theirs.instructions, 2))


def test_a_tensor_constant_in_the_loss_is_copied_into_its_stage():
    """A tensor the loss makes from Python data is a constant of the
    traced graph: each stage that reads it gets its own copy (no input, no
    RESHARD), and the step equals the serial one."""
    _, t_state, batch = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
    _, serial_state, _ = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))

    def step(state, batch):

        def loss_fn(params):
            out = state.apply_fn(params, batch["x"])
            scale = torch.tensor([0.5, 2.0]).repeat(DIM // 2)
            return torch.mean((out * scale - batch["y"]) ** 2)

        loss, grads = alpa_tpu_torch.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    pstep = alpa_tpu_torch.parallelize(step,
                                       method=_port_method(2, 2, "1f1b"))
    t_state, t_losses = _run(pstep, t_state, batch)
    serial_state, s_losses = _run(step, serial_state, _port_batch(batch))
    np.testing.assert_allclose(t_losses, s_losses, **MLP_TOL)
    ttesting.assert_allclose(t_state.params, serial_state.params, **MLP_TOL)
    ex = pstep.get_last_executable()
    assert any(n.op == "get_attr" for e in ex.stage_execs
               for n in e.module.graph.nodes)
    assert all(v.op != "get_attr" for e in ex.stage_execs for v in e.invars)


def test_an_in_place_op_in_the_step_is_functionalized():
    """An in-place op in the loss leaves a mutating node in the trace; the
    compiler functionalizes the graph, so no stage mutates a value another
    stage reads, and the step equals the serial one."""
    _, t_state, batch = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))
    _, serial_state, _ = _mlp_pair(2, optax.sgd(1e-2), tmu.sgd(1e-2))

    def step(state, batch):

        def loss_fn(params):
            out = state.apply_fn(params, batch["x"])
            out.mul_(2.0)
            return torch.mean((out - batch["y"]) ** 2)

        loss, grads = alpa_tpu_torch.value_and_grad(loss_fn)(state.params)
        return state.apply_gradients(grads=grads), loss

    graph = _traced_graph(step, _mlp_pair(2, optax.sgd(1e-2),
                                          tmu.sgd(1e-2))[1],
                          _port_batch(batch))
    assert not any(n.target._schema.is_mutable for n in graph.nodes
                   if hasattr(n.target, "_schema"))
    pstep = alpa_tpu_torch.parallelize(step,
                                       method=_port_method(2, 2, "1f1b"))
    t_state, t_losses = _run(pstep, t_state, batch)
    serial_state, s_losses = _run(step, serial_state, _port_batch(batch))
    np.testing.assert_allclose(t_losses, s_losses, **MLP_TOL)
    ttesting.assert_allclose(t_state.params, serial_state.params, **MLP_TOL)
