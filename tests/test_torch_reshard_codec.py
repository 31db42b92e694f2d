"""The activation and gradient codecs against the JAX package.

The activation codec (``encode``/``decode``) must give JAX's ``q`` and
scales bit for bit on the same seeded inputs, for int8 and fp8: both
sides divide in fp32 and round to nearest, half to even (``jnp.round``
and ``torch.round``; the fp8 casts of ``astype`` and ``.to``), and
``wire_bytes``, ``eligible`` and ``ERROR_BOUND`` are JAX's.  Its round
trip stays within ``ERROR_BOUND`` of each block's largest magnitude, and
a quantized cross-mesh edge lands every block within that bound.

The stochastic gradient codec draws its uniforms from a
``torch.Generator`` where JAX draws from ``jax.random``, so it is held to
JAX's contract tests (``tests/shard_parallel/test_grad_quant.py:70-210``)
rather than to JAX's bits: unbiasedness, error feedback's amortisation,
ragged, zero and denormal blocks, the reduce-scatter's two-hop bound,
the bound's composition, the eligibility gate; and the ILP flips the
same MLP gradient tensors to the quantized reduce-scatter as JAX's.
Accumulation with ``grad_quantize="int8"`` keeps the gradients within
``grad_error_bound`` of the unquantized step.
"""
import re

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.tree_util import keystr, tree_flatten_with_path

import alpa_tpu_torch
from alpa_tpu import testing as jtesting
from alpa_tpu.device_mesh import PhysicalDeviceMesh as JaxPhysicalMesh
from alpa_tpu.global_env import global_config as jconfig
from alpa_tpu.pipeline_parallel import reshard_codec as jcodec
from alpa_tpu.shard_parallel import auto_sharding as jas
from alpa_tpu.shard_parallel import solver as jsolver
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.device_mesh import DistributedArray, PhysicalDeviceMesh
from alpa_tpu_torch.global_env import global_config as tconfig
from alpa_tpu_torch.model import model_util as tmu
from alpa_tpu_torch.pipeline_parallel import cross_mesh_resharding as tcmr
from alpa_tpu_torch.pipeline_parallel import reshard_codec as codec
from alpa_tpu_torch.shard_parallel import auto_sharding as tas
from alpa_tpu_torch.shard_parallel import solver as tsolver

MODES = ("int8", "fp8")
KNOBS = ("grad_quantize", "grad_quantize_min_bytes", "grad_error_feedback",
         "reshard_quantize", "reshard_quantize_min_bytes")


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


@pytest.fixture(autouse=True)
def _restore_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.setattr(tconfig, k, getattr(tconfig, k))
        monkeypatch.setattr(jconfig, k, getattr(jconfig, k))
    yield


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def _blockmax(x):
    """Per element, its 256-block's largest magnitude."""
    flat = np.ravel(np.asarray(x, np.float32))
    n = flat.size
    nb = -(-n // codec.BLOCK)
    padded = np.pad(flat, (0, nb * codec.BLOCK - n))
    bm = np.abs(padded.reshape(nb, codec.BLOCK)).max(axis=1)
    return np.repeat(bm, codec.BLOCK)[:n]


def _inputs():
    rng = np.random.default_rng(0)
    return {
        "aligned": rng.standard_normal((4, 256)).astype(np.float32),
        "ragged": (rng.standard_normal((3, 7, 19)) * 50).astype(np.float32),
        "zero_block": np.concatenate([np.zeros(256, np.float32),
                                      rng.standard_normal(300).astype(
                                          np.float32)]),
        "halves": (np.arange(-600, 600, dtype=np.float32) / 4.0),
        "tiny": (rng.standard_normal(512) * 1e-30).astype(np.float32),
        "scalar": np.asarray(3.25, np.float32),
    }


def test_constants_equal_jax():
    assert codec.BLOCK == jcodec.BLOCK
    assert codec.ERROR_BOUND == jcodec.ERROR_BOUND
    assert codec.GRAD_MODES == jcodec.GRAD_MODES
    assert float(np.float32(codec._SCALE_FLOOR)) == \
        float(jcodec._SCALE_FLOOR)
    for shape in [(), (7,), (256,), (3, 100), (1000, 3)]:
        assert codec.wire_bytes(shape, 4, "int8") == \
            jcodec.wire_bytes(shape, 4, "int8")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", list(_inputs()))
def test_encode_decode_bit_exact_with_jax(name, mode):
    x = _inputs()[name]
    jq, js = jcodec.encode(jnp.asarray(x), mode)
    tq, ts = codec.encode(torch.from_numpy(x), mode)
    jq = np.asarray(jq)
    if mode == "int8":
        np.testing.assert_array_equal(tq.numpy(), jq)
    else:
        np.testing.assert_array_equal(
            tq.view(torch.uint8).numpy(),
            jq.view(np.uint8))
    np.testing.assert_array_equal(ts.numpy().view(np.uint32),
                                  np.asarray(js).view(np.uint32))
    jd = jcodec.decode(jnp.asarray(jq), js, x.shape, jnp.float32, mode)
    td = codec.decode(tq, ts, x.shape, torch.float32, mode)
    np.testing.assert_array_equal(td.numpy().view(np.uint32),
                                  np.asarray(jd).view(np.uint32))
    err = np.abs(td.numpy().astype(np.float64).ravel() -
                 x.astype(np.float64).ravel())
    assert np.all(err <= codec.ERROR_BOUND[mode] * _blockmax(x) + 1e-45)


def test_bf16_payload_bit_exact_with_jax():
    x = np.random.default_rng(3).standard_normal(700).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    for mode in MODES:
        jq, js = jcodec.encode(jx, mode)
        tq, ts = codec.encode(tx, mode)
        np.testing.assert_array_equal(tq.view(torch.uint8).numpy(),
                                      np.asarray(jq).view(np.uint8))
        jd = jcodec.decode(jq, js, x.shape, jnp.bfloat16, mode)
        td = codec.decode(tq, ts, x.shape, torch.bfloat16, mode)
        np.testing.assert_array_equal(
            td.view(torch.int16).numpy(),
            np.asarray(jd).view(ml_dtypes.bfloat16).view(np.int16))


def test_eligible_equals_jax():
    jconfig.reshard_quantize_min_bytes = 4096
    tconfig.reshard_quantize_min_bytes = 4096
    for shape in [(16,), (1024,), (32, 32), (1025,)]:
        for jd, td in [(np.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16),
                       (np.int32, torch.int32)]:
            for mode in ("int8", "fp8", "off", "nope"):
                aval = jax.ShapeDtypeStruct(shape, jd)
                assert codec.eligible(shape, td, mode) == \
                    jcodec.eligible(aval, mode), (shape, td, mode)


@pytest.mark.parametrize("mode", MODES)
def test_quantized_edge_lands_every_block_within_bound(mode):
    """A cross-mesh edge through the codec, (1, 2) sharded on rows to a
    (2, 2) mesh sharded on columns: every destination block within the
    codec's bound of the source, the wire bytes the codec's, about 3.94x
    fewer than the lossless bytes."""
    tconfig.reshard_quantize = mode
    tconfig.reshard_quantize_min_bytes = 0
    shape = (64, 128)
    src = tcmr.MeshSharding(((1,), ()), (1, 2), (0, 1))
    dst = tcmr.MeshSharding(((), (0,)), (2, 2), (2, 3, 4, 5))
    full = torch.from_numpy(np.random.default_rng(5).standard_normal(
        shape).astype(np.float32))
    shards = DistributedArray.from_full(full, src.spec, PhysicalDeviceMesh(
        ["cpu"] * 2).get_logical_mesh((1, 2))).shards
    plan = tcmr.plan_resharding(shape, 4, src, dst,
                                allow_allgather_rewrite=False)
    t = tcmr.make_transfer(plan, src, dst, ["cpu"] * 2, ["cpu"] * 4,
                           torch.float32, cross=True)
    assert isinstance(t, codec.QuantizedTransfer)
    out, moved = t(shards)
    assert moved == 0
    want = tcmr.ReshardingTask(plan, ["cpu"] * 2, ["cpu"] * 4)(shards)[0]
    bound = codec.ERROR_BOUND[mode] * _blockmax(full.numpy()).reshape(shape)
    vda = tcmr.VirtualDistributedArray.from_sharding(shape, dst)
    for got, exact, tile in zip(out, want, vda.device_tiles):
        err = (got - exact).abs().numpy()
        assert np.all(err <= bound[tcmr._index(tile.slices)] + 1e-45)
    rep = t.last_report
    assert rep.cross_mesh_bytes == codec.wire_bytes(shape, 4, mode) == \
        64 * 128 + 4 * 32
    assert 64 * 128 * 4 / rep.cross_mesh_bytes == pytest.approx(3.94, 1e-2)


class TestGradCodecContract:
    """JAX's contract tests of the gradient codec, pinned from
    ``ERROR_BOUND``."""

    @pytest.mark.parametrize("mode", MODES)
    def test_stochastic_rounding_is_unbiased(self, mode):
        rng = np.random.default_rng(7)
        x = torch.from_numpy(rng.standard_normal(512).astype(np.float32))
        bound = codec.ERROR_BOUND[f"grad_{mode}"]
        n_seeds = 256
        acc = np.zeros(512, np.float64)
        for s in range(n_seeds):
            g_hat, _ = codec.grad_compress(x, mode, _gen(s))
            err = g_hat.double().numpy() - x.double().numpy()
            assert np.all(np.abs(err) <= bound * _blockmax(x) + 1e-7)
            acc += g_hat.double().numpy()
        mean_err = np.abs(acc / n_seeds - x.double().numpy())
        tol = bound * _blockmax(x) * (6.0 / (2.0 * np.sqrt(n_seeds)))
        assert np.all(mean_err <= tol + 1e-7)

    @pytest.mark.parametrize("mode", MODES)
    def test_error_feedback_amortizes_cumulative_error(self, mode):
        rng = np.random.default_rng(3)
        g = torch.from_numpy(rng.standard_normal(600).astype(np.float32)
                             * 0.3)
        bound = codec.ERROR_BOUND[f"grad_{mode}"]
        k, res = 8, None
        sent = np.zeros(600, np.float64)
        for step in range(k):
            g_hat, res = codec.grad_compress(g, mode, _gen(100 + step),
                                             residual=res)
            sent += g_hat.double().numpy()
        cum_err = np.abs(sent - k * g.double().numpy())
        single_shot = bound * _blockmax(g) * (1.0 + bound) + 1e-6
        assert np.all(cum_err <= single_shot)
        assert np.all(cum_err <= k * bound * _blockmax(g) + 1e-6)

    @pytest.mark.parametrize("mode", MODES)
    def test_ragged_zero_and_denormal_blocks_within_bound(self, mode):
        bound = codec.ERROR_BOUND[f"grad_{mode}"]
        rng = np.random.default_rng(11)
        cases = [rng.standard_normal(1000).astype(np.float32),
                 np.zeros(300, np.float32),
                 (rng.standard_normal(512) * 1e-40).astype(np.float32)]
        for arr in cases:
            g_hat, res = codec.grad_compress(torch.from_numpy(arr), mode,
                                             _gen(5))
            err = np.abs(g_hat.double().numpy() - arr.astype(np.float64))
            assert torch.isfinite(g_hat).all()
            assert np.all(err <= bound * _blockmax(arr) +
                          float(np.float32(codec._SCALE_FLOOR)))
            if not arr.any():
                assert not g_hat.any() and not res.any()

    @pytest.mark.parametrize("mode", MODES)
    def test_reduce_scatter_two_hop_bound(self, mode):
        rng = np.random.default_rng(23)
        grads = [torch.from_numpy(rng.standard_normal(700).astype(
            np.float32)) for _ in range(4)]
        mean_hat, new_res = codec.grad_reduce_scatter(grads, mode, _gen(9))
        true_mean = np.mean([g.double().numpy() for g in grads], axis=0)
        bound_rs = codec.ERROR_BOUND[f"grad_{mode}_rs"]
        scale = np.max([_blockmax(g) for g in grads], axis=0)
        err = np.abs(mean_hat.double().numpy() - true_mean)
        assert np.all(err <= bound_rs * scale * (1.0 + bound_rs) + 1e-6)
        assert len(new_res) == 4

    def test_grad_error_bound_composes_from_the_dict(self):
        eb = codec.ERROR_BOUND
        for mode in MODES:
            assert codec.grad_error_bound(mode) == eb[f"grad_{mode}"] == \
                jcodec.grad_error_bound(mode)
            assert codec.grad_error_bound(mode, reduce_scatter=True) == \
                eb[f"grad_{mode}_rs"]
            assert codec.grad_error_bound(mode, error_feedback=False,
                                          hops=4) == 4 * eb[f"grad_{mode}"]
            assert eb[f"grad_{mode}_rs"] == pytest.approx(
                2 * eb[f"grad_{mode}"])

    def test_grad_eligible_gating(self):
        assert codec.grad_eligible((256, 256), torch.float32, "int8",
                                   min_bytes=1024)
        assert not codec.grad_eligible((4,), torch.float32, "int8",
                                       min_bytes=1024)
        assert not codec.grad_eligible((256, 256), torch.int32, "int8",
                                       min_bytes=0)
        assert not codec.grad_eligible((256, 256), torch.float32, "nope",
                                       min_bytes=0)
        tconfig.grad_quantize_min_bytes = 1 << 30
        assert not codec.grad_eligible((256, 256), torch.float32, "int8")


def _mlp_flats():
    """JAX's and the port's flat MLP step (hidden 64, 8 rows), avals,
    paths and batch indices, as their ``parallelize`` hands them over."""
    jstate, jbatch = jtesting.create_mlp_train_state_and_batch(
        16, hidden_dim=64)

    def jstep(state, batch):
        import alpa_tpu
        loss, grads = alpa_tpu.value_and_grad(lambda p: jnp.mean(
            (state.apply_fn(p, batch["x"]) - batch["y"]) ** 2))(state.params)
        return state.apply_gradients(grads=grads), loss

    leaves, tree = tree_flatten_with_path((jstate, jbatch))
    javals = [jax.ShapeDtypeStruct(np.shape(x), jnp.asarray(x).dtype)
              for _, x in leaves]

    def jflat(*xs):
        return jax.tree_util.tree_leaves(
            jstep(*jax.tree_util.tree_unflatten(tree, xs)))

    n_state = len(jax.tree_util.tree_leaves(jstate))
    jpaths = [keystr(p) for p, _ in leaves]

    params = jax.tree_util.tree_map(np.asarray, jstate.params)
    tstate, tbatch = ttesting.create_mlp_train_state_and_batch(
        batch_size=16, input_dim=32, hidden_dim=64, output_dim=32,
        num_layers=2, params=params, x=np.asarray(jbatch["x"]),
        y=np.asarray(jbatch["y"]), tx=tmu.sgd(1e-2, momentum=0.9))

    class Capture(alpa_tpu_torch.ParallelMethod):
        donates_in_place = False

        def compile_executable(self, fun, *, avals, batch_invars,
                               donated_invars):
            self.captured = (fun, list(avals), list(fun.in_paths),
                             [i for i, b in enumerate(batch_invars) if b])
            raise StopIteration

    method = Capture()
    with pytest.raises(StopIteration):
        alpa_tpu_torch.parallelize(
            ttesting.get_mlp_train_step(use_value_and_grad=True),
            method=method)(tstate, tbatch)
    return ((jflat, javals, jpaths, list(range(n_state, len(javals)))),
            method.captured, jstate)


def _port_path(jax_path):
    """The port's path of a JAX MLP state leaf: ``Dense_i``'s ``kernel``
    and ``bias`` are ``layers.i``'s ``weight`` and ``bias``."""
    kind = re.search(r"opt_state\[0\]\.(\w+)", jax_path)
    layer, leaf = re.search(r"Dense_(\d+)'\]\['(\w+)'\]", jax_path).groups()
    key = f"layers.{layer}.{'weight' if leaf == 'kernel' else leaf}"
    if kind is None:
        return f"[0].params['{key}']"
    return f"[0].opt_state[0]['{kind.group(1)}']['{key}']"


def _flipped_jax(jflat, option):
    _, _, _, _, (graph, choice) = jsolver.plan_auto_sharding(
        *jflat, JaxPhysicalMesh(np.array(jax.devices())), option,
        return_graph=True)
    return {jflat[2][n.invar_idx] for n, s in zip(graph.nodes, choice)
            if n.kind == "invar" and getattr(n.strategies[s], "codec", None)}


def test_ilp_flips_the_mlp_tensors_jax_flips():
    """With ``grad_quantize="int8"`` and a tight memory budget, the ILP
    routes the same gradient tensors through the quantized reduce-scatter
    as JAX's (by path), the counters count them, and ``off`` flips none."""
    from alpa_tpu_torch.pipeline_parallel.reshard_codec import STATS
    jflat, tflat, jstate = _mlp_flats()
    state_bytes = sum(np.prod(a.shape) * a.dtype.itemsize
                      for a in jax.tree_util.tree_leaves(jstate)
                      if hasattr(a, "shape") and a.shape)
    tight = int(state_bytes * 0.66)
    for knob in (jconfig, tconfig):
        knob.grad_quantize = "int8"
        knob.grad_quantize_min_bytes = 1024
    want = _flipped_jax(jflat, jas.AutoShardingOption(
        memory_budget_per_device=tight))
    before = STATS["grad_tensors_int8"]
    res = tsolver.plan_auto_sharding(
        *tflat, PhysicalDeviceMesh(["cpu"] * 8),
        tas.AutoShardingOption(memory_budget_per_device=tight))
    graph, choice = res[2]
    got = {tflat[2][i] for i, _, _ in tsolver.quantized_choices(graph,
                                                               choice)}
    assert want and got == {_port_path(p) for p in want}
    assert STATS["grad_tensors_int8"] - before == len(got)
    tconfig.grad_quantize = "off"
    res = tsolver.plan_auto_sharding(
        *tflat, PhysicalDeviceMesh(["cpu"] * 8),
        tas.AutoShardingOption(memory_budget_per_device=tight))
    assert not tsolver.quantized_choices(*res[2])


@pytest.mark.parametrize("devices", [["cpu"], ["cpu"] * 2])
def test_quantized_accumulation_within_bound(devices):
    """``Zero2Parallel(num_micro_batches=2)`` on the MLP with
    ``grad_quantize="int8"``: every microbatch's gradient goes through the
    codec with error feedback, so Adam's first moment after one step stays
    within ``grad_error_bound`` of each tensor's largest against the
    unquantized step; at "off" the step is bit-identical to one without
    the knob."""
    rng = np.random.default_rng(0)
    # one row 16 times: the two microbatches equal, however the devices
    # split the rows, so the mean's blocks bound each microbatch's
    x = np.tile(rng.standard_normal((1, 32)).astype(np.float32), (16, 1))
    y = np.tile(rng.standard_normal((1, 32)).astype(np.float32), (16, 1))

    def run():
        state, batch = ttesting.create_mlp_train_state_and_batch(
            batch_size=16, input_dim=32, hidden_dim=64, output_dim=32,
            num_layers=2, x=x, y=y, tx=tmu.adam(1e-2), seed=0)
        step = alpa_tpu_torch.parallelize(
            ttesting.get_mlp_train_step(use_value_and_grad=True),
            method=alpa_tpu_torch.Zero2Parallel(num_micro_batches=2,
                                                devices=devices))
        state, loss = step(state, batch)
        mu = ttesting.gather_tree(state.opt_state[0]["mu"])
        return {k: v.clone() for k, v in mu.items()}, float(loss)

    tconfig.grad_quantize_min_bytes = 1024
    base, base_loss = run()
    tconfig.grad_quantize = "int8"
    quant, quant_loss = run()
    assert quant_loss == base_loss
    bound = codec.grad_error_bound("int8")
    flipped = 0
    for name, want in base.items():
        got = quant[name]
        if want.numel() * 4 < 1024:
            assert torch.equal(got, want), name
            continue
        flipped += not torch.equal(got, want)
        # the first moment is 0.1 x the mean of the two microbatches'
        # gradients; with error feedback the mean misses by the last
        # residual over 2, within half the bound of the mean's blocks
        assert float((got - want).abs().max()) <= \
            bound / 2 * float(want.abs().max()) * (1 + bound), name
    assert flipped
    tconfig.grad_quantize = "off"
    again, _ = run()
    for name in base:
        assert torch.equal(again[name], base[name])
