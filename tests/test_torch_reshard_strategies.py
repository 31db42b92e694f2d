"""Cross-mesh resharding's planner, collective strategies and executors
against the JAX package, on the session's 8 virtual CPU devices.

The same (shape, source sharding, destination sharding) pairs go to JAX's
``plan_resharding`` (``NamedSharding``s) and the port's (``MeshSharding``s
over the same device ids), at JAX's defaults (the local all-gather
rewrite on) and with load balancing off: the requests, ``transfer_bytes``,
``broadcast_bytes``, both ``max_link_bytes`` pairs, ``send_order`` and the
``route_broadcast`` routes must be equal, exactly.  ``collective_options``'
link stats must be equal and ``choose_strategy``'s choice too under the
"link" wire model (JAX without a calibration, the port without a logical
mesh: both price the intra-mesh leg at 0), with costs to rtol 1e-6.  Each
execution mode and each forced strategy, run on a seeded numpy array,
must give JAX's executed array bit for bit, the planned modes with JAX's
``ExecutionReport`` bytes.
"""
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec

import jax
from alpa_tpu import mesh_profiling as jprof
from alpa_tpu.global_env import global_config as jconfig
from alpa_tpu.pipeline_parallel import cross_mesh_resharding as jcmr
from alpa_tpu_torch.device_mesh import DistributedArray, PhysicalDeviceMesh
from alpa_tpu_torch.global_env import global_config as tconfig
from alpa_tpu_torch.pipeline_parallel import cross_mesh_resharding as tcmr
from alpa_tpu_torch.pipeline_parallel import reshard_codec as tcodec

# (shape, source (mesh shape, spec), destination (mesh shape, spec)):
# replicated destinations (the rewrite splits them), a dim no replica
# count divides, sharded <-> sharded, 2 -> 4 and 4 -> 2 devices
CASES = [
    ((8, 16), ((1, 4), ((1,), ())), ((1, 4), ((), ()))),
    ((8, 16), ((1, 4), ((), ())), ((2, 2), ((0,), ()))),
    ((8, 16), ((1, 4), ((1,), ())), ((1, 4), ((), (1,)))),
    ((8, 16, 4), ((2, 2), ((0,), (1,), ())), ((2, 2), ((1,), (), (0,)))),
    ((8, 16), ((1, 2), ((1,), ())), ((1, 4), ((), (1,)))),
    ((8, 16), ((1, 2), ((), (1,))), ((2, 2), ((0, 1), ()))),
    ((12, 8), ((2, 1), ((0,), ())), ((1, 4), ((1,), ()))),
    ((6, 5), ((1, 2), ((1,), ())), ((2, 2), ((), ()))),
    ((16, 8), ((2, 2), ((0,), (1,))), ((2, 2), ((), (0,)))),
    ((16, 8), ((1, 4), ((), ())), ((1, 4), ((), ()))),
    ((16, 8), ((4, 1), ((0,), ())), ((2, 2), ((0,), ()))),
]

NAMES = ("mesh0", "mesh1")
KNOBS = ("resharding_transfer_latency_s", "resharding_wire_model",
         "resharding_wire_bandwidth", "reshard_strategy",
         "resharding_loadbalance_mode", "reshard_quantize",
         "reshard_quantize_min_bytes")


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
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
def _restore_knobs(monkeypatch):
    for k in KNOBS:
        monkeypatch.setattr(tconfig, k, getattr(tconfig, k))
        monkeypatch.setattr(jconfig, k, getattr(jconfig, k))
    # JAX without a calibration prices the intra-mesh leg at 0
    monkeypatch.setattr(jprof, "get_effective_calibration",
                        lambda *a, **k: None)
    yield


def _set(**knobs):
    for k, v in knobs.items():
        setattr(tconfig, k, v)
        setattr(jconfig, k, v)


def _jax_sharding(devices, mesh_shape, spec):
    mesh = Mesh(np.asarray(devices).reshape(mesh_shape), NAMES)
    parts = []
    for axes in spec:
        names = tuple(NAMES[a] for a in axes)
        parts.append(None if not names else
                     names[0] if len(names) == 1 else names)
    return NamedSharding(mesh, PartitionSpec(*parts))


def _pair(case):
    """JAX's and the port's (source, destination) shardings of a case,
    the source on the first devices, the destination on the next."""
    shape, (src_mesh, src_spec), (dst_mesh, dst_spec) = CASES[case]
    n_src, n_dst = int(np.prod(src_mesh)), int(np.prod(dst_mesh))
    devices = jax.devices()
    ids = [d.id for d in devices]
    jsrc = _jax_sharding(devices[:n_src], src_mesh, src_spec)
    jdst = _jax_sharding(devices[n_src:n_src + n_dst], dst_mesh, dst_spec)
    tsrc = tcmr.MeshSharding(src_spec, src_mesh, tuple(ids[:n_src]))
    tdst = tcmr.MeshSharding(dst_spec, dst_mesh,
                             tuple(ids[n_src:n_src + n_dst]))
    return shape, (jsrc, jdst), (tsrc, tdst)


def _requests(spec):
    return [(r.dst_shard_index, r.dst_tile.slices,
             [(s.tile.slices, s.src_shard_index, tuple(s.offset_in_src))
              for s in r.srcs]) for r in spec.requests]


FIELDS = ("transfer_bytes", "allgather_rewrite", "broadcast_bytes",
          "max_link_bytes", "max_link_bytes_naive",
          "max_link_bytes_broadcast", "max_link_bytes_broadcast_naive",
          "send_order", "loadbalanced", "src_device_ids", "dst_device_ids")


@pytest.mark.parametrize("loadbalance", [True, False])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_plan_resharding_equals_jax(case, loadbalance):
    shape, (jsrc, jdst), (tsrc, tdst) = _pair(case)
    want = jcmr.plan_resharding(shape, 4, jsrc, jdst,
                                loadbalance=loadbalance)
    got = tcmr.plan_resharding(shape, 4, tsrc, tdst,
                               loadbalance=loadbalance)
    assert _requests(got) == _requests(want)
    for f in FIELDS:
        assert getattr(got, f) == getattr(want, f), f
    assert [t.slices for t in got.dst_tiles] == \
        [t.slices for t in want.dst_tiles]
    assert tcmr.route_broadcast(got, loadbalance) == \
        jcmr.route_broadcast(want, loadbalance)
    for mode in ("send_recv", "broadcast"):
        assert tcmr.naive_transfer_bytes(shape, 4, tdst, mode) == \
            jcmr.naive_transfer_bytes(shape, 4, jdst, mode)
    for broadcast in (False, True):
        t = tcmr.compute_link_loads(got, broadcast, loadbalance)
        j = jcmr.compute_link_loads(want, broadcast, loadbalance)
        assert t == j


def test_planner_stats_count_plans():
    tcmr.reset_planner_stats()
    shape, _, (tsrc, tdst) = _pair(0)
    spec = tcmr.plan_resharding(shape, 4, tsrc, tdst)
    tcmr.plan_resharding(shape, 4, tsrc, tdst)
    stats = tcmr.get_planner_stats()
    assert stats["plans"] == 2
    assert stats["total_bytes"] == 2 * spec.transfer_bytes
    assert stats["broadcast_bytes"] == 2 * spec.broadcast_bytes
    assert stats["max_link_bytes"] == max(spec.max_link_bytes,
                                          spec.max_link_bytes_broadcast)
    tcmr.reset_planner_stats()
    assert tcmr.get_planner_stats()["plans"] == 0


def _landing_tiles(sharding, shape):
    if isinstance(sharding, tcmr.MeshSharding):
        vda = tcmr.VirtualDistributedArray.from_sharding(shape, sharding)
    else:
        vda = jcmr.VirtualDistributedArray.from_sharding(shape, sharding)
    return [t.slices for t in vda.device_tiles]


@pytest.mark.parametrize("case", range(len(CASES)))
def test_collective_options_equal_jax(case):
    shape, (jsrc, jdst), (tsrc, tdst) = _pair(case)
    want = jcmr.collective_options(shape, 4, jsrc, jdst)
    got = tcmr.collective_options(shape, 4, tsrc, tdst)
    assert list(got) == list(want)
    for name in want:
        assert got[name]["kind"] == want[name]["kind"]
        assert got[name]["stats"] == want[name]["stats"], name
        assert _landing_tiles(got[name]["landing"], shape) == \
            _landing_tiles(want[name]["landing"], shape), name


@pytest.mark.parametrize("forced", ["auto"] + list(tcmr.RESHARD_STRATEGIES))
@pytest.mark.parametrize("case", range(len(CASES)))
def test_choose_strategy_equals_jax_under_link_model(case, forced):
    _set(resharding_wire_model="link", resharding_transfer_latency_s=1e-3,
         resharding_wire_bandwidth=2e5, reshard_strategy=forced)
    shape, (jsrc, jdst), (tsrc, tdst) = _pair(case)
    jchoice, jcosts, _ = jcmr.choose_strategy(shape, 4, jsrc, jdst)
    tchoice, tcosts, _ = tcmr.choose_strategy(shape, 4, tsrc, tdst)
    assert tchoice == jchoice
    assert list(tcosts) == list(jcosts)
    np.testing.assert_allclose([tcosts[k] for k in jcosts],
                               [jcosts[k] for k in jcosts], rtol=1e-6)
    chosen, costs, cached = tcmr.resolve_strategy(shape, 4, tsrc, tdst)
    assert (chosen, costs, cached) == (tchoice, tcosts, False)


def test_intra_leg_priced_by_the_destination_mesh():
    """With the destination's logical mesh, a strategy's intra-mesh leg
    costs its collective along each axis the landing layout adds, in
    ``LogicalDeviceMesh``'s alpha-beta units; at the default knobs (no
    wire latency, no bandwidth) direct_p2p stays the choice."""
    shape, _, (tsrc, tdst) = _pair(0)
    mesh = PhysicalDeviceMesh(["cpu"] * 4).get_logical_mesh((1, 4))
    choice, costs, opts = tcmr.choose_strategy(shape, 4, tsrc, tdst, mesh)
    assert choice == "direct_p2p" and costs["direct_p2p"] == 0.0
    nbytes = float(np.prod(shape)) * 4
    for name, o in opts.items():
        if o["kind"] is None:
            continue
        axes = [a for a, _ in tcmr._relayout_axes(o["landing"], tdst)]
        assert axes
        assert costs[name] == pytest.approx(sum(
            getattr(mesh, f"{o['kind']}_cost")(nbytes, a) for a in axes))


def _source(case, seed=0):
    """A seeded array, as JAX's array on the source sharding and as the
    port's source shards."""
    shape, (jsrc, jdst), (tsrc, tdst) = _pair(case)
    full = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    jarr = jax.device_put(full, jsrc)
    src_mesh = CASES[case][1][0]
    tarr = DistributedArray.from_full(
        torch.from_numpy(full), tsrc.spec, PhysicalDeviceMesh(
            ["cpu"] * int(np.prod(src_mesh))).get_logical_mesh(src_mesh))
    return full, jarr, tarr.shards


def _jax_shards(out, jdst, shape):
    index = jdst.devices_indices_map(tuple(shape))
    data = {s.device.id: np.asarray(s.data) for s in out.addressable_shards}
    return [data[d.id] for d in index]


@pytest.mark.parametrize("mode", ["device_put", "tiled", "broadcast"])
@pytest.mark.parametrize("case", range(len(CASES)))
def test_execution_modes_equal_jax(case, mode):
    shape, (jsrc, jdst), (tsrc, tdst) = _pair(case)
    full, jarr, tshards = _source(case)
    jspec = jcmr.plan_resharding(shape, 4, jsrc, jdst)
    jtask = jcmr.ReshardingTask(jspec, jdst)
    want = _jax_shards(jtask.run(jarr, mode), jdst, shape)
    # the direct executor runs a plan without the all-gather rewrite, and
    # refuses one with it
    tspec = tcmr.plan_resharding(shape, 4, tsrc, tdst,
                                 allow_allgather_rewrite=mode != "device_put")
    n_src, n_dst = len(tsrc.device_ids), len(tdst.device_ids)
    if mode == "device_put" and jspec.allgather_rewrite:
        with pytest.raises(ValueError, match="all-gather rewrite"):
            tcmr.ReshardingTask(tcmr.plan_resharding(shape, 4, tsrc, tdst),
                                ["cpu"] * n_src, ["cpu"] * n_dst, mode)
    task = tcmr.ReshardingTask(tspec, ["cpu"] * n_src, ["cpu"] * n_dst, mode)
    got, moved = task(tshards)
    assert moved == 0    # one physical device
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    rep, jrep = task.last_report, jtask.last_report
    if mode == "device_put":
        # JAX's runtime carries the move; the port's direct executor
        # sends every piece of its plan
        assert rep.cross_mesh_bytes == tspec.transfer_bytes
        assert rep.intra_mesh_bytes == 0
        return
    for f in ("cross_mesh_bytes", "intra_mesh_bytes", "n_tiles",
              "max_link_bytes"):
        assert getattr(rep, f) == getattr(jrep, f), f
    assert rep.cross_mesh_bytes == (tspec.broadcast_bytes
                                    if mode == "broadcast"
                                    else tspec.transfer_bytes)


@pytest.mark.parametrize("case", range(len(CASES)))
def test_forced_strategies_equal_direct_and_jax(case):
    """Each eligible strategy, lowered by ``make_transfer`` with the
    destination's logical mesh, gives the direct executor's shards bit
    for bit, and JAX's executed array of the same forced strategy."""
    shape, (jsrc, jdst), (tsrc, tdst) = _pair(case)
    full, jarr, tshards = _source(case, seed=1)
    dst_mesh_shape = CASES[case][2][0]
    n_src, n_dst = len(tsrc.device_ids), len(tdst.device_ids)
    lmesh = PhysicalDeviceMesh(["cpu"] * n_dst).get_logical_mesh(
        dst_mesh_shape)
    base = tcmr.plan_resharding(shape, 4, tsrc, tdst,
                                allow_allgather_rewrite=False)
    direct, _ = tcmr.ReshardingTask(base, ["cpu"] * n_src,
                                    ["cpu"] * n_dst)(tshards)
    for name in tcmr.collective_options(shape, 4, tsrc, tdst):
        _set(reshard_strategy=name)
        plan = tcmr.plan_resharding(shape, 4, tsrc, tdst,
                                    allow_allgather_rewrite=False,
                                    logical_mesh=lmesh)
        assert plan.strategy == name
        t = tcmr.make_transfer(plan, tsrc, tdst, ["cpu"] * n_src,
                               ["cpu"] * n_dst, torch.float32, cross=True,
                               dst_logical_mesh=lmesh)
        assert t.strategy == name
        got, _ = t(tshards)
        jt = jcmr.make_transfer(jax.ShapeDtypeStruct(shape, np.float32),
                                jsrc, jdst, cross=True,
                                plan=jcmr.plan_resharding(shape, 4, jsrc,
                                                          jdst))
        want = _jax_shards(jt(jarr), jdst, shape)
        for g, d, w in zip(got, direct, want):
            assert torch.equal(g, d), name
            np.testing.assert_array_equal(g.numpy(), w)
        if name != "direct_p2p":
            assert t.last_report.cross_mesh_bytes == \
                t.wire_plan.transfer_bytes


def test_make_transfer_never_quantizes_weights_or_relayouts():
    _set(reshard_quantize="int8", reshard_quantize_min_bytes=0)
    shape, _, (tsrc, tdst) = _pair(9)
    plan = tcmr.plan_resharding(shape, 4, tsrc, tdst,
                                allow_allgather_rewrite=False)
    args = (plan, tsrc, tdst, ["cpu"] * 4, ["cpu"] * 4, torch.float32)
    assert isinstance(tcmr.make_transfer(*args, cross=True),
                      tcodec.QuantizedTransfer)
    assert isinstance(tcmr.make_transfer(*args, cross=True, weight=True),
                      tcmr.DirectTransfer)
    assert isinstance(tcmr.make_transfer(*args, cross=False),
                      tcmr.DirectTransfer)
    # an integer payload is not eligible
    assert isinstance(tcmr.make_transfer(*args[:-1], torch.int64,
                                         cross=True), tcmr.DirectTransfer)
    _set(reshard_quantize="off")
    assert isinstance(tcmr.make_transfer(*args, cross=True),
                      tcmr.DirectTransfer)


def test_pipeshard_codec_quantizes_activation_edges_only(monkeypatch):
    """With ``reshard_quantize="int8"`` the two-level MLP's cross-mesh
    activation edges (microbatch >= 0) run the codec, no weight edge
    does, the step runs and its losses stay within the codec's error of
    the lossless step's."""
    monkeypatch.setattr(tconfig, "reshard_quantize_min_bytes", 0)
    base_losses = _pipeshard_mlp_run()[0]
    losses, _, stats, ex = _pipeshard_mlp_run(reshard_quantize="int8")
    edges = [(i.var_key[1], isinstance(i.resharding[0],
                                       tcodec.QuantizedTransfer))
             for i in ex.instructions if i.opcode.name == "RESHARD"]
    assert any(q for _, q in edges)
    assert all(mb >= 0 for mb, q in edges if q)
    assert any(mb < 0 for mb, _ in edges)    # weight edges, lossless
    assert stats["strategies"]["quantized_int8"] == sum(q for _, q in edges)
    np.testing.assert_allclose(losses, base_losses, rtol=1e-2)


def test_make_ingest_transfer_lands_a_host_value():
    _, _, (_, tdst) = _pair(2)
    full = torch.arange(128, dtype=torch.float32).reshape(8, 16)
    t = tcmr.make_ingest_transfer((8, 16), torch.float32, tdst, ["cpu"] * 4)
    shards, _ = t([full])
    assert t.wire == (1, float(full.numel() * 4))
    for p, s in enumerate(shards):
        assert torch.equal(s, full[:, 4 * p:4 * (p + 1)])


def test_resharding_plan_report_and_fingerprint():
    tcmr.reset_recent_plans()
    shape, _, (tsrc, tdst) = _pair(0)
    tcmr.plan_resharding(shape, 4, tsrc, tdst)
    first = tcmr.strategy_plan_fingerprint()
    text = tcmr.format_resharding_plan()
    assert "strategy=direct_p2p" in text and str(shape) in text
    tcmr.reset_recent_plans()
    tcmr.plan_resharding(shape, 4, tsrc, tdst)
    assert tcmr.strategy_plan_fingerprint() == first
    tcmr.reset_recent_plans()
    assert "no cross-mesh edges" in tcmr.format_resharding_plan()


def _pipeshard_mlp_run(**values):
    """The 4-layer MLP in two stages of four CPU devices (the ILP in each),
    2 SGD steps from seeded weights, with the knobs ``values`` set: the
    losses, the parameters and the executable's resharding stats."""
    import alpa_tpu_torch
    from alpa_tpu_torch import (ManualLayerOption, PipeshardParallel,
                                UniformStageOption)
    from alpa_tpu_torch import testing as ttesting
    from alpa_tpu_torch.model import model_util as tmu
    for k, v in values.items():
        setattr(tconfig, k, v)
    state, batch = ttesting.create_mlp_train_state_and_batch(
        batch_size=16, input_dim=32, hidden_dim=32, output_dim=32,
        num_layers=4, manual_pipeline_layer=True, seed=0,
        tx=tmu.sgd(1e-2, momentum=0.9))
    step = alpa_tpu_torch.parallelize(
        ttesting.get_mlp_train_step(use_value_and_grad=True),
        method=PipeshardParallel(devices=["cpu"] * 8, num_micro_batches=2,
                                 layer_option=ManualLayerOption(),
                                 stage_option=UniformStageOption(2)))
    losses = []
    for _ in range(2):
        state, loss = step(state, batch)
        losses.append(float(loss))
    ex = step.get_last_executable()
    params = ttesting.gather_tree(state.params)
    alpa_tpu_torch.shutdown()
    return losses, params, ex.get_resharding_stats(), ex


@pytest.mark.parametrize("values", [
    dict(resharding_execution="planned"),
    dict(resharding_execution="planned", resharding_mode="broadcast"),
    dict(reshard_strategy="slice_all_gather"),
    dict(reshard_strategy="reduce_scatter_gather")],
    ids=["tiled", "broadcast", "slice_all_gather", "reduce_scatter_gather"])
def test_pipeshard_executions_equal_the_default(values, monkeypatch):
    """The two-level MLP under each cross-mesh execution the knobs select
    gives the default (direct) step's losses and parameters bit for bit;
    the planned modes' cross-mesh bytes are the tile plans' (fewer than
    the naive plans': the rewrite), the rest moving inside the meshes.
    No edge of this model is eligible for ``all_to_all``; the executor
    tests above hold it to JAX's."""
    monkeypatch.setattr(tconfig, "resharding_execution", "device_put")
    monkeypatch.setattr(tconfig, "resharding_mode", "send_recv")
    base_losses, base_params, base, _ = _pipeshard_mlp_run()
    assert base["strategies"] == {"direct_p2p": base["cross_mesh"]}
    assert base["cross_mesh_bytes"] == base["naive_cross_mesh_bytes"]
    losses, params, stats, _ = _pipeshard_mlp_run(**values)
    assert losses == base_losses
    for name, want in base_params.items():
        assert torch.equal(params[name], want), name
    if "resharding_execution" in values:
        assert set(stats["strategies"]) == {
            "broadcast" if "resharding_mode" in values else "tiled"}
        assert stats["cross_mesh_bytes"] == stats["planned_bytes"] < \
            stats["naive_cross_mesh_bytes"]
        assert stats["intra_mesh_bytes"] > 0
    else:
        assert values["reshard_strategy"] in stats["strategies"]
