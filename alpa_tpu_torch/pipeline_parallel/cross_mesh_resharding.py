"""Cross-mesh resharding: the tile planner, the collective strategies and
their executors.

Counterpart of ``alpa_tpu/pipeline_parallel/cross_mesh_resharding.py``.  A
value produced under one Spec on one stage mesh and read under another
Spec on another mesh (or on the same mesh, a relayout) moves as tiles:
each destination shard is covered by the pieces of the source shards
that intersect it, a piece replicated on several source devices taken
from the least loaded one.  Where the destination replicates a block,
the local all-gather rewrite (MLSys'23; ``allgather_rewrite``) has each
of its k holders fetch a disjoint 1/k across meshes and the destination
mesh all-gather the parts; broadcast routing (``route_broadcast``) sends
each unique piece once, to the group member with the least ingress,
which broadcasts it to the group.  The planner also reports both
max-link objectives (balanced and naive), the greedy send order and
JAX's per-edge collective strategies (``collective_options``,
``choose_strategy``), whose intra-mesh leg the destination's
``LogicalDeviceMesh`` prices.

Executors take a value's shards and return the destination's:
``ReshardingTask`` runs a plan in JAX's modes (``"device_put"``, the
default, assembles each destination shard from its pieces; ``"tiled"``
and ``"broadcast"`` add the intra-mesh legs); ``DirectTransfer``,
``CollectiveTransfer`` and the codec's ``QuantizedTransfer``
(``reshard_codec.py``) are the edge executors ``make_transfer`` picks.
Each fills an ``ExecutionReport``.  Pieces move with ``non_blocking``
only into a card; the intra-mesh legs run ``shard_parallel.collectives``
(NCCL between distinct cards, plain tensor ops on one card or the host).
A value on a mesh of one device is a plain tensor (its plan one piece,
the whole tensor); on a wider mesh it is a ``DistributedArray``.

``resolve_strategy`` replays each edge's decision from the compile cache
(namespace ``reshard_strategy``); the planner's counters are the
``alpa_resharding_*`` families and ``alpa_reshard_strategy_total``.
Waiting for another module: ``run_multiprocess`` (A.1).
"""
import dataclasses
import hashlib
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from alpa_tpu_torch import fault as _fault
from alpa_tpu_torch.device_mesh import DistributedArray
from alpa_tpu_torch.telemetry import metrics as _tmetrics
from alpa_tpu_torch.telemetry import trace as _ttrace
from alpa_tpu_torch.shard_parallel.sharding_spec import Spec, local_slices

Slice = Tuple[int, int]


@dataclasses.dataclass(frozen=True)
class Tile:
    """An axis-aligned box of the global array."""
    slices: Tuple[Slice, ...]

    @property
    def shape(self) -> Tuple[int, ...]:
        return tuple(b - a for a, b in self.slices)

    @property
    def size(self) -> int:
        return int(np.prod(self.shape)) if self.slices else 1

    def intersect(self, other: "Tile") -> Optional["Tile"]:
        out = []
        for (a1, b1), (a2, b2) in zip(self.slices, other.slices):
            lo, hi = max(a1, a2), min(b1, b2)
            if lo >= hi:
                return None
            out.append((lo, hi))
        return Tile(tuple(out))

    def offset_in(self, outer: "Tile") -> Tuple[Slice, ...]:
        """This tile's index range relative to ``outer``'s origin."""
        return tuple((a - oa, b - oa)
                     for (a, b), (oa, _) in zip(self.slices, outer.slices))


@dataclasses.dataclass(frozen=True)
class MeshSharding:
    """A Spec on a logical mesh: ``mesh_shape`` and, per row-major mesh
    position, the global id of its device (the ids of a pipeline's virtual
    mesh, so that two stage meshes never share one)."""
    spec: Spec
    mesh_shape: Tuple[int, ...]
    device_ids: Tuple[int, ...]


@dataclasses.dataclass
class TileSlice:
    """A piece of a source shard headed to one destination shard."""
    tile: Tile
    src_shard_index: int
    offset_in_src: Tuple[Slice, ...]


class VirtualDistributedArray:
    """A sharding seen as tiles: ``device_tiles[p]``, the block of the
    global array that mesh position ``p`` holds (equal blocks where a dim
    is replicated)."""

    def __init__(self, shape: Sequence[int], device_tiles: List[Tile],
                 device_ids: Sequence[int]):
        self.shape = tuple(shape)
        self.device_tiles = device_tiles
        self.device_ids = list(device_ids)

    @classmethod
    def from_sharding(cls, shape, sharding: MeshSharding
                      ) -> "VirtualDistributedArray":
        mesh_shape = tuple(sharding.mesh_shape)
        tiles = []
        for p in range(int(np.prod(mesh_shape))):
            coords = tuple(int(c) for c in np.unravel_index(p, mesh_shape))
            tiles.append(Tile(tuple(
                (off, off + n) for off, n in local_slices(
                    tuple(shape), sharding.spec, coords, mesh_shape))))
        return cls(shape, tiles, sharding.device_ids)

    @property
    def unique_tiles(self) -> Dict[Tuple[Slice, ...], List[int]]:
        """Each distinct block -> the positions that hold it."""
        out: Dict[Tuple[Slice, ...], List[int]] = {}
        for i, t in enumerate(self.device_tiles):
            out.setdefault(t.slices, []).append(i)
        return out


@dataclasses.dataclass
class DstTileRequest:
    """One destination shard and the pieces that cover it."""
    dst_shard_index: int
    dst_tile: Tile
    srcs: List[TileSlice]


@dataclasses.dataclass
class ReshardingTaskSpec:
    """The plan of one (array, source sharding, destination sharding)
    (``alpa_tpu/pipeline_parallel/cross_mesh_resharding.py:130``).

    ``transfer_bytes``: every planned piece; ``allgather_rewrite``: the
    requests fetch each replicated destination block once, split over its
    replica group; ``broadcast_bytes``: each unique fetched piece of a
    replica group once.  ``max_link_bytes``: the busiest device's egress
    or ingress under this plan (``_broadcast`` under broadcast routing),
    ``_naive`` the same with first-holder selection and routing;
    ``send_order``: the greedy least-loaded-egress order of the
    ``(request, piece)`` moves (empty: plan order).  ``strategy`` and its
    ``strategy_costs`` / ``strategy_stats`` / ``wire_*``: the collective
    strategy chosen for the edge (``choose_strategy``)."""
    shape: Tuple[int, ...]
    requests: List[DstTileRequest]
    transfer_bytes: float = 0.0
    allgather_rewrite: bool = False
    src_device_ids: Tuple[int, ...] = ()
    dst_device_ids: Tuple[int, ...] = ()
    src_tiles: Tuple[Tile, ...] = ()
    dst_tiles: Tuple[Tile, ...] = ()
    itemsize: int = 1
    broadcast_bytes: float = 0.0
    max_link_bytes: float = 0.0
    max_link_bytes_naive: float = 0.0
    max_link_bytes_broadcast: float = 0.0
    max_link_bytes_broadcast_naive: float = 0.0
    send_order: Tuple[Tuple[int, int], ...] = ()
    loadbalanced: bool = True
    strategy: str = "direct_p2p"
    strategy_costs: Dict[str, float] = dataclasses.field(
        default_factory=dict)
    strategy_stats: Dict[str, Dict[str, float]] = dataclasses.field(
        default_factory=dict)
    wire_messages: int = 1
    wire_bytes: float = 0.0
    strategy_cached: bool = False

    def total_tiles(self) -> int:
        return sum(len(r.srcs) for r in self.requests)


def _cover_tile(dst_tile: Tile, src_vda: VirtualDistributedArray,
                load: Dict[int, float], itemsize: int,
                balance: bool = True) -> List[TileSlice]:
    """The pieces of the source shards covering ``dst_tile``: of each
    distinct source block that intersects it, the holder least loaded so
    far (``balance``), else the first holder (the naive baseline)."""
    pieces: List[TileSlice] = []
    for tile_slices, holders in src_vda.unique_tiles.items():
        src_tile = Tile(tile_slices)
        inter = dst_tile.intersect(src_tile)
        if inter is None:
            continue
        best = min(holders, key=lambda i: load.get(i, 0.0)) if balance \
            else holders[0]
        load[best] = load.get(best, 0.0) + inter.size * itemsize
        pieces.append(TileSlice(inter, best, inter.offset_in(src_tile)))
    return pieces


def _build_requests(src_vda: VirtualDistributedArray,
                    dst_vda: VirtualDistributedArray, itemsize: int,
                    allgather_rewrite: bool = False, balance: bool = True
                    ) -> Tuple[List[DstTileRequest], float]:
    """One request per destination shard, or under ``allgather_rewrite``
    one per replica-group member, each fetching a disjoint 1/k of the
    group's block split along its largest dim that k divides (the first
    member fetching it whole when none does); and the bytes of all
    pieces."""
    load: Dict[int, float] = {}
    requests, total = [], 0.0
    if not allgather_rewrite:
        for i, dst_tile in enumerate(dst_vda.device_tiles):
            srcs = _cover_tile(dst_tile, src_vda, load, itemsize, balance)
            requests.append(DstTileRequest(i, dst_tile, srcs))
            total += sum(s.tile.size for s in srcs) * itemsize
        return requests, total
    for tile_slices, holders in dst_vda.unique_tiles.items():
        dst_tile = Tile(tile_slices)
        k = len(holders)
        dims = dst_tile.shape
        split_dim = next((int(d) for d in np.argsort(dims)[::-1]
                          if dims[d] % k == 0 and dims[d] >= k), None)
        for gi, holder in enumerate(holders):
            if split_dim is None and gi > 0:
                continue
            part = dst_tile
            if split_dim is not None:
                a, b = dst_tile.slices[split_dim]
                step = (b - a) // k
                sl = list(dst_tile.slices)
                sl[split_dim] = (a + gi * step, a + (gi + 1) * step)
                part = Tile(tuple(sl))
            srcs = _cover_tile(part, src_vda, load, itemsize, balance)
            requests.append(DstTileRequest(holder, part, srcs))
            total += sum(s.tile.size for s in srcs) * itemsize
    return requests, total


########################################
# link loads, broadcast routing, send order
########################################


def route_broadcast(spec: ReshardingTaskSpec, loadbalance: bool = True
                    ) -> Dict[Tuple, int]:
    """Each unique fetched piece of each replica group routed to one
    member for broadcast execution: the member with the least ingress so
    far (``loadbalance``), else the group's first holder.  Returns
    ``(group block slices, piece slices) -> destination shard index``."""
    groups = VirtualDistributedArray(spec.shape, list(spec.dst_tiles),
                                     list(spec.dst_device_ids)).unique_tiles
    itemsize = spec.itemsize or 1
    ingress: Dict[int, float] = {}
    routes: Dict[Tuple, int] = {}
    for req in spec.requests:
        gslices = spec.dst_tiles[req.dst_shard_index].slices
        holders = groups[gslices]
        for ts in req.srcs:
            key = (gslices, ts.tile.slices)
            if key in routes:
                continue
            target = min(holders, key=lambda h: (ingress.get(h, 0.0), h)) \
                if loadbalance else holders[0]
            routes[key] = target
            ingress[target] = ingress.get(target, 0.0) + \
                ts.tile.size * itemsize
    return routes


def compute_link_loads(spec: ReshardingTaskSpec, broadcast: bool = False,
                       loadbalance: bool = True) -> Dict[str, Any]:
    """Egress bytes per source device, ingress bytes per destination
    device, their largest (``max_link_bytes``) and the total: of every
    ``(request, piece)`` move, or under ``broadcast`` of each unique piece
    of a replica group once, to the member ``route_broadcast`` picks."""
    itemsize = spec.itemsize or 1
    egress: Dict[int, float] = {}
    ingress: Dict[int, float] = {}
    total = 0.0
    routes = route_broadcast(spec, loadbalance) if broadcast else None
    seen = set()
    for req in spec.requests:
        gslices = spec.dst_tiles[req.dst_shard_index].slices \
            if broadcast else None
        for ts in req.srcs:
            if broadcast:
                key = (gslices, ts.tile.slices)
                if key in seen:
                    continue
                seen.add(key)
                dst_dev = spec.dst_device_ids[routes[key]]
            else:
                dst_dev = spec.dst_device_ids[req.dst_shard_index]
            b = ts.tile.size * itemsize
            src_dev = spec.src_device_ids[ts.src_shard_index]
            egress[src_dev] = egress.get(src_dev, 0.0) + b
            ingress[dst_dev] = ingress.get(dst_dev, 0.0) + b
            total += b
    links = list(egress.values()) + list(ingress.values())
    return {"egress": egress, "ingress": ingress, "total_bytes": total,
            "max_link_bytes": max(links) if links else 0.0}


def plan_send_order(spec: ReshardingTaskSpec) -> Tuple[Tuple[int, int], ...]:
    """The ``(request, piece)`` moves in greedy order: next the pending
    move whose source device has issued the fewest bytes, ties in plan
    order."""
    itemsize = spec.itemsize or 1
    pending = [(ri, si) for ri, req in enumerate(spec.requests)
               for si in range(len(req.srcs))]
    issued: Dict[int, float] = {}
    order: List[Tuple[int, int]] = []

    def device(p):
        return spec.src_device_ids[
            spec.requests[p[0]].srcs[p[1]].src_shard_index]

    while pending:
        best = min(pending, key=lambda p: (issued.get(device(p), 0.0), p))
        pending.remove(best)
        ts = spec.requests[best[0]].srcs[best[1]]
        issued[device(best)] = issued.get(device(best), 0.0) + \
            ts.tile.size * itemsize
        order.append(best)
    return tuple(order)


# the planner's counters, as the JAX module keeps them in the registry
_PLANNER_REG = _tmetrics.get_registry()
_PLANS = _PLANNER_REG.counter(
    "alpa_resharding_plans_total", "Resharding plans computed")
_PLAN_BYTES = _PLANNER_REG.counter(
    "alpa_resharding_planned_bytes_total",
    "Planned cross-mesh payload bytes (send_recv accounting)")
_PLAN_BCAST_BYTES = _PLANNER_REG.counter(
    "alpa_resharding_planned_broadcast_bytes_total",
    "Planned cross-mesh payload bytes under broadcast routing")
_PLAN_MAX_LINK = _PLANNER_REG.gauge(
    "alpa_resharding_max_link_bytes",
    "Max per-device link bytes over all plans, balanced routing")
_PLAN_MAX_LINK_NAIVE = _PLANNER_REG.gauge(
    "alpa_resharding_max_link_bytes_naive",
    "Max per-device link bytes over all plans, naive routing")
_STRATEGY_COUNT = _PLANNER_REG.counter(
    "alpa_reshard_strategy_total",
    "Cross-mesh resharding edges planned, per chosen strategy",
    labelnames=("kind",))


def _record_plan(spec: ReshardingTaskSpec):
    _PLANS.inc()
    _PLAN_BYTES.inc(spec.transfer_bytes)
    _PLAN_BCAST_BYTES.inc(spec.broadcast_bytes)
    _PLAN_MAX_LINK.set_max(max(spec.max_link_bytes,
                               spec.max_link_bytes_broadcast))
    _PLAN_MAX_LINK_NAIVE.set_max(max(spec.max_link_bytes_naive,
                                     spec.max_link_bytes_broadcast_naive))


def get_planner_stats() -> Dict[str, float]:
    """The planner's counters since the last reset: plans made, planned
    and broadcast bytes, the largest max-link objective balanced and
    naive (a view over the registry's ``alpa_resharding_*``)."""
    return {
        "plans": int(_PLANS.value),
        "total_bytes": _PLAN_BYTES.value,
        "broadcast_bytes": _PLAN_BCAST_BYTES.value,
        "max_link_bytes": _PLAN_MAX_LINK.value,
        "max_link_bytes_naive": _PLAN_MAX_LINK_NAIVE.value,
    }


def reset_planner_stats():
    for fam in (_PLANS, _PLAN_BYTES, _PLAN_BCAST_BYTES, _PLAN_MAX_LINK,
                _PLAN_MAX_LINK_NAIVE):
        fam.reset()


def _plan(shape, itemsize, src_sharding: MeshSharding,
          dst_sharding: MeshSharding, allow_allgather_rewrite: bool,
          loadbalance: bool) -> ReshardingTaskSpec:
    """The tile plan, its link loads and send order, without a strategy."""
    src_vda = VirtualDistributedArray.from_sharding(shape, src_sharding)
    dst_vda = VirtualDistributedArray.from_sharding(shape, dst_sharding)
    dst_unique = dst_vda.unique_tiles
    replication = max(len(v) for v in dst_unique.values()) \
        if dst_unique else 1
    rewrite = allow_allgather_rewrite and replication > 1
    requests, total = _build_requests(src_vda, dst_vda, itemsize, rewrite,
                                      loadbalance)
    spec = ReshardingTaskSpec(
        tuple(shape), requests, total, rewrite,
        src_device_ids=tuple(src_vda.device_ids),
        dst_device_ids=tuple(dst_vda.device_ids),
        src_tiles=tuple(src_vda.device_tiles),
        dst_tiles=tuple(dst_vda.device_tiles), itemsize=itemsize,
        loadbalanced=bool(loadbalance))
    spec.max_link_bytes = compute_link_loads(spec)["max_link_bytes"]
    bloads = compute_link_loads(spec, broadcast=True,
                                loadbalance=loadbalance)
    spec.broadcast_bytes = bloads["total_bytes"]
    spec.max_link_bytes_broadcast = bloads["max_link_bytes"]
    if loadbalance:
        nreq, _ = _build_requests(src_vda, dst_vda, itemsize, rewrite,
                                  balance=False)
        nspec = dataclasses.replace(spec, requests=nreq)
        spec.max_link_bytes_naive = compute_link_loads(
            nspec)["max_link_bytes"]
        spec.max_link_bytes_broadcast_naive = compute_link_loads(
            nspec, broadcast=True, loadbalance=False)["max_link_bytes"]
        spec.send_order = plan_send_order(spec)
    else:
        spec.max_link_bytes_naive = spec.max_link_bytes
        spec.max_link_bytes_broadcast_naive = spec.max_link_bytes_broadcast
    return spec


def plan_resharding(shape: Sequence[int], itemsize: int,
                    src_sharding: MeshSharding, dst_sharding: MeshSharding,
                    allow_allgather_rewrite: bool = True,
                    loadbalance: Optional[bool] = None,
                    logical_mesh=None) -> ReshardingTaskSpec:
    """The tile plan of one value (``alpa_tpu/pipeline_parallel/
    cross_mesh_resharding.py:435``): the local all-gather rewrite where
    the destination replicates a block, balanced source selection,
    broadcast routing and send order unless ``loadbalance`` is off
    (default: ``global_config.resharding_loadbalance_mode``), both
    max-link objectives, and the edge's collective strategy
    (``resolve_strategy``; ``logical_mesh``, the destination's, prices
    its intra-mesh leg)."""
    from alpa_tpu_torch.global_env import global_config
    if loadbalance is None:
        loadbalance = global_config.resharding_loadbalance_mode != \
            "no_loadbalance"
    spec = _plan(shape, itemsize, src_sharding, dst_sharding,
                 allow_allgather_rewrite, loadbalance)
    strat, costs, cached = resolve_strategy(shape, itemsize, src_sharding,
                                            dst_sharding, logical_mesh)
    opts = collective_options(shape, itemsize, src_sharding, dst_sharding)
    spec.strategy = strat if strat in opts else "direct_p2p"
    spec.strategy_costs = costs
    spec.strategy_stats = {k: dict(o["stats"]) for k, o in opts.items()}
    st = opts[spec.strategy]["stats"]
    spec.wire_messages = int(st["max_link_messages"])
    spec.wire_bytes = float(st["total_bytes"])
    spec.strategy_cached = bool(cached)
    _STRATEGY_COUNT.labels(spec.strategy).inc()
    _RECENT_PLANS.append({
        "shape": tuple(shape), "itemsize": int(itemsize),
        "src": _sharding_key(src_sharding),
        "dst": _sharding_key(dst_sharding), "strategy": spec.strategy,
        "costs": dict(costs), "cached": bool(cached),
        "wire_messages": spec.wire_messages, "wire_bytes": spec.wire_bytes,
        "transfer_bytes": spec.transfer_bytes,
        "max_link_bytes": spec.max_link_bytes})
    _record_plan(spec)
    return spec


def naive_transfer_bytes(shape: Sequence[int], itemsize: int,
                         dst_sharding: MeshSharding,
                         mode: str = "send_recv") -> float:
    """Bytes of the naive plan: every destination shard receives its whole
    block (``"send_recv"``: a replicated destination pays once per
    replica), or each unique destination block crosses once
    (``"broadcast"``)."""
    vda = VirtualDistributedArray.from_sharding(shape, dst_sharding)
    if mode == "broadcast":
        return float(sum(Tile(sl).size for sl in vda.unique_tiles)) * \
            itemsize
    if mode != "send_recv":
        raise ValueError(f"unknown naive_transfer_bytes mode: {mode}")
    return float(sum(t.size for t in vda.device_tiles)) * itemsize


########################################
# collective strategies
########################################

#: An edge's lowering: ``direct_p2p`` moves the tile plan straight to the
#: destination layout; ``slice_all_gather`` (a destination replicated over
#: an axis) lands a disjoint 1/k slice on each destination device and
#: all-gathers inside the destination mesh; ``all_to_all`` lands the
#: source's layout 1:1 on the destination mesh and re-lays it there;
#: ``reduce_scatter_gather`` (a replicated source) pulls disjoint pieces
#: from distinct source replicas, then gathers inside the destination mesh.
RESHARD_STRATEGIES = ("direct_p2p", "slice_all_gather", "all_to_all",
                      "reduce_scatter_gather")

#: the intra-mesh collective of each strategy's second leg
_STRATEGY_COLLECTIVE_KIND = {
    "direct_p2p": None,
    "slice_all_gather": "all_gather",
    "all_to_all": "all_to_all",
    "reduce_scatter_gather": "reduce_scatter",
}


def _sharding_key(sharding: MeshSharding) -> str:
    """A device-free form of a sharding (reports): mesh shape and spec."""
    return f"{tuple(sharding.mesh_shape)}|{tuple(sharding.spec)}"


def _spec_entries(sharding: MeshSharding, ndim: int) -> Optional[Tuple]:
    """The spec as one mesh axis or None per dim; None where a dim is
    sharded over several axes (the strategies below skip such edges)."""
    entries = tuple(sharding.spec) + ((),) * (ndim - len(sharding.spec))
    if any(len(e) > 1 for e in entries):
        return None
    return tuple(e[0] if e else None for e in entries)


def _with_entries(sharding: MeshSharding, entries) -> MeshSharding:
    return MeshSharding(tuple((e,) if e is not None else ()
                              for e in entries),
                        tuple(sharding.mesh_shape), sharding.device_ids)


def _replication(sharding: MeshSharding, shape) -> int:
    uniq = VirtualDistributedArray.from_sharding(shape, sharding).unique_tiles
    return max(len(v) for v in uniq.values()) if uniq else 1


def _scatter_sharding(dst_sharding: MeshSharding, shape
                      ) -> Optional[MeshSharding]:
    """The 1/k landing layout: the destination spec with each unused mesh
    axis put on the largest whole dim it divides (the lowest on ties)."""
    entries = _spec_entries(dst_sharding, len(shape))
    if entries is None:
        return None
    entries = list(entries)
    used = {e for e in entries if e is not None}
    changed = False
    for ax, k in enumerate(dst_sharding.mesh_shape):
        if ax in used or k <= 1:
            continue
        cands = [(shape[d], d) for d, e in enumerate(entries)
                 if e is None and shape[d] % k == 0 and shape[d] >= k]
        if not cands:
            continue
        best = max(sz for sz, _ in cands)
        entries[min(d for sz, d in cands if sz == best)] = ax
        changed = True
    return _with_entries(dst_sharding, entries) if changed else None


def _translate_spec(src_sharding: MeshSharding, dst_sharding: MeshSharding,
                    shape) -> Optional[MeshSharding]:
    """The source layout on the destination mesh (the all-to-all landing
    layout), or None where an axis it uses differs in size there."""
    entries = _spec_entries(src_sharding, len(shape))
    if entries is None:
        return None
    src_sizes, dst_sizes = src_sharding.mesh_shape, dst_sharding.mesh_shape
    for e in entries:
        if e is not None and (e >= len(dst_sizes) or
                              dst_sizes[e] != src_sizes[e]):
            return None
    return _with_entries(dst_sharding, entries)


def _strategy_link_stats(shape, itemsize, src_sharding: MeshSharding,
                         landing: MeshSharding) -> Dict[str, float]:
    """The wire leg when each landing shard pulls its block from
    load-balanced source holders: the busiest link's messages and bytes,
    and the total bytes."""
    src_vda = VirtualDistributedArray.from_sharding(shape, src_sharding)
    land_vda = VirtualDistributedArray.from_sharding(shape, landing)
    load: Dict[int, float] = {}
    eg_m: Dict[int, int] = {}
    in_m: Dict[int, int] = {}
    eg_b: Dict[int, float] = {}
    in_b: Dict[int, float] = {}
    total = 0.0
    for i, dtile in enumerate(land_vda.device_tiles):
        ddev = land_vda.device_ids[i]
        for ts in _cover_tile(dtile, src_vda, load, itemsize, True):
            b = ts.tile.size * itemsize
            sdev = src_vda.device_ids[ts.src_shard_index]
            eg_m[sdev] = eg_m.get(sdev, 0) + 1
            in_m[ddev] = in_m.get(ddev, 0) + 1
            eg_b[sdev] = eg_b.get(sdev, 0.0) + b
            in_b[ddev] = in_b.get(ddev, 0.0) + b
            total += b
    msgs = list(eg_m.values()) + list(in_m.values())
    byts = list(eg_b.values()) + list(in_b.values())
    return {"max_link_messages": int(max(msgs)) if msgs else 0,
            "max_link_bytes": float(max(byts)) if byts else 0.0,
            "total_bytes": float(total)}


def collective_options(shape, itemsize, src_sharding: MeshSharding,
                       dst_sharding: MeshSharding
                       ) -> Dict[str, Dict[str, Any]]:
    """The eligible strategies of one edge in tie-break order: name ->
    {"landing": the wire leg's layout, "kind": the intra-mesh collective
    (None for direct), "stats": the wire leg's link stats}.
    ``direct_p2p`` is always eligible."""
    opts: Dict[str, Dict[str, Any]] = {}

    def add(name, landing):
        opts[name] = {"landing": landing,
                      "kind": _STRATEGY_COLLECTIVE_KIND[name],
                      "stats": _strategy_link_stats(shape, itemsize,
                                                    src_sharding, landing)}

    add("direct_p2p", dst_sharding)
    src_repl = _replication(src_sharding, shape)
    dst_repl = _replication(dst_sharding, shape)
    dst_entries = _spec_entries(dst_sharding, len(shape))
    scattered = _scatter_sharding(dst_sharding, shape) \
        if dst_entries is not None else None
    if src_repl > 1 and scattered is not None:
        add("reduce_scatter_gather", scattered)
    if dst_repl > 1 and scattered is not None:
        add("slice_all_gather", scattered)
    if src_repl == 1 and dst_repl == 1:
        translated = _translate_spec(src_sharding, dst_sharding, shape)
        if (translated is not None and dst_entries is not None and
                _spec_entries(translated, len(shape)) != dst_entries):
            add("all_to_all", translated)
    return opts


def _relayout_axes(landing: MeshSharding, dst: MeshSharding
                   ) -> List[Tuple[int, int]]:
    """``(mesh axis, dim)`` of each axis the landing layout shards a dim
    on where the destination does not: the intra-mesh leg gathers them."""
    out = []
    for d, (a, b) in enumerate(zip(landing.spec, dst.spec)):
        if tuple(a) != tuple(b):
            out.extend((ax, d) for ax in a)
    return out


def _intra_cost(kind: str, nbytes: float, landing: MeshSharding,
                dst: MeshSharding, logical_mesh) -> float:
    """The intra-mesh leg's price on the destination's logical mesh: its
    alpha-beta cost of ``kind`` along each axis the leg runs over."""
    cost = getattr(logical_mesh, f"{kind}_cost")
    return sum(cost(nbytes, ax) for ax, _ in _relayout_axes(landing, dst))


def _strategy_cost(stats: Dict[str, float], kind: Optional[str],
                   lat: float, bw: float, model: str,
                   intra: float = 0.0) -> float:
    """An edge's estimated seconds: the wire leg as the active wire model
    charges it (``"link"``: latency per message of the busiest link;
    ``"call"``: one latency), plus bytes over ``bw`` where it is set, plus
    the intra-mesh leg's price ``intra``."""
    cross = lat * stats["max_link_messages"] if model == "link" else lat
    if bw:
        cross += stats["max_link_bytes"] / bw
    return cross + (intra if kind is not None else 0.0)


def choose_strategy(shape, itemsize, src_sharding: MeshSharding,
                    dst_sharding: MeshSharding, logical_mesh=None
                    ) -> Tuple[str, Dict[str, float],
                               Dict[str, Dict[str, Any]]]:
    """The cheapest eligible strategy of one edge
    (``alpa_tpu/pipeline_parallel/cross_mesh_resharding.py:770``), or the
    one ``global_config.reshard_strategy`` forces where it is eligible
    (else ``direct_p2p``).  The intra-mesh leg is priced by the
    destination's ``logical_mesh`` (``LogicalDeviceMesh``'s alpha-beta
    costs), at 0 without one.  Returns (strategy, cost per candidate,
    candidates)."""
    from alpa_tpu_torch.global_env import global_config
    opts = collective_options(shape, itemsize, src_sharding, dst_sharding)
    lat = global_config.resharding_transfer_latency_s
    bw = global_config.resharding_wire_bandwidth
    model = global_config.resharding_wire_model
    nbytes = float(np.prod(shape, dtype=np.int64)) * itemsize \
        if len(shape) else float(itemsize)
    costs = {}
    for name, o in opts.items():
        intra = 0.0
        if o["kind"] is not None and logical_mesh is not None:
            intra = _intra_cost(o["kind"], nbytes, o["landing"],
                                dst_sharding, logical_mesh)
        costs[name] = _strategy_cost(o["stats"], o["kind"], lat, bw, model,
                                     intra)
    forced = global_config.reshard_strategy
    if forced != "auto":
        if forced not in RESHARD_STRATEGIES:
            raise ValueError(f"reshard_strategy must be 'auto' or one of "
                             f"{RESHARD_STRATEGIES}, got {forced!r}")
        chosen = forced if forced in opts else "direct_p2p"
    else:
        order = list(opts)
        chosen = min(order, key=lambda n: (costs[n], order.index(n)))
    return chosen, costs, opts


def resolve_strategy(shape, itemsize, src_sharding: MeshSharding,
                     dst_sharding: MeshSharding, logical_mesh=None
                     ) -> Tuple[str, Dict[str, float], bool]:
    """``choose_strategy``'s decision as ``(strategy, costs, cached)``,
    replayed from the compile cache (namespace ``reshard_strategy``) where
    it holds it.  The key covers the edge (shape, itemsize, both
    shardings), the destination's logical mesh shape and every knob the
    cost model reads, and the calibration token when replanning is on."""
    from alpa_tpu_torch.compile_cache import cache_enabled, get_compile_cache
    from alpa_tpu_torch.global_env import global_config
    from alpa_tpu_torch.telemetry.calibration import calibration_cache_token
    tok = calibration_cache_token()
    parts = (tuple(shape), int(itemsize),
             _sharding_key(src_sharding), _sharding_key(dst_sharding),
             tuple(logical_mesh.shape) if logical_mesh is not None else None,
             global_config.reshard_strategy,
             global_config.resharding_wire_model,
             global_config.resharding_transfer_latency_s,
             global_config.resharding_wire_bandwidth) + \
        ((tok,) if tok else ())
    cache = get_compile_cache() if cache_enabled() else None
    key = cache.make_key("reshard_strategy", parts) if cache else None
    if cache is not None:
        hit = cache.get("reshard_strategy", key)
        if isinstance(hit, dict) and hit.get("strategy") in \
                RESHARD_STRATEGIES:
            return hit["strategy"], dict(hit.get("costs", {})), True
    chosen, costs, _ = choose_strategy(shape, itemsize, src_sharding,
                                       dst_sharding, logical_mesh)
    if cache is not None:
        cache.put("reshard_strategy", key,
                  {"strategy": chosen, "costs": costs})
    return chosen, costs, False


#: the most recent per-edge strategy decisions (``format_resharding_plan``)
_RECENT_PLANS: deque = deque(maxlen=128)


def strategy_plan_fingerprint() -> str:
    """A hash of the recorded per-edge decisions, in order: two runs that
    planned the same edges to the same strategies match."""
    h = hashlib.sha256()
    for p in _RECENT_PLANS:
        h.update(f"{p['shape']}|{p['itemsize']}|{p['src']}|{p['dst']}|"
                 f"{p['strategy']}".encode())
    return h.hexdigest()


def reset_recent_plans():
    _RECENT_PLANS.clear()


def format_resharding_plan() -> str:
    """The recent per-edge strategy decisions, one block per edge."""
    if not _RECENT_PLANS:
        return "resharding plan: (no cross-mesh edges planned yet)"
    lines = [f"resharding plan ({len(_RECENT_PLANS)} most recent edges; "
             "strategy chosen by the collective cost model):"]
    for p in _RECENT_PLANS:
        costs = " ".join(f"{k}={v * 1e3:.3f}ms"
                         for k, v in sorted(p["costs"].items()))
        lines.append(
            f"  {p['shape']} x{p['itemsize']}B {p['src']} -> {p['dst']}")
        lines.append(
            f"    strategy={p['strategy']}"
            f"{' (cached)' if p['cached'] else ''} "
            f"wire_msgs={p['wire_messages']} "
            f"wire_bytes={p['wire_bytes']:.0f} "
            f"planned_bytes={p['transfer_bytes']:.0f} "
            f"max_link={p['max_link_bytes']:.0f}")
        if costs:
            lines.append(f"    est: {costs}")
    return "\n".join(lines)


########################################
# execution
########################################


def _index(slices: Sequence[Slice]):
    return tuple(slice(a, b) for a, b in slices)


@dataclasses.dataclass
class ExecutionReport:
    """What one transfer moved, in payload bytes: ``cross_mesh_bytes`` of
    the pieces sent from the source mesh to the destination mesh (a
    quantized edge: its wire bytes), ``intra_mesh_bytes`` of the pieces
    the destination mesh passed among its devices (the rewrite's
    all-gather, broadcast's fan-out, a strategy's second leg),
    ``n_tiles`` the pieces sent and ``max_link_bytes`` the busiest
    device's egress or ingress in the cross-mesh leg.  ``moved`` counts
    the bytes that left one physical device for another (none on one
    card named several times)."""
    mode: str = "device_put"
    cross_mesh_bytes: float = 0.0
    intra_mesh_bytes: float = 0.0
    n_tiles: int = 0
    max_link_bytes: float = 0.0
    moved: int = 0


class ReshardingTask:
    """A planned resharding executed on shards: ``task(src shards) ->
    (dst shards, bytes moved between distinct devices)``, the devices of
    the meshes by position.  Modes (``alpa_tpu/pipeline_parallel/
    cross_mesh_resharding.py:1277``):

    * ``"device_put"``, the default: each destination shard is assembled
      from the pieces of the source shards that intersect it (a plan made
      with ``allow_allgather_rewrite=False``; a rewritten plan runs in the
      other modes);
    * ``"tiled"``: the plan as it is, in its send order; under the
      rewrite each replica-group member receives its 1/k part and the
      group all-gathers the parts (``collectives.all_gather``);
    * ``"broadcast"``: each unique piece of a replica group crosses once,
      to the member ``route_broadcast`` picks, which broadcasts it to the
      group (``collectives.broadcast``).

    A piece moves with ``non_blocking`` only into a card (a copy into
    host memory must be done before the host reads it).  A destination
    shard that one piece covers whole, on its own device, is that piece
    (no byte moves).  ``last_report`` is the last call's
    ``ExecutionReport``."""

    def __init__(self, plan: ReshardingTaskSpec,
                 src_devices: Sequence[torch.device],
                 dst_devices: Sequence[torch.device],
                 mode: str = "device_put"):
        self.plan = plan
        self.src_devices = [torch.device(d) for d in src_devices]
        self.dst_devices = [torch.device(d) for d in dst_devices]
        self.mode = self._checked(mode)
        self.last_report: Optional[ExecutionReport] = None

    def _checked(self, mode: str) -> str:
        if mode not in ("device_put", "tiled", "broadcast"):
            raise ValueError(f"unknown resharding execution mode: {mode}")
        if mode == "device_put" and self.plan.allgather_rewrite:
            raise ValueError(
                "a plan with the all-gather rewrite gives each replica only "
                "its part: run it in 'tiled' or 'broadcast' mode, or plan "
                "with allow_allgather_rewrite=False for 'device_put'")
        return mode

    def __call__(self, src_shards: Sequence[torch.Tensor],
                 mode: Optional[str] = None
                 ) -> Tuple[List[torch.Tensor], int]:
        mode = self._checked(mode) if mode else self.mode
        if mode != "device_put":
            # where the JAX package's executable runs the task (its "planned"
            # execution); its "device_put" edges never reach it
            _fault.fire("cross_mesh_recv", mode=mode,
                        n_requests=len(self.plan.requests))
        if mode == "device_put" or not self.plan.requests:
            report = ExecutionReport(mode="device_put")
            out = self._run_direct(src_shards, report)
        else:
            report = ExecutionReport(mode=mode)
            out = self._run_planned(src_shards, mode == "broadcast", report)
        self.last_report = report
        return out, report.moved

    def _send(self, src_shards, ts: TileSlice, device: torch.device,
              report: ExecutionReport, egress, ingress, dst_id: int):
        """One planned piece from its source shard to ``device``."""
        src = src_shards[ts.src_shard_index]
        piece = src if ts.tile.shape == tuple(src.shape) else \
            src[_index(ts.offset_in_src)]
        nbytes = piece.numel() * piece.element_size()
        report.cross_mesh_bytes += nbytes
        report.n_tiles += 1
        src_id = self.plan.src_device_ids[ts.src_shard_index]
        egress[src_id] = egress.get(src_id, 0.0) + nbytes
        ingress[dst_id] = ingress.get(dst_id, 0.0) + nbytes
        return self._to(piece, device, report)

    @staticmethod
    def _to(x: torch.Tensor, device: torch.device,
            report: ExecutionReport) -> torch.Tensor:
        if x.device == device:
            return x
        report.moved += x.numel() * x.element_size()
        return x.to(device, non_blocking=device.type == "cuda")

    @staticmethod
    def _assemble(tile: Tile, pieces, device, dtype) -> torch.Tensor:
        """``tile`` on ``device`` from ``(piece tile, tensor)`` pairs that
        cover it; the one piece itself where it is the whole tile."""
        if len(pieces) == 1 and pieces[0][0] == tile:
            return pieces[0][1]
        out = torch.empty(tile.shape, dtype=dtype, device=device)
        for t, piece in pieces:
            out[_index(t.offset_in(tile))].copy_(piece)
        return out

    def _run_direct(self, src_shards, report: ExecutionReport):
        egress, ingress, out = {}, {}, []
        dtype = src_shards[0].dtype
        for req in self.plan.requests:
            device = self.dst_devices[req.dst_shard_index]
            dst_id = self.plan.dst_device_ids[req.dst_shard_index]
            pieces = [(ts.tile, self._send(src_shards, ts, device, report,
                                           egress, ingress, dst_id))
                      for ts in req.srcs]
            out.append(self._assemble(req.dst_tile, pieces, device, dtype))
        report.max_link_bytes = max(list(egress.values()) +
                                    list(ingress.values()), default=0.0)
        return out

    def _run_planned(self, src_shards, broadcast: bool,
                     report: ExecutionReport):
        from alpa_tpu_torch.shard_parallel import collectives
        plan = self.plan
        dtype = src_shards[0].dtype
        groups = VirtualDistributedArray(plan.shape, list(plan.dst_tiles),
                                         list(plan.dst_device_ids)
                                         ).unique_tiles
        routes = route_broadcast(plan, plan.loadbalanced) \
            if broadcast else None
        # 1) the cross-mesh leg, in the planner's send order
        landed: Dict[int, List[Tuple[Tile, torch.Tensor]]] = {}
        seen, egress, ingress = set(), {}, {}
        order = plan.send_order or tuple(
            (ri, si) for ri, req in enumerate(plan.requests)
            for si in range(len(req.srcs)))
        for ri, si in order:
            req = plan.requests[ri]
            ts = req.srcs[si]
            target = req.dst_shard_index
            if broadcast:
                key = (plan.dst_tiles[target].slices, ts.tile.slices)
                if key in seen:
                    continue
                seen.add(key)
                target = routes[key]
            piece = self._send(src_shards, ts, self.dst_devices[target],
                               report, egress, ingress,
                               plan.dst_device_ids[target])
            landed.setdefault(target, []).append((ts.tile, piece))
        report.max_link_bytes = max(list(egress.values()) +
                                    list(ingress.values()), default=0.0)
        # 2) the intra-mesh leg: each replica group completes its block
        out: List[Optional[torch.Tensor]] = [None] * len(plan.dst_tiles)
        for slices, holders in groups.items():
            full = Tile(slices)
            devs = [self.dst_devices[h] for h in holders]
            if len(holders) == 1 or not (plan.allgather_rewrite or
                                         broadcast):
                for h in holders:
                    out[h] = self._assemble(full, landed.get(h, []),
                                            self.dst_devices[h], dtype)
                continue
            if broadcast:
                pieces: Dict[Tuple, List[torch.Tensor]] = {}
                for gi, h in enumerate(holders):
                    for t, buf in landed.get(h, []):
                        pieces[t.slices] = self._broadcast(
                            collectives, buf, gi, devs, report)
                for gi, h in enumerate(holders):
                    out[h] = self._assemble(
                        full, [(Tile(t), c[gi]) for t, c in pieces.items()],
                        devs[gi], dtype)
                continue
            parts = [(req.dst_tile, req.dst_shard_index)
                     for req in plan.requests
                     if req.dst_shard_index in holders]
            split = [d for d, ab in enumerate(full.slices)
                     if parts[0][0].slices[d] != ab]
            if len(parts) != len(holders) or len(split) != 1:
                # no dim splits k ways: the first member fetched the block
                whole = self._assemble(full, landed.get(holders[0], []),
                                       devs[0], dtype)
                for h, c in zip(holders, self._broadcast(
                        collectives, whole, 0, devs, report)):
                    out[h] = c
                continue
            ordered = sorted(parts, key=lambda p: p[0].slices[split[0]])
            mine = [self._assemble(t, landed.get(h, []),
                                   self.dst_devices[h], dtype)
                    for t, h in ordered]
            odevs = [self.dst_devices[h] for _, h in ordered]
            gathered = collectives.all_gather(mine, odevs, split[0])
            for i, x in enumerate(mine):
                nbytes = x.numel() * x.element_size()
                report.intra_mesh_bytes += (len(mine) - 1) * nbytes
                report.moved += nbytes * sum(d != odevs[i] for d in odevs)
            for (_, h), g in zip(ordered, gathered):
                out[h] = g
        return out

    @staticmethod
    def _broadcast(collectives, x, root, devices, report):
        """``x`` (on ``devices[root]``) on every device of the group."""
        nbytes = x.numel() * x.element_size()
        report.intra_mesh_bytes += (len(devices) - 1) * nbytes
        report.moved += nbytes * sum(d != devices[root] for d in devices)
        return collectives.broadcast(x, root, devices)


class DirectTransfer:
    """One RESHARD edge lowered straight to its tile plan: a
    ``ReshardingTask`` in ``"device_put"`` mode.  ``wire``: the planner's
    busiest-link ``(messages, bytes)`` of the edge."""

    strategy = "direct_p2p"

    def __init__(self, plan: ReshardingTaskSpec, src_devices, dst_devices):
        self.plan = plan
        self.task = ReshardingTask(plan, src_devices, dst_devices)
        self.wire = (plan.wire_messages,
                     plan.strategy_stats.get("direct_p2p", {}).get(
                         "max_link_bytes", plan.max_link_bytes))
        self.nbytes = int(np.prod(plan.shape, dtype=np.int64)) * \
            plan.itemsize

    @property
    def last_report(self) -> Optional[ExecutionReport]:
        return self.task.last_report

    def __call__(self, src_shards):
        if _ttrace.enabled():
            # the edge's bytes and host time, on the calling thread's track
            with _ttrace.get_recorder().span(
                    "reshard.edge", "resharding",
                    {"bytes": self.nbytes, "strategy": self.strategy}):
                return self.task(src_shards)
        return self.task(src_shards)


class CollectiveTransfer:
    """One RESHARD edge lowered to two legs (``alpa_tpu/pipeline_parallel/
    cross_mesh_resharding.py:1126``): the wire leg moves the tile plan to
    the strategy's landing layout on the destination mesh, so that only
    the strategy's bytes cross meshes; the intra-mesh leg all-gathers,
    over the destination's logical mesh (``collectives``: NCCL between
    distinct cards, plain tensor ops on one card or the host), every axis
    the landing layout shards where the destination does not, then each
    device keeps its destination block.  Both legs move data only, so
    every strategy equals ``direct_p2p`` bit for bit."""

    def __init__(self, plan: ReshardingTaskSpec, src_sharding: MeshSharding,
                 dst_sharding: MeshSharding, strategy: str,
                 landing: MeshSharding, src_devices, dst_devices,
                 dst_logical_mesh):
        self.plan = plan
        self.strategy = strategy
        self.landing = landing
        self.dst_sharding = dst_sharding
        self.mesh = dst_logical_mesh
        self.dst_devices = [torch.device(d) for d in dst_devices]
        shape, itemsize = plan.shape, plan.itemsize
        self.wire_plan = _plan(shape, itemsize, src_sharding, landing,
                               False, plan.loadbalanced)
        self.task = ReshardingTask(self.wire_plan, src_devices, dst_devices)
        st = plan.strategy_stats.get(strategy, {})
        self.wire = (st.get("max_link_messages", 1),
                     st.get("max_link_bytes", 0.0))
        self.nbytes = int(np.prod(shape, dtype=np.int64)) * itemsize
        self.last_report: Optional[ExecutionReport] = None

    def __call__(self, src_shards):
        if _ttrace.enabled():
            with _ttrace.get_recorder().span(
                    "reshard.edge", "resharding",
                    {"bytes": self.nbytes, "strategy": self.strategy}):
                return self._transfer(src_shards)
        return self._transfer(src_shards)

    def _transfer(self, src_shards):
        from alpa_tpu_torch.shard_parallel import collectives
        shards, _ = self.task(src_shards)
        report = dataclasses.replace(self.task.last_report,
                                     mode=self.strategy)
        spec = [tuple(a) for a in self.landing.spec]
        mesh_shape = tuple(self.landing.mesh_shape)
        for ax, dim in _relayout_axes(self.landing, self.dst_sharding):
            record = collectives.CollectiveRecord(
                "all_gather", ax, tuple(shards[0].shape), shards[0].dtype,
                0, collectives.axis_backend(self.mesh, ax), dim=dim)
            n = mesh_shape[ax]
            report.intra_mesh_bytes += sum(
                (n - 1) * x.numel() * x.element_size() for x in shards)
            if collectives.axis_backend(self.mesh, ax) == "nccl":
                report.moved += sum((n - 1) * x.numel() * x.element_size()
                                    for x in shards)
            shards = collectives.run_collective(record, shards, self.mesh)
            spec[dim] = tuple(a for a in spec[dim] if a != ax)
        cur = MeshSharding(tuple(spec), mesh_shape, self.landing.device_ids)
        have = VirtualDistributedArray.from_sharding(self.plan.shape, cur)
        want = VirtualDistributedArray.from_sharding(self.plan.shape,
                                                     self.dst_sharding)
        out = []
        for x, h, w in zip(shards, have.device_tiles, want.device_tiles):
            out.append(x if h == w else
                       x[_index(w.offset_in(h))].contiguous())
        self.last_report = report
        return out, report.moved


def make_transfer(plan: ReshardingTaskSpec, src_sharding: MeshSharding,
                  dst_sharding: MeshSharding, src_devices, dst_devices,
                  dtype: torch.dtype, cross: bool = False,
                  weight: bool = False, dst_logical_mesh=None):
    """The executor of one RESHARD edge (``alpa_tpu/pipeline_parallel/
    cross_mesh_resharding.py:1187``): a relayout on one mesh
    (``cross=False``) stays direct; a cross-mesh edge takes the activation
    codec where ``global_config.reshard_quantize`` is on and the edge is
    eligible, never for a ``weight`` (a microbatch-invariant value: a
    parameter, optimizer state, an accumulator); else the plan's
    strategy (``CollectiveTransfer``, which needs the destination's
    logical mesh), else ``DirectTransfer`` (which runs ``plan`` as it is:
    a plan without the all-gather rewrite)."""
    if not cross:
        return DirectTransfer(plan, src_devices, dst_devices)
    from alpa_tpu_torch.global_env import global_config
    mode = global_config.reshard_quantize
    if mode != "off" and not weight:
        from alpa_tpu_torch.pipeline_parallel import reshard_codec
        qt = reshard_codec.maybe_quantized_transfer(
            plan, dtype, src_sharding, dst_sharding, src_devices,
            dst_devices, mode)
        if qt is not None:
            return qt
    if plan.strategy != "direct_p2p" and dst_logical_mesh is not None:
        opts = collective_options(plan.shape, plan.itemsize, src_sharding,
                                  dst_sharding)
        return CollectiveTransfer(plan, src_sharding, dst_sharding,
                                  plan.strategy,
                                  opts[plan.strategy]["landing"],
                                  src_devices, dst_devices, dst_logical_mesh)
    return DirectTransfer(plan, src_devices, dst_devices)


def make_ingest_transfer(shape: Sequence[int], dtype: torch.dtype,
                         dst_sharding: MeshSharding, dst_devices):
    """The executor landing a value that lives in no mesh (a host tensor
    from another process) on ``dst_sharding``: a ``DirectTransfer`` from
    one source shard holding the whole value, on its own device."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    src = MeshSharding(tuple(() for _ in shape), (1,), (-1,))
    plan = _plan(tuple(shape), itemsize, src, dst_sharding, False, True)
    t = DirectTransfer(plan, ["cpu"], dst_devices)
    t.wire = (1, float(t.nbytes))
    return t


def as_shards(x) -> List[torch.Tensor]:
    """A value's shards: a ``DistributedArray``'s, or a plain tensor (a
    one-device mesh's value) as one shard."""
    return x.shards if isinstance(x, DistributedArray) else [x]
