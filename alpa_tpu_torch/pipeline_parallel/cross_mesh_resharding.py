"""Cross-mesh resharding: the tile planner and its executor.

Counterpart of ``alpa_tpu/pipeline_parallel/cross_mesh_resharding.py``
(``Tile``, ``VirtualDistributedArray``, ``_cover_tile``,
``_build_requests``, ``plan_resharding``, ``naive_transfer_bytes``, and
the planned executor of ``ReshardingTask``).  A value produced under one
Spec on one stage mesh and read under another Spec on another mesh (or on
the same mesh, a relayout) moves as tiles: each destination shard is
covered by the pieces of the source shards that intersect it, a piece
replicated on several source devices taken from the least loaded one.
``transfer_bytes`` counts every piece that a destination shard receives;
``naive_transfer_bytes`` every destination shard's whole need.

The executor copies each planned piece, a slice of a source shard, to its
destination device (``non_blocking`` between distinct cards, which PyTorch
orders after the work queued on both devices' current streams and before
the work queued after it) and assembles each destination shard from the
pieces that cover it.  A destination shard that one piece covers whole,
on the card that holds it, is handed over as that source shard or a view
of it: no byte moves.  A value on a mesh of one device is a plain tensor
(its plan one piece, the whole tensor); on a wider mesh it is a
``DistributedArray``.

Out of this module, as in ROADMAP A.5.7: the local all-gather rewrite of
a replicated destination (JAX's ``allgather_rewrite``), broadcast routing
(``route_broadcast``), the collective strategies (``collective_options``,
``choose_strategy``) and ``reshard_codec.py``.  ``plan_resharding`` here
equals JAX's with ``allow_allgather_rewrite=False``.
"""
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from alpa_tpu_torch.device_mesh import DistributedArray
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
    """The plan of one (array, source sharding, destination sharding):
    ``transfer_bytes`` over every piece; ``max_link_bytes`` the busiest
    device's egress or ingress under the plan's choice of sources."""
    shape: Tuple[int, ...]
    requests: List[DstTileRequest]
    transfer_bytes: float = 0.0
    src_device_ids: Tuple[int, ...] = ()
    dst_device_ids: Tuple[int, ...] = ()
    itemsize: int = 1
    max_link_bytes: float = 0.0


def _cover_tile(dst_tile: Tile, src_vda: VirtualDistributedArray,
                load: Dict[int, float], itemsize: int) -> List[TileSlice]:
    """The pieces of the source shards covering ``dst_tile``: of each
    distinct source block that intersects it, the holder least loaded so
    far."""
    pieces: List[TileSlice] = []
    for tile_slices, holders in src_vda.unique_tiles.items():
        src_tile = Tile(tile_slices)
        inter = dst_tile.intersect(src_tile)
        if inter is None:
            continue
        best = min(holders, key=lambda i: load.get(i, 0.0))
        load[best] = load.get(best, 0.0) + inter.size * itemsize
        pieces.append(TileSlice(inter, best, inter.offset_in(src_tile)))
    return pieces


def _build_requests(src_vda: VirtualDistributedArray,
                    dst_vda: VirtualDistributedArray, itemsize: int
                    ) -> Tuple[List[DstTileRequest], float]:
    """One request per destination shard, and the bytes of all pieces."""
    load: Dict[int, float] = {}
    requests, total = [], 0.0
    for i, dst_tile in enumerate(dst_vda.device_tiles):
        srcs = _cover_tile(dst_tile, src_vda, load, itemsize)
        requests.append(DstTileRequest(i, dst_tile, srcs))
        total += sum(s.tile.size for s in srcs) * itemsize
    return requests, total


def max_link_bytes(spec: ReshardingTaskSpec) -> float:
    """The busiest device's egress or ingress bytes under the plan (the
    planner's max-link objective)."""
    egress: Dict[int, float] = {}
    ingress: Dict[int, float] = {}
    for req in spec.requests:
        dst_dev = spec.dst_device_ids[req.dst_shard_index]
        for ts in req.srcs:
            b = ts.tile.size * spec.itemsize
            src_dev = spec.src_device_ids[ts.src_shard_index]
            egress[src_dev] = egress.get(src_dev, 0.0) + b
            ingress[dst_dev] = ingress.get(dst_dev, 0.0) + b
    return max(list(egress.values()) + list(ingress.values()), default=0.0)


def plan_resharding(shape: Sequence[int], itemsize: int,
                    src_sharding: MeshSharding, dst_sharding: MeshSharding
                    ) -> ReshardingTaskSpec:
    """The tile plan of one value (``alpa_tpu/pipeline_parallel/
    cross_mesh_resharding.py:435`` without the all-gather rewrite)."""
    src_vda = VirtualDistributedArray.from_sharding(shape, src_sharding)
    dst_vda = VirtualDistributedArray.from_sharding(shape, dst_sharding)
    requests, total = _build_requests(src_vda, dst_vda, itemsize)
    spec = ReshardingTaskSpec(
        tuple(shape), requests, total,
        src_device_ids=tuple(src_vda.device_ids),
        dst_device_ids=tuple(dst_vda.device_ids), itemsize=itemsize)
    spec.max_link_bytes = max_link_bytes(spec)
    return spec


def naive_transfer_bytes(shape: Sequence[int], itemsize: int,
                         dst_sharding: MeshSharding) -> float:
    """Bytes of the naive plan: every destination shard receives its whole
    block (a replicated destination pays once per replica)."""
    vda = VirtualDistributedArray.from_sharding(shape, dst_sharding)
    return float(sum(t.size for t in vda.device_tiles)) * itemsize


def _index(slices: Sequence[Slice]):
    return tuple(slice(a, b) for a, b in slices)


class ReshardingTask:
    """A planned resharding, executed on shards: ``(src shards) -> (dst
    shards, bytes moved between distinct devices)``.  ``src_devices`` and
    ``dst_devices`` are the meshes' devices by position."""

    def __init__(self, plan: ReshardingTaskSpec,
                 src_devices: Sequence[torch.device],
                 dst_devices: Sequence[torch.device]):
        self.plan = plan
        self.src_devices = [torch.device(d) for d in src_devices]
        self.dst_devices = [torch.device(d) for d in dst_devices]

    def __call__(self, src_shards: Sequence[torch.Tensor]
                 ) -> Tuple[List[torch.Tensor], int]:
        plan, moved, out = self.plan, 0, []
        for req in plan.requests:
            device = self.dst_devices[req.dst_shard_index]
            pieces = []
            for ts in req.srcs:
                src = src_shards[ts.src_shard_index]
                piece = src if ts.tile.shape == tuple(src.shape) else \
                    src[_index(ts.offset_in_src)]
                if piece.device != device:
                    moved += piece.numel() * piece.element_size()
                    # asynchronous only into a card: a copy into host
                    # memory must be done before the host reads it
                    piece = piece.to(device,
                                     non_blocking=device.type == "cuda")
                pieces.append((ts, piece))
            if len(pieces) == 1 and pieces[0][0].tile == req.dst_tile:
                out.append(pieces[0][1])
                continue
            first = src_shards[req.srcs[0].src_shard_index]
            shard = torch.empty(req.dst_tile.shape, dtype=first.dtype,
                                device=device)
            for ts, piece in pieces:
                shard[_index(ts.tile.offset_in(req.dst_tile))].copy_(piece)
            out.append(shard)
        return out, moved


def as_shards(x) -> List[torch.Tensor]:
    """A value's shards: a ``DistributedArray``'s, or a plain tensor (a
    one-device mesh's value) as one shard."""
    return x.shards if isinstance(x, DistributedArray) else [x]
