"""Collectives along one logical-mesh axis, over per-device tensors.

The SPMD executor (``spmd_partition.py``) drives every device of a mesh
from one process, as the JAX package's single controller does, so a
collective takes the list of the group's local tensors and returns the
list of results, one per device:

* ``all_reduce`` (sum, max or min), ``all_gather`` and ``reduce_scatter``
  along a tensor dim, ``all_to_all`` (split one dim, concatenate
  another), and ``broadcast`` of one device's tensor (cross-mesh
  resharding's fan-out inside a destination mesh).
* Where a group's devices are distinct CUDA cards the collective is
  NCCL's, through ``torch.cuda.nccl`` (one call over the group's
  tensors); ``all_to_all`` is an all-gather followed by each device's
  slice.  On the CPU, and where a group names one card more than once
  (NCCL refuses a duplicated GPU), it is plain tensor ops: a sum or a
  ``cat`` over the list.  The choice follows from the devices
  (``backend_of``) and stands in each collective's record; it is not a
  fallback, and an NCCL call that fails raises.  NCCL calls are
  serialised by a process-wide lock (``_NCCL_LOCK``).

Each result is a tensor of its own on its operand's device, never a view
of another device's, so that a device's later in-place writes touch only
its own values, and contiguous on both backends, so that an op reading
it gets the same layout whichever backend made it.
"""
import dataclasses
import threading
from typing import List, Optional, Sequence, Tuple

import torch

# ncclRedOp_t
_NCCL_OPS = {"sum": 0, "max": 2, "min": 3}
#: one NCCL collective at a time in the process: a call launches on every
#: device of its group, and two threads calling at once over the same
#: cards (threaded dispatch with two stage meshes on one pair of cards)
#: would interleave their launches differently on each card and hang
_NCCL_LOCK = threading.Lock()


@dataclasses.dataclass
class CollectiveRecord:
    """One collective of a partitioned program: ``kind`` along logical
    mesh ``axis``; ``dim`` the gathered or scattered dim (all-to-all: the
    split dim, with ``concat_dim``); ``op`` the reduction.  ``shape`` and
    ``dtype`` are one device's operand; ``nbytes`` the bytes of the value
    one device contributes or receives in full (all-reduce: its operand;
    all-gather: the gathered result; reduce-scatter: its operand;
    all-to-all: the group's operands it gathers, n x its operand, as it
    is composed from an all-gather, where a true all-to-all would move
    its operand once).  ``backend``: "nccl", "plain" or, where the axis's
    groups differ, "mixed"."""
    kind: str
    axis: int
    shape: Tuple[int, ...]
    dtype: torch.dtype
    nbytes: int
    backend: str
    dim: Optional[int] = None
    concat_dim: Optional[int] = None
    op: str = "sum"


def backend_of(devices: Sequence[torch.device]) -> str:
    """"nccl" where every device is a distinct CUDA card, else "plain"."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices):
        idx = [torch.device("cuda", d.index or 0).index for d in devices]
        if len(set(idx)) == len(idx):
            return "nccl"
    return "plain"


def _moved(x: torch.Tensor, dim: int) -> torch.Tensor:
    return x.movedim(dim, 0).contiguous()


def _handed_back(out: torch.Tensor, dim: int) -> torch.Tensor:
    """An NCCL result gathered or scattered along dim 0, with ``dim`` moved
    back, in the contiguous layout the plain path's ``cat``/``chunk``
    gives.  Some aten kernels read an input as contiguous whatever its
    strides (``native_layer_norm_backward`` its saved mean and rstd), so
    a moved view of equal values gave other results (ROADMAP C.4)."""
    return out.movedim(0, dim).contiguous()


def all_reduce(xs: Sequence[torch.Tensor], devices, op: str = "sum"
               ) -> List[torch.Tensor]:
    if backend_of(devices) == "nccl":
        import torch.cuda.nccl as nccl
        ins = [x.contiguous() for x in xs]
        outs = [torch.empty_like(x) for x in ins]
        with _NCCL_LOCK:
            nccl.all_reduce(ins, outs, op=_NCCL_OPS[op])
        return outs
    total = _plain_reduce(xs, op)
    return [total] + [total.to(x.device, copy=True) for x in xs[1:]]


def _plain_reduce(xs: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """The reduction of ``xs``, on the first one's device."""
    home = xs[0].device
    total = xs[0].clone()
    for x in xs[1:]:
        x = x.to(home)
        if op == "sum":
            total += x
        elif op == "max":
            total = torch.maximum(total, x)
        else:
            total = torch.minimum(total, x)
    return total


def all_gather(xs: Sequence[torch.Tensor], devices, dim: int
               ) -> List[torch.Tensor]:
    n = len(xs)
    if backend_of(devices) == "nccl":
        import torch.cuda.nccl as nccl
        ins = [_moved(x, dim) for x in xs]
        outs = [x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
                for x in ins]
        with _NCCL_LOCK:
            nccl.all_gather(ins, outs)
        return [_handed_back(o, dim) for o in outs]
    home = xs[0].device
    full = torch.cat([x.to(home) for x in xs], dim)
    return [full] + [full.to(x.device, copy=True) for x in xs[1:]]


def reduce_scatter(xs: Sequence[torch.Tensor], devices, dim: int,
                   op: str = "sum") -> List[torch.Tensor]:
    n = len(xs)
    if backend_of(devices) == "nccl":
        import torch.cuda.nccl as nccl
        ins = [_moved(x, dim) for x in xs]
        outs = [x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
                for x in ins]
        with _NCCL_LOCK:
            nccl.reduce_scatter(ins, outs, op=_NCCL_OPS[op])
        return [_handed_back(o, dim) for o in outs]
    total = _plain_reduce(xs, op)
    return [c.to(x.device, copy=True).contiguous()
            for c, x in zip(total.chunk(n, dim), xs)]


def broadcast(x: torch.Tensor, root: int, devices) -> List[torch.Tensor]:
    """``x`` (on ``devices[root]``) on every device of the group: the
    root's result is ``x`` itself, every other a tensor of its own."""
    if backend_of(devices) == "nccl" and len(devices) > 1:
        import torch.cuda.nccl as nccl
        x = x.contiguous()
        bufs = [x if i == root else torch.empty_like(x, device=d)
                for i, d in enumerate(devices)]
        with _NCCL_LOCK:
            nccl.broadcast(bufs, root=root)
        return bufs
    return [x if i == root else x.to(d, copy=True)
            for i, d in enumerate(devices)]


def all_to_all(xs: Sequence[torch.Tensor], devices, split_dim: int,
               concat_dim: int) -> List[torch.Tensor]:
    """Device i's result: the i-th block along ``split_dim`` of every
    device's tensor, concatenated along ``concat_dim`` in group order."""
    n = len(xs)
    gathered = all_gather([x.unsqueeze(0) for x in xs], devices, 0)
    outs = []
    for i, g in enumerate(gathered):
        parts = [g[j].chunk(n, split_dim)[i] for j in range(n)]
        outs.append(torch.cat(parts, concat_dim))
    return outs


def run_collective(record: CollectiveRecord, values: Sequence[torch.Tensor],
                   logical_mesh) -> List[torch.Tensor]:
    """``record`` over ``values`` (one per row-major mesh position), group
    by group along its axis; the results in the same order."""
    devices = logical_mesh.flat_devices()
    out: List[Optional[torch.Tensor]] = [None] * len(values)
    for group in logical_mesh.axis_groups(record.axis):
        xs = [values[p] for p in group]
        devs = [devices[p] for p in group]
        if record.kind == "all_reduce":
            ys = all_reduce(xs, devs, record.op)
        elif record.kind == "all_gather":
            ys = all_gather(xs, devs, record.dim)
        elif record.kind == "reduce_scatter":
            ys = reduce_scatter(xs, devs, record.dim, record.op)
        else:
            ys = all_to_all(xs, devs, record.dim, record.concat_dim)
        for p, y in zip(group, ys):
            out[p] = y
    return out


def axis_backend(logical_mesh, axis: int) -> str:
    """The backend of ``axis``'s groups: "nccl", "plain" or "mixed"."""
    devices = logical_mesh.flat_devices()
    kinds = {backend_of([devices[p] for p in g])
             for g in logical_mesh.axis_groups(axis)}
    return kinds.pop() if len(kinds) == 1 else "mixed"
