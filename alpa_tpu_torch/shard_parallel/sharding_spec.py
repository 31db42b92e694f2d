"""Sharding spec algebra for the auto-sharding planner.

Counterpart of ``alpa_tpu/shard_parallel/sharding_spec.py``.  A ``Spec`` is
a tuple over a tensor's dims; each element is the tuple of logical mesh
axes (ints) that dim is sharded over (usually none or one, two for a dim
sharded over both axes of a 2-D mesh).  Replicated: every element empty.

An aval is anything with a ``shape`` and a ``dtype`` (a tensor, a fake
tensor, an ``Aval``); the dtype is a ``torch.dtype`` or a numpy dtype.
The JAX package maps a Spec to a ``PartitionSpec``; the port's plans carry
the Spec tuples themselves.  A device's slice under a Spec is
``NamedSharding``'s tiling: a dim sharded over axes ``(a0, a1)`` is cut
into ``n0 * n1`` equal blocks, block ``c0 * n1 + c1`` on the device at
coordinates ``c`` (the first axis major); ``local_slices`` and
``local_shape`` give a device's block, which the SPMD executor
(``spmd_partition.py``) holds.
"""
from typing import NamedTuple, Sequence, Tuple

import numpy as np

Spec = Tuple[Tuple[int, ...], ...]


class Aval(NamedTuple):
    """A tensor's shape and dtype."""
    shape: Tuple[int, ...]
    dtype: object


def itemsize(dtype) -> int:
    return int(dtype.itemsize)


def nbytes(aval) -> float:
    shape = tuple(aval.shape)
    return (float(np.prod(shape)) if shape else 1.0) * itemsize(aval.dtype)


def replicated_spec(ndim: int) -> Spec:
    return tuple(() for _ in range(ndim))


def is_replicated(spec: Spec) -> bool:
    return all(not axes for axes in spec)


def used_axes(spec: Spec) -> Tuple[int, ...]:
    out = []
    for axes in spec:
        out.extend(axes)
    return tuple(sorted(out))


def make_spec(ndim: int, assignment: dict) -> Spec:
    """assignment: {tensor_dim: mesh_axis or tuple(mesh_axes)}"""
    spec = [() for _ in range(ndim)]
    for d, a in assignment.items():
        spec[d] = (a,) if isinstance(a, int) else tuple(a)
    return tuple(spec)


def num_shards(spec: Spec, mesh_shape: Sequence[int]) -> int:
    n = 1
    for a in used_axes(spec):
        n *= mesh_shape[a]
    return n


def sharded_bytes(aval, spec: Spec, mesh_shape: Sequence[int]) -> float:
    return nbytes(aval) / num_shards(spec, mesh_shape)


def spec_valid(aval, spec: Spec, mesh_shape: Sequence[int]) -> bool:
    """Every sharded dim must be divisible by its axis product."""
    shape = tuple(aval.shape)
    if len(spec) != len(shape):
        return False
    for d, axes in enumerate(spec):
        if not axes:
            continue
        p = int(np.prod([mesh_shape[a] for a in axes]))
        if p > 1 and (shape[d] % p != 0 or shape[d] < p):
            return False
    return True


def enumerate_var_specs(aval, mesh_shape: Sequence[int],
                        max_axes: int = 2) -> Tuple[Spec, ...]:
    """All valid specs for a tensor: replicated, one dim on one axis, and
    two dims on the two axes (or one dim on both axes)."""
    ndim = len(tuple(aval.shape))
    nontrivial = [a for a, s in enumerate(mesh_shape) if s > 1]
    out = [replicated_spec(ndim)]
    for a in nontrivial:
        for d in range(ndim):
            s = make_spec(ndim, {d: a})
            if spec_valid(aval, s, mesh_shape):
                out.append(s)
    if len(nontrivial) >= 2 and max_axes >= 2:
        a0, a1 = nontrivial[0], nontrivial[1]
        for d0 in range(ndim):
            for d1 in range(ndim):
                if d0 == d1:
                    s = make_spec(ndim, {d0: (a0, a1)})
                else:
                    s = make_spec(ndim, {d0: a0, d1: a1})
                if spec_valid(aval, s, mesh_shape):
                    out.append(s)
    return tuple(dict.fromkeys(out))


def resharding_cost(aval, src: Spec, dst: Spec, logical_mesh) -> float:
    """Alpha-beta cost of turning a ``src``-sharded tensor into ``dst``
    (``alpa_tpu/shard_parallel/sharding_spec.py:116``): per mesh axis,
    dropping it pays an all-gather of the whole tensor, moving it to
    another dim pays an all-to-all, and a newly sharded axis is a free
    local slice."""
    if src == dst:
        return 0.0
    size = nbytes(aval)
    cost = 0.0
    src_axis_dim = {a: d for d, axes in enumerate(src) for a in axes}
    dst_axis_dim = {a: d for d, axes in enumerate(dst) for a in axes}
    for a, d in src_axis_dim.items():
        if a not in dst_axis_dim:
            cost += logical_mesh.all_gather_cost(size, a)
        elif dst_axis_dim[a] != d:
            cost += logical_mesh.all_to_all_cost(size, a)
    return cost


def shard_index(axes: Sequence[int], coords: Sequence[int],
                mesh_shape: Sequence[int]) -> int:
    """The block a device at ``coords`` holds of a dim sharded over
    ``axes`` (the first axis major)."""
    k = 0
    for a in axes:
        k = k * mesh_shape[a] + coords[a]
    return k


def local_slices(shape: Sequence[int], spec: Spec, coords: Sequence[int],
                 mesh_shape: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """``(offset, size)`` per dim of the block of a tensor of ``shape``
    that the device at ``coords`` holds under ``spec``."""
    out = []
    for size, axes in zip(shape, spec):
        n = int(np.prod([mesh_shape[a] for a in axes])) if axes else 1
        if size % n:
            raise ValueError(f"dim of size {size} does not split into {n}")
        block = size // n
        out.append((shard_index(axes, coords, mesh_shape) * block, block))
    return tuple(out)


def local_shape(aval, spec: Spec, mesh_shape: Sequence[int]
                ) -> Tuple[int, ...]:
    """The shape of each device's block of ``aval`` under ``spec``."""
    shape = tuple(aval.shape)
    return tuple(size // (int(np.prod([mesh_shape[a] for a in axes]))
                          if axes else 1)
                 for size, axes in zip(shape, spec))
