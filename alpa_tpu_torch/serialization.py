"""Distributed checkpointing (the port of ``alpa_tpu/serialization.py``).

Per-leaf directories holding one file per saved shard and an index, in
the JAX package's layout, so each package reads the other's directories:

  ckpt_dir/
    metadata.json                      # step, leaf shapes and dtypes
    <leaf-path>/shard_p0_<k>.npy       # one file per distinct shard
    <leaf-path>/index_p0.json          # shard file -> global slice

A leaf path joins the state's keys with ``.``, as flax's state dict
names them: a ``TrainState`` is ``step``, ``params`` and ``opt_state``, a
dict its keys, a tuple or list its indices, so a port state's leaves are
``params.wte.weight``, ``opt_state.0.mu.wte.weight`` and so on.  Leaves
are ``torch.Tensor``s, ``DistributedArray``s, numpy arrays and Python
scalars; a ``DistributedArray`` writes one file per distinct block with
the global slice its spec gives that block (the positions that repeat a
block, its replicas, are skipped as JAX skips ``replica_id != 0``).  bf16
is written as its raw bytes under the dtype name ``"bfloat16"``, with
the ``.npy`` header ``ml_dtypes`` gives it (``'<V2'``).

``restore_checkpoint`` reads into the structure of a target: each leaf
placed as the target's is (a ``DistributedArray`` reads only its own
blocks' slices), or as ``shardings`` says.  An optional node-local cache
directory (``global_config.checkpoint_cache_dir`` or ``local_cache_dir``)
is drained to the target directory by background threads.
"""
import dataclasses
import json
import logging
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from alpa_tpu_torch.device_mesh import DistributedArray
from alpa_tpu_torch.global_env import global_config

logger = logging.getLogger(__name__)

_SEP = "."
_BF16 = "bfloat16"


class CheckpointCorruptError(RuntimeError):
    """The checkpoint directory is incomplete or inconsistent (missing
    shard files, truncated index, metadata/shard mismatch).  Raised by
    validation up front, with the offending leaf named."""


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where a restored leaf goes: ``spec`` over ``logical_mesh`` (a
    ``LogicalDeviceMesh``), as a ``DistributedArray``'s blocks."""
    spec: Tuple
    logical_mesh: Any


# ---- the state dict ------------------------------------------------------


def _leaf_dirname(path_parts) -> str:
    return _SEP.join(str(p) for p in path_parts) or "_root"


def _is_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, DistributedArray, np.ndarray,
                          np.generic, int, float, bool, ShardLayout))


def is_tensor_leaf(x) -> bool:
    return isinstance(x, (torch.Tensor, DistributedArray))


def to_state_dict(target) -> Any:
    """flax's ``to_state_dict`` for the port's trees: dataclasses (a
    ``TrainState``: its ``step``, ``params`` and ``opt_state``) and
    namedtuples by field, dicts by key, lists and tuples by index; leaves
    as they are."""
    if _is_leaf(target) or target is None:
        return target
    if hasattr(target, "_fields"):
        return {k: to_state_dict(getattr(target, k)) for k in target._fields}
    if dataclasses.is_dataclass(target):
        from alpa_tpu_torch.model.model_util import TrainState
        keys = (("step", "params", "opt_state")
                if isinstance(target, TrainState) else
                [f.name for f in dataclasses.fields(target)])
        return {k: to_state_dict(getattr(target, k)) for k in keys}
    if isinstance(target, dict):
        return {str(k): to_state_dict(v) for k, v in target.items()}
    if isinstance(target, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(target)}
    return target


def from_state_dict(target, sd) -> Any:
    """``target``'s structure with the leaves of ``sd`` (a state dict of
    the same shape), as flax's ``from_state_dict``."""
    if _is_leaf(target) or target is None:
        return sd
    if hasattr(target, "_fields"):
        return type(target)(*[from_state_dict(getattr(target, k), sd[k])
                              for k in target._fields])
    if dataclasses.is_dataclass(target):
        keys = to_state_dict(target).keys()
        return dataclasses.replace(target, **{
            k: from_state_dict(getattr(target, k), sd[k]) for k in keys})
    if isinstance(target, dict):
        return type(target)((k, from_state_dict(v, sd[str(k)]))
                            for k, v in target.items())
    if isinstance(target, (list, tuple)):
        return type(target)(from_state_dict(v, sd[str(i)])
                            for i, v in enumerate(target))
    return target


def _flatten_state_dict(sd, prefix=()):
    out = {}
    if isinstance(sd, dict):
        for k, v in sd.items():
            out.update(_flatten_state_dict(v, prefix + (k,)))
    elif sd is not None:
        out[prefix] = sd
    return out


def flat_leaves(target) -> Dict[str, Tuple[Tuple[str, ...], Any]]:
    """``{leaf name: (state-dict path, leaf)}`` in the tree's order."""
    flat = _flatten_state_dict(to_state_dict(target))
    return {_leaf_dirname(path): (path, leaf) for path, leaf in flat.items()}


def rebuild(target, new_flat: Dict[Tuple[str, ...], Any]) -> Any:
    """``target``'s structure with the leaf at each state-dict path
    replaced by ``new_flat[path]`` (paths not in it keep their leaf)."""
    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        return new_flat.get(path, node)
    return from_state_dict(target, walk((), to_state_dict(target)))


# ---- leaves <-> bytes ----------------------------------------------------


def dtype_name(dtype) -> str:
    """The JAX package's dtype name of a torch or numpy dtype."""
    if isinstance(dtype, torch.dtype):
        return _BF16 if dtype == torch.bfloat16 else \
            str(dtype).replace("torch.", "")
    return str(np.dtype(dtype))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy of a tensor's values on the host (bf16 as its raw
    ``uint16`` bits); a copy also of a host tensor, since a train step
    writes its state in place."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).to("cpu", copy=True).numpy().view(
            np.uint16)
    return t.to("cpu", copy=True).numpy()


def _contiguous(arr) -> np.ndarray:
    """``arr`` in C order and writable, a 0-d array kept 0-d
    (``ascontiguousarray`` makes it 1-d)."""
    arr = np.asarray(arr)
    if not arr.flags["C_CONTIGUOUS"]:
        return np.ascontiguousarray(arr)
    # a chunk read back is a read-only view of its bytes
    return arr if arr.flags["WRITEABLE"] else arr.copy()


def from_numpy(arr: np.ndarray, name: str, device=None) -> torch.Tensor:
    """The tensor of dtype ``name`` (a JAX dtype name) whose values (for
    ``"bfloat16"``: raw bits) ``arr`` holds, on ``device``."""
    arr = _contiguous(arr)
    if name == _BF16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device) if device is not None else t


def _slice_of(shape, spec, logical_mesh, p) -> Tuple[Tuple[int, int], ...]:
    from alpa_tpu_torch.shard_parallel.sharding_spec import local_slices
    return tuple((off, off + size) for off, size in local_slices(
        shape, spec, logical_mesh.coords(p), logical_mesh.shape))


def leaf_pieces(leaf) -> Tuple[List[int], str, List[Tuple[Tuple, Any]]]:
    """``(shape, dtype name, [(global slice, host ndarray), ...])`` of a
    leaf: one piece per distinct block of a ``DistributedArray`` (the
    first position holding it), else one piece.  The device-to-host
    copies happen here."""
    if isinstance(leaf, DistributedArray):
        pieces, seen = [], set()
        for p, shard in enumerate(leaf.shards):
            index = _slice_of(leaf.shape, leaf.spec, leaf.logical_mesh, p) \
                if leaf.shape else ()
            if index in seen:
                continue
            seen.add(index)
            pieces.append((index, to_numpy(shard)))
        return list(leaf.shape), dtype_name(leaf.dtype), pieces
    if isinstance(leaf, torch.Tensor):
        arr = to_numpy(leaf)
        name = dtype_name(leaf.dtype)
    else:
        arr = np.asarray(leaf)
        name = dtype_name(arr.dtype)
    index = tuple((0, d) for d in arr.shape) if arr.ndim else ()
    return list(arr.shape), name, [(index, arr)]


def place_leaf(like, read_slice, shape, name, layout=None) -> Any:
    """A restored leaf placed as ``like`` (the target's leaf) is, or as
    ``layout`` (a ``ShardLayout``, or a ``DistributedArray`` whose layout
    to take): ``read_slice(index)`` reads one global slice as a host
    array.  A ``DistributedArray`` reads its own blocks' slices only."""
    full = tuple((0, d) for d in shape) if shape else ()
    if layout is None:
        layout = like
    if isinstance(layout, (ShardLayout, DistributedArray)):
        spec, mesh = tuple(layout.spec), layout.logical_mesh
        shards = []
        for p, device in enumerate(mesh.flat_devices()):
            index = _slice_of(tuple(shape), spec, mesh, p) if shape else ()
            shards.append(from_numpy(read_slice(index), name, device))
        return DistributedArray(shards, spec, mesh, tuple(shape),
                                shards[0].dtype)
    if isinstance(layout, torch.Tensor):
        return from_numpy(read_slice(full), name, layout.device)
    arr = read_slice(full)
    if isinstance(like, (bool, int, float)) and arr.ndim == 0:
        return type(like)(arr.item())
    return arr


def leaf_indices(leaf, shape) -> List[Tuple[Tuple[int, int], ...]]:
    """The global slices a restore of ``leaf`` reads: each block's of a
    ``DistributedArray``, else the whole leaf."""
    if isinstance(leaf, DistributedArray):
        return [_slice_of(leaf.shape, leaf.spec, leaf.logical_mesh, p)
                if leaf.shape else () for p in range(len(leaf.shards))]
    return [tuple((0, d) for d in shape) if shape else ()]


def copy_leaf_(dst, read_slice, shape, name) -> None:
    """Write a restored leaf into ``dst`` (a tensor or a
    ``DistributedArray``) in place, block by block, keeping every
    address (CUDA graphs replay on them)."""
    if isinstance(dst, DistributedArray):
        for p, shard in enumerate(dst.shards):
            index = _slice_of(dst.shape, dst.spec, dst.logical_mesh, p) \
                if dst.shape else ()
            with torch.no_grad():
                shard.copy_(from_numpy(read_slice(index), name))
        return
    full = tuple((0, d) for d in shape) if shape else ()
    with torch.no_grad():
        dst.copy_(from_numpy(read_slice(full), name))


# ---- the per-leaf directory format ---------------------------------------


def _save_npy(path: str, arr: np.ndarray, name: str):
    """``np.save`` of a leaf's piece; bf16 bits under the header
    ``ml_dtypes`` writes for bfloat16 (``'<V2'``)."""
    arr = _contiguous(arr)
    if name != _BF16:
        np.save(path, arr)
        return
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False,
                "shape": tuple(arr.shape)})
        f.write(arr.tobytes())


def _load_npy(path: str, name: str) -> np.ndarray:
    arr = np.load(path)
    if name == _BF16:
        return arr.view(np.uint16)
    return arr


class _AsyncMover:
    """Background mover from the local cache to the final directory (the
    reference's DaemonMoveWorker).  Failures re-raise from ``wait()``
    (``checkpoint_wait()``), after the failed move's partial destination
    is removed: a half-drained leaf must not pass for a complete one."""

    def __init__(self):
        self.threads: List[threading.Thread] = []
        self._lock = threading.Lock()
        self._errors: List[BaseException] = []

    def submit(self, src: str, dst: str):
        t = threading.Thread(target=self._move_safe, args=(src, dst),
                             daemon=True)
        t.start()
        self.threads.append(t)

    def _move_safe(self, src, dst):
        try:
            self._move(src, dst)
        except BaseException as e:  # pylint: disable=broad-except
            logger.exception("async checkpoint drain %s -> %s failed",
                             src, dst)
            try:
                if os.path.isdir(dst):
                    shutil.rmtree(dst, ignore_errors=True)
                elif os.path.exists(dst):
                    os.unlink(dst)
            except OSError:
                logger.exception("cleanup of partial %s failed", dst)
            with self._lock:
                self._errors.append(e)

    @staticmethod
    def _move(src, dst):
        os.makedirs(os.path.dirname(dst), exist_ok=True)
        if os.path.isdir(src):
            # merge file by file into the leaf directory: a bare move
            # would nest src inside an existing dst
            os.makedirs(dst, exist_ok=True)
            for name in os.listdir(src):
                shutil.move(os.path.join(src, name),
                            os.path.join(dst, name))
            os.rmdir(src)
        else:
            shutil.move(src, dst)

    def wait(self):
        for t in self.threads:
            t.join()
        self.threads = []
        with self._lock:
            errors, self._errors = self._errors, []
        if errors:
            raise CheckpointCorruptError(
                f"{len(errors)} async checkpoint move(s) failed; first: "
                f"{type(errors[0]).__name__}: {errors[0]}") from errors[0]


_mover = _AsyncMover()


def save_checkpoint(ckpt_dir: str, target: Any, step: int,
                    local_cache_dir: Optional[str] = None):
    """Save a tree of (possibly distributed) tensors.  One process writes
    every distinct block.  ``local_cache_dir`` (default
    ``global_config.checkpoint_cache_dir``) writes there first and drains
    to ``ckpt_dir`` in the background (``checkpoint_wait``)."""
    if local_cache_dir is None:
        local_cache_dir = global_config.checkpoint_cache_dir
    write_dir = local_cache_dir or ckpt_dir
    os.makedirs(write_dir, exist_ok=True)
    proc = 0
    metadata = {"step": step, "leaves": {}, "n_processes": 1}
    for name, (_path, leaf) in flat_leaves(target).items():
        leaf_dir = os.path.join(write_dir, name)
        os.makedirs(leaf_dir, exist_ok=True)
        shape, dtype, pieces = leaf_pieces(leaf)
        index = []
        for k, (sl, arr) in enumerate(pieces):
            fname = f"shard_p{proc}_{k}.npy"
            _save_npy(os.path.join(leaf_dir, fname), arr, dtype)
            index.append({"file": fname, "slice": [list(x) for x in sl]})
        with open(os.path.join(leaf_dir, f"index_p{proc}.json"), "w",
                  encoding="utf-8") as f:
            json.dump(index, f)
        metadata["leaves"][name] = {"shape": shape, "dtype": dtype}
    with open(os.path.join(write_dir, "metadata.json"), "w",
              encoding="utf-8") as f:
        json.dump(metadata, f)
    if local_cache_dir:
        os.makedirs(ckpt_dir, exist_ok=True)
        for name in list(metadata["leaves"]) + ["metadata.json"]:
            _mover.submit(os.path.join(write_dir, name),
                          os.path.join(ckpt_dir, name))


def checkpoint_wait():
    """Block until the asynchronous cache drains finish."""
    _mover.wait()


def _read_index(leaf_dir: str, n_processes: Optional[int] = None):
    """Merge the per-process index files; ``n_processes`` (from the
    metadata) bounds which ``index_p<i>.json`` belong to this save."""
    names = sorted(
        f for f in os.listdir(leaf_dir)
        if f.startswith("index") and f.endswith(".json"))
    per_proc = [f for f in names if f.startswith("index_p")]
    if per_proc:
        if n_processes is not None:
            keep = {f"index_p{i}.json" for i in range(n_processes)}
            per_proc = [f for f in per_proc if f in keep]
        names = per_proc
    index = []
    for fname in names:
        with open(os.path.join(leaf_dir, fname), encoding="utf-8") as f:
            index.extend(json.load(f))
    return index


def _slice_reader(leaf_dir: str, shape, name: str,
                  n_processes: Optional[int]):
    """``read(global slice) -> host array`` over a leaf's shard files:
    a saved shard of exactly that slice, else a slice of the full array
    (assembled once)."""
    index = _read_index(leaf_dir, n_processes)
    full = None
    np_dtype = np.dtype(np.uint16) if name == _BF16 else np.dtype(name)

    def read(global_slice):
        nonlocal full
        global_slice = tuple(tuple(x) for x in global_slice)
        for ent in index:
            if tuple(tuple(x) for x in ent["slice"]) == global_slice:
                return _load_npy(os.path.join(leaf_dir, ent["file"]), name)
        if full is None:
            full = np.zeros(shape, np_dtype)
            for ent in index:
                sl = tuple(slice(a, b) for a, b in ent["slice"])
                full[sl] = _load_npy(os.path.join(leaf_dir, ent["file"]),
                                     name)
        return full[tuple(slice(a, b) for a, b in global_slice)]
    return read


def validate_checkpoint(ckpt_dir: str, metadata: Optional[Dict] = None):
    """Cross-check the index files against what is on disk before any
    array is assembled: every leaf directory present, every index
    entry's shard file present and non-empty, slices in bounds, and the
    slices' volume enough to cover the leaf.  Raises
    :class:`CheckpointCorruptError` naming the first offending leaf."""
    if metadata is None:
        metadata = load_checkpoint_metadata(ckpt_dir)
    n_proc = metadata.get("n_processes")
    for name, info in metadata.get("leaves", {}).items():
        leaf_dir = os.path.join(ckpt_dir, name)
        if not os.path.isdir(leaf_dir):
            raise CheckpointCorruptError(
                f"checkpoint {ckpt_dir} is missing leaf directory "
                f"{name!r} (listed in metadata.json): truncated or "
                "partially-drained save")
        index = _read_index(leaf_dir, n_proc)
        if not index:
            raise CheckpointCorruptError(
                f"leaf {name!r} has no usable index entries in "
                f"{leaf_dir}: empty or stale index files")
        shape = tuple(info["shape"])
        total = 1
        for d in shape:
            total *= d
        covered = 0
        for ent in index:
            path = os.path.join(leaf_dir, ent["file"])
            if not os.path.exists(path) or os.path.getsize(path) == 0:
                raise CheckpointCorruptError(
                    f"leaf {name!r}: shard file {ent['file']} is "
                    f"missing or empty in {leaf_dir}: the index refers "
                    "to a shard that never finished writing")
            vol = 1
            for (a, b), dim in zip(ent["slice"], shape):
                if not 0 <= a < b <= dim:
                    raise CheckpointCorruptError(
                        f"leaf {name!r}: shard {ent['file']} covers "
                        f"slice {ent['slice']} outside the leaf shape "
                        f"{list(shape)}: index/metadata mismatch")
                vol *= b - a
            covered += vol
        if covered < total:
            raise CheckpointCorruptError(
                f"leaf {name!r}: shards cover {covered} of {total} "
                f"elements of shape {list(shape)}: missing shard files "
                "(a process's flush never landed)")


def restore_checkpoint(ckpt_dir: str, target: Any,
                       shardings: Optional[Any] = None,
                       in_place: bool = False):
    """Restore into the structure of ``target``.  Each leaf is placed as
    the target's leaf is (a tensor on its device, a ``DistributedArray``
    under its spec and mesh, reading only its blocks), or as the leaf of
    ``shardings`` (a tree matching ``target``) says: a ``ShardLayout``
    or a ``DistributedArray``.  ``in_place`` writes into
    the target's own tensors instead (``copy_``; scalars are replaced).

    The index is validated against the shard files first
    (``validate_checkpoint``): a corrupt or truncated checkpoint raises
    :class:`CheckpointCorruptError` before anything is read."""
    metadata = load_checkpoint_metadata(ckpt_dir)
    validate_checkpoint(ckpt_dir, metadata)
    layouts = {}
    if shardings is not None:
        layouts = {path: lay for _n, (path, lay) in
                   flat_leaves(shardings).items()}
    new_flat = {}
    for name, (path, leaf) in flat_leaves(target).items():
        info = metadata["leaves"].get(name)
        if info is None:
            raise KeyError(f"checkpoint missing leaf {name}")
        shape = tuple(info["shape"])
        read = _slice_reader(os.path.join(ckpt_dir, name), shape,
                             info["dtype"], metadata.get("n_processes"))
        if in_place and isinstance(leaf, (torch.Tensor, DistributedArray)):
            copy_leaf_(leaf, read, shape, info["dtype"])
            new_flat[path] = leaf
        else:
            new_flat[path] = place_leaf(leaf, read, shape, info["dtype"],
                                        layouts.get(path))
    return rebuild(target, new_flat)


def load_checkpoint_metadata(ckpt_dir: str) -> Dict:
    """Read and sanity-check ``metadata.json``: a missing, unparsable or
    structurally wrong file raises :class:`CheckpointCorruptError` with
    the path named."""
    path = os.path.join(ckpt_dir, "metadata.json")
    if not os.path.exists(path):
        raise CheckpointCorruptError(
            f"no metadata.json in {ckpt_dir}: not a checkpoint "
            "directory, or the save died before metadata was written")
    try:
        with open(path, encoding="utf-8") as f:
            metadata = json.load(f)
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CheckpointCorruptError(
            f"metadata.json in {ckpt_dir} is unreadable ({e}): "
            "truncated write") from e
    if not isinstance(metadata, dict) or \
            not isinstance(metadata.get("leaves"), dict):
        raise CheckpointCorruptError(
            f"metadata.json in {ckpt_dir} lacks a 'leaves' table: "
            "not a checkpoint metadata file")
    return metadata
