"""Mesh executables: what ``@parallelize`` runs on one physical mesh.

Counterpart of ``alpa_tpu/mesh_executable.py`` (``MeshExecutable``,
``NormalMeshExecutable``, ``GradAccMeshExecutable``).  On one device a
``NormalMeshExecutable`` holds the function itself and runs it eagerly on
flat, already tree-flattened arguments; there is no compiled program.  A
``GradAccMeshExecutable`` runs the traced compute-grad graph once per
microbatch and the apply-grad graph once (``shard_parallel/grad_acc.py``).
``launch_on_driver`` first puts host values (numpy arrays, tensors on
another device) on the mesh's device, as the JAX version commits host
arrays to their shardings.

On more than one device both run the partitioned program of the step
(``shard_parallel/spmd_partition.SpmdProgram``) over the logical mesh's
devices (``_SpmdExecution``): plain inputs are sharded at entry by their
Specs (``_prepare_args``), a ``DistributedArray`` under its own Spec is
taken as it is, a donated argument no device holds is released once its
blocks are copied, donated state shards are written in place on every
device, each state output comes back as a ``DistributedArray`` under its
input's Spec, and the other outputs (the loss) come back replicated,
from the mesh's first device.  ``get_collective_counts()`` gives each
collective kind's count and bytes per step, the counterpart of
``count_communication_primitives`` over the HLO text.  Each launch's
host time is observed in ``alpa_mesh_dispatch_seconds``.
"""
import functools
import itertools
import time

import numpy as np
import torch

from alpa_tpu_torch.device_mesh import DistributedArray, PhysicalDeviceMesh
from alpa_tpu_torch.shard_parallel.grad_acc import (compress_spmd,
                                                    new_grad_codec,
                                                    quantized_accumulators)
from alpa_tpu_torch.telemetry import metrics as _tmetrics

_exec_uuids = itertools.count(1)

# the host time of one launch of a single-mesh executable
_DISPATCH_SECONDS = _tmetrics.get_registry().histogram(
    "alpa_mesh_dispatch_seconds",
    "launch_on_driver enqueue latency per mesh executable call")


def _timed_launch(launch):
    """``launch_on_driver`` observed in ``alpa_mesh_dispatch_seconds``."""
    @functools.wraps(launch)
    def timed(self, *flat_args):
        t0 = time.perf_counter()
        try:
            return launch(self, *flat_args)
        finally:
            _DISPATCH_SECONDS.observe(time.perf_counter() - t0)
    return timed


class MeshExecutable:
    """Base class."""

    def __init__(self, physical_mesh: PhysicalDeviceMesh):
        self.physical_mesh = physical_mesh
        self.exec_uuid = next(_exec_uuids)

    def launch_on_driver(self, *args):
        raise NotImplementedError

    def __call__(self, *args):
        return self.launch_on_driver(*args)

    def get_total_allocation_size(self) -> int:
        raise NotImplementedError

    def get_plan_fingerprint(self) -> str:
        """A content hash of the executable's parallel plan: the mesh's
        extent, the logical mesh, the inputs' and outputs' avals and
        specs, as ``alpa_tpu/mesh_executable.py:153`` hashes its mesh
        extent, avals and shardings.  ``checkpoint.CheckpointManager``
        checks it on resume."""
        import hashlib
        parts = [repr(tuple(self.physical_mesh.shape))]
        mesh = getattr(self, "logical_mesh", None)
        if mesh is not None:
            parts.append(repr(tuple(mesh.shape)))
        parts.extend(repr(a) for a in getattr(self, "avals", None) or ())
        for name in ("in_specs", "out_specs"):
            parts.extend(repr(s if s is None else tuple(s)) for s in
                         getattr(self, name, None) or ())
        return hashlib.sha256("\n".join(parts).encode()).hexdigest()


class _SpmdExecution:
    """Running a partitioned program over the logical mesh's devices."""

    def _setup_spmd(self, program, avals, donated_invars, out_specs):
        self.program = program
        self.logical_mesh = program.logical_mesh
        self.avals = list(avals)
        self.in_specs = list(program.in_specs)
        self.out_specs = list(out_specs)
        self.donated_invars = list(donated_invars)
        self.devices = program.devices
        self._peak_bytes = -1

    def _shard_args(self, flat_args):
        """Per mesh position, its local value of every flat argument: a
        ``DistributedArray`` under its input's Spec on this mesh as it is,
        anything else committed to each device's block (a copy per
        position where the argument is donated, so that each device's
        in-place write touches its own)."""
        from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import \
            _to_tensor
        from alpa_tpu_torch.shard_parallel.sharding_spec import local_slices
        mesh = self.logical_mesh
        per_pos = [[] for _ in self.devices]
        for i, x in enumerate(flat_args):
            spec = self.in_specs[i]
            if isinstance(x, DistributedArray) and x.spec == spec and \
                    x.logical_mesh.shape == mesh.shape and \
                    x.logical_mesh.flat_devices() == self.devices:
                for p, shard in enumerate(x.shards):
                    per_pos[p].append(shard)
                continue
            if isinstance(x, DistributedArray):
                x = x.gather(self.devices[0])
            full = _to_tensor(x, self.avals[i][1], self.devices[0])
            used = set()
            for p, device in enumerate(self.devices):
                block = full
                for d, (off, size) in enumerate(local_slices(
                        full.shape, spec, mesh.coords(p), mesh.shape)):
                    if size != full.shape[d]:
                        block = block.narrow(d, off, size)
                key = (device, block.data_ptr(), tuple(block.shape))
                if block is full and key not in used and \
                        full.device == device:
                    per_pos[p].append(full)
                elif self.donated_invars[i] or block.device != device:
                    per_pos[p].append(block.to(device, copy=True)
                                      .contiguous())
                else:
                    per_pos[p].append(block.contiguous())
                used.add(key)
        return per_pos

    def _collect(self, per_pos_outs, global_outs):
        """The flat outputs: a ``DistributedArray`` per pinned (state)
        output, the first device's value for the others."""
        flat = []
        for j, out in enumerate(global_outs):
            first = per_pos_outs[0][j]
            spec = self.out_specs[j] if j < len(self.out_specs) else None
            if isinstance(first, torch.Tensor) and spec is not None:
                shape, dtype = out
                flat.append(DistributedArray(
                    [vals[j] for vals in per_pos_outs], spec,
                    self.logical_mesh, shape, dtype))
            else:
                flat.append(first)
        return flat

    def _release_donated_args(self, flat_args, per_pos_in):
        """Release each donated argument's storage that no device's input
        holds (its blocks were copied) and no undonated argument shares,
        before the program runs: from the call on a donated value is the
        executable's, as JAX deletes a donated buffer, and the state is
        not held twice through the step."""
        def ptr(x):
            return x.untyped_storage().data_ptr()

        keep = {ptr(x) for vals in per_pos_in for x in vals
                if isinstance(x, torch.Tensor)}
        keep.update(ptr(x) for x, d in zip(flat_args, self.donated_invars)
                    if not d and isinstance(x, torch.Tensor))
        for x, d in zip(flat_args, self.donated_invars):
            if d and isinstance(x, torch.Tensor) and ptr(x) not in keep:
                storage = x.untyped_storage()
                if storage.resizable():
                    storage.resize_(0)

    def _free_donated_shards(self, per_pos_in, per_pos_out):
        """Release each donated input shard's storage that no output and
        no undonated input holds."""
        def ptr(x):
            return x.untyped_storage().data_ptr()

        keep = {ptr(x) for vals in per_pos_out for x in vals
                if isinstance(x, torch.Tensor)}
        keep.update(ptr(x) for vals in per_pos_in
                    for x, d in zip(vals, self.donated_invars)
                    if not d and isinstance(x, torch.Tensor))
        for vals in per_pos_in:
            for x, d in zip(vals, self.donated_invars):
                if d and isinstance(x, torch.Tensor) and \
                        ptr(x) not in keep:
                    storage = x.untyped_storage()
                    if storage.resizable():
                        storage.resize_(0)

    def _reset_peaks(self):
        for device in set(self.devices):
            if device.type == "cuda":
                torch.cuda.reset_peak_memory_stats(device)

    def _read_peaks(self):
        cards = [d for d in set(self.devices) if d.type == "cuda"]
        if cards:
            self._peak_bytes = max(torch.cuda.max_memory_allocated(d)
                                   for d in cards)

    def get_collective_counts(self):
        """Per collective kind, ``{"count", "bytes"}`` of one step (the
        compute-grad part's once per microbatch), and the backend of the
        kind's calls ("nccl", "plain" or "mixed")."""
        reps = {"compute": getattr(self, "num_micro_batches", None) or 1,
                "apply": 1}
        out = {}
        for part, steps in self.program.parts.items():
            for step in steps:
                if step.kind != "collective":
                    continue
                rec = step.record
                row = out.setdefault(rec.kind, {"count": 0, "bytes": 0,
                                                "backend": rec.backend})
                row["count"] += reps[part]
                row["bytes"] += rec.nbytes * reps[part]
                if row["backend"] != rec.backend:
                    row["backend"] = "mixed"
        return out


class NormalMeshExecutable(MeshExecutable, _SpmdExecution):
    """A function over flat arguments.  On one device, ``fun`` itself
    (flat lists in and out) run eagerly; on more, ``program`` (an
    ``SpmdProgram`` of the traced ``fun``) over the mesh's devices."""

    def __init__(self, physical_mesh: PhysicalDeviceMesh, fun,
                 program=None, avals=(), donated_invars=(), out_specs=()):
        super().__init__(physical_mesh)
        if physical_mesh.num_devices != 1 and program is None:
            raise ValueError(
                f"a mesh of {physical_mesh.num_devices} devices runs the "
                "partitioned program of the step; none was given")
        self.device = physical_mesh.flat_devices[0]
        self.fun = fun
        self._peak_bytes = -1
        self.program = program
        if program is not None:
            self._setup_spmd(program, avals, donated_invars, out_specs)

    @_timed_launch
    def launch_on_driver(self, *flat_args):
        """Run on flat args; returns the flat outputs.  On a CUDA device it
        also records the allocator's peak over the launch."""
        if self.program is not None:
            return self._launch_spmd(flat_args)
        args = self._prepare_args(flat_args)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        out = self.fun(*args)
        if cuda:
            self._peak_bytes = torch.cuda.max_memory_allocated(self.device)
        return out

    def _launch_spmd(self, flat_args):
        program = self.program
        self._reset_peaks()
        per_pos_in = self._shard_args(flat_args)
        self._release_donated_args(flat_args, per_pos_in)
        stores = program.initial_store(per_pos_in)
        program.run_part("compute", stores)
        program.set_externals(stores, program.pre_values(stores))
        program.run_part("apply", stores)
        per_pos_out = program.output_values(stores)
        del stores
        self._free_donated_shards(per_pos_in, per_pos_out)
        self._read_peaks()
        return self._collect(per_pos_out, self.out_avals)

    def _prepare_args(self, flat_args):
        """Put numpy arrays and tensors on another device on the mesh's
        device; other leaves (Python numbers) pass as they are."""
        out = []
        for a in flat_args:
            if isinstance(a, np.ndarray):
                a = torch.tensor(a, device=self.device)
            elif isinstance(a, torch.Tensor) and a.device != self.device:
                a = a.to(self.device)
            out.append(a)
        return out

    def get_total_allocation_size(self) -> int:
        """Peak bytes the CUDA allocator held during the last launch (-1
        before a launch on a CUDA device)."""
        return self._peak_bytes


class GradAccMeshExecutable(MeshExecutable, _SpmdExecution):
    """A step with gradient accumulation on the mesh's one device
    (``alpa_tpu/mesh_executable.py``'s ``GradAccMeshExecutable``): the
    compute-grad graph of ``shard_parallel.grad_acc`` once per microbatch,
    each adding its marked values into one accumulator per value (an fp32
    buffer per fp32 gradient leaf, allocated once and zeroed once per
    step), then the apply-grad graph once.  A donated input that the
    apply-grad graph reads is written in place by it
    (``alias_donated_inputs``, as pipeshard's apply-grad), so old and new
    state never coexist; other donated inputs no output holds have their
    storage released after the step.  The graphs run uncaptured, on the
    current stream.

    Over more than one device (``spmd``, the ``SpmdProgram`` of the step
    traced at microbatch shapes) each device runs the compute-grad part
    on its block of each microbatch and adds its marked values, partial
    sums still, into accumulators of its own; the means are reduced once,
    by the collectives the apply-grad part starts with (Alpa's skipped
    all-reduce during accumulation), before the update."""

    def __init__(self, physical_mesh: PhysicalDeviceMesh, program,
                 avals, batch_invars, donated_invars, num_micro_batches,
                 spmd=None, out_specs=()):
        from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import \
            StageExecutable
        super().__init__(physical_mesh)
        self.num_micro_batches = num_micro_batches
        self.batch_invars = list(batch_invars)
        self._accs = None
        self._peak_bytes = -1
        # set by the compiler
        self.trace_seconds = self.compile_seconds = 0.0
        self.plan = None
        self.spmd = spmd
        if spmd is not None:
            self._setup_spmd(spmd, avals, donated_invars, out_specs)
            self._quantized = quantized_accumulators([
                n.meta.get("val") if n is not None else None
                for n in spmd.pres])
            return
        self.device = physical_mesh.flat_devices[0]
        self.dtypes = [dtype for _, dtype in avals]
        self.donated_invars = list(donated_invars)
        self.program = program
        self._quantized = quantized_accumulators(program.acc_vals)
        index = {v: i for i, v in enumerate(program.placeholders)}
        n_acc = len(program.acc_vals)
        compute = program.compute
        self.compute_exec = StageExecutable(compute, 0, self.device,
                                            program.root)
        # where each graph input comes from: ("arg", flat index) or
        # ("acc", accumulator index)
        self._compute_in = [("arg", index[v]) for v in
                            compute.invars[:len(compute.invars) - n_acc]]
        self._compute_in += [("acc", k) for k in range(n_acc)]
        apply = program.apply
        self._apply_in = [("acc", program.post_acc[v]) if v in
                          program.post_acc else ("arg", index[v])
                          for v in apply.invars]
        returned = {i for kind, i in program.outputs if kind == "input"}
        donate = [j for j, (kind, i) in enumerate(self._apply_in)
                  if kind == "arg" and donated_invars[i] and
                  i not in returned]
        self.apply_exec = StageExecutable(apply, 0, self.device,
                                          program.root, donate=donate)

    def _inputs(self, flat_args):
        from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import \
            _to_tensor
        return [_to_tensor(x, dtype, self.device)
                for x, dtype in zip(flat_args, self.dtypes)]

    @_timed_launch
    def launch_on_driver(self, *flat_args):
        """Run the step on flat args; returns the flat outputs."""
        if self.spmd is not None:
            return self._launch_spmd(flat_args)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        inputs = self._inputs(flat_args)
        if self._accs is None:
            self._accs = [torch.zeros(v.shape, dtype=v.dtype,
                                      device=self.device)
                          for v in self.program.acc_vals]
        else:
            for acc in self._accs:
                acc.zero_()
        n = self.num_micro_batches
        slices = {i: x.chunk(n) for i, x in enumerate(inputs)
                  if self.batch_invars[i]}
        # a quantized accumulator's microbatch gradient is added into a
        # zeroed buffer of its own, then compressed into the accumulator
        codec = new_grad_codec(self._quantized, self.device)
        fresh = {j: torch.empty_like(self._accs[j]) for j in self._quantized}
        for mb in range(n):
            for buf in fresh.values():
                buf.zero_()
            self.compute_exec([
                fresh.get(i, self._accs[i]) if kind == "acc" else
                (slices[i][mb] if i in slices else inputs[i])
                for kind, i in self._compute_in])
            for j, buf in fresh.items():
                self._accs[j].add_(codec.compress((0, j), buf))
        outs = self.apply_exec([self._accs[i] if kind == "acc" else inputs[i]
                                for kind, i in self._apply_in])
        flat_out = [outs[i] if kind == "apply" else
                    (flat_args[i] if kind == "input" else i)
                    for kind, i in self.program.outputs]
        self._free_donated(inputs, flat_out)
        if cuda:
            self._peak_bytes = torch.cuda.max_memory_allocated(self.device)
        return flat_out

    def _launch_spmd(self, flat_args):
        program, n = self.spmd, self.num_micro_batches
        self._reset_peaks()
        per_pos_in = self._shard_args(flat_args)
        self._release_donated_args(flat_args, per_pos_in)
        chunks = [[x.chunk(n) if self.batch_invars[i] else None
                   for i, x in enumerate(vals)] for vals in per_pos_in]
        if self._accs is None:
            self._accs = [[None] * len(program.pres) for _ in self.devices]
        codecs = [new_grad_codec(self._quantized, d) for d in self.devices]
        stores = None
        for mb in range(n):
            stores = program.initial_store([
                [c[mb] if c is not None else x for x, c in zip(vals, cs)]
                for vals, cs in zip(per_pos_in, chunks)])
            program.run_part("compute", stores)
            pre = program.pre_values(stores)
            if self._quantized:
                pre = compress_spmd(pre, self._quantized, codecs,
                                    program.pre_layouts, self.logical_mesh)
            for p, vals in enumerate(pre):
                accs = self._accs[p]
                for j, v in enumerate(vals):
                    if v is None:
                        continue
                    if accs[j] is None:
                        accs[j] = torch.zeros_like(v)
                    elif mb == 0:
                        accs[j].zero_()
                    accs[j].add_(v)
        for accs in self._accs:
            for acc in accs:
                if acc is not None and n > 1:
                    acc.div_(n)
        program.set_externals(stores, self._accs)
        program.run_part("apply", stores)
        per_pos_out = program.output_values(stores)
        del stores
        # an accumulator handed out as an output is the caller's now
        held = {id(x) for vals in per_pos_out for x in vals}
        self._accs = [[None if id(a) in held else a for a in accs]
                      for accs in self._accs]
        self._free_donated_shards(per_pos_in, per_pos_out)
        self._read_peaks()
        return self._collect(per_pos_out, self.out_avals)

    def _free_donated(self, inputs, flat_out):
        """Release the storage of donated inputs that no output and no
        undonated input shares."""
        def ptr(x):
            return x.untyped_storage().data_ptr()

        keep = {ptr(x) for x in flat_out if isinstance(x, torch.Tensor)}
        keep.update(ptr(x) for x, d in zip(inputs, self.donated_invars)
                    if not d)
        keep.update(ptr(x) for x in self._accs)
        for x, d in zip(inputs, self.donated_invars):
            if d and ptr(x) not in keep:
                storage = x.untyped_storage()
                if storage.resizable():
                    storage.resize_(0)

    def get_total_allocation_size(self) -> int:
        """Peak bytes the CUDA allocator held during the last launch (-1
        before a launch on a CUDA device)."""
        return self._peak_bytes
