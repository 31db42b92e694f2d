"""Mesh executables: what ``@parallelize`` runs on one physical mesh.

Counterpart of ``alpa_tpu/mesh_executable.py`` (``MeshExecutable``,
``NormalMeshExecutable``, ``GradAccMeshExecutable``).  A
``NormalMeshExecutable`` holds the function itself and runs it eagerly on
flat, already tree-flattened arguments; there is no compiled program.  A
``GradAccMeshExecutable`` runs the traced compute-grad graph once per
microbatch and the apply-grad graph once (``shard_parallel/grad_acc.py``).
``launch_on_driver`` first puts host values (numpy arrays, tensors on
another device) on the mesh's device, as the JAX version commits host
arrays to their shardings.
"""
import itertools

import numpy as np
import torch

from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh

_exec_uuids = itertools.count(1)


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


class NormalMeshExecutable(MeshExecutable):
    """A function over flat arguments, run on the mesh's one device.
    ``fun`` takes and returns flat lists."""

    def __init__(self, physical_mesh: PhysicalDeviceMesh, fun):
        super().__init__(physical_mesh)
        if physical_mesh.num_devices != 1:
            raise NotImplementedError(
                f"NormalMeshExecutable runs on one device; got a mesh of "
                f"{physical_mesh.num_devices}")
        self.device = physical_mesh.flat_devices[0]
        self.fun = fun
        self._peak_bytes = -1

    def launch_on_driver(self, *flat_args):
        """Run on flat args; returns the flat outputs.  On a CUDA device it
        also records the allocator's peak over the launch."""
        args = self._prepare_args(flat_args)
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats(self.device)
        out = self.fun(*args)
        if cuda:
            self._peak_bytes = torch.cuda.max_memory_allocated(self.device)
        return out

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


class GradAccMeshExecutable(MeshExecutable):
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
    current stream.  A mesh of more than one device raises (ROADMAP
    A.3.2)."""

    def __init__(self, physical_mesh: PhysicalDeviceMesh, program,
                 avals, batch_invars, donated_invars, num_micro_batches):
        from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import \
            StageExecutable
        super().__init__(physical_mesh)
        if physical_mesh.num_devices != 1:
            raise NotImplementedError(
                f"a gradient-accumulation step over {physical_mesh.num_devices}"
                " devices needs the multi-device executor, which is not "
                "ported yet (ROADMAP A.3.2)")
        self.device = physical_mesh.flat_devices[0]
        self.num_micro_batches = num_micro_batches
        self.dtypes = [dtype for _, dtype in avals]
        self.batch_invars = list(batch_invars)
        self.donated_invars = list(donated_invars)
        self.program = program
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
        self._accs = None
        self._peak_bytes = -1
        # set by the compiler
        self.trace_seconds = self.compile_seconds = 0.0
        self.plan = None

    def _inputs(self, flat_args):
        from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import \
            _to_tensor
        return [_to_tensor(x, dtype, self.device)
                for x, dtype in zip(flat_args, self.dtypes)]

    def launch_on_driver(self, *flat_args):
        """Run the step on flat args; returns the flat outputs."""
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
        for mb in range(n):
            self.compute_exec([
                self._accs[i] if kind == "acc" else
                (slices[i][mb] if i in slices else inputs[i])
                for kind, i in self._compute_in])
        outs = self.apply_exec([self._accs[i] if kind == "acc" else inputs[i]
                                for kind, i in self._apply_in])
        flat_out = [outs[i] if kind == "apply" else
                    (flat_args[i] if kind == "input" else i)
                    for kind, i in self.program.outputs]
        self._free_donated(inputs, flat_out)
        if cuda:
            self._peak_bytes = torch.cuda.max_memory_allocated(self.device)
        return flat_out

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
