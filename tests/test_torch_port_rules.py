"""Rules the PyTorch port keeps: no JAX, CUDA by default, no fallback."""
import ast
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import alpa_tpu_torch
from alpa_tpu_torch import device_mesh
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.model.gpt_model import GPTConfig
from alpa_tpu_torch.ops import _build
from alpa_tpu_torch.ops import flash_attention as fa
from alpa_tpu_torch.serve import Generator, get_model, run_controller

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "alpa_tpu_torch"
PORT_FILES = sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "alpa_tpu", "transformers")
TINY = GPTConfig(hidden_size=64, num_layers=1, num_heads=1, seq_len=32,
                 vocab_size=32)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    """Building a torch module draws its default init from the global RNG;
    restore that state so these tests leave other tests' draws alone."""
    with torch.random.fork_rng():
        yield


def _blocked(name: str) -> bool:
    return any(name == b or name.startswith(b + ".") for b in BLOCKED)


def test_every_module_imports_with_jax_blocked():
    """Import each port module, and chip_smoke.py, in a fresh interpreter
    where any attempt to import jax, flax, alpa_tpu or transformers
    raises."""
    modules = [".".join(p.relative_to(REPO).with_suffix("").parts)
               for p in sorted(PORT.rglob("*.py"))]
    modules = [m[:-len(".__init__")] if m.endswith(".__init__") else m
               for m in modules]
    script = f"""
import importlib, importlib.util, sys
BLOCKED = {BLOCKED!r}
class Block:
    def find_spec(self, name, path=None, target=None):
        if any(name == b or name.startswith(b + ".") for b in BLOCKED):
            raise ImportError("blocked import of " + name)
        return None
sys.meta_path.insert(0, Block())
for m in {modules!r}:
    importlib.import_module(m)
spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(REPO / "chip_smoke.py")!r})
spec.loader.exec_module(importlib.util.module_from_spec(spec))
leaked = [m for m in sys.modules if any(
    m == b or m.startswith(b + ".") for b in BLOCKED)]
assert not leaked, leaked
print("ok", len({modules!r}))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", script], cwd=str(REPO),
                          env=env, capture_output=True, text=True,
                          timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("ok")


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_imports_in_source(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert not any(_blocked(n) for n in names), (path, node.lineno)


def test_default_device_is_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        alpa_tpu_torch.get_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_model(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Generator(None, TINY)
    server = run_controller(port=0)
    try:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            server.controller.register_model("m", TINY)
    finally:
        server.shutdown()
    assert alpa_tpu_torch.get_device("cpu").type == "cpu"


def test_kernel_wrapper_rejects_what_the_kernel_cannot_take():
    def qkv(d=64, dtype=torch.float32):
        return [torch.zeros(1, 8, 2, d, dtype=dtype) for _ in range(3)]

    with pytest.raises(ValueError, match="head dim"):
        fa._kernel_args(*qkv(d=96))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._kernel_args(*qkv(dtype=torch.float16))
    q, k, v = qkv()
    with pytest.raises(ValueError, match="contiguous head"):
        fa._kernel_args(q, k, v.transpose(-1, -2))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention_forward(*[t.to("meta") for t in qkv()],
                                   causal=True)
    with pytest.raises(ValueError, match="q_offset"):
        fa.flash_attention_forward(*qkv(), causal=True, q_offset=-1)


def test_build_raises_without_nvcc(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_ROOT",
                        pathlib.Path("/nonexistent-build-root"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_fwd.cu")


def test_init_and_parallelize_default_to_cuda_and_raise_without_it(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    alpa_tpu_torch.shutdown()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        alpa_tpu_torch.init()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        alpa_tpu_torch.parallelize(lambda x: x * 2)(torch.ones(2))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        device_mesh.LocalPhysicalDeviceMesh()
    try:
        alpa_tpu_torch.init(devices=["cpu"])
        out = alpa_tpu_torch.parallelize(lambda x: x * 2)(torch.ones(2))
        assert out.device.type == "cpu" and float(out.sum()) == 4.0
    finally:
        alpa_tpu_torch.shutdown()


def test_shard_parallel_never_runs_many_devices_on_one(monkeypatch):
    """A step over two devices runs the partitioned program once per
    device on that device's block (half the batch each), with or without
    accumulation, never the whole step on one device; the JAX package's
    ``emit_sharding_constraints=False`` is accepted, and a
    ``constrain_min_elements`` off its default raises with its reason."""
    from alpa_tpu_torch.shard_parallel import spmd_partition
    seen = []
    real = spmd_partition.SpmdProgram._module

    def module(self, step, device):
        inner = real(self, step, device)

        def run(*args):
            seen.append(tuple(tuple(a.shape) for a in args
                              if isinstance(a, torch.Tensor)))
            return inner(*args)
        return run

    monkeypatch.setattr(spmd_partition.SpmdProgram, "_module", module)
    for k in (None, 2):
        seen.clear()
        state, batch = ttesting.create_mlp_train_state_and_batch(
            batch_size=32, input_dim=4, hidden_dim=4, output_dim=4)
        method = alpa_tpu_torch.DataParallel(devices=["cpu", "cpu"],
                                             num_micro_batches=k)
        step = ttesting.get_mlp_train_step(method, True)
        step(state, batch)
        ex = step.get_last_executable()
        segments = {part: sum(st.kind == "segment" for st in steps)
                    for part, steps in ex.program.parts.items()}
        # each segment ran once per device (the compute-grad part once per
        # microbatch), on the device's block: 16 // k rows of the 32
        assert len(seen) == 2 * ((k or 1) * segments["compute"] +
                                 segments["apply"])
        assert any((16 // (k or 1), 4) in shapes for shapes in seen)
        assert not any((32 // (k or 1), 4) in shapes for shapes in seen)
    alpa_tpu_torch.AutoShardingOption(emit_sharding_constraints=False)
    with pytest.raises(NotImplementedError, match="constrain_min_elements"):
        alpa_tpu_torch.AutoShardingOption(constrain_min_elements=1)
    with pytest.raises(NotImplementedError, match="multi-host"):
        alpa_tpu_torch.init(cluster="distributed", devices=["cpu"])


def test_backward_wrapper_rejects_what_the_kernels_cannot_take():
    def args(d=64, dtype=torch.float32, sq=8):
        q, k, v, do = (torch.zeros(1, sq, 2, d, dtype=dtype)
                       for _ in range(4))
        return q, k, v, q.clone(), torch.zeros(2, sq), do

    q, k, v, out, lse, do = args(d=96)
    with pytest.raises(ValueError, match="head dim"):
        fa._bwd_common(q, k, v, do, True, 0)
    q, k, v, out, lse, do = args(dtype=torch.float16)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._bwd_common(q, k, v, do, True, 0)
    q, k, v, out, lse, do = args()
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fa._bwd_common(q, k, v, do.to(torch.bfloat16), True, 0)
    with pytest.raises(ValueError, match="contiguous head"):
        fa._bwd_common(q, k, v.transpose(-1, -2), do, True, 0)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_backward(q, k, v, out, lse[:, :4], do,
                                    causal=True)
    with pytest.raises(ValueError, match="q's shape"):
        fa.flash_attention_backward(q, k, v, out[:, :4], lse, do,
                                    causal=True)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fa.flash_attention_backward(*[t.to("meta") for t in args()],
                                    causal=True)


def test_build_raises_without_nvcc_for_the_backward_kernels(monkeypatch):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setattr(_build.os.path, "exists", lambda path: False)
    monkeypatch.setattr(_build, "BUILD_ROOT",
                        pathlib.Path("/nonexistent-build-root"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build("flash_bwd.cu")


LIBRARY_ATTENTION = ("scaled_dot_product_attention",
                     "_scaled_dot_product_flash_attention",
                     "_scaled_dot_product_efficient_attention",
                     "_scaled_dot_product_cudnn_attention",
                     "_cudnn_attention", "cudnn_attention", "sdpa_kernel")


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_calls_no_library_attention_or_compile(path):
    """The port's kernels are its own: no module calls PyTorch's fused
    attention, a cuDNN attention entry point or ``torch.compile``
    (``chip_smoke.py`` may time one as a yardstick)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute):
            name = node.attr
            assert not (name == "compile" and isinstance(node.value, ast.Name)
                        and node.value.id == "torch"), (path, node.lineno)
        elif isinstance(node, ast.Name):
            name = node.id
        elif isinstance(node, ast.alias):
            name = node.name.rsplit(".", 1)[-1]
        else:
            continue
        assert name not in LIBRARY_ATTENTION, (path, node.lineno, name)


def _cuda_function(source: str, name: str) -> str:
    """The text of the function ``name`` in a CUDA source, up to its
    closing brace at column 0."""
    start = source.index(f" {name}(")
    return source[start:source.index("\n}\n", start)]


def _cuda_source(name: str) -> str:
    """A CUDA source with the shared header it includes."""
    csrc = PORT / "csrc"
    src = (csrc / name).read_text()
    assert '#include "sm90.cuh"' in src
    return src + (csrc / "sm90.cuh").read_text()


def test_bf16_backward_kernels_use_the_tensor_cores():
    """The bf16 backward kernels do their products with ``wgmma`` (the dq
    kernel: S, dP, then dS K; the dk/dv kernel: S^T, dP^T, then P^T dO and
    dS^T Q), and the entry points send bf16 to them."""
    src = _cuda_source("flash_bwd.cu")
    assert "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16" in src
    for helper in ("mma_ss_pair", "mma_rs"):
        assert "sm90::wgmma_" in _cuda_function(src, helper)
    dq = _cuda_function(src, "flash_bwd_dq_bf16_kernel")
    dkv = _cuda_function(src, "flash_bwd_dkv_bf16_kernel")
    # second products take P and dS as a bf16 hi + lo pair: two passes each
    assert dq.count("mma_ss_pair<D>(") == 1 and dq.count("mma_rs<D>(") == 2
    assert dkv.count("mma_ss_pair<D>(") == 1 and dkv.count("mma_rs<D>(") == 4
    for kernel in (dq, dkv):   # tiles come through the cp.async ring
        assert "load_tile<" in kernel and "ring_wait()" in kernel
        assert "fmaf(" not in kernel
    for entry in ("launch_dq", "launch_dkv"):
        launcher = _cuda_function(src, entry)
        assert "if (bf16_inputs)" in launcher and "_bf16_kernel<D>" in launcher


def test_bf16_backward_wrapper_rejects_misaligned_tensors():
    """The bf16 kernels copy 16-byte chunks: a pointer or a (B, S, H) stride
    that is not a multiple of 16 bytes raises; fp32 takes any."""
    def bf16(shape, offset=0):
        flat = torch.zeros(offset + int(torch.Size(shape).numel()),
                           dtype=torch.bfloat16)
        return flat[offset:].view(shape)

    q, k, v, do = (bf16((1, 8, 2, 64)) for _ in range(4))
    assert fa._bwd_common(q, k, v, do, True, 0)[0] == 1
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._bwd_common(q, k, v, bf16((1, 8, 2, 64), offset=1), True, 0)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._bwd_common(q, bf16((1, 8, 3, 64))[:, :, :2], v, do, True, 0,
                       out=bf16((1, 8, 2, 64), offset=4))
    odd = bf16((1, 8, 2, 68))[..., :64]         # S and H strides of 68
    with pytest.raises(ValueError, match="16-byte aligned"):
        fa._bwd_common(q, odd, v, do, True, 0)
    fa._bwd_common(*(t.float() for t in (q, odd, v, do)), True, 0)


def test_bf16_forward_kernel_uses_the_tensor_cores():
    """The bf16 forward kernel does S = Q K^T and O += P V with ``wgmma``
    through the ``sm90::`` helpers, on tiles that come through the
    ``cp.async`` ring, with no FMA on the CUDA cores; the fp32 kernel keeps
    those, and the launcher sends bf16 to the tensor-core kernel."""
    src = _cuda_source("flash_fwd.cu")
    assert "sm90::wgmma_ss_n64(" in _cuda_function(src, "mma_qk")
    kernel = _cuda_function(src, "flash_fwd_bf16_kernel")
    assert kernel.count("mma_qk<D>(") == 1 and kernel.count("mma_rs<D>(") == 1
    assert "load_tile<" in kernel and "ring_wait()" in kernel
    assert "fmaf(" not in kernel
    assert "fmaf(" in _cuda_function(src, "flash_fwd_kernel")
    assert "__nv_bfloat16" not in _cuda_function(src, "flash_fwd_kernel")
    launcher = _cuda_function(src, "launch_fwd")
    assert "if (bf16_inputs)" in launcher
    assert "flash_fwd_bf16_kernel<D>" in launcher
    assert "launch_fwd<64>(p, dtype == 1, s)" in src


def test_an_edited_header_changes_the_build_directory(monkeypatch, tmp_path):
    """Every ``*.cuh`` under ``csrc/`` enters the hash that names a
    source's build directory, so editing a header rebuilds the kernels that
    include it; the build directory of an unchanged tree stays."""
    for path in (PORT / "csrc").iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {s: _build.build_dir(s) for s in ("flash_fwd.cu", "flash_bwd.cu")}
    assert before == {s: _build.build_dir(s) for s in before}
    header = tmp_path / "sm90.cuh"
    header.write_bytes(header.read_bytes() + b"\n")
    for source, old in before.items():
        assert _build.build_dir(source) != old
        assert _build.build_dir(source).parent == old.parent


def test_pipeshard_without_devices_raises_without_cuda(monkeypatch):
    """``PipeshardParallel()`` with no devices named takes the CUDA devices
    and raises without CUDA; named CPU devices run."""
    from alpa_tpu_torch.testing import (create_mlp_train_state_and_batch,
                                        get_mlp_train_step)

    def method(devices=None):
        return alpa_tpu_torch.PipeshardParallel(
            devices=devices, num_micro_batches=2,
            layer_option=alpa_tpu_torch.ManualLayerOption(),
            stage_option=alpa_tpu_torch.UniformStageOption(2))

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    alpa_tpu_torch.shutdown()
    state, batch = create_mlp_train_state_and_batch(
        batch_size=4, input_dim=8, hidden_dim=8, output_dim=8, num_layers=2,
        manual_pipeline_layer=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_mlp_train_step(method(), use_value_and_grad=True)(state, batch)
    state, loss = get_mlp_train_step(method(["cpu"] * 2),
                                     use_value_and_grad=True)(state, batch)
    assert loss.device.type == "cpu" and torch.isfinite(loss)


def test_dispatch_modules_are_under_the_import_checks():
    """The modules of the dispatch modes, the inference path and the
    serving engine are among the files the import and ``torch.compile``
    checks above walk."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ("alpa_tpu_torch/global_env.py",
                   "alpa_tpu_torch/pipeline_parallel/runtime_emitter.py",
                   "alpa_tpu_torch/pipeline_parallel/pipeshard_executable.py",
                   "alpa_tpu_torch/pipeline_parallel/compile_executable.py",
                   "alpa_tpu_torch/pipeline_parallel/layer_construction.py",
                   "alpa_tpu_torch/serve/engine.py",
                   "alpa_tpu_torch/serve/kv_cache.py",
                   "alpa_tpu_torch/serve/packed.py",
                   "alpa_tpu_torch/serve/scheduler.py"):
        assert module in names


def test_shard_parallel_modules_are_under_the_import_checks():
    """The planner and accumulation modules are among the files the import
    and ``torch.compile`` checks above walk."""
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    for module in ("sharding_spec", "auto_sharding", "manual_sharding",
                   "strategy", "ilp", "solver", "grad_acc",
                   "compile_executable"):
        assert f"alpa_tpu_torch/shard_parallel/{module}.py" in names


def _cpu_pipeshard_step():
    from alpa_tpu_torch.testing import (create_mlp_train_state_and_batch,
                                        get_mlp_train_step)
    state, batch = create_mlp_train_state_and_batch(
        batch_size=4, input_dim=8, hidden_dim=8, output_dim=8, num_layers=2,
        manual_pipeline_layer=True)
    step = get_mlp_train_step(alpa_tpu_torch.PipeshardParallel(
        devices=["cpu"] * 2, num_micro_batches=2,
        layer_option=alpa_tpu_torch.ManualLayerOption(),
        stage_option=alpa_tpu_torch.UniformStageOption(2)),
        use_value_and_grad=True)
    return step, state, batch


def test_failed_capture_raises_instead_of_running_eagerly(monkeypatch):
    """A RUN whose stage graph would be captured (a CUDA executable past
    its first call; the CUDA calls mocked on the CPU) and whose capture
    fails raises ``RuntimeError``: the stage is not run eagerly in its
    place, and no half-captured step is kept."""
    from alpa_tpu_torch.pipeline_parallel import pipeshard_executable as pe
    step, state, batch = _cpu_pipeshard_step()
    ex, flat = step.get_executable(state, batch)
    captures = []

    class FailingCapture:
        def __init__(self, graph, pool=None, stream=None):
            del graph, pool, stream

        def __enter__(self):
            captures.append(1)

        def __exit__(self, *exc):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

    def eager(*args, **kwargs):
        raise AssertionError("a stage ran eagerly after a failed capture")

    for name, fake in (("synchronize", lambda *a: None),
                       ("graph_pool_handle", lambda: (0, 0)),
                       ("Stream", lambda *a: None),
                       ("Event", lambda *a: None),
                       ("CUDAGraph", lambda: None),
                       ("graph", FailingCapture)):
        monkeypatch.setattr(torch.cuda, name, fake)
    monkeypatch.setattr(ex, "_run_eager", eager)
    ex._use_graphs = ex._warm = True
    with pytest.raises(RuntimeError, match="not run eagerly"):
        ex.launch_on_driver(*flat)
    assert captures == [1] and ex._captured is None
    assert isinstance(pe.CapturedRun, type)


def test_launch_leaves_the_peak_memory_statistics_alone(monkeypatch):
    """A pipeshard launch no longer resets the allocator's peak statistics
    (a replay allocates nothing, so a per-call reset would hide the
    graphs' memory): no call of ``reset_peak_memory_stats`` in the
    driver, and none at run time."""
    from alpa_tpu_torch.pipeline_parallel import pipeshard_executable as pe
    tree = ast.parse(pathlib.Path(pe.__file__).read_text())
    assert not any(isinstance(n, ast.Attribute) and
                   n.attr == "reset_peak_memory_stats"
                   for n in ast.walk(tree))

    def reset(*args, **kwargs):
        raise AssertionError("reset_peak_memory_stats called")

    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", reset)
    step, state, batch = _cpu_pipeshard_step()
    for _ in range(2):
        state, loss = step(state, batch)
    assert torch.isfinite(loss)


def test_serving_engine_and_pool_default_to_cuda(monkeypatch):
    """``KVBlockPool`` and the engine (through its ``Generator``) run on
    CUDA unless given the CPU; on the CPU the decode tick is not captured."""
    from alpa_tpu_torch.model.gpt_model import GPTModel
    from alpa_tpu_torch.serve import ContinuousBatchingEngine, KVBlockPool
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        KVBlockPool(TINY)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousBatchingEngine(Generator(GPTModel(TINY), TINY))
    gen = Generator(GPTModel(TINY), TINY, device="cpu")
    engine = ContinuousBatchingEngine(gen, max_batch=1, prompt_bucket=8)
    try:
        assert engine.device.type == "cpu" and engine._capture is False
        assert KVBlockPool.for_generator(gen).device.type == "cpu"
    finally:
        engine.shutdown()


def test_failed_decode_capture_fails_the_rows_and_runs_nothing_in_its_place(
        monkeypatch):
    """The engine's capture of its decode tick (the CUDA calls mocked on
    the CPU) fails: the live rows get the error, the engine counts a step
    failure, and no tick runs uncaptured beyond the capture's one warm-up;
    the next tick tries the capture again."""
    import contextlib
    from alpa_tpu_torch.model.gpt_model import GPTModel
    from alpa_tpu_torch.serve import ContinuousBatchingEngine
    from alpa_tpu_torch.serve.generation import GenerationConfig

    class FakeStream:
        def wait_stream(self, other):
            del other

    class FailingCapture:
        def __init__(self, graph, stream=None, capture_error_mode=None):
            assert capture_error_mode == "thread_local"
            del graph, stream

        def __enter__(self):
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")

        def __exit__(self, *exc):
            return False

    for name, fake in (("Stream", lambda *a: FakeStream()),
                       ("current_stream", lambda *a: FakeStream()),
                       ("stream", lambda s: contextlib.nullcontext()),
                       ("CUDAGraph", lambda: None),
                       ("graph", FailingCapture)):
        monkeypatch.setattr(torch.cuda, name, fake)
    gen = Generator(GPTModel(TINY), TINY, device="cpu")
    engine = ContinuousBatchingEngine(gen, max_batch=1, prompt_bucket=8)
    ticks = []
    monkeypatch.setattr(engine, "_tick_body", lambda: ticks.append(1))
    engine._capture = True
    try:
        for attempt in (1, 2):
            with pytest.raises(RuntimeError, match="not run uncaptured"):
                engine.submit(np.arange(1, 4), GenerationConfig(
                    max_new_tokens=3))
            assert engine.step_failures == attempt and len(ticks) == attempt
        assert engine.decode_captures == 0 and engine._graph is None
        assert engine.decode_replays == 0 and not engine._active.any()
    finally:
        engine.shutdown()
