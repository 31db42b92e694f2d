"""Build and load the port's native code at first use.

Each CUDA source under ``alpa_tpu_torch/csrc/`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds); the host C++
source (``stage_dp.cc``, the stage DP) is compiled by ``g++``.  Libraries
land in ``alpa_tpu_torch/_build/<hash>/``, keyed by the hash of the source,
of every CUDA header under ``csrc/`` (for a CUDA source) and of the flags,
so an edited source or header is rebuilt and an unchanged one is reused
within a checkout.  There is no fallback: a missing compiler or a failed
build raises.
"""
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-Wall", "-Wextra")

_lock = threading.Lock()
_loaded = {}


def find_nvcc() -> str:
    """The CUDA compiler on PATH, else the toolkit's default location."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from source "
            "at first use and need the CUDA toolkit (nvcc on PATH or "
            "/usr/local/cuda/bin/nvcc)")
    return nvcc


def find_gxx() -> str:
    """The host C++ compiler on PATH."""
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(
            "g++ not found: the port's host C++ code (the stage DP) is built "
            "from source at first use and needs g++ on PATH")
    return gxx


def _is_cuda(source: str) -> bool:
    return source.endswith(".cu")


def build_dir(source: str) -> Path:
    """Where ``csrc/<source>`` is built: a directory named by the hash of
    the source, of every ``*.cuh`` under ``csrc/`` (any of which a CUDA
    source may include) and of the compiler's flags."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    if _is_cuda(source):
        for header in sorted(CSRC.glob("*.cuh")):
            digest.update(header.name.encode() + header.read_bytes())
    flags = NVCC_FLAGS if _is_cuda(source) else GXX_FLAGS
    digest.update(" ".join(flags).encode())
    return BUILD_ROOT / digest.hexdigest()[:16]


def build(source: str) -> Path:
    """Compile ``csrc/<source>`` into a shared library unless an identical
    build exists; return the library's path.  The compiler's output (for a
    CUDA source, its register and shared-memory report) is kept beside it
    as ``build.log``."""
    src = CSRC / source
    out_dir = build_dir(source)
    lib = out_dir / (Path(source).stem + ".so")
    if lib.exists():
        return lib
    if _is_cuda(source):
        cmd = [find_nvcc(), *NVCC_FLAGS]
    else:
        cmd = [find_gxx(), *GXX_FLAGS]
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{lib.name}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", str(tmp), str(src)],
                          capture_output=True, text=True, check=False)
    (out_dir / "build.log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{Path(cmd[0]).name} failed on {src} "
                           f"(rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, lib)
    return lib


def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<source>``, once per process."""
    with _lock:
        if source not in _loaded:
            _loaded[source] = ctypes.CDLL(str(build(source)))
        return _loaded[source]
