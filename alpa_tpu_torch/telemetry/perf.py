"""The one peak-FLOPs / MFU formula of the port.

Counterpart of ``compute_mfu`` and ``peak_flops_info`` in
``alpa_tpu/telemetry/perf.py``.  ``GPU_SPECS`` plays the part of the JAX
package's ``TPU_GENERATION_SPECS``: published peaks per card, which the MFU
and the kernels' bounds are taken against.
"""
from typing import Any, Dict, Optional

import torch

# NVIDIA's data sheet, SXM part, dense rates without sparsity, at the full
# 700 W power limit
GPU_SPECS = {
    "h100-sxm": {
        "peak_bf16_tflops": 989.0,
        "peak_fp32_tflops": 67.0,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def detect_gpu_generation(device=None) -> str:
    """The ``GPU_SPECS`` key of a CUDA device, from its name."""
    name = torch.cuda.get_device_name(device)
    if "H100" in name and "PCIe" not in name:
        return "h100-sxm"
    raise ValueError(f"no published peaks for {name!r} in GPU_SPECS")


def peak_flops_info(generation: Optional[str] = None) -> Dict[str, Any]:
    """The card's bf16 peak, by generation or detected from device 0."""
    gen = generation or detect_gpu_generation()
    return {"generation": gen,
            "peak_bf16_tflops": GPU_SPECS[gen]["peak_bf16_tflops"]}


def compute_mfu(tflops_per_chip: float,
                peak_tflops: Optional[float] = None) -> float:
    """achieved TFLOPS per chip / peak TFLOPS per chip."""
    peak = peak_tflops if peak_tflops else (
        peak_flops_info()["peak_bf16_tflops"])
    return tflops_per_chip / peak if peak > 0 else 0.0
