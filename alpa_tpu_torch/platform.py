"""Device selection for the port (counterpart of ``alpa_tpu/platform.py``).

Entry points run on the GPU.  A run without CUDA raises instead of
quietly falling back to the CPU; the CPU is used only when a caller asks
for it, as the tests do.
"""
import torch


def get_device(device=None) -> torch.device:
    """``None`` -> ``cuda`` (raises when CUDA is unavailable); otherwise
    the device asked for, which must exist."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; the port runs on the GPU by default. "
            "Pass device='cpu' to run on the CPU explicitly.")
    return dev
