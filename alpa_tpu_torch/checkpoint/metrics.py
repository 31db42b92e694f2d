"""Process-global checkpoint counters (exposed via
``alpa_tpu_torch.monitoring.get_checkpoint_stats``), the port of
``alpa_tpu/checkpoint/metrics.py``.

They live in the metrics registry as the labeled counter family
``alpa_checkpoint_stat_total{key=...}``, so ``GET /metrics`` on the
serving controller exports checkpoint traffic; ``incr``/``snapshot``/
``reset`` are a thin view, ``snapshot()`` a ``{name: value}`` dict.
"""
from typing import Dict

from alpa_tpu_torch.telemetry import metrics as _metrics

_FAMILY = _metrics.get_registry().counter(
    "alpa_checkpoint_stat_total",
    "Checkpoint traffic counters (saves, restores, staged/written "
    "bytes, accumulated staging/write/blocking seconds)",
    labelnames=("key",))


def incr(name: str, value: float = 1) -> None:
    _FAMILY.labels(name).inc(value)


def snapshot() -> Dict[str, float]:
    return {key[0]: child.value for key, child in _FAMILY.children()}


def reset() -> None:
    _FAMILY.reset()
