"""Lossy codecs for cross-mesh activations and for gradient collectives.

Counterpart of ``alpa_tpu/pipeline_parallel/reshard_codec.py`` (EQuARX's
blockwise quantization), in plain torch: JAX computes these in XLA, not
in a Pallas kernel, so the port has no kernel for them.

**Activation codec** (``global_config.reshard_quantize``, off by
default): the source mesh encodes an fp32 or bf16 value into a narrow
wire dtype with one fp32 scale per ``BLOCK`` elements of the flattened
value, only the narrow payload and the scales cross meshes, and the
destination decodes it.  ``make_transfer`` never applies it to a
microbatch-invariant value (weights, optimizer state, accumulators).
Bounds, as a fraction of the block's largest magnitude
(``ERROR_BOUND``): ``int8``, symmetric, ``scale = amax / 127``, rounded
to nearest (half to even), at most ``1/254``, zeros exact; ``fp8``
(``torch.float8_e4m3fn``), ``scale = amax / 448``, at most 7%.  An fp32
value of ``N`` elements crosses as ``N + 4 * ceil(N / 256)`` bytes
instead of ``4 N``: about 3.94x fewer for block-aligned sizes.

**Gradient codec** (``global_config.grad_quantize``): stochastic
rounding (``encode_stochastic``: each element rounds up with probability
equal to its fractional distance, so the expectation is exact, at the
price of one full step of error instead of half) and error feedback
(``grad_compress``: the residual ``x - decode(encode(x))`` is added to
the next quantization, so the error of the transmitted sum stays at the
one-shot bound).  ``grad_reduce_scatter`` composes quantize,
partial-reduce and requantize for ZeRO's reduce-scatter (two hops,
``ERROR_BOUND["grad_*_rs"]``).  Random draws come from an explicit
``torch.Generator``.  The plan verifier's numerics certification
(``analysis/numerics.py``) composes these bounds over a plan.  ``STATS``
keeps plain counters; the
registry's ``alpa_reshard_quantized_*``, ``alpa_grad_quantized_*`` and
``alpa_grad_error_feedback_norm`` families count the same events.
"""
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from alpa_tpu_torch.telemetry import metrics as _tmetrics

#: elements per scaling block; one fp32 scale crosses per block
BLOCK = 256

#: the round-trip error of one element as a fraction of its block's
#: largest magnitude, per codec mode
ERROR_BOUND = {
    "int8": 1.0 / 254.0,
    "fp8": 0.07,
    # stochastic rounding: one full step
    "grad_int8": 1.0 / 127.0,
    "grad_fp8": 0.08,
    # the reduce-scatter's two hops, added
    "grad_int8_rs": 2.0 / 127.0,
    "grad_fp8_rs": 0.16,
}

_ELIGIBLE_DTYPES = (torch.float32, torch.bfloat16)

#: plain counters: quantized edges per codec and wire bytes they saved;
#: gradient tensors the plans routed through the codec, the bytes saved
#: (also the registry's ``alpa_reshard_quantized_*`` and
#: ``alpa_grad_quantized_*`` families)
STATS: Dict[str, float] = {"edges_int8": 0, "edges_fp8": 0,
                           "bytes_saved": 0, "grad_tensors_int8": 0,
                           "grad_tensors_fp8": 0, "grad_bytes_saved": 0}

_REG = _tmetrics.get_registry()
_Q_EDGES = _REG.counter(
    "alpa_reshard_quantized_edges_total",
    "Cross-mesh transfers executed through the quantized codec",
    labelnames=("codec",))
_Q_BYTES_SAVED = _REG.counter(
    "alpa_reshard_quantized_bytes_saved_total",
    "Wire bytes saved by the quantized codec vs the lossless payload")
_GQ_TENSORS = _REG.counter(
    "alpa_grad_quantized_tensors_total",
    "Gradient tensors the plan routed through the quantized "
    "gradient-collective codec",
    labelnames=("codec",))
_GQ_BYTES_SAVED = _REG.counter(
    "alpa_grad_quantized_bytes_saved_total",
    "Gradient-sync wire bytes saved by the quantized codec vs "
    "full-precision collectives")
_GQ_EF_NORM = _REG.gauge(
    "alpa_grad_error_feedback_norm",
    "L2 norm of the most recent per-replica error-feedback residual "
    "carried into the next step's gradient quantization")


def have_fp8() -> bool:
    """Whether this torch has ``float8_e4m3fn``."""
    return hasattr(torch, "float8_e4m3fn")


def _numel(shape) -> int:
    return int(np.prod(tuple(shape), dtype=np.int64)) if len(shape) else 1


def eligible(shape, dtype: torch.dtype, mode: str,
             min_bytes: Optional[int] = None) -> bool:
    """Whether an edge's value may go through the activation codec: a
    codec mode, an fp32 or bf16 payload and at least
    ``global_config.reshard_quantize_min_bytes`` of it."""
    if mode not in ("int8", "fp8") or (mode == "fp8" and not have_fp8()):
        return False
    if dtype not in _ELIGIBLE_DTYPES:
        return False
    if min_bytes is None:
        from alpa_tpu_torch.global_env import global_config
        min_bytes = global_config.reshard_quantize_min_bytes
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _numel(shape) * itemsize >= min_bytes


def _wire_dtype(mode: str) -> torch.dtype:
    return torch.int8 if mode == "int8" else torch.float8_e4m3fn


def _wire_max(mode: str) -> float:
    return 127.0 if mode == "int8" else 448.0


def _blocks(x: torch.Tensor) -> torch.Tensor:
    """``x`` flattened in fp32, zero-padded to whole blocks, as
    ``(blocks, BLOCK)``."""
    n = x.numel()
    nb = -(-n // BLOCK)
    flat = x.reshape(-1).float()
    if nb * BLOCK != n:
        flat = torch.cat([flat, flat.new_zeros(nb * BLOCK - n)])
    return flat.reshape(nb, BLOCK)


def encode(x: torch.Tensor, mode: str
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(q, scales)``: ``q[i] ~ x[i] / scale[block(i)]`` in the wire
    dtype, ``scales`` of shape ``(blocks, 1)`` in fp32."""
    blocks = _blocks(x)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0, amax / _wire_max(mode),
                        torch.ones_like(amax))
    q = blocks / scale
    if mode == "int8":
        q = torch.clamp(torch.round(q), -127, 127)
    return q.to(_wire_dtype(mode)), scale


def decode(q: torch.Tensor, scale: torch.Tensor, shape, dtype: torch.dtype,
           mode: str) -> torch.Tensor:
    """The inverse of ``encode`` up to its rounding: rescale, trim the
    padding, restore the shape and the payload's dtype."""
    del mode
    n = _numel(shape)
    flat = (q.float() * scale).reshape(-1)[:n]
    return flat.reshape(tuple(shape)).to(dtype)


def wire_bytes(shape, itemsize: int, mode: str) -> int:
    """Bytes on the wire for one value: one per element and four per
    block (both wire dtypes take one byte)."""
    del itemsize, mode
    n = _numel(shape)
    return n + 4 * (-(-n // BLOCK))


class QuantizedTransfer:
    """One quantized cross-mesh edge, on shards: the source shards are
    gathered on the first source device (``intra_mesh_bytes``), encoded
    there, the payload and scales sent to the first destination device
    (``cross_mesh_bytes``, the wire bytes), decoded, and each destination
    device takes its block (``intra_mesh_bytes``)."""

    def __init__(self, plan, dtype: torch.dtype, src_sharding, dst_sharding,
                 src_devices, dst_devices, mode: str):
        from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import \
            VirtualDistributedArray
        self.plan = plan
        self.mode = mode
        self.strategy = f"quantized_{mode}"
        self.shape = tuple(plan.shape)
        self.dtype = dtype
        self.src_devices = [torch.device(d) for d in src_devices]
        self.dst_devices = [torch.device(d) for d in dst_devices]
        self.src_tiles = VirtualDistributedArray.from_sharding(
            self.shape, src_sharding).unique_tiles
        self.dst_tiles = VirtualDistributedArray.from_sharding(
            self.shape, dst_sharding).device_tiles
        self.nbytes = _numel(self.shape) * plan.itemsize
        self.wire = (1, float(self.wire_nbytes))
        self.last_report = None

    @property
    def wire_nbytes(self) -> int:
        return wire_bytes(self.shape, self.plan.itemsize, self.mode)

    def __call__(self, src_shards: Sequence[torch.Tensor]):
        from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import (
            ExecutionReport, _index)
        report = ExecutionReport(mode=self.strategy)
        home, dest = self.src_devices[0], self.dst_devices[0]

        def move(x, device, counter):
            nbytes = x.numel() * x.element_size()
            setattr(report, counter, getattr(report, counter) + nbytes)
            if x.device == device:
                return x
            report.moved += nbytes
            return x.to(device, non_blocking=device.type == "cuda")

        if len(self.src_tiles) == 1:
            # a replicated value: the first device holds it whole
            full = src_shards[0]
        else:
            full = torch.empty(self.shape, dtype=src_shards[0].dtype,
                               device=home)
            for slices, holders in self.src_tiles.items():
                x = src_shards[holders[0]]
                if holders[0] != 0:
                    x = move(x, home, "intra_mesh_bytes")
                full[_index(slices)].copy_(x)
        q, scale = encode(full, self.mode)
        q = move(q, dest, "cross_mesh_bytes")
        scale = move(scale, dest, "cross_mesh_bytes")
        report.n_tiles = 1
        report.max_link_bytes = report.cross_mesh_bytes
        value = decode(q, scale, self.shape, self.dtype, self.mode)
        out = []
        for p, (tile, device) in enumerate(zip(self.dst_tiles,
                                               self.dst_devices)):
            block = value if tile.shape == self.shape else \
                value[_index(tile.slices)].contiguous()
            out.append(block if p == 0 else
                       move(block, device, "intra_mesh_bytes"))
        STATS[f"edges_{self.mode}"] += 1
        STATS["bytes_saved"] += max(0, self.nbytes - self.wire_nbytes)
        _Q_EDGES.labels(self.mode).inc()
        _Q_BYTES_SAVED.inc(max(0, self.nbytes - self.wire_nbytes))
        self.last_report = report
        return out, report.moved


def maybe_quantized_transfer(plan, dtype: torch.dtype, src_sharding,
                             dst_sharding, src_devices, dst_devices,
                             mode: str) -> Optional[QuantizedTransfer]:
    """A ``QuantizedTransfer`` where the edge is eligible under ``mode``,
    else None (the caller keeps a lossless path)."""
    if not eligible(plan.shape, dtype, mode):
        return None
    return QuantizedTransfer(plan, dtype, src_sharding, dst_sharding,
                             src_devices, dst_devices, mode)


########################################
# the gradient codec
########################################

#: the modes ``global_config.grad_quantize`` takes besides "off"
GRAD_MODES = ("int8", "fp8")

#: the smallest normal fp32: a block's scale never falls below it, so a
#: block of tiny magnitudes keeps an absolute error of one such step and
#: an all-zero block stays exact
_SCALE_FLOOR = 1.1754944e-38


def note_grad_quantized(codec: str, full_bytes: int,
                        wire_nbytes: int) -> None:
    """Count one gradient tensor a plan routed through the codec."""
    STATS[f"grad_tensors_{codec}"] += 1
    STATS["grad_bytes_saved"] += max(0, int(full_bytes) - int(wire_nbytes))
    _GQ_TENSORS.labels(codec).inc()
    _GQ_BYTES_SAVED.inc(max(0, int(full_bytes) - int(wire_nbytes)))


def note_error_feedback_norm(value: float) -> None:
    """Export the residual buffer's L2 norm (read on the host by the
    caller) as ``alpa_grad_error_feedback_norm``."""
    _GQ_EF_NORM.set(float(value))


def encode_stochastic(x: torch.Tensor, mode: str,
                      generator: torch.Generator
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``encode``'s layout with stochastic rounding, the uniforms drawn
    from ``generator``: ``int8`` rounds ``q`` down or up by one step;
    ``fp8`` rounds onto the ``float8_e4m3fn`` grid, whose step is
    ``2^(floor(log2|q|) - 3)`` and ``2^-9`` below ``2^-6``."""
    if mode not in GRAD_MODES:
        raise ValueError(f"unknown gradient codec mode: {mode!r}")
    blocks = _blocks(x)
    amax = blocks.abs().amax(dim=1, keepdim=True)
    scale = torch.where(amax > 0,
                        torch.clamp(amax / _wire_max(mode),
                                    min=_SCALE_FLOOR),
                        torch.ones_like(amax))
    q = blocks / scale
    u = torch.rand(blocks.shape, generator=generator, dtype=torch.float32,
                   device=generator.device).to(blocks.device)
    if mode == "int8":
        lo = torch.floor(q)
        q = torch.clamp(lo + (u < (q - lo)).float(), -127.0, 127.0)
    else:
        a = q.abs()
        e = torch.floor(torch.log2(torch.clamp(a, min=2.0 ** -6)))
        step = torch.where(a < 2.0 ** -6, torch.full_like(a, 2.0 ** -9),
                           torch.exp2(e - 3.0))
        lo = torch.floor(q / step) * step
        q = lo + torch.where(u < (q - lo) / step, step,
                             torch.zeros_like(step))
        q = torch.clamp(q, -_wire_max(mode), _wire_max(mode))
    return q.to(_wire_dtype(mode)), scale


def grad_compress(g: torch.Tensor, mode: str, generator: torch.Generator,
                  residual: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback quantization of a gradient: ``(g_hat,
    new_residual)``, ``g_hat`` the decoded stochastic encoding of ``g +
    residual`` and ``new_residual`` what it failed to carry."""
    x = g if residual is None else g + residual.to(g.dtype)
    q, scale = encode_stochastic(x, mode, generator)
    g_hat = decode(q, scale, tuple(x.shape), x.dtype, mode)
    return g_hat, (x.float() - g_hat.float()).to(x.dtype)


def grad_reduce_scatter(grads: Sequence[torch.Tensor], mode: str,
                        generator: torch.Generator,
                        residuals: Optional[Sequence[torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """ZeRO's reduce-scatter through the codec, replica by replica: each
    replica's gradient one ``grad_compress`` hop (its residual fed back),
    the decoded contributions averaged, the mean requantized for the
    scatter hop.  Returns ``(mean, new residuals)``."""
    hats, new_res = [], []
    for i, g in enumerate(grads):
        h, r = grad_compress(g, mode, generator,
                             None if residuals is None else residuals[i])
        hats.append(h)
        new_res.append(r)
    partial = hats[0].float()
    for h in hats[1:]:
        partial = partial + h.float()
    partial = (partial / len(grads)).to(grads[0].dtype)
    q, scale = encode_stochastic(partial, mode, generator)
    return decode(q, scale, tuple(partial.shape), partial.dtype,
                  mode), new_res


def grad_error_bound(mode: str, reduce_scatter: bool = False,
                     error_feedback: bool = True, hops: int = 1) -> float:
    """The relative error bound of a quantized gradient sync: one hop's
    (``grad_*_rs`` for the reduce-scatter), kept over any number of hops
    with error feedback, else ``hops`` times it."""
    per_hop = ERROR_BOUND[f"grad_{mode}" + ("_rs" if reduce_scatter
                                            else "")]
    return per_hop if error_feedback else per_hop * max(1, int(hops))


def grad_wire_bytes(shape, itemsize: int, mode: str) -> int:
    """Wire bytes of one gradient tensor under the codec."""
    return wire_bytes(shape, itemsize, mode)


def grad_eligible(shape, dtype: torch.dtype, mode: str,
                  min_bytes: Optional[int] = None) -> bool:
    """Whether one gradient tensor may go through the gradient codec: a
    codec mode, fp32 or bf16, at least ``grad_quantize_min_bytes``."""
    if mode not in GRAD_MODES or (mode == "fp8" and not have_fp8()):
        return False
    if dtype not in _ELIGIBLE_DTYPES:
        return False
    if min_bytes is None:
        from alpa_tpu_torch.global_env import global_config
        min_bytes = global_config.grad_quantize_min_bytes
    itemsize = torch.empty((), dtype=dtype).element_size()
    return _numel(shape) * itemsize >= int(min_bytes)


@dataclasses.dataclass
class GradCodecState:
    """The gradient codec's state over a run: the generator its uniforms
    come from and each accumulator's error-feedback residual."""
    mode: str
    generator: torch.Generator
    error_feedback: bool = True
    residuals: Dict[Tuple[int, int], torch.Tensor] = dataclasses.field(
        default_factory=dict)

    def compress(self, key: Tuple[int, int], g: torch.Tensor
                 ) -> torch.Tensor:
        """``g`` through one ``grad_compress`` hop, the residual of
        ``key`` carried into the next."""
        res = self.residuals.get(key) if self.error_feedback else None
        g_hat, new_res = grad_compress(g, self.mode, self.generator, res)
        if self.error_feedback:
            self.residuals[key] = new_res
        return g_hat
