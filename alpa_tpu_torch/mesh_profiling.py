"""Mesh profiling, the calibrated cost model, and the stage cost and
memory models of the stage DP.

Counterpart of ``alpa_tpu/mesh_profiling.py``.  Two paths, as there:

* ``ProfilingResultDatabase``: measured matmul and collective times per
  mesh signature, JSON-persisted, filled by ``profile_all`` /
  ``profile_one_mesh`` on the cards (CUDA events around the port's
  ``shard_parallel.collectives`` and a chain of matmuls).  Its fit, a
  ``CalibratedCostModel``, gives seconds per flop by size and an
  (alpha, beta) per collective kind in seconds, which
  ``LogicalDeviceMesh``'s cost queries and the stage DP read.  A mesh
  signature names the device kind and the collectives' backend
  (``collectives.backend_of``): a table measured on a card named several
  times (plain copies) never prices NCCL between distinct cards.
* ``estimate_stage_cost``: analytic flops x seconds per flop / devices,
  plus the objective of the intra-op ILP of the merged stage -- in
  seconds where the logical mesh carries a collective calibration, else
  in the ILP's abstract units at the fixed exchange rate
  ``ILP_UNIT_SECONDS``.  Under ``replan_mode != "off"`` a measured stage
  time from the calibration store supersedes it.

``analytic_calibration`` plays the part of the JAX package's
per-generation link table: on distinct H100s ("nccl") the NVLink rate of
``telemetry.perf.GPU_SPECS`` backfills the collective kinds no table
measured (``get_effective_calibration``).  Measured stage profiling
(``refine_costs_measured``) runs the candidate stages on the cards and
times them; it is bounded by ``measured_candidates_limit``.
"""
import dataclasses
import json
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from alpa_tpu_torch.util import node_flops

logger = logging.getLogger(__name__)

#: seconds per flop of the uncalibrated cost model (the JAX package's)
DEFAULT_SEC_PER_FLOP = 1.0 / 100e12
#: the exchange rate of the ILP's abstract units into the cost's seconds
#: on an uncalibrated logical mesh
ILP_UNIT_SECONDS = 1e-7
#: seconds the ILP of one candidate stage may take (the JAX package's)
STAGE_ILP_TIME_LIMIT = 10

#: optimizer-state bytes per parameter byte (Adam-family: mu + nu)
OPT_STATE_MULT = 2.0

COLLECTIVE_KINDS = ("all_reduce", "all_gather", "reduce_scatter",
                    "all_to_all")

#: version stamp of saved profiling databases (the JAX package's)
PROF_DB_SCHEMA_VERSION = 1

# (kind, key) pairs already warned for out-of-range lookups
_warned_out_of_range: set = set()


@dataclasses.dataclass
class CalibratedCostModel:
    """Fitted from a ``MeshProfilingResult``; all values in seconds.

    ``dot_points``: sorted (flops, sec/flop) samples (a matmul's
    efficiency depends on its size).  ``collective_ab``: kind -> (alpha
    latency s, beta s/byte), fitted by least squares on t = alpha + beta
    * ring_bytes.  ``backend``: the collectives' backend the table was
    measured over ("nccl", "plain"; None: any), which a logical mesh
    checks before it prices with it."""
    dot_points: List[Tuple[float, float]]
    collective_ab: Dict[str, Tuple[float, float]]
    backend: Optional[str] = None

    def __post_init__(self):
        pts = sorted(self.dot_points)
        self._dot_xs = np.array([p[0] for p in pts], float)
        self._dot_ys = np.array([p[1] for p in pts], float)

    def sec_per_flop(self, flops: float = 1e12) -> float:
        if not len(self._dot_xs):
            return DEFAULT_SEC_PER_FLOP
        return float(np.interp(flops, self._dot_xs, self._dot_ys))

    def alpha_beta(self, kind: str) -> Optional[Tuple[float, float]]:
        return self.collective_ab.get(kind)


class MeshProfilingResult:
    """Measured costs of one mesh signature.  Collective entries record
    (ring_bytes, seconds), ring_bytes already carrying the ring factor,
    so alpha-beta fits transfer across axis sizes."""

    def __init__(self):
        self.dot_cost_dict: Dict[Tuple, List] = {}
        self.all_reduce_cost_dict: Dict[Tuple, List] = {}
        self.all_gather_cost_dict: Dict[Tuple, List] = {}
        self.reduce_scatter_cost_dict: Dict[Tuple, List] = {}
        self.all_to_all_cost_dict: Dict[Tuple, List] = {}

    def record(self, kind: str, key: Tuple, size: float, seconds: float):
        getattr(self, f"{kind}_cost_dict").setdefault(tuple(key), []).append(
            (float(size), float(seconds)))

    def estimate(self, kind: str, key: Tuple, size: float) -> Optional[float]:
        """Linear interpolation on the measured (size, time) points; a
        lookup outside the measured range warns once per (kind, key)."""
        points = getattr(self, f"{kind}_cost_dict").get(tuple(key))
        if not points:
            return None
        points = sorted(points)
        sizes = np.array([p[0] for p in points], dtype=float)
        times = np.array([p[1] for p in points], dtype=float)
        if size < sizes[0] or size > sizes[-1]:
            wkey = (kind, tuple(key))
            if wkey not in _warned_out_of_range:
                _warned_out_of_range.add(wkey)
                logger.warning(
                    "profiling DB lookup out of measured range: kind=%s "
                    "key=%s size=%.3g not in [%.3g, %.3g] -- clamping to "
                    "the nearest profiled entry", kind, tuple(key), size,
                    sizes[0], sizes[-1])
        return float(np.interp(size, sizes, times))

    def fit(self) -> CalibratedCostModel:
        """Least-squares alpha-beta per collective kind and the dot
        efficiency curve."""
        dot_points = []
        for points in self.dot_cost_dict.values():
            for flops, sec in points:
                if flops > 0:
                    dot_points.append((float(flops), sec / flops))
        ab = {}
        for kind in COLLECTIVE_KINDS:
            pts = []
            for points in getattr(self, f"{kind}_cost_dict").values():
                pts.extend(points)
            if len(pts) >= 2:
                x = np.array([p[0] for p in pts], float)
                y = np.array([p[1] for p in pts], float)
                A = np.stack([np.ones_like(x), x], axis=1)
                (alpha, beta), *_ = np.linalg.lstsq(A, y, rcond=None)
                ab[kind] = (max(float(alpha), 0.0), max(float(beta), 1e-15))
            elif len(pts) == 1:
                size, sec = pts[0]
                ab[kind] = (0.0, max(sec / max(size, 1.0), 1e-15))
        return CalibratedCostModel(sorted(dot_points), ab)

    def to_json(self) -> Dict:
        out = {}
        for kind in ("dot",) + COLLECTIVE_KINDS:
            d = getattr(self, f"{kind}_cost_dict")
            out[kind] = {json.dumps(list(k)): v for k, v in d.items()}
        return out

    @classmethod
    def from_json(cls, data: Dict) -> "MeshProfilingResult":
        r = cls()
        for kind in ("dot",) + COLLECTIVE_KINDS:
            d = {}
            for k, v in data.get(kind, {}).items():
                d[tuple(json.loads(k))] = [tuple(p) for p in v]
            setattr(r, f"{kind}_cost_dict", d)
        return r


class ProfilingResultDatabase:
    """Mesh signature -> ``MeshProfilingResult``.  A signature is
    ``"<hosts>x<devices>-<device kind>-<backend>"`` (``mesh_signature``)."""

    def __init__(self, data: Optional[Dict] = None):
        self.data: Dict[str, MeshProfilingResult] = data or {}

    def query(self, cluster_key: str) -> Optional[MeshProfilingResult]:
        return self.data.get(cluster_key)

    def best_result(self, backend: Optional[str] = None
                    ) -> Optional[MeshProfilingResult]:
        """The entry with the most dot samples, among the signatures of
        ``backend`` where it is given."""
        best = self.best_entry(backend)
        return best[1] if best else None

    def best_entry(self, backend: Optional[str] = None
                   ) -> Optional[Tuple[str, MeshProfilingResult]]:
        """``(signature, result)`` of ``best_result``."""
        best = None
        for key, res in self.data.items():
            if backend is not None and not key.endswith(f"-{backend}"):
                continue
            n = sum(len(v) for v in res.dot_cost_dict.values())
            if best is None or n > best[0]:
                best = (n, key, res)
        return best[1:] if best else None

    def update_one_mesh(self, cluster_key: str,
                        result: MeshProfilingResult):
        self.data[cluster_key] = result

    def save(self, filename: str):
        with open(filename, "w", encoding="utf-8") as f:
            json.dump({"schema_version": PROF_DB_SCHEMA_VERSION,
                       "meshes": {k: v.to_json()
                                  for k, v in self.data.items()}}, f,
                      indent=1)

    @classmethod
    def load(cls, filename: str) -> "ProfilingResultDatabase":
        """Load a database; a file without the stamp (the legacy layout)
        loads with a warning."""
        with open(filename, encoding="utf-8") as f:
            raw = json.load(f)
        if "schema_version" in raw:
            version = raw["schema_version"]
            if version != PROF_DB_SCHEMA_VERSION:
                logger.warning(
                    "profiling DB %s has schema_version=%s (this build "
                    "reads %s); attempting to load anyway", filename,
                    version, PROF_DB_SCHEMA_VERSION)
            meshes = raw.get("meshes", {})
        else:
            logger.warning(
                "profiling DB %s has no schema_version stamp (legacy "
                "layout); re-save it to stamp schema_version=%s",
                filename, PROF_DB_SCHEMA_VERSION)
            meshes = raw
        return cls({k: MeshProfilingResult.from_json(v)
                    for k, v in meshes.items()})


########################################
# the analytic calibration per card
########################################

#: the latency charged per collective call over NVLink in the analytic
#: table (a launch; the measured tables replace it)
NVLINK_ALPHA_S = 10e-6

# matmul efficiency ladder of the analytic dot curve: small products
# underfeed the tensor cores, large ones approach the peak
_ANALYTIC_DOT_EFFICIENCY = ((1e8, 0.15), (1e10, 0.40), (1e12, 0.55),
                            (1e14, 0.60))


def analytic_calibration(generation: str = "h100-sxm"
                         ) -> CalibratedCostModel:
    """A ``CalibratedCostModel`` from the card's published rates
    (``telemetry.perf.GPU_SPECS``): every collective kind at
    ``NVLINK_ALPHA_S`` and one over the NVLink bandwidth one way (NVIDIA's
    H100 SXM data sheet: 900 GB/s NVLink 4 per card, both directions
    together); the dot curve the bf16 peak scaled by the efficiency
    ladder."""
    from alpa_tpu_torch.telemetry.perf import GPU_SPECS
    spec = GPU_SPECS[generation]
    beta = 1.0 / spec["nvlink_bytes_per_s"]
    ab = {kind: (NVLINK_ALPHA_S, beta) for kind in COLLECTIVE_KINDS}
    peak = spec["peak_bf16_tflops"] * 1e12
    dot_points = [(flops, 1.0 / (eff * peak))
                  for flops, eff in _ANALYTIC_DOT_EFFICIENCY]
    return CalibratedCostModel(dot_points, ab, backend="nccl")


def merge_calibrations(primary: Optional[CalibratedCostModel],
                       fallback: CalibratedCostModel) -> CalibratedCostModel:
    """Measured entries win; the fallback fills what was never measured
    (the dot curve or single collective kinds)."""
    if primary is None:
        return fallback
    dot = primary.dot_points or fallback.dot_points
    ab = dict(fallback.collective_ab)
    ab.update(primary.collective_ab)
    return CalibratedCostModel(dot, ab, primary.backend or fallback.backend)


def get_effective_calibration(platform: Optional[str] = None,
                              backend: Optional[str] = None
                              ) -> Optional[CalibratedCostModel]:
    """The calibration cost queries use: the configured database; on
    distinct cards (``platform`` "cuda" with ``backend`` "nccl")
    backfilled with the card's analytic NVLink table.  Any other platform
    or backend (the host, a card named several times) gets the measured
    database as it is, never an NVLink table."""
    cal = get_global_calibration()
    if platform is None:
        platform = "cuda" if torch.cuda.is_available() else "cpu"
    if platform != "cuda" or backend != "nccl":
        return cal
    from alpa_tpu_torch.telemetry.perf import detect_gpu_generation
    try:
        gen = detect_gpu_generation()
    except ValueError:
        return cal
    return merge_calibrations(cal, analytic_calibration(gen))


# ---- the process-wide calibration ----
_global_calibration: Optional[CalibratedCostModel] = None
_calibration_explicit = False
_calibration_loaded_from: Optional[Any] = None


def calibration_from_file(fname: str, backend: Optional[str] = None
                          ) -> Optional[CalibratedCostModel]:
    """Load and fit a profiling database (its entries of ``backend``
    where given); None, with a warning, on failure."""
    try:
        entry = ProfilingResultDatabase.load(fname).best_entry(backend)
        if entry is None:
            return None
        key, res = entry
        cal = res.fit()
        cal.backend = key.rsplit("-", 1)[-1] if key.count("-") >= 2 \
            else None
        logger.info("loaded profiling DB %s (sec/flop@1T=%.3e)", fname,
                    cal.sec_per_flop())
        return cal
    except Exception as e:  # pylint: disable=broad-except
        logger.warning("loading profiling DB %s failed: %s", fname, e)
        return None


def set_global_calibration(model: Optional[CalibratedCostModel]):
    global _global_calibration, _calibration_explicit
    _global_calibration = model
    _calibration_explicit = True


def reset_global_calibration():
    """Back to ``global_config.profiling_database_filename`` (tests)."""
    global _global_calibration, _calibration_explicit, \
        _calibration_loaded_from
    _global_calibration = None
    _calibration_explicit = False
    _calibration_loaded_from = None


def get_global_calibration() -> Optional[CalibratedCostModel]:
    """The process-wide calibration: ``set_global_calibration``'s, else
    the fit of ``global_config.profiling_database_filename`` (re-read when
    the file or the name changes); None without either, and then every
    plan is the uncalibrated one."""
    global _global_calibration, _calibration_loaded_from
    if _calibration_explicit:
        return _global_calibration
    import os
    from alpa_tpu_torch.global_env import global_config
    fname = global_config.profiling_database_filename
    try:
        st = os.stat(fname) if fname else None
        ident = (st.st_mtime_ns, st.st_size) if st else None
    except OSError:
        ident = None
    key = (fname, ident)
    if key != _calibration_loaded_from:
        _calibration_loaded_from = key
        _global_calibration = calibration_from_file(fname) if fname else None
    return _global_calibration


########################################
# profiling on the devices
########################################


def device_kind(device) -> str:
    """A device's kind for the database's keys: the ``GPU_SPECS`` key of a
    known card, else its CUDA name, or "cpu"."""
    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    from alpa_tpu_torch.telemetry.perf import detect_gpu_generation
    try:
        return detect_gpu_generation(device)
    except ValueError:
        return torch.cuda.get_device_name(device).replace(" ", "_")


def mesh_signature(devices) -> str:
    """``"1x<n>-<device kind>-<backend>"`` of a one-host mesh's devices."""
    from alpa_tpu_torch.shard_parallel.collectives import backend_of
    devices = [torch.device(d) for d in devices]
    return (f"1x{len(devices)}-{device_kind(devices[0])}-"
            f"{backend_of(devices)}")


def _timer(device):
    """``time(fn, repeat)``: seconds per call of ``fn`` -- CUDA events on
    the device's current stream, the host clock on the CPU."""
    device = torch.device(device)

    def time_fn(fn, repeat: int = 5, warmup: int = 2) -> float:
        for _ in range(warmup):
            fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            s = torch.cuda.current_stream(device)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(s)
            for _ in range(repeat):
                fn()
            end.record(s)
            end.synchronize()
            return start.elapsed_time(end) * 1e-3 / repeat
        tic = time.perf_counter()
        for _ in range(repeat):
            fn()
        return (time.perf_counter() - tic) / repeat
    return time_fn


def profile_one_mesh(devices, sizes=tuple(1 << k for k in (10, 14, 18, 22,
                                                            26, 28)),
                     dot_ns=(512, 1024, 2048, 4096),
                     dtype: Optional[torch.dtype] = None,
                     repeat: int = 5) -> MeshProfilingResult:
    """Matmul and collective times on a mesh's ``devices`` (a one-host
    list, a card named several times allowed): a chain of ``repeat``
    products ``n x n @ n x n`` per size on the first device, and each
    collective kind of ``shard_parallel.collectives`` over all the
    devices, from ``sizes`` bytes of fp32 per device.  CUDA events on a
    card, the host clock on the CPU; keys carry the dtype, the group size
    and the backend."""
    from alpa_tpu_torch.shard_parallel import collectives
    devices = [torch.device(d) for d in devices]
    first = devices[0]
    time_fn = _timer(first)
    result = MeshProfilingResult()
    dtype = dtype or (torch.bfloat16 if first.type == "cuda"
                      else torch.float32)
    dname = str(dtype).replace("torch.", "")
    gen = torch.Generator(device="cpu").manual_seed(0)
    for n in dot_ns:
        a = (torch.randn(n, n, generator=gen) * 0.01).to(first, dtype)
        b = (torch.randn(n, n, generator=gen) * 0.01).to(first, dtype)
        sec = time_fn(lambda: torch.matmul(a, b), repeat)
        result.record("dot", (dname,), 2.0 * n ** 3, max(sec, 1e-9))
        del a, b
    n = len(devices)
    if n > 1:
        backend = collectives.backend_of(devices)
        for size in sizes:
            elems = -(-max(size // 4, n * n) // (n * n)) * (n * n)
            xs = [torch.zeros(elems // n, dtype=torch.float32, device=d)
                  for d in devices]
            nbytes = float(elems * 4)
            ring = (n - 1) / n
            block = nbytes / n
            runs = {
                "all_reduce": (lambda: collectives.all_reduce(xs, devices),
                               2 * ring * block),
                "all_gather": (lambda: collectives.all_gather(
                    xs, devices, 0), ring * nbytes),
                "reduce_scatter": (lambda: collectives.reduce_scatter(
                    xs, devices, 0), ring * block),
                "all_to_all": (lambda: collectives.all_to_all(
                    xs, devices, 0, 0), ring * block),
            }
            for kind, (fn, wire) in runs.items():
                result.record(kind, ("f32", n, backend), wire,
                              _sync_all(fn, devices, time_fn, repeat))
            del xs
    return result


def _sync_all(fn, devices, time_fn, repeat) -> float:
    """Seconds per call of a collective ``fn`` over ``devices``: timed on
    the first device's stream with the other cards synchronised after
    each call, so the time covers every card's part."""
    others = [d for d in dict.fromkeys(devices)
              if d.type == "cuda" and d != devices[0]]

    def call():
        fn()
        for d in others:
            torch.cuda.synchronize(d)
    return time_fn(call, repeat)


def profile_all(cluster, filename: Optional[str] = None,
                **kwargs) -> ProfilingResultDatabase:
    """Profile the cluster's physical mesh (one host) into a database
    under its ``mesh_signature``, saved to ``filename`` where given."""
    db = ProfilingResultDatabase()
    mesh = cluster.get_physical_mesh()
    devices = list(mesh.devices.flat)
    db.update_one_mesh(mesh_signature(devices),
                       profile_one_mesh(devices, **kwargs))
    if filename:
        db.save(filename)
    return db


########################################
# the static stage cost model
########################################


def estimate_stage_cost(stage_comps, logical_mesh, as_option,
                        use_ilp: bool = True,
                        info: Optional[dict] = None,
                        sec_per_flop: Any = None) -> float:
    """The cost of the layer computations ``stage_comps`` merged into one
    stage on ``logical_mesh``: flops x seconds per flop / devices (the
    calibration's curve at the per-device flops where there is one, a
    callable ``sec_per_flop`` likewise, else ``DEFAULT_SEC_PER_FLOP``),
    plus, on more than one device (and with ``use_ilp``), the objective of
    the ILP of the merged stage's strategy graph (no input taken as
    batch): seconds on a calibrated logical mesh, else its abstract units
    x ``ILP_UNIT_SECONDS``.  Under ``replan_mode != "off"`` a measured
    time of a stage of these flops on this many devices in the
    calibration store (``stage_cost_signature``) replaces the estimate
    once it has ``calibration_min_samples``; the estimate is recorded
    beside it.  ``info``, when given, accumulates the ILP solves and
    their seconds."""
    from alpa_tpu_torch.pipeline_parallel.computation import \
        merge_computations
    from alpa_tpu_torch.shard_parallel.ilp import (solution_cost,
                                                   solve_strategy_graph)
    from alpa_tpu_torch.shard_parallel.sharding_spec import Aval
    from alpa_tpu_torch.shard_parallel.strategy import build_strategy_graph
    from alpa_tpu_torch.telemetry import calibration as _calibration
    from alpa_tpu_torch.telemetry import trace as _ttrace
    comp = (merge_computations(stage_comps, "cost_probe")
            if len(stage_comps) > 1 else stage_comps[0])
    flops = sum(node_flops(n) for n in comp.nodes)
    n_dev = logical_mesh.num_devices
    if sec_per_flop is None:
        cal = getattr(logical_mesh, "calibration", None) or \
            get_global_calibration()
        sec_per_flop = (cal.sec_per_flop(flops / max(n_dev, 1))
                        if cal is not None else DEFAULT_SEC_PER_FLOP)
    elif callable(sec_per_flop):
        sec_per_flop = sec_per_flop(flops / max(n_dev, 1))
    compute = flops * sec_per_flop / max(n_dev, 1)
    comm = 0.0
    if use_ilp and n_dev > 1:
        tic = time.perf_counter()
        with _ttrace.span("stage-cost-ilp", "compile",
                          {"devices": n_dev} if _ttrace.enabled() else None):
            avals = [Aval(tuple(v.meta["val"].shape), v.meta["val"].dtype)
                     for v in comp.invars]
            graph = build_strategy_graph(comp.to_graph(), avals,
                                         logical_mesh, [], as_option)
            choice = solve_strategy_graph(graph, STAGE_ILP_TIME_LIMIT)
            units = solution_cost(graph, choice)
        comm = units if getattr(logical_mesh, "calibrated", False) else \
            units * ILP_UNIT_SECONDS
        if info is not None:
            info["ilp_solves"] = info.get("ilp_solves", 0) + 1
            info["ilp_seconds"] = (info.get("ilp_seconds", 0.0) +
                                   time.perf_counter() - tic)
    analytic = compute + comm
    if _calibration.replan_active():
        store = _calibration.get_calibration_store()
        sig = _calibration.stage_cost_signature(flops, n_dev)
        store.set_modeled("stage_run", sig, analytic * 1e6)
        measured = store.measured_us("stage_run", sig)
        if measured is not None:
            return measured * 1e-6
    return analytic


def _bytes(v) -> float:
    val = v.meta.get("val")
    if not isinstance(val, torch.Tensor):
        return 0.0
    return float(max(val.numel(), 1)) * val.element_size()


def estimate_stage_memory_split(stage_comps, num_devices: int,
                                objective: str = "training"
                                ) -> Tuple[float, float]:
    """(per-device parameter bytes, per-device bytes of one microbatch's
    activations) of the layer computations ``stage_comps`` on a submesh of
    ``num_devices``, which the stage DP combines as ``param + inflight(s) *
    act``.

    Parameters are the stage's inputs that none of its computations
    produce, each counted once; activations are the values its
    computations produce, each counted once, except those that merely pass
    through (an input of the stage).  For ``objective="training"`` the
    parameter term carries the optimizer state (``OPT_STATE_MULT`` x the
    parameter bytes), divided over the submesh as the JAX package's
    default, ZeRO "auto", divides it; a forward-only pipeline
    (``"inference"``) holds none.  Both terms divide by the submesh's
    devices."""
    produced = {v for c in stage_comps for v in c.outvars}
    stage_inputs = set()
    param_bytes = 0.0
    for c in stage_comps:
        for v in c.invars:
            if v in produced or v in stage_inputs:
                continue
            stage_inputs.add(v)
            param_bytes += _bytes(v)
    act_bytes, counted = 0.0, set()
    for c in stage_comps:
        for v in c.outvars:
            if v in counted or v in stage_inputs:
                continue
            counted.add(v)
            act_bytes += _bytes(v)
    n = max(num_devices, 1)
    opt_bytes = (OPT_STATE_MULT * param_bytes / n if objective == "training"
                 else 0.0)
    return param_bytes / n + opt_bytes, act_bytes / n


########################################
# measured stage profiling (opt-in)
########################################


def compile_stage_candidate(stage_comps, num_devices: int, as_option,
                            root, devices):
    """One candidate stage, runnable on the first ``num_devices`` of
    ``devices``: its merged graph on one device, or on several the SPMD
    stage executable its intra-op plan gives (the planner the final
    compile runs, so the time includes its collectives).  Returns
    ``(run, args)``, its inputs zeros on the devices."""
    from alpa_tpu_torch.pipeline_parallel.computation import \
        merge_computations
    comp = (merge_computations(list(stage_comps), "profile_probe")
            if len(stage_comps) > 1 else stage_comps[0])
    devices = [torch.device(d) for d in devices][:num_devices]
    if len(devices) < num_devices:
        raise ValueError(f"cannot profile a {num_devices}-device candidate "
                         f"on {len(devices)} devices")
    vals = [v.meta["val"] for v in comp.invars]
    if num_devices == 1:
        module = comp.get_runnable(root, devices[0])
        args = [torch.zeros(tuple(v.shape), dtype=v.dtype,
                            device=devices[0]) for v in vals]

        def run():
            with torch.no_grad():
                return module(*args)
        return run, args
    import numpy as np_
    from alpa_tpu_torch.device_mesh import PhysicalDeviceMesh
    from alpa_tpu_torch.pipeline_parallel.pipeshard_executable import (
        SpmdStageExecutable, _distribute_full)
    mesh = PhysicalDeviceMesh(np_.array(devices, dtype=object).reshape(
        1, num_devices))
    ex = SpmdStageExecutable(comp, 0, mesh, np_.arange(num_devices), root,
                             as_option, None, {}, [""] * len(vals))
    ex.compile()
    used: set = set()
    args = [_distribute_full(torch.zeros(tuple(v.shape), dtype=v.dtype,
                                         device=devices[0]), spec,
                             ex.logical_mesh, used)
            for v, spec in zip(vals, ex.in_specs)]

    def run():
        with torch.no_grad():
            return ex(args)
    return run, args


def time_compiled_candidate(run, args, devices, niter: int = 3) -> float:
    """Seconds of one call of a compiled candidate: CUDA events on the
    first device's stream with every card synchronised after each call
    (the host clock on the CPU), after one warm-up call."""
    devices = [torch.device(d) for d in devices]
    return _sync_all(run, devices, _timer(devices[0]), niter)


def profile_stage_cost(stage_comps, num_devices: int, as_option, root,
                       devices, niter: int = 3) -> float:
    """Compile and time one candidate stage (zero inputs)."""
    run, args = compile_stage_candidate(stage_comps, num_devices, as_option,
                                        root, devices)
    return time_compiled_candidate(run, args, devices[:num_devices], niter)


def shortlist_candidates(costs, submesh_sizes, n_avail, limit: int):
    """The candidates to measure, bucketed by (span length, submesh) and
    taken round-robin over the buckets in modeled-cost order until
    ``limit``, so refinement touches the spans the DP considers."""
    L, _, M = costs.shape
    buckets: Dict[Tuple[int, int], List[Tuple[float, int, int, int]]] = {}
    for i in range(L):
        for j in range(i, L):
            for m in range(M):
                if np.isfinite(costs[i, j, m]) and \
                        submesh_sizes[m] <= n_avail:
                    buckets.setdefault((j - i, m), []).append(
                        (costs[i, j, m], i, j, m))
    for b in buckets.values():
        b.sort()
    out = []
    rank = 0
    while len(out) < limit and any(len(b) > rank for b in buckets.values()):
        for key in sorted(buckets):
            b = buckets[key]
            if rank < len(b) and len(out) < limit:
                out.append(b[rank])
        rank += 1
    return out


def refine_costs_measured(costs, layer_comps, submesh_sizes, as_option,
                          root, devices, limit: int = 16,
                          compile_workers: int = 4) -> int:
    """Replace the most promising entries of the cost tensor by measured
    seconds: ``shortlist_candidates`` picks up to ``limit``, their plans
    are made on a pool of ``compile_workers`` threads, and each is then
    built and timed alone, one after another (timing two at once would
    share the card).  A candidate that fails -- out of memory included --
    raises: a measured run must not fall back to the cost model.  Returns
    the entries refined."""
    import concurrent.futures
    devices = [torch.device(d) for d in devices]
    cands = shortlist_candidates(costs, submesh_sizes, len(devices), limit)
    if not cands:
        return 0

    def merged(i, j):
        from alpa_tpu_torch.pipeline_parallel.computation import \
            merge_computations
        comps = layer_comps[i:j + 1]
        return [merge_computations(list(comps), "profile_probe")
                if len(comps) > 1 else comps[0]]
    with concurrent.futures.ThreadPoolExecutor(compile_workers) as pool:
        spans = dict(zip([(i, j, m) for _, i, j, m in cands], pool.map(
            lambda c: merged(c[1], c[2]), cands)))
    refined = 0
    for (i, j, m), comps in sorted(spans.items()):
        n = int(submesh_sizes[m])
        costs[i, j, m] = profile_stage_cost(comps, n, as_option, root,
                                            devices)
        refined += 1
        if devices[0].type == "cuda":
            torch.cuda.empty_cache()
    return refined
