"""Static pipeline schedules: GPipe, 1F1B (PipeDream-flush), inference.

Counterpart of ``alpa_tpu/pipeline_parallel/schedules.py``, near verbatim:
a schedule is a list of clock ticks; each tick lists, per mesh, the
(microbatch_idx, stage_idx) task to run (or None).  Stage->mesh placement
follows the symmetric layout: forward stage i and backward stage (2k-1-i)
run on mesh i.  The JAX package's overlap-window hints belong to its
overlap dispatcher, which is not ported.
"""
from typing import List, Optional, Tuple

import numpy as np

Task = Optional[Tuple[int, int]]  # (microbatch, stage)


class PipelineSchedule:
    """Base class."""

    def __init__(self, *, num_stages: int, num_meshes: int,
                 num_batch: int):
        self.num_stages = num_stages
        self.num_meshes = num_meshes
        self.num_batch = num_batch
        self._schedules: List[List[Task]] = self._generate_schedule()

    @property
    def schedules(self) -> List[List[Task]]:
        return self._schedules

    def _generate_schedule(self):
        raise NotImplementedError

    @property
    def num_clock(self) -> int:
        return len(self._schedules)

    def stage_mesh_mapping(self, stage_idx: int) -> int:
        """Symmetric placement: fwd stage i and bwd stage 2M-1-i on mesh i."""
        m = self.num_meshes
        if stage_idx < m:
            return stage_idx
        if stage_idx < 2 * m:
            return 2 * m - 1 - stage_idx
        # apply-grad stages: stage 2m+i on mesh i
        return stage_idx - 2 * m

    def mesh_stage_mapping(self, mesh_idx: int) -> List[int]:
        return [
            s for s in range(self.num_stages)
            if self.stage_mesh_mapping(s) == mesh_idx
        ]

    def pprint_schedule(self) -> str:
        lines = ["k\t" + "\t".join(f"mesh{i}" for i in range(self.num_meshes))]
        for k, tick in enumerate(self._schedules):
            lines.append(f"{k}\t" + "\t".join(
                (f"b{t[0]}s{t[1]}" if t else "-") for t in tick))
        return "\n".join(lines)

    def overlap_window_hint(self) -> int:
        """The default in-flight transfer window of overlap dispatch: about
        one eagerly launched cross-mesh transfer per pipeline rank."""
        return max(2, min(8, self.num_meshes))


class GpipeSchedule(PipelineSchedule):
    """All forwards, then all backwards."""

    def _generate_schedule(self):
        m, n = self.num_meshes, self.num_batch
        schedules = []
        # forward waves
        num_clock = m + n - 1
        for k in range(num_clock):
            tick: List[Task] = []
            for d in range(m):
                mb = k - d
                tick.append((mb, d) if 0 <= mb < n else None)
            schedules.append(tick)
        # backward waves: bwd stage for mesh d is (2m-1-d)
        for k in range(num_clock):
            tick = []
            for d in range(m):
                mb = k - (m - 1 - d)
                tick.append((mb, 2 * m - 1 - d) if 0 <= mb < n else None)
            schedules.append(tick)
        return schedules


class PipeDreamFlush(PipelineSchedule):
    """1F1B with flush: same latency as GPipe but
    bounded activation memory (at most `m - mesh_idx` in-flight
    microbatches per mesh)."""

    def _warmup_depth(self, mesh_idx: int) -> int:
        return self.num_meshes - mesh_idx - 1

    def _generate_schedule(self):
        m, n = self.num_meshes, self.num_batch
        # per-mesh operation list: ('F'|'B', microbatch)
        per_mesh_ops: List[List[Tuple[str, int]]] = []
        for d in range(m):
            warmup = min(self._warmup_depth(d), n)
            ops = [("F", i) for i in range(warmup)]
            fwd_i, bwd_i = warmup, 0
            # steady 1F1B
            while fwd_i < n:
                ops.append(("F", fwd_i))
                fwd_i += 1
                ops.append(("B", bwd_i))
                bwd_i += 1
            while bwd_i < n:
                ops.append(("B", bwd_i))
                bwd_i += 1
            per_mesh_ops.append(ops)

        # simulate clock ticks with dependency: F(mb,d) needs F(mb,d-1) done;
        # B(mb,d) needs B(mb,d+1) done (and F(mb,d)).
        fwd_done = np.full((n, m), -1)  # clock when done
        bwd_done = np.full((n, m), -1)
        ptr = [0] * m
        schedules = []
        clock = 0
        total_ops = sum(len(o) for o in per_mesh_ops)
        done_ops = 0
        while done_ops < total_ops and clock < 10 * total_ops + 10:
            tick: List[Task] = [None] * m
            for d in range(m):
                if ptr[d] >= len(per_mesh_ops[d]):
                    continue
                kind, mb = per_mesh_ops[d][ptr[d]]
                if kind == "F":
                    ready = d == 0 or (0 <= fwd_done[mb][d - 1] < clock)
                    if ready:
                        tick[d] = (mb, d)
                        fwd_done[mb][d] = clock
                        ptr[d] += 1
                        done_ops += 1
                else:
                    ready_up = (d == m - 1) or (0 <= bwd_done[mb][d + 1] <
                                                clock)
                    ready_fwd = 0 <= fwd_done[mb][d] < clock
                    if ready_up and ready_fwd:
                        tick[d] = (mb, 2 * m - 1 - d)
                        bwd_done[mb][d] = clock
                        ptr[d] += 1
                        done_ops += 1
            schedules.append(tick)
            clock += 1
        if done_ops != total_ops:
            raise RuntimeError("1F1B schedule failed to converge")
        return schedules


class OverlapFriendlyPipeDreamSchedule(PipeDreamFlush):
    """1F1B with a doubled warmup depth: each mesh runs up to
    ``2*(m - d) - 1`` forward microbatches before its first backward, so
    more cross-mesh activations are in flight at once, for transfers to
    overlap with compute.  Trade-off: proportionally more live activation
    memory."""

    def _warmup_depth(self, mesh_idx: int) -> int:
        return 2 * (self.num_meshes - mesh_idx) - 1

    def overlap_window_hint(self) -> int:
        # twice the warmup keeps about twice the activations in flight
        return max(2, min(16, 2 * self.num_meshes))


class InferenceSchedule(PipelineSchedule):
    """Forward-only pipelined batches."""

    def _generate_schedule(self):
        m, n = self.num_meshes, self.num_batch
        schedules = []
        for k in range(m + n - 1):
            tick: List[Task] = []
            for d in range(m):
                mb = k - d
                tick.append((mb, d) if 0 <= mb < n else None)
            schedules.append(tick)
        return schedules

    def stage_mesh_mapping(self, stage_idx: int) -> int:
        if stage_idx < self.num_meshes:
            return stage_idx
        return stage_idx - self.num_meshes


def create_pipeline_schedule(name: str, *, num_stages: int, num_meshes: int,
                             num_batch: int) -> PipelineSchedule:
    """"""
    if name == "1f1b_overlap_friendly":
        return OverlapFriendlyPipeDreamSchedule(num_stages=num_stages,
                                                num_meshes=num_meshes,
                                                num_batch=num_batch)
    if name == "gpipe":
        return GpipeSchedule(num_stages=num_stages, num_meshes=num_meshes,
                             num_batch=num_batch)
    if name in ("1f1b", "pipedream_flush"):
        return PipeDreamFlush(num_stages=num_stages, num_meshes=num_meshes,
                              num_batch=num_batch)
    if name == "inference":
        return InferenceSchedule(num_stages=num_stages,
                                 num_meshes=num_meshes, num_batch=num_batch)
    raise ValueError(f"unknown pipeline schedule: {name}")
