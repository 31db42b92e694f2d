"""Pipeline instructions, per-mesh streams and FREE emission.

Counterpart of part of ``alpa_tpu/pipeline_parallel/runtime_emitter.py``:
the instruction set (``RUN``, ``RESHARD``, ``FREE``), the split of the
global instruction list into per-mesh streams with their cross-stream
dependencies, and ``FREE`` after each value's last use.  A value is keyed
``(node, instance)``: instance is the microbatch for per-microbatch values
and -1 for values shared by all microbatches (parameters, accumulators,
apply-grad results).  The register-file lowering, the race and hazard
checkers, overlap dispatch and the plan superoptimizer are not ported yet
(ROADMAP A.5).
"""
import dataclasses
import enum
from typing import Any, Dict, List, Optional, Tuple


class PipelineInstType(enum.IntEnum):
    RUN = 0
    RESHARD = 1
    FREE = 2


@dataclasses.dataclass
class PipelineInstruction:
    """One step of the static pipeline program."""
    opcode: PipelineInstType
    # RUN
    stage_id: Optional[int] = None
    micro_batch: Optional[int] = None
    input_keys: Optional[List[Tuple[Any, int]]] = None
    output_keys: Optional[List[Tuple[Any, int]]] = None
    # RESHARD (and the mesh a RUN executes on)
    var_key: Optional[Tuple[Any, int]] = None
    src_mesh: Optional[int] = None
    dst_mesh: Optional[int] = None
    # FREE: (node, instance, mesh)
    free_keys: Optional[List[Tuple[Any, int, int]]] = None
    info: str = ""
    # RUN: the stage's runnable
    executable: Any = dataclasses.field(default=None, repr=False)

    def __repr__(self):
        if self.opcode == PipelineInstType.RUN:
            return f"RUN(stage={self.stage_id}, mb={self.micro_batch})"
        if self.opcode == PipelineInstType.RESHARD:
            return (f"RESHARD({self.var_key}, {self.src_mesh}->"
                    f"{self.dst_mesh})")
        return f"FREE({len(self.free_keys)})"


@dataclasses.dataclass
class InstructionStreams:
    """``streams[m]``: the global instruction indices mesh ``m`` executes,
    in order; ``deps[i]``: the indices in other streams instruction ``i``
    waits for (read after write, and write or free after read).  Every
    edge points to an earlier index, so in-order stream workers cannot
    deadlock."""
    streams: List[List[int]]
    deps: Dict[int, set]
    stream_of: Dict[int, int]


def instruction_accesses(inst) -> List[Tuple[Tuple[Any, int, int], str]]:
    """The (value key, "read" | "write" | "kill") pairs an instruction
    touches."""
    if inst.opcode == PipelineInstType.RUN:
        return ([((k[0], k[1], inst.dst_mesh), "read")
                 for k in inst.input_keys] +
                [((k[0], k[1], inst.dst_mesh), "write")
                 for k in inst.output_keys])
    if inst.opcode == PipelineInstType.RESHARD:
        return [((inst.var_key[0], inst.var_key[1], inst.src_mesh), "read"),
                ((inst.var_key[0], inst.var_key[1], inst.dst_mesh), "write")]
    return [(tuple(key), "kill") for key in inst.free_keys]


def partition_streams(instructions: List[PipelineInstruction],
                      num_meshes: int) -> InstructionStreams:
    """Split the global instruction list into per-mesh streams.  RUN and
    RESHARD go to their destination mesh; FREE follows the instruction
    before it (its last user)."""
    streams: List[List[int]] = [[] for _ in range(num_meshes)]
    stream_of: Dict[int, int] = {}
    deps: Dict[int, set] = {}
    history: Dict[Tuple[Any, int, int], List[Tuple[int, int, str]]] = {}
    prev_stream = 0
    for i, inst in enumerate(instructions):
        m = prev_stream if inst.opcode == PipelineInstType.FREE \
            else inst.dst_mesh
        m = m if 0 <= m < num_meshes else 0
        streams[m].append(i)
        stream_of[i] = prev_stream = m
        d = set()
        for key, kind in instruction_accesses(inst):
            hist = history.setdefault(key, [])
            if kind == "read":
                for j, sm, k in reversed(hist):
                    if k in ("write", "kill"):
                        if sm != m:
                            d.add(j)
                        break
            else:
                d.update(j for j, sm, _ in hist if sm != m)
            hist.append((i, m, kind))
        if d:
            deps[i] = d
    return InstructionStreams(streams, deps, stream_of)


def emit_free_instructions(instructions: List[PipelineInstruction],
                           protected_keys) -> List[PipelineInstruction]:
    """Insert a FREE after the last use of each (node, instance, mesh)
    value that an instruction defined and no output needs; inputs placed
    at launch are the driver's."""
    last_use: Dict[Tuple[Any, int, int], int] = {}
    defined = set()
    for i, inst in enumerate(instructions):
        if inst.opcode == PipelineInstType.RUN:
            for k in inst.input_keys:
                last_use[(k[0], k[1], inst.dst_mesh)] = i
            for k in inst.output_keys:
                defined.add((k[0], k[1], inst.dst_mesh))
        elif inst.opcode == PipelineInstType.RESHARD:
            last_use[(inst.var_key[0], inst.var_key[1], inst.src_mesh)] = i
            defined.add((inst.var_key[0], inst.var_key[1], inst.dst_mesh))
    frees_at: Dict[int, List[Tuple[Any, int, int]]] = {}
    for key, i in last_use.items():
        if key in defined and key not in protected_keys:
            frees_at.setdefault(i, []).append(key)
    out: List[PipelineInstruction] = []
    for i, inst in enumerate(instructions):
        out.append(inst)
        if i in frees_at:
            out.append(PipelineInstruction(PipelineInstType.FREE,
                                           free_keys=frees_at[i]))
    return out
