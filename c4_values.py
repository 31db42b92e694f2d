"""ROADMAP C.4's value-by-value step: phase 16's first step (GPT-1.3B,
bf16, 4 microbatches, two stages of two devices; ``chip_smoke.py``'s
``two_level_method``) on ``[c0, c1, c0, c1]`` and on ``[c0] * 4`` from the
same state and batch, with the refusal of stages over distinct cards
lifted in this process only.  Stage 0's backward calls are recorded per
microbatch, and its partitioned program is replayed node by node on both
plans from the recorded inputs.  It prints the first stage input that is
not bit-equal between the two runs, the first microbatch whose
accumulators differ beyond 1e-2, the first node whose value differs
beyond 1e-2 (its aten target, its devices, its inputs and the factories
and constants it reads), and each replay against its run's outputs.  It
reports and does not fail on a difference, since finding one is its
purpose.

Run on a machine with two or more CUDA cards, from the root of a
checkout: ``python3 c4_values.py`` (about 7 minutes on H100s)."""
import contextlib
import gc
import sys

import torch

import chip_smoke as smoke


@contextlib.contextmanager
def recorded_stage_calls(stage_filter, calls):
    """Each call of a ``SpmdStageExecutable`` that ``stage_filter`` picks,
    appended to ``calls`` as ``(stage, inputs, outputs)``: per input and
    output its per-device values copied to the host (the inputs before the
    call writes its donated accumulators), in this process only."""
    from alpa_tpu_torch.pipeline_parallel import pipeshard_executable as pe
    from alpa_tpu_torch.pipeline_parallel.cross_mesh_resharding import \
        as_shards

    def host(values):
        return [[t.detach().to("cpu", copy=True) for t in as_shards(v)]
                for v in values]

    def make(orig):
        def call(self, args):
            if not stage_filter(self):
                return orig(self, args)
            inputs = host(args)
            outs = orig(self, args)
            calls.append((self, inputs, host(outs)))
            return outs
        return call
    with smoke.wrapped(pe.SpmdStageExecutable, "__call__", make):
        yield


@contextlib.contextmanager
def kept_layouts():
    """Every node the SPMD partitioner emits keeps the ``Layout`` (spec,
    partial axes) of the traced value it realises, as
    ``meta["c4_layout"]``, and ``meta["c4_val"]``, that value's global
    meta, in this process only."""
    from alpa_tpu_torch.shard_parallel import spmd_partition as sp

    def make(orig):
        def set_(self, key, node, layout):
            if isinstance(node, torch.fx.Node):
                node.meta.setdefault("c4_layout", layout)
                node.meta.setdefault("c4_val", self.gval(key))
            return orig(self, key, node, layout)
        return set_
    with smoke.wrapped(sp.Partitioner, "set", make):
        yield


def lockstep_values(program, inputs):
    """The partitioned ``program`` (a stage's ``SpmdProgram``) run node by
    node over its devices from ``inputs`` (per input, its per-device
    values on the host), as ``torch.fx.Interpreter`` runs a graph, each
    segment op on its device with the devices it names retargeted there
    (as ``PipelineComputation.get_runnable`` does) and each collective
    over all devices.  Yields ``(node, per-device values, per-device
    (args, kwargs) of a segment op or None)``; a value is dropped after
    its last reader."""
    from alpa_tpu_torch.shard_parallel.collectives import run_collective
    from alpa_tpu_torch.shard_parallel.spmd_partition import (collective,
                                                              external)
    devices = program.devices
    nodes = list(program.root.graph.nodes)
    last = {}
    for i, n in enumerate(nodes):
        for a in n.all_input_nodes:
            last[a] = i
    env = [dict() for _ in devices]
    for p, device in enumerate(devices):
        for ph, vals in zip(program.placeholders, inputs):
            env[p][ph] = vals[p].to(device)
        env[p][program.coords_node] = program.coords[p]

    def on(p, x):
        return devices[p] if isinstance(x, torch.device) else x
    for i, node in enumerate(nodes):
        called = None
        if node.op == "placeholder":
            continue
        if node.op == "output":
            yield node, [[e[o] if isinstance(o, torch.fx.Node) else o
                          for o in program.outputs] for e in env], None
            return
        if node.op == "get_attr":
            const = getattr(program.root, node.target)
            for p, device in enumerate(devices):
                env[p][node] = const.to(device)
        elif node.target is collective:
            x = node.args[1]
            ys = run_collective(program.records[node.args[0]],
                                [env[p][x] for p in range(len(devices))],
                                program.logical_mesh)
            for p, y in enumerate(ys):
                env[p][node] = y
        elif node.target is external:
            raise smoke.SmokeFailure(
                f"C.4 values: {node} reads an external value")
        else:
            called = []
            for p, device in enumerate(devices):
                args = torch.fx.node.map_arg(node.args, lambda a: env[p][a])
                kwargs = torch.fx.node.map_arg(node.kwargs,
                                               lambda a: env[p][a])
                args = torch.fx.node.map_aggregate(args, lambda x: on(p, x))
                kwargs = torch.fx.node.map_aggregate(kwargs,
                                                     lambda x: on(p, x))
                ctx = (torch.cuda.device(device) if device.type == "cuda"
                       else contextlib.nullcontext())
                with ctx, torch.no_grad():
                    env[p][node] = node.target(*args, **kwargs)
                called.append((args, kwargs))
        yield node, [env[p][node] for p in range(len(devices))], called
        for a in node.all_input_nodes:
            if last.get(a) == i and a.op != "placeholder":
                for e in env:
                    e.pop(a, None)


def c4_value(program, node, values, device) -> torch.Tensor:
    """A node's value for the comparison, on ``device`` in fp32: gathered by
    its spec where the partitioner left it complete (``kept_layouts``),
    else its per-device values side by side."""
    from alpa_tpu_torch.device_mesh import DistributedArray
    lay, val = node.meta.get("c4_layout"), node.meta.get("c4_val")
    tensors = [v for v in values if isinstance(v, torch.Tensor)]
    if len(tensors) != len(values):
        return None
    if lay is not None and not lay.partial and \
            isinstance(val, torch.Tensor) and \
            len(lay.spec) == val.dim():
        try:
            return DistributedArray(tensors, lay.spec, program.logical_mesh,
                                    tuple(val.shape), tensors[0].dtype
                                    ).gather(device).float()
        except (RuntimeError, ValueError, IndexError):
            pass
    return torch.cat([t.detach().reshape(-1).to(device, torch.float32)
                      for t in tensors])


def flat_tensors(v):
    """The tensors of a value (a tensor, or a tuple or list of them)."""
    if isinstance(v, torch.Tensor):
        return [v]
    if isinstance(v, (tuple, list)):
        return [t for x in v for t in flat_tensors(x)]
    return []


def c4_first_inexact(node, va, vb, called, device):
    """None where every device's value of ``node`` is bit-equal in the two
    runs (``va``, ``vb``); else a line naming it, its largest difference,
    and, for a segment op, whether the same op on ``device`` from the
    two-card run's inputs of the differing device gives that device's
    value bit for bit (the op does not depend on the card it runs on) or
    the one-card run's."""
    device = torch.device(device)
    for p, (xa, xb) in enumerate(zip(va, vb)):
        ta, tb = flat_tensors(xa), flat_tensors(xb)
        if len(ta) != len(tb) or not ta:
            continue
        ta = [t.to(device) for t in ta]
        tb = [t.to(device) for t in tb]
        if all(torch.equal(a, b) for a, b in zip(ta, tb)):
            continue
        diff = max(float((a.float() - b.float()).abs().max())
                   for a, b in zip(ta, tb))
        line = (f"{c4_node_line(node, va)} (args "
                f"{[str(a) for a in node.args][:4]}); device position {p}: "
                f"max |diff| {diff:.3e}")
        if called:
            args, kwargs = called[p]

            def moved(x):
                if isinstance(x, torch.Tensor):
                    return x.to(device)
                return device if isinstance(x, torch.device) else x
            args = torch.fx.node.map_aggregate(args, moved)
            kwargs = torch.fx.node.map_aggregate(kwargs, moved)
            ctx = (torch.cuda.device(device) if device.type == "cuda"
                   else contextlib.nullcontext())
            with ctx, torch.no_grad():
                again = flat_tensors(node.target(*args, **kwargs))
            as_a = all(torch.equal(x, y) for x, y in zip(again, ta))
            as_b = all(torch.equal(x, y) for x, y in zip(again, tb))
            line += (f"; rerun on {device} from these inputs: equal to the "
                     f"two-card value {as_a}, to the one-card value {as_b}")
        else:
            line += "; a collective"
        return line
    return None


def rel_diff(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| / max |b| (NaN where they disagree in shape)."""
    if a.shape != b.shape:
        return float("nan")
    if a.numel() == 0:
        return 0.0
    scale = float(b.abs().max())
    return float((a - b).abs().max()) / max(scale, 1e-30)


def c4_node_line(node, values) -> str:
    """A node's aten target, the devices of its values and of its inputs,
    and the factories and constants it reads."""
    reads = [a for a in node.all_input_nodes if a.op == "get_attr" or (
        a.op == "call_function" and any(
            isinstance(x, torch.device) for x in torch.fx.node.map_aggregate(
                (a.args, tuple(a.kwargs.values())), lambda x: x)
            if not isinstance(x, (tuple, list))))]
    named = [x for x in (*node.args, *node.kwargs.values())
             if isinstance(x, torch.device)]
    return (f"{node.name} = {node.target} (source {node.meta.get('source')}) "
            f"on {[str(getattr(v, 'device', v)) for v in values]}; inputs "
            f"{[a.name for a in node.all_input_nodes]}; factories or "
            f"constants read {[(a.name, str(a.target)) for a in reads]}; "
            f"devices it names {[str(d) for d in named]}")


def c4_values(devices_a, devices_b, cfg=None):
    """ROADMAP C.4's value-by-value step: phase 16's first step (GPT-1.3B,
    bf16, 4 microbatches) over ``devices_a`` (``[c0, c1, c0, c1]``) and
    the same plan over ``devices_b`` (``[c0] * 4``) from the same state and
    batch; stage 0's backward calls recorded, microbatch by microbatch.
    Prints the first input of each call that differs beyond 1e-2 relative
    (the first microbatch whose accumulators differ), then runs the two
    partitioned backward programs node by node (``lockstep_values``) from
    their own recorded inputs and prints the first node whose value,
    gathered by its spec, differs beyond 1e-2 relative, with its target,
    devices, inputs' devices and the factories and constants it reads;
    also each run's outputs against the lockstep replay's.  Returns the
    first differing node's line (None where none differs)."""
    cfg = cfg or smoke.pipeshard_config(pipeline_boundary_every=12)
    batch = {k: torch.as_tensor(v, device=torch.device(devices_b[0]))
             for k, v in smoke.lm_batch(cfg, 8).items()}
    runs = {}
    for label, devices in (("one card", devices_b), ("two cards", devices_a)):
        calls = []
        with smoke.wide_stages_over_cards(), kept_layouts(), \
                recorded_stage_calls(lambda ex: ex.mesh_id == 0 and
                                     ex.name.endswith("_bwd"), calls):
            state = smoke.train_state(cfg)
            step = smoke.make_train_step(smoke.two_level_method(devices))
            state, loss = step(state, batch)
        print(f"C.4 values {label} {devices}: first loss {float(loss):.6f}, "
              f"{len(calls)} calls of stage 0's backward")
        runs[label] = calls
        del state, step
        gc.collect()
        torch.cuda.empty_cache()
    a_calls, b_calls = runs["two cards"], runs["one card"]
    smoke.check(len(a_calls) == len(b_calls) and a_calls,
                f"C.4 values: {len(a_calls)} and {len(b_calls)} backward "
                "calls")
    stage_a, stage_b = a_calls[0][0], b_calls[0][0]
    pa, pb = stage_a.program, stage_b.program
    same = [str(n.target) for n in pa.root.graph.nodes] == \
        [str(n.target) for n in pb.root.graph.nodes]
    print(f"C.4 values: stage {stage_a.name}, programs of "
          f"{len(pa.root.graph.nodes)} and {len(pb.root.graph.nodes)} nodes, "
          f"{'the same ops' if same else 'different ops'}; logical "
          f"{tuple(pa.logical_mesh.shape)} and {tuple(pb.logical_mesh.shape)}")
    acc_pos = {stage_a.invars.index(acc) for acc in stage_a.acc_out.values()
               if acc in stage_a.invars}
    first_node = None
    first_acc_mb = None
    first_inexact_input = None
    for mb, ((_, ins_a, outs_a), (_, ins_b, outs_b)) in enumerate(
            zip(a_calls, b_calls)):
        bad_in = []
        for j, (xa, xb) in enumerate(zip(ins_a, ins_b)):
            r = rel_diff(torch.cat([t.reshape(-1).float() for t in xa]),
                         torch.cat([t.reshape(-1).float() for t in xb])) \
                if len(xa) == len(xb) else float("nan")
            if not r <= 1e-2:
                bad_in.append((j, r))
        if first_acc_mb is None and any(j in acc_pos for j, _ in bad_in):
            first_acc_mb = mb
        if first_inexact_input is None:
            first_inexact_input = inexact_input(stage_a, mb, ins_a, ins_b,
                                                acc_pos)
        out_real = max((rel_diff(torch.cat([t.reshape(-1).float() for t in
                                            oa]),
                                 torch.cat([t.reshape(-1).float() for t in
                                            ob]))
                        for oa, ob in zip(outs_a, outs_b)), default=0.0)
        named = [(stage_a.invars[j].name,
                  "accumulator" if j in acc_pos else "input", f"{r:.3e}")
                 for j, r in bad_in[:6]]
        print(f"C.4 values microbatch {mb}: inputs differing beyond 1e-2 "
              f"{named} of {len(ins_a)}; the runs' outputs differ by "
              f"{out_real:.3e}")
        if not same:
            continue
        mb_first = None
        n_nodes = 0
        replayed = []
        exact = coarse = None
        for (na, va, ca), (nb, vb, _) in zip(lockstep_values(pa, ins_a),
                                             lockstep_values(pb, ins_b)):
            if na.op == "output":
                replayed = [va, vb]
                break
            n_nodes += 1
            if mb == 0 and exact is None:
                exact = c4_first_inexact(na, va, vb, ca, devices_b[0])
            if mb_first is not None and (coarse is not None or mb):
                continue
            if mb_first is not None:
                xa = c4_value(pa, na, va, devices_b[0])
                xb = c4_value(pb, nb, vb, devices_b[0])
                if xa is not None and xb is not None and \
                        not rel_diff(xa, xb) <= 1e-1:
                    coarse = (f"{c4_node_line(na, va)}: "
                              f"{rel_diff(xa, xb):.3e} relative")
                continue
            xa = c4_value(pa, na, va, devices_b[0])
            xb = c4_value(pb, nb, vb, devices_b[0])
            if xa is None or xb is None:
                continue
            r = rel_diff(xa, xb)
            if not r <= 1e-2:
                mb_first = (f"{c4_node_line(na, va)}: {r:.3e} relative; "
                            f"the one-card run's node "
                            f"{c4_node_line(nb, vb)}")
        # the replay against each run's own outputs: a replay that agrees
        # with the other card's while the run does not puts the fault in
        # how the run executes its program, not in the program
        vs_run = [float("nan")] * 2
        for k, (outs, rep) in enumerate(zip((outs_a, outs_b), replayed)):
            worst = 0.0
            for j, real in enumerate(outs):
                got = [per_dev[j] for per_dev in rep]
                if not all(isinstance(t, torch.Tensor) for t in got):
                    continue
                worst = max(worst, rel_diff(
                    torch.cat([t.reshape(-1).to("cpu", torch.float32)
                               for t in got]),
                    torch.cat([t.reshape(-1).float() for t in real])))
            vs_run[k] = worst
        if mb == 0:
            print(f"C.4 values microbatch 0: first node not bit-equal: "
                  f"{exact or 'none'}; first beyond 1e-1: "
                  f"{coarse or 'none'}")
        print(f"C.4 values microbatch {mb}: {n_nodes} nodes replayed; the "
              f"replay against the run's own outputs: two cards "
              f"{vs_run[0]:.3e}, one card {vs_run[1]:.3e}; first differing "
              f"node beyond 1e-2: {mb_first or 'none'}")
        del replayed
        if first_node is None and mb_first is not None:
            first_node = (mb, mb_first)
    print(f"C.4 values [{smoke.card_line()}]: first stage input not "
          f"bit-equal: {first_inexact_input or 'none'}; first microbatch "
          f"whose accumulators differ: {first_acc_mb}; first differing "
          f"node: {first_node or 'none'}")
    return first_node

def inexact_input(stage, mb, ins_a, ins_b, acc_pos):
    """The first input of ``stage``'s call ``mb`` whose per-device values
    are not bit-equal in the two runs, as ``(microbatch, name, kind,
    max |diff|)``; None where all are."""
    for j, (xa, xb) in enumerate(zip(ins_a, ins_b)):
        if len(xa) == len(xb) and all(
                a.shape == b.shape and torch.equal(a, b)
                for a, b in zip(xa, xb)):
            continue
        diff = max((float((a.float() - b.float()).abs().max())
                    for a, b in zip(xa, xb) if a.shape == b.shape),
                   default=float("nan"))
        return (mb, stage.invars[j].name,
                "accumulator" if j in acc_pos else "input", f"{diff:.3e}")
    return None


def main() -> int:
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        print("FAIL: c4_values.py needs two CUDA cards", file=sys.stderr)
        return 1
    print(f"setup: {smoke.card_line()}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    smoke.build_kernels()
    c0, c1 = "cuda:0", "cuda:1"
    c4_values([c0, c1, c0, c1], [c0] * 4)
    return 0


if __name__ == "__main__":
    sys.exit(main())
