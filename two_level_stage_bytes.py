"""Phase 16's first step (GPT-1.3B in two stages of two virtual devices on
one card; ``chip_smoke.py``'s ``two_level_method``) on the source tree
given, printing per stage the bytes its inputs and outputs take on one
device, by kind (parameters, optimizer state, gradient accumulators,
batch, other values) and by whether they are replicated, the specs of the
values a stage takes from another stage, the collectives of each stage's
partitioned program per run, and the peak.

Run on a machine with one CUDA card, from any directory:
``python3 two_level_stage_bytes.py <tree> [--reference] [--off c5,c6]
[--layers N] [--four-cards]``,
``<tree>`` the root of a checkout (the current one, or an earlier
commit's ``git archive``), to attribute a change of phase 16's peak or
collectives to the stage inputs that moved.  ``--reference``: the
reference attention in place of the flash kernels (the case in which the
second stage's input is sharded on its sequence dim, ROADMAP C.7).
``--layers``: the depth (24, phase 16's; a stage boundary after half).
``--off``: plan as if a repair of ROADMAP §C were not there, by patching
the tree's modules in this process: ``c5`` reads a backward stage's
in-place accumulator add as a plain elementwise add (the accumulator
leads), ``c6`` leaves autograd's saved views of a stage input as the
backward stage's inputs.  ``--four-cards`` (a machine with four cards,
the current tree): the stages over ``cuda:0..3``,
Adam's first moment after the step held to the one-device-per-stage
step's, as ``chip_smoke.py --four-cards`` holds it, to attribute C.4's
fault to a repair's plan change."""
import argparse
import dataclasses
import os
import sys

import numpy as np


def switch_off(repairs):
    """The repairs named in ``repairs`` undone by patching module state."""
    if "c5" in repairs:
        from alpa_tpu_torch.shard_parallel import strategy
        # the tag apply_grad.py sets is then read under another key
        strategy.ACCUMULATES = "accumulates, reading switched off"
    if "c6" in repairs:
        from alpa_tpu_torch.pipeline_parallel import computation
        computation._remake_views = lambda *args: None


def main(root: str, reference: bool, off, four_cards: bool,
         layers: int = 24):
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import torch

    import chip_smoke as s
    from alpa_tpu_torch.shard_parallel.sharding_spec import local_shape

    switch_off(off)
    s.build_kernels()
    cfg = dataclasses.replace(s.config_from_spec(
        "1.3B", dtype=torch.bfloat16,
        attention_impl="reference" if reference else "flash",
        pipeline_boundary_every=layers // 2), num_layers=layers)
    tag = f"{root} {cfg.attention_impl} {layers} layers off={sorted(off)}"
    batch = {k: torch.as_tensor(v, device="cuda")
             for k, v in s.lm_batch(cfg, 8).items()}
    devices = [f"cuda:{i}" for i in range(4)] if four_cards else \
        ["cuda:0"] * 4
    ref = s.two_level_reference(cfg, batch, ["cuda:0"] * 2) \
        if four_cards else None
    state = s.train_state(cfg)
    step = s.make_train_step(s.two_level_method(devices))
    for d in sorted(set(devices)):
        torch.cuda.reset_peak_memory_stats(d)
    state, loss = step(state, batch)
    s.sync_cards(devices)
    ex = step.get_last_executable()
    if ref is not None:
        rel = s.max_rel_diff(s.gathered_mu(state), ref["mu"])
        worst = max(rel, key=rel.get)
        print(f"{tag} over {devices} [{s.card_line()} x4]: Adam's first "
              f"moment after one step max |diff| / max |mu| per tensor "
              f"{rel[worst]:.3e} at {worst} (tol {s.TWO_LEVEL_GRAD_TOL:g}) "
              f"against one device per stage; first loss {float(loss)} vs "
              f"{ref['loss']}")
    for e in ex.stage_execs + [a for a in ex.apply_execs if a is not None]:
        shape = tuple(e.logical_mesh.shape)
        kinds, values = {}, []
        for v, sp, path in zip(e.invars, e.in_specs, e.in_paths):
            val = v.meta["val"]
            n = int(np.prod(local_shape(val, sp, shape))) * \
                val.element_size()
            kind = ("acc" if v in ex.acc_pairs else
                    "params" if "params" in path else
                    "opt" if "opt_state" in path else
                    "batch" if path.startswith("[1]") else "values")
            rep = "replicated" if not any(sp) else "sharded"
            kinds[(kind, rep)] = kinds.get((kind, rep), 0) + n
            if kind == "values" and val.dim() == 3 and \
                    not e.name.endswith("_bwd"):
                values.append((tuple(val.shape), tuple(sp)))
        outs = sum(int(np.prod(local_shape(v.meta["val"], sp, shape))) *
                   v.meta["val"].element_size()
                   for v, sp in zip(e.outvars, e.out_specs))
        coll = {}
        for rec in getattr(getattr(e, "program", None), "records", ()):
            row = coll.setdefault(rec.kind, [0, 0])
            row[0] += 1
            row[1] += rec.nbytes
        print(f"{tag} {e.name}: inputs per device "
              f"{ {k: round(b / 2**30, 3) for k, b in sorted(kinds.items())} }"
              f" GiB; outputs {outs / 2**30:.3f} GiB; 3-D values taken "
              f"(shape, spec) {values}; collectives per run (count, bytes) "
              f"{coll}")
    per_step = ex.get_collective_counts()
    print(f"{tag} collectives per step: " + ", ".join(
        f"{k} {r['count']} calls {r['bytes']} bytes"
        for k, r in sorted(per_step.items())))
    peak = max(torch.cuda.max_memory_allocated(d)
               for d in sorted(set(devices)))
    print(f"{tag} [{s.card_line()}] loss {float(loss)} peak "
          f"{peak / 2**30:.3f} GiB")


if __name__ == "__main__":
    parser = argparse.ArgumentParser()
    parser.add_argument("tree", nargs="?", default=".")
    parser.add_argument("--reference", action="store_true")
    parser.add_argument("--off", default="")
    parser.add_argument("--four-cards", action="store_true")
    parser.add_argument("--layers", type=int, default=24)
    args = parser.parse_args()
    main(args.tree, args.reference,
         {r for r in args.off.split(",") if r}, args.four_cards, args.layers)
