"""The port's plan verifier against the JAX package's, on the same plans.

Each plan of ``torch_plan_pairs`` is compiled by both packages from the
same weights; the port lowers and verifies it as the JAX package does, and
the two verdicts are held to each other: the set of ``(analysis, code)``
findings, the leaked slots and, per mesh, the static peak of live bytes.
The peaks are equal on every mesh whose slots are the same values in both
packages; where a backward stage keeps other values by design (autograd's
saved tensors, not JAX's residuals: a ReLU's output for JAX's mask, the
loss a seed gradient reads for its shape; an int64 step count for JAX's
int32), the two peaks differ by no more than those slots' bytes (ROADMAP
"Differences by design").  A plan dict written by either package's
``model_to_dict`` reads in the other's ``model_from_dict`` and gets the
identical verdict there, numbers and all (seconds aside).  Planted faults
are found under the same codes by both packages, and the policy knob
refuses a bad plan before any launch.
"""
import dataclasses

import numpy as np
import pytest
import torch

import alpa_tpu_torch
import torch_plan_pairs as pp
from alpa_tpu.analysis import model_check as jmc
from alpa_tpu.analysis import plan_verifier as jpv
from alpa_tpu_torch.analysis import model_check as tmc
from alpa_tpu_torch.analysis import plan_verifier as tpv
from alpa_tpu_torch.global_env import global_config
from alpa_tpu_torch.pipeline_parallel.runtime_emitter import (
    PipelineInstType, instruction_accesses)


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield
    # a plan with leaked slots annotates the flight dumps process-wide
    from alpa_tpu_torch.telemetry import flight
    flight.clear_annotations()


@pytest.fixture
def knobs():
    """Restore the port's plan-analysis knobs after a test."""
    names = ("verify_plans", "verify_plans_numerics", "verify_plans_equiv",
             "numerics_error_budget", "reshard_quantize",
             "reshard_quantize_min_bytes", "compile_cache_enabled")
    saved = {n: getattr(global_config, n) for n in names}
    yield global_config
    for n, v in saved.items():
        setattr(global_config, n, v)


def _no_seconds(x):
    if isinstance(x, dict):
        return {k: _no_seconds(v) for k, v in x.items()
                if "seconds" not in k}
    if isinstance(x, (list, tuple)):
        return [_no_seconds(v) for v in x]
    return x


def _verdict_facts(verdict):
    return ([(f.analysis, f.code, f.op, f.message) for f in verdict.errors],
            [(f.analysis, f.code, f.op, f.message)
             for f in verdict.warnings],
            [(f.analysis, f.code, f.op, f.message) for f in verdict.notes],
            _no_seconds(verdict.stats))


@pytest.mark.parametrize("name", pp.PLANS)
def test_verdict_matches_jax(name):
    jex, tex = pp.plan_pair(name)
    jv, tv = jex.get_plan_verdict(), tex.get_plan_verdict()
    assert pp.findings(tv) == pp.findings(jv)
    assert tv.ok == jv.ok
    assert tv.stats["leaked_slots"] == jv.stats["leaked_slots"] == 0
    (jm, _, _), (tm, _, _) = pp.plan_models(name)
    jpop, tpop = pp.slot_population(jm), pp.slot_population(tm)
    assert set(tv.stats["peak_bytes"]) == set(jv.stats["peak_bytes"])
    for mesh, peak in jv.stats["peak_bytes"].items():
        m = int(mesh)
        if jpop[m] == tpop[m]:
            assert tv.stats["peak_bytes"][mesh] == peak, mesh
        else:
            differ = sum(k[3] * n for k, n in ((jpop[m] - tpop[m]) +
                                               (tpop[m] - jpop[m])).items())
            assert abs(tv.stats["peak_bytes"][mesh] - peak) <= differ
    # the placed values (parameters, optimizer state, batch slices,
    # accumulators) are the same in both packages but for the step count
    for m in jpop:
        placed = {s.slot for s in jm.slots.values() if s.mesh == m and
                  s.preplaced and s.dtype not in ("int32", "int64")}
        tplaced = {s.slot for s in tm.slots.values() if s.mesh == m and
                   s.preplaced and s.dtype not in ("int32", "int64")}
        assert sum(jm.slots[s].nbytes for s in placed) == \
            sum(tm.slots[s].nbytes for s in tplaced), m


@pytest.mark.parametrize("name", ["mlp2-1f1b", "mlp4-gpipe", "gpt",
                                  "two-level"])
def test_plan_dicts_read_alike_in_both_packages(name):
    """JAX's plan dict verified by the port equals JAX's own verdict on it,
    and the port's plan dict verified by JAX equals the port's."""
    (jm, jh, jw), (tm, th, tw) = pp.plan_models(name)
    jdict = jmc.model_to_dict(jm, jh, jw)
    want = pp.verify_all(jpv, jm, jh, jw)
    got = pp.verify_all(tpv, *tmc.model_from_dict(jdict))
    assert _verdict_facts(got) == _verdict_facts(want)
    tdict = tmc.model_to_dict(tm, th, tw)
    want = pp.verify_all(tpv, tm, th, tw)
    got = pp.verify_all(jpv, *jmc.model_from_dict(tdict))
    assert _verdict_facts(got) == _verdict_facts(want)


def _free_before_consumer(insts, accesses):
    for fi, x in enumerate(insts):
        if x.opcode.name != "FREE":
            continue
        keys = {tuple(k) for k in x.free_keys}
        readers = [i for i in range(fi) if any(
            kind == "read" and tuple(k) in keys
            for k, kind in accesses(insts[i]))]
        writers = [i for i in range(fi) if any(
            kind == "write" and tuple(k) in keys
            for k, kind in accesses(insts[i]))]
        if readers and writers and min(writers) < min(readers):
            out = insts[:fi] + insts[fi + 1:]
            out.insert(min(readers), x)
            return out
    raise AssertionError("no FREE with an earlier reader")


def _double_free(insts, accesses):
    fi = next(i for i, x in enumerate(insts) if x.opcode.name == "FREE")
    return insts[:fi + 1] + [insts[fi]] + insts[fi + 1:]


def _reshard_before_producer(insts, accesses):
    j = next(i for i, x in enumerate(insts) if x.opcode.name == "RESHARD"
             and x.src_mesh != x.dst_mesh)
    return [insts[j]] + insts[:j] + insts[j + 1:]


def _dropped_accumulation(insts, accesses):
    for i, x in enumerate(insts):
        if x.opcode.name != "RUN":
            continue
        acc = accesses(x)
        kills = {tuple(k) for k, kind in acc if kind == "kill"}
        writes = {tuple(k) for k, kind in acc if kind == "write"}
        if kills & writes:
            return insts[:i] + insts[i + 1:]
    raise AssertionError("no accumulation RUN")


@pytest.mark.parametrize("mutate,code", [
    (_free_before_consumer, ("liveness", "liveness.use-after-free")),
    (_double_free, ("liveness", "liveness.double-free")),
    (_reshard_before_producer, ("deadlock", "deadlock.recv-before-send")),
    (_dropped_accumulation, ("liveness", "liveness.use-undefined")),
])
def test_planted_instruction_faults_found_alike(mutate, code):
    """A FREE moved before its consumer, a FREE repeated, a cross-mesh
    RESHARD moved before its producer and a microbatch's accumulation
    dropped: each lowering is verified by its own package and both find
    the fault under the same code (the two instruction lists differ in
    their FREEs, so the same mutation moves other FREEs and the other
    findings it causes may differ)."""
    from alpa_tpu.pipeline_parallel.runtime_emitter import \
        instruction_accesses as jax_accesses
    jex, tex = pp.plan_pair("mlp2-1f1b")
    new = []
    for ex, lower, accesses in ((jex, pp.jax_lower, jax_accesses),
                                (tex, pp.port_lower, instruction_accesses)):
        base = ex.get_plan_verdict()
        prog = lower(ex, mutate(list(ex.instructions), accesses))
        new.append(pp.findings(prog.verdict) - pp.findings(base))
    assert code in new[0], new[0]
    assert code in new[1], new[1]


def _lossy_weight_edge(model, hooks):
    i = next(o.idx for o in model.ops if o.kind == "RESHARD" and o.weight)
    ops = list(model.ops)
    ops[i] = dataclasses.replace(ops[i], strategy="quantized", codec="int8",
                                 groupable=False)
    return dataclasses.replace(model, ops=ops), hooks


def _swapped_stages(model, hooks):
    runs = [o for o in model.ops if o.kind == "RUN" and o.equiv]
    a = runs[0]
    b = next(o for o in runs if o.equiv["stage"] != a.equiv["stage"])
    ops = list(model.ops)
    ops[a.idx] = dataclasses.replace(a, equiv=b.equiv)
    ops[b.idx] = dataclasses.replace(b, equiv=a.equiv)
    return dataclasses.replace(model, ops=ops), hooks


def _quantized_edge_in_group(model, hooks):
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import OpHook
    edges = {}
    for o in model.ops:
        if o.kind == "RESHARD" and o.cross:
            edges.setdefault(o.edge, []).append(o.idx)
    members = next(v for v in edges.values() if len(v) > 1)[:2]
    ops = list(model.ops)
    ops[members[1]] = dataclasses.replace(ops[members[1]],
                                          strategy="quantized",
                                          codec="int8", groupable=False)
    mem = [ops[m] for m in members]
    group = OpHook(kind="exec", name="group", node=members[0],
                   mesh=mem[0].mesh,
                   reads=tuple(s for o in mem for s in o.reads),
                   writes=tuple(s for o in mem for s in o.writes),
                   members=tuple(members))
    return dataclasses.replace(model, ops=ops), list(hooks) + [group]


@pytest.mark.parametrize("mutate,codes", [
    (_lossy_weight_edge, {("typing", "typing.quantized-weight-edge"),
                          ("numerics", "numerics.lossy-weight-path")}),
    (_swapped_stages, {("equiv", "equiv.output-mismatch")}),
    (_quantized_edge_in_group, {("structure",
                                 "structure.group-nongroupable")}),
])
def test_planted_model_faults_found_alike(mutate, codes):
    """A lossy codec on a weight edge, two stages swapped in the term
    algebra and a quantized edge fused into a group: planted in the same
    plan dict, read by each package, found under the same codes."""
    (jm, jh, jw), _ = pp.plan_models("mlp2-1f1b")
    d = jmc.model_to_dict(jm, jh, jw)
    new = []
    for pv, mc in ((jpv, jmc), (tpv, tmc)):
        model, hooks, window = mc.model_from_dict(d)
        base = pp.verify_all(pv, model, hooks, window)
        bad_model, bad_hooks = mutate(model, hooks)
        bad = pp.verify_all(pv, bad_model, bad_hooks, window)
        new.append(pp.findings(bad) - pp.findings(base))
    assert new[0] == new[1]
    assert codes <= new[1], new[1]


def _mlp_step_pair(method):
    _, t_state, batch = pp.mlp_states("mlp2-1f1b")
    step = alpa_tpu_torch.parallelize(pp._port_mlp_step, method=method)
    return step, t_state, pp.port_batch(batch)


def test_error_policy_refuses_the_launch(knobs):
    """Under ``verify_plans="error"`` a plan with an error finding (here a
    quantized activation edge over a numerics budget of 1e-6) raises
    ``PlanVerificationError`` before any op runs: the state is untouched,
    and every later launch is refused as well; ``get_plan_verdict`` still
    reports the verdict."""
    knobs.verify_plans = "error"
    knobs.reshard_quantize = "int8"
    knobs.reshard_quantize_min_bytes = 0
    knobs.numerics_error_budget = 1e-6
    step, state, batch = _mlp_step_pair(pp.methods("mlp2-1f1b")[1])
    before = {k: v.clone() for k, v in state.params.items()}
    for _ in range(2):
        with pytest.raises(tpv.PlanVerificationError) as e:
            step(state, batch)
    assert ("numerics", "numerics.budget-exceeded") in pp.findings(
        e.value.verdict)
    for k, v in state.params.items():
        assert torch.equal(v, before[k])
    ex = step.get_last_executable()
    assert not ex._warm
    assert not ex.get_plan_verdict().ok


def test_off_leaves_the_plan_and_the_step_unchanged(knobs):
    """``verify_plans="off"`` verifies nothing (no verdict) and gives the
    same plan fingerprint and bit-identical losses and parameters as the
    default "warn", which verifies each plan once however many steps
    run."""
    results = {}
    # every lowering that verifies counts (no verdict replayed from the
    # cache), so the count shows how often the plan was verified
    knobs.compile_cache_enabled = False
    for policy in ("warn", "off"):
        knobs.verify_plans = policy
        step, state, batch = _mlp_step_pair(pp.methods("mlp2-1f1b")[1])
        fp = step.get_executable(state, batch)[0].get_plan_fingerprint()
        count = tpv.verification_counts.get(fp, 0)
        losses = []
        for _ in range(3):
            state, loss = step(state, batch)
            losses.append(loss.item())
        ex = step.get_last_executable()
        assert ex.get_plan_fingerprint() == fp
        results[policy] = (fp, losses, state.params)
        if policy == "warn":
            assert tpv.verification_counts.get(fp) == count + 1
            assert ex.get_plan_verdict().ok
        else:
            assert ex.get_plan_verdict() is None
    (fa, la, pa), (fb, lb, pb) = results["warn"], results["off"]
    assert fa == fb and la == lb
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_verdict_is_cached_and_dumped(knobs, tmp_path):
    """A second lowering of the same program replays the verdict from the
    ``plan_verdict`` namespace (a hit, no analysis); ``dump_debug_info``
    writes the verdict's reports."""
    from alpa_tpu_torch import compile_cache, monitoring
    compile_cache.reset_compile_cache()
    step, state, batch = _mlp_step_pair(pp.methods("mlp2-gpipe")[1])
    ex, _ = step.get_executable(state, batch)
    verdict = ex.get_plan_verdict()
    prog = pp.port_lower(ex, ex.instructions)
    stats = compile_cache.get_compile_cache().stats()["namespaces"]
    assert stats["plan_verdict"]["hits"] >= 1
    assert prog.verdict.to_dict()["errors"] == verdict.to_dict()["errors"]
    monitoring.dump_debug_info(ex, str(tmp_path))
    for name in ("plan_verdict.txt", "model_check.txt", "numerics.txt",
                 "equiv.txt", "superopt.txt"):
        assert (tmp_path / name).exists(), name
    assert (tmp_path / "plan_verdict.txt").read_text().startswith(
        "plan verdict: PASS")
    compile_cache.reset_compile_cache()
    assert np.isfinite(verdict.stats["peak_bytes"]["0"])
