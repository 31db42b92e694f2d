"""The port's translation validation against the JAX package's.

Per plan of ``torch_plan_pairs``: as many stage applications, the same
protected outputs proved, the same axioms used and the same status per
output as JAX's proof.  A stage's signature (its name and the
``graph_fingerprint`` of its aten graph) is the same in two compiles of
one step, so a warm restart keys the verdict alike.  On one plan dict
(JAX's ``model_to_dict``) a microbatch's accumulation dropped, or run
twice, is found by both packages under the same code and with the same
witness: the protected outputs are the apply-grad's new state, whose terms
read the accumulated sums, so the proof reports an output mismatch whose
witness names the sum that lost (or gained) a microbatch's
contribution.
"""
import dataclasses

import pytest
import torch

import alpa_tpu_torch
import torch_plan_pairs as pp
from alpa_tpu.analysis import equivalence as jeq
from alpa_tpu.analysis import model_check as jmc
from alpa_tpu_torch.analysis import equivalence as teq
from alpa_tpu_torch.analysis import model_check as tmc


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


def _equiv(verdict):
    return verdict.stats["equiv"]


@pytest.mark.parametrize("name", pp.PLANS)
def test_equivalence_matches_jax(name):
    jex, tex = pp.plan_pair(name)
    j, t = _equiv(jex.get_plan_verdict()), _equiv(tex.get_plan_verdict())
    for key in ("n_outputs", "n_proved", "n_apps", "num_microbatches",
                "axioms_used", "partial"):
        assert t[key] == j[key], key
    assert t["n_proved"] == t["n_outputs"] > 0
    assert sorted(r["status"] for r in t["per_output"]) == \
        sorted(r["status"] for r in j["per_output"])
    assert sorted(tuple(r["axioms"]) for r in t["per_output"]) == \
        sorted(tuple(r["axioms"]) for r in j["per_output"])


def test_stage_signatures_are_stable_across_compiles():
    _, tex = pp.plan_pair("gpt")
    _, t_state, batch = pp.states("gpt")
    again, _ = alpa_tpu_torch.parallelize(
        pp.steps("gpt")[1], method=pp.methods("gpt")[1]).get_executable(
            t_state, pp.port_batch(batch))
    sig = {e.name: teq.stage_signature(e) for e in tex.stage_execs}
    assert sig == {e.name: teq.stage_signature(e)
                   for e in again.stage_execs}
    assert len(set(sig.values())) == len(sig)
    ref = tex._plan_context().reference
    assert teq.reference_digest(ref) == teq.reference_digest(
        again._plan_context().reference)
    assert ref["format"] == "alpa-equiv-reference/v1"
    assert ref["num_microbatches"] == 2


def _accumulation_run(model):
    return next(o for o in model.ops if o.kind == "RUN" and o.equiv and
                o.equiv["acc"] and o.equiv["mb"] == 1)


def _drop(model):
    op = _accumulation_run(model)
    return dataclasses.replace(model, ops=[o for o in model.ops
                                           if o is not op])


def _run_twice(model):
    op = _accumulation_run(model)
    ops = []
    for o in model.ops:
        ops.append(o)
        if o is op:
            ops.append(o)
    return dataclasses.replace(model, ops=ops)


@pytest.mark.parametrize("mutate,code", [
    (_drop, "equiv.output-mismatch"),
    (_run_twice, "equiv.output-mismatch"),
])
def test_accumulation_faults_found_alike(mutate, code):
    (jm, jh, jw), _ = pp.plan_models("mlp2-1f1b")
    d = jmc.model_to_dict(jm, jh, jw)
    results = []
    for eq, mc in ((jeq, jmc), (teq, tmc)):
        model, _, _ = mc.model_from_dict(d)
        base = eq.check_equiv(model, numerics_ok=True)
        assert base.ok and not base.findings
        bad = eq.check_equiv(mutate(model), numerics_ok=True)
        results.append([(f.code, f.message) for f in bad.findings])
    assert results[0] == results[1]
    assert code in {c for c, _ in results[1]}
    assert any("sum{" in m for _, m in results[1])
