"""The port's model checker against the JAX package's, on the same plans.

Per plan of ``torch_plan_pairs``: the checker's result under buffered and
rendezvous channels, whether its exploration was partial, and the retry
classification of every fault site equal JAX's; both packages check the
plan in "fixture" mode exactly when JAX's does (its instruction count
against ``FIXTURE_MAX_OPS``, the same 256).  On one plan dict (JAX's
``model_to_dict``) both checkers give identical stats, state counts
included.  Under ``verify_plans="error"`` ``call_with_retry`` refuses a
real failure at a site the checker classed unsafe, as JAX's does, and
retries it under "warn".
"""
import pytest
import torch

import torch_plan_pairs as pp
from alpa_tpu.analysis import model_check as jmc
from alpa_tpu_torch import fault as tfault
from alpa_tpu_torch.analysis import model_check as tmc
from alpa_tpu_torch.global_env import global_config


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


def _classes(stats):
    return {s: (e["classification"], tuple(e["reasons"]))
            for s, e in stats["retry_sites"].items()}


@pytest.mark.parametrize("name", pp.PLANS)
def test_model_check_matches_jax(name):
    jex, tex = pp.plan_pair(name)
    jv, tv = jex.get_plan_verdict(), tex.get_plan_verdict()
    jmcs, tmcs = jv.stats.get("model_check"), tv.stats.get("model_check")
    assert (jmcs is None) == (tmcs is None)
    assert (jv.stats["n_ops"] <= jmc.FIXTURE_MAX_OPS) == \
        (tv.stats["n_ops"] <= tmc.FIXTURE_MAX_OPS)
    assert tmc.FIXTURE_MAX_OPS == jmc.FIXTURE_MAX_OPS == 256
    assert tmc.DEFAULT_STATE_BUDGET == jmc.DEFAULT_STATE_BUDGET == 50000
    if jmcs is None:
        return
    assert tmcs["semantics"] == jmcs["semantics"]
    assert tmcs["partial"] == jmcs["partial"]
    assert _classes(tmcs) == _classes(jmcs)
    assert {f.code for f in tv.findings() if f.analysis == "model_check"} \
        == {f.code for f in jv.findings() if f.analysis == "model_check"}


@pytest.mark.parametrize("name", ["mlp4-1f1b", "gpt"])
def test_one_plan_dict_checks_alike(name):
    (jm, jh, jw), _ = pp.plan_models(name)
    d = jmc.model_to_dict(jm, jh, jw)
    want = jmc.check_model(*jmc.model_from_dict(d)[:2],
                           overlap_window=jw)
    tmodel, thooks, tw = tmc.model_from_dict(d)
    got = tmc.check_model(tmodel, hooks=thooks, overlap_window=tw)
    assert [(f.code, f.op, f.message) for f in got.findings] == \
        [(f.code, f.op, f.message) for f in want.findings]
    drop = ("seconds",)
    assert {k: v for k, v in got.stats.items() if k not in drop} == \
        {k: v for k, v in want.stats.items() if k not in drop}
    # the dict survives the port's round trip unchanged
    assert tmc.model_to_dict(tmodel, thooks, tw) == d


def test_overlap_program_checks_its_window():
    """The overlap-mode program of the 4-stage MLP: the window the
    scheduler declares holds as a property, in both packages."""
    import dataclasses
    jex, tex = pp.plan_pair("mlp4-1f1b")
    jv = jex._make_lowerer("overlap")(list(jex.instructions)).verdict
    context = dataclasses.replace(tex._plan_context(), plan_fingerprint=None)
    tv = tex._lower_for_analysis(tex.instructions, "overlap",
                                 context).verdict
    jmcs, tmcs = jv.stats["model_check"], tv.stats["model_check"]
    assert tmcs["declared_window"] == jmcs["declared_window"] > 0
    assert tmcs["max_inflight"] <= tmcs["declared_window"]
    assert ("model_check", "model.inflight-exceeds-window") not in \
        pp.findings(tv)
    assert _classes(tmcs) == _classes(jmcs)


@pytest.fixture
def classified():
    old = global_config.verify_plans
    tfault.install_retry_classification(
        {"stage_launch": {"classification": "unsafe",
                          "reasons": ["unsafe-donation"], "hooks": 2}})
    yield global_config
    tfault.install_retry_classification(None)
    global_config.verify_plans = old


@pytest.mark.parametrize("policy,calls", [("error", 1), ("warn", 3)])
def test_call_with_retry_refuses_an_unsafe_site(classified, policy, calls):
    classified.verify_plans = policy
    n = []

    def fn():
        n.append(1)
        if len(n) < 3:
            raise RuntimeError("device lost in the middle of the op")
        return "done"

    pol = tfault.RetryPolicy(max_attempts=3, base_delay=0.0, max_delay=0.0,
                             jitter=0.0)
    if policy == "error":
        with pytest.raises(RuntimeError, match="device lost"):
            tfault.call_with_retry(fn, pol, site="stage_launch")
    else:
        assert tfault.call_with_retry(fn, pol, site="stage_launch") == "done"
    assert len(n) == calls
    # an injected fault fires before the op: always retried
    n.clear()

    def injected():
        n.append(1)
        if len(n) < 2:
            raise tfault.InjectedFault("injected")
        return "done"

    assert tfault.call_with_retry(injected, pol, site="stage_launch") == \
        "done"
    assert tfault.get_retry_classification()["stage_launch"][
        "classification"] == "unsafe"


def test_verified_plan_installs_its_classification():
    _, tex = pp.plan_pair("mlp2-1f1b")
    tfault.install_retry_classification(None)
    verdict = tex.get_plan_verdict()
    # a replayed verdict installs it too (verify_program runs on every
    # lowering that verifies, cache hits included)
    pp.port_lower(tex, tex.instructions)
    got = tfault.get_retry_classification()
    assert got == verdict.stats["model_check"]["retry_sites"]
    assert got["stage_launch"]["classification"] == "unsafe"
    tfault.install_retry_classification(None)
