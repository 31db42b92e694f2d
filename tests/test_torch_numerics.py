"""The port's numerics certification against the JAX package's.

Per plan of ``torch_plan_pairs``, the certification's largest composed
bound (to 1e-12 relative), its lossy edges and its count of below-fp32
reductions equal JAX's, and so do each stage's ``min_accum`` and
``below_fp32_accum`` as ``eqn_classify`` reads them off the aten graph and
JAX's off the jaxpr: this pins the rule for JAX's ``add_any`` (not
counted; a bf16 ``sum`` of the same backward stage sets the flag) on the
narrow GPT in fp32 and in bf16.  With the activation codec on every
cross-mesh edge (``reshard_quantize="int8"``, no size floor) both packages
certify the same lossy hops and the same bound, read from codec contracts
that are equal (``ERROR_BOUND``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import alpa_tpu
import alpa_tpu_torch
import torch_plan_pairs as pp
from alpa_tpu.global_env import global_config as jconfig
from alpa_tpu.pipeline_parallel import reshard_codec as jcodec
from alpa_tpu.shard_parallel.eqn_classify import \
    classify_stage_precision as jax_precision
from alpa_tpu_torch.global_env import global_config as tconfig
from alpa_tpu_torch.pipeline_parallel import reshard_codec as tcodec
from alpa_tpu_torch.shard_parallel.eqn_classify import \
    classify_stage_precision as port_precision

REL = 1e-12


@pytest.fixture(autouse=True)
def _keep_global_torch_rng():
    with torch.random.fork_rng():
        yield


def _numerics(verdict):
    return verdict.stats["numerics"]


@pytest.mark.parametrize("name", pp.PLANS)
def test_numerics_matches_jax(name):
    jex, tex = pp.plan_pair(name)
    j, t = _numerics(jex.get_plan_verdict()), _numerics(
        tex.get_plan_verdict())
    np.testing.assert_allclose(t["max_error_bound"], j["max_error_bound"],
                               rtol=REL, atol=0)
    assert t["lossy_edges"] == j["lossy_edges"]
    assert t["n_bf16_reductions"] == j["n_bf16_reductions"]
    assert t["budget"] == j["budget"]


@pytest.mark.parametrize("name", ["gpt", "gpt-bf16", "mlp2-1f1b"])
def test_stage_precision_flags_match_jax(name):
    """Per stage, the narrowest accumulation dtype and the below-fp32
    reduction flag; the counts differ by design (aten merges a layer norm
    into one op, and has no ``add_any``)."""
    jex, tex = pp.plan_pair(name)
    jr = {i.info: jax_precision(i.executable) for i in jex.instructions
          if i.opcode.name == "RUN"}
    tr = {i.info: port_precision(i.executable) for i in tex.instructions
          if i.opcode.name == "RUN"}
    assert set(tr) == set(jr)
    for stage, want in jr.items():
        got = tr[stage]
        assert (got["min_accum"], got["below_fp32_accum"]) == \
            (want["min_accum"], want["below_fp32_accum"]), stage
        assert got["n_matmul"] == want["n_matmul"], stage
    if name == "gpt-bf16":
        assert {s for s, r in tr.items() if r["below_fp32_accum"]} == \
            {"stage_0_bwd", "stage_1_bwd"}


def test_codec_contracts_are_equal():
    assert tcodec.ERROR_BOUND == jcodec.ERROR_BOUND
    assert tcodec.BLOCK == jcodec.BLOCK


@pytest.fixture
def quantized_edges():
    saved = [(c, n, getattr(c, n)) for c in (jconfig, tconfig)
             for n in ("reshard_quantize", "reshard_quantize_min_bytes")]
    for c in (jconfig, tconfig):
        c.reshard_quantize = "int8"
        c.reshard_quantize_min_bytes = 0
    yield
    for c, n, v in saved:
        setattr(c, n, v)


def test_quantized_edges_certify_alike(quantized_edges):
    """The 4-stage MLP with every cross-mesh activation edge through the
    int8 codec: the same lossy hops per codec, the same largest bound (one
    hop of 1/254 of a block's largest magnitude composed along the forward
    chain and the backward's), no weight or optimizer-state value on a
    lossy hop, and the per-output table's bounds."""
    name = "mlp4-1f1b"
    alpa_tpu.init(cluster="local")
    j_state, t_state, batch = pp.states(name)
    jstep, tstep = pp.steps(name)
    jmethod, tmethod = pp.methods(name)
    jex, _ = alpa_tpu.parallelize(jstep, method=jmethod).get_executable(
        j_state, pp.jax_batch(name, batch))
    tex, _ = alpa_tpu_torch.parallelize(
        tstep, method=tmethod).get_executable(t_state, pp.port_batch(batch))
    jv, tv = jex.get_plan_verdict(), tex.get_plan_verdict()
    j, t = _numerics(jv), _numerics(tv)
    assert j["lossy_edges"] and t["lossy_edges"] == j["lossy_edges"]
    np.testing.assert_allclose(t["max_error_bound"], j["max_error_bound"],
                               rtol=REL, atol=0)
    assert t["max_error_bound"] >= tcodec.ERROR_BOUND["int8"]
    assert pp.findings(tv) == pp.findings(jv)
    assert ("numerics", "numerics.quantized-reduction") in pp.findings(tv)
    assert not {("numerics", "numerics.lossy-weight-path"),
                ("numerics", "numerics.lossy-opt-state-path")} & \
        pp.findings(tv)
    assert sorted(r["bound"] for r in t["bound_table"]) == \
        pytest.approx(sorted(r["bound"] for r in j["bound_table"]),
                      rel=REL)
    assert jnp.isfinite(j["max_error_bound"])


def _port_mlp4_executable():
    name = "mlp4-1f1b"
    _, t_state, batch = pp.states(name)
    ex, _ = alpa_tpu_torch.parallelize(
        pp.steps(name)[1], method=pp.methods(name)[1]).get_executable(
            t_state, pp.port_batch(batch))
    return ex


def test_an_overlap_program_keys_its_codec():
    """The overlap-mode program of the 4-stage MLP with and without the
    int8 codec: their fingerprints differ (each launch and wait names its
    RESHARDs' strategies), so the lossless program's cached verdict is
    never replayed for the quantized one, which certifies its lossy hops.
    Before, an overlap program's text named its transfers by index only,
    and the quantized plan got the lossless verdict (no lossy hop)."""
    import dataclasses

    def overlap(ex):
        return ex._lower_for_analysis(
            ex.instructions, "overlap",
            dataclasses.replace(ex._plan_context(), plan_fingerprint=None))

    lossless = overlap(_port_mlp4_executable())
    saved = (tconfig.reshard_quantize, tconfig.reshard_quantize_min_bytes)
    tconfig.reshard_quantize, tconfig.reshard_quantize_min_bytes = "int8", 0
    try:
        qex = _port_mlp4_executable()
        quantized = overlap(qex)
    finally:
        tconfig.reshard_quantize, tconfig.reshard_quantize_min_bytes = saved
    from alpa_tpu_torch.pipeline_parallel.runtime_emitter import \
        _strategy_of
    edges = sum(_strategy_of(i) == "quantized_int8"
                for i in qex.instructions if i.opcode.name == "RESHARD")
    assert edges > 0
    assert quantized.fingerprint() != lossless.fingerprint()
    assert not _numerics(lossless.verdict)["lossy_edges"]
    assert _numerics(quantized.verdict)["lossy_edges"] == {"int8": edges}
