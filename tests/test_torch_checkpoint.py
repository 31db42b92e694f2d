"""The port's checkpoint store and manager (``alpa_tpu_torch/
checkpoint/``) against the JAX package's, after
``tests/checkpoint/test_store.py``, ``test_manager.py`` and
``test_zero_resume.py``.

For the same fp32 and bf16 leaves and slices both ``ShardStore``s write
byte-equal manifests and chunks, and each reads the other's; bf16 is
kept as its raw bits (``uint16``) in the port, as ``ml_dtypes.bfloat16``
in JAX.  ``read_leaf_slice`` reassembles the same slices; corruption,
retention and ``gc`` behave alike; the managers write the same store for
the same named state.  The port's manager saves asynchronously and
restores (in place too), and the narrow MLP saved under
``Zero2Parallel`` at degree 4 on CPU devices restores at degree 2 and
resumes bit for bit, while a restore under the other plan's fingerprint
raises ``PlanFingerprintMismatch``.  Everything is written under
``tmp_path``.
"""
import os

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

import alpa_tpu_torch
from alpa_tpu.checkpoint import metrics as jmetrics
from alpa_tpu.checkpoint.manager import CheckpointManager as JManager
from alpa_tpu.checkpoint.policy import RetentionPolicy as JPolicy
from alpa_tpu.checkpoint.store import ShardStore as JStore
from alpa_tpu_torch import Zero2Parallel
from alpa_tpu_torch import testing as ttesting
from alpa_tpu_torch.checkpoint import (CheckpointManager,
                                       ChunkCorruptionError,
                                       PlanFingerprintMismatch,
                                       RetentionPolicy, ShardStore)
from alpa_tpu_torch.checkpoint import metrics as tmetrics
from alpa_tpu_torch.checkpoint.manager import CheckpointSaveError
from alpa_tpu_torch.device_mesh import DistributedArray


@pytest.fixture(autouse=True)
def _clean():
    with torch.random.fork_rng():
        yield
    tmetrics.reset()
    jmetrics.reset()
    alpa_tpu_torch.shutdown()


def _files(root):
    """Every file under ``root`` (relative path -> bytes)."""
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def _leaves(seed):
    """Named leaves for both stores: fp32 in row halves, bf16 in column
    halves, a scalar; the port's bf16 as its bits."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((8, 6)).astype(np.float32)
    bf = rng.standard_normal((4, 10)).astype(np.float32).astype(
        ml_dtypes.bfloat16)
    s = np.asarray(3.5, np.float32)

    def leaves(bf_arr):
        return {
            "params.w": {"shape": [8, 6], "dtype": "float32", "pieces": [
                (((0, 4), (0, 6)), w[:4]), (((4, 8), (0, 6)), w[4:])]},
            "params.b": {"shape": [4, 10], "dtype": "bfloat16", "pieces": [
                (((0, 4), (0, 5)), bf_arr[:, :5]),
                (((0, 4), (5, 10)), bf_arr[:, 5:])]},
            "step": {"shape": [], "dtype": "float32", "pieces": [((), s)]}}
    return leaves(bf), leaves(bf.view(np.uint16)), (w, bf, s)


def _write_both(tmp_path, steps=(1,), chunk_bytes=48):
    stores = {"jax": JStore(str(tmp_path / "jax")),
              "port": ShardStore(str(tmp_path / "port"))}
    truth = None
    for step in steps:
        jleaves, tleaves, truth = _leaves(step)
        stores["jax"].write_step(step, jleaves, plan_fingerprint="f" * 64,
                                 meta={"k": step}, chunk_bytes=chunk_bytes)
        stores["port"].write_step(step, tleaves, plan_fingerprint="f" * 64,
                                  meta={"k": step}, chunk_bytes=chunk_bytes)
    return stores, truth


def test_stores_write_byte_equal_manifests_and_chunks(tmp_path):
    stores, _ = _write_both(tmp_path, steps=(1, 2))
    jfiles, tfiles = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert jfiles == tfiles
    assert any(k.startswith("chunks") for k in tfiles)
    assert sorted(k for k in tfiles if k.startswith("manifests")) == [
        os.path.join("manifests", f"step_{s:012d}.json") for s in (1, 2)]
    assert stores["port"].all_steps() == stores["jax"].all_steps() == [1, 2]


@pytest.mark.parametrize("reader", ["port", "jax"])
def test_each_package_reads_the_others_store(tmp_path, reader):
    """The port reads the JAX package's store and JAX the port's: every
    leaf whole and in a slice no save wrote, bf16 bit for bit."""
    _write_both(tmp_path)
    w, bf, s = _leaves(1)[2]
    other = "jax" if reader == "port" else "port"
    store = (ShardStore if reader == "port" else JStore)(
        str(tmp_path / other))
    man = store.read_manifest(1)
    got_w = store.read_leaf_slice(man["leaves"]["params.w"],
                                  ((2, 7), (1, 6)))
    np.testing.assert_array_equal(got_w, w[2:7, 1:6])
    got_b = store.read_leaf_slice(man["leaves"]["params.b"],
                                  ((1, 3), (3, 8)))
    want_b = bf[1:3, 3:8]
    if reader == "port":
        assert got_b.dtype == np.uint16
        np.testing.assert_array_equal(got_b, want_b.view(np.uint16))
    else:
        np.testing.assert_array_equal(got_b.view(np.uint16),
                                      want_b.view(np.uint16))
    assert float(store.read_leaf_slice(man["leaves"]["step"], ())) == s


@pytest.mark.parametrize("seed", range(3))
def test_read_leaf_slice_reassembles_the_same_slices(tmp_path, seed):
    stores, _ = _write_both(tmp_path, chunk_bytes=24)
    rng = np.random.default_rng(seed)
    for _ in range(6):
        a0 = int(rng.integers(0, 7))
        a1 = int(rng.integers(a0 + 1, 9))
        b0 = int(rng.integers(0, 5))
        b1 = int(rng.integers(b0 + 1, 7))
        index = ((a0, a1), (b0, b1))
        got = [st.read_leaf_slice(st.read_manifest(1)["leaves"]["params.w"],
                                  index) for st in stores.values()]
        np.testing.assert_array_equal(got[0], got[1])


def test_corruption_retention_and_gc_as_jax(tmp_path):
    """A flipped byte fails ``verify_step`` naming its leaf and raises on
    read, ``last_verified_step`` falls back a step, retention keeps the
    same steps, and ``gc`` removes the same chunks, in both stores."""
    stores, _ = _write_both(tmp_path, steps=(1, 2, 3))
    reports = {}
    for name, st in stores.items():
        man = st.read_manifest(3)
        h = man["leaves"]["params.w"]["chunks"][0]["hash"]
        path = st.chunk_path(h)
        data = bytearray(open(path, "rb").read())
        data[0] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(data))
        rep = st.verify_step(3)
        with pytest.raises(Exception) as err:
            st.read_leaf_slice(man["leaves"]["params.w"], ((0, 8), (0, 6)))
        assert type(err.value).__name__ == "ChunkCorruptionError"
        policy = (RetentionPolicy if name == "port" else JPolicy)(
            keep_last_k=1, keep_every_n=2)
        survivors = policy.surviving(st.all_steps())
        for s in policy.to_delete(st.all_steps()):
            st.delete_step(s)
        reports[name] = (rep["ok"], sorted({b["leaf"] for b in rep["bad"]}),
                         rep["n_chunks"], rep["n_bytes"],
                         st.last_verified_step(), survivors, st.gc(),
                         st.all_steps())
    assert reports["port"] == reports["jax"]
    assert reports["port"][0] is False and reports["port"][1] == ["params.w"]
    assert reports["port"][4] == 2
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")


def _state(seed, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"dense.weight": torch.randn(6, 4, generator=g),
                       "dense.bias": torch.randn(4, generator=g).to(dtype)},
            "count": 3}


def test_managers_write_the_same_store_with_retention(tmp_path):
    """The same named state (fp32 and bf16 leaves, a Python int) saved at
    steps 1-3 by each package's manager under keep-last-2: the stores are
    byte-equal."""
    jm = JManager(str(tmp_path / "jax"), policy=JPolicy(keep_last_k=2),
                  async_save=False)
    tm = CheckpointManager(str(tmp_path / "port"),
                           policy=RetentionPolicy(keep_last_k=2))
    for step in (1, 2, 3):
        st = _state(step, torch.bfloat16)
        jstate = {"params": {
            "dense.weight": jnp.asarray(st["params"]["dense.weight"].numpy()),
            "dense.bias": jnp.asarray(
                st["params"]["dense.bias"].float().numpy(), jnp.bfloat16)},
            "count": 3}
        jm.save(step, jstate, plan_fingerprint="p", meta={"s": step})
        tm.save(step, st, plan_fingerprint="p", meta={"s": step})
    jm.wait()
    tm.wait()
    assert tm.all_steps() == jm.all_steps() == [2, 3]
    assert _files(tmp_path / "jax") == _files(tmp_path / "port")


def test_async_save_and_restore_in_place(tmp_path):
    """An asynchronous save returns after its host copies: writing the
    live state right after does not reach the checkpoint.  A restore into
    the live state keeps every tensor's address; a plain one gives fresh
    tensors with the saved values; a failed write surfaces on ``wait``."""
    mgr = CheckpointManager(str(tmp_path / "ckpt"))
    state = _state(0, torch.bfloat16)
    saved = {k: v.clone() for k, v in state["params"].items()}
    mgr.save(5, state)
    for v in state["params"].values():
        v.add_(1)
    mgr.wait()
    assert mgr.latest_step() == 5 and mgr.last_bytes == 6 * 4 * 4 + 4 * 2 + 8
    ptrs = {k: v.data_ptr() for k, v in state["params"].items()}
    back = mgr.restore(state, in_place=True)
    for k, v in back["params"].items():
        assert v.data_ptr() == ptrs[k] and torch.equal(v, saved[k])
    fresh = mgr.restore(_state(9, torch.bfloat16))
    for k, v in fresh["params"].items():
        assert torch.equal(v, saved[k]) and v.dtype == saved[k].dtype
    assert fresh["count"] == 3
    stats = tmetrics.snapshot()
    assert stats["saves"] == 1 and stats["restores"] == 2

    def broken(*a, **k):
        raise OSError("disk full")
    mgr.store.write_step = broken
    mgr.save(6, state)
    with pytest.raises(CheckpointSaveError):
        mgr.wait()
    assert mgr.latest_step() == 5


def test_in_place_restore_of_a_corrupt_step_leaves_the_state(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(1, _state(1))
    man = mgr.store.read_manifest(1)
    path = mgr.store.chunk_path(
        man["leaves"]["params.dense.bias"]["chunks"][0]["hash"])
    with open(path, "r+b") as f:
        f.write(b"\x00\x01")
    live = _state(2)
    before = {k: v.clone() for k, v in live["params"].items()}
    with pytest.raises(ChunkCorruptionError):
        mgr.restore(live, in_place=True)
    for k, v in live["params"].items():
        assert torch.equal(v, before[k]), k


def _gather(state):
    return {k: (v.gather("cpu") if isinstance(v, DistributedArray) else v)
            for k, v in state.params.items()}


def test_zero2_dp4_restores_at_dp2_and_resumes_bitwise(tmp_path):
    """``test_zero_resume.py`` on the port: 2 steps of the narrow MLP
    under ``Zero2Parallel`` at degree 4 on CPU devices, saved; at degree 2
    the saved plan's fingerprint is refused, the state restored into the
    degree-2 layout (each block through ``read_leaf_slice``) equals the
    saved one, and its next step equals the step from a replicated
    restore bit for bit."""
    from torch.utils import _pytree as pytree
    step4 = ttesting.get_mlp_train_step(Zero2Parallel(devices=["cpu"] * 4),
                                        use_value_and_grad=True)
    state4, batch = ttesting.create_mlp_train_state_and_batch(
        16, hidden_dim=64)
    for _ in range(2):
        state4, _ = step4(state4, batch)
    sharded = [x for x in pytree.tree_leaves(state4.opt_state)
               if isinstance(x, DistributedArray) and any(x.spec)]
    assert sharded, "the optimizer state is ZeRO-partitioned at save"
    truth = {k: v.clone() for k, v in _gather(state4).items()}
    mgr = CheckpointManager(str(tmp_path / "ckpt"), async_save=False)
    mgr.save(2, state4, executable=step4.get_last_executable())

    step2 = ttesting.get_mlp_train_step(Zero2Parallel(devices=["cpu"] * 2),
                                        use_value_and_grad=True)
    seed2, _ = ttesting.create_mlp_train_state_and_batch(16, hidden_dim=64)
    layout, _ = step2(seed2, batch)
    ex2 = step2.get_last_executable()
    assert ex2.get_plan_fingerprint() != \
        step4.get_last_executable().get_plan_fingerprint()
    with pytest.raises(PlanFingerprintMismatch):
        mgr.restore(ttesting.create_mlp_train_state_and_batch(
            16, hidden_dim=64)[0], executable=ex2)
    restored = mgr.restore(layout)
    assert any(isinstance(x, DistributedArray) and any(x.spec) and
               x.logical_mesh.num_devices == 2
               for x in pytree.tree_leaves(restored.opt_state))
    for k, v in _gather(restored).items():
        assert torch.equal(v, truth[k]), k
    host = mgr.restore(ttesting.create_mlp_train_state_and_batch(
        16, hidden_dim=64)[0])
    next_a, loss_a = step2(restored, batch)
    next_b, loss_b = step2(host, batch)
    assert torch.equal(torch.as_tensor(loss_a), torch.as_tensor(loss_b))
    for k, v in _gather(next_a).items():
        assert torch.equal(v, _gather(next_b)[k]), k
