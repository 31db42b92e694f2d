"""The port's per-leaf checkpoint directories (``alpa_tpu_torch/
serialization.py``) against the JAX package's, with the cases of
``tests/runtime/test_serialization_guards.py`` run on both packages.

For the same named numpy leaves the two write byte-equal directories
(metadata, indices, ``.npy`` shards); a bf16 leaf's shard has the header
``ml_dtypes`` writes; a ``DistributedArray`` writes one file per distinct
block (replicas skipped) that the JAX package reads back whole; the
async mover's failures surface from ``checkpoint_wait``; a corrupt
directory fails validation naming its leaf.  Everything is written under
``tmp_path``.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from alpa_tpu import serialization as jser
from alpa_tpu_torch import serialization as tser
from alpa_tpu_torch.device_mesh import DistributedArray, PhysicalDeviceMesh
from alpa_tpu_torch.model import model_util as tmu

PKGS = {"jax": jser, "port": tser}


@pytest.fixture(autouse=True)
def _keep_rng():
    with torch.random.fork_rng():
        yield


def _state():
    return {"w": np.arange(8, dtype=np.float32),
            "b": np.ones((2, 3), np.float32),
            "opt": ({"mu": np.full((4,), 0.5, np.float32)}, {}),
            "step": np.asarray(3, np.int64)}


def _files(root):
    out = {}
    for dirpath, _dirs, names in os.walk(root):
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_directories_equal_jax_for_the_same_numpy_leaves(tmp_path):
    for name, mod in PKGS.items():
        mod.save_checkpoint(str(tmp_path / name), _state(), step=4)
    files = _files(tmp_path / "port")
    assert files == _files(tmp_path / "jax")
    assert "opt.0.mu/shard_p0_0.npy" in files
    assert json.loads(files["metadata.json"])["leaves"]["step"] == {
        "shape": [], "dtype": "int64"}


def test_bf16_shards_have_the_jax_header_and_round_trip(tmp_path):
    """A bf16 tensor saved by the port and the same values as a JAX bf16
    array saved by JAX: byte-equal files; the port restores JAX's bit for
    bit."""
    t = torch.randn(5, 3, generator=torch.Generator().manual_seed(0)).to(
        torch.bfloat16)
    jarr = jnp.asarray(t.float().numpy(), jnp.bfloat16)
    tser.save_checkpoint(str(tmp_path / "port"), {"x": t}, step=1)
    jser.save_checkpoint(str(tmp_path / "jax"), {"x": jarr}, step=1)
    assert _files(tmp_path / "port") == _files(tmp_path / "jax")
    back = tser.restore_checkpoint(str(tmp_path / "jax"),
                                   {"x": torch.zeros(5, 3, dtype=torch.bfloat16)})
    assert back["x"].dtype == torch.bfloat16 and torch.equal(back["x"], t)
    # the JAX package cannot read a bf16 shard back (numpy has no cast
    # from the '<V2' it loads); it fails alike on its own directory
    for name in ("port", "jax"):
        with pytest.raises(ValueError, match="cast"):
            jser.restore_checkpoint(str(tmp_path / name),
                                    {"x": np.zeros((5, 3), np.float32)})


def test_distributed_blocks_replicas_skipped_and_read_by_jax(tmp_path):
    """A ``DistributedArray`` sharded over one axis of a (2, 2) mesh of
    CPU devices: two files (the replicas skipped) with their global
    slices; JAX assembles the whole array; the port restores it into
    another layout, each block from its slice, and in place."""
    mesh = PhysicalDeviceMesh(["cpu"] * 4).get_logical_mesh((2, 2))
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    arr = DistributedArray.from_full(full, ((0,), ()), mesh)
    tser.save_checkpoint(str(tmp_path / "ck"), {"a": arr}, step=2)
    with open(tmp_path / "ck" / "a" / "index_p0.json") as f:
        index = json.load(f)
    assert index == [{"file": "shard_p0_0.npy", "slice": [[0, 2], [0, 6]]},
                     {"file": "shard_p0_1.npy", "slice": [[2, 4], [0, 6]]}]
    jback = jser.restore_checkpoint(str(tmp_path / "ck"),
                                    {"a": np.zeros((4, 6), np.float32)})
    np.testing.assert_array_equal(np.asarray(jback["a"]), full.numpy())
    other = DistributedArray.from_full(torch.zeros(4, 6), ((), (1,)), mesh)
    back = tser.restore_checkpoint(str(tmp_path / "ck"), {"a": other})
    assert back["a"].spec == ((), (1,))
    assert torch.equal(back["a"].gather("cpu"), full)
    ptrs = [s.data_ptr() for s in other.shards]
    tser.restore_checkpoint(str(tmp_path / "ck"), {"a": other},
                            in_place=True)
    assert [s.data_ptr() for s in other.shards] == ptrs
    assert torch.equal(other.gather("cpu"), full)


def test_train_state_leaf_names(tmp_path):
    """A port ``TrainState`` saves ``step``, ``params`` and
    ``opt_state`` by flax's state-dict names and restores into a fresh
    state of the same structure."""
    params = {"dense.weight": torch.ones(2, 3), "dense.bias": torch.zeros(3)}
    state = tmu.TrainState.create(apply_fn=None, params=params,
                                  tx=tmu.adam(1e-3))
    tser.save_checkpoint(str(tmp_path / "ck"), state, step=0)
    meta = tser.load_checkpoint_metadata(str(tmp_path / "ck"))
    assert sorted(meta["leaves"]) == [
        "opt_state.0.count", "opt_state.0.mu.dense.bias",
        "opt_state.0.mu.dense.weight", "opt_state.0.nu.dense.bias",
        "opt_state.0.nu.dense.weight", "params.dense.bias",
        "params.dense.weight", "step"]
    fresh = tmu.TrainState.create(
        apply_fn=None, params={k: torch.full_like(v, 7.0)
                               for k, v in params.items()},
        tx=tmu.adam(1e-3))
    back = tser.restore_checkpoint(str(tmp_path / "ck"), fresh)
    assert back.step == 0 and isinstance(back, tmu.TrainState)
    for k, v in back.params.items():
        assert torch.equal(v, params[k])


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_async_mover_failure_raises_from_wait_and_cleans(tmp_path, pkg):
    mod = PKGS[pkg]
    mover = mod._AsyncMover()
    src = tmp_path / "src_leaf"
    dst = tmp_path / "final" / "leaf"
    src.mkdir()
    (src / "shard_p0_0.npy").write_bytes(b"x" * 16)
    (src / "shard_p0_1.npy").write_bytes(b"y" * 16)
    real_move = mod._AsyncMover._move

    def dying_move(s, d):
        os.makedirs(d, exist_ok=True)
        shutil.copy(os.path.join(s, "shard_p0_0.npy"),
                    os.path.join(d, "shard_p0_0.npy"))
        raise OSError("NFS went away")

    mover._move = dying_move
    mover.submit(str(src), str(dst))
    with pytest.raises(mod.CheckpointCorruptError, match="NFS went away"):
        mover.wait()
    assert not dst.exists()
    mover._move = real_move
    mover.submit(str(src), str(dst))
    mover.wait()
    assert sorted(os.listdir(dst)) == ["shard_p0_0.npy", "shard_p0_1.npy"]


@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_cache_dir_drain_failure_surfaces(tmp_path, monkeypatch, pkg):
    mod = PKGS[pkg]
    calls = []
    real_move = mod._AsyncMover._move

    def boom_first(src, dst):
        calls.append(src)
        if len(calls) == 1:
            raise OSError("disk full")
        return real_move(src, dst)

    monkeypatch.setattr(mod._AsyncMover, "_move", staticmethod(boom_first))
    mod.save_checkpoint(str(tmp_path / "final"), _state(), step=1,
                        local_cache_dir=str(tmp_path / "cache"))
    with pytest.raises(mod.CheckpointCorruptError, match="disk full"):
        mod.checkpoint_wait()
    mod.checkpoint_wait()


def _corrupt(case, ckpt):
    """Damage a saved directory as the JAX guard test's case does."""
    idx = os.path.join(ckpt, "w", "index_p0.json")
    if case == "missing_leaf_dir":
        shutil.rmtree(os.path.join(ckpt, "w"))
    elif case == "missing_shard_file":
        os.unlink(os.path.join(ckpt, "w", "shard_p0_0.npy"))
    elif case == "empty_shard_file":
        open(os.path.join(ckpt, "w", "shard_p0_0.npy"), "w").close()
    elif case == "empty_index":
        with open(idx, "w") as f:
            json.dump([], f)
    elif case in ("out_of_bounds_slice", "coverage_hole"):
        with open(idx) as f:
            index = json.load(f)
        index[0]["slice"] = [[0, 16]] if case == "out_of_bounds_slice" \
            else [[0, 4]]
        with open(idx, "w") as f:
            json.dump(index, f)
    elif case == "metadata_truncated_json":
        with open(os.path.join(ckpt, "metadata.json"), "w") as f:
            f.write('{"step": 1, "leav')
    elif case == "metadata_wrong_structure":
        with open(os.path.join(ckpt, "metadata.json"), "w") as f:
            json.dump({"step": 1}, f)
    elif case == "metadata_missing":
        os.unlink(os.path.join(ckpt, "metadata.json"))


GUARDS = {"happy_path": None,
          "missing_leaf_dir": "missing leaf directory",
          "missing_shard_file": "missing or empty",
          "empty_shard_file": "missing or empty",
          "empty_index": "no usable index",
          "out_of_bounds_slice": "outside",
          "coverage_hole": "cover",
          "metadata_missing": "no metadata.json",
          "metadata_truncated_json": "unreadable",
          "metadata_wrong_structure": "leaves"}


@pytest.mark.parametrize("case", sorted(GUARDS))
@pytest.mark.parametrize("pkg", sorted(PKGS))
def test_validation_guards_as_jax(tmp_path, pkg, case):
    mod = PKGS[pkg]
    ckpt = str(tmp_path / "ckpt")
    mod.save_checkpoint(ckpt, _state(), step=1)
    _corrupt(case, ckpt)
    if GUARDS[case] is None:
        mod.validate_checkpoint(ckpt)
        restored = mod.restore_checkpoint(ckpt, _state())
        np.testing.assert_array_equal(np.asarray(restored["w"]),
                                      np.arange(8, dtype=np.float32))
        return
    with pytest.raises(mod.CheckpointCorruptError, match=GUARDS[case]):
        mod.restore_checkpoint(ckpt, _state())
