"""CheckpointManager (cmcd_tpu/utils/checkpoint.py): numpy .npz entries, one
directory per step, atomic commit, max_to_keep, background writes."""

import os

import jax
import jax.numpy as jnp
import numpy as onp
import optax
import pytest

from cmcd_tpu.utils.checkpoint import CheckpointManager


def _state(v):
    params = {"train": {"a": jnp.full((3,), v), "b": jnp.ones((2, 2)) * v},
              "notrain": {"n": jnp.arange(4, dtype=jnp.int32)}}
    return params, optax.adam(1e-3).init(params["train"])


def test_roundtrip_keeps_structure_values_and_dtypes(tmp_path):
    params, opt_state = _state(2.5)
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(12, params, opt_state=opt_state, key=jax.random.PRNGKey(3),
              extra={"ema": params["train"]}, wait=True)
    template = {"params": _state(0.0)[0], "opt_state": _state(0.0)[1],
                "key": jax.random.PRNGKey(0), "extra": {"ema": _state(0.0)[0]["train"]}}
    step, restored = mngr.restore(template=template)
    assert step == 12
    assert jax.tree_util.tree_structure(restored) == jax.tree_util.tree_structure(template)
    for got, want in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(
            {"params": params, "opt_state": opt_state, "key": jax.random.PRNGKey(3),
             "extra": {"ema": params["train"]}})):
        assert got.dtype == want.dtype
        onp.testing.assert_array_equal(onp.asarray(got), onp.asarray(want))
    assert os.listdir(tmp_path) == ["12"]
    mngr.close()


def test_async_save_then_wait_commits(tmp_path):
    mngr = CheckpointManager(str(tmp_path))
    params, _ = _state(1.0)
    mngr.save(5, params)  # returns before the write is durable
    mngr.wait()
    assert mngr.all_steps() == [5]
    assert os.path.isfile(tmp_path / "5" / "state.npz")
    # The host copy was taken at save time: later changes do not leak in.
    step, leaves = mngr.restore()
    assert step == 5 and len(leaves) == len(jax.tree_util.tree_leaves({"params": params}))


def test_max_to_keep_prunes_oldest(tmp_path):
    mngr = CheckpointManager(str(tmp_path), max_to_keep=2)
    for step in (10, 20, 30, 40):
        mngr.save(step, _state(float(step))[0])
    mngr.wait()
    assert mngr.all_steps() == [30, 40]
    assert sorted(os.listdir(tmp_path)) == ["30", "40"]
    _, restored = mngr.restore(template={"params": _state(0.0)[0]})
    onp.testing.assert_allclose(onp.asarray(restored["params"]["train"]["a"]), 40.0)


def test_uncommitted_temporary_is_never_latest(tmp_path):
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(10, _state(1.0)[0], wait=True)
    # A write killed before its rename leaves a temporary entry behind, and
    # a directory without a state file is not a checkpoint either.
    os.makedirs(tmp_path / "50.tmp-0")
    (tmp_path / "50.tmp-0" / "state.npz").write_bytes(b"partial")
    os.makedirs(tmp_path / "60")
    assert mngr.latest_step() == 10
    assert CheckpointManager(str(tmp_path)).latest_step() == 10


def test_empty_directory_restores_nothing(tmp_path):
    mngr = CheckpointManager(str(tmp_path / "new"))
    assert mngr.latest_step() is None
    assert mngr.restore() == (None, None)


def test_template_with_other_structure_is_refused(tmp_path):
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(1, _state(1.0)[0], wait=True)
    with pytest.raises(ValueError, match="leaves"):
        mngr.restore(template={"params": {"only": jnp.zeros(3)}})


def test_same_step_saved_twice_keeps_the_newer(tmp_path):
    mngr = CheckpointManager(str(tmp_path))
    mngr.save(7, _state(1.0)[0], wait=True)
    mngr.save(7, _state(9.0)[0], wait=True)
    _, restored = mngr.restore(template={"params": _state(0.0)[0]})
    onp.testing.assert_allclose(onp.asarray(restored["params"]["train"]["a"]), 9.0)


def test_failed_write_surfaces_in_wait(tmp_path, monkeypatch):
    mngr = CheckpointManager(str(tmp_path))

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(onp, "savez", broken)
    mngr.save(3, _state(1.0)[0])
    with pytest.raises(OSError, match="disk full"):
        mngr.wait()
    assert mngr.all_steps() == []
    assert os.listdir(tmp_path) == []


def test_many_concurrent_saves_leave_a_consistent_directory(tmp_path):
    """More background writers than cores, committing in any order: the
    newest max_to_keep steps survive, each restorable."""
    mngr = CheckpointManager(str(tmp_path), max_to_keep=3)
    steps = list(range(1, 4 * (os.cpu_count() or 1) + 9))
    for step in steps:
        mngr.save(step, _state(float(step))[0])
    mngr.wait()
    assert mngr.all_steps() == steps[-3:]
    assert sorted(os.listdir(tmp_path), key=int) == [str(s) for s in steps[-3:]]
    for step in steps[-3:]:
        _, restored = mngr.restore(step, template={"params": _state(0.0)[0]})
        onp.testing.assert_allclose(
            onp.asarray(restored["params"]["train"]["a"]), float(step))
