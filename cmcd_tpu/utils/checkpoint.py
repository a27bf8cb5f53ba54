"""Periodic checkpointing and resume, written with numpy alone.

New capability vs the reference, which only pickles final params into a
wandb artifact (src/main.py:289-301) and cannot resume a run (SURVEY.md §5).
Checkpoints hold params, optimizer state, PRNG key, and the step counter.

Layout: one directory entry per checkpoint, named by its step number
(`<dir>/<step>/state.npz`). The state pytree is flattened to its leaves,
stored as `leaf_<i>` arrays, and rebuilt from a caller-supplied template with
the same structure. A write goes to `<step>.tmp-<n>` first and is renamed into
place, so a checkpoint killed mid-write never becomes `latest_step`.
"""

from __future__ import annotations

import itertools
import os
import shutil
import threading
from typing import Any, Optional

import jax
import numpy as onp

_STATE_FILE = "state.npz"
_TMP_MARK = ".tmp-"


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: int = 3):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self._max_to_keep = max_to_keep
        self._pending: list[threading.Thread] = []
        self._errors: list[BaseException] = []
        self._lock = threading.Lock()
        self._tmp_ids = itertools.count()

    def save(self, step: int, params, opt_state=None, key=None,
             extra: Optional[dict] = None, wait: bool = False):
        """Persist the full training state.

        Asynchronous by default: the arrays are copied to host memory before
        this returns, then written and committed by a background thread, so
        periodic checkpoints overlap with training. wait=True blocks until the
        write is durable (the trainer's final save)."""
        state = {"params": params}
        if opt_state is not None:
            state["opt_state"] = opt_state
        if key is not None:
            state["key"] = key
        if extra:
            state["extra"] = extra
        leaves = [onp.asarray(x) for x in jax.tree_util.tree_leaves(
            jax.device_get(state))]
        tmp = os.path.join(self._dir, f"{step}{_TMP_MARK}{next(self._tmp_ids)}")
        thread = threading.Thread(
            target=self._write, args=(step, tmp, leaves), daemon=True
        )
        thread.start()
        self._pending.append(thread)
        if wait:
            self.wait()

    def _write(self, step: int, tmp: str, leaves):
        try:
            os.makedirs(tmp)
            with open(os.path.join(tmp, _STATE_FILE), "wb") as f:
                onp.savez(f, **{f"leaf_{i}": x for i, x in enumerate(leaves)})
                f.flush()
                os.fsync(f.fileno())
            with self._lock:
                final = os.path.join(self._dir, str(step))
                if os.path.exists(final):
                    shutil.rmtree(final)
                os.rename(tmp, final)
                dir_fd = os.open(self._dir, os.O_RDONLY)
                try:
                    os.fsync(dir_fd)  # make the rename itself durable
                finally:
                    os.close(dir_fd)
                self._prune()
        except Exception as e:  # surfaced by wait()
            shutil.rmtree(tmp, ignore_errors=True)
            self._errors.append(e)

    def _prune(self):
        steps = self.all_steps()
        for step in steps[: max(len(steps) - self._max_to_keep, 0)]:
            shutil.rmtree(os.path.join(self._dir, str(step)), ignore_errors=True)

    def wait(self):
        """Block until all pending saves are committed; re-raise a failed
        write."""
        while self._pending:
            self._pending.pop(0).join()
        if self._errors:
            raise self._errors.pop(0)

    def all_steps(self) -> list[int]:
        """Committed checkpoint steps, ascending. Uncommitted temporaries are
        never listed."""
        return sorted(
            int(name) for name in os.listdir(self._dir)
            if name.isdigit()
            and os.path.isfile(os.path.join(self._dir, name, _STATE_FILE))
        )

    def latest_step(self) -> Optional[int]:
        self.wait()
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: Optional[int] = None, template: Any = None):
        """Returns (step, state). With a template the state has the
        template's pytree structure and each leaf the dtype and sharding of
        the template's leaf; without one it is the flat list of stored
        leaves."""
        self.wait()
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        with onp.load(os.path.join(self._dir, str(step), _STATE_FILE)) as data:
            leaves = [data[f"leaf_{i}"] for i in range(len(data.files))]
        if template is None:
            return step, leaves
        tpl_leaves, treedef = jax.tree_util.tree_flatten(template)
        if len(tpl_leaves) != len(leaves):
            raise ValueError(
                f"checkpoint {step} holds {len(leaves)} leaves; the template "
                f"has {len(tpl_leaves)}"
            )
        restored = [
            jax.device_put(
                x.astype(getattr(t, "dtype", x.dtype)),
                getattr(t, "sharding", None),
            )
            for x, t in zip(leaves, tpl_leaves)
        ]
        return step, jax.tree_util.tree_unflatten(treedef, restored)

    def close(self):
        self.wait()
