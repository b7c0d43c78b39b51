"""Checkpoint lifecycle: discovery, validation, rotation, async double-buffer
(↔ paddle_tpu/distributed/checkpoint/manager.py).

The durable layout under a checkpoint root is

    root/
      step_100/        committed: COMMIT marker + 0.metadata + *.distcp
      step_200/
      step_300.tmp/    a save that died mid-write (ignored, swept by rotation)

`latest_checkpoint(root)` walks the step directories newest-first and returns
the first one that VALIDATES (commit marker present, metadata parseable,
every referenced shard file on disk with a matching crc32) — a truncated,
corrupt, or uncommitted checkpoint is skipped with a warning and the previous
good step is used: a crash at any point costs at most the steps since the
last commit, never the run.

`CheckpointManager` drives periodic saves for a training loop: step-numbered
directories, keep-last-N rotation (oldest committed dirs removed after the
new commit lands, markers first so a crash mid-delete can't fake a valid
checkpoint), and optional async double-buffered saves (device→host snapshot
on the train thread, write+commit+rotate on one background thread, at most
one save in flight). With a live step, `mgr.save(step.train_state(), n)` and
`mgr.restore_latest(step.train_state())` save and restore its parameters,
buffers and optimizer state.
"""

from __future__ import annotations

import collections
import os
import re
import shutil
import sys
import threading

import torch

from ...framework.core import Tensor

from .load_state_dict import load_state_dict
from .metadata import COMMIT_FILE, CheckpointCorruptError, LocalShard, \
    Metadata, crc32_file, metadata_path
from .save_state_dict import (_rank_and_world, _snapshot, _write_and_commit,
                              save_state_dict)

__all__ = [
    "CheckpointInfo", "latest_checkpoint", "validate_checkpoint",
    "checkpoint_steps", "CheckpointManager", "wait_async_save",
]

_STEP_RE = re.compile(r"^step_(\d+)$")


def _tensors(state_dict):
    """The torch tensors a load of `state_dict` writes in place."""
    out = []
    for v in state_dict.values():
        for part in v if isinstance(v, (list, tuple)) else [v]:
            t = part.tensor if isinstance(part, LocalShard) else part
            t = t._value if isinstance(t, Tensor) else t
            if isinstance(t, torch.Tensor):
                out.append(t)
    return out

CheckpointInfo = collections.namedtuple("CheckpointInfo", ["path", "step"])


# --------------------------------------------------------------------------- #
# discovery / validation
# --------------------------------------------------------------------------- #

def checkpoint_steps(root):
    """All step-numbered checkpoint dirs under `root` (committed or not),
    sorted ascending by step: [(step, path)]."""
    try:
        names = os.listdir(root)
    except OSError:
        return []
    out = []
    for d in names:
        m = _STEP_RE.match(d)
        p = os.path.join(root, d)
        if m and os.path.isdir(p):
            out.append((int(m.group(1)), p))
    return sorted(out)


def validate_checkpoint(path, verify_checksums=True):
    """(ok, reason) — commit marker present, metadata loads, every referenced
    shard file exists and (when recorded) matches its crc32."""
    if not os.path.isfile(os.path.join(path, COMMIT_FILE)):
        return False, "no COMMIT marker (save was interrupted)"
    try:
        meta = Metadata.load(metadata_path(path))
    except (OSError, ValueError, KeyError, TypeError) as e:
        return False, f"metadata unreadable: {e!r}"
    files = {m.file_name
             for v in meta.state_dict_metadata.values() for m in v}
    for fname in sorted(files):
        fpath = os.path.join(path, fname)
        if not os.path.isfile(fpath):
            return False, f"shard file missing: {fname}"
        expected = meta.file_checksums.get(fname, "")
        if verify_checksums and expected:
            try:
                if crc32_file(fpath) != expected:
                    return False, f"shard file corrupt (crc mismatch): {fname}"
            except OSError as e:
                # EIO/EACCES/vanished-under-us are exactly the cases
                # discovery must fall back past, not crash on
                return False, f"shard file unreadable: {fname} ({e})"
    return True, ""


def latest_checkpoint(root, verify_checksums=True):
    """Newest VALID checkpoint under `root`, or None. Falls back past
    corrupt/partial/uncommitted steps (each skip is logged to stderr)."""
    for step, path in reversed(checkpoint_steps(root)):
        ok, reason = validate_checkpoint(path, verify_checksums)
        if ok:
            return CheckpointInfo(path, step)
        print(f"[checkpoint] skipping {path}: {reason}", file=sys.stderr)
    return None


# --------------------------------------------------------------------------- #
# async double-buffered saver
# --------------------------------------------------------------------------- #

class _SaveHandle(threading.Thread):
    def __init__(self, fn):
        super().__init__(daemon=True, name="ckpt-async-save")
        self._fn = fn
        self._exc = None

    def run(self):
        try:
            self._fn()
        except BaseException as e:  # surfaced on wait()/next submit
            self._exc = e

    def result(self, timeout=None):
        self.join(timeout)
        if self.is_alive():
            raise TimeoutError("async checkpoint save still in flight")
        if self._exc is not None:
            raise self._exc


class _AsyncSaver:
    """At most ONE save in flight. submit() first drains the previous save
    (re-raising its failure), so commits stay ordered and memory is bounded
    to two snapshots: the one being written and the one just taken."""

    def __init__(self):
        self._lock = threading.Lock()
        self._pending = None

    def submit(self, fn):
        with self._lock:
            self._drain()
            h = _SaveHandle(fn)
            h.start()
            self._pending = h
            return h

    def _drain(self):
        h, self._pending = self._pending, None
        if h is not None:
            h.result()

    def wait(self):
        with self._lock:
            self._drain()


_async_saver = _AsyncSaver()


def wait_async_save():
    """Drain the module-level saver used by bare `save_state_dict(...,
    async_save=True)` calls; re-raises its exception on failure. Each
    CheckpointManager owns a separate saver — use `manager.wait()` there."""
    _async_saver.wait()


# --------------------------------------------------------------------------- #
# manager
# --------------------------------------------------------------------------- #

class CheckpointManager:
    """Periodic checkpointing with rotation for a training loop.

        mgr = CheckpointManager(root, keep_last_n=3, async_save=True)
        start = mgr.restore_latest(state_dict)   # None on a fresh run
        ...
        mgr.save(state_dict, step)
        ...
        mgr.wait()                               # flush before exit
    """

    def __init__(self, root, keep_last_n=3, async_save=False):
        self.root = root
        self.keep_last_n = max(1, int(keep_last_n))
        self.async_save = async_save
        # own saver, not the module singleton: two managers (e.g. model vs
        # EMA roots) must not serialize behind each other or surface each
        # other's failures
        self._saver = _AsyncSaver()
        os.makedirs(root, exist_ok=True)

    def path_for(self, step):
        return os.path.join(self.root, f"step_{int(step)}")

    def save(self, state_dict, step):
        """Atomically commit `state_dict` as step `step`; rotation runs after
        the commit (on the saver thread when async)."""
        path = self.path_for(step)
        if self.async_save and _rank_and_world()[1] == 1:
            plan = _snapshot(state_dict)
            return self._saver.submit(
                lambda: _write_and_commit(plan, path, 0,
                                          post_commit=self._rotate))
        return save_state_dict(state_dict, path, _post_commit=self._rotate)

    def wait(self):
        self._saver.wait()

    def latest(self, verify_checksums=True):
        return latest_checkpoint(self.root, verify_checksums)

    def restore_latest(self, state_dict):
        """Load the newest valid checkpoint into `state_dict` (in place,
        onto each tensor's current placement). Returns the step restored
        from, or None when no valid checkpoint exists.

        Checksums are verified once, by the load itself — discovery here
        checks structure only (COMMIT + metadata + file presence) so a
        multi-GB restore doesn't read and crc every shard file twice. A
        load-time corruption hit falls back to the next older candidate.
        The load writes the tensors in place, so each candidate's load is
        preceded by a copy of the live values (on their device) that a
        failed load is rolled back to."""
        for step, path in reversed(checkpoint_steps(self.root)):
            ok, reason = validate_checkpoint(path, verify_checksums=False)
            if not ok:
                print(f"[checkpoint] skipping {path}: {reason}",
                      file=sys.stderr)
                continue
            snapshot = [(t, t.detach().clone()) for t in _tensors(state_dict)]
            try:
                load_state_dict(state_dict, path)
                return step
            except BaseException as e:
                # roll back on ANY mid-load failure — a KeyError (key absent
                # from this checkpoint) or a KeyboardInterrupt leaves the
                # same half-mutated mix corruption does
                with torch.no_grad():
                    for t, old in snapshot:
                        t.copy_(old)
                if not isinstance(e, CheckpointCorruptError):
                    raise
                print(f"[checkpoint] skipping {path}: {e}", file=sys.stderr)
        return None

    def _rotate(self):
        """Drop committed checkpoints beyond keep_last_n (oldest first) and
        sweep stale .tmp dirs. Runs post-commit, so an in-flight save can
        never be rotated away. COMMIT marker is removed before the rmtree:
        a crash mid-delete leaves an invalid husk, not a liar."""
        steps = checkpoint_steps(self.root)
        committed = [(s, p) for s, p in steps
                     if os.path.isfile(os.path.join(p, COMMIT_FILE))]
        for _, path in committed[:-self.keep_last_n]:
            self._remove(path)
        # only sweep .tmp dirs at or below the newest committed step: in
        # multi-process runs the commit barrier releases peers before this
        # post_commit hook runs, so a HIGHER-step .tmp may already be the
        # next save being written
        newest = committed[-1][0] if committed else -1
        for d in os.listdir(self.root):
            m = _STEP_RE.match(d[:-4]) if d.endswith(".tmp") else None
            if m and int(m.group(1)) <= newest:
                shutil.rmtree(os.path.join(self.root, d), ignore_errors=True)

    @staticmethod
    def _remove(path):
        try:
            os.unlink(os.path.join(path, COMMIT_FILE))
        except OSError:
            pass
        shutil.rmtree(path, ignore_errors=True)
