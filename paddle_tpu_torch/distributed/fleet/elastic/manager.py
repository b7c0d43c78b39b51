"""Elastic fault detection and recovery
(↔ paddle_tpu/distributed/fleet/elastic/manager.py, the same code; reference:
python/paddle/distributed/fleet/elastic/manager.py: ElasticManager :125,
the LauncherInterface watchdog, np range N:M scaling).

The rendezvous substrate is the native TCPStore (`distributed.store`,
`csrc/host/tcp_store.cc`) instead of etcd. Each node heartbeats
`<job>/heartbeat/<rank>` with a timestamp; the manager watches the live set
against the `np` range: a missing heartbeat marks the node dead, shrinking
below min-nodes makes the job not ready (the launcher tears down and
restarts the pod, `distributed.launch`'s restart loop), and a rejoin within
the range resumes. A card that fails surfaces as a CUDA or NCCL error that
kills the worker, which the same loop catches.
"""

from __future__ import annotations

import os
import time

__all__ = ["ElasticStatus", "ElasticManager"]


class ElasticStatus:
    COMPLETED = "completed"  # training finished (complete() was called)
    ERROR = "error"
    HOLD = "hold"            # below min nodes: wait for rejoin
    RESTART = "restart"      # live set can still grow / changed: re-form
    EXIT = "exit"
    OK = "ok"                # healthy full cluster, no action (not in Paddle)


class ElasticManager:
    """reference elastic/manager.py:125."""

    def __init__(self, store=None, job_id=None, np_range=None, rank=None,
                 heartbeat_interval=2.0, timeout=10.0):
        self.job_id = job_id or os.environ.get("PADDLE_JOB_ID", "default")
        np_spec = np_range or os.environ.get("PADDLE_ELASTIC_NP", "1")
        if isinstance(np_spec, str) and ":" in np_spec:
            lo, hi = np_spec.split(":")
            self.min_np, self.max_np = int(lo), int(hi)
        else:
            self.min_np = self.max_np = int(np_spec)
        self.rank = rank if rank is not None else int(
            os.environ.get("PADDLE_TRAINER_ID", "0"))
        self.heartbeat_interval = heartbeat_interval
        self.timeout = timeout
        if store is None:
            from ...store import create_or_get_global_tcp_store

            store = create_or_get_global_tcp_store()
        self.store = store
        self.enable = self.max_np > 1 or self.min_np != self.max_np
        self._stopped = False
        # reform tracking: a formed job that loses a node (below min ⇒ HOLD,
        # or a shrink within the runnable band) must make every survivor
        # observe exactly one reform signal, so collective groups re-form
        # around the new membership. The signal is a GENERATION COUNTER in
        # the shared store (not a local flag): nodes whose polls never
        # landed inside the shrink window still see the bumped generation.
        # `last_restart_was_reform` distinguishes that signal from the
        # steady "can still scale up" RESTART of a partial band, which a
        # runnable cluster must NOT keep exiting on. Growth within the band
        # (a node joining a runnable partial cluster) is a scale-out event
        # for the launcher, not an in-step reform: growth to full strength
        # reads OK.
        self._was_ready = False
        self._bump_pending = False
        self._last_alive = None
        self._reform_gen_seen = None
        self.last_restart_was_reform = False

    # ------------------------------------------------------------------ #

    def _key(self, rank):
        return f"{self.job_id}/heartbeat/{rank}"

    def _reform_key(self):
        return f"{self.job_id}/reform_gen"

    def _reform_gen(self):
        probe = getattr(self.store, "tryget", None)
        try:
            raw = probe(self._reform_key()) if probe else None
            if not raw:
                return 0
            try:
                return int(raw)  # decimal (fake stores)
            except ValueError:
                # native ADD stores 8-byte little-endian i64
                return int.from_bytes(raw[:8], "little", signed=True)
        except (OSError, RuntimeError, ConnectionError):
            # store unreachable mid-poll: treat as "no reform signal yet";
            # the next watch() tick re-probes
            return 0

    def heartbeat(self):
        """Publish this node's liveness (reference: etcd lease refresh)."""
        self.store.set(self._key(self.rank), str(time.time()).encode())

    def alive_nodes(self):
        """Ranks whose heartbeat is fresher than the timeout."""
        now = time.time()
        alive = []
        probe = getattr(self.store, "tryget", None)
        if probe is None:
            # a blocking get() on a dead rank's key would stall the scan for
            # the full io timeout — exactly what this probe exists to avoid
            raise TypeError(
                "ElasticManager requires a store with a non-blocking "
                "tryget() (native TCPStore)")
        for r in range(self.max_np):
            try:
                raw = probe(self._key(r))
            except (OSError, RuntimeError, ConnectionError):
                continue  # unreadable heartbeat == not provably alive
            if not raw:
                continue
            try:
                ts = float(raw.decode())
            except ValueError:
                continue
            if now - ts <= self.timeout:
                alive.append(r)
        return alive

    def is_ready(self):
        """Job can (re)start: live nodes within [min_np, max_np]."""
        return len(self.alive_nodes()) >= self.min_np

    def complete(self):
        """Mark the job finished (reference: trainers reporting completion
        before the manager exits the watch loop)."""
        self.store.set(f"{self.job_id}/completed", b"1")

    def is_completed(self):
        probe = getattr(self.store, "tryget", None)
        try:
            return bool(probe and probe(f"{self.job_id}/completed"))
        except (OSError, RuntimeError, ConnectionError):
            return False  # store down != job done; keep polling

    def watch(self):
        """One scheduling decision (reference manager.watch loop):
        COMPLETED when training reported done, HOLD below min (wait for
        rejoin), RESTART while the live set can still change OR right after
        a hold ends (rejoin ⇒ re-form the groups), OK for a healthy full
        cluster."""
        self.last_restart_was_reform = False
        if self.is_completed():
            return ElasticStatus.COMPLETED
        alive = self.alive_nodes()
        alive_set = frozenset(alive)
        below = len(alive) < self.min_np

        # detect an un-signaled departure: a formed job entering HOLD, or a
        # shrink inside the runnable band. The pending flag is STICKY until
        # the generation actually advances — advancing local state before a
        # successful store.add() would lose the one-shot signal forever on
        # a transient store error.
        if below:
            if self._was_ready:
                self._bump_pending = True
            self._was_ready = False
            self._last_alive = None
        else:
            if self._last_alive is not None and self._last_alive - alive_set:
                self._bump_pending = True
            self._was_ready = True
            self._last_alive = alive_set

        # only the LOWEST surviving rank bumps for an event: all survivors
        # observe the same departure, and N bumps for one event would read
        # as N distinct reforms to late adopters
        if self._bump_pending and alive and self.rank == min(alive):
            try:
                self.store.add(self._reform_key(), 1)
                self._bump_pending = False
            except Exception:  # sticky: the pending flag survives, the bump is retried
                pass

        if below:
            return ElasticStatus.HOLD
        gen = self._reform_gen()
        if self._reform_gen_seen is None:
            # first formation sighting by this process: its own groups are
            # forming fresh anyway, nothing to re-form
            self._reform_gen_seen = gen
        elif gen > self._reform_gen_seen:
            self._reform_gen_seen = gen
            self._bump_pending = False  # signaled — by this node or a peer
            self.last_restart_was_reform = True
            return ElasticStatus.RESTART
        if len(alive) < self.max_np:
            return ElasticStatus.RESTART  # can still scale up (steady state)
        return ElasticStatus.OK

    def exit(self, completed=True):
        self._stopped = True
        if completed:
            try:
                self.complete()
            except Exception:  # the store may already be torn down
                pass
        try:
            self.store.delete_key(self._key(self.rank))
        except Exception:  # a leaked heartbeat key ages out
            pass
