"""ResilientTrainer, the recovery story wired end to end
(↔ paddle_tpu/distributed/resilience.py).

It composes the port's survival organs into one training loop: the
launcher's restart loop (`launch/main.py`, PADDLE_RESTART_COUNT), the
ElasticManager's heartbeats and liveness (`fleet/elastic/manager.py`),
the comm watchdog (`comm_watchdog.comm_task`, `csrc/host/watchdog.cc`),
the crash-safe sharded checkpoint (`distributed/checkpoint/`), the fault
points and the flight recorder:

    step = DistributedTrainStep(model, loss_fn, opt)

    def step_fn(i):
        return step(x, y).item()        # one optimization step

    trainer = ResilientTrainer(step_fn, step.train_state, "ckpts",
                               save_every=100, step_timeout=600)
    trainer.run(num_steps)

Per failure mode:

* **Worker death or preemption** (a save included): the launcher respawns
  the pod; on entry `run()` restores from the newest committed checkpoint,
  skipping any uncommitted or corrupt save. The step offset comes from the
  checkpoint's directory name, not from any state the dead process held.
* **Hang** (a stuck collective or host sync): every step runs inside
  `comm_watchdog.comm_task` with a deadline; the watchdog's spill thread
  writes its report to PADDLE_WD_REPORT_FILE and (under the launcher) a
  FatalError line, which the LogWatcher turns into a pod teardown and a
  restart.
* **Node loss below min_np**: the elastic manager reports HOLD; the
  trainer pauses (heartbeating) until the cluster refills or
  `hold_timeout` expires, and honours the RESTART reform signal after a
  rejoin.
* **Corrupt checkpoint on disk**: the checksums reject it at restore, and
  discovery falls back to the previous committed step.

`load_state_dict` writes the saved shards onto each tensor's current
placement, so a pod that comes back with another mesh restores the same
global state. The reference's elastic plan adoption (`plan_path`,
`planner_cfg`, `on_plan`, `plan_devices`: re-planning the mesh with the
planner before the restore) comes with the planner, ROADMAP queue A item
7b-ii; until then those options raise NotImplementedError.
"""

from __future__ import annotations

import os
import sys
import threading
import time

from ..observability import flight as _flight
from ..observability import metrics as _metrics
from ..observability import spans as _spans
from . import comm_watchdog, faults
from .checkpoint.manager import CheckpointManager

__all__ = ["ResilientTrainer", "run_with_recovery", "REFORM_EXIT_CODE"]

# a worker exits with this code to ask the launcher's restart loop for an
# in-place pod re-form (distinct from faults.FAULT_EXIT_CODE and from
# ordinary crashes for the logs' sake: any non-zero code restarts)
REFORM_EXIT_CODE = 75

# the trainer's metric handles, resolved per registry instance (a
# reset_default_registry() between two trainers must not strand the second
# one on a dead registry)
_tm = _metrics.HandleCache(lambda reg: {
    "step": reg.histogram(
        "trainer_step_seconds", "ResilientTrainer wall time per step"),
    "ckpt": reg.histogram(
        "trainer_checkpoint_save_seconds",
        "checkpoint save latency (submit time for async saves)"),
    "hb_age": reg.gauge(
        "trainer_heartbeat_age_seconds",
        "seconds since this rank's last elastic heartbeat, sampled at "
        "step boundaries"),
    "wd": reg.counter(
        "trainer_watchdog_timeouts_total",
        "comm-watchdog deadline overruns observed by the trainer"),
})

# a persistently slow job trips the watchdog every step; one full post-
# mortem per overrun would grow PADDLE_FLIGHT_FILE without bound
_WD_DUMP_MIN_INTERVAL_S = 60.0

_PLANNER_OPTIONS = ("plan_path", "planner_cfg", "on_plan", "plan_devices")


class ResilientTrainer:
    """Drive `step_fn` for `num_steps` with periodic crash-safe checkpoints,
    elastic liveness, watchdog deadlines and auto-resume.

    Parameters
    ----------
    step_fn : callable(step: int) -> loss
        One optimization step. It must update the tensors that
        `state_dict` exposes (the TrainStep / optimizer contract).
    state_dict : dict | callable() -> dict
        name -> tensor map of the model and optimizer state, loaded in
        place on resume. A callable (a step's `train_state`) is evaluated
        again at each save and restore.
    ckpt_dir : str
        The checkpoint root (its step_N directories are managed).
    save_every : int
        Commit a checkpoint every N steps (and once at the end).
    keep_last_n : int
        How many committed checkpoints the rotation keeps.
    async_save : bool
        Background saves after a snapshot (single-process runs).
    elastic : ElasticManager | None
        When given: heartbeat each step, pause on HOLD, and exit with
        REFORM_EXIT_CODE on a reform signal if `exit_on_reform`.
    step_timeout : float | None
        Per-step watchdog deadline in seconds; enables the comm watchdog
        when set.
    plan_path, planner_cfg, on_plan, plan_devices
        The reference's elastic plan adoption; raise NotImplementedError
        (ROADMAP queue A item 7b-ii, the planner).
    """

    def __init__(self, step_fn, state_dict, ckpt_dir, *, save_every=100,
                 keep_last_n=3, async_save=True, elastic=None,
                 step_timeout=None, hold_poll=1.0, hold_timeout=300.0,
                 exit_on_reform=False, log=None, plan_path=None,
                 planner_cfg=None, on_plan=None, plan_devices=None):
        given = [n for n, v in zip(_PLANNER_OPTIONS, (plan_path, planner_cfg,
                                                      on_plan, plan_devices))
                 if v is not None]
        if given:
            raise NotImplementedError(
                f"ResilientTrainer({', '.join(given)}): elastic mesh-plan "
                "adoption needs the planner, ported with ROADMAP queue A "
                "item 7b-ii")
        self.step_fn = step_fn
        self._state_dict = state_dict
        self.manager = CheckpointManager(ckpt_dir, keep_last_n=keep_last_n,
                                         async_save=async_save)
        self.save_every = max(1, int(save_every))
        self.elastic = elastic
        self.step_timeout = step_timeout
        self.hold_poll = hold_poll
        self.hold_timeout = hold_timeout
        self.exit_on_reform = exit_on_reform
        self.plan = None             # no mesh plan is adopted (item 7b-ii)
        self.plan_changed = False
        self.restart_count = int(os.environ.get("PADDLE_RESTART_COUNT", "0"))
        self.resumed_from = None
        self._log = log or (lambda msg: print(f"[resilience] {msg}",
                                              file=sys.stderr, flush=True))
        self._timeouts_seen = 0
        self._last_beat = None  # monotonic time of the latest heartbeat
        # monotonic time of the last overrun dump; None = never dumped (0.0
        # would suppress the first dump for the first minute of uptime)
        self._last_wd_dump = None

    # ------------------------------------------------------------------ #

    def state(self):
        return self._state_dict() if callable(self._state_dict) \
            else self._state_dict

    def resume(self):
        """Restore the newest valid checkpoint; returns the first step to
        run (0 on a fresh start)."""
        step = self.manager.restore_latest(self.state())
        if step is None:
            if self.restart_count > 0:
                self._log(f"restart #{self.restart_count}: no valid "
                          "checkpoint found, starting from step 0")
            return 0
        self.resumed_from = step
        self._log(f"restart #{self.restart_count}: resumed from committed "
                  f"step {step} ({self.manager.path_for(step)})")
        return step + 1

    # ------------------------------------------------------------------ #

    def _wait_ready(self, step):
        """Heartbeat and elastic gate: block while the cluster is below
        min_np, honour the reform signal after a rejoin."""
        if self.elastic is None:
            return
        from .fleet.elastic.manager import ElasticStatus

        self.elastic.heartbeat()
        self._last_beat = time.monotonic()
        status = self.elastic.watch()
        if status == ElasticStatus.HOLD:
            deadline = time.monotonic() + self.hold_timeout
            self._log(f"step {step}: cluster below min_np, holding "
                      f"(up to {self.hold_timeout}s)")
            while status == ElasticStatus.HOLD:
                if time.monotonic() > deadline:
                    raise RuntimeError(
                        f"elastic hold timed out after {self.hold_timeout}s "
                        "waiting for the cluster to refill")
                time.sleep(self.hold_poll)
                self.elastic.heartbeat()
                status = self.elastic.watch()
            self._log(f"step {step}: cluster refilled ({status})")
        # exit only on a genuine reform signal (a node left, or the cluster
        # refilled after a hold), flagged by the manager's shared reform
        # generation. A partial but runnable cluster reports RESTART in its
        # steady state as a scale-up hint; exiting on that would livelock:
        # every respawned worker would exit at its first step.
        if (status == ElasticStatus.RESTART and self.exit_on_reform
                and getattr(self.elastic, "last_restart_was_reform", True)):
            self._log(f"step {step}: membership changed, exiting for an "
                      "in-place pod re-form")
            self.manager.wait()
            sys.exit(REFORM_EXIT_CODE)

    def _check_watchdog(self, step):
        n = comm_watchdog.timeout_count()
        if n > self._timeouts_seen:
            new = n - self._timeouts_seen
            self._timeouts_seen = n
            report = comm_watchdog.drain_report()
            # the spill thread may have drained it to the report file
            # first; either way the timeout itself is worth a log line
            self._log(f"step {step}: comm watchdog flagged a deadline "
                      f"overrun ({n} total)"
                      + (f"\n{report}" if report else ""))
            _tm.get()["wd"].inc(new)
            rec = _flight.get_recorder()
            rec.note("watchdog_timeout", step=step, total=n)
            # an overrun is when the last steps' ring is worth persisting:
            # the process may be torn down next. Every overrun is noted
            # above; the full dump repeats at most once per interval.
            now = time.monotonic()
            if (self._last_wd_dump is None
                    or now - self._last_wd_dump >= _WD_DUMP_MIN_INTERVAL_S):
                self._last_wd_dump = now
                rec.dump(reason=f"watchdog deadline overrun at step {step}")

    # ------------------------------------------------------------------ #

    def _start_heartbeat_thread(self):
        """Heartbeat on a cadence independent of the step's length: a long
        first step or a multi-GB synchronous save must not age this node's
        heartbeat past the liveness timeout, where peers read a death."""
        stop = threading.Event()
        interval = getattr(self.elastic, "heartbeat_interval", 2.0)

        def _beat():
            while not stop.wait(interval):
                try:
                    self.elastic.heartbeat()
                    self._last_beat = time.monotonic()
                except Exception:  # a store hiccup: the next beat retries
                    pass

        t = threading.Thread(target=_beat, daemon=True, name="elastic-hb")
        t.start()
        return stop

    def _save(self, step):
        t0 = time.perf_counter()
        self.manager.save(self.state(), step)
        dt = time.perf_counter() - t0
        _tm.get()["ckpt"].observe(dt)
        _flight.get_recorder().note("checkpoint_save", step=step,
                                    latency_s=round(dt, 6))

    def run(self, num_steps):
        """Train to `num_steps` steps in all (counting the progress made
        before a crash); returns a summary dict."""
        recorder = _flight.get_recorder()
        recorder.snapshot_metrics()  # the dump reports this run's deltas
        # SIGTERM (preemption) and uncaught-exception post-mortems, chained
        # and idempotent, to PADDLE_FLIGHT_FILE (set by the launcher)
        _flight.install_crash_handlers()
        start = self.resume()
        recorder.note("trainer_start", start_step=start,
                      resumed_from=self.resumed_from,
                      restart_count=self.restart_count)
        if self.step_timeout is not None:
            comm_watchdog.enable()
            # report only this run's overruns, not an earlier trainer's
            self._timeouts_seen = comm_watchdog.timeout_count()
        hb_stop = None
        if self.elastic is not None:
            hb_stop = self._start_heartbeat_thread()
        last_loss = None
        saved_at = start - 1
        step = start
        try:
            for step in range(start, num_steps):
                self._wait_ready(step)
                tl = _spans.active_timeline()
                if tl is not None:
                    tl.step_begin(step)
                t0 = time.perf_counter()
                # kind="step": a deadline-only region; the whole step is
                # not communication, and counting it in the overlap
                # accounting would swamp the real comm intervals inside it
                with comm_watchdog.comm_task(f"train_step/{step}",
                                             self.step_timeout, kind="step"):
                    # inside the watchdog's region: an injected stall here
                    # is a step wedged in a collective
                    faults.fault_point("trainer.before_step")
                    last_loss = self.step_fn(step)
                tm = _tm.get()
                tm["step"].observe(time.perf_counter() - t0)
                if self._last_beat is not None:
                    tm["hb_age"].set(time.monotonic() - self._last_beat)
                self._check_watchdog(step)
                if tl is not None:
                    tl.step_end(extra={"restart_count": self.restart_count})
                if (step + 1) % self.save_every == 0:
                    self._save(step)
                    saved_at = step
            if num_steps > start and saved_at != num_steps - 1:
                self._save(num_steps - 1)
            self.manager.wait()
        except Exception as e:
            # the post-mortem the flight recorder exists for: the last
            # steps' timelines, the metric deltas and the watchdog's peek,
            # written before the exception unwinds (SystemExit, the reform
            # path, excluded)
            tl = _spans.active_timeline()
            if tl is not None:
                # the dying step never reached step_end; close it so the
                # dump's ring holds the step that killed the run
                tl.step_end(extra={"aborted": True,
                                   "restart_count": self.restart_count})
            recorder.dump(reason=f"trainer crash at step {step}: "
                                 f"{type(e).__name__}: {e}")
            raise
        finally:
            if hb_stop is not None:
                hb_stop.set()
        if self.elastic is not None:
            self.elastic.exit(completed=True)
        return {
            "start_step": start,
            "last_step": max(num_steps - 1, start - 1),
            "resumed_from": self.resumed_from,
            "restart_count": self.restart_count,
            "last_loss": last_loss,
        }


def run_with_recovery(step_fn, state_dict, ckpt_dir, num_steps, **kwargs):
    """Functional wrapper: build a ResilientTrainer and run it."""
    return ResilientTrainer(step_fn, state_dict, ckpt_dir, **kwargs).run(num_steps)
