"""The port's launcher restart loop and elastic manager
(`python -m paddle_tpu_torch.distributed.launch`,
`paddle_tpu_torch.distributed.fleet.elastic`) against the JAX package's:

- tests/test_elastic.py's cases (:45-130): a failed pod respawned with
  PADDLE_RESTART_COUNT incremented, restarts exhausted, none by default,
  an N:M range implying restarts, a fatal log line tearing down a hung
  worker, the manager's liveness over the native store;
- tests/test_resilience.py's `TestElasticTransitions` (:256) on a fake
  store;
- one scripted heartbeat timeline on a fake clock driving both packages'
  managers: the same status, reform flag and reform generation at every
  watch.
"""

import os
import subprocess
import sys
import time

import pytest

from paddle_tpu_torch.distributed.fleet.elastic import (ElasticManager,
                                                        ElasticStatus)
from paddle_tpu_torch.distributed.store import TCPStore

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run_launch(tmp_path, extra_args, script_body, timeout=120):
    script = os.path.join(tmp_path, "train.py")
    with open(script, "w") as f:
        f.write(script_body)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("PADDLE_", "MASTER_"))}
    env.update(PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
               SENTINEL=os.path.join(tmp_path, "sentinel"))
    return subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         f"--log_dir={tmp_path}/log", *extra_args, script],
        env=env, capture_output=True, text=True, timeout=timeout,
        cwd=tmp_path)


CRASH_ONCE = """
import os, sys
s = os.environ["SENTINEL"]
if not os.path.exists(s):
    open(s, "w").write("x")
    print("FatalError: injected first-run crash", flush=True)
    sys.exit(17)
print("restart_count=", os.environ.get("PADDLE_RESTART_COUNT"), flush=True)
print("rank", os.environ["RANK"], os.environ["WORLD_SIZE"],
      os.environ["LOCAL_RANK"], "master", os.environ["PADDLE_MASTER"],
      "coordinator" in " ".join(os.environ).lower(), flush=True)
print("OK", flush=True)
"""


def test_launcher_restarts_failed_pod(tmp_path):
    """The first life exits 17; with --max_restart the pod respawns and
    succeeds, with the rank variables init_parallel_env reads."""
    proc = _run_launch(tmp_path, ["--max_restart=2"], CRASH_ONCE)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "restart 1/2" in proc.stderr
    assert "fatal log" in proc.stderr  # the LogWatcher surfaced the line
    logs = os.listdir(os.path.join(tmp_path, "log"))
    assert any(l.endswith(".r0") for l in logs)
    r1 = [l for l in logs if l.endswith(".r1")][0]
    out = open(os.path.join(tmp_path, "log", r1)).read()
    assert "restart_count= 1" in out and "OK" in out
    assert "rank 0 1 0 master 127.0.0.1:" in out
    assert "False" in out   # no JAX_COORDINATOR_ADDRESS


def test_launcher_exhausts_restarts(tmp_path):
    proc = _run_launch(tmp_path, ["--max_restart=1"], "import sys\nsys.exit(9)\n")
    assert proc.returncode == 9
    assert "restarts exhausted" in proc.stderr


def test_launcher_no_restart_by_default(tmp_path):
    proc = _run_launch(tmp_path, [], "import sys\nsys.exit(5)\n")
    assert proc.returncode == 5
    assert "restart 1" not in proc.stderr


def test_nnodes_range_implies_restart(tmp_path):
    proc = _run_launch(tmp_path, ["--nnodes=1:2"], CRASH_ONCE)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "restart 1/3" in proc.stderr


def test_fatal_log_tears_down_hung_worker(tmp_path):
    """A worker that logs a fatal line but hangs (a stuck collective) is
    torn down by the log watcher, not waited on."""
    t0 = time.time()
    proc = _run_launch(tmp_path, [], """
import time
print("FatalError: poisoned collective", flush=True)
time.sleep(120)
""")
    assert proc.returncode != 0
    assert time.time() - t0 < 60, "watcher did not tear down the hung worker"
    assert "fatal log" in proc.stderr


def test_devices_accepted_and_master_needed_across_nodes(tmp_path):
    ok = _run_launch(tmp_path, ["--devices=0"], "print('ran')\n")
    assert ok.returncode == 0, ok.stderr[-2000:]
    bad = _run_launch(tmp_path, ["--nnodes=2"], "print('ran')\n")
    assert bad.returncode == 2 and "--master" in bad.stderr


def test_elastic_manager_liveness():
    srv = TCPStore("127.0.0.1", 0, is_master=True, world_size=1)
    try:
        m0 = ElasticManager(store=srv, job_id="j", np_range="1:2", rank=0,
                            timeout=1.5)
        assert m0.enable
        # nothing has heartbeat yet: below min, HOLD
        assert m0.alive_nodes() == []
        assert m0.watch() == ElasticStatus.HOLD
        m0.heartbeat()
        assert m0.alive_nodes() == [0]
        assert m0.is_ready()
        # one node of a 1:2 range: it can still scale up, RESTART
        assert m0.watch() == ElasticStatus.RESTART
        m1 = ElasticManager(store=srv, job_id="j", np_range="1:2", rank=1,
                            timeout=1.5)
        m1.heartbeat()
        assert sorted(m0.alive_nodes()) == [0, 1]
        assert m0.watch() == ElasticStatus.OK  # a healthy full cluster
        # rank 1's heartbeat ages out: back to RESTART
        time.sleep(1.6)
        m0.heartbeat()
        assert m0.alive_nodes() == [0]
        assert m0.watch() == ElasticStatus.RESTART
        m0.exit(completed=True)
        assert m0.alive_nodes() == []
        assert m0.watch() == ElasticStatus.COMPLETED
    finally:
        srv.close()


# --------------------------------------------------------------------------- #
# status transitions (tests/test_resilience.py:235-329)
# --------------------------------------------------------------------------- #


class FakeStore:
    """The subset of TCPStore the elastic manager uses."""

    def __init__(self):
        self.d = {}

    def set(self, k, v):
        self.d[k] = v if isinstance(v, bytes) else str(v).encode()

    def tryget(self, k):
        return self.d.get(k)

    def add(self, k, amount):
        cur = int(self.d.get(k, b"0")) + int(amount)
        self.d[k] = str(cur).encode()
        return cur

    def delete_key(self, k):
        self.d.pop(k, None)


class TestElasticTransitions:
    def test_ok_hold_restart_on_rejoin(self):
        store = FakeStore()
        m = ElasticManager(store=store, job_id="j", np_range="2:2", rank=0,
                           timeout=5.0)
        m.heartbeat()
        store.set("j/heartbeat/1", str(time.time()))
        assert m.watch() == ElasticStatus.OK
        store.set("j/heartbeat/1", str(time.time() - 60))
        assert m.watch() == ElasticStatus.HOLD
        assert m.watch() == ElasticStatus.HOLD  # stable while down
        # rank 1 rejoins: one RESTART to re-form the groups, then OK
        store.set("j/heartbeat/1", str(time.time()))
        assert m.watch() == ElasticStatus.RESTART
        assert m.watch() == ElasticStatus.OK

    def test_initial_fillup_is_not_a_reform(self):
        store = FakeStore()
        m = ElasticManager(store=store, job_id="j2", np_range="2:2", rank=0,
                           timeout=5.0)
        assert m.watch() == ElasticStatus.HOLD
        m.heartbeat()
        store.set("j2/heartbeat/1", str(time.time()))
        assert m.watch() == ElasticStatus.OK

    def test_shrink_within_band_signals_one_reform(self):
        store = FakeStore()
        m = ElasticManager(store=store, job_id="jb", np_range="2:4", rank=0,
                           timeout=5.0)
        m.heartbeat()
        for r in (1, 2):
            store.set(f"jb/heartbeat/{r}", str(time.time()))
        assert m.watch() == ElasticStatus.RESTART  # 3 of 4: can scale up
        assert not m.last_restart_was_reform
        assert m.watch() == ElasticStatus.RESTART  # steady state
        assert not m.last_restart_was_reform
        store.set("jb/heartbeat/2", str(time.time() - 60))
        assert m.watch() == ElasticStatus.RESTART
        assert m.last_restart_was_reform
        assert m.watch() == ElasticStatus.RESTART
        assert not m.last_restart_was_reform

    def test_completed_wins(self):
        store = FakeStore()
        m = ElasticManager(store=store, job_id="j3", np_range="1:1", rank=0)
        m.heartbeat()
        assert m.watch() == ElasticStatus.OK
        m.complete()
        assert m.watch() == ElasticStatus.COMPLETED


class _Clock:
    """A fake `time` module: time() reads a clock the script advances."""

    def __init__(self):
        self.now = 1000.0

    def time(self):
        return self.now


# (seconds to advance, ranks that heartbeat now, complete?) before each
# watch of rank 0's manager, np 2:3, timeout 5 s
TIMELINE = [
    (0, [0], False),          # alone: below min
    (1, [0, 1], False),       # formed at 2 of 3: scale-up hint
    (1, [0, 1, 2], False),    # full
    (1, [0, 1, 2], False),
    (6, [0, 1], False),       # rank 2 aged out: a shrink in the band
    (1, [0, 1], False),       # steady partial band
    (6, [0], False),          # rank 1 aged out too: below min
    (1, [0], False),
    (1, [0, 1], False),       # rank 1 rejoins: a reform
    (1, [0, 1, 2], False),    # rank 2 rejoins: full again
    (1, [0, 1, 2], False),
    (1, [0, 1, 2], True),     # training done
]


def test_scripted_timeline_gives_the_same_statuses(monkeypatch):
    """The same heartbeats on a fake clock through both packages' managers:
    at every watch the status, the reform flag and the store's reform
    generation agree."""
    import importlib

    results = {}
    for pkg in ("paddle_tpu", "paddle_tpu_torch"):
        mod = importlib.import_module(f"{pkg}.distributed.fleet.elastic.manager")
        clock = _Clock()
        monkeypatch.setattr(mod, "time", clock)
        store = FakeStore()
        m = mod.ElasticManager(store=store, job_id="t", np_range="2:3",
                               rank=0, timeout=5.0)
        peers = [mod.ElasticManager(store=store, job_id="t", np_range="2:3",
                                    rank=r, timeout=5.0) for r in (1, 2)]
        seq = []
        for dt, beats, done in TIMELINE:
            clock.now += dt
            for r in beats:
                (m if r == 0 else peers[r - 1]).heartbeat()
            if done:
                m.complete()
            seq.append((m.watch(), m.last_restart_was_reform,
                        int(store.tryget("t/reform_gen") or b"0")))
        results[pkg] = seq
    ref, port = results["paddle_tpu"], results["paddle_tpu_torch"]
    assert port == ref
    statuses = [s for s, _, _ in ref]
    assert statuses[0] == "hold" and statuses[-1] == "completed"
    assert {"hold", "restart", "ok", "completed"} <= set(statuses)
    assert sum(flag for _, flag, _ in ref) == 2   # the shrink, the rejoin
    assert ref[-1][2] == 2
