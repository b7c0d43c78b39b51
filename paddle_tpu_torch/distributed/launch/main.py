"""The launcher (↔ paddle_tpu/distributed/launch/main.py; reference:
python/paddle/distributed/launch/main.py CLI, controllers/collective.py:22-150
CollectiveController and Pod, controllers/watcher.py's log watcher, and
fleet/elastic/manager.py's restart semantics).

One controller process per host spawns the pod: `--nproc_per_node` worker
processes, each a fresh interpreter (`subprocess.Popen`, never a fork, so
no worker inherits a CUDA context), one per card. A watcher thread tails
the workers' logs for fatal patterns; when a worker fails, or logs a fatal
line and hangs, the pod is torn down and, while `--max_restart` allows,
spawned again with PADDLE_RESTART_COUNT incremented (elastic level 1: an
in-place pod restart).

**A worker's environment.** The launcher's own, plus:

- PADDLE_TRAINER_ID / RANK (its global rank), PADDLE_TRAINERS_NUM /
  WORLD_SIZE, PADDLE_LOCAL_RANK / LOCAL_RANK (its card:
  `init_parallel_env` binds `cuda:{LOCAL_RANK}`), PADDLE_JOB_ID,
  PADDLE_RESTART_COUNT;
- PADDLE_MASTER ("host:port"), MASTER_ADDR and MASTER_PORT: `--master`,
  or on one node without it a port of 127.0.0.1 chosen afresh for each
  spawn of the pod. torch's c10d store (`init_parallel_env`) takes that
  port and the native store (`create_or_get_global_tcp_store`) the port +
  1 (`distributed.store`), so the launcher picks a port whose successor is
  free too;
- PADDLE_WD_REPORT_FILE and PADDLE_FLIGHT_FILE (the comm watchdog's and
  the flight recorder's post-mortems, folded into the worker's log when
  the pod dies), and PADDLE_WD_FATAL=1 when the pod may restart (the
  watchdog then logs a FatalError line, which the watcher turns into a
  teardown).

`--devices` is accepted, as the reference accepts it, and not read: each
rank's card follows from LOCAL_RANK.
"""

from __future__ import annotations

import argparse
import os
import re
import signal
import socket
import subprocess
import sys
import threading
import time

__all__ = ["launch", "Pod", "LogWatcher"]

_FATAL_PATTERNS = re.compile(
    r"(FatalError|Check failed|core dumped|Segmentation fault|NumericError)")


class LogWatcher(threading.Thread):
    """Tails worker log files, surfacing fatal patterns (reference:
    launch/controllers/watcher.py)."""

    def __init__(self, paths, on_fatal=None, interval=0.5):
        super().__init__(daemon=True)
        self.paths = list(paths)
        self.on_fatal = on_fatal
        self.interval = interval
        self.fatal_lines: list[str] = []
        # start at the current size: logs open in append mode, and a stale
        # fatal line from an earlier launcher run must not kill a fresh pod
        self._offsets = {}
        for p in self.paths:
            try:
                self._offsets[p] = os.path.getsize(p)
            except OSError:
                self._offsets[p] = 0
        self._stop_evt = threading.Event()  # Thread reserves _stop

    def stop(self):
        self._stop_evt.set()

    def scan_once(self):
        for p in self.paths:
            try:
                with open(p, "rb") as f:
                    f.seek(self._offsets[p])
                    chunk = f.read()
            except OSError:
                continue
            # only complete lines: a fatal pattern split across a read
            # boundary must still match on the next scan
            cut = chunk.rfind(b"\n")
            if cut < 0:
                continue
            self._offsets[p] += cut + 1
            for line in chunk[:cut].decode(errors="replace").splitlines():
                if _FATAL_PATTERNS.search(line):
                    self.fatal_lines.append(f"{p}: {line}")
                    if self.on_fatal is not None:
                        self.on_fatal(p, line)

    def run(self):
        while not self._stop_evt.is_set():
            self.scan_once()
            time.sleep(self.interval)
        self.scan_once()


def _free_master_port():
    """A port p of this host with p and p + STORE_PORT_OFFSET both free (the
    c10d store and the native store of one rendezvous)."""
    from ..store import STORE_PORT_OFFSET

    for _ in range(64):
        with socket.socket() as a:
            a.bind(("", 0))
            port = a.getsockname()[1]
            try:
                with socket.socket() as b:
                    b.bind(("", port + STORE_PORT_OFFSET))
            except OSError:
                continue
        return port
    raise RuntimeError("launch: no free pair of ports for the rendezvous")


class Pod:
    """The set of worker processes on this host (reference Pod in
    launch/controllers/collective.py)."""

    def __init__(self, args, restart_count=0):
        self.args = args
        self.restart_count = restart_count
        self.procs: list[subprocess.Popen] = []
        self.log_paths: list[str] = []
        self.wd_report_paths: list[str] = []
        self.flight_paths: list[str] = []

    def _master(self):
        """The rendezvous "host:port": --master, else a fresh local port."""
        if self.args.master:
            return self.args.master
        return f"127.0.0.1:{_free_master_port()}"

    def spawn(self):
        args = self.args
        nnodes = int(str(args.nnodes).split(":")[0])
        world = nnodes * args.nproc_per_node
        master = self._master()
        host, port = master.rsplit(":", 1)
        os.makedirs(args.log_dir, exist_ok=True)
        for local in range(args.nproc_per_node):
            rank = args.rank * args.nproc_per_node + local
            env = dict(os.environ)
            env.update(PADDLE_TRAINER_ID=str(rank), RANK=str(rank),
                       PADDLE_TRAINERS_NUM=str(world), WORLD_SIZE=str(world),
                       PADDLE_LOCAL_RANK=str(local), LOCAL_RANK=str(local),
                       PADDLE_JOB_ID=args.job_id,
                       PADDLE_RESTART_COUNT=str(self.restart_count),
                       PADDLE_MASTER=master, MASTER_ADDR=host,
                       MASTER_PORT=port)
            log_path = os.path.join(
                args.log_dir, f"workerlog.{local}.r{self.restart_count}")
            self.log_paths.append(log_path)
            # the comm watchdog's post-mortem channel: the worker's spill
            # thread appends timeout reports here (comm_watchdog.enable),
            # and the launcher folds the file into the worker log on death
            wd_path = log_path + ".wd"
            try:
                # a stale report of an earlier launcher run in the same
                # log_dir must not be pinned on this pod's death
                os.unlink(wd_path)
            except OSError:
                pass
            env["PADDLE_WD_REPORT_FILE"] = wd_path
            self.wd_report_paths.append(wd_path)
            # the flight recorder's post-mortem channel: ResilientTrainer
            # (and the SIGTERM / excepthook handlers it installs) dump the
            # last steps' telemetry here; folded in like the watchdog's
            fl_path = log_path + ".flight"
            try:
                os.unlink(fl_path)
            except OSError:
                pass
            env["PADDLE_FLIGHT_FILE"] = fl_path
            self.flight_paths.append(fl_path)
            if args.max_restart > 0:
                # a restartable pod escalates hangs: the spill thread's
                # FatalError line trips the LogWatcher: teardown, respawn
                env["PADDLE_WD_FATAL"] = "1"
            logf = open(log_path, "ab")
            proc = subprocess.Popen(
                [sys.executable, args.training_script,
                 *args.training_script_args],
                env=env, stdout=logf, stderr=subprocess.STDOUT,
            )
            proc._logf = logf  # closed in terminate() / watch()
            self.procs.append(proc)
            print(f"[launch] worker {local} (restart {self.restart_count}) "
                  f"logging to {log_path}", file=sys.stderr)

    def terminate(self, grace=3.0):
        for p in self.procs:
            if p.poll() is None:
                p.terminate()
        deadline = time.time() + grace
        for p in self.procs:
            while p.poll() is None and time.time() < deadline:
                time.sleep(0.1)
            if p.poll() is None:
                p.kill()
            try:  # reap: the restart loop keeps this process alive, so an
                p.wait(timeout=5)  # unreaped child would linger as a zombie
            except subprocess.TimeoutExpired:
                pass
        self._close_logs()

    def _close_logs(self):
        for p in self.procs:
            f = getattr(p, "_logf", None)
            if f is not None and not f.closed:
                f.close()

    def dump_watchdog_reports(self):
        """Post-mortem: fold each worker's comm-watchdog spill file and its
        flight-recorder dump into its log (and the launcher's stderr) before
        the respawn, so the stuck step's report and the last steps'
        telemetry survive the restart that destroys the worker."""
        channels = [
            ("comm-watchdog", self.wd_report_paths),
            ("flight-recorder", self.flight_paths),
        ]
        for kind, paths in channels:
            for local, (log_path, src_path) in enumerate(
                    zip(self.log_paths, paths)):
                try:
                    with open(src_path) as f:
                        report = f.read().strip()
                except OSError:
                    continue
                if not report:
                    continue
                banner = (f"\n[launch] {kind} post-mortem for worker "
                          f"{local} (restart {self.restart_count}):"
                          f"\n{report}\n")
                try:
                    with open(log_path, "a") as f:
                        f.write(banner)
                except OSError:
                    pass
                print(banner, file=sys.stderr)

    def watch(self, fatal_evt=None):
        """Block until the pod finishes, a worker fails, or the log watcher
        flags a fatal line (a worker that logs the error but hangs in a
        collective instead of exiting); returns the pod's exit code (the
        first non-zero worker code, 1 on a fatal-log teardown, 0 when all
        succeed)."""
        procs = list(self.procs)
        while procs:
            if fatal_evt is not None and fatal_evt.is_set():
                self.terminate()
                return 1
            for p in list(procs):
                ret = p.poll()
                if ret is None:
                    continue
                procs.remove(p)
                if ret != 0:
                    self.terminate()
                    return ret
            time.sleep(0.3)
        self._close_logs()
        return 0


def _parse(argv=None):
    p = argparse.ArgumentParser("paddle_tpu_torch.distributed.launch")
    p.add_argument("--master", default=None,
                   help="rendezvous ip:port of the rank-0 host (c10d takes "
                        "the port, the native store the port + 1); on one "
                        "node a free local port by default")
    p.add_argument("--nnodes", default="1",
                   help="number of hosts, N or N:M (elastic range)")
    p.add_argument("--rank", type=int,
                   default=int(os.environ.get("PADDLE_TRAINER_ID", 0)))
    p.add_argument("--nproc_per_node", type=int, default=1,
                   help="worker processes per host, one per card")
    p.add_argument("--log_dir", default="log")
    p.add_argument("--run_mode", default="collective")
    p.add_argument("--job_id", default="default")
    p.add_argument("--max_restart", type=int,
                   default=int(os.environ.get("PADDLE_MAX_RESTART", "0")),
                   help="elastic: respawn the pod up to N times on failure")
    p.add_argument("--elastic_level", type=int, default=None,
                   help="-1/0 off, 1 in-place pod restart (implies "
                        "max_restart>=1 when set)")
    p.add_argument("--devices", default=None,
                   help="accepted for parity; a rank's card is its "
                        "LOCAL_RANK")
    p.add_argument("training_script")
    p.add_argument("training_script_args", nargs=argparse.REMAINDER)
    args = p.parse_args(argv)
    # an N:M elastic range implies restartability (reference --nnodes=2:4)
    if ":" in str(args.nnodes) and args.max_restart == 0:
        args.max_restart = 3
    if args.master is None and int(str(args.nnodes).split(":")[0]) > 1:
        p.error("--master is needed when the job spans more than one node")
    return args


def launch(argv=None):
    args = _parse(argv)
    if args.elastic_level and args.elastic_level > 0 and args.max_restart == 0:
        args.max_restart = 3  # the reference's elastic default

    restart = 0
    current: list[Pod] = []

    def _terminate(signum, frame):
        for pod in current:
            pod.terminate()
        sys.exit(1)

    signal.signal(signal.SIGTERM, _terminate)
    signal.signal(signal.SIGINT, _terminate)

    while True:
        pod = Pod(args, restart_count=restart)
        current[:] = [pod]
        pod.spawn()
        fatal_evt = threading.Event()
        watcher = LogWatcher(pod.log_paths,
                             on_fatal=lambda p, line: fatal_evt.set())
        watcher.start()
        code = pod.watch(fatal_evt)
        watcher.stop()
        watcher.join(timeout=5)
        for line in watcher.fatal_lines:
            print(f"[launch] fatal log: {line}", file=sys.stderr)
        if code == 0:
            sys.exit(0)
        pod.dump_watchdog_reports()
        if restart >= args.max_restart:
            print(f"[launch] pod failed (exit {code}), restarts exhausted "
                  f"({restart}/{args.max_restart})", file=sys.stderr)
            sys.exit(code)
        restart += 1
        print(f"[launch] pod failed (exit {code}); restart "
              f"{restart}/{args.max_restart}", file=sys.stderr)
        time.sleep(1.0)
