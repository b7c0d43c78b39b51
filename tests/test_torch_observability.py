"""The port's telemetry layer against the JAX package's
(tests/test_observability.py, less `TestFitTelemetry` — hapi is not
ported — and the graftlint and dispatch-cache cases, which have no
counterpart): registry semantics, exporters byte-equal to the reference's
for the same sequence of calls, span nesting and the chrome trace, the
StepTimeline over the port's own hooks (the sync observer chain of
`framework.core`, `comm_watchdog`'s task observers) and over a gpt3_tiny
training step, the overlap arithmetic equal to the reference's, the
watchdog's host build, and the flight recorder's post-mortems."""

import json
import os
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu_torch as port
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.distributed import comm_watchdog
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.observability import flight, metrics, spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


@pytest.fixture
def registry():
    reg = metrics.reset_default_registry()
    yield reg
    metrics.reset_default_registry()


@pytest.fixture
def recorder():
    rec = flight.reset_recorder()
    yield rec
    flight.reset_recorder()
    flight.uninstall_crash_handlers()


@pytest.fixture
def timeline(registry):
    tl = obs.enable_step_timeline()
    yield tl
    tl.uninstall()


def _t(values):
    return port.to_tensor(np.asarray(values, np.float32))


# --------------------------------------------------------------------------- #
# registry semantics
# --------------------------------------------------------------------------- #


def test_counter_labels_and_monotonicity(registry):
    c = registry.counter("req_total", "requests", ("op",))
    c.inc(op="a")
    c.inc(2.5, op="a")
    c.inc(op="b")
    assert c.value(op="a") == 3.5
    assert c.value(op="b") == 1.0
    with pytest.raises(ValueError):
        c.inc(-1, op="a")
    with pytest.raises(ValueError):
        c.inc(op="a", extra="nope")


def test_gauge_and_histogram(registry):
    g = registry.gauge("depth")
    g.set(4)
    g.inc()
    g.dec(2)
    assert g.value() == 3.0
    h = registry.histogram("lat", buckets=(0.1, 1.0, 10.0))
    for v in (0.05, 0.5, 0.5, 5.0, 50.0):
        h.observe(v)
    assert h.count() == 5
    assert h.sum() == pytest.approx(56.05)   # float sum; approx as the reference's test
    sample = [s for s in registry.collect() if s["metric"] == "lat"][0]
    assert sample["buckets"] == {"0.1": 1, "1.0": 2, "10.0": 1}


def test_redeclare_same_family_ok_mismatch_rejected(registry):
    c1 = registry.counter("x_total", "x", ("op",))
    assert registry.counter("x_total", "x", ("op",)) is c1
    with pytest.raises(ValueError):
        registry.gauge("x_total")
    with pytest.raises(ValueError):
        registry.counter("x_total", labelnames=("other",))
    h1 = registry.histogram("h", buckets=(1.0, 2.0))
    assert registry.histogram("h", buckets=(2.0, 1.0)) is h1
    with pytest.raises(ValueError):
        registry.histogram("h", buckets=(0.5, 2.0))


def test_snapshot_delta(registry):
    c = registry.counter("n_total")
    g = registry.gauge("g")
    c.inc(3)
    g.set(7)
    snap = registry.snapshot()
    c.inc(2)
    g.set(1)
    d = registry.delta(snap)
    assert d["n_total"] == 2
    assert d["g"] == 1  # gauges report their current value


# --------------------------------------------------------------------------- #
# exporters: byte-equal to the reference's for the same sequence of calls
# --------------------------------------------------------------------------- #


def _fill_golden(reg):
    c = reg.counter("rpc_total", "rpc calls", ("op",))
    c.inc(3, op="all_reduce")
    reg.gauge("queue_depth").set(2)
    h = reg.histogram("step_seconds", "per-step", buckets=(0.5, 2.0))
    for v in (0.25, 1.0, 9.0):
        h.observe(v)


def _fill_mixed(reg):
    c = reg.counter("collective_calls_total", "eager collective invocations",
                    ("op",))
    for op, n in (("all_gather", 4), ("reduce_scatter", 2), ("all_reduce", 7)):
        c.inc(n, op=op)
    reg.counter("collective_bytes_total", "bytes", ("op",)).inc(
        1.5e9, op="all_gather")
    g = reg.gauge("serving_queue_depth", 'live "rows"\nand waits',
                  ("engine", "queue"))
    g.set(3, engine="paged", queue="decode")
    g.set(0.125, engine='we"ird\\', queue="prefill")
    h = reg.histogram("serving_ttft_seconds", "ttft", ("engine",))
    for v in (0.0005, 0.003, 0.02, 0.3, 7.0, 300.0):
        h.observe(v, engine="paged")
    reg.histogram("empty_seconds", buckets=(1e-3, 0.1))


def _fill_overlap_metrics(reg):
    f = reg.gauge("step_overlap_fraction", "comm covered, last step")
    f.set(0.333333)
    reg.counter("comm_exposed_seconds_total", "exposed").inc(0.012345)
    reg.counter("comm_overlapped_seconds_total", "covered").inc(1e-7)


@pytest.mark.parametrize("fill", [_fill_golden, _fill_mixed,
                                  _fill_overlap_metrics])
def test_exporters_byte_equal_to_reference(fill, tmp_path):
    from paddle_tpu.observability.metrics import MetricsRegistry as RefReg

    mine, theirs = metrics.MetricsRegistry(), RefReg()
    fill(mine)
    fill(theirs)
    assert mine.prometheus_text() == theirs.prometheus_text()
    assert mine.jsonl_events(ts=0) == theirs.jsonl_events(ts=0)
    assert mine.jsonl_events(ts=1234.5678901) == \
        theirs.jsonl_events(ts=1234.5678901)
    assert mine.snapshot() == theirs.snapshot()
    a, b = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    mine.export_jsonl(str(a), ts=0)
    theirs.export_jsonl(str(b), ts=0)
    assert a.read_bytes() == b.read_bytes()


def test_prometheus_text_golden(registry):
    _fill_golden(registry)
    assert registry.prometheus_text() == (
        "# HELP rpc_total rpc calls\n"
        "# TYPE rpc_total counter\n"
        'rpc_total{op="all_reduce"} 3\n'
        "# TYPE queue_depth gauge\n"
        "queue_depth 2\n"
        "# HELP step_seconds per-step\n"
        "# TYPE step_seconds histogram\n"
        'step_seconds_bucket{le="0.5"} 1\n'
        'step_seconds_bucket{le="2"} 2\n'
        'step_seconds_bucket{le="+Inf"} 3\n'
        "step_seconds_sum 10.25\n"
        "step_seconds_count 3\n"
    )


# --------------------------------------------------------------------------- #
# spans and the chrome trace
# --------------------------------------------------------------------------- #


def test_span_nesting_paths_and_decorator(timeline):
    @obs.span("inner_fn")
    def work():
        return 1

    timeline.step_begin(0)
    with obs.span("fwd"):
        with obs.span("attn"):
            pass
        work()
    rec = timeline.step_end()
    names = [(s["name"], s["depth"]) for s in rec["spans"]]
    assert ("fwd/attn", 1) in names and ("fwd/inner_fn", 1) in names
    assert ("fwd", 0) in names
    assert all(s["dur_s"] >= 0 for s in rec["spans"])


def test_chrome_trace_holds_spans_and_port_ops(tmp_path):
    from paddle_tpu_torch.profiler import Profiler

    p = Profiler()
    p.start()
    x = _t(np.ones((4, 4)))
    with obs.span("obs_step"):
        with obs.span("obs_fwd"):
            _ = (x + x).sum()
    p.stop()
    path = str(tmp_path / "trace.json")
    p.export(path)
    doc = json.load(open(path))
    byname = {e["name"]: e for e in doc["traceEvents"]}
    assert byname["obs_step"]["cat"] == "observability"
    assert "obs_step/obs_fwd" in byname
    assert any(e["cat"] == "operator" for e in doc["traceEvents"])


# --------------------------------------------------------------------------- #
# StepTimeline
# --------------------------------------------------------------------------- #


def test_timeline_stitches_syncs_and_comm_tasks(timeline):
    x = _t(np.ones(8))
    timeline.step_begin(7)
    with obs.span("fwd"):
        y = (x * 2.0).sum()
    with comm_watchdog.comm_task("allreduce/7"):
        time.sleep(0.01)
    _ = float(y)      # sync 1
    _ = y.numpy()     # sync 2
    _ = y.item()      # sync 3
    _ = bool(y)       # sync 4
    rec = timeline.step_end(extra={"loss": 1.0})
    assert rec["step"] == 7 and rec["loss"] == 1.0
    assert rec["host_syncs"] == 4
    assert rec["sync_kinds"] == {"float": 1, "array": 1, "item": 1, "bool": 1}
    assert [t["desc"] for t in rec["comm_tasks"]] == ["allreduce/7"]
    assert rec["comm_tasks"][0]["dur_s"] >= 0.01
    assert "dispatch" not in rec and rec["dur_s"] > 0
    assert timeline.records[-1] is rec


def test_interstep_syncs_and_eviction(registry):
    tl = spans.StepTimeline(keep=2).install()
    try:
        x = _t(np.ones(2))
        for i in range(5):
            tl.step_begin(i)
            _ = float(x.sum())
            tl.step_end()
        _ = int(x.sum())   # between steps
    finally:
        tl.uninstall()
    assert len(tl.records) == 2
    assert tl.interstep_syncs == 1
    assert tl.total_host_syncs() == 6


def test_timeline_jsonl_output(registry, tmp_path):
    path = str(tmp_path / "steps.jsonl")
    tl = obs.enable_step_timeline(jsonl_path=path)
    try:
        for i in range(3):
            tl.step_begin(i)
            tl.step_end()
    finally:
        tl.uninstall()
    recs = [json.loads(ln) for ln in open(path)]
    assert [r["step"] for r in recs] == [0, 1, 2]
    assert all("overlap_fraction" in r for r in recs)


def test_gpt3_tiny_train_step_record_has_the_reference_keys(registry):
    """A StepTimeline over the port's gpt3_tiny DistributedTrainStep: the
    record has every key of the reference's record over its own step but
    `dispatch` (and `autotune`, absent there too on the CPU), the step's
    span and input copy, and the host syncs of `Tensor.item()`."""
    import paddle_tpu as ref
    from paddle_tpu.models import GPTForCausalLM as RefGPT
    from paddle_tpu.models import GPTPretrainingCriterion as RefCrit
    from paddle_tpu.models import gpt3_tiny as ref_tiny
    from paddle_tpu.observability import spans as ref_spans
    from paddle_tpu.optimizer import AdamW as RefAdamW

    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_tiny)
    from paddle_tpu_torch.optimizer import AdamW

    ids = np.random.default_rng(0).integers(0, 1024, (2, 16))
    ref.seed(0)
    rm = RefGPT(ref_tiny())
    rcrit = RefCrit()
    rstep = ref.jit.TrainStep(rm, lambda lg, lb: rcrit(lg, lb),
                              RefAdamW(1e-3, parameters=rm.parameters()))
    rtl = ref_spans.enable_step_timeline()
    try:
        rtl.step_begin(0)
        float(rstep(ref.to_tensor(ids), ref.to_tensor(ids)))
        want = set(rtl.step_end())
    finally:
        rtl.uninstall()

    m = GPTForCausalLM(gpt3_tiny(), seed=0)
    crit = GPTPretrainingCriterion()
    step = DistributedTrainStep(m, lambda lg, lb: crit(lg, lb),
                                AdamW(1e-3, parameters=m.parameters()))
    tl = obs.enable_step_timeline()
    try:
        tl.step_begin(0)
        loss = port.Tensor(step(ids, ids))
        loss.item()
        rec = tl.step_end()
    finally:
        tl.uninstall()
    assert set(rec) == want - {"dispatch", "autotune"}
    assert rec["host_syncs"] == 1 and rec["sync_kinds"] == {"item": 1}
    assert [s["name"] for s in rec["spans"]] == ["train_step/compiled"]
    assert rec["spans"][0]["attrs"] == {"kind": "compute"}
    assert [t["desc"] for t in rec["comm_tasks"]] == ["h2d/inputs"]


def test_fleet_summary_over_store(registry):
    class FakeStore:
        def __init__(self):
            self.kv = {}

        def set(self, k, v):
            self.kv[k] = v.encode() if isinstance(v, str) else v

        def tryget(self, k):
            return self.kv.get(k)

    store = FakeStore()
    base = {"sync_kinds": {}, "comm_tasks": [], "spans": [], "t_wall": 0.0}
    obs.publish_step_record(
        store, 0, {**base, "step": 3, "dur_s": 0.10, "host_syncs": 1})
    obs.publish_step_record(
        store, 1, {**base, "step": 3, "dur_s": 0.30, "host_syncs": 2,
                   "comm_tasks": [{"desc": "ar", "dur_s": 0.05}]})
    s = obs.fleet_step_summary(store, world_size=2, step=3)
    assert s["ranks"] == 2 and s["straggler_rank"] == 1
    assert s["step_time_s"]["max"] == 0.30
    assert s["host_syncs"] == 3
    assert s["comm_task_s"] == pytest.approx(0.05)
    with pytest.raises(TimeoutError):
        obs.fleet_step_summary(FakeStore(), world_size=1, step=0,
                               timeout=0.05)


# --------------------------------------------------------------------------- #
# the sync observer chain
# --------------------------------------------------------------------------- #


def test_set_sync_observer_returns_previous_base():
    prev0 = core.set_sync_observer(None)
    try:
        a = lambda k, t: None  # noqa: E731
        assert core.set_sync_observer(a) is None
        assert core.set_sync_observer(None) is a
    finally:
        core.set_sync_observer(prev0)


def test_chain_composes_with_base_and_item_replacement():
    seen = []
    prev0 = core.set_sync_observer(lambda k, t: seen.append(("base", k)))
    fn = core.add_sync_observer(lambda k, t: seen.append(("chain", k)))
    rep = core.add_sync_observer(lambda k, t: 42.0 if k == "item" else None)
    try:
        x = _t(np.ones(2))
        _ = float(x.sum())
        assert ("base", "float") in seen and ("chain", "float") in seen
        assert x.sum().item() == 42.0   # the last non-None wins
    finally:
        core.remove_sync_observer(rep)
        core.remove_sync_observer(fn)
        core.set_sync_observer(prev0)
    assert core._sync_observer is prev0


# --------------------------------------------------------------------------- #
# the watchdog, on the port's host build
# --------------------------------------------------------------------------- #


def test_watchdog_peek_is_non_destructive_drain_consumes_once():
    comm_watchdog.disable()
    assert comm_watchdog.enable(timeout_seconds=5.0)
    try:
        with comm_watchdog.comm_task("stuck/1", 0.1):
            time.sleep(0.4)
        deadline = time.time() + 3
        while time.time() < deadline and not comm_watchdog.peek_report():
            time.sleep(0.05)
        first = comm_watchdog.peek_report()
        assert "stuck/1" in first
        assert comm_watchdog.peek_report() == first
        assert "stuck/1" in comm_watchdog.drain_report()
        assert comm_watchdog.drain_report() == ""
        assert "stuck/1" in comm_watchdog.peek_report()
        ev = comm_watchdog.report_events()
        assert ev and ev[0]["desc"] == "stuck/1"
        assert ev[0]["timeout_ms"] == 100 and ev[0]["elapsed_ms"] >= 100
        assert comm_watchdog.timeout_count() == 1
        assert comm_watchdog.inflight() == 0
    finally:
        comm_watchdog.disable()


def test_stall_past_a_1s_deadline_spills_a_report(tmp_path):
    """A region held 1.6 s past a 1 s deadline: the spill thread appends
    the monitor's line to the report file while the region still runs."""
    path = tmp_path / "wd.report"
    comm_watchdog.disable()
    assert comm_watchdog.enable(timeout_seconds=1.0, report_file=str(path))
    try:
        with comm_watchdog.comm_task("train_step/stall"):
            assert comm_watchdog.inflight() == 1
            time.sleep(1.6)
            deadline = time.time() + 3
            while time.time() < deadline and not (
                    path.exists() and path.read_text()):
                time.sleep(0.05)
        text = path.read_text()
        assert "'train_step/stall' exceeded 1000ms" in text
        assert comm_watchdog.timeout_count() == 1
    finally:
        comm_watchdog.disable()


def test_native_host_build_is_cached_by_source_hash():
    from paddle_tpu_torch.framework import native

    lib = native.build()
    assert lib.parent == native.BUILD_DIR and lib.exists()
    assert native.build() == lib   # cached: no second build
    assert native.load() is native.load()


# --------------------------------------------------------------------------- #
# flight recorder
# --------------------------------------------------------------------------- #


def test_flight_ring_bounded_and_dump_contents(registry, recorder, tmp_path):
    rec = flight.FlightRecorder(capacity=3)
    for i in range(5):
        rec.record_step({"step": i, "dur_s": 0.01, "host_syncs": 0})
    assert [s["step"] for s in rec.steps] == [2, 3, 4]
    rec.note("checkpoint_save", step=4)
    registry.counter("c_total").inc(2)
    path = str(tmp_path / "fl.json")
    assert rec.dump(path, reason="unit test") == path
    doc = json.loads(open(path).read().splitlines()[-1])
    assert doc["reason"] == "unit test"
    assert [s["step"] for s in doc["steps"]] == [2, 3, 4]
    assert doc["events"][0]["kind"] == "checkpoint_save"
    assert doc["metric_deltas"]["c_total"] == 2
    assert "watchdog_report" in doc and "dispatch_cache" not in doc


def test_timeline_feeds_default_recorder(registry, recorder):
    tl = obs.enable_step_timeline()
    try:
        tl.step_begin(11)
        tl.step_end()
    finally:
        tl.uninstall()
    assert [s["step"] for s in recorder.steps] == [11]


def test_flight_dump_on_injected_crash(tmp_path):
    """A training loop in a fresh interpreter with the crash handlers in
    and a fault point armed inside its checkpoint save: the uncaught
    FaultInjected goes through the chained excepthook, which dumps the
    recorder with the dying step's record and the save's metric delta."""
    fl = tmp_path / "worker.flight"
    code = f"""
import numpy as np, torch
from paddle_tpu_torch import observability as obs
from paddle_tpu_torch.observability import flight, metrics
from paddle_tpu_torch.distributed.checkpoint import CheckpointManager
flight.get_recorder()
flight.install_crash_handlers()
tl = obs.enable_step_timeline()
mgr = CheckpointManager({str(tmp_path / "ck")!r})
w = torch.zeros(4)
steps = metrics.default_registry().counter("train_steps_total")
for i in range(6):
    tl.step_begin(i)
    w += 1.0
    steps.inc()
    if i % 2 == 1:
        flight.get_recorder().note("checkpoint_save", step=i)
        mgr.save({{"w": w}}, i)
    tl.step_end()
"""
    env = dict(os.environ, PADDLE_FLIGHT_FILE=str(fl),
               PADDLE_FAULT_INJECT="ckpt.before_commit:exc@2",
               PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 1 and "FaultInjected" in out.stderr
    doc = json.loads(fl.read_text().splitlines()[-1])
    assert doc["reason"].startswith("uncaught FaultInjected")
    assert [s["step"] for s in doc["steps"]] == [0, 1, 2]   # 3 dies open
    assert [e["step"] for e in doc["events"]] == [1, 3]
    assert doc["metric_deltas"]["train_steps_total"] == 4
    assert doc["watchdog_timeouts"] == 0


def test_sigterm_handler_chains_and_uninstalls(registry, recorder, tmp_path):
    calls = []

    def handler(signum, frame):
        calls.append(signum)

    prev = signal.signal(signal.SIGTERM, handler)
    try:
        path = str(tmp_path / "sig.flight")
        flight.install_crash_handlers(path)
        os.kill(os.getpid(), signal.SIGTERM)
        time.sleep(0.01)
        assert calls == [signal.SIGTERM]   # the previous handler still ran
        doc = json.loads(open(path).read().splitlines()[-1])
        assert doc["reason"] == "SIGTERM" and doc["lockfree"] is True
        flight.uninstall_crash_handlers()
        assert signal.getsignal(signal.SIGTERM) is handler
    finally:
        flight.uninstall_crash_handlers()
        signal.signal(signal.SIGTERM, prev)


# --------------------------------------------------------------------------- #
# overlap arithmetic: equal to the reference's (its TestOverlapStats cases)
# --------------------------------------------------------------------------- #


def _ct(start_s, dur_s, desc="rs", kind="comm"):
    return {"desc": desc, "kind": kind, "start_ns": int(start_s * 1e9),
            "dur_s": dur_s}


def _sp(start_s, dur_s, kind="compute", name="bwd"):
    rec = {"name": name, "depth": 0, "start_ns": int(start_s * 1e9),
           "dur_s": dur_s}
    if kind is not None:
        rec["attrs"] = {"kind": kind}
    return rec


OVERLAP_CASES = {
    "disjoint": ([_ct(0.0, 0.1)], [_sp(0.2, 0.1)]),
    "covered": ([_ct(0.1, 0.1)], [_sp(0.0, 0.5)]),
    "partial": ([_ct(0.0, 0.4)], [_sp(0.3, 0.3)]),
    "zero_comm": ([], [_sp(0.0, 1.0)]),
    "union": ([_ct(0.0, 0.2), _ct(0.1, 0.2)], [_sp(0.0, 0.15), _sp(0.1, 0.15)]),
    "step_kind_excluded": ([_ct(0.0, 1.0, desc="train_step/3", kind="step"),
                            _ct(0.2, 0.1)],
                           [_sp(0.0, 1.0, kind=None, name="fit/train_batch")]),
    "a2a_joins": ([_ct(0.0, 0.2, desc="moe/a2a/epx4", kind="a2a"),
                   _ct(0.1, 0.2), _ct(0.0, 1.0, desc="train_step/1",
                                      kind="step")], [_sp(0.0, 0.15)]),
    "multi_sweep": ([_ct(0.0, 0.1), _ct(0.2, 0.1), _ct(0.4, 0.1)],
                    [_sp(0.05, 0.2), _sp(0.45, 0.2)]),
}


@pytest.mark.parametrize("name", sorted(OVERLAP_CASES))
def test_overlap_stats_equal_to_reference(name):
    from paddle_tpu.observability import spans as ref_spans

    comm, compute = OVERLAP_CASES[name]
    got = spans.overlap_stats(comm, compute)
    assert got == ref_spans.overlap_stats(comm, compute)
    assert spans.aggregate_overlap([got, got]) == \
        ref_spans.aggregate_overlap([got, got])
    assert spans.COMM_KINDS == ref_spans.COMM_KINDS


def test_overlap_record_and_metrics(timeline, registry):
    timeline.step_begin(0)
    with comm_watchdog.comm_task("rs/grads"):
        with obs.span("update", kind="compute"):
            time.sleep(0.01)
    rec = timeline.step_end()
    assert rec["overlap_fraction"] == rec["overlap"]["fraction"] > 0.5
    assert registry.get("step_overlap_fraction").value() == \
        rec["overlap_fraction"]
    assert registry.get("comm_overlapped_seconds_total").value() == \
        pytest.approx(rec["overlap"]["covered_s"])
    exposed0 = registry.get("comm_exposed_seconds_total").value()
    timeline.step_begin(1)
    with comm_watchdog.comm_task("allgather/params"):
        time.sleep(0.005)
    rec = timeline.step_end()
    assert rec["overlap_fraction"] == 0.0
    assert registry.get("comm_exposed_seconds_total").value() - exposed0 == \
        pytest.approx(rec["overlap"]["exposed_s"])
    assert rec["comm_tasks"][0]["start_ns"] >= 0


def test_collectives_feed_the_registry_and_the_timeline(timeline, registry):
    """A one-rank gloo group: an eager all-reduce and the step's flat
    all-gather count in collective_{calls,bytes}_total{op=} and their
    comm_task intervals land in the step record."""
    import torch.distributed as tdist

    from paddle_tpu_torch.distributed import collective as C

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port_no = sock.getsockname()[1]
    tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port_no}",
                             rank=0, world_size=1)
    try:
        snap = registry.snapshot()
        timeline.step_begin(0)
        C.all_reduce(torch.ones(3))
        C._all_gather_flat(torch.empty(4), torch.ones(4), None)
        rec = timeline.step_end()
        assert C.traffic(snap) == {
            "calls": {"all_reduce": 1, "all_gather": 1},
            "bytes": {"all_reduce": 12, "all_gather": 16}}
        assert [t["desc"] for t in rec["comm_tasks"]] == ["all_gather"]
    finally:
        tdist.destroy_process_group()
