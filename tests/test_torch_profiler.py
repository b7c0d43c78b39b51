"""The port's profiler against the JAX package's (tests/test_profiler.py):
the scheduler's states equal the reference's, host op events come from the
port's dispatch point (`framework.core`'s op event hook), the chrome export
holds the spans, the summary tables, and the device Kernel Summary parsed
from a trace in Kineto's layout (`"cat": "kernel"` events named by C++
symbols, as `torch.profiler` writes them on the card)."""

import json
import os

import numpy as np
import pytest

import paddle_tpu_torch as port
from paddle_tpu_torch import profiler
from paddle_tpu_torch.framework import core
from paddle_tpu_torch.profiler import (Profiler, ProfilerState, RecordEvent,
                                       benchmark, export_chrome_tracing,
                                       make_scheduler)


@pytest.fixture(autouse=True)
def _cpu():
    port.set_device("cpu")
    yield
    port.device._default = "cuda"


def _x(n=8):
    return port.to_tensor(np.ones((n, n), np.float32))


SCHEDULES = [
    dict(closed=1, ready=1, record=4, repeat=1, skip_first=1),
    dict(closed=1, ready=1, record=2, repeat=0),
    dict(closed=0, ready=0, record=1, repeat=0),
    dict(closed=2, ready=0, record=1, repeat=0, skip_first=3),
    dict(closed=0, ready=1, record=1),
    dict(closed=3, ready=2, record=3, repeat=2, skip_first=2),
]


@pytest.mark.parametrize("kw", SCHEDULES, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_scheduler_states_equal_reference(kw):
    from paddle_tpu.profiler import make_scheduler as ref_make

    mine, theirs = make_scheduler(**kw), ref_make(**kw)
    assert [mine(i).name for i in range(21)] == \
        [theirs(i).name for i in range(21)]


def test_scheduler_record_is_mandatory():
    with pytest.raises(AssertionError):
        make_scheduler(closed=1, ready=1, record=0)


def test_records_port_ops_and_exports(tmp_path):
    """Op events from the port's dispatch (run_op and the reported
    functionals) and RecordEvent annotations land in a loadable chrome
    trace, and summary() aggregates them."""
    traces = []

    def on_ready(prof):
        path = os.path.join(tmp_path, f"trace_{prof.step_num}.json")
        prof.export(path)
        traces.append(path)

    x = _x()
    with Profiler(scheduler=make_scheduler(closed=0, ready=1, record=2,
                                           repeat=1),
                  on_trace_ready=on_ready) as p:
        for _ in range(4):
            with RecordEvent("train_iter"):
                _ = (port.matmul(x, x) + 1.0).sum()
                _ = port.nn.functional.gelu(x._value)   # a reported functional
            p.step()
    assert traces, "on_trace_ready never fired"
    doc = json.load(open(traces[0]))
    names = {e["name"] for e in doc["traceEvents"]}
    assert {"train_iter", "matmul", "add", "sum", "gelu"} <= names
    cats = {e["cat"] for e in doc["traceEvents"]}
    assert "operator" in cats and "user_defined" in cats
    assert all(e["ph"] == "X" and e["dur"] >= 0 for e in doc["traceEvents"])
    # two recorded steps: two of each op
    assert sum(e["name"] == "matmul" for e in doc["traceEvents"]) == 2
    s = p.summary()
    assert "train_iter" in s and "Calls" in s


def test_closed_state_records_nothing_and_unhooks():
    p = Profiler(scheduler=make_scheduler(closed=10, ready=0, record=1))
    p.start()
    _ = (_x(4) + _x(4)).sum()
    p.step()
    p.stop()
    assert p.events() == []
    assert core._op_event_hook is None


def test_export_chrome_tracing_handler_holds_spans(tmp_path):
    from paddle_tpu_torch.observability import span

    d = os.path.join(tmp_path, "log")
    x = _x(4)
    with Profiler(scheduler=make_scheduler(closed=0, ready=0, record=2,
                                           repeat=1),
                  on_trace_ready=export_chrome_tracing(d)) as p:
        for _ in range(2):
            with span("bench_step"):
                with span("matmul_block"):
                    _ = port.matmul(x, x)
            p.step()
    traces = [f for f in os.listdir(d) if f.endswith(".paddle_trace.json")]
    assert traces
    doc = json.load(open(os.path.join(d, traces[0])))
    by_cat = {}
    for e in doc["traceEvents"]:
        by_cat.setdefault(e["cat"], set()).add(e["name"])
    assert {"bench_step", "bench_step/matmul_block"} <= by_cat["observability"]
    assert "matmul" in by_cat["operator"]


def test_device_trace_window_writes_a_torch_trace(tmp_path):
    """With device_trace_dir, each record window runs torch.profiler (CPU
    activity here, CUDA too on the card) and writes Kineto's chrome trace
    there, with the spans and RecordEvents mirrored as its ranges."""
    from paddle_tpu_torch.observability import span

    d = str(tmp_path / "dev")
    x = _x(16)
    p = Profiler(scheduler=make_scheduler(closed=0, ready=1, record=1),
                 device_trace_dir=d)
    p.start()
    for _ in range(2):
        with span("train_step/compiled", kind="compute"):
            with RecordEvent("inner"):
                _ = port.matmul(x, x)
        p.step()
    p.stop()
    assert p.device_trace_path and os.path.dirname(p.device_trace_path) == d
    doc = json.load(open(p.device_trace_path))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"train_step/compiled", "inner"} <= names
    assert core._op_event_hook is None and p._torch_prof is None


def test_step_info_and_benchmark():
    from paddle_tpu_torch.observability import metrics

    reg = metrics.reset_default_registry()
    try:
        with Profiler(timer_only=True) as p:
            for _ in range(3):
                _ = _x(4) + 1.0
                p.step()
        info = p.step_info()
        assert "ips" in info and "batch_cost" in info
        b = benchmark()
        b.begin()
        b.after_reader()
        b.after_step(num_samples=32)
        b.end()
        assert "ips" in b.step_info() and b.ips > 0
        h = reg.get("benchmark_cost_seconds")
        assert h.count(phase="reader") == 1 and h.count(phase="batch") == 1
    finally:
        metrics.reset_default_registry()


def test_summary_overview_and_tables():
    p = profiler.Profiler(scheduler=(0, 1))
    p.start()
    with profiler.RecordEvent("userstep"):
        a = _x(4)
        for _ in range(3):
            a = port.matmul(a, a)
    p.stop()
    s = p.summary()
    assert "Overview Summary" in s and "Category: operator" in s
    row = [ln for ln in s.splitlines() if ln.startswith("matmul")]
    assert row and row[0].split()[1] == "3", row
    assert "%" in row[0]


def _kineto_trace():
    """A small trace in the layout torch.profiler exports: CPU ops, CUDA
    runtime calls, a user annotation and kernels (cat "kernel", dur in
    us), the kernels named by their demangled C++ symbols."""
    fwd = ("void (anonymous namespace)::flash_fwd_sm90_kernel<__nv_bfloat16, "
           "128, (anonymous namespace)::CausalBias>(Params)")
    norm = ("void norm_fwd_rows_kernel<__nv_bfloat16, float, true>"
            "(NormArgs)")
    return {"schemaVersion": 1, "traceEvents": [
        {"ph": "M", "pid": 7, "name": "process_name",
         "args": {"name": "python3"}},
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "GPU 0"}},
        {"ph": "X", "cat": "cpu_op", "pid": 7, "tid": 7, "name": "aten::mm",
         "ts": 0, "dur": 50.0},
        {"ph": "X", "cat": "user_annotation", "pid": 7, "tid": 7,
         "name": "train_step/compiled", "ts": 0, "dur": 900.0},
        {"ph": "X", "cat": "gpu_user_annotation", "pid": 0, "tid": 7,
         "name": "train_step/compiled", "ts": 1, "dur": 950.0},
        {"ph": "X", "cat": "cuda_runtime", "pid": 7, "tid": 7,
         "name": "cudaLaunchKernel", "ts": 5, "dur": 4.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": fwd,
         "ts": 10, "dur": 200.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": fwd,
         "ts": 300, "dur": 250.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": norm,
         "ts": 600, "dur": 50.0},
        {"ph": "X", "cat": "gpu_memcpy", "pid": 0, "tid": 8,
         "name": "Memcpy HtoD (Pageable -> Device)", "ts": 700, "dur": 30.0},
    ]}


def test_device_kernel_summary_from_a_kineto_trace(tmp_path):
    from paddle_tpu_torch.profiler.statistic import (build_device_summary,
                                                     find_device_trace,
                                                     parse_device_trace)

    path = tmp_path / "host_pid1_1.pt.trace.json"
    path.write_text(json.dumps(_kineto_trace()))
    assert find_device_trace(str(tmp_path)) == str(path)
    agg = parse_device_trace(str(path))
    # the kernels only: not the annotations, the CPU ops or the copies
    assert len(agg) == 2
    fwd = next(n for n in agg if "flash_fwd_sm90_kernel" in n)
    assert agg[fwd]["calls"] == 2 and agg[fwd]["total"] == 450.0 * 1e3
    assert agg[fwd]["mn"] == 200.0e3 and agg[fwd]["mx"] == 250.0e3
    text = "\n".join(build_device_summary(str(tmp_path), time_unit="us"))
    assert "Kernel Summary (device, top 2)" in text
    assert "90.0%" in text   # 450 of 500 us
    p = profiler.Profiler(scheduler=(0, 1), device_trace_dir=str(tmp_path))
    assert "Kernel Summary" in p.summary()


def test_device_kernel_summary_reads_the_xla_layout_too(tmp_path):
    """The reference's layout (events without a cat on a device track)
    parses as before: the same numbers as the reference's parser."""
    import gzip

    from paddle_tpu.profiler.statistic import \
        parse_device_trace as ref_parse

    from paddle_tpu_torch.profiler.statistic import parse_device_trace

    trace = {"traceEvents": [
        {"ph": "M", "pid": 1, "name": "process_name",
         "args": {"name": "/device:TPU:0"}},
        {"ph": "M", "pid": 9, "name": "process_name",
         "args": {"name": "python host"}},
        {"ph": "X", "pid": 1, "tid": 1, "name": "fusion.1", "ts": 0,
         "dur": 500.0},
        {"ph": "X", "pid": 1, "tid": 1, "name": "fusion.1", "ts": 600,
         "dur": 700.0},
        {"ph": "X", "pid": 1, "tid": 1, "name": "copy.2", "ts": 1400,
         "dur": 100.0},
        {"ph": "X", "pid": 9, "tid": 1, "name": "hostop", "ts": 0,
         "dur": 9999.0}]}
    path = tmp_path / "host.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(trace, f)
    assert parse_device_trace(str(path)) == ref_parse(str(path))


def test_state_machine_drives_the_windows():
    seen = []
    p = Profiler(scheduler=make_scheduler(closed=1, ready=1, record=2,
                                          repeat=1),
                 on_trace_ready=lambda prof: seen.append(prof.step_num))
    p.start()
    states = [p.current_state]
    for _ in range(5):
        _ = _x(2) * 2.0
        p.step()
        states.append(p.current_state)
    p.stop()
    assert states == [ProfilerState.CLOSED, ProfilerState.READY,
                      ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN,
                      ProfilerState.CLOSED, ProfilerState.CLOSED]
    assert seen == [4]
    assert [e.name for e in p.events()].count("multiply") == 2
