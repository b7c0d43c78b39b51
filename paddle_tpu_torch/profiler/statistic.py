"""Summary statistics over the host event stream and the device trace
(↔ paddle_tpu/profiler/statistic.py; reference:
python/paddle/profiler/profiler_statistic.py — per-op aggregation and the
formatted summary tables: Overview Summary, Operator Summary, Kernel
Summary).

Host op events come from the op event hook at `framework.core`'s dispatch
point (the reference's RecordEvent stream); device kernel times come from
the chrome trace that `torch.profiler` writes into `device_trace_dir`, in
Kineto's layout: each CUDA kernel is a complete event (`"ph": "X"`) of
`"cat": "kernel"` named by the kernel's C++ symbol, its `dur` in
microseconds (the reference parses the XLA trace's device tracks, :75-147;
a trace in that layout, events without a `cat` on a process whose name
mentions a device, parses too).
"""

from __future__ import annotations

import glob
import gzip
import json
import os
from collections import defaultdict

_UNIT = {"s": 1e-9, "ms": 1e-6, "us": 1e-3, "ns": 1.0}


def aggregate(events):
    """name -> dict(calls, total_ns, avg_ns, min_ns, max_ns, cat)."""
    agg = {}
    for e in events:
        d = agg.get(e.name)
        dur = e.end_ns - e.start_ns
        if d is None:
            agg[e.name] = d = dict(calls=0, total=0, mn=None, mx=0, cat=e.cat)
        d["calls"] += 1
        d["total"] += dur
        d["mn"] = dur if d["mn"] is None else min(d["mn"], dur)
        d["mx"] = max(d["mx"], dur)
    return agg


def _table(title, rows, width, scale, time_unit, grand):
    """rows: [(name, dict)] sorted; returns formatted lines."""
    out = []
    out.append(f"\n{'-' * (width + 58)}")
    out.append(f"{title}   (time unit: {time_unit})")
    out.append(f"{'-' * (width + 58)}")
    out.append(f"{'Name'.ljust(width)}  {'Calls':>7}  {'Total':>10}  "
               f"{'Avg':>10}  {'Min':>10}  {'Max':>10}  {'Ratio':>6}")
    for name, d in rows:
        t, c = d["total"], d["calls"]
        out.append(
            f"{name.ljust(width)}  {c:>7}  {t * scale:>10.3f}  "
            f"{t / c * scale:>10.3f}  {d['mn'] * scale:>10.3f}  "
            f"{d['mx'] * scale:>10.3f}  {t / grand:>6.1%}")
    return out


def build_overview(events, time_unit="ms"):
    """Overview Summary: time per event category (reference
    profiler_statistic.py overview table)."""
    scale = _UNIT.get(time_unit, 1e-6)
    by_cat = defaultdict(lambda: dict(calls=0, total=0, mn=None, mx=0))
    for e in events:
        d = by_cat[e.cat]
        dur = e.end_ns - e.start_ns
        d["calls"] += 1
        d["total"] += dur
        d["mn"] = dur if d["mn"] is None else min(d["mn"], dur)
        d["mx"] = max(d["mx"], dur)
    if not by_cat:
        return []
    grand = sum(d["total"] for d in by_cat.values()) or 1
    rows = sorted(by_cat.items(), key=lambda kv: -kv[1]["total"])
    width = max([len(c) for c in by_cat] + [20])
    return _table("Overview Summary", rows, width, scale, time_unit, grand)


def find_device_trace(trace_dir):
    """Latest chrome trace under a device trace dir (the Profiler writes
    <host>_pid<pid>_<ms>.pt.trace.json; an XLA capture writes
    plugins/profile/<ts>/<host>.trace.json.gz)."""
    pats = [os.path.join(trace_dir, "**", "*.trace.json.gz"),
            os.path.join(trace_dir, "**", "*.trace.json"),
            os.path.join(trace_dir, "*.json.gz"),
            os.path.join(trace_dir, "*.json")]
    cands = []
    for p in pats:
        cands.extend(glob.glob(p, recursive=True))
    if not cands:
        return None
    return max(cands, key=os.path.getmtime)


def parse_device_trace(path, max_ops=None):
    """Aggregate the device's kernel events of a chrome trace.

    Returns name -> dict(calls, total_ns, mn, mx, cat="kernel"). A kernel
    event is a complete event of `"cat": "kernel"` (Kineto), or one without
    a `cat` on a device track (a process whose metadata name mentions a
    device: "/device:", "TPU", "GPU"; the XLA layout); `dur` is in us.
    """
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    events = data.get("traceEvents", data if isinstance(data, list) else [])
    dev_pids = set()
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "process_name":
            pname = str(e.get("args", {}).get("name", ""))
            if ("/device:" in pname or "TPU" in pname or "GPU" in pname
                    or pname.startswith("Device")):
                dev_pids.add(e.get("pid"))
    agg = {}
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = e.get("cat")
        if cat != "kernel" and (cat is not None or e.get("pid") not in dev_pids):
            continue
        name = e.get("name", "?")
        dur_ns = float(e.get("dur", 0)) * 1e3  # chrome trace dur is us
        d = agg.get(name)
        if d is None:
            agg[name] = d = dict(calls=0, total=0.0, mn=None, mx=0.0,
                                 cat="kernel")
        d["calls"] += 1
        d["total"] += dur_ns
        d["mn"] = dur_ns if d["mn"] is None else min(d["mn"], dur_ns)
        d["mx"] = max(d["mx"], dur_ns)
    if max_ops is not None and len(agg) > max_ops:
        top = sorted(agg.items(), key=lambda kv: -kv[1]["total"])[:max_ops]
        agg = dict(top)
    return agg


def build_device_summary(trace_dir, time_unit="ms", max_ops=30):
    """Kernel Summary from the captured device trace (reference
    profiler_statistic.py kernel table over CUPTI records, which Kineto's
    trace holds here)."""
    scale = _UNIT.get(time_unit, 1e-6)
    path = find_device_trace(trace_dir) if trace_dir else None
    if path is None:
        return []
    try:
        agg = parse_device_trace(path, max_ops=max_ops)
    except Exception:
        return []
    if not agg:
        return []
    grand = sum(d["total"] for d in agg.values()) or 1
    rows = sorted(agg.items(), key=lambda kv: -kv[1]["total"])
    width = min(max([len(n) for n in agg] + [20]), 60)
    rows = [(n[:width], d) for n, d in rows]
    return _table(f"Kernel Summary (device, top {len(rows)})", rows, width,
                  scale, time_unit, grand)


def build_summary(events, time_unit="ms", device_trace_dir=None):
    """Formatted tables: Overview + per-category host ops + device kernels,
    sorted by total time (reference profiler_statistic.py _build_table)."""
    scale = _UNIT.get(time_unit, 1e-6)
    agg = aggregate(events)
    dev = build_device_summary(device_trace_dir, time_unit)
    if not agg and not dev:
        return "no profiler events recorded"
    out = []
    out.extend(build_overview(events, time_unit))
    by_cat = defaultdict(list)
    for name, d in agg.items():
        by_cat[d["cat"]].append((name, d))
    grand = sum(d["total"] for d in agg.values()) or 1
    width = max([len(n) for n in agg] + [20]) if agg else 20
    for cat in sorted(by_cat):
        rows = sorted(by_cat[cat], key=lambda kv: -kv[1]["total"])
        out.extend(_table(f"Category: {cat}", rows, width, scale, time_unit,
                          grand))
    out.extend(dev)
    return "\n".join(out)
