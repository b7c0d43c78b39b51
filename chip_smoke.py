#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. build   — compile paddle_tpu_torch/csrc/*.cu with nvcc (sm_90a), load it.
2. kernels — each hand-written kernel against its plain PyTorch version on
             the card, at the serving path's shapes and a few edge shapes,
             in float32 and bfloat16: max error against a stated tolerance,
             device time (CUDA graph replays timed by CUDA events, warm
             L2) and eager back-to-back time, the plain version's time,
             the least time the card could take (bound), and the time of
             one PyTorch library call computing the same function where
             there is one.
3. serve   — gpt3_1p3b at full width and depth in bf16, random weights from
             a seed, through inference.create_serving_engine (paged, 16
             rows, 512 tokens, page size 32) over 12 requests of the serving
             benchmark's mix. Launch counters are zeroed just before and read
             just after: every LayerNorm and every decode attention must have
             gone through its kernel. Then torch.profiler over five decode
             ticks of a full batch: device-busy share and top kernels.
4. hold    — gpt3_1p3b width at 2 layers in f32 (TF32 off): the same greedy
             requests through the engine on the card (kernels) and on the
             CPU (plain versions); first-decode-tick logits within tolerance
             and identical tokens.

The second-to-last line is a JSON object listing the kernels; the last line
is {"ok": true, "device": {...}}. Every number printed sits beside the
card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12    # H100 SXM HBM3
PEAK_OPS = {"float32": 67e12, "bfloat16": 989e12}  # f32 CUDA cores; bf16 dense tensor
# Kernel vs plain version, max |err| of outputs of magnitude <= ~4:
# f32 differs only in the order of the row/softmax sums (a few ulps);
# bf16 computes in f32 on identical inputs and rounds once, so the two may
# land on neighbouring bf16 values: two ulps at |y| < 4 (norm, 2^-6 each)
# and at |o| < 2 (decode, 2^-7 each).
NORM_TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
DECODE_TOL = {"float32": 1e-4, "bfloat16": 1.6e-2}
# Engine on the card vs on the CPU, f32 with TF32 off: logits of magnitude
# ~1 summed in other orders over K <= 8192 differ by a few 1e-6; 1e-3
# leaves room for that while catching a wrong mask, page or layer.
HOLD_LOGIT_TOL = 1e-3


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def say(card, msg):
    print(f"[{card}] {msg}", flush=True)


def time_ms(fn, reps=15, inner=20):
    """Device time of one call: `inner` calls captured into a CUDA graph,
    the graph replayed `reps` times between CUDA events; the median replay
    over `inner`. The graph takes the host (Python, ctypes, launch
    latency) out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def eager_ms(fn, reps=15, inner=20):
    """Time of one call launched eagerly back to back (CUDA events): what
    the engine's eager loop pays, host overhead included when the host is
    slower than the device."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #


def check_norm(card, torch):
    from paddle_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    main = None
    # (R, N, kind): decode rows and prefill rows at the 1.3B width, the 13B
    # width, an odd width, and the RMSNorm form of the same kernel
    shapes = [(16, 2048, "ln"), (512, 2048, "ln"), (16, 5120, "ln"),
              (37, 1031, "ln"), (16, 2048, "rms")]
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for R, N, kind in shapes:
            x = torch.randn(R, N, device="cuda", generator=gen).to(dt)
            w = (1 + 0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
            b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
            bias = b if kind == "ln" else None
            out, rstd, mean = fn.norm_fwd(x, w, bias, kind, 1e-5)
            ref, rstd_ref, mean_ref = fn.norm_fwd_plain(x, w, bias, kind, 1e-5)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            err_stats = (rstd - rstd_ref).abs().max().item() / rstd_ref.abs().max().item()
            if kind == "ln":
                err_stats = max(err_stats, (mean - mean_ref).abs().max().item())
            if not (err <= NORM_TOL[dtype] and err_stats <= 1e-5):
                raise AssertionError(
                    f"fused_norm {kind} {dtype} [{R},{N}]: max|out err| {err} "
                    f"(tol {NORM_TOL[dtype]}), stats err {err_stats} (tol 1e-5)")
            worst = max(worst, err)
            es = x.element_size()
            nbytes = 2 * R * N * es + (2 if bias is not None else 1) * N * es \
                + R * 4 * (2 if kind == "ln" else 1)
            bnd, by = bound_ms(nbytes, 8 * R * N, "float32")
            k_ms = time_ms(lambda: fn.norm_fwd(x, w, bias, kind, 1e-5))
            k_eager = eager_ms(lambda: fn.norm_fwd(x, w, bias, kind, 1e-5))
            p_ms = time_ms(lambda: fn.norm_fwd_plain(x, w, bias, kind, 1e-5))
            lib_ms = None
            if kind == "ln":
                lib_ms = time_ms(lambda: torch.nn.functional.layer_norm(
                    x, (N,), w, bias, 1e-5))
            row = dict(kind=kind, dtype=dtype, R=R, N=N, max_abs_err=err,
                       tol=NORM_TOL[dtype], ms=k_ms, eager_ms=k_eager,
                       plain_ms=p_ms,
                       bound_ms=bnd, bound_by=by, library_ms=lib_ms)
            say(card, "fused_norm " + json.dumps(row))
            if (R, N, kind, dtype) == (16, 2048, "ln", "bfloat16"):
                main = row
    return {"worst": worst, "main": main}


def _decode_case(torch, gen, B, H, Hkv, D, ps, P, lengths, holes, dtype):
    n_pages = B * P + 1
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(dtype)
    kc = torch.randn(n_pages, Hkv, ps, D, device="cuda", generator=gen).to(dtype)
    vc = torch.randn(n_pages, Hkv, ps, D, device="cuda", generator=gen).to(dtype)
    perm = np.random.default_rng(1).permutation(np.arange(1, n_pages))
    tables = np.full((B, P), -1, np.int32)
    nxt = 0
    for b, L in enumerate(lengths):
        for j in range(-(-L // ps)):
            tables[b, j] = perm[nxt]
            nxt += 1
    for b, j in holes:
        tables[b, j] = -1
    lens = np.asarray(lengths, np.int32)
    valid = 0  # tokens whose K/V the function must read
    for b, L in enumerate(lengths):
        for j in range(P):
            if tables[b, j] >= 0:
                valid += max(0, min(ps, L - j * ps))
    return (q, kc, vc, torch.tensor(tables, device="cuda"),
            torch.tensor(lens, device="cuda"), valid)


def check_decode(card, torch):
    from paddle_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(1)
    # serving path: B=16 rows, 16 heads of 128, page size 32, 512 tokens;
    # ragged lengths, a zero-length row, a parked row (length 1, table all
    # -1) and a -1 hole in the middle of a row's table
    path_lengths = [512, 1, 0, 33, 100, 255, 256, 257, 300, 31, 32, 64, 480,
                    129, 17, 200]
    cases = {
        "path_g1": (16, 16, 16, 128, 32, 16, path_lengths,
                    [(1, 0), (3, 0), (8, 4)]),
        "gqa_g4": (16, 16, 4, 128, 32, 16, path_lengths, [(12, 7)]),
        "gqa_g2_d64_ps13": (5, 8, 4, 64, 13, 10, [130, 1, 0, 77, 14], [(3, 2)]),
    }
    worst = 0.0
    main = None
    for dtype in ("float32", "bfloat16"):
        dt = getattr(torch, dtype)
        for name, (B, H, Hkv, D, ps, P, lengths, holes) in cases.items():
            q, kc, vc, tables, lens, valid = _decode_case(
                torch, gen, B, H, Hkv, D, ps, P, lengths, holes, dt)
            out = da.paged_decode_attention(q, kc, vc, tables, lens)
            ref = da.paged_decode_attention_plain(q, kc, vc, tables, lens,
                                                  D ** -0.5)
            torch.cuda.synchronize()
            if not torch.isfinite(out.float()).all():
                raise AssertionError(f"paged_decode {name} {dtype}: non-finite output")
            # rows with no readable token: zero length, or every page -1
            # (row 1 of path_g1 is a parked row: length 1, table all -1)
            zero_rows = [b for b in range(B) if (tables[b] < 0).all()]
            if any(out[b].abs().max().item() != 0 for b in zero_rows):
                raise AssertionError(f"paged_decode {name} {dtype}: a row "
                                     "without valid tokens is not zero")
            err = (out.float() - ref.float()).abs().max().item()
            if not err <= DECODE_TOL[dtype]:
                raise AssertionError(
                    f"paged_decode {name} {dtype}: max|err| {err} "
                    f"(tol {DECODE_TOL[dtype]})")
            worst = max(worst, err)
            es = q.element_size()
            nbytes = (2 * valid * Hkv * D * es + 2 * q.numel() * es
                      + tables.numel() * 4 + lens.numel() * 4)
            ops = 4 * valid * (H // Hkv) * Hkv * D
            bnd, by = bound_ms(nbytes, ops, dtype)
            k_ms = time_ms(lambda: da.paged_decode_attention(q, kc, vc, tables, lens))
            k_eager = eager_ms(lambda: da.paged_decode_attention(q, kc, vc, tables, lens))
            p_ms = time_ms(lambda: da.paged_decode_attention_plain(
                q, kc, vc, tables, lens, D ** -0.5), reps=5, inner=3)
            row = dict(case=name, dtype=dtype, B=B, H=H, Hkv=Hkv, D=D, ps=ps,
                       valid_tokens=valid, max_abs_err=err,
                       tol=DECODE_TOL[dtype], ms=k_ms, eager_ms=k_eager,
                       plain_ms=p_ms,
                       bound_ms=bnd, bound_by=by, library_ms=None)
            say(card, "paged_decode " + json.dumps(row))
            if (name, dtype) == ("path_g1", "bfloat16"):
                main = row
    say(card, "paged_decode library_ms: none; no single PyTorch call attends "
              "through a block table over a paged cache")
    return {"worst": worst, "main": main}


# --------------------------------------------------------------------------- #
# phase 3: serve gpt3_1p3b
# --------------------------------------------------------------------------- #


def serving_workload(vocab_size, S, n_req):
    """The serving benchmark's request mix (bench.py _serving_workload):
    every third prompt extends one long common prefix, lengths staggered,
    every fourth request sampled at T=0.7, the rest greedy."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab_size, S // 4).astype(np.int32)
    out = []
    for i in range(n_req):
        tail = rng.integers(1, vocab_size, 2 + i % (S // 8)).astype(np.int32)
        prompt = (np.concatenate([shared, tail]) if i % 3 == 0
                  else rng.integers(1, vocab_size, 4 + i % (S // 4)).astype(np.int32))
        out.append((prompt, 0.7 if i % 4 == 0 else 0.0))
    return out


def serve(card, torch):
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import fused_norm as fn

    cfg = gpt3_1p3b()
    B, S, ps, n_req, max_new = 16, 512, 32, 12, 16
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(card, f"serve: gpt3_1p3b bf16, {n_params} parameters, built in "
              f"{time.perf_counter() - t0:.3f} s")

    # warm-up engine (cuBLAS handles, allocator): one short request
    warm = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                 page_size=ps)
    warm.add_request(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    warm.run()
    del warm

    eng = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                page_size=ps, seed=0)
    for prompt, temp in serving_workload(cfg.vocab_size, S, n_req):
        eng.add_request(prompt, max_new_tokens=max_new, temperature=temp)
    torch.cuda.synchronize()
    fn.LAUNCHES = 0
    da.LAUNCHES = 0
    t_start = time.perf_counter()
    peak_used = 0
    while eng.has_work():
        eng.step()
        peak_used = max(peak_used, eng.pool.pages_total - eng.pool.pages_free)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_start
    launches = {"fused_norm": fn.LAUNCHES, "paged_decode_attention": da.LAUNCHES}

    done = eng.finished
    m = eng.metrics
    decode_ticks = m["step_seconds"].count(engine="paged")
    L = cfg.num_layers
    want = {"fused_norm": (n_req + decode_ticks) * (2 * L + 1),
            "paged_decode_attention": decode_ticks * L}
    if len(done) != n_req or any(len(r.generated) != max_new for r in done):
        raise AssertionError("serve: not every request finished with "
                             f"{max_new} tokens")
    if not torch.isfinite(eng.last_logits.float()).all():
        raise AssertionError("serve: non-finite logits")
    if launches != want:
        raise AssertionError(f"serve: kernel launches {launches}, expected "
                             f"{want} (every LayerNorm and decode attention)")
    tokens = m["tokens"].value(engine="paged")
    ttft = m["ttft"].values(engine="paged")
    steps = m["step_seconds"].values(engine="paged")
    line = {
        "model": "gpt3_1p3b", "dtype": "bfloat16", "batch": B,
        "max_seq_len": S, "page_size": ps, "requests": len(done),
        "tokens": tokens, "seconds": total_s, "tokens_per_s": tokens / total_s,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "step_p99_s": float(np.percentile(steps, 99)),
        "decode_ticks": decode_ticks, "pages_total": eng.pool.pages_total,
        "peak_pages_used": peak_used, "page_allocs": eng.pool.allocs_total,
        "prefix_hits": m["prefix_hits"].value(),
        "preemptions": m["preemptions"].value(), "launches": launches,
    }
    say(card, "serve (smoke run, not a benchmark) " + json.dumps(line))
    del eng
    profile_decode(card, torch, model, B, S, ps)
    del model
    torch.cuda.empty_cache()
    return launches


def profile_decode(card, torch, model, B, S, ps, ticks=5):
    """Where a decode tick's time goes: torch.profiler over `ticks` decode
    ticks of a full batch (B live rows, 16-token prompts; the admission
    tick is left out). Prints the wall time per tick, the device-busy time
    per tick (the sum of device activity; one stream, so nothing overlaps)
    and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import create_serving_engine

    eng = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                page_size=ps, seed=0)
    rng = np.random.default_rng(1)
    for _ in range(B):
        eng.add_request(rng.integers(1, model.config.vocab_size, 16),
                        max_new_tokens=ticks + 2)
    eng.step()  # admission (B prefills) and the first decode tick
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(ticks):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    def dev_us(e):
        return e.self_device_time_total

    # device-side events only (kernels, copies); the CPU ops that launched
    # them carry the same time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and dev_us(e) > 0]
    busy_us = sum(dev_us(e) for e in events)
    top = sorted(events, key=dev_us, reverse=True)[:8]
    say(card, "decode tick profile " + json.dumps({
        "rows": B, "ticks": ticks, "wall_ms_per_tick": wall * 1e3 / ticks,
        "device_busy_ms_per_tick": busy_us / 1e3 / ticks,
        "device_busy_share": busy_us / 1e6 / wall if wall > 0 else None,
        "top_device_kernels": [
            {"name": e.key[:80], "ms_per_tick": dev_us(e) / 1e3 / ticks,
             "calls_per_tick": e.count / ticks} for e in top]}))


# --------------------------------------------------------------------------- #
# phase 4: the same engine on the card (kernels) and on the CPU (plain)
# --------------------------------------------------------------------------- #


def hold(card, torch):
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(gpt3_1p3b(), num_layers=2)
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=1)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32, seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = [p for p, _ in serving_workload(cfg.vocab_size, 128, 4)]
    results = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        eng = create_serving_engine(model, max_batch_size=4, max_seq_len=128,
                                    page_size=32, seed=0)
        ids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        eng.step()  # admission + the first decode tick
        first = eng.last_logits.float().cpu()
        by = {r.req_id: r for r in eng.run()}
        results[name] = (first, [by[i].generated for i in ids])
    diff = (results["cuda"][0] - results["cpu"][0]).abs().max().item()
    same = results["cuda"][1] == results["cpu"][1]
    say(card, "hold " + json.dumps({
        "model": "gpt3_1p3b width, 2 layers", "dtype": "float32",
        "first_tick_max_abs_logit_diff": diff, "tol": HOLD_LOGIT_TOL,
        "tokens_identical": same, "tokens_cuda": results["cuda"][1]}))
    if not (diff <= HOLD_LOGIT_TOL and same):
        raise AssertionError("hold: the card's engine disagrees with the CPU's")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from paddle_tpu_torch.ops import _build

    card = card_line()
    print(card, flush=True)
    say(card, f"torch {torch.__version__} cuda {torch.version.cuda} "
              f"device {torch.cuda.get_device_name(0)}")

    t0 = time.perf_counter()
    _build.load_library()
    say(card, f"build: {time.perf_counter() - t0:.2f} s")
    for ln in _build.BUILD_LOG.splitlines():
        if "Used" in ln or "spill" in ln:
            say(card, "ptxas: " + ln.strip())

    norm = check_norm(card, torch)
    decode = check_decode(card, torch)
    launches = serve(card, torch)
    hold(card, torch)

    kernels = []
    for name, src, replaces, res in (
            ("fused_norm", "paddle_tpu_torch/csrc/fused_norm.cu",
             "paddle_tpu/ops/pallas/fused_norm.py:107", norm),
            ("paged_decode_attention", "paddle_tpu_torch/csrc/decode_attention.cu",
             "paddle_tpu/ops/pallas/decode_attention.py:50", decode)):
        main_row = res["main"]
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": res["worst"],
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
