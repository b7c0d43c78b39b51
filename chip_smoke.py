#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. build      — compile paddle_tpu_torch/csrc/*.cu with nvcc (sm_90a, one
                process per source, in parallel), load it.
2. kernels    — each hand-written kernel against its plain PyTorch version
                on the card, at the shapes its path gives it and a few edge
                shapes, in float32 and bfloat16: max error against a stated
                tolerance, device time (CUDA graph replays timed by CUDA
                events, warm L2) and eager back-to-back time, the plain
                version's time, the least time the card could take (bound),
                and the time of one PyTorch library call computing the same
                function where there is one. Fused norm forward and dx,
                paged decode attention, flash attention forward, dq and
                dk/dv.
2b. faults    — the flash kernels built again from copies of csrc/, each
                with one planted fault (a kv or q tile skipped, long rows
                normalised 1% off): at the path's shape every one must
                fail the limits of phase 2.
3. serve      — gpt3_1p3b at full width and depth in bf16, random weights
                from a seed, through inference.create_serving_engine (paged,
                16 rows, 512 tokens, page size 32) over 12 requests of the
                serving benchmark's mix. Launch counters are zeroed just
                before and read just after: every LayerNorm and every decode
                attention must have gone through its kernel. Then
                torch.profiler over five decode ticks of a full batch:
                device-busy share and top kernels.
4. hold       — gpt3_1p3b width at 2 layers in f32 (TF32 off): the same
                greedy requests through the engine on the card (kernels) and
                on the CPU (plain versions); first-decode-tick logits within
                tolerance and identical tokens.
5. train      — gpt3_1p3b at full width and depth, batch 4 x 2048 tokens,
                the bench's 1.3B recipe: amp.decorate O2 (bf16 parameters,
                LayerNorm in f32), AdamW(lr 1e-4, bf16 moments), per-layer
                recompute, an O2 bf16 step through
                distributed.DistributedTrainStep. One warm-up step (every
                parameter must change; gradients must reach the token
                embedding and layer 0's input LayerNorm), then three timed
                steps with the launch counters zeroed just before and read
                just after: per step 48 flash forwards (24 + 24 in
                recompute), 24 dq, 24 dk/dv, 97 norm forwards (49 + 48 in
                recompute) and 49 norm dx. Step time, tokens/s, MFU, peak
                memory, and torch.profiler over one step.
6. train hold — gpt3_1p3b width at 2 layers, batch 2 x 256, f32 (TF32
                off), recompute on: three AdamW steps on the card (kernels)
                and on the CPU (plain versions) from the same weights; the
                losses and the step-1 gradients within tolerance.

The second-to-last line is a JSON object listing the kernels; the last line
is {"ok": true, "device": {...}}. Every number printed sits beside the
card's name and power limit as nvidia-smi reports them.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import re
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
# Norm dx kernel vs plain, max |err| of outputs of magnitude <= ~4: the
# same f32 arithmetic, row sums in another order; bf16 rounds once, two
# ulps as for the forward.
NORM_DX_TOL = {"float32": 1e-4, "bfloat16": 3.2e-2}
# Flash attention kernels vs plain, every element held to its own row:
# |got - plain| <= FLASH_TOL * max |plain| over the row (a query row of O
# and dQ, a key row of dK and dV), a row whose largest |plain| is below a
# thousandth of the tensor's largest (a row of zeros, or a gradient that
# cancels to rounding noise, like dQ of a row that sees one key) being held
# to that thousandth instead. At the path shape the rows span two orders of
# magnitude (row 0 of O is v_0, a row past a thousand keys averages as
# many values to |O| ~ 0.03), so one limit set by the largest entry would
# pass a kernel that lost a kv tile. f32 differs only in the order of the
# sums over D and over the keys. bf16 rounds P and dS to bf16 on both
# sides, but the kernel rounds exp(s - running max) and the plain version
# exp(s - row max), and O and dQ round once more: one bf16 ulp (up to 2^-7
# relative) of a row's largest value; dK/dV come out in f32. The limit is
# two ulps. Beside it, the whole tensor: ||got - plain||_F / ||plain||_F
# <= FLASH_FROB_TOL. LSE is f32 on both sides, its sums in another order.
# Measured on an H100 80GB HBM3 over the cases below: row-relative 2^-7
# (O), 0.005 (dQ), 0.0042 (dK/dV); Frobenius at most 2.0e-3 (O) and
# 1.1e-4 (gradients), where a forward kernel that normalises its long rows
# 1% off gives 7.5e-3 (phase 2b); LSE 9.5e-7.
FLASH_TOL = {"float32": 1e-4, "bfloat16": 2 ** -6}
FLASH_FROB_TOL = {"float32": 1e-5, "bfloat16": 4e-3}
FLASH_LSE_TOL = 1e-5
# Training step on the card vs on the CPU, f32 with TF32 off, 2 layers at
# the 1.3B width: the losses (~10.8) agree to a few 1e-6 relative; each
# gradient's max |diff| is held to 1e-3 of its largest entry (or of a
# thousandth of the largest gradient anywhere, for tensors whose gradient
# is analytically zero, like the k-projection biases).
TRAIN_HOLD_LOSS_RTOL = 1e-4
TRAIN_HOLD_GRAD_TOL = 1e-3


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


def ptxas_summary(log):
    """One line for nvcc's `-Xptxas -v` report: kernels compiled, the most
    registers any uses, and each kernel that spills (its name and mangled
    template arguments) with its spill-store bytes."""
    regs, spills, name = [], {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            mangled = ln.split("'")[1] if "'" in ln else ln
            m = re.search(r"\d([a-z_]+_kernel)(I\w*?E)?", mangled)
            name = "".join(m.groups("")) if m else mangled[-60:]
        elif "Used" in ln and "registers" in ln:
            regs.append(int(ln.split("Used")[1].split("registers")[0]))
        elif "bytes spill stores" in ln:
            stored = int(ln.split("bytes spill stores")[0].split(",")[-1])
            if stored:
                spills[name or "?"] = stored
    return {"kernels": len(regs), "max_registers": max(regs, default=0),
            "spill_store_bytes": spills}


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
    # (R, N, kind): decode rows and prefill rows at the 1.3B width, the
    # training step's rows (batch 4 x 2048; f32 under O2), the 13B width,
    # an odd width, and the RMSNorm form of the same kernel
    shapes = [(16, 2048, "ln"), (512, 2048, "ln"), (8192, 2048, "ln"),
              (16, 5120, "ln"), (37, 1031, "ln"), (16, 2048, "rms")]
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


def check_norm_dx(card, torch):
    """The dx kernel against its plain version. The main path's shape is
    f32 [8192, 2048] (under O2 LayerNorm runs in f32, batch 4 x 2048)."""
    from paddle_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    main = None
    shapes = [(8192, 2048, "ln", "float32"), (8192, 2048, "ln", "bfloat16"),
              (37, 1031, "ln", "float32"), (37, 1031, "ln", "bfloat16"),
              (512, 2048, "rms", "bfloat16"), (16, 5120, "rms", "float32")]
    for R, N, kind, dtype in shapes:
        dt = getattr(torch, dtype)
        x = (torch.randn(R, N, device="cuda", generator=gen) + 0.5).to(dt)
        w = (1 + 0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
        b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
        dy = torch.randn(R, N, device="cuda", generator=gen).to(dt)
        _, rstd, mean = fn.norm_fwd_plain(x, w, b if kind == "ln" else None,
                                          kind, 1e-5)
        dx = fn.norm_bwd_dx(x, w, dy, rstd, mean, kind)
        ref = fn.norm_bwd_dx_plain(x, w, dy, rstd, mean, kind)
        torch.cuda.synchronize()
        err = (dx.float() - ref.float()).abs().max().item()
        if not err <= NORM_DX_TOL[dtype]:
            raise AssertionError(f"fused_norm_dx {kind} {dtype} [{R},{N}]: "
                                 f"max|err| {err} (tol {NORM_DX_TOL[dtype]})")
        worst = max(worst, err)
        es = x.element_size()
        nbytes = 3 * R * N * es + N * es + R * 4 * (2 if kind == "ln" else 1)
        bnd, by = bound_ms(nbytes, 10 * R * N, "float32")
        k_ms = time_ms(lambda: fn.norm_bwd_dx(x, w, dy, rstd, mean, kind))
        k_eager = eager_ms(lambda: fn.norm_bwd_dx(x, w, dy, rstd, mean, kind))
        p_ms = time_ms(lambda: fn.norm_bwd_dx_plain(x, w, dy, rstd, mean, kind),
                       reps=5, inner=5)
        lib_ms = None
        if kind == "ln":
            mean2, rstd2 = mean[:, None], rstd[:, None]
            lib_ms = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [N], mean2, rstd2, w, b, [True, False, False]))
        row = dict(kind=kind, dtype=dtype, R=R, N=N, max_abs_err=err,
                   tol=NORM_DX_TOL[dtype], ms=k_ms, eager_ms=k_eager,
                   plain_ms=p_ms, bound_ms=bnd, bound_by=by,
                   library_ms=lib_ms)
        say(card, "fused_norm_dx " + json.dumps(row))
        if (R, N, kind, dtype) == (8192, 2048, "ln", "float32"):
            main = row
    say(card, "fused_norm_dx library_ms: torch.ops.aten.native_layer_norm_"
              "backward (dx only); none for RMSNorm")
    return {"worst": worst, "main": main}


def _flash_err(got, ref):
    """(max |got - ref|, the largest over rows (the last axis is a row) of
    max |got - ref| / max(max |ref| in the row, max |ref| / 1000),
    ||got - ref||_F / ||ref||_F)."""
    got, ref = got.float(), ref.float()
    d = (got - ref).abs()
    top = ref.abs().amax(-1)
    floor = max(top.max().item() * 1e-3, 1e-30)
    row = d.amax(-1) / top.clamp_min(floor)
    return (d.max().item(), row.max().item(),
            (d.norm() / ref.norm().clamp_min(1e-30)).item())


def _lse_err(got, ref):
    """max |got - ref| over the rows that see a key; inf if the rows that see
    none (LSE +inf) differ."""
    fin = ref.isfinite()
    if not bool((fin == got.isfinite()).all()):
        return math.inf
    return (got - ref)[fin].abs().max().item() if fin.any() else 0.0


def _flash_errs(got, ref):
    return {w: _lse_err(g, ref[w]) if w == "lse" else _flash_err(g, ref[w])
            for w, g in got.items()}


def _flash_violations(errs, dtype):
    """The outputs whose errors (as `_flash_errs` gives them) break the
    limits."""
    bad = []
    for what, e in errs.items():
        if what == "lse":
            if not e <= FLASH_LSE_TOL:
                bad.append(f"lse max|err| {e} (tol {FLASH_LSE_TOL})")
        elif not (e[1] <= FLASH_TOL[dtype] and e[2] <= FLASH_FROB_TOL[dtype]):
            bad.append(f"{what} row-relative {e[1]} (tol {FLASH_TOL[dtype]}), "
                       f"Frobenius {e[2]} (tol {FLASH_FROB_TOL[dtype]})")
    return bad


# name: (B, Sq, Skv, H, Hkv, D, causal, key bias, dtype)
FLASH_CASES = {
    "path": (4, 2048, 2048, 16, 16, 128, True, False, "bfloat16"),
    "f32": (1, 1024, 1024, 16, 16, 128, True, False, "float32"),
    "gqa_g4": (2, 512, 512, 16, 4, 128, True, False, "bfloat16"),
    "ragged_sq_lt_skv_g2_d64": (2, 333, 517, 8, 4, 64, True, False, "bfloat16"),
    "sq_gt_skv_f32_d64": (1, 300, 200, 4, 4, 64, True, False, "float32"),
    "key_bias_padded_row": (3, 257, 257, 8, 8, 128, False, True, "bfloat16"),
}


def _flash_inputs(torch, gen, B, Sq, Skv, H, Hkv, D, bias, dtype):
    """(q, k, v, dO, key bias or None, keep [B, Skv] bool). With `bias`,
    batch row b pads its last 17 (b + 1) keys and batch row 1 all of
    them."""
    dt = getattr(torch, dtype)
    q = torch.randn(B, Sq, H, D, device="cuda", generator=gen).to(dt)
    k = torch.randn(B, Skv, Hkv, D, device="cuda", generator=gen).to(dt)
    v = torch.randn(B, Skv, Hkv, D, device="cuda", generator=gen).to(dt)
    dout = torch.randn(B, Sq, H, D, device="cuda", generator=gen).to(dt)
    kb = None
    keep = torch.ones(B, Skv, dtype=torch.bool, device="cuda")
    if bias:
        for bi in range(B):
            keep[bi, Skv - 17 * (bi + 1):] = False
        keep[1] = False
        kb = torch.where(keep, 0.0, -1e30).float()
    return q, k, v, dout, kb, keep


def _flash_outputs(fa, q, k, v, dout, kb, causal, scale):
    """(the kernels' outputs, the plain versions', delta) on the same
    inputs; the backward kernels get the plain forward's LSE and
    delta = rowsum(dO * O)."""
    out, lse = fa.flash_fwd(q, k, v, causal, scale, kb)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale, kb)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq = fa.flash_bwd_dq(q, k, v, kb, dout, lse_p, delta, causal, scale)
    dq_p = fa.flash_bwd_dq_plain(q, k, v, kb, dout, lse_p, delta, causal, scale)
    dk, dv = fa.flash_bwd_dkv(q, k, v, kb, dout, lse_p, delta, causal, scale)
    dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, kb, dout, lse_p, delta,
                                        causal, scale)
    return ({"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
            {"out": out_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
            delta)


def check_flash(card, torch):
    """Forward, dq and dk/dv kernels against their plain versions on the
    same inputs (the backward kernels get the plain forward's LSE and
    delta). Cases: the training path's shape (B 4, S 2048, 16 heads of 128,
    causal, bf16), f32, GQA g = 4, ragged Sq != Skv (bottom-right causal),
    Sq > Skv (rows that see no key), a key bias with a fully padded batch
    row."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(3)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    main = {}
    failures = []  # raised together once every case has printed its row
    for name, (B, Sq, Skv, H, Hkv, D, causal, bias, dtype) in FLASH_CASES.items():
        q, k, v, dout, kb, keep = _flash_inputs(torch, gen, B, Sq, Skv, H,
                                                Hkv, D, bias, dtype)
        scale = D ** -0.5
        got, plain, delta = _flash_outputs(fa, q, k, v, dout, kb, causal, scale)
        torch.cuda.synchronize()
        out, dq, lse_p = got["out"], got["dq"], plain["lse"]
        errs = _flash_errs(got, plain)
        failures += [f"flash {name}: {b}" for b in _flash_violations(errs, dtype)]
        empty = torch.isinf(lse_p).transpose(1, 2)  # [B, Sq, H]
        n_empty = int(empty.sum())
        if n_empty and (out[empty].abs().max().item() != 0
                        or dq[empty].abs().max().item() != 0):
            failures.append(f"flash {name}: a row that sees no key is not zero")
        # pairs (query row, key) whose logit the function needs
        vis = fa._visible(Sq, Skv, causal, "cuda")
        pairs = int((vis[None] & keep[:, None, :]).sum()) * H
        es = q.element_size()
        qo = B * Sq * H * D * es
        kv = B * Skv * Hkv * D * es
        stats = B * H * Sq * 4
        kb_bytes = 0 if kb is None else B * Skv * 4
        shapes = dict(B=B, Sq=Sq, Skv=Skv, H=H, Hkv=Hkv, D=D, causal=causal,
                      key_bias=bias, dtype=dtype, pairs=pairs,
                      rows_without_keys=n_empty)
        heavy = pairs * D > 1e10
        reps, inner = (5, 3) if heavy else (10, 10)
        # kernel: (call, plain call, bytes, operations, outputs compared)
        rows = {
            "fwd": (lambda: fa.flash_fwd(q, k, v, causal, scale, kb),
                    lambda: fa.flash_fwd_plain(q, k, v, causal, scale, kb),
                    2 * qo + 2 * kv + stats + kb_bytes, 4 * pairs * D,
                    ("out", "lse")),
            "dq": (lambda: fa.flash_bwd_dq(q, k, v, kb, dout, lse_p, delta,
                                           causal, scale),
                   lambda: fa.flash_bwd_dq_plain(q, k, v, kb, dout, lse_p,
                                                 delta, causal, scale),
                   3 * qo + 2 * kv + 2 * stats + kb_bytes, 6 * pairs * D,
                   ("dq",)),
            "dkv": (lambda: fa.flash_bwd_dkv(q, k, v, kb, dout, lse_p, delta,
                                             causal, scale),
                    lambda: fa.flash_bwd_dkv_plain(q, k, v, kb, dout, lse_p,
                                                   delta, causal, scale),
                    2 * qo + 2 * kv + 2 * stats + kb_bytes
                    + 2 * B * Skv * H * D * 4, 8 * pairs * D, ("dk", "dv")),
        }
        lib = {}
        if name == "path":
            lib = lib_path = library_sdpa(torch, q, k, v, dout, causal)
        for kernel, (fn_k, fn_p, nbytes, ops, outs) in rows.items():
            bnd, by = bound_ms(nbytes, ops, dtype)
            err = max(errs[o][0] if o != "lse" else errs[o] for o in outs)
            row = dict(kernel=kernel, case=name, **shapes, max_abs_err=err,
                       row_rel_err=max(errs[o][1] for o in outs if o != "lse"),
                       frobenius_rel_err=max(errs[o][2] for o in outs
                                             if o != "lse"),
                       tol=FLASH_TOL[dtype], frobenius_tol=FLASH_FROB_TOL[dtype],
                       ms=time_ms(fn_k, reps=reps, inner=inner),
                       eager_ms=eager_ms(fn_k, reps=reps, inner=inner),
                       plain_ms=time_ms(fn_p, reps=3, inner=2),
                       bound_ms=bnd, bound_by=by,
                       library_ms=lib.get(kernel))
            say(card, "flash_attention " + json.dumps(row))
            worst[kernel] = max(worst[kernel], err)
            if name == "path":
                main[kernel] = row
        del q, k, v, dout, got, plain, out, dq
        torch.cuda.empty_cache()
    say(card, "flash_attention library_ms: torch scaled_dot_product_attention"
              "(is_causal=True) forward; its backward through autograd (device "
              "time, forward and backward in one CUDA graph less the forward), "
              "one figure for dq and dk/dv together, listed under both; the "
              "path's backward measured three times: "
              + json.dumps(lib_path["bwd_runs"]))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst, "main": main}


def library_sdpa(torch, q, k, v, dout, causal):
    """Yardstick device times of PyTorch's own attention on the same inputs
    (never called by the port), CUDA-graph replays as for the kernels: the
    forward, and the backward through autograd as the time of forward and
    backward captured together less the forward's. The backward is measured
    three times; the median is the yardstick, `bwd_runs` the spread."""
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v))
    dh = dout.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention

    def fwd_bwd():
        return torch.autograd.grad(sdpa(qh, kh, vh, is_causal=causal),
                                   (qh, kh, vh), dh)

    fwd = time_ms(lambda: sdpa(qh, kh, vh, is_causal=causal), reps=5, inner=5)
    bwd = sorted(time_ms(fwd_bwd, reps=5, inner=5) - fwd for _ in range(3))
    return {"fwd": fwd, "dq": bwd[1], "dkv": bwd[1], "bwd_runs": bwd}


# Faults planted in copies of csrc/flash_attention.cu (phase 2b), name:
# (the kernel's signature, the text replaced in it, the replacement). They
# follow the tensor-core kernels' code: a change there that moves the
# replaced text must move these with it.
KERNEL_FAULTS = {
    "fwd: q tiles past the first skip their last kv tile": (
        "flash_fwd_tc_kernel(", "t < n_kv;", "t < n_kv - (q0 > 0);"),
    "fwd: rows past the first q tile normalised 1% off": (
        "flash_fwd_tc_kernel(", "1.f / l;", "1.f / (l * (q0 > 0 ? 1.01f : 1.f));"),
    "dq: q tiles past the first skip their last kv tile": (
        "flash_dq_tc_kernel(", "t < n_kv;", "t < n_kv - (q0 > 0);"),
    "dk/dv: the last q tile skipped": (
        "flash_dkv_tc_kernel(", "t < n_q;", "t < n_q - 1;"),
}


def planted_kernel_faults(card, torch):
    """The flash limits must fail faulty kernels: for each fault of
    KERNEL_FAULTS, the kernels are built again from a copy of csrc/ (in a
    temporary directory, all builds in parallel) with the fault planted,
    and held at the flash path's shape against the plain versions with
    check_flash's limits."""
    import pathlib
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import flash_attention as fa

    B, S, _, H, Hkv, D, causal, bias, dtype = FLASH_CASES["path"]
    sound = _build.load_library()
    passed = []
    with tempfile.TemporaryDirectory() as tmp:
        csrcs = {}
        for i, (fault, (kernel, old, new)) in enumerate(KERNEL_FAULTS.items()):
            csrc = pathlib.Path(tmp) / str(i) / "csrc"
            shutil.copytree(_build.CSRC, csrc)
            src = csrc / "flash_attention.cu"
            text = src.read_text()
            at = text.index(old, text.index(kernel))
            src.write_text(text[:at] + new + text[at + len(old):])
            csrcs[fault] = csrc
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(csrcs)) as pool:
            libs = dict(zip(csrcs, pool.map(
                lambda c: _build.build_library(c, c.parent / "build"),
                csrcs.values())))
        say(card, f"planted kernel faults: {len(libs)} builds in "
                  f"{time.perf_counter() - t0:.2f} s")
        try:
            for fault, lib in libs.items():
                # the wrappers launch from the library load_library() holds
                _build._LIB = _build.open_library(lib)
                gen = torch.Generator(device="cuda").manual_seed(3)
                q, k, v, dout, kb, _ = _flash_inputs(torch, gen, B, S, S, H,
                                                     Hkv, D, bias, dtype)
                got, plain, _ = _flash_outputs(fa, q, k, v, dout, kb, causal,
                                               D ** -0.5)
                bad = _flash_violations(_flash_errs(got, plain), dtype)
                say(card, "planted kernel fault " + json.dumps(
                    {"fault": fault, "failed": bool(bad), "violations": bad}))
                if not bad:
                    passed.append(fault)
                del q, k, v, dout, got, plain
        finally:
            _build._LIB = sound
    if passed:
        raise AssertionError(f"the flash limits pass faulty kernels: {passed}")


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


# --------------------------------------------------------------------------- #
# phase 5: train gpt3_1p3b
# --------------------------------------------------------------------------- #

PEAK_BF16 = PEAK_OPS["bfloat16"]


def decoder_flops(cfg, batch, seq):
    """bench.py `_decoder_flops`: 6ND for forward and backward plus the
    attention term 12*L*h*seq per token, N = the non-embedding weights of
    `GPTConfig.num_params(include_embeddings=False)` plus the tied
    vocab x hidden table."""
    h, L, V = cfg.hidden_size, cfg.num_layers, cfg.vocab_size
    d = cfg.head_dim
    attn = h * (cfg.num_heads * d) + 2 * h * (cfg.kv_heads * d) + (cfg.num_heads * d) * h
    mlp = 2 * h * cfg.ffn_size
    n_params = L * (attn + mlp + 2 * h) + h + V * h
    tokens = batch * seq
    return 6.0 * n_params * tokens + 12.0 * L * h * seq * tokens


def _counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn

    return {"flash_fwd": fa.FWD_LAUNCHES, "flash_bwd_dq": fa.DQ_LAUNCHES,
            "flash_bwd_dkv": fa.DKV_LAUNCHES, "fused_norm": fn.LAUNCHES,
            "fused_norm_dx": fn.DX_LAUNCHES}


def _zero_counters():
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn

    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fn.LAUNCHES = fn.DX_LAUNCHES = 0


def _train_setup(torch, cfg, device, dtype, seed, recipe):
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=seed)
    if recipe:
        amp.decorate(model, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16" if recipe else None)
    step = DistributedTrainStep(model, lambda lg, lb: crit(lg, lb), opt,
                                mesh=None, amp_level="O2" if recipe else None,
                                amp_dtype="bfloat16")
    return model, crit, step


def train(card, torch):
    from paddle_tpu_torch.models import gpt3_1p3b

    cfg = gpt3_1p3b(max_position_embeddings=2048, use_recompute=True)
    B, S, timed = 4, 2048, 3
    t0 = time.perf_counter()
    model, _, step = _train_setup(torch, cfg, "cuda", torch.float32, 0, True)
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device="cuda")
    torch.cuda.synchronize()
    say(card, f"train: gpt3_1p3b, {n_params} parameters "
              f"({sorted({str(p.dtype) for p in named.values()})}), built in "
              f"{time.perf_counter() - t0:.3f} s")

    # warm-up step: every parameter must change, and the gradient must
    # reach the bottom of the graph (the token embedding, layer 0's norm)
    before = {k: p.detach().clone() for k, p in named.items()}
    watch = ("gpt.embed_tokens.weight", "gpt.layers.0.input_layernorm.weight")
    seen = {}
    hooks = [named[k].register_post_accumulate_grad_hook(
        lambda t, k=k: seen.__setitem__(k, t.grad.float().norm().item()))
        for k in watch]
    t0 = time.perf_counter()
    loss0 = step(ids, labels).item()
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    for h in hooks:
        h.remove()
    unchanged = [k for k, p in named.items() if torch.equal(p.detach(), before[k])]
    del before
    if unchanged:
        raise AssertionError(f"train: parameters unchanged by step 1: {unchanged}")
    if sorted(seen) != sorted(watch) or not all(
            math.isfinite(g) and g > 0 for g in seen.values()):
        raise AssertionError(f"train: gradient norms at the bottom {seen}")

    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ids, labels) for _ in range(timed)]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _counters()
    L = cfg.num_layers
    per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                "fused_norm": (2 * L + 1) + 2 * L, "fused_norm_dx": 2 * L + 1}
    want = {k: v * timed for k, v in per_step.items()}
    losses = [loss0] + [l.item() for l in losses]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    if launches != want:
        raise AssertionError(f"train: kernel launches {launches} over {timed} "
                             f"steps, expected {want}")
    step_s = total_s / timed
    flops = decoder_flops(cfg, B, S)
    line = {
        "model": "gpt3_1p3b", "recipe": "O2 bf16 params (LayerNorm f32), "
        "AdamW bf16 moments, per-layer recompute", "batch": B, "seq": S,
        "parameters": n_params, "losses": losses, "warmup_step_s": warm_s,
        "timed_steps": timed, "step_s": step_s, "tokens_per_s": B * S / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / PEAK_BF16,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "grad_norm_at_bottom": seen, "launches": launches,
        "launches_per_step": per_step,
    }
    say(card, "train (smoke run, not a benchmark) " + json.dumps(line))
    profile_step(card, torch, lambda: step(ids, labels), "train step")
    del step, model, named
    torch.cuda.empty_cache()
    return launches


def profile_step(card, torch, fn, what):
    """torch.profiler over one call of `fn`: wall time, device-busy time
    (the sum of device activity; one stream, so nothing overlaps) and the
    kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]
    say(card, f"{what} profile " + json.dumps({
        "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall if wall > 0 else None,
        "top_device_kernels": [
            {"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
             "calls": e.count} for e in top]}))


# --------------------------------------------------------------------------- #
# phase 6: the training step on the card (kernels) and on the CPU (plain)
# --------------------------------------------------------------------------- #


def train_hold(card, torch):
    from paddle_tpu_torch.models import gpt3_1p3b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(gpt3_1p3b(use_recompute=True), num_layers=2)
    B, S, steps = 2, 256, 3
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    results = {}
    state = None
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model, crit, step = _train_setup(torch, cfg, dev, torch.float32, 2, False)
        if state is None:
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        ids_t = torch.as_tensor(ids, device=dev)
        labels_t = torch.as_tensor(labels, device=dev)
        crit(model(ids_t), labels_t).backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        losses = [step(ids_t, labels_t).item() for _ in range(steps)]
        results[dev] = (losses, grads, time.perf_counter() - t0)
    (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = results["cuda"], results["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    grad_rel = {k: (g_gpu[k] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-3 * gmax)
                for k, g in g_cpu.items()}
    worst = max(grad_rel, key=grad_rel.get)
    say(card, "train hold " + json.dumps({
        "model": "gpt3_1p3b width, 2 layers, recompute", "dtype": "float32",
        "batch": B, "seq": S, "losses_cuda": l_gpu, "losses_cpu": l_cpu,
        "max_loss_rel_diff": loss_rel, "loss_rtol": TRAIN_HOLD_LOSS_RTOL,
        "max_grad_rel_diff": grad_rel[worst], "worst_grad": worst,
        "grad_tol": TRAIN_HOLD_GRAD_TOL, "seconds_cuda": s_gpu,
        "seconds_cpu": s_cpu}))
    if not (loss_rel <= TRAIN_HOLD_LOSS_RTOL
            and grad_rel[worst] <= TRAIN_HOLD_GRAD_TOL):
        raise AssertionError("train hold: the card's training step disagrees "
                             "with the CPU's")


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
    say(card, "ptxas " + json.dumps(ptxas_summary(_build.BUILD_LOG)))

    norm = check_norm(card, torch)
    norm_dx = check_norm_dx(card, torch)
    decode = check_decode(card, torch)
    flash = check_flash(card, torch)
    planted_kernel_faults(card, torch)
    serve_launches = serve(card, torch)
    hold(card, torch)
    train_launches = train(card, torch)
    train_hold(card, torch)

    # launches: each kernel's count over the paths that run it, each path
    # driven with the counters zeroed just before and read just after
    launches = {
        "fused_norm": serve_launches["fused_norm"] + train_launches["fused_norm"],
        "paged_decode_attention": serve_launches["paged_decode_attention"],
        **{k: train_launches[k] for k in ("fused_norm_dx", "flash_fwd",
                                          "flash_bwd_dq", "flash_bwd_dkv")}}
    fa_src = "paddle_tpu_torch/csrc/flash_attention.cu"
    fa_ref = "paddle_tpu/ops/pallas/flash_attention.py"
    kernels = []
    for name, src, replaces, main_row, err in (
            ("fused_norm", "paddle_tpu_torch/csrc/fused_norm.cu",
             "paddle_tpu/ops/pallas/fused_norm.py:107", norm["main"], norm["worst"]),
            ("paged_decode_attention", "paddle_tpu_torch/csrc/decode_attention.cu",
             "paddle_tpu/ops/pallas/decode_attention.py:50", decode["main"],
             decode["worst"]),
            ("fused_norm_dx", "paddle_tpu_torch/csrc/fused_norm.cu",
             "paddle_tpu/ops/pallas/fused_norm.py:196", norm_dx["main"],
             norm_dx["worst"]),
            ("flash_fwd", fa_src, fa_ref + ":127", flash["main"]["fwd"],
             flash["worst"]["fwd"]),
            ("flash_bwd_dq", fa_src, fa_ref + ":332", flash["main"]["dq"],
             flash["worst"]["dq"]),
            ("flash_bwd_dkv", fa_src, fa_ref + ":406", flash["main"]["dkv"],
             flash["worst"]["dkv"])):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
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
