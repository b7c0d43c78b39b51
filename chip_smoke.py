#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases; any failure raises and the script exits non-zero:

1. build      — compile paddle_tpu_torch/csrc/*.cu with nvcc (sm_90a, one
                process per source, in parallel), load it. The Hopper
                kernels' instantiations, one line each for the bf16
                attention forward (flash, flashmask and varlen at head dims
                64 and 128), the bf16 backward (dQ and dK/dV of flash,
                flashmask and varlen at 64 and 128) and the bf16 grouped GEMM
                (weights read as they are and transposed): registers and
                spills from ptxas, wgmma (HGMMA) and TMA-load (UTMALDG)
                instructions from `cuobjdump -sass`; none may spill or
                lack either. The fused RoPE's twelve instantiations
                (`fused_rope ptxas`) and the norm dx's eighteen
                (`fused_norm_dx ptxas`): registers and spills; none may
                spill.
2. kernels    — each hand-written kernel against its plain PyTorch version
                on the card, at the shapes its path gives it and a few edge
                shapes, in float32 and bfloat16: max error against a stated
                tolerance, device time (CUDA graph replays timed by CUDA
                events, warm L2; the paged decodes also on a cold L2,
                round-robin over copies of the case) and eager
                back-to-back time, the plain
                version's time, the least time the card could take (bound),
                and the time of one PyTorch library call computing the same
                function where there is one. Fused norm forward (the
                serving rows, the three training steps' f32 rows, rows at a
                mean of 1000, an odd width, a row past the register
                design's 8192 elements) and dx (also at the three training
                steps' f32 rows, with the dweight/dbias reductions beside
                them timed, rows at a mean of 1000, a view off the 16-byte
                line and a row past 8192 elements; each case's route),
                paged decode attention (full precision and int8 pages, with
                g = 4, a zero-length row, -1 table entries, a live chunk of
                -1 pages, a page whose scales are 0, a serving tick's
                one-page rows at gpt3_1p3b's and llama_7b's heads, one
                512-token row; each case called twice, bit for bit, the
                arrival counters left at zero), dense-cache decode
                attention split over the
                sequence (the MMHA shape, g = 4, a short odd cache with a
                zero-length row), flash attention forward, dq and dk/dv (the
                path's shape; S off the forward's 128-row tiles, D 64, 40,
                96 and 36 (the copy route), g = 4, a key bias, Sq > Skv
                and Skv > Sq, a fused qkv's strided views and unaligned
                views (the copy route)), then
                flash_attention_fwd(...).backward(dO) through autograd at
                the path's shape and at GQA 32/8 against the plain
                functions (dQ, and dK, dV of the kv heads), the
                flash forward at the dense engine's decode shape (Sq = 1),
                fused RoPE (forward and backward, neox and interleaved,
                q + k at 32/8 heads in bf16, f32 and f16, the decode and
                prefill shapes with a table per row, a ragged S, and the
                scalar route at D 36 and on a view at an odd 2-byte
                offset; each case's route, grid and share of its bound
                printed), flashmask forward, dq and dk/dv (the LLaMA
                step's trivial causal index at B 4 x 2048 with 32/8 heads,
                and document masks: causal n = 1 and n = 2, non-causal
                n = 2 and n = 4 (n = 2 and rows that keep no key in bf16
                and f32), a mask per head, GQA, S not a multiple of 64 or
                128, rows that keep no key; the backward kernels read the
                tile classes the forward derives), then the path's
                flashmask_attention_fwd(...).backward(dO) through autograd
                against the plain functions (dQ, and dK, dV of the kv
                heads), the grouped GEMM (the gpt3_moe
                rung's four products with the group sizes of a real
                routing, bf16 and f32; groups with no and all live rows,
                partly live tiles, strides 16 and 48, K and N off the tile,
                dlhs against transposed weights) and varlen forward, dq
                and dk/dv (a pack of 8192 tokens in 8 causal documents at
                32/8 heads of 128; non-causal at T = 1000 in f32, causal
                cross attention with q lengths != k lengths, an empty k
                segment in f32 and in bf16, a one-tile pack; the backward
                kernels read the tile classes the forward derives, and the
                keys whose document starts in the second 64 of a 128-key
                dK/dV tile are held on their own).
2b. faults    — the kernels built again from copies of csrc/, each with
                one planted fault (a kv or q tile skipped, long rows
                normalised 1% off; the flash backward's q steps without
                the bottom-right offset, and its dK/dV adding the key bias
                on partial tiles only; flashmask: a partial tile of the
                forward treated as full, the end bound of n = 2
                ignored, partly kept tiles of the f32 kernels skipped,
                every head reading mask head 0, and in the bf16 backward
                a q tile's last kv tile skipped in dQ, a partial tile
                treated as full and a kv head's group of query heads one
                short in dK/dV; varlen: each q tile's first kv tile skipped
                (f32), the segment test's upper bound dropped, in the sm90
                kernels a partial tile read as full and the forward's and
                dQ's loop one kv tile short, the tile classes' last kv tile
                full past Tk, and in the sm90 dK/dV a CTA's q steps ending
                at its first 64 keys' range and each key tile's first q
                step one step late; norm forward:
                the cross-warp sum without the group's last warp, the
                scalar tail skipped; norm dx: the paired exchange without
                the group's last warp, the prefetched row's dy taken from
                the current row, the scalar tail skipped; grouped GEMM: a
                partly
                live 64-row unit treated as dead, a tile's second unit
                taking the first one's liveness; dense decode: the combine
                without a chunk's rescale, a chunk's tokens counted to
                S_max instead of the length; paged decode: the combine
                without a chunk's rescale, a live chunk of -1 pages exiting
                without arriving, the last chunk leaving its arrival
                counter set, int8 probabilities taking the chunk's first
                page's v_scale; RoPE: the neox second half read one vector
                late, the table row taken as 0 with a table per row, the
                head chunk's start off by one where it crosses from q into
                k): at its case every one must
                fail the limits of phase 2. Only the sources a fault
                touches are compiled again.
2c. clocks    — the varlen dQ and dK/dV at the path's shape rebuilt with
                a time stamp at each CTA's start and end: the SMs' busy
                share, the idle tail, and the durations replayed in launch
                order and longest first; dK/dV in its order by class count
                and in key-tile order.
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
                tolerance and identical tokens; model.generate on the card
                gives the card engine's tokens.
4b. serve-quant — bench.py's serving_quant A/B on gpt3_1p3b bf16: 64
                requests of the mix, 32 new tokens, B 16, S 512, page size
                32, an equal KV budget of (B*S)/(2*ps) bf16 pages. Leg A bf16
                pages, leg B kv_quant + serve_w8; each leg launches only its
                own paged decode kernel, ticks x 24 times, and the norm
                kernel (requests + ticks) x 49 times; leg B holds >= 1.9x
                the pages and no less peak concurrency. A profile of leg B's
                decode tick.
4c. dense     — the 12-request mix through create_serving_engine(paged=
                False): flash forward at Sq = 1 ticks x 24, norm (requests
                + ticks) x 49; model.generate on one greedy prompt, fed the
                engine's tokens, ranks each first or within a bf16 tie
                (BF16_TIE_ULPS) at every step; a profile of the dense
                decode tick.
4d. mmha      — 32 steps of incubate masked_multihead_attention at B 16,
                16 heads of 128, S_max 2048: the dense-cache kernel pair
                (split and combine, one launch of the wrapper) exactly 32
                times, every step within tolerance of the plain version.
4e. quant hold — phase 4 with kv_quant and serve_w8: tokens identical,
                logits within tolerance, int8 payloads within 1.
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
6b. train sharded — phase 5's step through distributed.DistributedTrainStep
                on a 1-rank NCCL group (init_parallel_env, rendezvous at
                127.0.0.1 on a free port; build_mesh(sharding=1)), sharding
                stage 3 with offload: parameters gathered by each block for
                the forward and again for the backward, gradients
                reduce-scattered into the shards, the AdamW states in
                pinned host memory between steps. The same weights and
                tokens as phase 5; each loss within TRAIN_SHARDED_RTOL of
                phase 5's, phase 5's launches per step, all-gathers and
                reduce-scatters counted in every step, every state pinned
                on the host after every step, and the peak device memory
                below phase 5's by at least OFFLOAD_PEAK_SHARE of the
                host-held bytes. Step time, tokens/s, MFU, the collective
                counts and torch.profiler over one step; the process group
                is destroyed at the end.
7. llama serve — llama_7b at full width and depth in bf16, random weights
                from a seed, through the paged engine (16 rows, 512 tokens,
                page size 32) over the 12-request mix: RoPE (prefills +
                ticks) x 32, paged decode ticks x 32, RMSNorm (prefills +
                ticks) x 65, no flash or flashmask launch; model.generate on
                one greedy prompt against the engine (the first decode
                step's logits within BF16_DECODE_LOGIT_RTOL, the tokens
                printed); a profile of five full-batch decode ticks; then
                llama_7b in f32 at full depth, where generate must give a
                one-row paged engine's tokens.
8. llama hold — llama_7b width at 2 layers in f32 (TF32 off): phase 4.
9. llama train — bench.py's llama_7bshape rung (hidden 4096, 3 layers, 32
                query heads over 8 kv heads, ffn 11008, flashmask attention
                with the trivial index) at batch 4 x 2048: f32 parameters
                and AdamW moments, AMP O2 bf16, sharding stage 2 on one
                device. As phase 5, with per step 3 flashmask forwards, 3
                dq, 3 dk/dv, 6 RoPE launches (3 forward, 3 backward), 7
                RMSNorm forwards and 7 dx, and no flash launch.
10. llama train hold — phase 6 at the llama_7bshape widths (2 layers,
                flashmask attention).
11. moe train — bench.py's gpt3_moe rung (run_moe_rung: 8 experts, GShard
                top-2 with random routing, width 1024, expert hidden 4096,
                4 attention-free layers, vocabulary 32000) at batch 8 x
                1024: f32 parameters and AdamW moments, AMP O2 bf16. As
                phase 5, with per step 16 grouped GEMMs (two a block
                forward, two dlhs), 4 LayerNorm forwards and 4 dx, and no
                attention launch; gradients must reach the embedding,
                every gate and every expert's w1 and w2.
12. moe train hold — phase 6 at the rung's widths (2 layers, random
                routing off on both sides).
13. varlen    — nn.functional.flash_attn_unpadded forward and backward at
                phase 2's main varlen case: one launch of each varlen
                kernel, output and q/k/v gradients within phase 2's limits
                of the plain path on the card; then the same tokens through
                flash_attn_varlen_qkvpacked(varlen_padded=False). Each
                entry's forward and forward + backward are timed eagerly.

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
# llama_7b in bf16: `generate` (f32 dense caches, decode through the flash
# kernel at Sq = 1, which rounds P to bf16 before P V) against the paged
# engine (bf16 pages, the paged decode kernel, P in f32 as in the JAX
# kernel) at the first decode step of one prompt: the same function
# rounded differently. bf16 rounds each op to 2^-9 relative; over 32 layers
# of ~8 rounded ops the hidden state drifts by ~sqrt(256) x 2^-9 ~ 3% in
# the worst case, so the row's logits are held to 10% of their norm, which
# a wrong layer, cache or page, or non-finite values, exceed. With random
# weights the logits barely depend on attention (on llama_tiny in bf16 the
# two paths differ by 0.6% and a decode query rotated at the wrong
# position by 0.9-1.2%), so RoPE positions are held where that shows: the
# CPU tests (f32, against the JAX package, to 1e-5) and the f32 holds.
# Greedy tokens are compared and printed, not held: with 32000 logits of
# spread ~1.3 rounded to bf16 (2^-5 at |x| ~ 4), the top two of a step are
# within that rounding often enough that the two paths may pick different
# tokens. The tokens are held in f32: at full depth in the serve phase and
# in the holds.
BF16_DECODE_LOGIT_RTOL = 0.1
# gpt3_1p3b in bf16: `generate` (batch 1, the prompt unpadded, f32 caches)
# against the dense engine (the prompt padded to a bucket, decode batched
# over the live rows): the same kernels per row, but cuBLAS products of
# other shapes, which round differently. generate's model is fed the
# engine's tokens (teacher forcing, through generate's own calls) and at
# every step the engine's token must be generate's greedy pick or lie
# within BF16_TIE_ULPS bf16 steps of its top logit (a tie in bf16). A
# wrong kernel moves logits by far more than a step.
BF16_TIE_ULPS = 2
# The same with int8 KV pages and int8 weights: the weights quantize
# identically on both sides (elementwise, IEEE division), but K/V rows
# that differ by rounding can land on either side of a quantizer's rounding
# boundary, moving one payload by 1 (one scale step, <= 1/127 of its page's
# abs-max); a few such moves shift a logit by far less than 1e-2.
QUANT_HOLD_LOGIT_TOL = 1e-2
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
# the sharded step (stage 3, offload, world size 1) against phase 5's step:
# the same bf16 arithmetic, its losses within a bf16 step's reach
TRAIN_SHARDED_RTOL = 2e-3
# the offloaded states must come off the card's peak, nearly all of them
OFFLOAD_PEAK_SHARE = 0.9
TRAIN_HOLD_GRAD_TOL = 1e-3
# RoPE kernel vs plain: both compute x_a c - x_b s and x_b c + x_a s in f32
# with one rounding per product and sum (the kernel uses no fused
# multiply-add) and round once to the tensor's dtype, so they should agree
# bit for bit; the limit allows one ulp at |x| < 8 (f32 5e-7, bf16 2^-5,
# f16 2^-8).
ROPE_TOL = {"float32": 1e-6, "bfloat16": 2 ** -5, "float16": 2 ** -8}


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0].strip()


def say(card, msg):
    print(f"[{card}] {msg}", flush=True)


def _graph_ms(calls, reps):
    """Device time of one call: `calls` captured into a CUDA graph in
    order, the graph replayed `reps` times between CUDA events; the median
    replay over the number of calls. The graph takes the host (Python,
    ctypes, launch latency) out of the number."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        calls[0]()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for fn in calls:
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
        times.append(start.elapsed_time(end) / len(calls))
    return float(np.median(times))


def time_ms(fn, reps=15, inner=20):
    """Device time of one call on a warm L2: `inner` calls of `fn` in a
    CUDA graph (`_graph_ms`)."""
    return _graph_ms([fn] * inner, reps)


# bytes read between two reads of one copy of a case's inputs in
# `time_ms_cold`: twice the H100's 50 MB L2
COLD_GAP_BYTES = 100e6


def time_ms_cold(fn, args, nbytes, reps=15, max_copies=256):
    """Device time of one call `fn(*args)` on a cold L2, as a serving tick
    finds a layer's pages (the weights stream through the L2 between two
    layers): the calls in a CUDA graph (`_graph_ms`) round-robin over n
    copies of `args` (tensors, tuples of tensors or None), n such that the
    other copies' calls move more than COLD_GAP_BYTES (`nbytes` a call)
    before a copy is read again. None if that needs more than `max_copies`
    copies."""
    n = int(COLD_GAP_BYTES // nbytes) + 2
    if n > max_copies:
        return None

    def clone(a):
        return a if a is None else (tuple(map(clone, a)) if isinstance(a, tuple)
                                    else a.clone())

    copies = [args] + [clone(args) for _ in range(n - 1)]
    calls = [lambda c=c: fn(*c) for c in copies]
    return _graph_ms(calls * max(1, -(-20 // n)), reps)


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


def ptxas_kernels(log, prefix, name_of=None):
    """Registers and spill-store bytes of each instantiation (its mangled
    template arguments kept) of the kernel named `prefix`, from nvcc's
    `-Xptxas -v` report (`log`, empty if this process did not build).
    `name_of`, if given, names an instantiation from its "Compiling entry
    function" line instead (None: not one of these kernels)."""
    out, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            m = None if name_of else re.search(rf"\d({prefix})(I\w*?E)?", ln)
            name = name_of(ln) if name_of else ("".join(m.groups("")) if m else None)
            if name:
                out[name] = {}
        elif name and "bytes spill stores" in ln:
            out[name]["spill_store_bytes"] = int(
                ln.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in ln and "registers" in ln:
            out[name]["registers"] = int(ln.split("Used")[1].split("registers")[0])
    return out


SM90_KERNEL = re.compile(
    r"(flash_(?:fwd|bwd_dq|bwd_dkv)_sm90_kernel)ILi(\d+)E.*?(CausalBias|FlashMask|Varlen)")
SM90_GG_KERNEL = re.compile(r"(gg_sm90_kernel)ILb([01])E")
# the Hopper kernels' instantiations chip_smoke.py expects: the bf16
# forward (csrc/flash_fwd_sm90.cuh) and the bf16 dQ and dK/dV
# (csrc/flash_bwd_sm90.cuh) of flash, flashmask and varlen, at head dims 64
# and 128, and the bf16 grouped GEMM
# (csrc/grouped_gemm_sm90.cuh) against [E, K, N] weights (false) and
# transposed [E, N, K] ones (true)
SM90_EXPECTED = {
    "forward": [f"flash_fwd_sm90_kernel<{d}, {m}>"
                for m in ("CausalBias", "FlashMask", "Varlen") for d in (64, 128)],
    "backward": [f"{k}<{d}, {m}>" for m in ("CausalBias", "FlashMask", "Varlen")
                 for k in ("flash_bwd_dq_sm90_kernel", "flash_bwd_dkv_sm90_kernel")
                 for d in (64, 128)],
    "grouped_gemm": [f"gg_sm90_kernel<{t}>" for t in ("false", "true")],
}


def sm90_report(card, lib_path, log):
    """The Hopper kernels' instantiations as built (SM90_EXPECTED): registers
    and spill-store bytes from nvcc's `-Xptxas -v` (`log`, empty if this
    process did not build), and the wgmma (HGMMA) and TMA-load (UTMALDG)
    instructions that `cuobjdump -sass` finds in each in the library. One
    line each for the attention forward, the attention backward and the
    grouped GEMM. Raises if an instantiation is missing, spills, or has no
    wgmma or no TMA load: it would not run on Hopper's tensor cores fed by
    TMA."""
    import shutil

    def name_of(ln):
        m = SM90_KERNEL.search(ln)
        if m:
            return f"{m[1]}<{m[2]}, {m[3]}>"
        m = SM90_GG_KERNEL.search(ln)
        return f"{m[1]}<{'true' if m[2] == '1' else 'false'}>" if m else None

    report, name = {}, None
    for ln in log.splitlines():
        if "Compiling entry function" in ln:
            name = name_of(ln)
            if name:
                report[name] = {}
        elif name and "bytes spill stores" in ln:
            report[name]["spill_store_bytes"] = int(
                ln.split("bytes spill stores")[0].split(",")[-1])
        elif name and "Used" in ln and "registers" in ln:
            report[name]["registers"] = int(
                ln.split("Used")[1].split("registers")[0])
    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    name = None
    for ln in sass.splitlines():
        if "Function :" in ln:
            name = name_of(ln)
            if name:
                report.setdefault(name, {}).update(HGMMA=0, UTMALDG=0)
        elif name:
            for op in ("HGMMA", "UTMALDG"):
                report[name][op] += op in ln
    bad = []
    for part, names in SM90_EXPECTED.items():
        say(card, f"sm90 {part} " + json.dumps({n: report.get(n) for n in names}))
        for n in names:
            r = report.get(n) or {}
            if not (r.get("HGMMA") and r.get("UTMALDG")) or r.get("spill_store_bytes"):
                bad.append(n)
    if bad:
        raise AssertionError(f"sm90 instantiations missing, spilling, or "
                             f"without wgmma or TMA loads: {bad}")
    return report


def bound_ms(nbytes, ops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


# --------------------------------------------------------------------------- #
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------- #


# (R, N, kind, dtypes, offset): rows of x = offset + N(0, 1). Decode rows
# and prefill rows at the 1.3B width, the training steps' rows under O2
# (f32, batch 4 x 2048: gpt3_1p3b's LayerNorm at 2048, llama_7bshape's
# RMSNorm at 4096, gpt3_moe's LayerNorm at 1024, and gpt3_1p3b's rows at
# a mean of 1000, which the two-pass centred variance exists for), the
# 13B width, an odd width (a scalar tail and rows off the 16-byte line),
# the RMSNorm form of the serving row, and a row wider than the register
# design's 8192 elements (the one-block-a-row kernel).
BOTH = ("float32", "bfloat16")
NORM_CASES = [(16, 2048, "ln", BOTH, 0.0), (512, 2048, "ln", BOTH, 0.0),
              (8192, 2048, "ln", BOTH, 0.0), (16, 5120, "ln", BOTH, 0.0),
              (37, 1031, "ln", BOTH, 0.0), (16, 2048, "rms", BOTH, 0.0),
              (8192, 4096, "rms", ("float32",), 0.0),
              (8192, 1024, "ln", ("float32",), 0.0),
              (8192, 2048, "ln", ("float32",), 1000.0),
              (64, 16384, "ln", BOTH, 0.0)]


def _norm_inputs(torch, gen, R, N, kind, dtype, offset=0.0):
    """(x, weight, bias or None) of a NORM_CASES case on the card."""
    dt = getattr(torch, dtype)
    x = torch.randn(R, N, device="cuda", generator=gen)
    x = (x + offset if offset else x).to(dt)
    w = (1 + 0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
    b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
    return x, w, (b if kind == "ln" else None)


def _norm_f64(torch, x, w, bias, kind, eps):
    """(out, rstd, mean or None) of the norm in float64 with the two-pass
    centred variance: a reference that shares no f32 sum with the kernel
    or with its plain version."""
    xd = x.double()
    mean = xd.mean(-1, keepdim=True) if kind == "ln" else None
    c = xd - mean if kind == "ln" else xd
    rstd = torch.rsqrt((c * c).mean(-1, keepdim=True) + eps)
    out = c * rstd * w.double()
    if bias is not None:
        out = out + bias.double()
    return out, rstd[:, 0], None if mean is None else mean[:, 0]


def _one_pass_f32(torch, x, w, bias, kind, eps):
    """The norm with the one-pass variance E[x^2] - E[x]^2 in f32: the form
    the two-pass centred variance exists to avoid, a control for rows at
    an offset."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True) if kind == "ln" else None
    m = mean if kind == "ln" else 0.0
    var = ((xf * xf).mean(-1, keepdim=True) - m * m).clamp_min(0)
    rstd = torch.rsqrt(var + eps)
    out = (xf - m) * rstd * w.float()
    if bias is not None:
        out = out + bias.float()
    return out, rstd[:, 0], None if mean is None else mean[:, 0]


def _f64_errors(got, ref):
    """(max |out err|, rstd err relative to its largest value, max |mean
    err| or 0) of a norm result against `_norm_f64`'s."""
    out, rstd, mean = got
    out_r, rstd_r, mean_r = ref
    err = (out.double() - out_r).abs().max().item()
    rstd_err = ((rstd.double() - rstd_r).abs().max()
                / rstd_r.abs().max()).item()
    mean_err = 0.0 if mean is None else (mean.double() - mean_r).abs().max().item()
    return err, rstd_err, mean_err


def _norm_errors(fn, torch, x, w, bias, kind, dtype, offset=0.0):
    """(max |out err|, stats err, violations, what else the row reports) of
    the forward kernel. Centred rows against its plain version: the output
    to NORM_TOL, rstd to 1e-5 of its largest value, the mean to 1e-5. Rows
    at an offset (a mean of 1000) against float64 (`_norm_f64`): the
    output to NORM_TOL, rstd to 1e-5 of its largest value and the mean to
    one f32 ulp of its largest value, the closest an f32 mean can come;
    the plain version (an f32 sum) and a one-pass variance
    (`_one_pass_f32`) are read beside it as controls, and the one-pass
    control must fail those limits, or the case would not tell the two
    variances apart."""
    got = fn.norm_fwd(x, w, bias, kind, 1e-5)
    out, rstd, mean = got
    if not offset:
        ref, rstd_ref, mean_ref = fn.norm_fwd_plain(x, w, bias, kind, 1e-5)
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        err_stats = (rstd - rstd_ref).abs().max().item() / rstd_ref.abs().max().item()
        if kind == "ln":
            err_stats = max(err_stats, (mean - mean_ref).abs().max().item())
        bad = []
        if not (err <= NORM_TOL[dtype] and err_stats <= 1e-5):
            bad.append(f"fused_norm {kind} {dtype} [{x.shape[0]},{x.shape[1]}]: "
                       f"max|out err| {err} (tol {NORM_TOL[dtype]}), stats err "
                       f"{err_stats} (tol 1e-5)")
        return err, err_stats, bad, {}
    ref = _norm_f64(torch, x, w, bias, kind, 1e-5)
    top = ref[2].abs().max().item() if kind == "ln" else 0.0
    mean_tol = max(1e-5, 2.0 ** (math.floor(math.log2(top)) - 23) if top else 0.0)

    def held(result):
        err, rstd_err, mean_err = _f64_errors(result, ref)
        return {"max_abs_err": err, "rstd_err": rstd_err, "mean_err": mean_err,
                "ok": err <= NORM_TOL[dtype] and rstd_err <= 1e-5
                and mean_err <= mean_tol}

    kernel = held(got)
    controls = {"plain_f32": held(fn.norm_fwd_plain(x, w, bias, kind, 1e-5)),
                "one_pass_f32": held(_one_pass_f32(torch, x, w, bias, kind,
                                                   1e-5))}
    name = f"fused_norm {kind} {dtype} [{x.shape[0]},{x.shape[1]}] at {offset}"
    bad = []
    if not kernel["ok"]:
        bad.append(f"{name}: against float64 {kernel} (tol out "
                   f"{NORM_TOL[dtype]}, rstd 1e-5, mean {mean_tol})")
    if controls["one_pass_f32"]["ok"]:
        bad.append(f"{name}: the one-pass variance passes too")
    return (kernel["max_abs_err"], max(kernel["rstd_err"], kernel["mean_err"]),
            bad, {"held_to": "float64", "rstd_err": kernel["rstd_err"],
                  "mean_err": kernel["mean_err"], "mean_tol": mean_tol,
                  "controls": controls})


def check_norm(card, torch):
    """The forward kernel against its plain version over NORM_CASES. Bound:
    bytes, x read and the output written once, the weight, bias and stats.
    Library: F.layer_norm (LayerNorm), F.rms_norm where this PyTorch has
    it (RMSNorm)."""
    from paddle_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(0)
    worst = 0.0
    main, training, failures = None, [], []
    F = torch.nn.functional
    for dtype in BOTH:
        for R, N, kind, dtypes, offset in NORM_CASES:
            if dtype not in dtypes:
                continue
            x, w, bias = _norm_inputs(torch, gen, R, N, kind, dtype, offset)
            err, err_stats, bad, extra = _norm_errors(
                fn, torch, x, w, bias, kind, dtype, offset)
            failures += bad
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
                lib_ms = time_ms(lambda: F.layer_norm(x, (N,), w, bias, 1e-5))
            elif hasattr(F, "rms_norm"):
                lib_ms = time_ms(lambda: F.rms_norm(x, (N,), w, 1e-5))
            row = dict(kind=kind, dtype=dtype, R=R, N=N, offset=offset,
                       max_abs_err=err, stats_err=err_stats,
                       tol=NORM_TOL[dtype], ms=k_ms, eager_ms=k_eager,
                       plain_ms=p_ms, bound_ms=bnd, bound_by=by,
                       library_ms=lib_ms, **extra)
            say(card, "fused_norm " + json.dumps(row))
            if (R, N, kind, dtype) == (16, 2048, "ln", "bfloat16"):
                main = row
            if R == 8192 and dtype == "float32":
                training.append({k: row[k] for k in (
                    "kind", "N", "offset", "ms", "bound_ms", "library_ms")})
    say(card, "fused_norm training rows (f32 [8192, N], the steps' shapes) "
              + json.dumps(training))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst, "main": main}


# name: (B, H, Hkv, D, ps, P, lengths, holes, zero-scale page). The
# serving path: 16 rows, 16 heads of 128, page size 32, 512 tokens, ragged
# lengths with a zero-length row, a parked row (length 1, table all -1, by
# the holes) and -1 holes in the middle of rows' tables; GQA g = 4; D 64
# at page size 13; a page whose int8 scales are 0 (zero_scale_page_d64,
# the int8 route only); hole_chunk: a 300-token row whose pages 4-7 are all
# -1 (a whole bf16 chunk of holes) beside a parked row; tick_g1 and
# llama_tick_g1: a serving tick's rows (16-23 tokens, one page a row, and
# a zero-length row) at gpt3_1p3b's and llama_7b's heads; b1_512: one
# 512-token row; llama_path_g1: the path's rows at llama_7b's 32 heads,
# with a chunk of -1 pages in the 512-token row (the kernel's CTAs then
# take several chunks each).
DECODE_PATH_LENGTHS = [512, 1, 0, 33, 100, 255, 256, 257, 300, 31, 32, 64,
                       480, 129, 17, 200]
TICK_LENGTHS = [16, 17, 18, 19, 20, 21, 22, 23, 16, 17, 18, 19, 20, 21, 22, 0]
PAGED_CASES = {
    "path_g1": (16, 16, 16, 128, 32, 16, DECODE_PATH_LENGTHS,
                [(1, 0), (3, 0), (8, 4)], None),
    "gqa_g4": (16, 16, 4, 128, 32, 16, DECODE_PATH_LENGTHS, [(12, 7)], None),
    "gqa_g2_d64_ps13": (5, 8, 4, 64, 13, 10, [130, 1, 0, 77, 14], [(3, 2)],
                        None),
    "zero_scale_page_d64": (5, 8, 4, 64, 16, 10, [130, 1, 0, 77, 14], [(3, 2)],
                            (0, 3)),
    "hole_chunk": (4, 16, 16, 128, 32, 16, [300, 1, 0, 77],
                   [(0, 4), (0, 5), (0, 6), (0, 7), (1, 0)], None),
    "tick_g1": (16, 16, 16, 128, 32, 16, TICK_LENGTHS, [], None),
    "llama_tick_g1": (16, 32, 32, 128, 32, 16, TICK_LENGTHS, [], None),
    "b1_512": (1, 16, 16, 128, 32, 16, [512], [], None),
    "llama_path_g1": (16, 32, 32, 128, 32, 16, DECODE_PATH_LENGTHS,
                      [(1, 0), (3, 0), (8, 4), (0, 4), (0, 5)], None),
}
PAGED_FULL = ["path_g1", "gqa_g4", "gqa_g2_d64_ps13", "hole_chunk", "tick_g1",
              "llama_tick_g1", "b1_512", "llama_path_g1"]
PAGED_Q8 = ["path_g1", "gqa_g4", "zero_scale_page_d64", "hole_chunk",
            "tick_g1", "llama_tick_g1", "b1_512", "llama_path_g1"]


def _paged_inputs(torch, name, dtype, q8):
    """A PAGED_CASES case on the card, from a seed of its own: q, caches
    (int8: payloads in [-127, 127] and scales that put |K|, |V| up to ~3,
    the zero-scale page's set to 0), `scales` ((k_scale, v_scale) or
    None), block tables over the pages in a random order with the holes
    punched to -1, lengths; then the bytes the call must move (every valid
    token's K and V row, the int8 scales of each (page, head) read, q, out,
    tables, lengths) and the valid tokens."""
    B, H, Hkv, D, ps, P, lengths, holes, zero = PAGED_CASES[name]
    seed = 100 * list(PAGED_CASES).index(name) + 10 * (dtype == "bfloat16") + q8
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n_pages = B * P + 1
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(getattr(torch, dtype))
    scales = None
    if q8:
        kc, vc = (torch.randint(-127, 128, (n_pages, Hkv, ps, D), device="cuda",
                                generator=gen, dtype=torch.int8) for _ in range(2))
        scales = tuple(0.005 + 0.02 * torch.rand(n_pages, Hkv, device="cuda",
                                                 generator=gen) for _ in range(2))
    else:
        kc, vc = (torch.randn(n_pages, Hkv, ps, D, device="cuda",
                              generator=gen).to(q.dtype) for _ in range(2))
    perm = np.random.default_rng(seed).permutation(np.arange(1, n_pages))
    tables = np.full((B, P), -1, np.int32)
    nxt = 0
    for b, L in enumerate(lengths):
        for j in range(min(P, -(-L // ps))):
            tables[b, j] = perm[nxt]
            nxt += 1
    for b, j in holes:
        tables[b, j] = -1
    if q8 and zero is not None:
        for sc in scales:
            sc[int(tables[zero])] = 0.0
    read = [(b, j) for b, L in enumerate(lengths) for j in range(P)
            if tables[b, j] >= 0 and j * ps < L]
    valid = sum(min(ps, lengths[b] - j * ps) for b, j in read)
    nbytes = (2 * valid * Hkv * D * kc.element_size()
              + (2 * 4 * len(read) * Hkv if q8 else 0)
              + 2 * q.numel() * q.element_size() + tables.size * 4 + B * 4)
    return ((q, kc, vc, torch.tensor(tables, device="cuda"),
             torch.tensor(lengths, dtype=torch.int32, device="cuda"), scales),
            nbytes, valid)


def _paged_call(da, q, kc, vc, tables, lens, scales):
    return da.paged_decode_attention(q, kc, vc, tables, lens, kv_scales=scales)


def _paged_plain(da, q, kc, vc, tables, lens, scales):
    if scales is None:
        return da.paged_decode_attention_plain(q, kc, vc, tables, lens,
                                               q.shape[-1] ** -0.5)
    return da.paged_decode_attention_q8_plain(q, kc, vc, tables, lens,
                                              q.shape[-1] ** -0.5, *scales)


def _paged_violations(torch, da, args, dtype):
    """What breaks the limits of a paged case `args`: two back-to-back
    calls, then the plain version. A non-finite value, a row without a
    readable token (length 0, or every page -1) not exactly zero, max |err|
    over DECODE_TOL, the second call not bit for bit the first (the
    arrival counters not reset), counters left non-zero."""
    out, again = _paged_call(da, *args), _paged_call(da, *args)
    ref = _paged_plain(da, *args)
    torch.cuda.synchronize()
    tables = args[3]
    err = (out.float() - ref.float()).abs().max().item()
    bad = []
    if not torch.isfinite(out.float()).all():
        bad.append("non-finite output")
    zero_rows = [b for b in range(tables.shape[0]) if (tables[b] < 0).all()]
    if any(out[b].abs().max().item() != 0 for b in zero_rows):
        bad.append("a row without valid tokens is not zero")
    if not err <= DECODE_TOL[dtype]:
        bad.append(f"max|err| {err} (tol {DECODE_TOL[dtype]})")
    if not torch.equal(out.view(torch.uint8), again.view(torch.uint8)):
        bad.append("a second call is not bit for bit the first")
    if any(bool(c.any()) for c in da._ARRIVALS.values()):
        bad.append("arrival counters left non-zero")
    return bad, err


def _check_paged(card, torch, q8):
    """The paged decode kernel (q8: int8 pages, `kv_scales=`) against its
    plain version over its PAGED_CASES, q in bf16 (the path) and f32: the
    limits of `_paged_violations`, then times warm (graph replays) and on a
    cold L2 (`time_ms_cold`), eager, plain, and the bound. A time under
    the bound is printed as a finding: the L2 held the pages."""
    from paddle_tpu_torch.ops import decode_attention as da

    kind = "paged_decode_q8" if q8 else "paged_decode"
    worst, main = 0.0, None
    for dtype in ("bfloat16", "float32"):
        for name in PAGED_Q8 if q8 else PAGED_FULL:
            B, H, Hkv, D, ps, P = PAGED_CASES[name][:6]
            args, nbytes, valid = _paged_inputs(torch, name, dtype, q8)
            bad, err = _paged_violations(torch, da, args, dtype)
            if bad:
                raise AssertionError(f"{kind} {name} {dtype}: " + "; ".join(bad))
            worst = max(worst, err)
            bnd, by = bound_ms(nbytes, 4 * valid * H * D, dtype)
            row = dict(case=name, dtype=dtype, B=B, H=H, Hkv=Hkv, D=D, ps=ps,
                       pages_a_chunk=min(P, da.paged_chunk_pages(
                           ps, D, args[1].element_size())),
                       valid_tokens=valid, max_abs_err=err,
                       tol=DECODE_TOL[dtype],
                       ms=time_ms(lambda: _paged_call(da, *args)),
                       cold_ms=time_ms_cold(lambda *a: _paged_call(da, *a), args,
                                            nbytes),
                       eager_ms=eager_ms(lambda: _paged_call(da, *args)),
                       plain_ms=time_ms(lambda: _paged_plain(da, *args),
                                        reps=5, inner=3),
                       bound_ms=bnd, bound_by=by, library_ms=None)
            say(card, f"{kind} " + json.dumps(row))
            for t in ("ms", "cold_ms"):
                if row[t] is not None and row[t] < bnd:
                    say(card, f"{kind} finding: {name} {dtype} {t} {row[t]} "
                              f"under its bound {bnd} ms: the L2 held pages")
            if (name, dtype) == ("path_g1", "bfloat16"):
                main = row
            del args
    torch.cuda.empty_cache()
    say(card, f"{kind} library_ms: none; no single PyTorch call attends "
              + ("over int8 pages " if q8 else "") + "through a block table "
              "over a paged cache")
    return {"worst": worst, "main": main}


def check_decode(card, torch):
    """The full-precision paged decode kernel: `_check_paged`."""
    return _check_paged(card, torch, q8=False)


def check_decode_q8(card, torch):
    """The int8 paged decode kernel: `_check_paged`."""
    return _check_paged(card, torch, q8=True)


# name: (B, H, Hkv, D, S_max, lengths)
DENSE_CASES = {
    "mmha_g1": (16, 16, 16, 128, 2048, [int(x) for x in np.linspace(1, 2048, 16)]),
    "gqa_g4": (16, 16, 4, 128, 2048, [int(x) for x in np.linspace(1, 2048, 16)]),
    "odd_s_max_d64": (4, 8, 8, 64, 301, [0, 1, 300, 301]),
}


def _dense_inputs(torch, gen, name, dtype):
    """(q, kc, vc, lengths) of a DENSE_CASES case on the card."""
    B, H, Hkv, D, S, lengths = DENSE_CASES[name]
    dt = getattr(torch, dtype)
    q = torch.randn(B, H, D, device="cuda", generator=gen).to(dt)
    kc = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).to(dt)
    vc = torch.randn(B, Hkv, S, D, device="cuda", generator=gen).to(dt)
    return q, kc, vc, torch.tensor(lengths, dtype=torch.int32, device="cuda")


def _dense_violations(torch, name, dtype, out, ref):
    """What breaks the limits: max |err| over DECODE_TOL, a non-finite value,
    a zero-length row not exactly zero."""
    err = (out.float() - ref.float()).abs().max().item()
    zero_rows = [b for b, L in enumerate(DENSE_CASES[name][5]) if L == 0]
    bad = []
    if not torch.isfinite(out.float()).all():
        bad.append("non-finite output")
    if any(out[b].abs().max().item() != 0 for b in zero_rows):
        bad.append("a zero-length row is not zero")
    if not err <= DECODE_TOL[dtype]:
        bad.append(f"max|err| {err} (tol {DECODE_TOL[dtype]})")
    return bad, err


def check_dense_decode(card, torch):
    """The dense-cache decode kernels against their plain version at the
    MMHA shape (B 16, 16 heads of 128, S_max 2048, lengths from 1 to 2048),
    at GQA g = 4 and at a short odd cache with a zero-length row; bf16 (the
    path) and f32. The library yardstick is F.scaled_dot_product_attention
    over the same keys with a bool key mask, at g = 1."""
    from paddle_tpu_torch.ops import decode_attention as da

    gen = torch.Generator(device="cuda").manual_seed(5)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    worst, main = 0.0, None
    for dtype in ("bfloat16", "float32"):
        for name, (B, H, Hkv, D, S, lengths) in DENSE_CASES.items():
            q, kc, vc, lens = _dense_inputs(torch, gen, name, dtype)
            out = da.dense_decode_attention(q, kc, vc, lens)
            ref = da.dense_decode_attention_plain(q, kc, vc, lens, D ** -0.5)
            torch.cuda.synchronize()
            bad, err = _dense_violations(torch, name, dtype, out, ref)
            if bad:
                raise AssertionError(f"dense_decode {name} {dtype}: "
                                     + "; ".join(bad))
            worst = max(worst, err)
            valid = sum(min(L, S) for L in lengths)
            es = q.element_size()
            nbytes = 2 * valid * Hkv * D * es + 2 * q.numel() * es + B * 4
            bnd, by = bound_ms(nbytes, 4 * valid * H * D, dtype)
            lib = None
            if Hkv == H:
                keep = (torch.arange(S, device="cuda")[None, :]
                        < lens[:, None])[:, None, None, :]
                q4 = q[:, :, None, :]
                lib = time_ms(lambda: sdpa(q4, kc, vc, attn_mask=keep))
            call = lambda: da.dense_decode_attention(q, kc, vc, lens)  # noqa: E731
            row = dict(case=name, dtype=dtype, B=B, H=H, Hkv=Hkv, D=D, S_max=S,
                       chunk=da.dense_chunk(D, es, S),
                       valid_tokens=valid, max_abs_err=err,
                       tol=DECODE_TOL[dtype], ms=time_ms(call),
                       eager_ms=eager_ms(call),
                       plain_ms=time_ms(lambda: da.dense_decode_attention_plain(
                           q, kc, vc, lens, D ** -0.5), reps=5, inner=3),
                       bound_ms=bnd, bound_by=by, library_ms=lib)
            say(card, "dense_decode " + json.dumps(row))
            if (name, dtype) == ("mmha_g1", "bfloat16"):
                main = row
            del q, kc, vc, out, ref
    say(card, "dense_decode library_ms: F.scaled_dot_product_attention on "
              "[B, H, 1, D] against the cache with a bool key mask (g = 1)")
    return {"worst": worst, "main": main}


def check_flash_decode(card, torch):
    """The flash forward kernel at the dense engine's decode shape: B 16,
    Sq 1, Skv 512, 16 heads of 128, bf16, a key bias that keeps each row's
    first lengths[b] + 1 keys (a parked row keeps key 0 only), held with
    check_flash's limits. Library: F.scaled_dot_product_attention with the
    same keys as a bool mask."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(6)
    B, Skv, H, D = 16, 512, 16, 128
    lengths = [0] + [int(x) for x in np.linspace(10, 510, B - 1)]
    q = torch.randn(B, 1, H, D, device="cuda", generator=gen).bfloat16()
    k = torch.randn(B, Skv, H, D, device="cuda", generator=gen).bfloat16()
    v = torch.randn(B, Skv, H, D, device="cuda", generator=gen).bfloat16()
    keep = (torch.arange(Skv, device="cuda")[None, :]
            <= torch.tensor(lengths, device="cuda")[:, None])
    kb = torch.where(keep, 0.0, -1e30).float()
    scale = D ** -0.5
    out, lse = fa.flash_fwd(q, k, v, False, scale, kb)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, False, scale, kb)
    torch.cuda.synchronize()
    errs = _flash_errs({"out": out, "lse": lse}, {"out": out_p, "lse": lse_p})
    bad = _flash_violations(errs, "bfloat16")
    valid = int(keep.sum())
    es = q.element_size()
    nbytes = 2 * q.numel() * es + 2 * valid * H * D * es + B * H * 4 + B * Skv * 4
    bnd, by = bound_ms(nbytes, 4 * valid * H * D, "bfloat16")
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))
    mask = keep[:, None, None, :]
    sdpa = torch.nn.functional.scaled_dot_product_attention
    call = lambda: fa.flash_fwd(q, k, v, False, scale, kb)  # noqa: E731
    row = dict(case="dense_decode_sq1", B=B, Sq=1, Skv=Skv, H=H, D=D,
               dtype="bfloat16", key_bias=True, valid_keys=valid,
               max_abs_err=errs["out"][0], row_rel_err=errs["out"][1],
               frobenius_rel_err=errs["out"][2], lse_err=errs["lse"],
               tol=FLASH_TOL["bfloat16"], ms=time_ms(call),
               eager_ms=eager_ms(call),
               plain_ms=time_ms(lambda: fa.flash_fwd_plain(q, k, v, False,
                                                           scale, kb),
                                reps=5, inner=3),
               bound_ms=bnd, bound_by=by,
               library_ms=time_ms(lambda: sdpa(qh, kh, vh, attn_mask=mask)))
    say(card, "flash_attention " + json.dumps(row))
    if bad:
        raise AssertionError(f"flash_fwd at Sq = 1: {bad}")
    return row


# name: (B, S, heads, D, table rows, interleaved, dtype, offset): q and k
# at the LLaMA-7B-shape training step (B 4, S 2048, 32 and 8 heads of 128,
# per-row tables, as the model builds them from position_ids) in bf16 (the
# path), f32 and f16, interleaved pairs, the llama_7b decode tick (B 16,
# one token, 32 + 32 heads, a table per row) and prefill (B 1, S 192, as
# the engine calls it), a ragged S with three tensors and one shared
# table, and the scalar route: D 36 (D/2 not a multiple of a vector) and
# every tensor a contiguous view `offset` elements (2 bytes) off the
# 16-byte line.
ROPE_CASES = {
    "train_neox": (4, 2048, (32, 8), 128, 4, False, "bfloat16", 0),
    "train_neox_f32": (4, 2048, (32, 8), 128, 4, False, "float32", 0),
    "train_interleaved": (4, 2048, (32, 8), 128, 4, True, "bfloat16", 0),
    "decode_per_row": (16, 1, (32, 32), 128, 16, False, "bfloat16", 0),
    "ragged_s37_qkv_shared_d64": (3, 37, (8, 2, 2), 64, 1, True, "float32", 0),
    "prefill_per_row": (1, 192, (32, 32), 128, 1, False, "bfloat16", 0),
    "train_neox_f16": (4, 2048, (32, 8), 128, 4, False, "float16", 0),
    "d36_scalar": (2, 512, (16, 4), 36, 2, False, "bfloat16", 0),
    "odd_offset_scalar": (4, 512, (32, 8), 128, 4, False, "bfloat16", 1),
}
# elements past each tensor's end in `_rope_inputs`: a planted fault that
# reads one vector past a head reads memory of its case
ROPE_SPARE = 64


def _rope_inputs(torch, gen, name):
    """The case's tensors (each cut from a buffer `offset` elements in,
    ROPE_SPARE elements longer) and its tables."""
    B, S, heads, D, Bt, _, dtype, off = ROPE_CASES[name]
    dt = getattr(torch, dtype)
    xs = []
    for h in heads:
        n = B * S * h * D
        buf = (2 * torch.randn(n + off + ROPE_SPARE, device="cuda",
                               generator=gen)).to(dt)
        xs.append(buf[off:off + n].view(B, S, h, D))
    ang = 2048 * torch.rand(Bt, S, D // 2, device="cuda", generator=gen)
    return xs, torch.cos(ang), torch.sin(ang)


def _rope_errors(torch, fr, name, xs, c, s):
    """max |kernel - plain| over the forward and the backward (sin
    negated), NaN where the kernel wrote a non-finite value."""
    il = ROPE_CASES[name][5]
    err = 0.0
    for sign in (1.0, -1.0):
        got = fr.rope(xs, c, s, il, sin_sign=sign)
        ref = fr.rope_plain(xs, c, s, il, sin_sign=sign)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            d = (a.float() - b.float()).abs()
            err = max(err, d.max().item()) if torch.isfinite(d).all() else math.nan
    return err


def _rope_violations(torch, fr, name, xs, c, s):
    dtype = ROPE_CASES[name][6]
    err = _rope_errors(torch, fr, name, xs, c, s)
    return err, ([] if err <= ROPE_TOL[dtype] else
                 [f"fused_rope {name}: max|err| {err} (tol {ROPE_TOL[dtype]})"])


def check_rope(card, torch):
    """The fused-RoPE kernel against its plain version, forward and
    backward (sin negated), at ROPE_CASES; each case's route (16-byte
    vectors or scalar), its grid (`ops.fused_rope.rope_plan`), its bound
    and its share of it. The kernel and the plain version round alike, so
    max|err| should be 0 (`bit_exact`); ROPE_TOL is the limit. No single
    PyTorch call computes it: library_ms is null."""
    from paddle_tpu_torch.ops import fused_rope as fr

    gen = torch.Generator(device="cuda").manual_seed(8)
    worst, main, bad = 0.0, None, []
    for name, (B, S, heads, D, Bt, il, dtype, _) in ROPE_CASES.items():
        xs, c, s = _rope_inputs(torch, gen, name)
        err, why = _rope_violations(torch, fr, name, xs, c, s)
        bad += why
        worst = max(worst, err)
        es = xs[0].element_size()
        aligned = all(t.data_ptr() % 16 == 0 for t in (*xs, c, s))
        plan = fr.rope_plan(B, S, heads, D, es, aligned)
        pairs = sum(x.numel() for x in xs) // 2
        nbytes = 2 * 2 * pairs * es + 2 * c.numel() * 4
        bnd, by = bound_ms(nbytes, 6 * pairs, "float32")
        call = lambda: fr.rope(xs, c, s, il)  # noqa: E731
        ms = time_ms(call)
        row = dict(case=name, dtype=dtype, B=B, S=S, heads=list(heads), D=D,
                   table_rows=Bt, interleaved=il,
                   route="vector" if plan.vector > 1 else "scalar",
                   grid=list(plan.grid), block=list(plan.block),
                   heads_per_thread=plan.heads_per_thread,
                   max_abs_err=err, bit_exact=err == 0.0, tol=ROPE_TOL[dtype],
                   ms=ms, eager_ms=eager_ms(call),
                   plain_ms=time_ms(lambda: fr.rope_plain(xs, c, s, il),
                                    reps=5, inner=3),
                   bound_ms=bnd, bound_by=by, bound_share=bnd / ms,
                   library_ms=None)
        say(card, "fused_rope " + json.dumps(row))
        if name == "train_neox":
            main = row
        del xs
    say(card, "fused_rope library_ms: none; no single PyTorch call rotates "
              "q and k by position tables")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"worst": worst, "main": main}


ROPE_KERNEL = re.compile(r"rope_kernelI(f|6__half|13__nv_bfloat16)Li(\d+)ELb([01])E")
ROPE_TYPES = {"f": "float", "6__half": "half", "13__nv_bfloat16": "bf16"}


def _rope_name(ln):
    m = ROPE_KERNEL.search(ln)
    return m and (f"rope_kernel<{ROPE_TYPES[m[1]]}, {m[2]}, "
                  f"{'interleaved' if m[3] == '1' else 'neox'}>")


def rope_ptxas(card, log):
    """Registers and spill-store bytes of each `rope_kernel<T, V,
    interleaved>` instantiation, from nvcc's `-Xptxas -v` report (`log`,
    empty if this process did not build). Raises on a spill, or on a
    missing instantiation when the log holds the build."""
    report = ptxas_kernels(log, None, _rope_name)
    say(card, "fused_rope ptxas " + json.dumps(report))
    spills = [n for n, r in report.items() if r.get("spill_store_bytes")]
    if spills:
        raise AssertionError(f"fused_rope instantiations spill: {spills}")
    if log and len(report) != 12:
        raise AssertionError(f"fused_rope: {len(report)} instantiations "
                             f"built, 12 expected")
    return report


# The dx kernel's cases (R, N, kind, dtype, mean of x, shift). The steps'
# shapes under O2 (f32, batch 4 x 2048 or 8 x 1024): gpt3_1p3b's LayerNorm
# at 2048, then llama_7bshape's RMSNorm at 4096 and gpt3_moe's LayerNorm at
# 1024, after the smaller cases so those keep their inputs; then rows at a
# mean of 1000 (x - mean stays exact in f32: x and the mean lie within a
# factor of 2), x and dy as [R, N] views one element into their buffers
# (off the 16-byte line: the scalar route), and rows past 8192 elements
# (the wide route).
NORM_DX_CASES = [
    (8192, 2048, "ln", "float32", 0.5, 0), (8192, 2048, "ln", "bfloat16", 0.5, 0),
    (37, 1031, "ln", "float32", 0.5, 0), (37, 1031, "ln", "bfloat16", 0.5, 0),
    (512, 2048, "rms", "bfloat16", 0.5, 0), (16, 5120, "rms", "float32", 0.5, 0),
    (8192, 4096, "rms", "float32", 0.5, 0), (8192, 1024, "ln", "float32", 0.5, 0),
    (8192, 1024, "ln", "float32", 1000.0, 0), (8192, 2048, "ln", "float32", 0.5, 1),
    (64, 12288, "ln", "float32", 0.5, 0)]
# the three steps' shapes, where FusedNorm.backward's dweight/dbias
# reductions are timed beside dx (`wdb_ms`)
NORM_DX_STEPS = [(8192, 2048, "ln"), (8192, 4096, "rms"), (8192, 1024, "ln")]


def _norm_dx_inputs(torch, fn, gen, R, N, kind, dtype, mean=0.5, shift=0):
    """x (mean `mean`), w, b, dy of a dx case on the card, x and dy [R, N]
    views `shift` elements into their buffers; rstd and mean from the plain
    forward."""
    dt = getattr(torch, dtype)
    x = (torch.randn(R, N, device="cuda", generator=gen) + mean).to(dt)
    w = (1 + 0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
    b = (0.1 * torch.randn(N, device="cuda", generator=gen)).to(dt)
    dy = torch.randn(R, N, device="cuda", generator=gen).to(dt)
    if shift:
        def shifted(t):
            buf = torch.empty(R * N + shift, device="cuda", dtype=dt)
            return buf[shift:].view(R, N).copy_(t)

        x, dy = shifted(x), shifted(dy)
    _, rstd, mu = fn.norm_fwd_plain(x, w, b if kind == "ln" else None, kind,
                                    1e-5)
    return x, w, b, dy, rstd, mu


def _norm_dx_violations(fn, torch, x, w, dy, rstd, mu, kind, dtype):
    """(max |kernel - plain| of dx, the violations of NORM_DX_TOL), NaN
    where the kernel wrote a non-finite value."""
    dx = fn.norm_bwd_dx(x, w, dy, rstd, mu, kind)
    ref = fn.norm_bwd_dx_plain(x, w, dy, rstd, mu, kind)
    torch.cuda.synchronize()
    d = (dx.float() - ref.float()).abs()
    err = d.max().item() if torch.isfinite(d).all() else math.nan
    R, N = x.shape
    return err, ([] if err <= NORM_DX_TOL[dtype] else
                 [f"fused_norm_dx {kind} {dtype} [{R},{N}]: max|err| {err} "
                  f"(tol {NORM_DX_TOL[dtype]})"])


def check_norm_dx(card, torch):
    """The dx kernel against its plain version over NORM_DX_CASES, each
    with its route (`ops.fused_norm.dx_plan`). The main path's shape is f32
    [8192, 2048] (under O2 LayerNorm runs in f32, batch 4 x 2048). At the
    steps' shapes also `wdb_ms`: the dweight and dbias torch reductions of
    FusedNorm.backward, which run beside dx."""
    from paddle_tpu_torch.ops import fused_norm as fn

    gen = torch.Generator(device="cuda").manual_seed(2)
    worst = 0.0
    main, bad = None, []
    for R, N, kind, dtype, mean, shift in NORM_DX_CASES:
        x, w, b, dy, rstd, mu = _norm_dx_inputs(torch, fn, gen, R, N, kind,
                                                dtype, mean, shift)
        err, why = _norm_dx_violations(fn, torch, x, w, dy, rstd, mu, kind,
                                       dtype)
        bad += why
        worst = max(worst, err)
        es = x.element_size()
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, dy))
        nbytes = 3 * R * N * es + N * es + R * 4 * (2 if kind == "ln" else 1)
        bnd, by = bound_ms(nbytes, 10 * R * N, "float32")
        k_ms = time_ms(lambda: fn.norm_bwd_dx(x, w, dy, rstd, mu, kind))
        k_eager = eager_ms(lambda: fn.norm_bwd_dx(x, w, dy, rstd, mu, kind))
        p_ms = time_ms(lambda: fn.norm_bwd_dx_plain(x, w, dy, rstd, mu, kind),
                       reps=5, inner=5)
        rstd2 = rstd[:, None]
        if kind == "ln":
            lib_ms = time_ms(lambda: torch.ops.aten.native_layer_norm_backward(
                dy, x, [N], mu[:, None], rstd2, w, b, [True, False, False]))
        else:
            lib_ms = time_ms(lambda: torch.ops.aten._fused_rms_norm_backward(
                dy, x, [N], rstd2, w, [True, False]))
        row = dict(kind=kind, dtype=dtype, R=R, N=N, mean=mean, shift=shift,
                   route=fn.dx_plan(R, N, es, aligned).route,
                   max_abs_err=err, tol=NORM_DX_TOL[dtype], ms=k_ms,
                   eager_ms=k_eager, plain_ms=p_ms, bound_ms=bnd, bound_by=by,
                   bound_share=bnd / k_ms, library_ms=lib_ms)
        if (R, N, kind) in NORM_DX_STEPS and mean == 0.5 and not shift:
            def wdb():  # FusedNorm.backward's dweight and dbias lines
                x32 = x.float()
                if kind == "ln":
                    x32 = x32 - mu[:, None]
                (dy.float() * (x32 * rstd[:, None])).sum(0).to(w.dtype)
                if kind == "ln":
                    dy.float().sum(0).to(b.dtype)

            row["wdb_ms"] = time_ms(wdb, reps=5, inner=5)
        say(card, "fused_norm_dx " + json.dumps(row))
        if (R, N, kind, dtype, mean, shift) == NORM_DX_CASES[0]:
            main = row
        del x, dy
    say(card, "fused_norm_dx library_ms: torch.ops.aten.native_layer_norm_"
              "backward / _fused_rms_norm_backward (dx only); wdb_ms: the "
              "dweight (and LayerNorm's dbias) reductions beside dx")
    if bad:
        raise AssertionError("; ".join(bad))
    return {"worst": worst, "main": main}


NORM_DX_KERNEL = re.compile(
    r"norm_bwd_dx_rows_kernelI(f|6__half|13__nv_bfloat16)"
    r"(f|6__half|13__nv_bfloat16|S\d*_)Lb([01])E")


def _norm_dx_name(ln):
    m = NORM_DX_KERNEL.search(ln)
    if not m:
        return None
    t = ROPE_TYPES[m[1]]
    return (f"norm_bwd_dx_rows_kernel<{t}, {ROPE_TYPES.get(m[2], t)}, "
            f"{'ln' if m[3] == '1' else 'rms'}>")


def norm_dx_ptxas(card, log):
    """Registers and spill-store bytes of each `norm_bwd_dx_rows_kernel<T,
    TW, kind>` instantiation (x, weight and kind: 18), from nvcc's
    `-Xptxas -v` report (`log`, empty if this process did not build).
    Raises on a spill, or on a missing instantiation when the log holds the
    build."""
    report = ptxas_kernels(log, None, _norm_dx_name)
    say(card, "fused_norm_dx ptxas " + json.dumps(report))
    spills = [n for n, r in report.items() if r.get("spill_store_bytes")]
    if spills:
        raise AssertionError(f"norm_bwd_dx_rows_kernel instantiations spill: "
                             f"{spills}")
    if log and len(report) != 18:
        raise AssertionError(f"norm_bwd_dx_rows_kernel: {len(report)} "
                             f"instantiations built, 18 expected")
    return report


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


# name: (B, Sq, Skv, H, Hkv, D, causal, key bias, dtype). The bf16 kernels'
# tiles are 128 x 128: the edge cases put S off them (333, 517, 257, 200,
# 150), D at 64, below it (40, and 36, which is not a multiple of 8: the
# wrappers' copy route) and between the panels (96), Sq > Skv (rows that
# see no key; at 456 over 200 the first two 128-row q tiles see none, so
# their dQ CTAs visit no kv tile) and Skv > Sq with an offset Skv - Sq off
# the 64-row step (184), and q/k/v as views (FLASH_LAYOUTS).
FLASH_CASES = {
    "path": (4, 2048, 2048, 16, 16, 128, True, False, "bfloat16"),
    "f32": (1, 1024, 1024, 16, 16, 128, True, False, "float32"),
    "gqa_g4": (2, 512, 512, 16, 4, 128, True, False, "bfloat16"),
    "ragged_sq_lt_skv_g2_d64": (2, 333, 517, 8, 4, 64, True, False, "bfloat16"),
    "sq_gt_skv_f32_d64": (1, 300, 200, 4, 4, 64, True, False, "float32"),
    "key_bias_padded_row": (3, 257, 257, 8, 8, 128, False, True, "bfloat16"),
    "sq_gt_skv_d64": (1, 300, 200, 4, 4, 64, True, False, "bfloat16"),
    "sq_gt_skv_by_two_tiles_d64": (1, 456, 200, 4, 4, 64, True, False,
                                   "bfloat16"),
    "d40_causal": (2, 200, 200, 8, 8, 40, True, False, "bfloat16"),
    "d96_g2": (1, 384, 384, 8, 4, 96, True, False, "bfloat16"),
    "d36_copy": (1, 150, 150, 4, 2, 36, False, False, "bfloat16"),
    "fused_qkv_view": (2, 384, 384, 16, 16, 128, True, False, "bfloat16"),
    "unaligned_view_copy": (1, 200, 200, 8, 8, 64, True, False, "bfloat16"),
}
# how a case's q, k and v are laid out (default: three contiguous tensors):
# "fused_qkv" slices one [B, S, 3, H, D] tensor (strided views the TMA maps
# take as they are); "unaligned" views one flat buffer 2 bytes past its
# start (the wrappers copy them)
FLASH_LAYOUTS = {"fused_qkv_view": "fused_qkv",
                 "unaligned_view_copy": "unaligned"}


def _flash_inputs(torch, gen, B, Sq, Skv, H, Hkv, D, bias, dtype,
                  layout="contiguous"):
    """(q, k, v, dO, key bias or None, keep [B, Skv] bool). With `bias`,
    batch row b pads its last 17 (b + 1) keys and batch row 1 all of
    them."""
    dt = getattr(torch, dtype)
    if layout == "fused_qkv":
        qkv = torch.randn(B, Sq, 3, H, D, device="cuda", generator=gen).to(dt)
        q, k, v = qkv.unbind(2)
    elif layout == "unaligned":
        nq, nkv = B * Sq * H * D, B * Skv * Hkv * D
        flat = torch.randn(nq + 2 * nkv + 1, device="cuda",
                           generator=gen).to(dt)[1:]
        q = flat[:nq].view(B, Sq, H, D)
        k = flat[nq:nq + nkv].view(B, Skv, Hkv, D)
        v = flat[nq + nkv:].view(B, Skv, Hkv, D)
    else:
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
    delta = rowsum(dO * O). dK and dV are the kv heads' f32 gradients
    [B, Skv, Hkv, D] on both sides."""
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
        q, k, v, dout, kb, keep = _flash_inputs(
            torch, gen, B, Sq, Skv, H, Hkv, D, bias, dtype,
            FLASH_LAYOUTS.get(name, "contiguous"))
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
                    + 2 * B * Skv * Hkv * D * 4, 8 * pairs * D, ("dk", "dv")),
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


# the autograd check's shapes: (B, Sq, Skv, H, Hkv, D, causal, key bias,
# dtype), the training path's and one GQA shape
FLASH_AUTOGRAD_CASES = {
    "path": FLASH_CASES["path"],
    "gqa_32_8": (2, 1024, 1024, 32, 8, 128, True, False, "bfloat16"),
}


def check_flash_autograd(card, torch):
    """flash_attention_fwd(q, k, v).backward(dO) in bf16 through the kernels,
    at the training path's shape (B 4 x 2048, 16 heads of 128, causal) and
    at GQA 32/8 (B 2 x 1024), against the same autograd function's plain
    versions on the same inputs on the card (the plain forward's LSE and
    delta, dq, and dk/dv of the kv heads rounded to k's dtype as the
    backward rounds the kernel's), held with check_flash's limits. It holds
    what autograd adds around the kernels: dO as autograd hands it over and
    the kv heads' f32 gradients the dk/dv kernel writes. One launch of each
    flash kernel a call."""
    from paddle_tpu_torch.ops import flash_attention as fa

    gen = torch.Generator(device="cuda").manual_seed(5)
    bad = []
    for name, (B, Sq, Skv, H, Hkv, D, causal, bias, dtype) in \
            FLASH_AUTOGRAD_CASES.items():
        q, k, v, dout, kb, _ = _flash_inputs(torch, gen, B, Sq, Skv, H, Hkv, D,
                                             bias, dtype)
        scale = D ** -0.5
        leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
        before = (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES)
        out = fa.flash_attention_fwd(*leaves, causal=causal, scale=scale,
                                     key_bias=kb)
        out.backward(dout)
        torch.cuda.synchronize()
        launches = [a - b for a, b in zip(
            (fa.FWD_LAUNCHES, fa.DQ_LAUNCHES, fa.DKV_LAUNCHES), before)]
        out_p, lse_p = fa.flash_fwd_plain(q, k, v, causal, scale, kb)
        delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
        dq_p = fa.flash_bwd_dq_plain(q, k, v, kb, dout, lse_p, delta, causal,
                                     scale)
        dk_p, dv_p = fa.flash_bwd_dkv_plain(q, k, v, kb, dout, lse_p, delta,
                                            causal, scale)
        got = {"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
               "dv": leaves[2].grad}
        plain = {"out": out_p, "dq": dq_p, "dk": dk_p.to(k.dtype),
                 "dv": dv_p.to(v.dtype)}
        errs = _flash_errs(got, plain)
        bad += [f"{name}: {b}" for b in _flash_violations(errs, dtype)]
        shapes = {w: list(t.shape) for w, t in got.items()}
        say(card, "flash autograd " + json.dumps({
            "case": name, "B": B, "Sq": Sq, "Skv": Skv, "H": H, "Hkv": Hkv,
            "D": D, "causal": causal, "launches_fwd_dq_dkv": launches,
            "shapes": shapes,
            "errors": {w: {"max_abs": e[0], "row_rel": e[1],
                           "frobenius_rel": e[2]} for w, e in errs.items()},
            "tol": FLASH_TOL[dtype], "frobenius_tol": FLASH_FROB_TOL[dtype]}))
        if launches != [1, 1, 1]:
            bad.append(f"{name}: launches (fwd, dq, dk/dv) {launches}, not "
                       "one each")
        for w, t in (("dk", k), ("dv", v)):
            if shapes[w] != list(t.shape) or got[w].dtype != t.dtype:
                bad.append(f"{name}: {w} {shapes[w]} {got[w].dtype}, not "
                           f"{list(t.shape)} {t.dtype}")
        del q, k, v, dout, leaves, out, got, plain, out_p, dq_p, dk_p, dv_p
        torch.cuda.empty_cache()
    if bad:
        raise AssertionError("flash autograd: " + "; ".join(bad))


def library_sdpa(torch, q, k, v, dout, causal, keep=None):
    """Yardstick device times of PyTorch's own attention on the same inputs
    (never called by the port), CUDA-graph replays as for the kernels: the
    forward, and the backward through autograd as the time of forward and
    backward captured together less the forward's. k and v are expanded to
    the query heads first (not timed); `keep` [B, H, Sq, Skv], where given,
    is the bool attn_mask, else `causal` is is_causal. The backward is
    measured three times; the median is the yardstick, `bwd_runs` the
    spread."""
    g = q.shape[2] // k.shape[2]
    qh, kh, vh = (t.transpose(1, 2).detach().requires_grad_() for t in (
        q, k.repeat_interleave(g, 2), v.repeat_interleave(g, 2)))
    dh = dout.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    kw = dict(is_causal=causal) if keep is None else dict(attn_mask=keep)

    def fwd_bwd():
        return torch.autograd.grad(sdpa(qh, kh, vh, **kw), (qh, kh, vh), dh)

    fwd = time_ms(lambda: sdpa(qh, kh, vh, **kw), reps=5, inner=5)
    bwd = sorted(time_ms(fwd_bwd, reps=5, inner=5) - fwd for _ in range(3))
    return {"fwd": fwd, "dq": bwd[1], "dkv": bwd[1], "bwd_runs": bwd}


def _docs(rng, S, n_docs):
    """Column -> first row of the next document (S in the last one)."""
    cuts = np.sort(rng.choice(np.arange(1, S), n_docs - 1, replace=False))
    bounds = np.concatenate([cuts, [S]])
    return bounds[np.searchsorted(bounds, np.arange(S), side="right")]


def flashmask_index(rng, B, Hm, S, n, kind):
    """startend_row_indices in the kernels' layout, int32 [B, Hm, n, S],
    of a mask kind: "trivial" (nothing masked beyond causal: the LLaMA
    step's index), "docs" (causal, 4 documents a row; with n = 2 only the
    next S/4 rows past a document are masked), "band" (non-causal n = 2:
    rows >= col + w1 or < col - w2), "two_holes" (non-causal n = 4) and
    "empty_rows" (non-causal n = 2: rows >= S - 5 keep no key)."""
    idx = np.empty((B, Hm, n, S), np.int32)
    cols = np.arange(S)
    for b in range(B):
        for hm in range(Hm):
            if kind == "trivial":
                idx[b, hm] = S
            elif kind == "docs":
                idx[b, hm, 0] = _docs(rng, S, 4)
                if n == 2:
                    idx[b, hm, 1] = np.minimum(idx[b, hm, 0] + S // 4, S)
            elif kind == "band":
                idx[b, hm, 0] = np.minimum(cols + int(rng.integers(64, 200)), S)
                idx[b, hm, 1] = np.maximum(cols - int(rng.integers(64, 200)), 0)
            elif kind == "two_holes":
                lts = rng.integers(0, S // 2, S)
                uts = rng.integers(S // 2, S, S)
                idx[b, hm] = [lts, lts + rng.integers(0, S // 4, S), uts,
                              uts + rng.integers(0, S // 4, S)]
            elif kind == "empty_rows":
                idx[b, hm, 0], idx[b, hm, 1] = S - 5, 0
    return idx


# name: (B, S, H, Hkv, Hm, D, causal, n, mask kind, dtype)
FLASHMASK_CASES = {
    "path": (4, 2048, 32, 8, 1, 128, True, 1, "trivial", "bfloat16"),
    "causal_n1_docs": (2, 1024, 8, 8, 1, 128, True, 1, "docs", "bfloat16"),
    "causal_n2_per_head_s1000_gqa": (1, 1000, 8, 2, 8, 128, True, 2, "docs",
                                     "bfloat16"),
    "full_n2_band_f32_d64": (1, 517, 4, 4, 1, 64, False, 2, "band", "float32"),
    "full_n4_gqa_32_8": (2, 300, 32, 8, 1, 128, False, 4, "two_holes",
                         "bfloat16"),
    "empty_rows_f32_d64": (2, 200, 4, 2, 1, 64, False, 2, "empty_rows",
                           "float32"),
    "full_n2_band_d64": (1, 517, 4, 4, 1, 64, False, 2, "band", "bfloat16"),
    "empty_rows_d64": (2, 200, 4, 2, 1, 64, False, 2, "empty_rows",
                       "bfloat16"),
}


def _flashmask_inputs(torch, gen, name):
    """(q, k, v, dO, idx [B, Hm, n, S] int32 on the card, causal, dtype)
    of a FLASHMASK_CASES case."""
    B, S, H, Hkv, Hm, D, causal, n, kind, dtype = FLASHMASK_CASES[name]
    q, k, v, dout, _, _ = _flash_inputs(torch, gen, B, S, S, H, Hkv, D, False,
                                        dtype)
    idx = flashmask_index(np.random.default_rng(len(name)), B, Hm, S, n, kind)
    return q, k, v, dout, torch.as_tensor(idx, device="cuda"), causal, dtype


def _flashmask_classes(mf, torch, q, idx, causal):
    """The tile classes the bf16 kernels read (None in f32), derived once
    as FlashmaskAttention's forward does for its backward."""
    if q.dtype != torch.bfloat16:
        return None
    return mf.flashmask_tile_classes(idx, q.shape[1], q.shape[1], causal)


def _flashmask_outputs(mf, q, k, v, dout, idx, causal, scale, cls):
    """As `_flash_outputs`, for the flashmask kernels; the backward
    kernels read the tile classes `cls`."""
    out, lse = mf.flashmask_fwd(q, k, v, idx, causal, scale)
    out_p, lse_p = mf.flashmask_fwd_plain(q, k, v, idx, causal, scale)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq = mf.flashmask_bwd_dq(q, k, v, idx, dout, lse_p, delta, causal, scale,
                             cls)
    dq_p = mf.flashmask_bwd_dq_plain(q, k, v, idx, dout, lse_p, delta, causal,
                                     scale)
    dk, dv = mf.flashmask_bwd_dkv(q, k, v, idx, dout, lse_p, delta, causal,
                                  scale, cls)
    dk_p, dv_p = mf.flashmask_bwd_dkv_plain(q, k, v, idx, dout, lse_p, delta,
                                            causal, scale)
    return ({"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
            {"out": out_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
            delta)


def check_flashmask(card, torch):
    """Flashmask forward, dq and dk/dv kernels against their plain versions
    on the same inputs (the backward kernels get the plain forward's LSE and
    delta), held with check_flash's limits: the LLaMA-7B-shape training
    step's attention (B 4, S 2048, 32 query heads over 8 kv heads, the
    trivial causal index, bf16), causal n = 1 with four documents a row,
    causal n = 2 with a mask per query head at S 1000 (not a multiple of
    the 64-row tile) and GQA, non-causal n = 2 in f32, non-causal n = 4 at
    GQA 32/8, and rows that keep no key (zeros and a zero dq). The
    operation bound counts the pairs this run's masks keep. Library: torch
    scaled_dot_product_attention, is_causal for the trivial index, else the
    keep-mask as a bool attn_mask."""
    from paddle_tpu_torch.ops import masked_flash as mf

    gen = torch.Generator(device="cuda").manual_seed(9)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    main, failures, lib_path = {}, [], None
    for name, (B, S, H, Hkv, Hm, D, causal, n, kind, dtype) in \
            FLASHMASK_CASES.items():
        q, k, v, dout, idx, causal, dtype = _flashmask_inputs(torch, gen, name)
        scale = D ** -0.5
        cls = _flashmask_classes(mf, torch, q, idx, causal)
        got, plain, delta = _flashmask_outputs(mf, q, k, v, dout, idx, causal,
                                               scale, cls)
        torch.cuda.synchronize()
        errs = _flash_errs(got, plain)
        failures += [f"flashmask {name}: {b}"
                     for b in _flash_violations(errs, dtype)]
        empty = torch.isinf(plain["lse"]).transpose(1, 2)  # [B, S, H]
        n_empty = int(empty.sum())
        if n_empty and (got["out"][empty].abs().max().item() != 0
                        or got["dq"][empty].abs().max().item() != 0):
            failures.append(f"flashmask {name}: a row that keeps no key is "
                            "not zero")
        keep = mf.flashmask_keep(idx, S, S, causal).repeat_interleave(
            H // Hm, dim=1)
        pairs = int(keep.sum())
        es = q.element_size()
        qo, kv = B * S * H * D * es, B * S * Hkv * D * es
        stats, idx_bytes = B * H * S * 4, idx.numel() * 4
        reps, inner = (5, 3) if pairs * D > 1e10 else (10, 10)
        rows = {
            "fwd": (lambda: mf.flashmask_fwd(q, k, v, idx, causal, scale),
                    lambda: mf.flashmask_fwd_plain(q, k, v, idx, causal, scale),
                    2 * qo + 2 * kv + stats + idx_bytes, 4 * pairs * D,
                    ("out", "lse")),
            "dq": (lambda: mf.flashmask_bwd_dq(q, k, v, idx, dout, plain["lse"],
                                               delta, causal, scale, cls),
                   lambda: mf.flashmask_bwd_dq_plain(
                       q, k, v, idx, dout, plain["lse"], delta, causal, scale),
                   3 * qo + 2 * kv + 2 * stats + idx_bytes, 6 * pairs * D,
                   ("dq",)),
            "dkv": (lambda: mf.flashmask_bwd_dkv(q, k, v, idx, dout,
                                                 plain["lse"], delta, causal,
                                                 scale, cls),
                    lambda: mf.flashmask_bwd_dkv_plain(
                        q, k, v, idx, dout, plain["lse"], delta, causal, scale),
                    2 * qo + 2 * kv + 2 * stats + idx_bytes
                    + 2 * B * S * Hkv * D * 4, 8 * pairs * D, ("dk", "dv")),
        }
        lib = {}
        if name == "path":
            lib = lib_path = library_sdpa(torch, q, k, v, dout, True)
        elif name == "causal_n1_docs":
            lib = library_sdpa(torch, q, k, v, dout, causal, keep)
        shapes = dict(B=B, S=S, H=H, Hkv=Hkv, Hm=Hm, n=n, D=D, causal=causal,
                      mask=kind, dtype=dtype, pairs=pairs,
                      rows_without_keys=n_empty)
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
                       bound_ms=bnd, bound_by=by, library_ms=lib.get(kernel))
            if kernel == "fwd" and dtype == "bfloat16":
                # the wrapper's share of `ms`: the tile classes it derives
                row["tile_classes_ms"] = time_ms(
                    lambda: mf.flashmask_tile_classes(idx, S, S, causal),
                    reps=reps, inner=inner)
            say(card, "flashmask " + json.dumps(row))
            worst[kernel] = max(worst[kernel], err)
            if name == "path":
                main[kernel] = row
        del q, k, v, dout, got, plain, keep
        torch.cuda.empty_cache()
    say(card, "flashmask library_ms: torch scaled_dot_product_attention on "
              "k and v expanded to the query heads, is_causal for the trivial "
              "index and the keep-mask as a bool attn_mask for the documents; "
              "its backward as in flash_attention, one figure for dq and "
              "dk/dv; the path's backward measured three times: "
              + json.dumps(lib_path["bwd_runs"]))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst, "main": main}


def check_flashmask_autograd(card, torch):
    """flashmask_attention_fwd(q, k, v, idx).backward(dO) at the path shape
    (FLASHMASK_CASES "path": bf16, B 4 x 2048, 32 query heads over 8 kv
    heads of 128, the trivial causal index) through the kernels, against
    the plain functions on the same inputs on the card, held with
    check_flash's limits: O, dQ, and dK and dV of the kv heads (the plain
    versions' group sums, rounded to k's dtype as the backward rounds the
    kernel's). It holds what autograd adds around the kernels: the tile
    classes the forward saves for the backward, dO as autograd hands it
    over, and the kv heads' f32 gradients the dk/dv kernel writes. One
    launch of each flashmask kernel."""
    from paddle_tpu_torch.ops import masked_flash as mf

    gen = torch.Generator(device="cuda").manual_seed(9)
    q, k, v, dout, idx, causal, dtype = _flashmask_inputs(torch, gen, "path")
    scale = q.shape[-1] ** -0.5
    leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
    before = (mf.FWD_LAUNCHES, mf.DQ_LAUNCHES, mf.DKV_LAUNCHES)
    out = mf.flashmask_attention_fwd(*leaves, idx.transpose(2, 3),
                                     causal=causal, scale=scale)
    out.backward(dout)
    torch.cuda.synchronize()
    launches = [a - b for a, b in zip(
        (mf.FWD_LAUNCHES, mf.DQ_LAUNCHES, mf.DKV_LAUNCHES), before)]
    out_p, lse_p = mf.flashmask_fwd_plain(q, k, v, idx, causal, scale)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(1, 2).contiguous()
    dq_p = mf.flashmask_bwd_dq_plain(q, k, v, idx, dout, lse_p, delta, causal,
                                     scale)
    dk_p, dv_p = mf.flashmask_bwd_dkv_plain(q, k, v, idx, dout, lse_p, delta,
                                            causal, scale)
    got = {"out": out.detach(), "dq": leaves[0].grad, "dk": leaves[1].grad,
           "dv": leaves[2].grad}
    plain = {"out": out_p, "dq": dq_p, "dk": dk_p.to(k.dtype),
             "dv": dv_p.to(v.dtype)}
    errs = _flash_errs(got, plain)
    bad = _flash_violations(errs, dtype)
    shapes = {w: list(t.shape) for w, t in got.items()}
    say(card, "flashmask autograd " + json.dumps({
        "case": "path", "launches_fwd_dq_dkv": launches, "shapes": shapes,
        "errors": {w: {"max_abs": e[0], "row_rel": e[1], "frobenius_rel": e[2]}
                   for w, e in errs.items()},
        "tol": FLASH_TOL[dtype], "frobenius_tol": FLASH_FROB_TOL[dtype]}))
    if launches != [1, 1, 1]:
        bad.append(f"launches (fwd, dq, dk/dv) {launches}, not one each")
    if shapes["dk"] != list(k.shape) or got["dk"].dtype != k.dtype:
        bad.append(f"dk {shapes['dk']} {got['dk'].dtype}, not k's")
    del q, k, v, dout, leaves, out, got, plain
    torch.cuda.empty_cache()
    if bad:
        raise AssertionError("flashmask autograd: " + "; ".join(bad))


# Grouped GEMM kernel vs plain, every output row held to its own largest
# |plain| (or to a thousandth of the tensor's largest, for rows that are
# zero): f32 differs only in the order of the K-sums (K <= 4096 products of
# magnitude ~1: a few 1e-7 of the row); bf16 multiplies the same bf16
# operands exactly on both sides, accumulates in f32 and rounds once, so
# the two may land on neighbouring bf16 values: one ulp, at most 2^-7 of
# the row's largest value. The limit is two ulps. Rows past a group's
# computed rows (dead tiles) must be exactly zero.
GG_TOL = {"float32": 1e-5, "bfloat16": 2 ** -6}

# name: (E, R, K, N, live rows a group or "rung", rhs read transposed, dtype).
# K is lhs's depth and N the output's width; a transposed rhs is [E, N, K]
# (the backward's dlhs against the weights). The rung's cases take the
# group sizes of one routing of the gpt3_moe rung (rung_sizes).
GG_CASES = {
    "rung_w1": (8, 1280, 1024, 4096, "rung", False, "bfloat16"),
    "rung_w2": (8, 1280, 4096, 1024, "rung", False, "bfloat16"),
    "rung_w2_dlhs": (8, 1280, 1024, 4096, "rung", True, "bfloat16"),
    "rung_w1_dlhs": (8, 1280, 4096, 1024, "rung", True, "bfloat16"),
    "rung_w1_f32": (8, 1280, 1024, 4096, "rung", False, "float32"),
    "rung_w2_f32": (8, 1280, 4096, 1024, "rung", False, "float32"),
    "r16_k37_f32": (4, 16, 37, 50, [0, 16, 5, 9], False, "float32"),
    "r48_n136": (3, 48, 72, 136, [48, 0, 17], False, "bfloat16"),
    "r48_dlhs_k37_f32": (3, 48, 37, 70, [48, 0, 17], True, "float32"),
    "partial_tiles": (4, 256, 64, 200, [65, 130, 0, 256], False, "bfloat16"),
    "k100_dlhs": (2, 128, 100, 96, [100, 1], True, "bfloat16"),
}


def rung_sizes(torch):
    """([8] int32 live rows a group, the capacity) of one routing of the
    gpt3_moe rung: a GShard gate at width 1024 over 8 experts (weights and
    random routing from seed 0, training) on 8192 tokens of N(0, 1)
    activations, each expert's routed pairs cut at the capacity 1229."""
    from paddle_tpu_torch.incubate.distributed.models.moe import GShardGate

    gen = torch.Generator(device="cuda").manual_seed(0)
    gate = GShardGate(1024, 8, device="cuda", generator=gen)
    x = torch.randn(8192, 1024, device="cuda", generator=gen)
    with torch.no_grad():
        topi, _, keep, _ = gate._route(x, gate.gate.weight, gate.gate.bias)
    counts = torch.bincount(topi[keep], minlength=8)
    cap = gate.capacity(8192)
    return torch.clamp(counts, max=cap).to(torch.int32), cap


def _gg_inputs(torch, gen, name, sizes_rung):
    """(lhs with values in every row, dead ones included, rhs, sizes) of a
    GG_CASES case on the card."""
    E, R, K, N, sizes, trans, dtype = GG_CASES[name]
    dt = getattr(torch, dtype)
    sz = sizes_rung if sizes == "rung" else torch.tensor(
        sizes, dtype=torch.int32, device="cuda")
    lhs = torch.randn(E * R, K, device="cuda", generator=gen).to(dt)
    shape = (E, N, K) if trans else (E, K, N)
    rhs = (torch.randn(*shape, device="cuda", generator=gen) * K ** -0.5).to(dt)
    return lhs, rhs, sz


def _gg_violations(gg, torch, name, out, ref, sz):
    """What breaks the limits: the row-relative error, a non-zero dead row,
    a non-finite value."""
    E, R, _, _, _, _, dtype = GG_CASES[name]
    err = _flash_err(out, ref)
    live = gg._computed_mask(sz, E, R, gg.BM, out.device).reshape(E * R)
    bad = []
    if not err[1] <= GG_TOL[dtype]:
        bad.append(f"row-relative {err[1]} (tol {GG_TOL[dtype]})")
    if bool(out[~live].any()):
        bad.append("a dead row is not zero")
    if not bool(torch.isfinite(out).all()):
        bad.append("non-finite output")
    return bad, err


def check_grouped_gemm(card, torch):
    """The grouped GEMM kernel against its plain version: the gpt3_moe
    rung's four products (the two forward GEMMs of an MoE block and their
    dlhs against the transposed weights, with the group sizes of a real
    routing) in bf16, the two forward ones in f32, and edge cases: a group
    with no live rows, one with all R, partly live tiles, the small strides
    R = 16 and 48 that row_stride gives, and K and N not multiples of the
    tile (K not a multiple of 8: the wrapper pads it for the bf16 kernel's
    TMA maps). The bound counts the rows this run's sizes make the kernel
    compute. Library: one torch.bmm
    over [E, R, K] x [E, K, N], which computes the dead rows too."""
    from paddle_tpu_torch.ops import grouped_gemm as gg

    gen = torch.Generator(device="cuda").manual_seed(11)
    sizes_rung, cap = rung_sizes(torch)
    say(card, f"grouped_gemm rung routing: sizes {sizes_rung.tolist()}, "
              f"capacity {cap}, row stride {gg.row_stride(cap)}")
    worst, main, failures = 0.0, None, []
    for name, (E, R, K, N, sizes, trans, dtype) in GG_CASES.items():
        lhs, rhs, sz = _gg_inputs(torch, gen, name, sizes_rung)
        out = gg.grouped_gemm(lhs, rhs, sz, trans)
        ref = gg.grouped_matmul_plain(lhs, rhs, sz, gg.BM, trans)
        torch.cuda.synchronize()
        bad, err = _gg_violations(gg, torch, name, out, ref, sz)
        failures += [f"grouped_gemm {name}: {b}" for b in bad]
        rows = int(gg.computed_rows(sz, R).sum())
        es = lhs.element_size()
        nbytes = (rows * K + int((sz > 0).sum()) * K * N + E * R * N) * es + E * 4
        ops = 2 * rows * K * N
        bnd, by = bound_ms(nbytes, ops, dtype)
        reps, inner = (5, 5) if ops > 1e10 else (10, 10)
        lib = None
        if sizes == "rung":
            w, l3 = (rhs.transpose(1, 2) if trans else rhs), lhs.view(E, R, K)
            lib = time_ms(lambda: torch.bmm(l3, w), reps=reps, inner=inner)
        row = dict(case=name, E=E, R=R, K=K, N=N, trans_rhs=trans, dtype=dtype,
                   sizes=sz.tolist(), computed_rows=rows, max_abs_err=err[0],
                   row_rel_err=err[1], tol=GG_TOL[dtype],
                   ms=time_ms(lambda: gg.grouped_gemm(lhs, rhs, sz, trans),
                              reps=reps, inner=inner),
                   eager_ms=eager_ms(lambda: gg.grouped_gemm(lhs, rhs, sz, trans),
                                     reps=reps, inner=inner),
                   plain_ms=time_ms(lambda: gg.grouped_matmul_plain(
                       lhs, rhs, sz, gg.BM, trans), reps=3, inner=2),
                   bound_ms=bnd, bound_by=by, library_ms=lib)
        say(card, "grouped_gemm " + json.dumps(row))
        worst = max(worst, err[0])
        if name == "rung_w1":
            main = row
        del lhs, rhs, out, ref
    torch.cuda.empty_cache()
    say(card, "grouped_gemm library_ms: torch.bmm over [E, R, K] x [E, K, N] "
              "(the transposed weights as a view for dlhs), dead rows "
              "computed too")
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst, "main": main}


# name: (q document lengths, or ("docs", T, documents) cut as `_docs` cuts
# them; k lengths, None for the q lengths; H, Hkv, D, causal, dtype)
VARLEN_CASES = {
    "path": (("docs", 8192, 8), None, 32, 8, 128, True, "bfloat16"),
    "full_docs_t1000_f32_d64": (("docs", 1000, 4), None, 4, 2, 64, False,
                                "float32"),
    "cross_causal_gqa": ([300, 200, 500], [100, 400, 250], 8, 2, 128, True,
                         "bfloat16"),
    "empty_k_segment_f32_d64": ([100, 60, 140], [120, 0, 100], 4, 4, 64,
                                True, "float32"),
    "empty_k_segment_bf16": ([100, 60, 140], [120, 0, 100], 8, 2, 128, True,
                             "bfloat16"),
    "single_tile_d32": ([7, 9, 11], None, 2, 1, 32, True, "bfloat16"),
}


def _varlen_lens(rng, spec):
    if isinstance(spec, tuple):
        _, T, n = spec
        ends = np.unique(_docs(rng, T, n))
        return np.diff(np.concatenate([[0], ends])).tolist()
    return list(spec)


def _varlen_inputs(torch, gen, name):
    """(q, k, v, dO, layout, cu_q, cu_k, causal, dtype) of a VARLEN_CASES
    case on the card."""
    from paddle_tpu_torch.ops import masked_flash as mf

    spec_q, spec_k, H, Hkv, D, causal, dtype = VARLEN_CASES[name]
    rng = np.random.default_rng(len(name))
    lens_q = _varlen_lens(rng, spec_q)
    lens_k = lens_q if spec_k is None else _varlen_lens(rng, spec_k)
    cu_q, cu_k = (torch.tensor(np.concatenate([[0], np.cumsum(l)]),
                               dtype=torch.int32, device="cuda")
                  for l in (lens_q, lens_k))
    Tq, Tk = sum(lens_q), sum(lens_k)
    dt = getattr(torch, dtype)
    q = torch.randn(Tq, H, D, device="cuda", generator=gen).to(dt)
    k = torch.randn(Tk, Hkv, D, device="cuda", generator=gen).to(dt)
    v = torch.randn(Tk, Hkv, D, device="cuda", generator=gen).to(dt)
    dout = torch.randn(Tq, H, D, device="cuda", generator=gen).to(dt)
    layout = mf.varlen_layout(cu_q, cu_k, Tq, Tk, causal)
    return q, k, v, dout, layout, cu_q, cu_k, causal, dtype


def _varlen_classes(mf, torch, q, k, layout, causal):
    """The tile classes the bf16 kernels read (None in f32), derived once
    by the kernel the forward's entry runs, as VarlenAttention keeps the
    forward's for its backward."""
    if q.dtype != torch.bfloat16:
        return None
    return mf.varlen_tile_classes(layout, q.shape[0], k.shape[0], causal)


def _varlen_outputs(mf, q, k, v, dout, layout, causal, scale, cls):
    """As `_flash_outputs`, for the varlen kernels; the backward kernels
    read the tile classes `cls`."""
    out, lse = mf.varlen_fwd(q, k, v, layout, causal, scale)
    out_p, lse_p = mf.varlen_fwd_plain(q, k, v, layout, causal, scale)
    delta = (dout.float() * out_p.float()).sum(-1).transpose(0, 1).contiguous()
    dq = mf.varlen_bwd_dq(q, k, v, layout, dout, lse_p, delta, causal, scale,
                          cls)
    dq_p = mf.varlen_bwd_dq_plain(q, k, v, layout, dout, lse_p, delta, causal,
                                  scale)
    dk, dv = mf.varlen_bwd_dkv(q, k, v, layout, dout, lse_p, delta, causal,
                               scale, cls)
    dk_p, dv_p = mf.varlen_bwd_dkv_plain(q, k, v, layout, dout, lse_p, delta,
                                         causal, scale)
    return ({"out": out, "lse": lse, "dq": dq, "dk": dk, "dv": dv},
            {"out": out_p, "lse": lse_p, "dq": dq_p, "dk": dk_p, "dv": dv_p},
            delta)


def _varlen_class_violations(torch, mf, name, layout, Tq, Tk, causal):
    """The tile classes the card derives (`varlen_classes_kernel`, which
    the bf16 forward launches before it) against their plain version:
    equal, tile for tile."""
    got = mf.varlen_tile_classes(layout, Tq, Tk, causal)
    ref = mf.varlen_tile_classes_plain(layout, Tq, Tk, causal)
    wrong = int((got != ref).sum())
    return [f"varlen {name}: {wrong} of {ref.numel()} tile classes differ "
            "from the plain version's"] if wrong else []


def _second_half_keys(torch, layout, Tk):
    """bool [Tk]: the keys in the second 64 of a 128-key tile whose 64-key
    tile is seen by q rows past the first 64 keys' last q step (a document
    that starts there): the dK/dV kernel reaches those rows only through
    the CTA-wide `q_tiles(p, k0, 128)`."""
    end = (layout.krange[1].long() + 63) // 64  # each 64-key tile's q-step end
    t = torch.arange(end.numel(), device=end.device)
    late = (t % 2 == 1) & (end > end[(t - 1).clamp_min(0)])
    return late.repeat_interleave(64)[:Tk]


def check_varlen(card, torch):
    """Varlen forward, dq and dk/dv kernels against their plain versions on
    the same inputs (the backward kernels get the plain forward's LSE and
    delta), held with check_flash's limits: a pack of 8192 tokens in 8
    documents at the LLaMA-7B head shape (32 query heads over 8 kv heads of
    128, causal, bf16), non-causal documents at T = 1000 (not a multiple
    of the 64-row tile) in f32, causal cross attention with q lengths !=
    k lengths and GQA, an empty k segment in f32 and in bf16 (its rows:
    zeros, zero dq) and a pack of 27 tokens (one tile). The bf16 forward
    runs the sm90 kernel on the tile classes its entry derives first
    (`varlen_classes_kernel`); those classes are held equal to
    `varlen_tile_classes_plain` in every case, and the classes kernel's
    time alone is printed beside the forward's row (`tile_classes_ms`,
    part of `ms`). The operation bound counts the pairs the segments
    keep. Library: torch scaled_dot_product_attention on the main
    case with k and v expanded to the query heads and the keep-mask as a
    bool [T, T] attn_mask (block-diagonal, causal within each block).
    The bf16 dq and dk/dv run the sm90 backward on the forward's classes;
    the keys whose document starts in the second 64 of a 128-key dK/dV
    tile (`_second_half_keys`) are held on their own too, and
    cross_causal_gqa must have some."""
    from paddle_tpu_torch.ops import masked_flash as mf

    gen = torch.Generator(device="cuda").manual_seed(13)
    worst = {"fwd": 0.0, "dq": 0.0, "dkv": 0.0}
    main, failures, lib_path = {}, [], None
    for name, (_, _, H, Hkv, D, _, _) in VARLEN_CASES.items():
        q, k, v, dout, layout, cu_q, cu_k, causal, dtype = _varlen_inputs(
            torch, gen, name)
        scale = D ** -0.5
        cls = _varlen_classes(mf, torch, q, k, layout, causal)
        got, plain, delta = _varlen_outputs(mf, q, k, v, dout, layout, causal,
                                            scale, cls)
        torch.cuda.synchronize()
        errs = _flash_errs(got, plain)
        failures += [f"varlen {name}: {b}"
                     for b in _flash_violations(errs, dtype)]
        empty = torch.isinf(plain["lse"]).transpose(0, 1)  # [Tq, H]
        n_empty = int(empty.sum())
        if n_empty and (got["out"][empty].abs().max().item() != 0
                        or got["dq"][empty].abs().max().item() != 0):
            failures.append(f"varlen {name}: a row that keeps no key is not "
                            "zero")
        Tq, Tk = q.shape[0], k.shape[0]
        failures += _varlen_class_violations(torch, mf, name, layout, Tq, Tk,
                                             causal)
        late = _second_half_keys(torch, layout, Tk)
        n_late = int(late.sum())
        if n_late:
            late_errs = {w: _flash_err(got[w][late], plain[w][late])
                         for w in ("dk", "dv")}
            say(card, f"varlen {name} second-half keys " + json.dumps(
                {"keys": n_late, "errs": late_errs}))
            failures += [f"varlen {name} second-half keys: {b}"
                         for b in _flash_violations(late_errs, dtype)]
        elif name == "cross_causal_gqa":
            failures.append("varlen cross_causal_gqa: no document starts in "
                            "the second half of a 128-key tile")
        keep = mf.varlen_keep(layout, Tq, causal)
        pairs = int(keep.sum()) * H
        es = q.element_size()
        qo, kv = Tq * H * D * es, Tk * Hkv * D * es
        stats = H * Tq * 4
        lay = sum(t.numel() * 4 for t in layout)
        reps, inner = (5, 3) if pairs * D > 1e10 else (10, 10)
        lse_p = plain["lse"]
        rows = {
            "fwd": (lambda: mf.varlen_fwd(q, k, v, layout, causal, scale),
                    lambda: mf.varlen_fwd_plain(q, k, v, layout, causal, scale),
                    2 * qo + 2 * kv + stats + lay, 4 * pairs * D,
                    ("out", "lse")),
            "dq": (lambda: mf.varlen_bwd_dq(q, k, v, layout, dout, lse_p,
                                            delta, causal, scale, cls),
                   lambda: mf.varlen_bwd_dq_plain(q, k, v, layout, dout, lse_p,
                                                  delta, causal, scale),
                   3 * qo + 2 * kv + 2 * stats + lay, 6 * pairs * D, ("dq",)),
            "dkv": (lambda: mf.varlen_bwd_dkv(q, k, v, layout, dout, lse_p,
                                              delta, causal, scale, cls),
                    lambda: mf.varlen_bwd_dkv_plain(q, k, v, layout, dout,
                                                    lse_p, delta, causal,
                                                    scale),
                    2 * qo + 2 * kv + 2 * stats + lay + 2 * Tk * Hkv * D * 4,
                    8 * pairs * D, ("dk", "dv")),
        }
        lib = {}
        if name == "path":
            lib = lib_path = library_sdpa(torch, q[None], k[None], v[None],
                                          dout[None], causal, keep[None, None])
        shapes = dict(Tq=Tq, Tk=Tk, documents=cu_q.numel() - 1,
                      lengths_q=np.diff(cu_q.tolist()).tolist()
                      if cu_q.numel() <= 9 else None,
                      H=H, Hkv=Hkv, D=D, causal=causal, dtype=dtype,
                      pairs=pairs, rows_without_keys=n_empty,
                      second_half_keys=n_late)
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
                       bound_ms=bnd, bound_by=by, library_ms=lib.get(kernel))
            if kernel == "fwd" and dtype == "bfloat16":
                # the classes kernel's share of `ms`
                row["tile_classes_ms"] = time_ms(
                    lambda: mf.varlen_tile_classes(layout, Tq, Tk, causal),
                    reps=reps, inner=inner)
            say(card, "varlen " + json.dumps(row))
            worst[kernel] = max(worst[kernel], err)
            if name == "path":
                main[kernel] = row
        del q, k, v, dout, got, plain, keep
        torch.cuda.empty_cache()
    say(card, "varlen library_ms: torch scaled_dot_product_attention on k and "
              "v expanded to the query heads with the segments' keep-mask as "
              "a bool [T, T] attn_mask; its backward as in flash_attention, "
              "one figure for dq and dk/dv; measured three times: "
              + json.dumps(lib_path["bwd_runs"]))
    if failures:
        raise AssertionError("; ".join(failures))
    return {"worst": worst, "main": main}


# Faults planted in copies of csrc/ (phase 2b), name: (the source file, the
# text that anchors the fault, the text replaced at its first occurrence
# after the anchor, the replacement, the case that must catch it: "flash
# <FLASH_CASES name>", "varlen <VARLEN_CASES name>", "grouped_gemm
# <GG_CASES name>", "dense_decode <DENSE_CASES name>" (bf16), "norm
# <R>x<N> <kind> <dtype>" (a NORM_CASES shape, offset 0), "norm_dx <R>x<N>
# <kind> <dtype>" (a NORM_DX_CASES shape, mean 0.5, on the 16-byte line)
# or a FLASHMASK_CASES name). They follow the kernels'
# code: a change there that moves the replaced text must move these with
# it. The `Varlen` policy's faults reach every kernel that reads what they
# change: `first_kv_tile` only the f32 kernels (so its case is f32),
# `keep`, `tile_class` and the 128-row `kv_tiles` the sm90 forward and
# the sm90 dQ and dK/dV (or dQ alone), `first_q_tile` and the CTA-wide
# `q_tiles(p, k0, bn)` the sm90 dK/dV.
KERNEL_FAULTS = {
    "fwd: q tiles past the first skip their last kv tile": (
        "flash_fwd_sm90.cuh", "flash_fwd_sm90_kernel(",
        "mask.kv_tiles(p, q0, kBM, kBN);",
        "mask.kv_tiles(p, q0, kBM, kBN) - (q0 > 0);", "flash path"),
    "fwd: rows past the first q tile normalised 1% off": (
        "flash_fwd_sm90.cuh", "void consume(", "1.f / l;",
        "1.f / (l * (q0 > 0 ? 1.01f : 1.f));", "flash path"),
    "flashmask fwd: a partial tile treated as full": (
        "masked_flash.cu", "tile_class(", "return c;",
        "return c == kPartialTile ? kFullTile : c;", "causal_n1_docs"),
    "flash bwd: first_q_tile without the bottom-right offset": (
        "flash_attention.cu", "struct CausalBias",
        "const int first = k0 - (p.Skv - p.Sq);", "const int first = k0;",
        "flash ragged_sq_lt_skv_g2_d64"),
    "flash bwd dk/dv: the key bias on partial tiles only": (
        "flash_bwd_sm90.cuh", "void dkv_consume(",
        "if (partial || mask.has_bias()) {", "if (partial) {",
        "flash key_bias_padded_row"),
    "flashmask: the end bound of causal n = 2 ignored": (
        "masked_flash.cu", "struct FlashMask", "(row >= k.i0 && row < k.i1)",
        "(row >= k.i0)", "causal_n2_per_head_s1000_gqa"),
    "flashmask f32: a tile whose keep-mask is partly empty skipped": (
        "flash_tiles.cuh", "bool any_kept(", "__syncthreads_or(mine) != 0",
        "__syncthreads_and(mine) != 0", "empty_rows_f32_d64"),
    "flashmask: every query head reads mask head 0": (
        "masked_flash.cu", "struct FlashMask", "h / (p.H / Hm)", "0 * h",
        "causal_n2_per_head_s1000_gqa"),
    "flashmask bwd dq: q tiles past the first skip their last kv tile": (
        "flash_bwd_sm90.cuh", "flash_bwd_dq_sm90_kernel(",
        "mask.kv_tiles(p, q0, kBM, kBN);",
        "mask.kv_tiles(p, q0, kBM, kBN) - (q0 > 0);", "path"),
    "flashmask bwd dk/dv: a partial tile treated as full": (
        "flash_bwd_sm90.cuh", "void dkv_consume(",
        "const bool partial = cls == kPartialTile;",
        "const bool partial = false;", "causal_n1_docs"),
    "flashmask bwd dk/dv: the group loop stops one query head short": (
        "flash_bwd_sm90.cuh", "flash_bwd_dkv_sm90_kernel(", "h1 = h0 + p.g;",
        "h1 = h0 + p.g - 1;", "causal_n2_per_head_s1000_gqa"),
    "varlen: each q tile's first kv tile skipped": (
        "varlen_flash.cu", "struct Varlen", "return qrange[q0 / kTile] / kTile;",
        "return qrange[q0 / kTile] / kTile + 1;", "varlen full_docs_t1000_f32_d64"),
    "varlen: the segment test's upper bound dropped": (
        "varlen_flash.cu", "struct Varlen", "row >= k.lo && row < k.hi",
        "row >= k.lo", "varlen path"),
    "varlen fwd: a partial tile read as full": (
        "varlen_flash.cu", "int tile_class(", "return c;",
        "return c == kPartialTile ? kFullTile : c;", "varlen path"),
    "varlen classes: the last kv tile full past Tk": (
        "varlen_flash.cu", "varlen_classes_kernel(",
        "bool full = lo_max <= r0 && r1 <= hi_min && !pad;",
        "bool full = lo_max <= r0 && r1 <= hi_min;", "varlen cross_causal_gqa"),
    "varlen fwd: the loop ends one kv tile short": (
        "varlen_flash.cu", "int kv_tiles(const Problem&, int q0, int bm, int bn)",
        "return (end + bn - 1) / bn;", "return (end + bn - 1) / bn - 1;",
        "varlen path"),
    "varlen dk/dv: a CTA's q steps end at its first 64 keys' range": (
        "varlen_flash.cu", "int q_tiles(const Problem&, int k0, int bn)",
        "t < min((k0 + bn) / kTile, n_kt);", "t < min(k0 / kTile + 1, n_kt);",
        "varlen cross_causal_gqa"),
    "varlen dk/dv: each key tile's first q step one step late": (
        "varlen_flash.cu", "int first_q_tile(", "return krange[k0 / kTile] / kTile;",
        "return krange[k0 / kTile] / kTile + 1;", "varlen path"),
    "norm fwd: the cross-warp sum drops the group's last warp": (
        "fused_norm.cu", "float group_sum(", "w < gw;", "w < gw - 1;",
        "norm 8192x2048 ln float32"),
    "norm fwd: the scalar tail skipped": (
        "fused_norm.cu", "the scalar tail",
        "v[j][e] = c0 + e < n ? ptt::to_f32(xr[c0 + e]) : 0.f;",
        "v[j][e] = 0.f;", "norm 37x1031 ln float32"),
    "norm dx: the paired exchange drops the group's last warp": (
        "fused_norm.cu", "float2 group_sum2(", "w < gw;", "w < gw - 1;",
        "norm_dx 8192x2048 ln float32"),
    "norm dx: the prefetched row's dy taken from the current row": (
        "fused_norm.cu", "the next row's loads go out before",
        "load_dx_row<T, kLN>(x, dy, rstd_in, mean_in, r + stride",
        "load_dx_row<T, kLN>(x, dy - stride * n, rstd_in, mean_in, r + stride",
        "norm_dx 8192x4096 rms float32"),
    "norm dx: the scalar tail skipped": (
        "fused_norm.cu", "void load_dx_row(", "const bool in = c0 + e < n;",
        "const bool in = false;", "norm_dx 37x1031 ln float32"),
    "grouped_gemm: a partly live tile treated as dead": (
        "grouped_gemm_sm90.cuh", "bool unit_live(", "return sizes[g] > off;",
        "return sizes[g] >= off + kGgUnit;", "grouped_gemm partial_tiles"),
    "grouped_gemm: a tile's second 64-row unit takes the first one's liveness": (
        "grouped_gemm_sm90.cuh", "GgTile gg_tile(",
        "unit_live(p.sizes, x.g, x.r0 + kGgUnit)", "unit_live(p.sizes, x.g, x.r0)",
        "grouped_gemm partial_tiles"),
    "dense decode: the combine drops a chunk's rescale exp(m_i - M)": (
        "dense_decode.cu", "float chunk_weight(", "return expf(m - top);",
        "return 1.f;", "dense_decode mmha_g1"),
    "dense decode: a chunk's valid tokens counted to S_max, not the length": (
        "dense_decode.cu", "decode_split_kernel(",
        "const int nv = min(chunk, length - c0);",
        "const int nv = min(chunk, s_max - c0);", "dense_decode odd_s_max_d64"),
    "paged decode: the combine drops a chunk's rescale exp(m_i - M)": (
        "decode_attention.cu", "float chunk_weight(", "return expf(m - top);",
        "return 1.f;", "paged_decode path_g1"),
    "paged decode: a live chunk of -1 pages exits without arriving": (
        "decode_attention.cu", "paged_split_kernel(",
        "if (loaded) sm90::mbar_wait(&bars[0], phase);",
        "if (!loaded) return;\n    sm90::mbar_wait(&bars[0], phase);",
        "paged_decode hole_chunk"),
    "paged decode: the last chunk to arrive leaves its counter set": (
        "decode_attention.cu", "paged_split_kernel(",
        "if (tid == 0) *arrived = 0;", "", "paged_decode path_g1"),
    "paged decode int8: probabilities take the chunk's first page's v_scale": (
        "decode_attention.cu", "paged_split_kernel(",
        "const float vsc = kQ8 ? vs_s[s] : 1.f;",
        "const float vsc = kQ8 ? vs_s[0] : 1.f;", "paged_decode_q8 path_g1"),
    "rope: the neox second half read one vector late": (
        "fused_rope.cu", "void load_head(", "(kIL ? V : a.half)",
        "(kIL ? V : a.half + V)", "rope train_neox"),
    "rope: the table row taken as 0 with a table per row": (
        "fused_rope.cu", "rope_kernel(const RopeArgs a)",
        "a.table_b > 1 ? r : r % a.S", "r % a.S", "rope decode_per_row"),
    "rope: the head chunk's start off by one where it crosses from q into k": (
        "fused_rope.cu", "the chunk crosses into the next tensor", "h = 0;",
        "h = 1;", "rope train_neox"),
}


def _fault_violations(torch, case):
    """Phase 2's violations at a fault's case ("flash <FLASH_CASES name>",
    "varlen <VARLEN_CASES name>", "grouped_gemm <GG_CASES name>",
    "dense_decode <DENSE_CASES name>", "paged_decode <PAGED_FULL name>" or
    "paged_decode_q8 <PAGED_Q8 name>" in bf16, "norm <R>x<N> <kind>
    <dtype>", "norm_dx <R>x<N> <kind> <dtype>", "rope <ROPE_CASES name>",
    or a FLASHMASK_CASES name), run on
    the library load_library() holds."""
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import grouped_gemm as gg
    from paddle_tpu_torch.ops import masked_flash as mf

    kind, _, name = case.partition(" ")
    if kind == "rope":
        from paddle_tpu_torch.ops import fused_rope as fr

        gen = torch.Generator(device="cuda").manual_seed(8)
        return _rope_violations(torch, fr, name,
                                *_rope_inputs(torch, gen, name))[1]
    if kind in ("paged_decode", "paged_decode_q8"):
        da._ARRIVALS.clear()  # counters a fault left set go with it
        args = _paged_inputs(torch, name, "bfloat16", kind == "paged_decode_q8")[0]
        bad = _paged_violations(torch, da, args, "bfloat16")[0]
        da._ARRIVALS.clear()
        return bad
    if kind == "norm":
        from paddle_tpu_torch.ops import fused_norm as fn

        shape, norm_kind, dtype = name.split()
        R, N = (int(s) for s in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(0)
        x, w, bias = _norm_inputs(torch, gen, R, N, norm_kind, dtype)
        return _norm_errors(fn, torch, x, w, bias, norm_kind, dtype)[2]
    if kind == "norm_dx":
        from paddle_tpu_torch.ops import fused_norm as fn

        shape, norm_kind, dtype = name.split()
        R, N = (int(s) for s in shape.split("x"))
        gen = torch.Generator(device="cuda").manual_seed(2)
        x, w, _, dy, rstd, mu = _norm_dx_inputs(torch, fn, gen, R, N,
                                                norm_kind, dtype)
        return _norm_dx_violations(fn, torch, x, w, dy, rstd, mu, norm_kind,
                                   dtype)[1]
    if kind == "flash":
        B, Sq, Skv, H, Hkv, D, causal, bias, dtype = FLASH_CASES[name]
        gen = torch.Generator(device="cuda").manual_seed(3)
        q, k, v, dout, kb, _ = _flash_inputs(
            torch, gen, B, Sq, Skv, H, Hkv, D, bias, dtype,
            FLASH_LAYOUTS.get(name, "contiguous"))
        got, plain, _ = _flash_outputs(fa, q, k, v, dout, kb, causal,
                                       D ** -0.5)
    elif kind == "varlen":
        gen = torch.Generator(device="cuda").manual_seed(13)
        q, k, v, dout, layout, _, _, causal, dtype = _varlen_inputs(
            torch, gen, name)
        got, plain, _ = _varlen_outputs(
            mf, q, k, v, dout, layout, causal, q.shape[-1] ** -0.5,
            _varlen_classes(mf, torch, q, k, layout, causal))
        return _varlen_class_violations(
            torch, mf, name, layout, q.shape[0], k.shape[0], causal
        ) + _flash_violations(_flash_errs(got, plain), dtype)
    elif kind == "grouped_gemm":
        gen = torch.Generator(device="cuda").manual_seed(11)
        lhs, rhs, sz = _gg_inputs(torch, gen, name, None)
        trans = GG_CASES[name][5]
        out = gg.grouped_gemm(lhs, rhs, sz, trans)
        ref = gg.grouped_matmul_plain(lhs, rhs, sz, gg.BM, trans)
        return _gg_violations(gg, torch, name, out, ref, sz)[0]
    elif kind == "dense_decode":
        gen = torch.Generator(device="cuda").manual_seed(5)
        q, kc, vc, lens = _dense_inputs(torch, gen, name, "bfloat16")
        out = da.dense_decode_attention(q, kc, vc, lens)
        ref = da.dense_decode_attention_plain(q, kc, vc, lens, q.shape[-1] ** -0.5)
        return _dense_violations(torch, name, "bfloat16", out, ref)[0]
    else:
        gen = torch.Generator(device="cuda").manual_seed(9)
        q, k, v, dout, idx, causal, dtype = _flashmask_inputs(torch, gen, case)
        got, plain, _ = _flashmask_outputs(
            mf, q, k, v, dout, idx, causal, q.shape[-1] ** -0.5,
            _flashmask_classes(mf, torch, q, idx, causal))
    return _flash_violations(_flash_errs(got, plain), dtype)


def planted_kernel_faults(card, torch):
    """The attention, grouped-GEMM, dense-decode and norm limits must fail
    faulty kernels: for each fault of KERNEL_FAULTS, the kernels are built again
    from a copy of csrc/ (in a temporary directory, all builds in parallel)
    with the fault planted, and held at its case against the plain versions
    with phase 2's limits."""
    import pathlib
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import decode_attention as da

    sound = _build.load_library()
    passed = []
    with tempfile.TemporaryDirectory() as tmp:
        csrcs = {}
        for i, (fault, (fname, anchor, old, new, _)) in enumerate(
                KERNEL_FAULTS.items()):
            csrc = pathlib.Path(tmp) / str(i) / "csrc"
            shutil.copytree(_build.CSRC, csrc)
            src = csrc / fname
            text = src.read_text()
            at = text.index(old, text.index(anchor))
            src.write_text(text[:at] + new + text[at + len(old):])
            csrcs[fault] = csrc
        t0 = time.perf_counter()
        with ThreadPoolExecutor(len(csrcs)) as pool:
            libs = dict(zip(csrcs, pool.map(
                lambda c: _build.build_library(c, c.parent / "build",
                                               _build.BUILD_DIR / "obj"),
                csrcs.values())))
        say(card, f"planted kernel faults: {len(libs)} builds in "
                  f"{time.perf_counter() - t0:.2f} s")
        try:
            for fault, lib in libs.items():
                # the wrappers launch from the library load_library() holds
                _build._LIB = _build.open_library(lib)
                case = KERNEL_FAULTS[fault][4]
                bad = _fault_violations(torch, case)
                say(card, "planted kernel fault " + json.dumps(
                    {"fault": fault, "case": case, "failed": bool(bad),
                     "violations": bad}))
                if not bad:
                    passed.append(fault)
                torch.cuda.empty_cache()
        finally:
            _build._LIB = sound
            da._ARRIVALS.clear()
    if passed:
        raise AssertionError(f"the kernel limits pass faulty kernels: {passed}")


# Per-CTA clocks (phase 2c): the varlen dQ and dK/dV kernels rebuilt from a
# copy of csrc/ in which thread 0 of each CTA stamps %globaltimer at its
# start and end, with its %smid, and an entry point that copies the stamps
# out. CTA_CLOCK_ORDERS: the dK/dV CTAs' order as built (the policy's
# `key_tile`) and in key-tile order (`key_tile` returning z).
CTA_CLOCK_STAMP = """
__device__ unsigned long long g_cta_clock[4 * 8192];
__device__ __forceinline__ void cta_clock(int slot) {
  if (threadIdx.x != 0) return;
  unsigned long long t;
  unsigned sm;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  const int cta = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z);
  g_cta_clock[4 * cta + slot] = t;
  if (slot == 0) g_cta_clock[4 * cta + 2] = sm;
}
"""
CTA_CLOCK_ORDERS = {
    "by class count": None,
    "by key tile": ("int key_tile(int z) const { return order[z]; }",
                    "int key_tile(int z) const { return z; }"),
}


def _stamped_csrc(csrc, order):
    """csrc/ with the sm90 backward's CTAs stamped (CTA_CLOCK_STAMP) and
    `ptt_cta_clocks(out, n)` in varlen_flash.cu; `order` an (old, new)
    replacement in varlen_flash.cu or None."""
    f = csrc / "flash_bwd_sm90.cuh"
    s = f.read_text()
    s = s.replace("constexpr int kStep = 64;", CTA_CLOCK_STAMP + "constexpr int kStep = 64;", 1)
    for kern, call in (("flash_bwd_dq_sm90_kernel(", "  dq_consume<DT>("),
                       ("flash_bwd_dkv_sm90_kernel(", "  dkv_consume<DT>(")):
        at = s.index("  using L = ", s.index(kern))
        s = s[:at] + "  cta_clock(0);\n" + s[at:]
        end = s.index(";\n", s.index(call, at)) + 2
        s = s[:end] + "  __syncthreads();\n  cta_clock(1);\n" + s[end:]
    f.write_text(s)
    v = csrc / "varlen_flash.cu"
    s = v.read_text()
    if order:
        if order[0] not in s:
            raise RuntimeError(f"varlen_flash.cu has no {order[0]!r} to replace")
        s = s.replace(order[0], order[1], 1)
    v.write_text(s + """
extern "C" int ptt_cta_clocks(void* out, int n) {
  return cudaMemcpyFromSymbol(out, sm90::g_cta_clock, n * sizeof(unsigned long long));
}
""")


def _greedy(durations, n_sm):
    """The makespan of CTAs of these durations dispatched in this order,
    each to the SM that frees first (one CTA an SM)."""
    free = np.zeros(n_sm)
    for d in durations:
        free[free.argmin()] += d
    return float(free.max())


def varlen_cta_clocks(card, torch):
    """Phase 2c: per-CTA clocks of the varlen dQ and dK/dV at the path's
    shape, for each order of CTA_CLOCK_ORDERS: the span from the first
    CTA's start to the last one's end, the SMs' busy share of it, the mean
    time an SM sits idle at the end, and the measured durations replayed
    on the card's SMs in launch order and longest first (what any order
    could reach) beside their sum over the SMs (no idle time)."""
    import ctypes
    import pathlib
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from paddle_tpu_torch.ops import _build
    from paddle_tpu_torch.ops import masked_flash as mf

    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, dout, layout, _, _, causal, _ = _varlen_inputs(torch, gen, "path")
    scale = q.shape[-1] ** -0.5
    cls = _varlen_classes(mf, torch, q, k, layout, causal)
    out, lse = mf.varlen_fwd_plain(q, k, v, layout, causal, scale)
    delta = (dout.float() * out.float()).sum(-1).transpose(0, 1).contiguous()
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    n_kt = -(-k.shape[0] // 128)
    runs = {
        "dkv": (lambda: mf.varlen_bwd_dkv(q, k, v, layout, dout, lse, delta,
                                          causal, scale, cls), k.shape[1] * n_kt),
        "dq": (lambda: mf.varlen_bwd_dq(q, k, v, layout, dout, lse, delta,
                                        causal, scale, cls),
               q.shape[1] * -(-q.shape[0] // 128)),
    }
    sound = _build.load_library()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            csrcs = {}
            for i, (name, order) in enumerate(CTA_CLOCK_ORDERS.items()):
                csrc = pathlib.Path(tmp) / str(i) / "csrc"
                shutil.copytree(_build.CSRC, csrc)
                _stamped_csrc(csrc, order)
                csrcs[name] = csrc
            with ThreadPoolExecutor(len(csrcs)) as pool:
                libs = dict(zip(csrcs, pool.map(
                    lambda c: _build.build_library(c, c.parent / "build",
                                                   _build.BUILD_DIR / "obj"),
                    csrcs.values())))
            for name, lib in libs.items():
                _build._LIB = _build.open_library(lib)
                _build._LIB.ptt_cta_clocks.argtypes = [ctypes.c_void_p, ctypes.c_int]
                for kernel, (fn, n_cta) in runs.items():
                    if kernel == "dq" and name != "by class count":
                        continue  # the order is dK/dV's alone
                    spans, r = [], None
                    for _ in range(4):
                        fn()
                        torch.cuda.synchronize()
                        buf = (ctypes.c_ulonglong * (4 * n_cta))()
                        _build.check(_build._LIB.ptt_cta_clocks(buf, 4 * n_cta),
                                     "ptt_cta_clocks")
                        r = np.frombuffer(buf, dtype=np.uint64).reshape(
                            n_cta, 4)[:, :3].astype(np.int64)
                        spans.append(float(r[:, 1].max() - r[:, 0].min()) / 1e3)
                    start, end = r[:, 0] - r[:, 0].min(), r[:, 1] - r[:, 0].min()
                    dur, span = end - start, float(end.max())
                    last = np.array([end[r[:, 2] == i].max()
                                     for i in np.unique(r[:, 2])])
                    say(card, f"cta clocks varlen {kernel} {name} " + json.dumps({
                        "ctas": n_cta, "sms": int(len(last)),
                        "span_us": spans, "busy_share": float(dur.sum()) / (n_sm * span),
                        "mean_idle_tail_us": float((span - last).mean()) / 1e3,
                        "cta_us": {"min": float(dur.min()) / 1e3,
                                   "median": float(np.median(dur)) / 1e3,
                                   "max": float(dur.max()) / 1e3},
                        "replay_launch_order_us": _greedy(dur, n_sm) / 1e3,
                        "replay_longest_first_us": _greedy(np.sort(dur)[::-1], n_sm) / 1e3,
                        "no_idle_us": float(dur.sum()) / n_sm / 1e3}))
    finally:
        _build._LIB = sound
    del q, k, v, dout, out
    torch.cuda.empty_cache()


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


def serve(card, torch, which="gpt3_1p3b"):
    """`which` ("gpt3_1p3b" or "llama_7b") at full width and depth in bf16,
    random weights from seed 0, through inference.create_serving_engine
    (paged, 16 rows, 512 tokens, page size 32) over 12 requests of the
    serving mix, 16 new tokens each. Counters zeroed just before and read
    just after: every norm ((prefills + ticks) x (2L + 1)), every decode
    attention (ticks x L) and, with RoPE, every rotation ((prefills +
    ticks) x L) went through its kernel, and no other kernel ran (prefill
    attention is the composite). For llama_7b, model.generate on one greedy
    prompt of the mix is held against the engine: in bf16 by the first
    decode step's logits (`generate_against_engine`), in f32 at full depth
    by its tokens (`generate_f32_full_depth`). A profile of five
    full-batch decode ticks comes between the two."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM

    cfg = getattr(models, which)()
    B, S, ps, n_req, max_new = 16, 512, 32, 12, 16
    t0 = time.perf_counter()
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    say(card, f"serve: {which} bf16, {n_params} parameters, "
              f"{_state_bytes(model)} bytes, built in "
              f"{time.perf_counter() - t0:.3f} s")

    # warm-up engine (cuBLAS handles, allocator): one short request
    warm = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                 page_size=ps)
    warm.add_request(np.arange(1, 9, dtype=np.int32), max_new_tokens=2)
    warm.run()
    del warm

    eng = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                page_size=ps, seed=0)
    workload = serving_workload(cfg.vocab_size, S, n_req)
    for prompt, temp in workload:
        eng.add_request(prompt, max_new_tokens=max_new, temperature=temp)
    torch.cuda.synchronize()
    _zero_counters()
    t_start = time.perf_counter()
    peak_used = 0
    while eng.has_work():
        eng.step()
        peak_used = max(peak_used, eng.pool.pages_total - eng.pool.pages_free)
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t_start
    launches = _counters()

    done = eng.finished
    m = eng.metrics
    decode_ticks = m["step_seconds"].count(engine="paged")
    L = cfg.num_layers
    want = _expected(fused_norm=(n_req + decode_ticks) * (2 * L + 1),
                     paged_decode_attention=decode_ticks * L,
                     fused_rope=(n_req + decode_ticks) * L if cfg.use_rope
                     else 0)
    if len(done) != n_req or any(len(r.generated) != max_new for r in done):
        raise AssertionError(f"serve {which}: not every request finished with "
                             f"{max_new} tokens")
    if not torch.isfinite(eng.last_logits.float()).all():
        raise AssertionError(f"serve {which}: non-finite logits")
    if launches != want:
        raise AssertionError(f"serve {which}: kernel launches {launches}, "
                             f"expected {want}")
    tokens = m["tokens"].value(engine="paged")
    ttft = m["ttft"].values(engine="paged")
    steps = m["step_seconds"].values(engine="paged")
    line = {
        "model": which, "dtype": "bfloat16", "batch": B,
        "max_seq_len": S, "page_size": ps, "requests": len(done),
        "tokens": tokens, "seconds": total_s, "tokens_per_s": tokens / total_s,
        "ttft_p50_s": float(np.percentile(ttft, 50)),
        "step_p99_s": float(np.percentile(steps, 99)),
        "decode_ticks": decode_ticks, "pages_total": eng.pool.pages_total,
        "kv_bytes_per_token": eng.pool.bytes_per_token,
        "peak_pages_used": peak_used, "page_allocs": eng.pool.allocs_total,
        "prefix_hits": m["prefix_hits"].value(),
        "preemptions": m["preemptions"].value(), "launches": launches,
    }
    say(card, f"serve {which} (smoke run, not a benchmark) " + json.dumps(line))
    del eng
    torch.cuda.empty_cache()
    if cfg.use_rope:
        by_prompt = {tuple(r.prompt): r.generated for r in done}
        prompt = next(p for p, temp in workload if temp == 0.0)
        generate_against_engine(card, torch, model, prompt, max_new,
                                by_prompt[tuple(prompt)], which,
                                create_serving_engine(model, max_batch_size=B,
                                                      max_seq_len=S,
                                                      page_size=ps, seed=0))
    profile_decode(card, torch, model, B, S, label=f"paged {which}",
                   page_size=ps)
    del model
    torch.cuda.empty_cache()
    if cfg.use_rope:
        generate_f32_full_depth(card, torch, cfg, prompt, max_new, which)
    return launches


def generate_f32_full_depth(card, torch, cfg, prompt, max_new, which):
    """`generate` against the paged engine at full width and depth in f32
    (TF32 off), where the two paths differ by f32 rounding only: on the
    greedy prompt of the serve phase the tokens must be identical (a
    one-row engine: its pages are 34 MB each in f32)."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=0)
    ps = 32
    S = -(-(len(prompt) + max_new + 1) // ps) * ps
    eng = create_serving_engine(model, max_batch_size=1, max_seq_len=S,
                                page_size=ps, seed=0)
    rid = eng.add_request(prompt, max_new_tokens=max_new)
    engine_tokens = {r.req_id: r.generated for r in eng.run()}[rid]
    del eng
    torch.cuda.empty_cache()
    gen = model.generate(prompt[None], max_new_tokens=max_new,
                         temperature=0.0)[0, len(prompt):].tolist()
    same = gen == engine_tokens
    say(card, f"generate {which} f32 " + json.dumps({
        "layers": cfg.num_layers, "prompt_tokens": len(prompt),
        "new_tokens": max_new, "tokens_identical_to_engine": same,
        "tokens": gen, "engine_tokens": engine_tokens}))
    del model
    torch.cuda.empty_cache()
    if not same:
        raise AssertionError(f"generate {which} f32: greedy tokens differ from "
                             "the paged engine's")


def generate_against_engine(card, torch, model, prompt, max_new, engine_tokens,
                            which, eng):
    """bf16 `generate` against the paged engine on one greedy prompt:
    the greedy tokens of both (printed: see BF16_DECODE_LOGIT_RTOL), and
    the logits of the first decode step, held to BF16_DECODE_LOGIT_RTOL of
    their norm: `eng` (a fresh engine; its decode step is [B, 1] whatever
    the live rows, so the prompt's row computes what it computed in the
    full mix) admits the prompt alone and runs one tick; generate's path
    (a prefill into f32 caches, one decode step at the prompt's length) is
    replayed through the model's own calls, fed the engine's first token
    so that both decode the same input."""
    t0 = time.perf_counter()
    gen = model.generate(prompt[None], max_new_tokens=max_new,
                         temperature=0.0)[0, len(prompt):].tolist()
    gen_s = time.perf_counter() - t0
    diverge = next((i for i, (a, b) in enumerate(zip(gen, engine_tokens))
                    if a != b), None)
    rid = eng.add_request(prompt, max_new_tokens=3)
    eng.step()  # admission (the first token) and the first decode tick
    row = next(i for i, r in enumerate(eng.active) if r is not None
               and r.req_id == rid)
    first = eng.active[row].generated[0]
    with torch.no_grad():
        ids = torch.as_tensor(prompt, device="cuda").long()[None]
        n = ids.shape[1]
        caches = model.init_kv_caches(1, n + max_new, dtype=torch.float32)
        model(ids, torch.arange(n, device="cuda")[None], caches, 0)
        logits, _ = model(torch.full((1, 1), first, device="cuda"),
                          torch.full((1, 1), n, device="cuda"), caches, n)
    lg, le = logits[0, -1].float(), eng.last_logits[row].float()
    rel = ((lg - le).norm() / le.norm()).item()

    def gap(x):
        top = x.topk(2).values
        return (top[0] - top[1]).item()

    say(card, f"generate {which} " + json.dumps({
        "prompt_tokens": len(prompt), "new_tokens": max_new,
        "seconds": gen_s, "tokens_identical_to_engine": diverge is None,
        "first_divergence": diverge, "tokens": gen,
        "engine_tokens": engine_tokens,
        "first_token_identical": gen[0] == first,
        "first_decode_logit_rel_diff": rel,
        "first_decode_max_abs_logit_diff": (lg - le).abs().max().item(),
        "rtol": BF16_DECODE_LOGIT_RTOL,
        "first_decode_top2_gap_generate": gap(lg),
        "first_decode_top2_gap_engine": gap(le)}))
    if not rel <= BF16_DECODE_LOGIT_RTOL:
        raise AssertionError(f"generate {which}: the first decode step differs "
                             "from the paged engine's beyond bf16 rounding")


def profile_decode(card, torch, model, B, S, ticks=5, label="paged",
                   **engine_kw):
    """Where a decode tick's time goes: torch.profiler over `ticks` decode
    ticks of a full batch (B live rows, 16-token prompts; the admission
    tick is left out) of the engine `create_serving_engine(model,
    **engine_kw)` builds. Prints the wall time per tick, the device-busy
    time per tick (the sum of device activity; one stream, so nothing
    overlaps), the kernels that take the most device time, and every
    kernel of the port (PORT_KERNEL) with its time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from paddle_tpu_torch.inference import create_serving_engine

    eng = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                seed=0, **engine_kw)
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
    ranked = sorted(events, key=dev_us, reverse=True)

    def rows(evs):
        return [{"name": e.key[:80], "ms_per_tick": dev_us(e) / 1e3 / ticks,
                 "calls_per_tick": e.count / ticks} for e in evs]

    say(card, "decode tick profile " + json.dumps({
        "engine": label, "rows": B, "ticks": ticks, "wall_ms_per_tick": wall * 1e3 / ticks,
        "device_busy_ms_per_tick": busy_us / 1e3 / ticks,
        "device_busy_share": busy_us / 1e6 / wall if wall > 0 else None,
        "top_device_kernels": rows(ranked[:8]),
        "port_kernels": rows(e for e in ranked if PORT_KERNEL.search(e.key))}))


# --------------------------------------------------------------------------- #
# phase 4: the same engine on the card (kernels) and on the CPU (plain)
# --------------------------------------------------------------------------- #


def hold(card, torch, which="gpt3_1p3b"):
    """The paged engine on the card (kernels) and on the CPU (plain
    versions): `which` ("gpt3_1p3b" or "llama_7b") at its full width and 2
    layers, f32 with TF32 off, four greedy requests of the mix; identical
    tokens and first-decode-tick logits within HOLD_LOGIT_TOL, and
    `generate` on the card (dense f32 caches, the flash kernel at Sq = 1)
    gives the card engine's tokens."""
    from paddle_tpu_torch import models
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(getattr(models, which)(), num_layers=2)
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
    # generate on the card (dense f32 caches, the flash kernel at Sq = 1)
    # gives the card engine's tokens
    gen = [gpu.generate(p[None], max_new_tokens=8, temperature=0.0)[
        0, len(p):].tolist() for p in prompts]
    gen_same = gen == results["cuda"][1]
    say(card, f"hold {which} " + json.dumps({
        "model": f"{which} width, 2 layers", "dtype": "float32",
        "first_tick_max_abs_logit_diff": diff, "tol": HOLD_LOGIT_TOL,
        "tokens_identical": same, "generate_tokens_identical": gen_same,
        "tokens_cuda": results["cuda"][1]}))
    if not (diff <= HOLD_LOGIT_TOL and same and gen_same):
        raise AssertionError(f"hold {which}: the card's engine disagrees with "
                             "the CPU's")


# --------------------------------------------------------------------------- #
# phase 4b-4e: the rest of serving (int8, dense engine, generate, MMHA)
# --------------------------------------------------------------------------- #


def _state_bytes(model):
    return sum(t.numel() * t.element_size() for t in model.state_dict().values())


def _drain(torch, eng, workload, max_new):
    """Add the workload, drain the engine with the launch counters zeroed
    just before and read just after. Returns (finished requests, seconds,
    peak live rows, launches)."""
    for prompt, temp in workload:
        eng.add_request(prompt, max_new_tokens=max_new, temperature=temp)
    torch.cuda.synchronize()
    _zero_counters()
    t0 = time.perf_counter()
    peak = 0
    while eng.has_work():
        eng.step()
        peak = max(peak, sum(r is not None for r in eng.active))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = _counters()
    done = eng.finished
    if len(done) != len(workload) or any(len(r.generated) != max_new
                                         for r in done):
        raise AssertionError(f"{eng.engine_label}: not every request finished "
                             f"with {max_new} tokens")
    if not torch.isfinite(eng.last_logits.float()).all():
        raise AssertionError(f"{eng.engine_label}: non-finite logits")
    return done, seconds, peak, launches


def _serve_line(eng, done, seconds, peak, launches):
    m = eng.metrics
    lab = eng.engine_label
    tokens = m["tokens"].value(engine=lab)
    return {"requests": len(done), "tokens": tokens, "seconds": seconds,
            "tokens_per_s": tokens / seconds,
            "ttft_p50_s": float(np.percentile(m["ttft"].values(engine=lab), 50)),
            "step_p99_s": float(np.percentile(
                m["step_seconds"].values(engine=lab), 99)),
            "decode_ticks": m["step_seconds"].count(engine=lab),
            "peak_concurrency": peak, "launches": launches}


def serve_quant(card, torch):
    """bench.py's serving_quant A/B on gpt3_1p3b bf16 with the rung's own
    settings: B 16, S 512, page size 32, the serving mix of 64 requests, 32
    new tokens each, an equal KV budget of (B*S)/(2*ps) bf16 pages. Leg A:
    bf16 pages; leg B: kv_quant (int8 pages) and serve_w8 (int8 weights).
    Each leg must launch only its own paged decode kernel, ticks x 24
    times, and the norm kernel (requests + ticks) x 49 times; leg B must
    hold >= 1.9x the pages and no less peak concurrency."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.inference.paged import BlockPool
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b

    cfg = gpt3_1p3b()
    B, S, ps, n_req, max_new = 16, 512, 32, 64, 32
    L = cfg.num_layers
    budget = (B * S) // (2 * ps) * BlockPool.page_nbytes(
        L, cfg.kv_heads, cfg.head_dim, ps, torch.bfloat16)
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    workload = serving_workload(cfg.vocab_size, S, n_req)
    legs = {}
    for leg, quant in (("A_bf16", False), ("B_int8_w8", True)):
        w_before = _state_bytes(model)
        eng = create_serving_engine(model, max_batch_size=B, max_seq_len=S,
                                    page_size=ps, seed=0, kv_quant=quant,
                                    serve_w8=quant, kv_budget_bytes=budget)
        w_after = _state_bytes(model)
        done, seconds, peak, launches = _drain(torch, eng, workload, max_new)
        line = _serve_line(eng, done, seconds, peak, launches)
        ticks = line["decode_ticks"]
        decode = ("paged_decode_attention_q8" if quant
                  else "paged_decode_attention")
        want = _expected(fused_norm=(n_req + ticks) * (2 * L + 1),
                         **{decode: ticks * L})
        line.update({
            "kv_budget_bytes": budget, "pages_total": eng.pool.pages_total,
            "bytes_per_page": eng.pool.bytes_per_page,
            "kv_bytes_per_token": eng.pool.bytes_per_token,
            "preemptions": eng.metrics["preemptions"].value(),
            "weight_bytes_before": w_before, "weight_bytes_after": w_after,
            "kv_dtype": str(eng.pool.kv[0][0].dtype)})
        say(card, f"serve_quant leg {leg} (smoke run, not a benchmark) "
                  + json.dumps(line))
        if launches != want:
            raise AssertionError(f"serve_quant {leg}: kernel launches "
                                 f"{launches}, expected {want}")
        legs[leg] = line
        del eng
        torch.cuda.empty_cache()
        if quant:
            profile_decode(card, torch, model, B, S, label="paged int8+w8",
                           page_size=ps, kv_quant=True, serve_w8=True)
    total = {k: legs["A_bf16"]["launches"][k] + legs["B_int8_w8"]["launches"][k]
             for k in legs["A_bf16"]["launches"]}
    a, b = legs["A_bf16"], legs["B_int8_w8"]
    ratio = b["pages_total"] / a["pages_total"]
    say(card, "serve_quant A/B " + json.dumps({
        "pages_ratio": ratio, "peak_concurrency": [a["peak_concurrency"],
                                                   b["peak_concurrency"]],
        "tokens_per_s": [a["tokens_per_s"], b["tokens_per_s"]]}))
    if not (ratio >= 1.9 and b["peak_concurrency"] >= a["peak_concurrency"]):
        raise AssertionError("serve_quant: the int8 leg must hold >= 1.9x the "
                             "pages and no less peak concurrency")
    del model
    torch.cuda.empty_cache()
    return total


def _teacher_forced_margins(torch, model, prompt, tokens):
    """`model.generate`'s greedy steps fed `tokens` instead of its own
    picks (its calls: a prefill into f32 caches, then one decode step a
    token): per step, how far tokens[i]'s logit lies below the top one, in
    bf16 steps of the top logit, and whether that is within
    BF16_TIE_ULPS."""
    was_training = model.training
    model.eval()
    steps = []
    with torch.no_grad():
        ids = torch.as_tensor(prompt, device="cuda").long()[None]
        n = ids.shape[1]
        caches = model.init_kv_caches(1, n + len(tokens), dtype=torch.float32)
        logits, _ = model(ids, torch.arange(n, device="cuda")[None], caches,
                          0)
        for i, tok in enumerate(tokens):
            if i:
                logits, _ = model(
                    torch.full((1, 1), tokens[i - 1], device="cuda"),
                    torch.full((1, 1), n + i - 1, device="cuda"), caches,
                    n + i - 1)
            row = logits[0, -1].float()
            top = row.max().item()
            ulp = 2.0 ** (math.floor(math.log2(max(abs(top), 1e-30))) - 7)
            below = (top - row[tok].item()) / ulp
            steps.append({"token": tok, "argmax": int(row.argmax()),
                          "bf16_steps_below_top": below,
                          "ok": below <= BF16_TIE_ULPS})
    model.train(was_training)
    return steps


def serve_dense(card, torch):
    """gpt3_1p3b bf16 through create_serving_engine(paged=False) (16 slots of
    512 tokens) over the 12-request mix of phase 3: every decode attention
    goes through the flash forward kernel at Sq = 1 (ticks x 24) and every
    LayerNorm through the norm kernel ((requests + ticks) x 49). Then
    model.generate runs one greedy prompt of the mix, and fed the engine's
    tokens it must rank each of them first or within a bf16 tie of first
    (BF16_TIE_ULPS), at every step."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b

    cfg = gpt3_1p3b()
    B, S, n_req, max_new = 16, 512, 12, 16
    L = cfg.num_layers
    model = GPTForCausalLM(cfg, device="cuda", dtype=torch.bfloat16, seed=0)
    workload = serving_workload(cfg.vocab_size, S, n_req)
    eng = create_serving_engine(model, paged=False, max_batch_size=B,
                                max_seq_len=S, seed=0)
    done, seconds, peak, launches = _drain(torch, eng, workload, max_new)
    line = _serve_line(eng, done, seconds, peak, launches)
    ticks = line["decode_ticks"]
    want = _expected(fused_norm=(n_req + ticks) * (2 * L + 1),
                     flash_fwd=ticks * L)
    say(card, "serve_dense (smoke run, not a benchmark) " + json.dumps(line))
    if launches != want:
        raise AssertionError(f"serve_dense: kernel launches {launches}, "
                             f"expected {want}")
    by_prompt = {tuple(r.prompt): r.generated for r in done}
    prompt = next(p for p, temp in workload if temp == 0.0)
    t0 = time.perf_counter()
    gen = model.generate(prompt[None], max_new_tokens=max_new,
                         temperature=0.0)[0, len(prompt):].tolist()
    seconds = time.perf_counter() - t0
    engine_tokens = by_prompt[tuple(prompt)]
    steps = _teacher_forced_margins(torch, model, prompt, engine_tokens)
    say(card, "generate " + json.dumps({
        "prompt_tokens": len(prompt), "new_tokens": max_new,
        "seconds": seconds, "tokens_identical_to_engine": gen == engine_tokens,
        "tokens": gen, "engine_tokens": engine_tokens,
        "teacher_forced": steps}))
    bad = [i for i, st in enumerate(steps) if not st["ok"]]
    if len(engine_tokens) != max_new or bad:
        raise AssertionError(
            f"generate: fed the dense engine's {len(engine_tokens)} tokens, "
            f"steps {bad} rank the engine's token more than {BF16_TIE_ULPS} "
            "bf16 steps below the top logit")
    del eng
    profile_decode(card, torch, model, B, S, label="dense", paged=False)
    del model
    torch.cuda.empty_cache()
    return launches


def mmha(card, torch):
    """32 decode steps of incubate masked_multihead_attention at the MMHA
    shape (B 16, 16 heads of 128, S_max 2048, bf16, start lengths spread
    over 0..2016, no src_mask): every step must launch the dense-cache
    kernel pair once and agree with the plain version on the updated cache."""
    from paddle_tpu_torch.incubate.nn.functional import (
        masked_multihead_attention,
    )
    from paddle_tpu_torch.ops import decode_attention as da

    B, H, D, S, steps = 16, 16, 128, 2048, 32
    gen = torch.Generator(device="cuda").manual_seed(7)
    cache = torch.randn(2, B, H, S, D, device="cuda", generator=gen).bfloat16()
    bias = (0.1 * torch.randn(3 * H * D, device="cuda", generator=gen)).bfloat16()
    start = np.linspace(0, S - steps, B).astype(np.int32)
    xs = [torch.randn(B, 3 * H * D, device="cuda", generator=gen).bfloat16()
          for _ in range(steps)]
    torch.cuda.synchronize()
    _zero_counters()
    worst = 0.0
    t0 = time.perf_counter()
    for t, x in enumerate(xs):
        seq = torch.tensor(start + t, device="cuda")
        out, cache = masked_multihead_attention(x, cache, bias=bias,
                                                sequence_lengths=seq)
        q = (x + bias).reshape(B, 3, H, D)[:, 0]
        ref = da.dense_decode_attention_plain(q, cache[0], cache[1], seq + 1,
                                              D ** -0.5)
        worst = max(worst, (out.float() - ref.reshape(B, H * D).float())
                    .abs().max().item())
    torch.cuda.synchronize()
    launches = _counters()
    say(card, "mmha " + json.dumps({
        "B": B, "H": H, "D": D, "S_max": S, "steps": steps, "dtype": "bfloat16",
        "max_abs_err": worst, "tol": DECODE_TOL["bfloat16"],
        "seconds_with_checks": time.perf_counter() - t0,
        "launches": launches}))
    if launches != _expected(dense_decode_attention=steps):
        raise AssertionError(f"mmha: kernel launches {launches}, expected "
                             f"{steps} dense-cache launches and no other")
    if not worst <= DECODE_TOL["bfloat16"]:
        raise AssertionError(f"mmha: max|err| {worst} against the plain version")
    return launches


def quant_hold(card, torch):
    """gpt3_1p3b width at 2 layers in f32 (TF32 off) with kv_quant and
    serve_w8: the same greedy requests through the paged engine on the card
    (kernels) and on the CPU (plain versions). Tokens identical, first-tick
    logits within QUANT_HOLD_LOGIT_TOL, int8 payloads within 1 of each
    other (the card's and the CPU's K/V differ by rounding, which can move
    a value across a rounding boundary of the quantizer)."""
    from paddle_tpu_torch.inference import create_serving_engine
    from paddle_tpu_torch.models import GPTForCausalLM, gpt3_1p3b

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(gpt3_1p3b(), num_layers=2)
    gpu = GPTForCausalLM(cfg, device="cuda", dtype=torch.float32, seed=1)
    cpu = GPTForCausalLM(cfg, device="cpu", dtype=torch.float32, seed=1)
    cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
    prompts = [p for p, _ in serving_workload(cfg.vocab_size, 128, 4)]
    res = {}
    for name, model in (("cuda", gpu), ("cpu", cpu)):
        eng = create_serving_engine(model, max_batch_size=4, max_seq_len=128,
                                    page_size=32, seed=0, kv_quant=True,
                                    serve_w8=True)
        ids = [eng.add_request(p, max_new_tokens=8) for p in prompts]
        eng.step()
        first = eng.last_logits.float().cpu()
        by = {r.req_id: r for r in eng.run()}
        pay = [t.cpu() for layer in eng.pool.kv for t in layer]
        res[name] = (first, [by[i].generated for i in ids], pay,
                     eng.pool.scales)
    diff = (res["cuda"][0] - res["cpu"][0]).abs().max().item()
    same = res["cuda"][1] == res["cpu"][1]
    pay_diff = max((a.int() - b.int()).abs().max().item()
                   for a, b in zip(res["cuda"][2], res["cpu"][2]))
    n_diff = sum(int((a != b).sum()) for a, b in zip(res["cuda"][2],
                                                     res["cpu"][2]))
    scale_rel = max(((a.cpu() - b).abs().max() / b.abs().max().clamp_min(1e-30))
                    .item() for sa, sb in zip(res["cuda"][3], res["cpu"][3])
                    for a, b in zip(sa, sb))
    say(card, "quant hold " + json.dumps({
        "model": "gpt3_1p3b width, 2 layers", "dtype": "float32",
        "kv_quant": True, "serve_w8": True,
        "first_tick_max_abs_logit_diff": diff, "tol": QUANT_HOLD_LOGIT_TOL,
        "tokens_identical": same, "max_int8_payload_diff": pay_diff,
        "int8_payloads_differing": n_diff, "max_scale_rel_diff": scale_rel,
        "tokens_cuda": res["cuda"][1]}))
    if not (diff <= QUANT_HOLD_LOGIT_TOL and same and pay_diff <= 1):
        raise AssertionError("quant hold: the card's int8 engine disagrees "
                             "with the CPU's")


# --------------------------------------------------------------------------- #
# phase 5: train gpt3_1p3b
# --------------------------------------------------------------------------- #

PEAK_BF16 = PEAK_OPS["bfloat16"]


def decoder_flops(cfg, batch, seq):
    """bench.py `_decoder_flops`: 6ND for forward and backward plus the
    attention term 12*L*h*seq per token, N = the non-embedding weights of
    `GPTConfig.num_params(include_embeddings=False)` plus one
    vocab x hidden table (bench.py counts one for the untied LLaMA head
    too)."""
    n_params = (cfg.num_params(include_embeddings=False)
                + cfg.vocab_size * cfg.hidden_size)
    tokens = batch * seq
    return (6.0 * n_params * tokens
            + 12.0 * cfg.num_layers * cfg.hidden_size * seq * tokens)


def _counters():
    """Every kernel's launch counter, by the name of the kernels line."""
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import fused_rope as fr
    from paddle_tpu_torch.ops import grouped_gemm as gg
    from paddle_tpu_torch.ops import masked_flash as mf

    return {"fused_norm": fn.LAUNCHES, "fused_norm_dx": fn.DX_LAUNCHES,
            "paged_decode_attention": da.LAUNCHES,
            "paged_decode_attention_q8": da.Q8_LAUNCHES,
            "dense_decode_attention": da.DENSE_LAUNCHES,
            "flash_fwd": fa.FWD_LAUNCHES, "flash_bwd_dq": fa.DQ_LAUNCHES,
            "flash_bwd_dkv": fa.DKV_LAUNCHES, "fused_rope": fr.LAUNCHES,
            "flashmask_fwd": mf.FWD_LAUNCHES,
            "flashmask_bwd_dq": mf.DQ_LAUNCHES,
            "flashmask_bwd_dkv": mf.DKV_LAUNCHES,
            "grouped_gemm": gg.LAUNCHES, "varlen_fwd": mf.VL_FWD_LAUNCHES,
            "varlen_bwd_dq": mf.VL_DQ_LAUNCHES,
            "varlen_bwd_dkv": mf.VL_DKV_LAUNCHES}


def _zero_counters():
    from paddle_tpu_torch.ops import decode_attention as da
    from paddle_tpu_torch.ops import flash_attention as fa
    from paddle_tpu_torch.ops import fused_norm as fn
    from paddle_tpu_torch.ops import fused_rope as fr
    from paddle_tpu_torch.ops import grouped_gemm as gg
    from paddle_tpu_torch.ops import masked_flash as mf

    fn.LAUNCHES = fn.DX_LAUNCHES = 0
    da.LAUNCHES = da.Q8_LAUNCHES = da.DENSE_LAUNCHES = 0
    fa.FWD_LAUNCHES = fa.DQ_LAUNCHES = fa.DKV_LAUNCHES = 0
    fr.LAUNCHES = 0
    mf.FWD_LAUNCHES = mf.DQ_LAUNCHES = mf.DKV_LAUNCHES = 0
    mf.VL_FWD_LAUNCHES = mf.VL_DQ_LAUNCHES = mf.VL_DKV_LAUNCHES = 0
    gg.LAUNCHES = 0


def _expected(**counts):
    """The launch counts a path must show: `counts`, and 0 for every other
    kernel."""
    return {**dict.fromkeys(_counters(), 0), **counts}


def _train_setup(torch, cfg, device, dtype, seed, recipe, **step_kw):
    """(model, criterion, step) of a training recipe: None (f32, the
    holds), "gpt3_1p3b" (bench.py's low-memory 1.3B recipe: amp.decorate
    O2, bf16 AdamW moments) or "llama_7bshape" (bench.py's LLaMA rung: f32
    parameters and moments, AMP O2 bf16, sharding stage 2 on one device);
    AdamW lr 1e-4, DistributedTrainStep without a mesh unless `step_kw`
    gives one (and its sharding stage and offload)."""
    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.models import GPTForCausalLM, GPTPretrainingCriterion
    from paddle_tpu_torch.optimizer import AdamW

    model = GPTForCausalLM(cfg, device=device, dtype=dtype, seed=seed)
    if recipe == "gpt3_1p3b":
        amp.decorate(model, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16" if recipe == "gpt3_1p3b" else None)
    kw = dict(mesh=None, sharding_stage=2 if recipe == "llama_7bshape"
              else None)
    kw.update(step_kw)
    step = DistributedTrainStep(model, lambda lg, lb: crit(lg, lb), opt,
                                amp_level="O2" if recipe else None,
                                amp_dtype="bfloat16", **kw)
    return model, crit, step


def _train_config(which):
    """(config, launches per step, parameters whose gradient must be
    seen, recipe text) of a training path."""
    from paddle_tpu_torch.models import LlamaConfig, gpt3_1p3b

    if which == "gpt3_1p3b":
        cfg = gpt3_1p3b(max_position_embeddings=2048, use_recompute=True)
        L = cfg.num_layers
        per_step = {"flash_fwd": 2 * L, "flash_bwd_dq": L, "flash_bwd_dkv": L,
                    "fused_norm": (2 * L + 1) + 2 * L,
                    "fused_norm_dx": 2 * L + 1}
        return (cfg, per_step, ("gpt.embed_tokens.weight",
                                "gpt.layers.0.input_layernorm.weight"),
                "O2 bf16 params (LayerNorm f32), AdamW bf16 moments, "
                "per-layer recompute")
    # bench.py:339-353, run_llama_rung: the 7B widths at depth 3
    cfg = LlamaConfig(hidden_size=4096, num_layers=3, num_heads=32,
                      num_kv_heads=8, intermediate_size=11008,
                      max_position_embeddings=2048, attn_variant="flashmask")
    L = cfg.num_layers
    per_step = {"flashmask_fwd": L, "flashmask_bwd_dq": L,
                "flashmask_bwd_dkv": L, "fused_rope": 2 * L,
                "fused_norm": 2 * L + 1, "fused_norm_dx": 2 * L + 1}
    return (cfg, per_step, ("gpt.embed_tokens.weight",
                            "gpt.layers.0.input_layernorm.weight",
                            "lm_head.weight"),
            "f32 params and AdamW moments, AMP O2 bf16, sharding stage 2 on "
            "one device, flashmask attention (trivial index)")


def train(card, torch, which):
    """A training path of bench.py on the card, batch 4 x 2048 (see
    `_train_config`): a warm-up step (every parameter must change; the
    watched gradients must be finite and non-zero), then three timed steps
    with the launch counters zeroed just before and read just after, and a
    profile of one step."""
    cfg, per_step, watch, recipe_text = _train_config(which)
    B, S, timed = 4, 2048, 3
    t0 = time.perf_counter()
    model, _, step = _train_setup(torch, cfg, "cuda", torch.float32, 0, which)
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device="cuda")
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), device="cuda")
    torch.cuda.synchronize()
    say(card, f"train {which}: {n_params} parameters "
              f"({sorted({str(p.dtype) for p in named.values()})}), built in "
              f"{time.perf_counter() - t0:.3f} s")

    # warm-up step: every parameter must change, and the gradient must
    # reach the bottom of the graph (the token embedding, layer 0's norm)
    # and the head
    before = {k: p.detach().clone() for k, p in named.items()}
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
        raise AssertionError(f"train {which}: parameters unchanged by step 1: "
                             f"{unchanged}")
    if sorted(seen) != sorted(watch) or not all(
            math.isfinite(g) and g > 0 for g in seen.values()):
        raise AssertionError(f"train {which}: gradient norms {seen}")

    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ids, labels) for _ in range(timed)]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _counters()
    want = _expected(**{k: v * timed for k, v in per_step.items()})
    losses = [loss0] + [l.item() for l in losses]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"train {which}: non-finite loss {losses}")
    if launches != want:
        raise AssertionError(f"train {which}: kernel launches {launches} over "
                             f"{timed} steps, expected {want}")
    step_s = total_s / timed
    flops = decoder_flops(cfg, B, S)
    line = {
        "model": which, "recipe": recipe_text, "batch": B, "seq": S,
        "parameters": n_params, "losses": losses, "warmup_step_s": warm_s,
        "timed_steps": timed, "step_s": step_s, "tokens_per_s": B * S / step_s,
        "flops_per_step": flops, "mfu": flops / step_s / PEAK_BF16,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "grad_norms_watched": seen, "launches": launches,
        "launches_per_step": per_step,
    }
    say(card, f"train {which} (smoke run, not a benchmark) " + json.dumps(line))
    profile_step(card, torch, lambda: step(ids, labels), f"train {which} step")
    del step, model, named
    torch.cuda.empty_cache()
    return launches, line


# the kernels of csrc/ by name, as torch.profiler reports them (the sm90
# ones: flash_fwd_sm90_kernel, flash_bwd_dq_sm90_kernel,
# flash_bwd_dkv_sm90_kernel, gg_sm90_kernel; the decodes: paged_split_,
# decode_split_ and decode_combine_kernel; varlen_classes_kernel)
PORT_KERNEL = re.compile(
    r"^void \(anonymous namespace\)::(sm90::)?"
    r"(flash_|norm_|decode_|paged_|rope_|gg_|varlen_)")


def profile_step(card, torch, fn, what):
    """torch.profiler over one call of `fn`: wall time, device-busy time
    (the sum of device activity; one stream, so nothing overlaps), the
    kernels that take the most device time, and every kernel of the port
    (csrc/: PORT_KERNEL in the trace's names) with its time."""
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
    ranked = sorted(events, key=lambda e: e.self_device_time_total,
                    reverse=True)

    def rows(evs):
        return [{"name": e.key[:80], "ms": e.self_device_time_total / 1e3,
                 "calls": e.count} for e in evs]

    say(card, f"{what} profile " + json.dumps({
        "wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
        "device_busy_share": busy_us / 1e6 / wall if wall > 0 else None,
        "top_device_kernels": rows(ranked[:10]),
        "port_kernels": rows(e for e in ranked if PORT_KERNEL.search(e.key))}))


# --------------------------------------------------------------------------- #
# phase 6: the training step on the card (kernels) and on the CPU (plain)
# --------------------------------------------------------------------------- #


def train_hold(card, torch, which):
    """The training step on the card (kernels) and on the CPU (plain
    versions), f32 with TF32 off, batch 2 x 256, 2 layers at the path's
    widths: three AdamW steps from the same weights; the losses and the
    step-1 gradients within tolerance. "gpt3_1p3b" runs with recompute,
    "llama_7bshape" with flashmask attention; both run the f32 CUDA-core
    forms of the attention kernels (the bf16 tensor-core forms are held by
    the kernel phase only)."""
    cfg = dataclasses.replace(_train_config(which)[0], num_layers=2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, steps = 2, 256, 3
    rng = np.random.default_rng(4)
    ids = rng.integers(0, cfg.vocab_size, (B, S))
    labels = rng.integers(0, cfg.vocab_size, (B, S))
    results = {}
    state = None
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model, crit, step = _train_setup(torch, cfg, dev, torch.float32, 2,
                                         None)
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
        del model, step
    _hold_verdict(card, which, results, B, S)


def _hold_verdict(card, which, results, B, S):
    """Print and hold a training hold: `results` maps "cuda" and "cpu" to
    (losses, step-1 gradients by name, seconds); the losses within
    TRAIN_HOLD_LOSS_RTOL, each gradient's max |diff| within
    TRAIN_HOLD_GRAD_TOL of its largest entry (or of a thousandth of the
    largest gradient anywhere)."""
    (l_gpu, g_gpu, s_gpu), (l_cpu, g_cpu, s_cpu) = results["cuda"], results["cpu"]
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(l_gpu, l_cpu))
    gmax = max(g.abs().max().item() for g in g_cpu.values())
    grad_rel = {k: (g_gpu[k] - g).abs().max().item()
                / max(g.abs().max().item(), 1e-3 * gmax)
                for k, g in g_cpu.items()}
    worst = max(grad_rel, key=grad_rel.get)
    say(card, f"train hold {which} " + json.dumps({
        "model": f"{which} widths, 2 layers", "dtype": "float32",
        "batch": B, "seq": S, "losses_cuda": l_gpu, "losses_cpu": l_cpu,
        "max_loss_rel_diff": loss_rel, "loss_rtol": TRAIN_HOLD_LOSS_RTOL,
        "max_grad_rel_diff": grad_rel[worst], "worst_grad": worst,
        "grad_tol": TRAIN_HOLD_GRAD_TOL, "seconds_cuda": s_gpu,
        "seconds_cpu": s_cpu}))
    if not (loss_rel <= TRAIN_HOLD_LOSS_RTOL
            and grad_rel[worst] <= TRAIN_HOLD_GRAD_TOL):
        raise AssertionError(f"train hold {which}: the card's training step "
                             "disagrees with the CPU's")


# --------------------------------------------------------------------------- #
# phase 6b: the sharded step (ZeRO stage 3 with offload) at world size 1
# --------------------------------------------------------------------------- #


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def train_sharded(card, torch, train_line):
    """Phase 5's gpt3_1p3b step through the sharded code of
    `DistributedTrainStep` on a 1-rank NCCL group (rendezvous at 127.0.0.1
    on a free port; `build_mesh(sharding=1)`, as bench.py:270 builds its
    one-device mesh): sharding stage 3 (every parameter gathered by its
    block for the forward and again for the backward, each gradient
    reduce-scattered into its shard) with offload (the AdamW states in
    pinned host memory between steps). The same weights and tokens as
    phase 5: a warm-up step, then three timed steps with the kernel and
    collective counters zeroed just before and read just after. Each loss
    within TRAIN_SHARDED_RTOL of phase 5's at the same step, the flash and
    norm launches phase 5's per step x 3, all-gathers and reduce-scatters
    in every step, every state tensor on the CPU and pinned after every
    step, and the peak device memory below phase 5's by at least
    OFFLOAD_PEAK_SHARE of the bytes the states hold on the host."""
    from paddle_tpu_torch import distributed as pdist
    from paddle_tpu_torch.distributed import collective as coll

    cfg, per_step, _, recipe_text = _train_config("gpt3_1p3b")
    B, S, timed = 4, 2048, 3
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
                      RANK="0", WORLD_SIZE="1")
    pdist.init_parallel_env()
    try:
        mesh = pdist.build_mesh(sharding=1)
        t0 = time.perf_counter()
        model, _, step = _train_setup(torch, cfg, "cuda", torch.float32, 0,
                                      "gpt3_1p3b", mesh=mesh,
                                      sharding_stage=3, offload=True)
        opt = step.optimizer
        rng = np.random.default_rng(0)
        ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                              device="cuda")
        labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)),
                                 device="cuda")
        torch.cuda.synchronize()
        built_s = time.perf_counter() - t0

        def states_pinned():
            bad = [k for k, p in step.params.items()
                   for v in opt._states[id(p)].values()
                   if v.device.type != "cpu" or not v.is_pinned()]
            if bad:
                raise AssertionError(f"train_sharded: states not pinned on "
                                     f"the host: {bad[:4]}")

        t0 = time.perf_counter()
        losses = [step(ids, labels).item()]
        warm_s = time.perf_counter() - t0
        states_pinned()
        host_bytes = sum(v.numel() * v.element_size()
                         for st in opt._states.values() for v in st.values())

        _zero_counters()
        coll.reset_counters()
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        calls = []
        for _ in range(timed):
            before = dict(coll.CALLS)
            losses.append(step(ids, labels).item())
            states_pinned()
            calls.append({op: coll.CALLS.get(op, 0) - before.get(op, 0)
                          for op in ("all_gather", "reduce_scatter",
                                     "all_reduce")})
        torch.cuda.synchronize()
        total_s = time.perf_counter() - t0
        launches = _counters()
        peak = torch.cuda.max_memory_allocated()
        step_s = total_s / timed
        flops = decoder_flops(cfg, B, S)
        ref = train_line["losses"]
        rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref))
        want = _expected(**{k: v * timed for k, v in per_step.items()})
        drop = train_line["peak_memory_bytes"] - peak
        line = {
            "model": "gpt3_1p3b", "recipe": recipe_text,
            "mesh": pdist.env.mesh_shape(mesh), "sharding_stage": 3,
            "offload": True, "comm_overlap": step.comm_overlap,
            "batch": B, "seq": S, "built_s": built_s, "warmup_step_s": warm_s,
            "losses": losses, "train_losses": ref, "max_loss_rel_diff": rel,
            "loss_rtol": TRAIN_SHARDED_RTOL, "timed_steps": timed,
            "step_s": step_s, "tokens_per_s": B * S / step_s,
            "mfu": flops / step_s / PEAK_BF16,
            "collectives_per_step": calls,
            "collective_bytes": dict(coll.BYTES),
            "host_state_bytes": host_bytes, "peak_memory_bytes": peak,
            "train_peak_memory_bytes": train_line["peak_memory_bytes"],
            "peak_drop_bytes": drop,
            "peak_drop_share_of_host_bytes": drop / host_bytes,
            "launches": launches, "launches_per_step": per_step}
        say(card, "train_sharded gpt3_1p3b (smoke run, not a benchmark) "
            + json.dumps(line))
        if rel > TRAIN_SHARDED_RTOL:
            raise AssertionError(f"train_sharded: losses {losses} against "
                                 f"phase 5's {ref}")
        if launches != want:
            raise AssertionError(f"train_sharded: kernel launches {launches}, "
                                 f"expected {want}")
        if not all(c["all_gather"] > 0 and c["reduce_scatter"] > 0
                   for c in calls):
            raise AssertionError(f"train_sharded: collectives {calls}")
        if drop < OFFLOAD_PEAK_SHARE * host_bytes:
            raise AssertionError(
                f"train_sharded: peak {peak} B against phase 5's "
                f"{train_line['peak_memory_bytes']} B, a drop of {drop} B; "
                f"the states hold {host_bytes} B on the host")
        profile_step(card, torch, lambda: step(ids, labels),
                     "train_sharded gpt3_1p3b step")
        del step, model, opt
        torch.cuda.empty_cache()
        return launches
    finally:
        pdist.destroy_process_group()


# --------------------------------------------------------------------------- #
# phases 11-12: bench.py's gpt3_moe rung
# --------------------------------------------------------------------------- #

# bench.py run_moe_rung (:491): experts, top-k, width, expert hidden, depth,
# vocabulary, batch and sequence of the rung on a TPU
MOE_RUNG = dict(E=8, topk=2, M=1024, H=4096, L=4, V=32000, batch=8, seq=1024)


def moe_decoder(torch, device, L=MOE_RUNG["L"], gate=None, seed=0):
    """bench.py's MoEDecoder (:533-549) at the rung's widths: a token
    embedding, L pre-LN residual MoE blocks (ExpertFFN, a GShard top-2
    gate; attention-free) and a Linear head. Weights from one generator
    made from `seed` on `device`; layer i's gate routes with seed + i."""
    from paddle_tpu_torch import nn as pnn
    from paddle_tpu_torch.incubate.distributed.models.moe import (ExpertFFN,
                                                                  MoELayer)

    c = MOE_RUNG
    M, H, V, E = c["M"], c["H"], c["V"], c["E"]
    gen = torch.Generator(device=device).manual_seed(seed)

    class MoEDecoder(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.embed = pnn.Embedding(V, M, generator=gen, device=device)
            self.norms = pnn.LayerList([pnn.LayerNorm(M, device=device)
                                        for _ in range(L)])
            self.moes = pnn.LayerList([
                MoELayer(M, ExpertFFN(E, M, H, generator=gen, device=device),
                         gate=dict(gate or {"type": "gshard",
                                            "top_k": c["topk"]}),
                         seed=seed + i, generator=gen, device=device)
                for i in range(L)])
            self.head = pnn.Linear(M, V, generator=gen, device=device)

        def forward(self, ids):
            x = self.embed(ids)
            for norm, moe in zip(self.norms, self.moes):
                x = x + moe(norm(x))
            return self.head(x)

    return MoEDecoder()


def moe_step(torch, model, amp_level):
    """bench.py's step of the rung: AdamW lr 1e-4 (f32 moments), cross
    entropy over the flattened logits, DistributedTrainStep with no mesh
    (one device: ep = 1, so batch_axes changes nothing)."""
    from paddle_tpu_torch.distributed import DistributedTrainStep
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.optimizer import AdamW

    V = MOE_RUNG["V"]
    return DistributedTrainStep(
        model, lambda lg, lb: F.cross_entropy(lg.reshape(-1, V),
                                              lb.reshape(-1, 1)),
        AdamW(learning_rate=1e-4, parameters=model.parameters()), mesh=None,
        batch_axes=("dp", "ep"), amp_level=amp_level, amp_dtype="bfloat16")


def moe_flops():
    """bench.py's FLOP count of a rung step (:576-582): the expert GEMMs
    over the routed rows, the router and the head, forward x 3."""
    c = MOE_RUNG
    tokens = c["batch"] * c["seq"]
    cap = math.ceil(1.2 * tokens / c["E"])
    routed = min(c["topk"] * tokens, c["E"] * cap)
    fwd = (c["L"] * routed * 4.0 * c["M"] * c["H"]
           + c["L"] * tokens * 2.0 * c["M"] * c["E"]
           + tokens * 2.0 * c["M"] * c["V"])
    return 3.0 * fwd


def train_moe(card, torch):
    """bench.py's gpt3_moe rung on the card at full width and depth (8
    experts, GShard top-2 with random routing, width 1024, expert hidden
    4096, 4 layers, vocabulary 32000, batch 8 x 1024), AMP O2 bf16 over f32
    parameters, AdamW lr 1e-4: a warm-up step (every parameter must change;
    gradients must reach the embedding, every gate and every expert's w1
    and w2), then three timed steps with the launch counters zeroed just
    before and read just after: per step 16 grouped GEMMs (two a block
    forward, two dlhs backward), 4 norm forwards and 4 dx, nothing else."""
    c = MOE_RUNG
    B, S, L, timed = c["batch"], c["seq"], c["L"], 3
    t0 = time.perf_counter()
    model = moe_decoder(torch, "cuda")
    step = moe_step(torch, model, "O2")
    named = dict(model.named_parameters())
    n_params = sum(p.numel() for p in named.values())
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, c["V"], (B, S)), device="cuda")
    labels = torch.as_tensor(rng.integers(0, c["V"], (B, S)), device="cuda")
    torch.cuda.synchronize()
    say(card, f"train gpt3_moe: {n_params} parameters, built in "
              f"{time.perf_counter() - t0:.3f} s")
    watch = ["embed.weight"] + [f"moes.{i}.{w}" for i in range(L) for w in (
        "gate.gate.weight", "experts.w1", "experts.w2")]
    before = {k: p.detach().clone() for k, p in named.items()}
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
        raise AssertionError(f"train gpt3_moe: parameters unchanged by step 1: "
                             f"{unchanged}")
    if sorted(seen) != sorted(watch) or not all(
            math.isfinite(g) and g > 0 for g in seen.values()):
        raise AssertionError(f"train gpt3_moe: gradient norms {seen}")

    per_step = {"grouped_gemm": 4 * L, "fused_norm": L, "fused_norm_dx": L}
    _zero_counters()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = [step(ids, labels) for _ in range(timed)]
    torch.cuda.synchronize()
    total_s = time.perf_counter() - t0
    launches = _counters()
    want = _expected(**{k: v * timed for k, v in per_step.items()})
    losses = [loss0] + [l.item() for l in losses]
    if not all(math.isfinite(l) for l in losses):
        raise AssertionError(f"train gpt3_moe: non-finite loss {losses}")
    if launches != want:
        raise AssertionError(f"train gpt3_moe: kernel launches {launches} over "
                             f"{timed} steps, expected {want}")
    step_s = total_s / timed
    flops = moe_flops()
    say(card, "train gpt3_moe (smoke run, not a benchmark) " + json.dumps({
        "model": "gpt3_moe", "recipe": "f32 params and AdamW moments, AMP O2 "
        "bf16, GShard top-2 with random routing, sorted fast path",
        **MOE_RUNG, "parameters": n_params, "losses": losses,
        "warmup_step_s": warm_s, "timed_steps": timed, "step_s": step_s,
        "tokens_per_s": B * S / step_s, "flops_per_step": flops,
        "mfu": flops / step_s / PEAK_BF16,
        "peak_memory_gb": torch.cuda.max_memory_allocated() / 1e9,
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
        "grad_norms_watched": seen, "launches": launches,
        "launches_per_step": per_step}))
    profile_step(card, torch, lambda: step(ids, labels), "train gpt3_moe step")
    del step, model, named
    torch.cuda.empty_cache()
    return launches


def moe_train_hold(card, torch):
    """The gpt3_moe step on the card (kernels) and on the CPU (plain
    versions) at the rung's widths with 2 layers, batch 2 x 256, f32 (TF32
    off): three AdamW steps from the same weights; the losses and the
    step-1 gradients within the train hold's tolerances. Random routing is
    off on both sides (`random_routing=False`): the two devices' generators
    draw different uniforms, and without them the routes follow the router
    alone, so both sides route alike."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    B, S, steps, V = 2, 256, 3, MOE_RUNG["V"]
    gate = {"type": "gshard", "top_k": 2, "random_routing": False}
    rng = np.random.default_rng(4)
    ids = rng.integers(0, V, (B, S))
    labels = rng.integers(0, V, (B, S))
    results, state = {}, None
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        model = moe_decoder(torch, dev, L=2, gate=gate, seed=2)
        if state is None:
            state = {k: v.cpu() for k, v in model.state_dict().items()}
        else:
            model.load_state_dict(state)
        step = moe_step(torch, model, None)
        ids_t = torch.as_tensor(ids, device=dev)
        labels_t = torch.as_tensor(labels, device=dev)
        step.loss_fn(model(ids_t), labels_t).backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        model.zero_grad(set_to_none=True)
        losses = [step(ids_t, labels_t).item() for _ in range(steps)]
        results[dev] = (losses, grads, time.perf_counter() - t0)
        del model, step
    _hold_verdict(card, "gpt3_moe", results, B, S)


# --------------------------------------------------------------------------- #
# phase 13: varlen attention through its entry points
# --------------------------------------------------------------------------- #


def varlen_entry(card, torch):
    """nn.functional.flash_attn_unpadded forward and backward through
    autograd at phase 2's main varlen case (a pack of 8192 tokens in 8
    causal documents, 32 query heads over 8 kv heads of 128, bf16): exactly
    one forward, one dq and one dk/dv launch, the output and the q/k/v
    gradients within phase 2's limits of the plain path on the card. Then
    the same tokens as qkv [T, 3, 32, 128] (k and v expanded to the query
    heads) through flash_attn_varlen_qkvpacked(varlen_padded=False). After
    the checked run, each entry's forward alone and its forward with the
    backward through autograd are timed eagerly back to back (CUDA
    events); `backward_ms` is their difference."""
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.ops import masked_flash as mf

    gen = torch.Generator(device="cuda").manual_seed(13)
    q, k, v, dout, layout, cu_q, cu_k, causal, dtype = _varlen_inputs(
        torch, gen, "path")
    D, g = q.shape[-1], q.shape[1] // k.shape[1]
    scale = D ** -0.5
    max_len = int((cu_q[1:] - cu_q[:-1]).max())

    def plain_path(k, v):
        out, lse = mf.varlen_fwd_plain(q, k, v, layout, causal, scale)
        delta = (dout.float() * out.float()).sum(-1).transpose(0, 1).contiguous()
        dq = mf.varlen_bwd_dq_plain(q, k, v, layout, dout, lse, delta, causal,
                                    scale)
        dk, dv = mf.varlen_bwd_dkv_plain(q, k, v, layout, dout, lse, delta,
                                         causal, scale)
        return {"out": out, "dq": dq, "dk": dk.to(k.dtype), "dv": dv.to(v.dtype)}

    def entry(name, fn, leaves, plain):
        _zero_counters()
        out, none = fn(*leaves)
        out.backward(dout)
        torch.cuda.synchronize()
        launches = _counters()
        want = _expected(varlen_fwd=1, varlen_bwd_dq=1, varlen_bwd_dkv=1)
        grads = [t.grad for t in leaves]
        if len(grads) == 1:  # qkv [T, 3, H, D]
            grads = grads[0].unbind(1)
        got = {"out": out.detach(), "dq": grads[0], "dk": grads[1],
               "dv": grads[2]}
        errs = _flash_errs(got, plain)
        bad = _flash_violations(errs, dtype)

        def fwd_bwd():
            for t in leaves:
                t.grad = None
            fn(*leaves)[0].backward(dout)

        with torch.no_grad():
            fwd_ms = eager_ms(lambda: fn(*leaves), reps=5, inner=3)
        both_ms = eager_ms(fwd_bwd, reps=5, inner=3)
        say(card, f"varlen {name} " + json.dumps({
            "Tq": q.shape[0], "documents": cu_q.numel() - 1, "H": q.shape[1],
            "D": D, "causal": causal, "dtype": dtype, "second": none,
            "row_rel_err": {w: e[1] for w, e in errs.items()},
            "frobenius_rel_err": {w: e[2] for w, e in errs.items()},
            "tol": FLASH_TOL[dtype], "launches": launches,
            "forward_ms": fwd_ms, "forward_backward_ms": both_ms,
            "backward_ms": both_ms - fwd_ms}))
        if launches != want or bad or none is not None:
            raise AssertionError(f"varlen {name}: launches {launches} (expected "
                                 f"{want}), {bad}")
        return launches

    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    a = entry("flash_attn_unpadded", lambda q_, k_, v_: F.flash_attn_unpadded(
        q_, k_, v_, cu_q, cu_k, max_len, max_len, scale, causal=causal),
        leaves, plain_path(k, v))
    del leaves
    ke, ve = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    qkv = torch.stack([q, ke, ve], dim=1).requires_grad_()
    b = entry("flash_attn_varlen_qkvpacked",
              lambda t: F.flash_attn_varlen_qkvpacked(
                  t, cu_q, cu_k, max_len, max_len, scale, causal=causal,
                  varlen_padded=False), [qkv], plain_path(ke, ve))
    del qkv, q, k, v, dout
    torch.cuda.empty_cache()
    return {n: a[n] + b[n] for n in a}



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
    sm90_report(card, _build.build_library(), _build.BUILD_LOG)
    say(card, "paged_split_kernel ptxas " + json.dumps(
        ptxas_kernels(_build.BUILD_LOG, "paged_split_kernel")))
    rope_ptxas(card, _build.BUILD_LOG)
    norm_dx_ptxas(card, _build.BUILD_LOG)

    norm = check_norm(card, torch)
    norm_dx = check_norm_dx(card, torch)
    decode = check_decode(card, torch)
    decode_q8 = check_decode_q8(card, torch)
    dense = check_dense_decode(card, torch)
    flash = check_flash(card, torch)
    check_flash_autograd(card, torch)
    check_flash_decode(card, torch)
    rope = check_rope(card, torch)
    flashmask = check_flashmask(card, torch)
    check_flashmask_autograd(card, torch)
    grouped = check_grouped_gemm(card, torch)
    varlen = check_varlen(card, torch)
    planted_kernel_faults(card, torch)
    varlen_cta_clocks(card, torch)
    serve_launches = serve(card, torch)
    hold(card, torch)
    quant_launches = serve_quant(card, torch)
    dense_launches = serve_dense(card, torch)
    mmha_launches = mmha(card, torch)
    quant_hold(card, torch)
    train_launches, train_line = train(card, torch, "gpt3_1p3b")
    train_hold(card, torch, "gpt3_1p3b")
    sharded_launches = train_sharded(card, torch, train_line)
    llama_serve_launches = serve(card, torch, "llama_7b")
    hold(card, torch, "llama_7b")
    llama_train_launches, _ = train(card, torch, "llama_7bshape")
    train_hold(card, torch, "llama_7bshape")
    moe_launches = train_moe(card, torch)
    moe_train_hold(card, torch)
    varlen_launches = varlen_entry(card, torch)

    # launches: each kernel's count over the paths that run it, each path
    # driven with the counters zeroed just before and read just after
    paths = (serve_launches, quant_launches, dense_launches, mmha_launches,
             train_launches, sharded_launches, llama_serve_launches,
             llama_train_launches, moe_launches, varlen_launches)
    launches = {name: sum(p.get(name, 0) for p in paths) for name in _counters()}
    da_src = "paddle_tpu_torch/csrc/decode_attention.cu"
    da_ref = "paddle_tpu/ops/pallas/decode_attention.py:50"
    fwd_src = "paddle_tpu_torch/csrc/flash_fwd_sm90.cuh"
    bwd_src = "paddle_tpu_torch/csrc/flash_bwd_sm90.cuh"
    fa_ref = "paddle_tpu/ops/pallas/flash_attention.py"
    mf_src = "paddle_tpu_torch/csrc/masked_flash.cu"
    mf_ref = "paddle_tpu/ops/pallas/masked_flash.py"
    kernels = []
    for name, src, replaces, main_row, err in (
            ("fused_norm", "paddle_tpu_torch/csrc/fused_norm.cu",
             "paddle_tpu/ops/pallas/fused_norm.py:107", norm["main"], norm["worst"]),
            ("paged_decode_attention", da_src, da_ref, decode["main"],
             decode["worst"]),
            ("paged_decode_attention_q8", da_src, da_ref, decode_q8["main"],
             decode_q8["worst"]),
            ("dense_decode_attention", "paddle_tpu_torch/csrc/dense_decode.cu",
             da_ref, dense["main"], dense["worst"]),
            ("fused_norm_dx", "paddle_tpu_torch/csrc/fused_norm.cu",
             "paddle_tpu/ops/pallas/fused_norm.py:196", norm_dx["main"],
             norm_dx["worst"]),
            ("flash_fwd", fwd_src, fa_ref + ":127", flash["main"]["fwd"],
             flash["worst"]["fwd"]),
            ("flash_bwd_dq", bwd_src, fa_ref + ":332", flash["main"]["dq"],
             flash["worst"]["dq"]),
            ("flash_bwd_dkv", bwd_src, fa_ref + ":406", flash["main"]["dkv"],
             flash["worst"]["dkv"]),
            ("fused_rope", "paddle_tpu_torch/csrc/fused_rope.cu",
             "paddle_tpu/ops/pallas/fused_rope.py:90", rope["main"],
             rope["worst"]),
            ("flashmask_fwd", fwd_src, mf_ref + ":77", flashmask["main"]["fwd"],
             flashmask["worst"]["fwd"]),
            ("flashmask_bwd_dq", bwd_src, mf_ref + ":138",
             flashmask["main"]["dq"], flashmask["worst"]["dq"]),
            ("flashmask_bwd_dkv", bwd_src, mf_ref + ":182",
             flashmask["main"]["dkv"], flashmask["worst"]["dkv"]),
            ("grouped_gemm", "paddle_tpu_torch/csrc/grouped_gemm_sm90.cuh",
             "paddle_tpu/ops/pallas/grouped_gemm.py:110", grouped["main"],
             grouped["worst"]),
            ("varlen_fwd", fwd_src, mf_ref + ":442", varlen["main"]["fwd"],
             varlen["worst"]["fwd"]),
            ("varlen_bwd_dq", bwd_src, mf_ref + ":490", varlen["main"]["dq"],
             varlen["worst"]["dq"]),
            ("varlen_bwd_dkv", bwd_src, mf_ref + ":529",
             varlen["main"]["dkv"], varlen["worst"]["dkv"])):
        kernels.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches[name], "max_abs_err": err,
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row["library_ms"]})
        if "cold_ms" in main_row:
            kernels[-1]["cold_ms"] = main_row["cold_ms"]
    print(card, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
