#!/usr/bin/env python3
"""The port's data-parallel and ZeRO step over several GPUs of one host
(NCCL, one process per card).

    python3 chip_ranks.py --ranks 4          # four cards
    python3 chip_ranks.py --ranks 4 --cpu    # four gloo processes, tiny sizes

Each rank runs, in order:

1. parity — the MLP of `tests/test_sharding_stages.py` (H 256, B 32, AdamW
   lr 1e-3, f32, TF32 off), weights from seed 0, four steps through
   `DistributedTrainStep` at sharding stages 0-3 on a mesh of
   sharding=N and of dp=2 x sharding=N/2, with comm_overlap off, and with
   offload at stages 2 and 3; every run's losses and gathered parameters
   against `jit.TrainStep` on the whole batch on this rank alone
   (LOSS_RTOL, PARAM_TOL), and comm_overlap off and on bit for bit.
2. step — gpt3_1p3b at full width and depth with `chip_smoke.py`'s
   recipe and tokens (O2 bf16, f32 LayerNorm, AdamW with bf16 moments,
   recompute; batch 4 x 2048, split over the ranks) at stage 3 with
   offload on a mesh of sharding=N: a warm-up step and three timed steps,
   their losses (phase 5 of `chip_smoke.py` prints the one-card losses of
   the same weights and tokens), step time, tokens/s, peak memory of
   each rank, the collectives of a step and the bytes each rank's states
   hold on the host.

Rank 0 prints one JSON line per part and a last line {"ok": ...}; the
process exits non-zero when a rank fails or a parity check does not hold.
Each process group has a timeout of GROUP_TIMEOUT_S, and the launcher
kills its ranks after RUN_TIMEOUT_S.
"""

from __future__ import annotations

import argparse
import datetime
import json
import math
import os
import socket
import sys
import time

GROUP_TIMEOUT_S = 300
RUN_TIMEOUT_S = 1500
LOSS_RTOL = 2e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
H, B = 256, 32


def _mlp(torch, device):
    from paddle_tpu_torch import nn as pnn

    class MLP(torch.nn.Module):
        def __init__(self):
            super().__init__()
            gen = torch.Generator(device=device).manual_seed(0)
            kw = dict(generator=gen, device=device)
            self.l1 = pnn.Linear(H, H, **kw)
            self.l2 = pnn.Linear(H, H, **kw)
            self.l3 = pnn.Linear(H, 8, **kw)

        def forward(self, x):
            return self.l3(torch.relu(self.l2(torch.relu(self.l1(x)))))

    return MLP()


def _mse(o, y):
    return ((o - y) ** 2).mean()


def parity(torch, dist, world, device):
    """Part 1: every stage's run against the one-rank TrainStep."""
    import numpy as np

    from paddle_tpu_torch.jit import TrainStep
    from paddle_tpu_torch.optimizer import AdamW

    rng = np.random.default_rng(0)
    x = torch.as_tensor(rng.normal(size=(B, H)), dtype=torch.float32,
                        device=device)
    y = torch.as_tensor(rng.normal(size=(B, 8)), dtype=torch.float32,
                        device=device)

    def run(cls, **kw):
        model = _mlp(torch, device)
        step = cls(model, _mse, AdamW(learning_rate=1e-3,
                                      parameters=model.parameters()), **kw)
        losses = [step(x, y).item() for _ in range(4)]
        full = (step.state_dict() if hasattr(step, "mesh")
                else model.state_dict())
        return losses, {k: v.detach().cpu() for k, v in full.items()}

    ref_l, ref_p = run(TrainStep)
    rows, bad = [], []
    meshes = {f"sharding{world}": dict(sharding=world),
              f"dp2_sharding{world // 2}": dict(dp=2, sharding=world // 2)}
    for mname, shape in meshes.items():
        mesh = dist.build_mesh(**shape)
        for stage in (0, 1, 2, 3):
            for extra in ({}, {"comm_overlap": False}, {"offload": True}):
                if extra.get("offload") and stage < 2:
                    continue
                losses, params = run(dist.DistributedTrainStep, mesh=mesh,
                                     sharding_stage=stage, **extra)
                rel = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_l))
                err = max((params[k] - ref_p[k]).abs().max().item()
                          for k in ref_p)
                ok = rel <= LOSS_RTOL and all(torch.allclose(
                    params[k], ref_p[k], **PARAM_TOL) for k in ref_p)
                name = f"{mname} stage {stage} {extra or ''}".strip()
                rows.append({"run": name, "max_loss_rel_diff": rel,
                             "max_param_abs_diff": err, "ok": ok,
                             "losses": losses})
                if not ok:
                    bad.append(name)
                if extra == {"comm_overlap": False}:
                    on = rows[-2]
                    if on["losses"] != losses:
                        bad.append(f"{name}: comm_overlap on and off differ")
    return {"part": "parity", "reference_losses": ref_l, "runs": rows,
            "failed": bad}


def gpt_step(torch, dist, world, device, cpu):
    """Part 2: gpt3_1p3b at stage 3 with offload over the ranks."""
    import numpy as np

    from paddle_tpu_torch import amp
    from paddle_tpu_torch.distributed import collective as coll
    from paddle_tpu_torch.models import (GPTForCausalLM,
                                         GPTPretrainingCriterion, gpt3_1p3b,
                                         gpt3_tiny)
    from paddle_tpu_torch.optimizer import AdamW

    if cpu:
        cfg, batch, seq = gpt3_tiny(use_recompute=True), 4, 64
    else:
        cfg = gpt3_1p3b(max_position_embeddings=2048, use_recompute=True)
        batch, seq = 4, 2048
    model = GPTForCausalLM(cfg, device=device, dtype=torch.float32, seed=0)
    amp.decorate(model, level="O2", dtype="bfloat16")
    crit = GPTPretrainingCriterion(cfg)
    opt = AdamW(learning_rate=1e-4, parameters=model.parameters(),
                moment_dtype="bfloat16")
    step = dist.DistributedTrainStep(
        model, lambda lg, lb: crit(lg, lb), opt,
        mesh=dist.build_mesh(sharding=world), sharding_stage=3,
        offload=True, amp_level="O2", amp_dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                          device=device)
    labels = torch.as_tensor(rng.integers(0, cfg.vocab_size, (batch, seq)),
                             device=device)
    sync = torch.cuda.synchronize if not cpu else (lambda: None)
    t0 = time.perf_counter()
    losses = [step(ids, labels).item()]
    warm_s = time.perf_counter() - t0
    if not cpu:
        torch.cuda.reset_peak_memory_stats()
    coll.reset_counters()
    sync()
    t0 = time.perf_counter()
    losses += [step(ids, labels).item() for _ in range(3)]
    sync()
    step_s = (time.perf_counter() - t0) / 3
    host = sum(v.numel() * v.element_size() for st in opt._states.values()
               for v in st.values())
    return {"part": "step", "model": "gpt3_1p3b" if not cpu else "gpt3_tiny",
            "mesh": dist.env.mesh_shape(step.mesh), "sharding_stage": 3,
            "offload": True, "batch": batch, "seq": seq,
            "losses": losses, "warmup_step_s": warm_s, "step_s": step_s,
            "tokens_per_s": batch * seq / step_s,
            "peak_memory_bytes": (torch.cuda.max_memory_allocated()
                                  if not cpu else None),
            "host_state_bytes": host,
            "collective_calls_per_step": {k: v / 3 for k, v in coll.CALLS.items()},
            "collective_bytes_per_step": {k: v / 3 for k, v in coll.BYTES.items()},
            "finite": all(math.isfinite(v) for v in losses)}


def rank_main(rank, world, port, cpu, out_dir):
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    import paddle_tpu_torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if cpu:
        torch.set_num_threads(1)
    dist.init_parallel_env(device="cpu" if cpu else None,
                           timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    device = dist.env.device()
    try:
        parts = [parity(torch, dist, world, device)]
        torch.backends.cuda.matmul.allow_tf32 = True
        parts.append(gpt_step(torch, dist, world, device, cpu))
        gathered = []
        dist.all_gather_object(gathered, parts)
        if rank == 0:
            with open(os.path.join(out_dir, "ranks.json"), "w") as f:
                json.dump(gathered, f)
    finally:
        dist.destroy_process_group()


def card_line():
    import subprocess

    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return " | ".join(out)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    import tempfile

    import torch
    import torch.multiprocessing as mp

    if not args.cpu and torch.cuda.device_count() < args.ranks:
        print(f"chip_ranks: {args.ranks} ranks need as many CUDA devices, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    card = "cpu (gloo)" if args.cpu else card_line()
    print(card, flush=True)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = tempfile.mkdtemp(prefix="chip_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, args.ranks, port, args.cpu, out_dir))
             for r in range(args.ranks)]
    for p in procs:
        p.start()
    end = time.monotonic() + RUN_TIMEOUT_S
    for p in procs:
        p.join(max(1.0, end - time.monotonic()))
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if any(codes):
        print(f"chip_ranks: rank exit codes {codes}", file=sys.stderr)
        return 1
    with open(os.path.join(out_dir, "ranks.json")) as f:
        ranks = json.load(f)
    failed = []
    for r, parts in enumerate(ranks):
        for part in parts:
            print(f"[{card}] rank {r} " + json.dumps(part), flush=True)
            failed += [f"rank {r}: {x}" for x in part.get("failed", [])]
            if part["part"] == "step" and not part["finite"]:
                failed.append(f"rank {r}: non-finite loss")
    losses = {tuple(parts[1]["losses"]) for parts in ranks}
    if len(losses) != 1:
        failed.append(f"the ranks report different losses {losses}")
    print(card, flush=True)
    print(json.dumps({"ok": not failed, "failed": failed,
                      "ranks": args.ranks}), flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
