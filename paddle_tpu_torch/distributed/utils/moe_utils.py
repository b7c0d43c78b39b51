"""The MoE token exchanges `global_scatter` / `global_gather`
(↔ paddle_tpu/distributed/utils/moe_utils.py).

Count contract (reference :15-19): with n ranks and L local experts a rank
(E = n L global experts), `local_count[i]` is the number of rows this rank
sends to global expert i (x's rows sorted by target expert) and
`global_count[r L + e]` the number of rows it receives from rank r for its
local expert e. `global_scatter` returns the received rows, rank r's
before rank r + 1's and within a rank expert e's before e + 1's;
`global_gather` sends them back, so that it returns rows in x's order.

The reference pads every (rank, expert) block to the largest count, sends
one equal-split all-to-all and compacts on the receive side. Here the rows
ride one uneven-split `all_to_all_single` whose splits are the per-rank
sums of the counts: the same values, and only the rows themselves on the
wire (its bytes are what `collective_bytes_total{op="all_to_all"}`
counts), under a `comm_task` of kind "a2a" (reference :90-100). The
counts are read on the host (tensors, arrays or lists). Both functions are
differentiable: the backward of each is the other with the same counts.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .. import collective as C
from ..comm_watchdog import comm_task

__all__ = ["global_gather", "global_scatter"]


def _counts(c):
    if isinstance(c, torch.Tensor):
        c = c.detach().cpu().numpy()
    return np.asarray(c).ravel().astype(np.int64)


def _exchange(x, send, recv, pg):
    """Rows of x split by `send` (rows to each rank) -> the rows every rank
    sent this one, split by `recv`."""
    x = x.contiguous()
    out = x.new_empty((int(recv.sum()),) + tuple(x.shape[1:]))
    C.record_collective_traffic("all_to_all", x.numel() * x.element_size())
    with comm_task("moe/global_exchange", kind="a2a"):
        dist.all_to_all_single(out, x, output_split_sizes=recv.tolist(),
                               input_split_sizes=send.tolist(), group=pg)
    return out


class _Exchange(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, pg):
        ctx.send, ctx.recv, ctx.pg = send, recv, pg
        return _exchange(x, send, recv, pg)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.recv, ctx.send, ctx.pg), None, None, None


def _rank_sums(local_count, global_count, group):
    """(rows to each rank, rows from each rank, process group)."""
    pg = getattr(group, "process_group", group)
    n = dist.get_world_size(pg)
    lc, gc = _counts(local_count), _counts(global_count)
    if lc.size % n or gc.size != lc.size:
        raise ValueError(f"counts of {lc.size} and {gc.size} experts over "
                         f"{n} ranks")
    return lc.reshape(n, -1).sum(1), gc.reshape(n, -1).sum(1), pg


def global_scatter(x, local_count, global_count, group=None,
                   use_calc_stream=True):
    """Send each of x's rows to the rank of its expert (module docstring);
    x's row count must be local_count's sum."""
    send, recv, pg = _rank_sums(local_count, global_count, group)
    if int(send.sum()) != x.shape[0]:
        raise ValueError(f"count sum {int(send.sum())} != rows {x.shape[0]}: "
                         "tokens would be silently dropped")
    return _Exchange.apply(x, send, recv, pg)


def global_gather(x, local_count, global_count, group=None,
                  use_calc_stream=True):
    """The inverse of `global_scatter` with the same counts: x's rows
    (global_count's sum) go back to the ranks they came from."""
    send, recv, pg = _rank_sums(local_count, global_count, group)
    if int(recv.sum()) != x.shape[0]:
        raise ValueError(f"count sum {int(recv.sum())} != rows {x.shape[0]}")
    return _Exchange.apply(x, recv, send, pg)
