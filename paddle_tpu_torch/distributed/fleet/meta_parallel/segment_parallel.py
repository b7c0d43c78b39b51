"""The segment-parallel model wrapper `SegmentParallel`
(↔ paddle_tpu/distributed/fleet/meta_parallel/__init__.py:65-66;
reference segment_parallel.py:26).

The reference's wrapper passes the model through: its arrays are global
and a `context_parallel` model cuts its attention over the sep axis
itself. Here each rank feeds its own chunk, so `SegmentParallel(model,
hcg)` is the `DataParallel` of the (dp, sep) group: it broadcasts the
parameters and buffers from the group's first rank and averages each
gradient over the group in the backward. An eager loop (`loss.backward();
opt.step()`) in which each rank feeds its dp rows and its sep chunk of
the sequence so trains the model over the mesh, the ring of its attention
running over the global mesh's sep group (`fleet.init` builds it). The
average is the global mean when every rank's loss is a mean over as many
tokens.
"""

from __future__ import annotations

from ...parallel import DataParallel

__all__ = ["SegmentParallel"]


class SegmentParallel(DataParallel):
    def __init__(self, layers, hcg, strategy=None):
        super().__init__(layers, strategy,
                         group=hcg.get_dp_sep_parallel_group())
        self._hcg = hcg
