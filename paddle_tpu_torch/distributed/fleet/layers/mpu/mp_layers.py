"""Tensor-parallel layers (↔ paddle_tpu/distributed/fleet/layers/mpu/mp_layers.py),
for now as plain single-device layers with the same parameter names and
layouts: ColumnParallelLinear and RowParallelLinear hold the full
[in, out] weight, VocabParallelEmbedding the full [vocab, hidden] table,
and ParallelCrossEntropy is the cross entropy over unsharded logits. Their
sharded form over a device mesh comes with the distributed slice
(ROADMAP A9)."""

from __future__ import annotations

import torch

from .....nn import functional as F
from .....nn.layer.common import Embedding, Linear

__all__ = ["ColumnParallelLinear", "ParallelCrossEntropy",
           "RowParallelLinear", "VocabParallelEmbedding"]


class VocabParallelEmbedding(Embedding):
    """Embedding over the vocabulary (Xavier-normal default init, as the
    JAX package's)."""

    def __init__(self, num_embeddings, embedding_dim, *, weight_std=None,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__(num_embeddings, embedding_dim, weight_std=weight_std,
                         generator=generator, device=device, dtype=dtype,
                         default_init="xavier_normal")


class ColumnParallelLinear(Linear):
    """Linear whose output features the distributed slice shards over mp."""

    def __init__(self, in_features, out_features, has_bias=True,
                 gather_output=True, *, weight_std=None, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__(in_features, out_features,
                         bias_attr=None if has_bias else False,
                         weight_std=weight_std, generator=generator,
                         device=device, dtype=dtype)
        self.gather_output = gather_output


class RowParallelLinear(Linear):
    """Linear whose input features the distributed slice shards over mp."""

    def __init__(self, in_features, out_features, has_bias=True,
                 input_is_parallel=False, *, weight_std=None, generator=None,
                 device=None, dtype=torch.float32):
        super().__init__(in_features, out_features,
                         bias_attr=None if has_bias else False,
                         weight_std=weight_std, generator=generator,
                         device=device, dtype=dtype)
        self.input_is_parallel = input_is_parallel


class ParallelCrossEntropy(torch.nn.Module):
    """Per-token cross entropy (reduction "none") over the vocabulary
    (↔ mp_layers.py:143-156); rows labelled `ignore_index` give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index

    def forward(self, input, label):  # noqa: A002
        return F.cross_entropy(input, label, reduction="none",
                               ignore_index=self.ignore_index)
