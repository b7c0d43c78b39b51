from .mp_layers import (ColumnParallelLinear, RowParallelLinear,
                        VocabParallelEmbedding)

__all__ = ["ColumnParallelLinear", "RowParallelLinear",
           "VocabParallelEmbedding"]
