from .activation import GELU, ReLU, Silu, Tanh
from .common import (AlphaDropout, Dropout, Dropout2D, Dropout3D, Embedding,
                     Flatten, Identity, Linear)
from .container import LayerList, Sequential
from .layers import Layer
from .loss import (BCELoss, BCEWithLogitsLoss, CosineEmbeddingLoss,
                   CrossEntropyLoss, CTCLoss, HingeEmbeddingLoss, KLDivLoss,
                   L1Loss, MarginRankingLoss, MSELoss, NLLLoss, SmoothL1Loss,
                   TripletMarginLoss)
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, GroupNorm,
                   InstanceNorm1D, InstanceNorm2D, InstanceNorm3D, LayerNorm,
                   RMSNorm, SyncBatchNorm, _BatchNormBase)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                      MaxPool3D)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool1D", "AlphaDropout", "Dropout2D", "Dropout3D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "BCELoss",
           "BCEWithLogitsLoss", "BatchNorm", "BatchNorm1D", "BatchNorm2D",
           "BatchNorm3D", "CTCLoss", "Conv1D", "Conv1DTranspose", "Conv2D",
           "Conv2DTranspose", "Conv3D", "Conv3DTranspose",
           "CosineEmbeddingLoss", "CrossEntropyLoss", "Dropout", "Embedding",
           "Flatten", "GELU", "GroupNorm", "HingeEmbeddingLoss", "Identity",
           "InstanceNorm1D", "InstanceNorm2D", "InstanceNorm3D", "KLDivLoss",
           "L1Loss", "Layer", "LayerList", "LayerNorm", "Linear", "MSELoss",
           "MarginRankingLoss", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "MultiHeadAttention", "NLLLoss", "RMSNorm", "ReLU", "Sequential",
           "Silu", "SmoothL1Loss", "SyncBatchNorm", "Tanh",
           "TripletMarginLoss", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
