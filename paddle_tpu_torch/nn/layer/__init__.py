from .activation import GELU, ReLU, Silu, Tanh
from .common import Dropout, Embedding, Flatten, Identity, Linear
from .container import LayerList, Sequential
from .conv import (Conv1D, Conv1DTranspose, Conv2D, Conv2DTranspose, Conv3D,
                   Conv3DTranspose)
from .norm import (BatchNorm, BatchNorm1D, BatchNorm2D, BatchNorm3D, LayerNorm,
                   RMSNorm, SyncBatchNorm, _BatchNormBase)
from .pooling import (AdaptiveAvgPool1D, AdaptiveAvgPool2D, AdaptiveAvgPool3D,
                      AdaptiveMaxPool1D, AdaptiveMaxPool2D, AdaptiveMaxPool3D,
                      AvgPool1D, AvgPool2D, AvgPool3D, MaxPool1D, MaxPool2D,
                      MaxPool3D)
from .transformer import (MultiHeadAttention, Transformer, TransformerDecoder,
                          TransformerDecoderLayer, TransformerEncoder,
                          TransformerEncoderLayer)

__all__ = ["AdaptiveAvgPool1D", "AdaptiveAvgPool2D", "AdaptiveAvgPool3D",
           "AdaptiveMaxPool1D", "AdaptiveMaxPool2D", "AdaptiveMaxPool3D",
           "AvgPool1D", "AvgPool2D", "AvgPool3D", "BatchNorm", "BatchNorm1D",
           "BatchNorm2D", "BatchNorm3D", "Conv1D", "Conv1DTranspose", "Conv2D",
           "Conv2DTranspose", "Conv3D", "Conv3DTranspose", "Dropout",
           "Embedding", "Flatten", "GELU", "Identity", "LayerList",
           "LayerNorm", "Linear", "MaxPool1D", "MaxPool2D", "MaxPool3D",
           "MultiHeadAttention", "RMSNorm", "ReLU", "Sequential", "Silu",
           "SyncBatchNorm", "Tanh", "Transformer", "TransformerDecoder",
           "TransformerDecoderLayer", "TransformerEncoder",
           "TransformerEncoderLayer"]
