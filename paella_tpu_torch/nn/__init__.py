from .attention import MultiheadAttention, dot_product_attention
from .blocks import (
    AttnBlock,
    DerivedWeights,
    Downsample,
    GlobalResponseNorm,
    ResBlock,
    TimestepBlock,
    Upsample,
)
from .functional import (
    depth_to_space,
    gelu,
    layer_norm,
    replication_pad_2d,
    silu,
    sinusoidal_embedding,
    space_to_depth,
)

__all__ = [
    "MultiheadAttention",
    "dot_product_attention",
    "AttnBlock",
    "DerivedWeights",
    "Downsample",
    "GlobalResponseNorm",
    "ResBlock",
    "TimestepBlock",
    "Upsample",
    "depth_to_space",
    "gelu",
    "layer_norm",
    "replication_pad_2d",
    "silu",
    "sinusoidal_embedding",
    "space_to_depth",
]
