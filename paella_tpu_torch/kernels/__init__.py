"""Hand-written Hopper kernels (csrc/) with their plain torch versions."""
from .resblock import ResBlockWeights, fused_resblock, prepare_resblock_weights, resblock_plain
from .sampling import fused_head_categorical, head_categorical_plain

__all__ = [
    "ResBlockWeights",
    "fused_head_categorical",
    "fused_resblock",
    "head_categorical_plain",
    "prepare_resblock_weights",
    "resblock_plain",
]
