"""Hand-written Hopper kernels (csrc/) with their plain torch versions."""
from .quantize import codebook_lookup_plain, fused_codebook_lookup
from .resblock import ResBlockWeights, fused_resblock, prepare_resblock_weights, resblock_plain
from .sampling import fused_head_categorical, gumbel_categorical, gumbel_categorical_plain, head_categorical_plain

__all__ = [
    "ResBlockWeights",
    "codebook_lookup_plain",
    "fused_codebook_lookup",
    "fused_head_categorical",
    "fused_resblock",
    "gumbel_categorical",
    "gumbel_categorical_plain",
    "head_categorical_plain",
    "prepare_resblock_weights",
    "resblock_plain",
]
