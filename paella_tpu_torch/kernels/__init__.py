"""Hand-written Hopper kernels (csrc/) with their plain torch versions."""
from .attention import attention_plain, fused_attention
from .attn_block import AttnBlockWeights, attn_block_plain, fused_attn_block, prepare_attn_block_weights
from .quantize import codebook_lookup_plain, fused_codebook_lookup
from .resblock import ResBlockWeights, fused_resblock, prepare_resblock_weights, resblock_plain
from .sampling import fused_head_categorical, gumbel_categorical, gumbel_categorical_plain, head_categorical_plain

__all__ = [
    "AttnBlockWeights",
    "ResBlockWeights",
    "attention_plain",
    "attn_block_plain",
    "codebook_lookup_plain",
    "fused_attention",
    "fused_attn_block",
    "fused_codebook_lookup",
    "fused_head_categorical",
    "fused_resblock",
    "gumbel_categorical",
    "gumbel_categorical_plain",
    "head_categorical_plain",
    "prepare_attn_block_weights",
    "prepare_resblock_weights",
    "resblock_plain",
]
