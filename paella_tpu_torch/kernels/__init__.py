"""Hand-written Hopper kernels (csrc/) with their plain torch versions."""
from .attention import attention_plain, fused_attention
from .attn_block import AttnBlockWeights, attn_block_plain, fused_attn_block, prepare_attn_block_weights
from .quantize import codebook_lookup_plain, fused_codebook_lookup
from .resblock import ResBlockWeights, fused_resblock, prepare_resblock_weights, resblock_plain
from .sampling import fused_head_categorical, gumbel_categorical, gumbel_categorical_plain, head_categorical_plain

# every kernel wrapper, then each one's plain version; each counts its calls in `launches`
WRAPPERS = (fused_resblock, fused_head_categorical, gumbel_categorical, fused_codebook_lookup, fused_attention,
            fused_attn_block, resblock_plain, head_categorical_plain, gumbel_categorical_plain,
            codebook_lookup_plain, attention_plain, attn_block_plain)


def launch_counts() -> dict:
    """{wrapper name: its `launches`}: the calls each made in this process,
    eagerly or while a CUDA graph was captured (a replay calls no wrapper);
    and "fused_attention_streamed": those of fused_attention's on the wgmma
    variant's streamed form."""
    return {**{f.__name__: f.launches for f in WRAPPERS},
            "fused_attention_streamed": fused_attention.streamed_launches}


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
    "launch_counts",
    "prepare_attn_block_weights",
    "prepare_resblock_weights",
    "resblock_plain",
]
