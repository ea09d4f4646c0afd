"""Structural editing: attention reweighting over conditioning tokens, a
numpy-only copy of `paella_tpu/sampling/editing.py` (importing the JAX
package pulls in jax; tests/test_torch_pipeline.py pins the copy to the
original).

The reference swaps every torch MultiheadAttention for an eager
reimplementation that multiplies post-softmax attention by a weight matrix
over the conditioning tokens (reference: utils/alter_attention.py:4-53). In
the port, as in the JAX package, every AttnBlock accepts `cond_reweight`
(B, S_cond) and the sampler threads it through.

Because ByT5 tokenization is byte-level, mapping a prompt SUBSTRING to its
token span is exact — `reweight_for_phrase` exploits that.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np


def build_cond_reweight(
    byt5_len: int,
    spans: Sequence[Tuple[int, int, float]],
    clip_seq_len: int = 4,
    has_clip: bool = True,
    has_clip_image: bool = False,
    clip_weight: float = 1.0,
    clip_image_weight: float = 1.0,
    base: float = 1.0,
) -> np.ndarray:
    """Build a (1, S_cond) multiplicative attention weight vector.

    spans: (start, end, weight) byte ranges into the ByT5 token sequence —
    weight > 1 amplifies attention to those tokens, < 1 suppresses it
    (the semantics of reference utils/alter_attention.py:34).
    The conditioning sequence layout matches Paella.gen_c_embeddings:
    [byt5 (byt5_len)] + [clip x clip_seq_len] + [clip_image x clip_seq_len].
    """
    parts = [np.full(byt5_len, base, np.float32)]
    for start, end, weight in spans:
        parts[0][start:end] = weight
    if has_clip:
        parts.append(np.full(clip_seq_len, clip_weight, np.float32))
    if has_clip_image:
        parts.append(np.full(clip_seq_len, clip_image_weight, np.float32))
    return np.concatenate(parts)[None, :]


def phrase_byte_span(prompt: str, phrase: str) -> Optional[Tuple[int, int]]:
    """Byte-level token span of `phrase` inside `prompt` (ByT5 ids are bytes+3,
    so byte offsets ARE token offsets)."""
    idx = prompt.find(phrase)
    if idx < 0:
        return None
    start = len(prompt[:idx].encode("utf-8"))
    end = start + len(phrase.encode("utf-8"))
    return start, end


def reweight_for_phrase(
    prompt: str,
    phrase: str,
    weight: float,
    byt5_len: int,
    clip_seq_len: int = 4,
    has_clip: bool = True,
    has_clip_image: bool = False,
) -> np.ndarray:
    """(1, S_cond) reweight vector amplifying/suppressing one phrase of the prompt.

    Example: reweight_for_phrase("a red car on a beach", "red", 3.0, byt5_len)
    triples the attention every pixel pays to the bytes of "red".
    """
    span = phrase_byte_span(prompt, phrase)
    if span is None:
        raise ValueError(f"phrase {phrase!r} not found in prompt {prompt!r}")
    return build_cond_reweight(
        byt5_len,
        [(span[0], span[1], weight)],
        clip_seq_len=clip_seq_len,
        has_clip=has_clip,
        has_clip_image=has_clip_image,
    )
