"""ByT5 tokenization, a copy of the ByT5 half of
`paella_tpu/cond/tokenizers.py` (pure Python and numpy; importing the JAX
package pulls in jax, and tests/test_torch_pipeline.py pins the copy to the
original). The CLIP BPE tokenizer comes with the CLIP towers.

ByT5 tokenization is byte-level and needs no vocabulary files: token id =
utf-8 byte + 3 (special ids: pad=0, eos=1, unk=2), with an EOS appended
(the reference calls HF AutoTokenizer, src_distributed/train.py:83).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

BYT5_PAD_ID = 0
BYT5_EOS_ID = 1
BYT5_OFFSET = 3


def byt5_encode(text: str, max_length: int | None = None) -> List[int]:
    ids = [b + BYT5_OFFSET for b in text.encode("utf-8")]
    ids.append(BYT5_EOS_ID)
    if max_length is not None and len(ids) > max_length:
        # match HF truncation: cut then keep EOS as the final token
        ids = ids[: max_length - 1] + [BYT5_EOS_ID]
    return ids


def byt5_batch_encode(
    texts: Sequence[str],
    max_length: int | None = 768,
    pad_to: int | None = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Batch-encode with longest-padding (reference uses padding='longest',
    max_length=768, src_distributed/train.py:83). Returns (ids, mask) int32/bool.

    pad_to overrides the padded length (e.g. bucket sizes to avoid XLA
    recompilation across batches — the reference's dynamic `longest` padding
    would trigger a recompile per unique length under jit).
    """
    encoded = [byt5_encode(t, max_length) for t in texts]
    longest = max(len(e) for e in encoded) if encoded else 1
    target = pad_to if pad_to is not None else longest
    target = max(target, longest if pad_to is None else target)
    ids = np.full((len(encoded), target), BYT5_PAD_ID, np.int32)
    mask = np.zeros((len(encoded), target), bool)
    for i, e in enumerate(encoded):
        e = e[:target]
        ids[i, : len(e)] = e
        mask[i, : len(e)] = True
    return ids, mask


def byt5_decode(ids: Sequence[int]) -> str:
    data = bytes(i - BYT5_OFFSET for i in ids if i >= BYT5_OFFSET)
    return data.decode("utf-8", errors="ignore")


def pad_bucket(length: int, buckets: Sequence[int] = (64, 128, 256, 512, 768)) -> int:
    """Smallest bucket >= length (static-shape-friendly padding)."""
    for b in buckets:
        if length <= b:
            return b
    return ((length + 127) // 128) * 128
