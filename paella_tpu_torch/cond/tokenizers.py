"""Tokenizers for the frozen conditioning encoders, a copy of
`paella_tpu/cond/tokenizers.py` (pure Python and numpy; importing the JAX
package pulls in jax). tests/test_torch_pipeline.py pins the ByT5 half to the
original and tests/test_torch_clip.py the CLIP half.

ByT5 tokenization is byte-level and needs no vocabulary files: token id =
utf-8 byte + 3 (special ids: pad=0, eos=1, unk=2), with an EOS appended
(the reference calls HF AutoTokenizer, src_distributed/train.py:83).

CLIP tokenization is a from-scratch byte-level BPE replacing the reference's
open_clip.tokenize (reference: src_distributed/utils.py:73-75). Vocab/merges
are DATA: supply the standard `bpe_simple_vocab_16e6.txt.gz` shipped with every
CLIP distribution as a local file; the algorithm lives here.
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


# ---------------------------------------------------------------------------
# CLIP byte-level BPE
# ---------------------------------------------------------------------------

import gzip
import html
from functools import lru_cache

try:  # exact \p{L}/\p{N} classes, same module transformers/open_clip use
    import regex as _re
except ImportError:  # pragma: no cover - regex ships with transformers
    import re as _re

# open_clip/CLIP/transformers all truncate the 16e6 merge file to this many
# entries (their shared magic slice [1 : 49152 - 256 - 2 + 1]); with the
# 512 byte-level symbols and 2 specials this yields the CLIP vocab of 49408.
DEFAULT_NUM_MERGES = 49152 - 256 - 2 + 1 - 1  # = 48894

_PAT = _re.compile(
    r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[\p{L}]+|[\p{N}]|[^\s\p{L}\p{N}]+"""
    if _re.__name__ == "regex"
    else r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""",
    _re.IGNORECASE,
)


@lru_cache()
def bytes_to_unicode() -> dict:
    """GPT-2's reversible byte -> printable-unicode map: the 188 'nice' bytes map
    to themselves, the rest to codepoints 256+, so every byte string becomes a
    string of distinct printable characters the merge table can refer to."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(ord("\xa1"), ord("\xac") + 1))
        + list(range(ord("\xae"), ord("\xff") + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(2**8):
        if b not in bs:
            bs.append(b)
            cs.append(2**8 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def _get_pairs(word: tuple) -> set:
    return {(a, b) for a, b in zip(word, word[1:])}


def _whitespace_clean(text: str) -> str:
    return _re.sub(r"\s+", " ", text).strip()


def _basic_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    return html.unescape(html.unescape(text)).strip()


class CLIPTokenizer:
    """Byte-level BPE with end-of-word markers, CLIP flavor.

    bpe_path: the merge table — `bpe_simple_vocab_16e6.txt.gz` (or an
    uncompressed copy / any file in the same format: a header line followed by
    one space-separated merge pair per line).
    """

    def __init__(self, bpe_path: str, num_merges: int = DEFAULT_NUM_MERGES):
        if bpe_path.endswith(".gz"):
            with gzip.open(bpe_path, "rt", encoding="utf-8") as f:
                lines = f.read().strip().split("\n")
        else:
            with open(bpe_path, encoding="utf-8") as f:
                lines = f.read().strip().split("\n")
        merges = [tuple(m.split()) for m in lines[1 : num_merges + 1]]

        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        vocab: List[str] = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab]
        vocab.extend("".join(m) for m in merges)
        vocab.extend(["<start_of_text>", "<end_of_text>"])
        self.encoder = {tok: i for i, tok in enumerate(vocab)}
        self.decoder = {i: tok for tok, i in self.encoder.items()}
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.cache = {
            "<start_of_text>": "<start_of_text>",
            "<end_of_text>": "<end_of_text>",
        }
        self.vocab_size = len(vocab)
        self.sot_token_id = self.encoder["<start_of_text>"]
        self.eot_token_id = self.encoder["<end_of_text>"]

    def bpe(self, token: str) -> str:
        """Greedy lowest-rank merging of one pre-token; returns space-joined
        subwords. Last character carries the </w> end-of-word marker."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = _get_pairs(word)
        if not pairs:
            return token + "</w>"

        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if word[i] == first and i < len(word) - 1 and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = _get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        ids: List[int] = []
        text = _whitespace_clean(_basic_clean(text)).lower()
        for token in _re.findall(_PAT, text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        text = "".join(self.decoder[int(i)] for i in ids)
        return (
            bytearray(self.byte_decoder[c] for c in text)
            .decode("utf-8", errors="replace")
            .replace("</w>", " ")
        )

    def __call__(
        self, prompts: Sequence[str], context_length: int = 77
    ) -> np.ndarray:
        """prompts -> (B, context_length) int32, [SOT] ids [EOT] zero-padded;
        over-length sequences are truncated with the final token forced to EOT
        (open_clip's tokenize contract)."""
        if isinstance(prompts, str):
            prompts = [prompts]
        result = np.zeros((len(prompts), context_length), np.int32)
        for i, text in enumerate(prompts):
            tokens = [self.sot_token_id] + self.encode(text) + [self.eot_token_id]
            if len(tokens) > context_length:
                tokens = tokens[:context_length]
                tokens[-1] = self.eot_token_id
            result[i, : len(tokens)] = tokens
        return result


def write_merges_file(merges: Sequence[tuple], path: str, header: str = "#version: bpe") -> None:
    """Write a merge table in the standard format (testing / fixture helper)."""
    with open(path, "w", encoding="utf-8") as f:
        f.write(header + "\n")
        for a, b in merges:
            f.write(f"{a} {b}\n")
