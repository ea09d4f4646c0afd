"""The text encoders' reference: tokenizers, ByT5 (T5 v1.1 encoder) and the
CLIP text tower, plain float32 torch over state dicts in the HF / open_clip
layouts.

- ByT5 tokens are utf-8 bytes + 3 with EOS (1) appended (google/byt5).
- CLIP's byte-level BPE: a frozen copy of the algorithm of
  `paella_tpu_torch/cond/tokenizers.py::CLIPTokenizer` (itself openai/CLIP's
  `simple_tokenizer.py`), over a merge table handed in as pairs.
- T5 v1.1 (arXiv:1910.10683, HF `modeling_t5.py`): RMSNorm pre-norm blocks,
  relative position bias from block 0's table shared by all blocks,
  unscaled dot-product attention, gated tanh-GELU feed-forward; the bucket
  is computed as the JAX package computes it (1e-6 inside the log).
- CLIP text (arXiv:2103.00020, open_clip `transformer.py`): causal
  pre-LayerNorm transformer (eps 1e-5), exact GELU, the projected state at
  the EOT token.
"""
from __future__ import annotations

import math
import re
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from .nn import Params, attention, linear


def byt5_ids(text: str) -> list:
    return [b + 3 for b in text.encode("utf-8")] + [1]


def _bytes_to_unicode() -> dict:
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("\xa1"), ord("\xac") + 1)) + list(range(ord("\xae"), 256))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


_PAT = re.compile(r"""<start_of_text>|<end_of_text>|'s|'t|'re|'ve|'m|'ll|'d|[^\W\d_]+|\d|[^\s\w]+""", re.IGNORECASE)


class ClipBPE:
    """prompts -> (B, 77) int64 ids: [SOT] BPE ids [EOT], zero-padded."""

    def __init__(self, merges: Sequence[tuple]):
        self.byte_encoder = _bytes_to_unicode()
        vocab = list(self.byte_encoder.values())
        vocab = vocab + [v + "</w>" for v in vocab] + ["".join(m) for m in merges] + ["<start_of_text>", "<end_of_text>"]
        self.encoder = {t: i for i, t in enumerate(vocab)}
        self.ranks = {tuple(m): i for i, m in enumerate(merges)}
        self.sot, self.eot = self.encoder["<start_of_text>"], self.encoder["<end_of_text>"]

    def bpe(self, token: str) -> list:
        word = list(token[:-1]) + [token[-1] + "</w>"]
        while len(word) > 1:
            pairs = {(a, b) for a, b in zip(word, word[1:])}
            best = min(pairs, key=lambda p: self.ranks.get(p, math.inf))
            if best not in self.ranks:
                break
            out, i = [], 0
            while i < len(word):
                if i < len(word) - 1 and (word[i], word[i + 1]) == best:
                    out.append(word[i] + word[i + 1])
                    i += 2
                else:
                    out.append(word[i])
                    i += 1
            word = out
        return word

    def __call__(self, prompts: Sequence[str], context_length: int = 77) -> torch.Tensor:
        out = np.zeros((len(prompts), context_length), np.int64)
        for row, text in enumerate(prompts):
            ids = [self.sot]
            for token in _PAT.findall(re.sub(r"\s+", " ", text).strip().lower()):
                token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
                ids += [self.encoder[t] for t in self.bpe(token)]
            ids.append(self.eot)
            if len(ids) > context_length:
                ids = ids[:context_length]
                ids[-1] = self.eot
            out[row, : len(ids)] = ids
        return torch.from_numpy(out)


def _rel_bucket(rel: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    num_buckets //= 2
    ret = (rel > 0).long() * num_buckets
    n = rel.abs()
    exact = num_buckets // 2
    large = exact + (torch.log(n.float() / exact + 1e-6) / math.log(max_distance / exact) * (num_buckets - exact)).long()
    return ret + torch.where(n < exact, n, large.clamp(max=num_buckets - 1))


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.square().mean(dim=-1, keepdim=True) + eps))


def t5_encode(P: Params, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, S) with no padding -> states (B, S, d_model)."""
    b, s = ids.shape
    h, d, eps = cfg["num_heads"], cfg["d_kv"], cfg["layer_norm_epsilon"]
    x = P("shared.weight", cast=False)[ids]
    pos = torch.arange(s, device=ids.device)
    buckets = _rel_bucket(pos[None, :] - pos[:, None], cfg["relative_attention_num_buckets"],
                          cfg["relative_attention_max_distance"])
    table = P("encoder.block.0.layer.0.SelfAttention.relative_attention_bias.weight", cast=False)
    bias = table[buckets].permute(2, 0, 1)[None]
    for i in range(cfg["num_layers"]):
        pre = f"encoder.block.{i}.layer."
        y = _rms(x, P(pre + "0.layer_norm.weight", cast=False), eps)
        q, k, v = (linear(P, y, f"{pre}0.SelfAttention.{n}.weight").reshape(b, s, h, d) for n in "qkv")
        att = attention(q, k, v, scale=1.0, bias=bias).reshape(b, s, h * d)
        x = x + linear(P, att, pre + "0.SelfAttention.o.weight")
        y = _rms(x, P(pre + "1.layer_norm.weight", cast=False), eps)
        g = F.gelu(linear(P, y, pre + "1.DenseReluDense.wi_0.weight"), approximate="tanh")
        x = x + linear(P, g * linear(P, y, pre + "1.DenseReluDense.wi_1.weight"), pre + "1.DenseReluDense.wo.weight")
    return _rms(x, P("encoder.final_layer_norm.weight", cast=False), eps)


def _ln(P, x, pre, eps):
    return F.layer_norm(x, x.shape[-1:], P(pre + ".weight", cast=False), P(pre + ".bias", cast=False), eps)


def clip_text(P: Params, cfg: dict, ids: torch.Tensor) -> torch.Tensor:
    """ids (B, 77) -> (B, embed_dim), the projected state at each EOT."""
    b, s = ids.shape
    heads, eps = cfg["heads"], cfg["layer_norm_eps"]
    x = P("token_embedding.weight", cast=False)[ids] + P("positional_embedding", cast=False)[:s]
    causal = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()
    for i in range(cfg["layers"]):
        pre = f"transformer.resblocks.{i}."
        y = _ln(P, x, pre + "ln_1", eps)
        qkv = linear(P, y, pre + "attn.in_proj_weight", pre + "attn.in_proj_bias")
        q, k, v = (t.reshape(b, s, heads, -1) for t in qkv.chunk(3, dim=-1))
        sc = torch.einsum("bnhd,bshd->bhns", q, k) * q.shape[-1] ** -0.5
        p = torch.softmax(sc.masked_fill(~causal, -1e9), dim=-1)
        att = torch.einsum("bhns,bshd->bnhd", p, v).reshape(b, s, -1)
        x = x + linear(P, att, pre + "attn.out_proj.weight", pre + "attn.out_proj.bias")
        y = _ln(P, x, pre + "ln_2", eps)
        x = x + linear(P, F.gelu(linear(P, y, pre + "mlp.c_fc.weight", pre + "mlp.c_fc.bias")),
                       pre + "mlp.c_proj.weight", pre + "mlp.c_proj.bias")
    x = _ln(P, x, "ln_final", eps)
    feats = x[torch.arange(b, device=ids.device), ids.argmax(dim=-1)]
    return P.act(feats) @ P("text_projection")
