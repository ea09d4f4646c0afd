"""The ByT5 text encoder (T5 v1.1 encoder stack), the counterpart of
`paella_tpu/cond/t5.py`, with its int8 modes.

Architecture (T5 v1.1 / ByT5): RMSNorm pre-norm blocks, relative position
bias (bucketed, computed once from block 0's table and shared), no 1/sqrt(d)
attention scaling (folded into the init by T5 convention), gated tanh-GELU
(`gelu_new`) feed-forward. Held to the JAX package, not to HF: the bucket
adds 1e-6 inside the log and truncates, scores are f32 with a -1e9 mask,
the softmax is cast to v's dtype, and the RMS variance is f32.

Parameters keep HF T5EncoderModel's names (`shared.weight`,
`encoder.block.{i}.layer.0.SelfAttention.q.weight`, ...,
`encoder.final_layer_norm.weight`), so such a state dict loads with
`strict=True`; HF's tied copy `encoder.embed_tokens.weight` is dropped on
load. `convert.t5_state_dict_from_jax` gives the same layout from a JAX
T5Encoder tree.

After quant.quantize_t5_int8 every block linear is an int8
quant.Int8Linear: weight-only (dequantized per output channel before a float
product), or with `T5Config.act_quant` a W8A8 product (quant.w8a8_dot).
The encoder is a callable (ids, mask) -> states, the pipeline's
`byt5_encode_fn`. On a card its forward is a CUDA graph replay, one
graph per input signature (sampling/graph.py::tower): a fresh prompt costs
one launch instead of thousands of eager ops. The graph's key holds the
module, its config (`act_quant` included), the device, the ids' and mask's
shapes and dtypes, and its weights' storage, never the values of the ids or
the mask, nor the derived-weight generation (it moves at every training
update; the encoder is frozen). On the CPU, and when called inside another
capture, the forward runs eagerly, op by op.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..nn import init
from ..quant import check_int8_state, w8a8_dot
from ..sampling import graph


@dataclasses.dataclass(frozen=True)
class T5Config:
    """Field for field the JAX package's T5Config (paella_tpu/cond/t5.py:27-61)."""

    vocab_size: int = 384  # ByT5: 256 bytes + 3 special + 125 extra ids
    d_model: int = 2560  # byt5-xl (hence byt5_embd=2560)
    d_kv: int = 64
    num_heads: int = 32
    d_ff: int = 6720
    num_layers: int = 36
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    dtype: str = "float32"
    # W8A8 for the block linears of a quantize_t5_int8 model; inert on float
    # weights
    act_quant: bool = False

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def byt5_xl(cls, dtype: str = "bfloat16") -> "T5Config":
        return cls(dtype=dtype)

    @classmethod
    def byt5_small_like(cls) -> "T5Config":
        return cls(d_model=1472, d_ff=3584, num_layers=12, num_heads=6, dtype="float32")

    @classmethod
    def tiny(cls) -> "T5Config":
        return cls(vocab_size=384, d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float) -> torch.Tensor:
    """T5LayerNorm: scale-only RMS norm, variance in f32."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (weight * (x32 * torch.rsqrt(var + eps))).to(x.dtype)


def relative_position_bucket(rel: torch.Tensor, num_buckets: int = 32, max_distance: int = 128) -> torch.Tensor:
    """T5's bidirectional relative-position bucketing (log-spaced beyond
    half), as the JAX package computes it: 1e-6 inside the log, f32, then
    truncated."""
    num_buckets //= 2
    ret = (rel > 0).to(torch.int32) * num_buckets
    n = rel.abs()
    max_exact = num_buckets // 2
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-6) / math.log(max_distance / max_exact) * (num_buckets - max_exact)
    ).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(n < max_exact, n.to(torch.int32), val_if_large)


def t5_dense(layer: nn.Module, x: torch.Tensor, cfg: T5Config) -> torch.Tensor:
    """A bias-free block linear in the compute dtype: float weights, int8
    codes dequantized per output channel (weight-only), or, under
    cfg.act_quant, a W8A8 product of the codes."""
    dt = cfg.compute_dtype
    scale = getattr(layer, "weight_scale", None)
    if scale is None:
        return F.linear(x.to(dt), layer.weight.to(dt))
    if cfg.act_quant:
        return w8a8_dot(x, layer.weight, scale, dt)
    return layer(x.to(dt))  # quant.Int8Linear: dequantized codes


class T5LayerNorm(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        inner = cfg.num_heads * cfg.d_kv
        self.q, self.k, self.v = (nn.Linear(cfg.d_model, inner, bias=False) for _ in range(3))
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)

    def forward(self, x, mask, position_bias, cfg: T5Config):
        b, s, _ = x.shape
        q, k, v = (t5_dense(lin, x, cfg).reshape(b, s, cfg.num_heads, cfg.d_kv) for lin in (self.q, self.k, self.v))
        # no 1/sqrt(d) scale (T5 folds it into the init); f32 scores
        scores = torch.einsum("bnhd,bshd->bhns", q.float(), k.float()) + position_bias.float()
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhns,bshd->bnhd", probs, v).reshape(b, s, -1)
        return t5_dense(self.o, out, cfg)


class _T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model)


class _T5DenseGatedActDense(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)


class _T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = _T5DenseGatedActDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model)


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_bias: bool = False):
        super().__init__()
        self.layer = nn.ModuleList([_T5LayerSelfAttention(cfg, has_relative_bias), _T5LayerFF(cfg)])

    def forward(self, x, mask, position_bias, cfg: T5Config):
        att, ff = self.layer
        eps = cfg.layer_norm_epsilon
        x = x + att.SelfAttention(rms_norm(x, att.layer_norm.weight, eps), mask, position_bias, cfg)
        h = rms_norm(x, ff.layer_norm.weight, eps)
        d = ff.DenseReluDense
        h = F.gelu(t5_dense(d.wi_0, h, cfg), approximate="tanh") * t5_dense(d.wi_1, h, cfg)  # gelu_new
        return x + t5_dense(d.wo, h, cfg)


class _T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList([T5Block(cfg, has_relative_bias=i == 0) for i in range(cfg.num_layers)])
        self.final_layer_norm = T5LayerNorm(cfg.d_model)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        state_dict.pop(f"{prefix}embed_tokens.weight", None)  # HF's tied copy of shared.weight
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class T5Encoder(nn.Module):
    """forward(input_ids (B, S) int, attention_mask (B, S) bool or None) ->
    last_hidden_state (B, S, d_model) in the compute dtype, matching the JAX
    T5Encoder."""

    def __init__(self, config: T5Config):
        super().__init__()
        self.config = config
        self.shared = nn.Embedding(config.vocab_size, config.d_model)
        self.encoder = _T5Stack(config)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's init distributions: N(0, 1) embedding and
        relative-bias table, ones for the norms, and N(0, 1/fan_in) (the
        variance of lecun_normal, untruncated) for every block linear."""
        init.normal_(self.shared.weight, 1.0, gen)
        for blk in self.encoder.block:
            att, ff = blk.layer
            if hasattr(att.SelfAttention, "relative_attention_bias"):
                init.normal_(att.SelfAttention.relative_attention_bias.weight, 1.0, gen)
            for lin in (att.SelfAttention.q, att.SelfAttention.k, att.SelfAttention.v, att.SelfAttention.o,
                        ff.DenseReluDense.wi_0, ff.DenseReluDense.wi_1, ff.DenseReluDense.wo):
                init.normal_(lin.weight, lin.weight.shape[1] ** -0.5, gen)
            att.layer_norm.weight.fill_(1.0)
            ff.layer_norm.weight.fill_(1.0)
        self.encoder.final_layer_norm.weight.fill_(1.0)

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """On a card, a replay of the graph captured for this call's input
        signature (batch, bucket, dtypes), the config and the weights' storage
        (sampling/graph.py::tower), which copies the ids and the mask in and
        returns a new tensor; on the CPU, and inside an outer capture, the
        eager forward. Every int8 mode takes the graph route too."""
        return graph.tower(self, "byt5", self._forward, {"input_ids": input_ids, "attention_mask": attention_mask})

    def _forward(self, input_ids: torch.Tensor, attention_mask: Optional[torch.Tensor]) -> torch.Tensor:
        cfg = self.config
        x = self.shared.weight[input_ids.long()].to(cfg.compute_dtype)
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        buckets = relative_position_bucket(
            pos[None, :] - pos[:, None], cfg.relative_attention_num_buckets, cfg.relative_attention_max_distance
        )
        table = self.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        position_bias = table[buckets.long()].permute(2, 0, 1)[None]  # (1, heads, S, S)
        mask = None if attention_mask is None else attention_mask.bool()
        for blk in self.encoder.block:
            x = blk(x, mask, position_bias, cfg)
        return rms_norm(x, self.encoder.final_layer_norm.weight, cfg.layer_norm_epsilon)

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        check_int8_state(self, state_dict, prefix)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)
