"""Multi-head attention for the denoiser, in plain torch (the JAX package
runs this in XLA on the main path: attention_impl="xla"), the counterpart
of `paella_tpu/nn/attention.py`."""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

NEG_INF = -1e9  # mask fill value; fine for f32 and bf16 softmax inputs


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    reweight: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    dropout_keep: Optional[Callable] = None,
) -> torch.Tensor:
    """Attention over (B, N, H, D) queries and (B, S, H, D) keys/values.

    Scores are float32. kv_mask (B, S) bool, True = attend: a masked key gets
    -1e9, so a zero-padded conditioning token acts exactly like an absent one.
    reweight, broadcastable to (B, H, N, S), multiplies the post-softmax
    probabilities (reference: utils/alter_attention.py:34). With a mask source
    `dropout_keep` ((shape, device) -> a bool keep-mask, nn/blocks.py::
    DropoutMasks.site) and dropout_rate > 0 (training), each probability is
    then kept where its mask is true, with probability 1 - dropout_rate, and
    scaled by 1 / (1 - dropout_rate), in float32 before the cast to v's
    dtype, as the JAX package orders it.
    """
    scale = q.shape[-1] ** -0.5
    logits = torch.einsum("bnhd,bshd->bhns", q.float(), k.float()) * scale
    if kv_mask is not None:
        logits = logits.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    if reweight is not None:
        probs = probs * reweight
    if dropout_rate > 0.0 and dropout_keep is not None:
        probs = probs * dropout_keep(probs.shape, probs.device) / (1.0 - dropout_rate)
    probs = probs.to(v.dtype)
    return torch.einsum("bhns,bshd->bnhd", probs, v)


class MultiheadAttention(nn.Module):
    """torch.nn.MultiheadAttention(c, nhead, bias=True, batch_first=True)'s
    parameters (in_proj_weight (3c, c) packed q|k|v, in_proj_bias, out_proj),
    so a reference state dict loads as it is, evaluated in the module's
    compute dtype with `attention_fn` as the core (dot_product_attention's
    contract; kernels/attention.py::fused_attention is the other)."""

    def __init__(self, c: int, nhead: int, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.c, self.nhead, self.dtype = c, nhead, dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * c, c))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * c))
        self.out_proj = nn.Linear(c, c)

    def reset_parameters(self, gen: torch.Generator) -> None:
        from . import init

        init.xavier_uniform_(self.in_proj_weight, gen)
        init.zeros_(self.in_proj_bias)
        init.xavier_uniform_(self.out_proj.weight, gen)
        init.zeros_(self.out_proj.bias)

    def forward(
        self,
        q: torch.Tensor,
        kv: torch.Tensor,
        kv_mask: Optional[torch.Tensor] = None,
        reweight: Optional[torch.Tensor] = None,
        attention_fn: Callable = dot_product_attention,
    ) -> torch.Tensor:
        dt = self.dtype
        c, nh = self.c, self.nhead
        w, bias = self.in_proj_weight.to(dt), self.in_proj_bias.to(dt)
        xq = F.linear(q.to(dt), w[:c], bias[:c])
        xkv = F.linear(kv.to(dt), w[c:], bias[c:])
        xk, xv = xkv.split(c, dim=-1)
        b, n, _ = xq.shape
        s = xk.shape[1]
        out = attention_fn(
            xq.reshape(b, n, nh, c // nh),
            xk.reshape(b, s, nh, c // nh),
            xv.reshape(b, s, nh, c // nh),
            kv_mask=kv_mask,
            reweight=reweight,
        )
        return F.linear(out.reshape(b, n, c), self.out_proj.weight.to(dt), self.out_proj.bias.to(dt))
