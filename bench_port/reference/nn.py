"""Plain float32 building blocks of the references.

`Params` reads a state dict ({name: tensor}, in any float dtype) and hands
each weight out in the reference's compute dtype, through an optional
`cast` that stands for a lower precision (the control). `matmul` and the
convolutions apply the same `cast` to their activations.
"""
from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


class Params:
    def __init__(self, sd: dict, dtype: torch.dtype = torch.float32, cast: Optional[Callable] = None):
        self.sd, self.dtype, self.cast = sd, dtype, cast

    def __call__(self, name: str, cast: bool = True) -> torch.Tensor:
        t = self.sd[name].to(self.dtype)
        return self.cast(t) if (cast and self.cast is not None) else t

    def act(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        return self.cast(x) if self.cast is not None else x


def linear(P: Params, x: torch.Tensor, w: str, b: Optional[str] = None) -> torch.Tensor:
    weight = P(w)
    if weight.dim() == 4:
        weight = weight[:, :, 0, 0]
    return F.linear(P.act(x), weight, None if b is None else P(b, cast=False))


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC PixelUnshuffle: channel c*r*r + i*r + j holds offset (i, j) of c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c).permute(0, 1, 3, 5, 2, 4)
    return x.reshape(b, h // r, w // r, c * r * r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    b, h, w, c = x.shape
    x = x.reshape(b, h, w, c // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(b, h * r, w * r, c // (r * r))


def sinusoidal_embedding(r: torch.Tensor, dim: int, max_positions: int = 10000) -> torch.Tensor:
    r = r.float() * max_positions
    half = dim // 2
    emb = math.log(max_positions) / (half - 1)
    emb = torch.exp(torch.arange(half, dtype=torch.float32, device=r.device) * -emb)
    emb = r[:, None] * emb[None, :]
    return torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)


def attention(q, k, v, mask=None, scale=None, bias=None, dropout=None):
    """(B, N, H, D) x (B, S, H, D): float scores, -1e9 at masked keys,
    softmax; `dropout(probs)` where given."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    s = torch.einsum("bnhd,bshd->bhns", q, k) * scale
    if bias is not None:
        s = s + bias
    if mask is not None:
        s = s.masked_fill(~mask[:, None, None, :], -1e9)
    p = torch.softmax(s, dim=-1)
    if dropout is not None:
        p = dropout(p)
    return torch.einsum("bhns,bshd->bnhd", p.to(v.dtype), v)


def _round8(t: torch.Tensor, dtype: torch.dtype, top: float) -> torch.Tensor:
    """t rounded to an fp8 format under one scale per tensor (its peak onto
    the format's largest value), back in t's dtype."""
    s = top / t.abs().amax().float().clamp(min=1e-30)
    return ((t.float() * s).to(dtype).float() / s).to(t.dtype)


class _Fp8(torch.autograd.Function):
    """Forward operands in e4m3, their gradients in e5m2: the two formats
    fp8 training computes its products in."""

    @staticmethod
    def forward(ctx, t):
        return _round8(t, torch.float8_e4m3fn, 448.0)

    @staticmethod
    def backward(ctx, g):
        return _round8(g, torch.float8_e5m2, 57344.0)


def fp8_round(t: torch.Tensor) -> torch.Tensor:
    """A product's operand in float8, the precision below bfloat16 that a
    control computes in: e4m3 forward, and under autograd its gradient in
    e5m2."""
    return _Fp8.apply(t) if t.requires_grad else _round8(t, torch.float8_e4m3fn, 448.0)
