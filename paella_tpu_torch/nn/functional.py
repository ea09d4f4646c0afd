"""Stateless functional ops shared across the port (NHWC, channels-last),
the counterparts of `paella_tpu/nn/functional.py`."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def layer_norm(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LayerNorm over the last axis with no learned affine, eps 1e-6 as every
    LayerNorm of the reference denoiser and codec (F.layer_norm's default is
    1e-5). torch's kernel takes the statistics in float32 for bf16 input, as
    the JAX package does; the result has x's dtype. One kernel launch."""
    return F.layer_norm(x, x.shape[-1:], eps=eps)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """Exact (erf) GELU."""
    return F.gelu(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    return F.silu(x)


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC torch.nn.PixelUnshuffle: out channel c*r^2 + i*r + j holds the
    intra-patch offset (i, j) of input channel c."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // r, r, w // r, r, c)
    x = x.permute(0, 1, 3, 5, 2, 4)  # (b, h/r, w/r, c, i, j)
    return x.reshape(b, h // r, w // r, c * r * r)


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """NHWC torch.nn.PixelShuffle, the inverse of :func:`space_to_depth`."""
    b, h, w, c = x.shape
    c_out = c // (r * r)
    x = x.reshape(b, h, w, c_out, r, r)
    x = x.permute(0, 1, 4, 2, 5, 3)  # (b, h, i, w, j, c_out)
    return x.reshape(b, h * r, w * r, c_out)


def replication_pad_2d(x: torch.Tensor, pad: int) -> torch.Tensor:
    """NHWC torch.nn.ReplicationPad2d."""
    y = F.pad(x.permute(0, 3, 1, 2), (pad, pad, pad, pad), mode="replicate")
    return y.permute(0, 2, 3, 1)


def sinusoidal_embedding(r: torch.Tensor, dim: int, max_positions: int = 10000) -> torch.Tensor:
    """Timestep embedding (reference: src/modules.py:212-221): `r` in (0, 1]
    is scaled by max_positions; returns sin||cos of shape (B, dim), float32."""
    r = r.float() * max_positions
    half_dim = dim // 2
    emb = math.log(max_positions) / (half_dim - 1)
    emb = torch.exp(torch.arange(half_dim, dtype=torch.float32, device=r.device) * -emb)
    emb = r[:, None] * emb[None, :]
    emb = torch.cat([torch.sin(emb), torch.cos(emb)], dim=1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb
