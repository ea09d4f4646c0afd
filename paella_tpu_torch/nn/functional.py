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


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """Keys' cubic kernel with a = -0.5 (F.interpolate's bicubic uses -0.75)."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_RESIZE_KERNELS = {"bicubic": _keys_cubic, "bilinear": _triangle}


def _resize_weights(n_in: int, n_out: int, method: str, device=None) -> torch.Tensor:
    """The (n_out, n_in) float32 resampling matrix of one axis, as
    `jax.image.scale_and_translate` builds it (jax/_src/image/scale.py):
    half-pixel centres, the kernel widened by in/out when downsampling
    (antialiasing), each output's weights renormalised to sum to one (which
    is what handles the border), and an output whose centre falls outside
    the input zeroed."""
    kernel = _RESIZE_KERNELS[method]
    inv_scale = 1.0 / (n_out / n_in)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float32, device=device)[:, None]).abs() / kernel_scale
    w = kernel(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * torch.finfo(torch.float32).eps, w / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, 0.0).T.contiguous()


def resize(images: torch.Tensor, size: tuple[int, int], method: str) -> torch.Tensor:
    """(B, H, W, C) -> (B, size[0], size[1], C), bicubic or bilinear, equal
    to `jax.image.resize(images, ..., method)` (antialiased when
    downsampling): one weight matrix per axis (:func:`_resize_weights`), applied
    with two einsums in float32 (the JAX package's images are float32). An
    axis whose size does not change is left as it is, as JAX does."""
    if method not in _RESIZE_KERNELS:
        raise ValueError(f"resize method {method!r}: 'bicubic' or 'bilinear'")
    x = images.float()
    h, w = x.shape[1:3]
    if size[0] != h:
        x = torch.einsum("oh,bhwc->bowc", _resize_weights(h, size[0], method, x.device), x)
    if size[1] != w:
        x = torch.einsum("ow,bhwc->bhoc", _resize_weights(w, size[1], method, x.device), x)
    return x
