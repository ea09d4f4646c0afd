"""Torch-layout weight initializers drawing from an explicit torch.Generator.

They reproduce the distributions of `paella_tpu/nn/init.py` (which in turn
reproduce the reference's torch init scheme, src/modules.py:189-210) on the
torch layouts the port stores:

- Linear weight (out, in);
- Conv weight (out, in/groups, kh, kw);
- ConvTranspose weight (in, out, kh, kw).

Fans follow torch: fan_in = shape[1] * receptive, fan_out = shape[0] * receptive.
For a ConvTranspose weight that makes fan_in the OUT channel count times the
kernel area, as in torch and in the JAX package.
"""
from __future__ import annotations

import math

import torch


def _fans(shape) -> tuple[int, int]:
    if len(shape) < 2:
        raise ValueError(f"need >=2D shape, got {tuple(shape)}")
    receptive = 1
    for s in shape[2:]:
        receptive *= s
    return shape[1] * receptive, shape[0] * receptive


@torch.no_grad()
def uniform_(t: torch.Tensor, bound: float, gen: torch.Generator) -> torch.Tensor:
    return t.uniform_(-bound, bound, generator=gen)


@torch.no_grad()
def xavier_uniform_(t: torch.Tensor, gen: torch.Generator, gain: float = 1.0) -> torch.Tensor:
    """torch.nn.init.xavier_uniform_ with gain. On MultiheadAttention's packed
    (3c, c) in_proj_weight this gives the joint bound sqrt(6 / (c + 3c)) that
    the JAX package's packed_qkv_xavier_uniform uses per projection."""
    fan_in, fan_out = _fans(t.shape)
    return uniform_(t, gain * math.sqrt(6.0 / (fan_in + fan_out)), gen)


@torch.no_grad()
def kaiming_uniform_leaky_(t: torch.Tensor, gen: torch.Generator, a: float = math.sqrt(5.0)) -> torch.Tensor:
    """torch's default Linear/Conv/ConvTranspose weight init: U(+-1/sqrt(fan_in))."""
    fan_in, _ = _fans(t.shape)
    gain = math.sqrt(2.0 / (1.0 + a * a))
    return uniform_(t, gain * math.sqrt(3.0 / fan_in), gen)


@torch.no_grad()
def torch_default_bias_(t: torch.Tensor, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """torch Linear/Conv default bias init: U(+-1/sqrt(fan_in))."""
    return uniform_(t, 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0, gen)


@torch.no_grad()
def normal_(t: torch.Tensor, std: float, gen: torch.Generator) -> torch.Tensor:
    return t.normal_(0.0, std, generator=gen)


@torch.no_grad()
def zeros_(t: torch.Tensor) -> torch.Tensor:
    return t.zero_()
