"""Forward noising and loss weighting for token-space diffusion, the
counterparts of `paella_tpu/models/noise.py` (reference: src/modules.py:277-283,
src_distributed/modules.py:283-284). Draws come from an explicit
`torch.Generator`; `mask` and `random_x` can be pinned, which makes the
result JAX's exactly for JAX's draws."""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def draw_noise(
    shape,
    t: torch.Tensor,
    num_labels: int,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
    random_x: Optional[torch.Tensor] = None,
    dtype: torch.dtype = torch.int32,
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(mask, random_x) of `add_noise` over a token grid of `shape` on
    `device` (t's by default): those given are kept, the others drawn in
    this order. mask
    int32, 1 where u <= t, u ~ U[0, 1) float32; random_x of `dtype`,
    uniform in [0, num_labels)."""
    device = t.device if device is None else device
    if mask is None:
        u = torch.rand(shape, generator=generator, device=device)
        mask = (u <= t.reshape(t.shape + (1,) * (len(shape) - t.dim()))).to(torch.int32)
    if random_x is None:
        random_x = torch.randint(0, num_labels, shape, generator=generator, device=device, dtype=dtype)
    return mask, random_x


def add_noise(
    x: torch.Tensor,
    t: torch.Tensor,
    num_labels: int,
    generator: Optional[torch.Generator] = None,
    mask: Optional[torch.Tensor] = None,
    random_x: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replace a Bernoulli(t) share of the tokens with uniform codebook ids.

    x (B, H, W) integer tokens, t (B,) noise levels. A token
    is replaced where u <= t, u ~ U[0, 1) float32; the ids are uniform in
    [0, num_labels) (`draw_noise`). Returns (noised, mask), mask int32 with
    1 at replaced positions."""
    mask, random_x = draw_noise(x.shape, t, num_labels, generator, mask, random_x, x.dtype, x.device)
    noised = x * (1 - mask) + random_x * mask
    return noised.to(x.dtype), mask


def get_loss_weight(t: torch.Tensor, mask: torch.Tensor, min_val: float = 0.3) -> torch.Tensor:
    """1 - (1 - mask)(1 - t)(1 - min_val), float32: noised tokens weigh 1,
    clean ones fall toward min_val as t -> 0, in JAX's order of operations."""
    t_b = t.float().reshape(t.shape + (1,) * (mask.dim() - t.dim()))
    return 1.0 - (1.0 - mask.float()) * ((1.0 - t_b) * (1.0 - min_val))
