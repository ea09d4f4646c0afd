"""The f4 VQGAN (dome272/Paella `src/vqgan.py:6-112`) as plain torch over a
state dict in the reference layout, NHWC: the nearest-code encode (for the
training step's labels) and the decode of a token grid.

VQResBlock: LayerNorm (eps 1e-6) scaled and shifted by learned gammas,
replication-padded depthwise 3x3 conv, gated residual; LayerNorm, the
channelwise MLP (exact GELU), gated residual. The encoder ends in BatchNorm
with its running statistics (eps 1e-5); the decoder ends in PixelShuffle(2).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .nn import Params, depth_to_space, layer_norm, linear, space_to_depth


def _levels(cfg: dict) -> list:
    return [cfg["c_hidden"] // 2**i for i in reversed(range(cfg["levels"]))]


def _vq_resblock(P, pre, x):
    g = P(pre + "gammas", cast=False)
    h = layer_norm(x) * (1 + g[0]) + g[1]
    h = F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    c = x.shape[-1]
    h = F.conv2d(P.act(h), P(pre + "depthwise.1.weight"), P(pre + "depthwise.1.bias", cast=False), groups=c)
    x = x + h.permute(0, 2, 3, 1) * g[2]
    h = layer_norm(x) * (1 + g[3]) + g[4]
    h = linear(P, F.gelu(linear(P, h, pre + "channelwise.0.weight", pre + "channelwise.0.bias")),
               pre + "channelwise.2.weight", pre + "channelwise.2.bias")
    return x + h * g[5]


def decode_indices(P: Params, cfg: dict, idx: torch.Tensor) -> torch.Tensor:
    """(B, h, w) token grid -> (B, 4h, 4w, 3) image, unclipped."""
    h = linear(P, P("vquantizer.codebook.weight", cast=False)[idx.long()], "up_blocks.0.0.weight", "up_blocks.0.0.bias")
    j = 1
    for i in range(cfg["levels"]):
        for _ in range(cfg["bottleneck_blocks"] if i == 0 else 1):
            h = _vq_resblock(P, f"up_blocks.{j}.", h)
            j += 1
        if i < cfg["levels"] - 1:
            y = F.conv_transpose2d(P.act(h).permute(0, 3, 1, 2), P(f"up_blocks.{j}.weight"),
                                   P(f"up_blocks.{j}.bias", cast=False), stride=2, padding=1)
            h = y.permute(0, 2, 3, 1)
            j += 1
    return depth_to_space(linear(P, h, "out_block.0.weight", "out_block.0.bias"), 2)


def encode_indices(P: Params, cfg: dict, images: torch.Tensor, running_mean: torch.Tensor,
                   running_var: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images -> (B, H/4, W/4) nearest-code indices, the
    encoder's BatchNorm at the running statistics given."""
    h = linear(P, space_to_depth(images, 2), "in_block.1.weight", "in_block.1.bias")
    j = 0
    for i in range(cfg["levels"]):
        if i > 0:
            y = F.conv2d(P.act(h).permute(0, 3, 1, 2), P(f"down_blocks.{j}.weight"), P(f"down_blocks.{j}.bias", cast=False),
                         stride=2, padding=1)
            h = y.permute(0, 2, 3, 1)
            j += 1
        h = _vq_resblock(P, f"down_blocks.{j}.", h)
        j += 1
    z = linear(P, h, f"down_blocks.{j}.0.weight")
    mean, var = running_mean.float(), running_var.float()
    z = (z - mean) * (torch.rsqrt(var + 1e-5) * P(f"down_blocks.{j}.1.weight", cast=False)) + P(f"down_blocks.{j}.1.bias", cast=False)
    cb = P("vquantizer.codebook.weight", cast=False)
    d = (cb * cb).sum(-1) - 2.0 * torch.einsum("bhwc,kc->bhwk", z, cb)
    return d.argmin(dim=-1)
