"""The Paella denoiser (dome272/Paella `src/modules.py:7-283`) as plain
torch functions over a state dict in the reference layout, NHWC.

Written from the published module: the 3-level UNet of ResBlocks (grouped
depthwise 3x3 conv, LayerNorm, the channelwise MLP with GELU and
GlobalResponseNorm, residual), TimestepBlocks (FiLM by the sinusoidal noise
embedding) and AttnBlocks (self attention over the pixels joined with the
mapped conditioning tokens), strided 2x2 down and up convolutions, skips
concatenated into the first ResBlock of each level on the way up, and the
tied-layout head. Every LayerNorm has no affine and eps 1e-6. Dropout (train
only) draws each block's mask as the program does (`dropout_mask`): a
generator seeded by (dropout_seed, the level's pass, the block's index).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from .nn import Params, attention, depth_to_space, layer_norm, linear, sinusoidal_embedding, space_to_depth


def cond_embedding(P: Params, cfg: dict, byt5, byt5_mask, clip=None, clip_mask=None, clip_image=None,
                   clip_image_mask=None):
    """The conditioning sequence (B, S, c_cond) and its mask (B, S): the
    mapped ByT5 states, then clip_seq_len tokens of each CLIP embedding."""
    b = byt5.shape[0]
    parts = [linear(P, byt5, "byt5_mapper.weight", "byt5_mapper.bias")]
    masks = [byt5_mask]
    for emb, mask, name in ((clip, clip_mask, "clip_mapper"), (clip_image, clip_image_mask, "clip_image_mapper")):
        if emb is None:
            continue
        parts.append(linear(P, emb, name + ".weight", name + ".bias").reshape(b, cfg["clip_seq_len"], -1))
        m = torch.ones(b, dtype=torch.bool, device=byt5.device) if mask is None else mask
        masks.append(m[:, None].expand(b, cfg["clip_seq_len"]))
    return layer_norm(torch.cat(parts, dim=1)), torch.cat(masks, dim=1)


def level_blocks(cfg: dict, i: int) -> list:
    """The block kinds of one pass through level i: "C", "T", "A" per repetition."""
    return [bt for _ in range(cfg["blocks"][i]) for bt in cfg["level_config"][i]]


def _grn(P, pre, h):
    gx = torch.sqrt(h.square().sum(dim=(1, 2), keepdim=True))
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    gamma, beta = P(pre + "gamma", cast=False).reshape(-1), P(pre + "beta", cast=False).reshape(-1)
    return gamma * (h * nx) + beta + h


def resblock(P, pre, x, skip=None, drop=None):
    h = x if skip is None else torch.cat([x, skip], dim=-1)
    c = x.shape[-1]
    h = F.conv2d(P.act(h).permute(0, 3, 1, 2), P(pre + "depthwise.weight"), P(pre + "depthwise.bias", cast=False),
                 padding=1, groups=c).permute(0, 2, 3, 1)
    h = F.gelu(linear(P, layer_norm(h), pre + "channelwise.0.weight", pre + "channelwise.0.bias"))
    h = _grn(P, pre + "channelwise.2.", h)
    if drop is not None:
        h = drop(h)
    return linear(P, h, pre + "channelwise.4.weight", pre + "channelwise.4.bias") + x


def timestep(P, pre, x, r_embed):
    ab = linear(P, r_embed, pre + "mapper.weight", pre + "mapper.bias")
    a, b = ab[:, None, None, :].chunk(2, dim=-1)
    return x * (1 + a) + b


def attn_block(P, pre, x, c_embed, cond_mask, nhead, drop=None):
    b, hh, ww, c = x.shape
    kv = linear(P, F.silu(c_embed), pre + "kv_mapper.1.weight", pre + "kv_mapper.1.bias")
    tokens = layer_norm(x).reshape(b, hh * ww, c)
    kv_full = torch.cat([tokens, kv], dim=1)
    mask = torch.cat([torch.ones(b, hh * ww, dtype=torch.bool, device=x.device), cond_mask], dim=1)
    w, bias = P(pre + "attention.attn.in_proj_weight"), P(pre + "attention.attn.in_proj_bias", cast=False)
    q = F.linear(P.act(tokens), w[:c], bias[:c])
    k = F.linear(P.act(kv_full), w[c:2 * c], bias[c:2 * c])
    v = F.linear(P.act(kv_full), w[2 * c:], bias[2 * c:])
    d = c // nhead
    out = attention(q.reshape(b, -1, nhead, d), k.reshape(b, -1, nhead, d), v.reshape(b, -1, nhead, d), mask,
                    dropout=drop)
    out = linear(P, out.reshape(b, hh * ww, c), pre + "attention.attn.out_proj.weight",
                 pre + "attention.attn.out_proj.bias")
    return x + out.reshape(b, hh, ww, c)


def dropout_mask(seed: int, place: int, j: int, rate: float, device, rows: slice, batch: int):
    """The program's per-block dropout: keep with probability 1 - rate from a
    generator seeded (seed * 1_000_003 + place * 4096 + j) mod 2^63, scale by
    1 / (1 - rate) (frozen from paella_tpu_torch/models/denoiser.py
    `_run_level_train` and nn/blocks.py `dropout`). The program draws one
    mask for its whole batch of `batch` rows; a microbatch holding `rows` of
    it draws that mask and keeps its own rows."""
    gen = torch.Generator(device=device).manual_seed((seed * 1_000_003 + place * 4096 + j) % 2**63)

    def drop(t):
        keep = torch.rand((batch,) + tuple(t.shape[1:]), generator=gen, device=t.device)[rows] < 1.0 - rate
        return torch.where(keep, t / (1.0 - rate), torch.zeros_like(t))

    return drop


def _run_level(P, cfg, pre, place, i, kinds, offset, h, skip, r_embed, c_embed, cond_mask, dropout):
    seed, rows, batch = dropout if dropout is not None else (None, None, None)
    rate = cfg["dropout"][i] if seed is not None else 0.0
    j = 0
    while j < len(kinds):
        kind, name = kinds[j], f"{pre}.{offset + j}."
        drop = dropout_mask(seed, place, offset + j, rate, h.device, rows, batch) if rate > 0 and kind in "CA" else None
        if kind == "C":
            h = resblock(P, name, h, skip if j == 0 else None, drop)
        elif kind == "T":
            h = timestep(P, name, h, r_embed)
        elif kind == "A":
            h = attn_block(P, name, h, c_embed, cond_mask, cfg["nhead"][i], drop)
        else:
            raise ValueError(f"block kind {kind!r}")
        j += 1
    return h


def features(P: Params, cfg: dict, x, r, c_embed, cond_mask, dropout: Optional[tuple] = None):
    """Pre-head features (B, H, W, c_out) of token grid x (B, H, W) at noise r
    (B,). dropout (train only): (seed, the rows of the step's batch that x
    holds, that batch's size)."""
    n, p = len(cfg["c_hidden"]), cfg["patch_size"]
    r_embed = sinusoidal_embedding(r, cfg["c_r"])
    h = layer_norm(P("in_mapper.0.weight", cast=False)[x.long()])
    h = layer_norm(linear(P, space_to_depth(h, p), "embedding.1.weight", "embedding.1.bias"))
    ctx = (r_embed, c_embed, cond_mask, dropout)
    outs = []
    for i in range(n):
        offset = 0
        if i > 0:
            h = _down(P, f"down_blocks.{i}.0.", h)
            offset = 1
        h = _run_level(P, cfg, f"down_blocks.{i}", i, i, level_blocks(cfg, i), offset, h, None, *ctx)
        outs.insert(0, h)
    h = outs[0]
    for iu, i in enumerate(reversed(range(n))):
        kinds = level_blocks(cfg, i)
        h = _run_level(P, cfg, f"up_blocks.{iu}", n + iu, i, kinds, 0, h, outs[iu] if iu > 0 else None, *ctx)
        if i > 0:
            h = _up(P, f"up_blocks.{iu}.{len(kinds)}.", h)
    h = linear(P, layer_norm(h), "clf.1.weight", "clf.1.bias")
    return layer_norm(depth_to_space(h, p))


def head(P: Params, feats: torch.Tensor) -> torch.Tensor:
    return linear(P, feats, "out_mapper.1.weight")


def _down(P, pre, x):
    y = F.conv2d(P.act(layer_norm(x)).permute(0, 3, 1, 2), P(pre + "1.weight"), P(pre + "1.bias", cast=False), stride=2)
    return y.permute(0, 2, 3, 1)


def _up(P, pre, x):
    y = F.conv_transpose2d(P.act(layer_norm(x)).permute(0, 3, 1, 2), P(pre + "1.weight"), P(pre + "1.bias", cast=False),
                           stride=2)
    return y.permute(0, 2, 3, 1)
