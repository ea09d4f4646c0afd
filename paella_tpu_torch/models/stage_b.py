"""Stable Cascade's Stage B, the decoder (Würstchen v3, arXiv:2306.00637;
StableCascade `modules/stage_b.py`, diffusers' `StableCascadeUNet`),
inference only, NHWC, in the config's compute dtype.

Module and parameter names are StableCascade's, so its state dict maps onto
this one by name: `effnet_mapper.{0,2}`, `pixels_mapper.{0,2}`,
`clip_mapper`, `embedding.1`, `down_blocks[i]` / `up_blocks[i]`
(ModuleLists of ResBlock, TimestepBlock, AttnBlock), `down_downscalers.i.1`
(Conv2d k 2 s 2), `up_upscalers.i.1` (ConvTranspose2d k 2 s 2),
`down_repeat_mappers.i.k` / `up_repeat_mappers.i.k` (1x1 convs), `clf.1`.

  x (B, H, W, c_in) -> PixelUnshuffle(p), 1x1 conv, LN
    + effnet_mapper(bilinear(effnet))          (Stage C's latents)
    + bilinear(pixels_mapper(pixels))          (pixels: zeros (B, 8, 8, 3))
  down, level i: [LN, conv k2 s2 if i > 0] then the level's blocks, run
    block_repeat[0][i] times with a 1x1 repeat mapper between runs
  up, level i (deepest first): the level's blocks run block_repeat[1][::-1][i]
    times, a repeat mapper between runs; the first ResBlock of every run of
    levels below the deepest takes the level's down output as its skip,
    joined after its LN into fc1; then LN, transposed conv k2 s2
  -> LN -> 1x1 conv -> PixelShuffle(p) -> eps (B, H, W, c_out)

The mappers are conv 1x1, GELU, conv 1x1, LN; bilinear is align_corners=True
to the embedding's size, in float32; the conditioning tokens are
LN(clip_mapper(pooled CLIP-bigG)) as c_clip_seq tokens. Every LayerNorm has
no affine and eps 1e-6. The blocks and their kernels are Stage C's
(models/cascade.py): a repeat runs the same blocks with the same weights
and the same FiLM rows.

`gen_cond_cache` computes once per call what every step shares: the clip
tokens, each AttnBlock's conditioning keys and values, and the effnet and
pixel terms' sum at the embedding's size (neither depends on x or r).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import StageBConfig
from ..nn.blocks import AttnBlock, Downsample, ResBlock, TimestepBlock, Upsample
from ..nn.functional import depth_to_space, layer_norm, space_to_depth
from .cascade import CascadeUNet


def resize(x: torch.Tensor, hw: tuple) -> torch.Tensor:
    """NHWC bilinear resize with align_corners=True, in float32."""
    y = F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear", align_corners=True)
    return y.permute(0, 2, 3, 1)


def _mapper(c_in: int, c: int) -> nn.Sequential:
    """conv 1x1 (c_in -> 4c), GELU, conv 1x1 (4c -> c), LayerNorm2d."""
    return nn.Sequential(nn.Conv2d(c_in, c * 4, kernel_size=1), nn.GELU(), nn.Conv2d(c * 4, c, kernel_size=1),
                         nn.Identity())


class StageB(CascadeUNet):
    """forward(x, r, clip=None, effnet=None, cond_cache=None):

      x           (B, H, W, c_in) Stage A latents, H and W multiples of
                  patch_size * 2^(levels - 1)
      r           (B,) noise level in [0, 1]
      clip        (B, 1, c_clip) the pooled CLIP-bigG text feature
      effnet      (B, h, w, c_effnet) Stage C's latents
      cond_cache  gen_cond_cache's output; clip and effnet are then not read

    The condition sca is 0 and the pixels are zeros (B, 8, 8, c_pixels), as
    diffusers' decoder pipeline sends them."""

    def __init__(self, config: StageBConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.patch_size < 1:
            raise ValueError("StageB: patch_size >= 1")
        dt = cfg.compute_dtype
        n = len(cfg.c_hidden)
        c0 = cfg.c_hidden[0]
        self.effnet_mapper = _mapper(cfg.c_effnet, c0)
        self.pixels_mapper = _mapper(cfg.c_pixels, c0)
        self.clip_mapper = nn.Linear(cfg.c_clip, cfg.c_cond * cfg.c_clip_seq)
        self.embedding = nn.Sequential(
            nn.Identity(),  # PixelUnshuffle
            nn.Conv2d(cfg.c_in * cfg.patch_size**2, c0, kernel_size=1),
            nn.Identity(),  # LayerNorm2d
        )

        def level(i: int, count: int, with_skip: bool) -> nn.ModuleList:
            c = cfg.c_hidden[i]
            blocks = []
            for rep in range(count):
                for k, bt in enumerate(cfg.level_config[i]):
                    if bt == "C":
                        c_skip = c if (with_skip and rep == 0 and k == 0) else 0
                        blocks.append(ResBlock(c, c_skip, cfg.kernel_size, dtype=dt, level=i, rep=rep,
                                               skip_at="channelwise"))
                    elif bt == "T":
                        blocks.append(TimestepBlock(c, cfg.c_r, dtype=dt, conds=cfg.t_conds))
                    elif bt == "A":
                        blocks.append(AttnBlock(c, cfg.c_cond, cfg.nhead[i], cfg.self_attn, dtype=dt))
                    else:
                        raise ValueError(f"block type {bt!r}: 'C', 'T' or 'A'")
            return nn.ModuleList(blocks)

        def repeat_mappers(i: int, repeats: int) -> nn.ModuleList:
            c = cfg.c_hidden[i]
            return nn.ModuleList([nn.Conv2d(c, c, kernel_size=1) for _ in range(repeats - 1)])

        self.down_blocks = nn.ModuleList([level(i, cfg.blocks[0][i], False) for i in range(n)])
        self.down_downscalers = nn.ModuleList(
            [nn.Identity()] + [Downsample(cfg.c_hidden[i - 1], cfg.c_hidden[i], dtype=dt) for i in range(1, n)])
        self.down_repeat_mappers = nn.ModuleList([repeat_mappers(i, cfg.block_repeat[0][i]) for i in range(n)])
        self.up_blocks = nn.ModuleList(
            [level(i, cfg.blocks[1][::-1][i], i < n - 1) for i in reversed(range(n))])
        self.up_upscalers = nn.ModuleList(
            [Upsample(cfg.c_hidden[i], cfg.c_hidden[i - 1], dtype=dt) for i in reversed(range(1, n))]
            + [nn.Identity()])
        self.up_repeat_mappers = nn.ModuleList(
            [repeat_mappers(i, cfg.block_repeat[1][::-1][i]) for i in reversed(range(n))])
        self.clf = nn.Sequential(
            nn.Identity(),  # LayerNorm2d
            nn.Conv2d(c0, cfg.c_out * cfg.patch_size**2, kernel_size=1),
            nn.Identity(),  # PixelShuffle
        )
        self.number_films()

    # -- conditioning --

    def _mapped(self, key: str, mapper: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        """A conditioning mapper on NHWC x, in the compute dtype; float32 out."""
        w1, b1 = self._linear(f"{key}.0", mapper[0])
        w2, b2 = self._linear(f"{key}.2", mapper[2])
        h = F.gelu(F.linear(x.to(w1.dtype), w1, b1))
        return layer_norm(F.linear(h, w2, b2)).float()

    def gen_c_embeddings(self, clip: torch.Tensor) -> torch.Tensor:
        """clip_norm(clip_mapper(pooled)) as (B, c_clip_seq, c_cond) tokens."""
        cfg = self.config
        dt = cfg.compute_dtype
        m = self.clip_mapper
        pooled = clip if clip.dim() == 3 else clip[:, None]
        c = F.linear(pooled.to(dt), m.weight.to(dt), m.bias.to(dt))
        return layer_norm(c.reshape(pooled.shape[0], pooled.shape[1] * cfg.c_clip_seq, cfg.c_cond))

    @torch.no_grad()
    def gen_cond_cache(self, clip: torch.Tensor, effnet: torch.Tensor, hw: tuple) -> dict:
        """What every step shares at embedding size hw (the latents' size
        over patch_size): the clip tokens, each AttnBlock's conditioning keys
        and values, and `inject`, effnet_mapper(bilinear(effnet)) +
        bilinear(pixels_mapper(zeros)) in float32 (B, *hw, c_hidden[0])."""
        c = self.gen_c_embeddings(clip)
        pixels = torch.zeros(effnet.shape[0], 8, 8, self.config.c_pixels, device=effnet.device)
        inject = (self._mapped("effnet", self.effnet_mapper, resize(effnet, hw))
                  + resize(self._mapped("pixels", self.pixels_mapper, pixels), hw))
        return {"clip": c, "kv": self.cond_kv(c), "inject": inject}

    # -- forward --

    def _level(self, prefix: str, blocks, mappers, h, skip, films: list, cache: dict) -> torch.Tensor:
        """A level's blocks run once a repeat, the repeat mappers between."""
        for rep in range(len(mappers) + 1):
            h = self._run_level(prefix, blocks, h, skip, films, cache)
            if rep < len(mappers):
                w, b = self._linear(f"{prefix}.repeat{rep}", mappers[rep])
                h = F.linear(h, w, b)
        return h

    @torch.no_grad()
    def forward(
        self,
        x: torch.Tensor,
        r: torch.Tensor,
        clip: Optional[torch.Tensor] = None,
        effnet: Optional[torch.Tensor] = None,
        cond_cache: Optional[dict] = None,
    ) -> torch.Tensor:
        cfg = self.config
        dt = cfg.compute_dtype
        p = cfg.patch_size
        n = len(cfg.c_hidden)
        hw = (x.shape[1] // p, x.shape[2] // p)
        f = p * 2 ** (n - 1)
        if x.shape[1] % f or x.shape[2] % f:
            raise ValueError(f"StageB: latents {tuple(x.shape[1:3])} are not multiples of {f} (patch_size x the "
                             "levels' stride-2 convs), so the up path would not meet its skips")
        if cond_cache is None:
            cond_cache = self.gen_cond_cache(clip, effnet, hw)
        films = self.films(r)

        emb_w, emb_b = self._linear("embedding", self.embedding[1])
        h = layer_norm(F.linear(space_to_depth(x.to(dt), p), emb_w, emb_b))
        h = (h.float() + cond_cache["inject"]).to(dt)
        level_outputs = []
        for i, blocks in enumerate(self.down_blocks):
            if i > 0:
                h = self.down_downscalers[i](h)
            h = self._level(f"down_blocks.{i}", blocks, self.down_repeat_mappers[i], h, None, films, cond_cache)
            level_outputs.insert(0, h)

        h = level_outputs[0]
        for iu, blocks in enumerate(self.up_blocks):
            skip = level_outputs[iu] if iu > 0 else None
            h = self._level(f"up_blocks.{iu}", blocks, self.up_repeat_mappers[iu], h, skip, films, cond_cache)
            if iu < n - 1:
                h = self.up_upscalers[iu](h)

        clf_w, clf_b = self._linear("clf", self.clf[1])
        return depth_to_space(F.linear(layer_norm(h), clf_w, clf_b), p)
