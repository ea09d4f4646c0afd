"""Stable Cascade's Stage C, the text-conditional prior (Würstchen v3,
arXiv:2306.00637; StableCascade `modules/stage_c.py`, diffusers'
`StableCascadeUNet`), inference only, NHWC, in the config's compute dtype.

Module and parameter names are StableCascade's, so its state dict maps onto
this one by name: `clip_txt_mapper`, `clip_txt_pooled_mapper`,
`clip_img_mapper`, `embedding.1`, `down_blocks[i]` / `up_blocks[i]`
(ModuleLists of ResBlock, TimestepBlock, AttnBlock), the level switches
`down_downscalers.1.1.blocks.0` and `up_upscalers.0.1.blocks.1` (1x1
convs: switch_level False), `clf.1`.

  x (B, H, W, c_in) -> 1x1 conv -> LN
  -> level 0: [CTA] x 8 -> LN, 1x1 conv -> level 1: [CTA] x 24       (down)
  -> level 1: [CTA] x 24 -> LN, 1x1 conv -> level 0: [CTA] x 8       (up; the
     first ResBlock takes level 0's down output as its skip, joined into fc1)
  -> LN -> 1x1 conv -> eps (B, H, W, c_out)

Every ResBlock and the TimestepBlock after it run as one K1 call
(kernels/resblock.py::fused_resblock) with the FiLM a = sum a_i, b = sum b_i
over t, sca and crp; the up path's first ResBlock takes K1's channelwise-skip
mode. The FiLM vectors of all TimestepBlocks come from one product a call
(their mappers stacked as a derived weight). Each AttnBlock attends its pixel
queries over [LN(x) tokens | kv_mapper(clip)] with K5
(kernels/attention.py::fused_attention, its wgmma variant at the published
shape), which reads the pixel keys and values out of the q|k|v product and
the conditioning's out of the cond cache; on the CPU its plain version.

`gen_cond_cache` computes once per call what every step shares: the CLIP
conditioning (the three mappers and `clip_norm`) and, per AttnBlock, its
kv_mapper output projected to the conditioning tokens' keys and values.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import StageCConfig
from ..nn.blocks import AttnBlock, ResBlock, TimestepBlock
from ..nn.functional import depth_to_space, layer_norm, space_to_depth
from .cascade import CascadeUNet


class _Switch(nn.Module):
    """UpDownBlock2d at switch_level False: its 1x1 `mapping` conv, in
    `blocks` at StableCascade's index (0 down, 1 up); the other slot is the
    interpolation it leaves out."""

    def __init__(self, c_in: int, c_out: int, up: bool):
        super().__init__()
        conv = nn.Conv2d(c_in, c_out, kernel_size=1)
        self.blocks = nn.ModuleList([nn.Identity(), conv] if up else [conv, nn.Identity()])
        self.up = up

    @property
    def conv(self) -> nn.Conv2d:
        return self.blocks[1 if self.up else 0]


class StageC(CascadeUNet):
    """forward(x, r, clip_text, clip_text_pooled, clip_img, cond_cache=None):

      x                 (B, H, W, c_in) latents
      r                 (B,) noise level in [0, 1]
      clip_text         (B, S, c_clip_text) the text tower's last hidden states
      clip_text_pooled  (B, 1, c_clip_text_pooled) its projected EOT feature
      clip_img          (B, 1, c_clip_img) image embeddings (zeros for text only)
      cond_cache        gen_cond_cache's output; the CLIP inputs are then not read

    The conditions sca and crp are 0, as the text-to-image prior runs them."""

    def __init__(self, config: StageCConfig):
        super().__init__()
        cfg = self.config = config
        if cfg.patch_size < 1 or any(cfg.switch_level) or any(r != 1 for rr in cfg.block_repeat for r in rr):
            raise ValueError("StageC runs block_repeat 1 and switch_level False, as the published prior")
        if len(set(cfg.c_hidden)) != 1:
            raise ValueError("StageC: levels of one width (switch_level False keeps the resolution)")
        dt = cfg.compute_dtype
        n = len(cfg.c_hidden)
        self.clip_txt_mapper = nn.Linear(cfg.c_clip_text, cfg.c_cond)
        self.clip_txt_pooled_mapper = nn.Linear(cfg.c_clip_text_pooled, cfg.c_cond * cfg.c_clip_seq)
        self.clip_img_mapper = nn.Linear(cfg.c_clip_img, cfg.c_cond * cfg.c_clip_seq)
        self.embedding = nn.Sequential(
            nn.Identity(),  # PixelUnshuffle
            nn.Conv2d(cfg.c_in * cfg.patch_size**2, cfg.c_hidden[0], kernel_size=1),
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

        self.down_blocks = nn.ModuleList([level(i, cfg.blocks[0][i], False) for i in range(n)])
        self.down_downscalers = nn.ModuleList(
            [nn.Identity()] + [nn.Sequential(nn.Identity(), _Switch(cfg.c_hidden[i - 1], cfg.c_hidden[i], False))
                               for i in range(1, n)])
        self.up_blocks = nn.ModuleList(
            [level(i, cfg.blocks[1][::-1][i], i < n - 1) for i in reversed(range(n))])
        self.up_upscalers = nn.ModuleList(
            [nn.Sequential(nn.Identity(), _Switch(cfg.c_hidden[i], cfg.c_hidden[i - 1], True))
             for i in reversed(range(1, n))] + [nn.Identity()])
        self.clf = nn.Sequential(
            nn.Identity(),  # LayerNorm2d
            nn.Conv2d(cfg.c_hidden[0], cfg.c_out * cfg.patch_size**2, kernel_size=1),
        )
        self.number_films()

    # -- conditioning --

    def gen_c_embeddings(self, clip_text, clip_text_pooled, clip_img) -> torch.Tensor:
        """clip_norm([txt_mapper(text) | pooled_mapper(pooled) | img_mapper(img)])
        (B, S + 2 c_clip_seq, c_cond)."""
        cfg = self.config
        dt = cfg.compute_dtype
        b = clip_text.shape[0]

        def lin(m: nn.Linear, v):
            return F.linear(v.to(dt), m.weight.to(dt), m.bias.to(dt))

        txt = lin(self.clip_txt_mapper, clip_text)
        pooled = lin(self.clip_txt_pooled_mapper, clip_text_pooled).reshape(b, -1, cfg.c_cond)
        img = lin(self.clip_img_mapper, clip_img).reshape(b, -1, cfg.c_cond)
        return layer_norm(torch.cat([txt, pooled, img], dim=1))

    @torch.no_grad()
    def gen_cond_cache(self, clip_text, clip_text_pooled, clip_img) -> dict:
        """The conditioning every step shares: the CLIP sequence and each
        AttnBlock's conditioning keys and values (B, S_cond, C), keyed by the
        block's module name."""
        clip = self.gen_c_embeddings(clip_text, clip_text_pooled, clip_img)
        return {"clip": clip, "kv": self.cond_kv(clip)}

    @torch.no_grad()
    def forward(
        self,
        x: torch.Tensor,
        r: torch.Tensor,
        clip_text: Optional[torch.Tensor] = None,
        clip_text_pooled: Optional[torch.Tensor] = None,
        clip_img: Optional[torch.Tensor] = None,
        cond_cache: Optional[dict] = None,
    ) -> torch.Tensor:
        cfg = self.config
        dt = cfg.compute_dtype
        p = cfg.patch_size
        if cond_cache is None:
            cond_cache = self.gen_cond_cache(clip_text, clip_text_pooled, clip_img)
        films = self.films(r)

        emb_w, emb_b = self._linear("embedding", self.embedding[1])
        h = layer_norm(F.linear(space_to_depth(x.to(dt), p), emb_w, emb_b))
        level_outputs = []
        for i, blocks in enumerate(self.down_blocks):
            if i > 0:
                w, bias = self._linear(f"down{i}", self.down_downscalers[i][1].conv)
                h = F.linear(layer_norm(h), w, bias)
            h = self._run_level(f"down_blocks.{i}", blocks, h, None, films, cond_cache)
            level_outputs.insert(0, h)

        h = level_outputs[0]
        for iu, blocks in enumerate(self.up_blocks):
            skip = level_outputs[iu] if iu > 0 else None
            h = self._run_level(f"up_blocks.{iu}", blocks, h, skip, films, cond_cache)
            if iu < len(self.up_blocks) - 1:
                w, bias = self._linear(f"up{iu}", self.up_upscalers[iu][1].conv)
                h = F.linear(layer_norm(h), w, bias)

        clf_w, clf_b = self._linear("clf", self.clf[1])
        return depth_to_space(F.linear(layer_norm(h), clf_w, clf_b), p)
