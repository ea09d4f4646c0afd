"""Stable Cascade's Stage B decoder, its sampler and Stage A's decode, in
plain float32 torch over state dicts: the reference the port
(`paella_tpu_torch`) is held to. It imports torch and the Stage C reference
beside it (its blocks, the text tower, the scheduler and the noise), no
more.

It follows the published description:
- Stage B: Würstchen v3 (arXiv:2306.00637), StableCascade
  `modules/stage_b.py::StageB` on `modules/common.py`'s blocks (as
  `stage_c_reference.py` holds them), diffusers' `StableCascadeUNet`: the
  embedding (PixelUnshuffle, 1x1 conv, LayerNorm2d), the effnet mapper over
  `F.interpolate(effnet, bilinear, align_corners=True)` and the pixel
  mapper's output interpolated the same way, levels entered by LayerNorm2d
  and `F.conv2d` (k 2, s 2) and left by LayerNorm2d and
  `F.conv_transpose2d` (k 2, s 2), each level's blocks run block_repeat
  times with a 1x1 repeat mapper between runs, the skip given to the first
  ResBlock of every run of the up path (diffusers' `_up_decode` passes it
  whenever k == 0), and clf (LayerNorm2d, 1x1 conv, PixelShuffle). NCHW
  inside.
- The conditioning tokens: LayerNorm(clip_mapper(pooled CLIP-bigG feature))
  as c_clip_seq tokens.
- The sampler: diffusers' `DDPMWuerstchenScheduler.step` (s 0.008, scaler
  1) over t = linspace(1, 0, steps + 1) at guidance 0, as
  `StableCascadeDecoderPipeline` runs it by default.
- Stage A: StableCascade `modules/stage_a.py::StageA.decode` (diffusers'
  `PaellaVQModel.decode` of latents already scaled): the latents times
  scale_factor, a 1x1 conv, the ResBlocks (LayerNorm scaled and shifted by
  learned gammas, replication-padded depthwise 3x3 conv, the channelwise
  MLP), the k4 s2 transposed conv, a 1x1 conv and PixelShuffle(2).

Departures, each on purpose:
- Latents cross the interface channels-last, (B, H, W, C), as the port keeps
  them; the models run NCHW inside.
- Noise: x_init and each step's z are drawn from the image's (2,) seed pair by
  the counter hash of `stage_c_reference.py` (a frozen copy of the port's
  draw), under the decoder's tags 5 and 6; diffusers draws torch's Philox
  stream.
- Everything is float32 (set TF32 off on a card); diffusers runs Stage B and
  its scheduler step in the model's dtype.
- Inference only: no dropout; sca is 0; the pixels are zeros (B, 3, 8, 8),
  as diffusers sends them; latents whose sides halve evenly at every level,
  so the up path's interpolation to the skip's size is never taken.

`cfg` is a dict of StageBConfig's fields (c_in, c_r, c_cond, c_hidden,
nhead, blocks, block_repeat, level_config, c_clip_seq, t_conds, c_pixels,
...); `acfg` of VQConfig's (levels, bottleneck_blocks, scale_factor).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

try:  # the benchmark's copy, beside reference/stage_c.py
    from . import stage_c as _c
except ImportError:  # the tests' copy, beside tests/stage_c_reference.py
    import stage_c_reference as _c

INIT_TAG, STEP_TAG = 5, 6

clip_text, pad_with_eot, schedule, ddpm_step, noise = _c.clip_text, _c.pad_with_eot, _c.schedule, _c.ddpm_step, _c.noise


# -- Stage B --------------------------------------------------------------


def _mapper(sd: dict, name: str, x: torch.Tensor) -> torch.Tensor:
    """conv 1x1, GELU, conv 1x1, LayerNorm2d (no affine, eps 1e-6)."""
    return _c._ln2d(_c._conv1x1(F.gelu(_c._conv1x1(x, sd, f"{name}.0")), sd, f"{name}.2"))


def _interp(x: torch.Tensor, size) -> torch.Tensor:
    return F.interpolate(x.float(), size=size, mode="bilinear", align_corners=True)


def c_embeddings(sd: dict, cfg: dict, clip: torch.Tensor) -> torch.Tensor:
    """StageB.gen_c_embeddings: pooled (B, 1, c_clip) -> (B, c_clip_seq, c_cond)."""
    b, s = clip.shape[:2]
    c = _c._lin(clip, sd, "clip_mapper").view(b, s * cfg["c_clip_seq"], -1)
    return F.layer_norm(c, c.shape[-1:], eps=1e-6)


def stage_b(sd: dict, cfg: dict, x: torch.Tensor, r: torch.Tensor, clip: torch.Tensor,
            effnet: torch.Tensor) -> torch.Tensor:
    """StageB.forward: latents (B, H, W, c_in), r (B,), the pooled text
    feature (B, 1, c_clip), Stage C's latents (B, h, w, c_effnet) -> eps
    (B, H, W, c_out)."""
    n = len(cfg["c_hidden"])
    conds = list(cfg["t_conds"])
    r_embed = torch.cat([_c.r_embedding(r, cfg["c_r"])]
                        + [_c.r_embedding(torch.zeros_like(r), cfg["c_r"]) for _ in conds], dim=1)
    clip = c_embeddings(sd, cfg, clip)
    p = cfg["patch_size"]
    h = _c._ln2d(_c._conv1x1(F.pixel_unshuffle(x.permute(0, 3, 1, 2), p), sd, "embedding.1"))
    size = h.shape[-2:]
    pixels = torch.zeros(x.shape[0], cfg["c_pixels"], 8, 8, device=x.device)
    h = h + _mapper(sd, "effnet_mapper", _interp(effnet.permute(0, 3, 1, 2), size))
    h = h + _interp(_mapper(sd, "pixels_mapper", pixels), size)

    def run(prefix, kinds, i, h, skip):
        for j, bt in enumerate(kinds):
            name = f"{prefix}.{j}"
            if bt == "C":
                h = _c.res_block(sd, name, h, skip if j == 0 else None)
            elif bt == "T":
                h = _c.timestep_block(sd, name, h, r_embed, conds)
            else:
                h = _c.attn_block(sd, name, h, clip, cfg["nhead"][i], cfg.get("self_attn", True))
        return h

    def level(prefix, mappers, i, count, repeats, h, skip):
        kinds = _c._level_blocks(cfg, i, count)
        for rep in range(repeats):
            h = run(prefix, kinds, i, h, skip)
            if rep < repeats - 1:
                h = _c._conv1x1(h, sd, f"{mappers}.{rep}")
        return h

    levels = []
    for i in range(n):
        if i > 0:
            name = f"down_downscalers.{i}.1"
            h = F.conv2d(_c._ln2d(h), sd[f"{name}.weight"], sd[f"{name}.bias"], stride=2)
        h = level(f"down_blocks.{i}", f"down_repeat_mappers.{i}", i, cfg["blocks"][0][i], cfg["block_repeat"][0][i],
                  h, None)
        levels.insert(0, h)
    h = levels[0]
    for iu, i in enumerate(reversed(range(n))):
        skip = levels[iu] if iu > 0 else None
        h = level(f"up_blocks.{iu}", f"up_repeat_mappers.{iu}", i, cfg["blocks"][1][::-1][i],
                  cfg["block_repeat"][1][::-1][i], h, skip)
        if i > 0:
            name = f"up_upscalers.{iu}.1"
            h = F.conv_transpose2d(_c._ln2d(h), sd[f"{name}.weight"], sd[f"{name}.bias"], stride=2)
    h = F.pixel_shuffle(_c._conv1x1(_c._ln2d(h), sd, "clf.1"), p)
    return h.permute(0, 2, 3, 1)


# -- Stage A ----------------------------------------------------------------


def _stage_a_block(sd: dict, p: str, x: torch.Tensor) -> torch.Tensor:
    """modules/stage_a.py::ResBlock."""
    g = sd[f"{p}.gammas"]
    h = _c._ln2d(x) * (1 + g[0]) + g[1]
    w = sd[f"{p}.depthwise.1.weight"]
    h = F.conv2d(F.pad(h, (1, 1, 1, 1), mode="replicate"), w, sd[f"{p}.depthwise.1.bias"], groups=w.shape[0])
    x = x + h * g[2]
    h = _c._ln2d(x) * (1 + g[3]) + g[4]
    h = _c._lin(F.gelu(_c._lin(h.permute(0, 2, 3, 1), sd, f"{p}.channelwise.0")), sd, f"{p}.channelwise.2")
    return x + h.permute(0, 3, 1, 2) * g[5]


def stage_a_decode(sd: dict, acfg: dict, x: torch.Tensor) -> torch.Tensor:
    """StageA.decode: latents (B, h, w, c_latent) -> images (B, 4h, 4w, 3),
    unclipped."""
    h = _c._conv1x1(x.permute(0, 3, 1, 2).float() * acfg["scale_factor"], sd, "up_blocks.0.0")
    j = 1
    for i in range(acfg["levels"]):
        for _ in range(acfg["bottleneck_blocks"] if i == 0 else 1):
            h = _stage_a_block(sd, f"up_blocks.{j}", h)
            j += 1
        if i < acfg["levels"] - 1:
            h = F.conv_transpose2d(h, sd[f"up_blocks.{j}.weight"], sd[f"up_blocks.{j}.bias"], stride=2, padding=1)
            j += 1
    return F.pixel_shuffle(_c._conv1x1(h, sd, "out_block.0"), 2).permute(0, 2, 3, 1)


def images(sd: dict, acfg: dict, x: torch.Tensor) -> torch.Tensor:
    """The decoder pipeline's images: clamp(Stage A's decode, 0, 1)."""
    return stage_a_decode(sd, acfg, x).clamp(0.0, 1.0)


# -- the sampler ------------------------------------------------------------


def sample(sd: dict, cfg: dict, seeds: torch.Tensor, clip: torch.Tensor, effnet: torch.Tensor, latent_hw: tuple,
           steps: int, round_to=None) -> torch.Tensor:
    """The latents-to-latents loop at guidance 0: clip (B, 1, c_clip),
    effnet (B, h, w, c_effnet); `round_to` a dtype x is rounded to after
    each step (the port's model dtype), or None."""
    b = seeds.shape[0]
    shape = (*latent_hw, cfg["c_in"])
    t = schedule(steps).to(seeds.device)
    x = noise(seeds, shape, INIT_TAG, 0)
    if round_to is not None:
        x = x.to(round_to).float()
    for i in range(steps):
        e = stage_b(sd, cfg, x, t[i].expand(b), clip, effnet)
        x = ddpm_step(x, e, t[i], t[i + 1], noise(seeds, shape, STEP_TAG, i))
        if round_to is not None:
            x = x.to(round_to).float()
    return x
