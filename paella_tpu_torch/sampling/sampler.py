"""Iterative renoising sampler with classifier-free guidance, the counterpart
of `paella_tpu/sampling/sampler.py::sample` in its per-image mode.

Every random draw comes from the per-image counter hash
(kernels/sampling.py), keyed by each image's (2,) uint32 seed pair — the
key data of the JAX package's batched key — and a per-(step, draw) salt, so
an image's tokens depend on its own seeds only, and the port's tokens can be
held token for token against the JAX package given the same seed pairs.

Per step: one batch-2B forward (cond and uncond merged by masks) returning
the pre-head features; the fused head kernel mixes CFG, projects, applies the
temperature and draws a Gumbel argmax; then the tokens are renoised toward the
fixed init noise. The schedules are plain values, so changing a cfg weight or
a temperature changes no compiled or captured state.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SampleConfig
from ..kernels.sampling import fused_head_categorical
from ..kernels.sampling import hash_bits as _hash_bits
from ..kernels.sampling import hash_uniform as _hash_uniform
from ..kernels.sampling import mix32 as _mix32

_M32 = 0xFFFFFFFF


@dataclasses.dataclass
class Conditioning:
    """Conditioning inputs for one forward. `clip`/`clip_image` may be None
    (absent) or masked per example via the *_mask fields (None = all present)."""

    byt5: torch.Tensor
    clip: Optional[torch.Tensor] = None
    clip_image: Optional[torch.Tensor] = None
    byt5_mask: Optional[torch.Tensor] = None
    clip_mask: Optional[torch.Tensor] = None
    clip_image_mask: Optional[torch.Tensor] = None

    @property
    def batch(self) -> int:
        return self.byt5.shape[0]

    def to(self, device) -> "Conditioning":
        return Conditioning(
            *(None if v is None else v.to(device) for v in dataclasses.astuple(self))
        )


def derive_seeds(seeds: torch.Tensor, tag: int, idx: torch.Tensor) -> torch.Tensor:
    """(len(idx), B, 2) seed pairs for draw `tag` at steps `idx`, from the
    images' (B, 2) seed pairs (JAX: sampler.py:309-319)."""
    s = seeds.to(torch.int64) & _M32
    idx = idx.to(torch.int64)
    # idx * 0x9E3779B9 + tag * 0x85EBCA6B + 1 (mod 2^32); idx < 2^16 keeps
    # the int64 product exact
    salts = _mix32((idx * 0x9E3779B9 + ((tag * 0x85EBCA6B) & _M32) + 1) & _M32)
    return torch.stack(
        [_mix32(s[None, :, 0] ^ salts[:, None]), _mix32((s[None, :, 1] + salts[:, None]) & _M32)],
        dim=-1,
    )


def _pad_seq(v: torch.Tensor, s: int) -> torch.Tensor:
    pad = [0, 0] * (v.dim() - 2) + [0, s - v.shape[1]]
    return F.pad(v, pad)


def merge_cfg_pair(cond: Conditioning, uncond: Conditioning) -> Conditioning:
    """Stack cond and uncond into one batch-2B Conditioning. A modality
    present on one side only is zero-filled and masked off on the other, and
    the shorter byt5 sequence is padded and masked, so one forward serves
    both branches."""
    b = cond.batch
    dev = cond.byt5.device

    def ones(n):
        return torch.ones((n,), dtype=torch.bool, device=dev)

    def pair_field(c, u, c_mask, u_mask):
        if c is None and u is None:
            return None, None
        if c is None:
            c, c_mask = torch.zeros_like(u), torch.zeros((b,), dtype=torch.bool, device=dev)
        if u is None:
            u, u_mask = torch.zeros_like(c), torch.zeros((b,), dtype=torch.bool, device=dev)
        merged = torch.cat([c, u], dim=0)
        if c_mask is None and u_mask is None:
            return merged, None
        c_mask = c_mask if c_mask is not None else ones(b)
        u_mask = u_mask if u_mask is not None else ones(b)
        return merged, torch.cat([c_mask, u_mask], dim=0)

    cb, ub = cond.byt5, uncond.byt5
    cm = cond.byt5_mask if cond.byt5_mask is not None else torch.ones(cb.shape[:2], dtype=torch.bool, device=dev)
    um = uncond.byt5_mask if uncond.byt5_mask is not None else torch.ones(ub.shape[:2], dtype=torch.bool, device=dev)
    s = max(cb.shape[1], ub.shape[1])
    byt5 = torch.cat([_pad_seq(cb, s), _pad_seq(ub.to(cb.dtype), s)], dim=0)
    byt5_mask = torch.cat([_pad_seq(cm, s), _pad_seq(um, s)], dim=0)
    clip, clip_mask = pair_field(cond.clip, uncond.clip, cond.clip_mask, uncond.clip_mask)
    clip_image, clip_image_mask = pair_field(
        cond.clip_image, uncond.clip_image, cond.clip_image_mask, uncond.clip_image_mask
    )
    return Conditioning(byt5, clip, clip_image, byt5_mask, clip_mask, clip_image_mask)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """The schedule jnp.linspace gives, correctly rounded to float32 (XLA's
    own f32 evaluation may differ from it by a few ulp)."""
    return np.linspace(np.float32(start), np.float32(stop), num, dtype=np.float64).astype(np.float32)


def sample(
    model: Any,
    seeds: torch.Tensor,
    conditioning: Conditioning,
    latent_shape: tuple[int, int, int],
    unconditional: Optional[Conditioning] = None,
    config: SampleConfig = SampleConfig(),
    init_x: Optional[torch.Tensor] = None,
    fixed_mask: Optional[torch.Tensor] = None,
    fixed_tokens: Optional[torch.Tensor] = None,
    cond_reweight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Generate a (B, h, w) int32 token grid on the model's device.

    seeds: (B, 2) uint32 values (any integer dtype), one seed pair per image.
    CFG runs when both `unconditional` and config.cfg are given.
    """
    if init_x is not None:
        raise NotImplementedError("init_x (img2img) is not ported yet (ROADMAP A5)")
    if fixed_mask is not None or fixed_tokens is not None:
        raise NotImplementedError("fixed_mask / fixed_tokens (inpainting) are not ported yet (ROADMAP A5)")
    if cond_reweight is not None:
        raise NotImplementedError("cond_reweight through the sampler is not ported yet (ROADMAP A7)")
    cfg = config.resolved()
    b, h, w = latent_shape
    mcfg = model.config
    down = mcfg.patch_size * 2 ** (len(mcfg.c_hidden) - 1)
    if h % down or w % down:
        raise ValueError(
            f"latent_shape {latent_shape}: H and W must be divisible by the UNet's "
            f"total downsample factor {down} (patch_size * 2^(levels-1))"
        )
    if tuple(seeds.shape) != (b, 2):
        raise ValueError(f"seeds must be ({b}, 2), got {tuple(seeds.shape)}")
    do_cfg = cfg.cfg is not None and unconditional is not None
    if do_cfg and cfg.sampling_conditional_steps < cfg.steps:
        raise NotImplementedError(
            "a sampling_conditional_steps cutoff below steps is not ported yet (ROADMAP A5)"
        )
    device = model.head_weight().device
    seeds = seeds.to(device=device, dtype=torch.int64) & _M32

    init_seeds = derive_seeds(seeds, 0, torch.zeros(1, dtype=torch.int64, device=device))[0]
    init_noise = (_hash_bits(init_seeds, (h, w)) % mcfg.num_labels).to(torch.int32)
    step_idx = torch.arange(cfg.steps, dtype=torch.int64, device=device)
    cat_seeds = derive_seeds(seeds, 1, step_idx)
    noise_seeds = derive_seeds(seeds, 2, step_idx)

    t_list = linspace_f32(cfg.t_start, cfg.t_end, cfg.steps + 1)
    temperatures = linspace_f32(*cfg.temperature, cfg.steps)
    cfgs = linspace_f32(*(cfg.cfg if do_cfg else (0.0, 0.0)), cfg.steps)

    merged = merge_cfg_pair(conditioning, unconditional) if do_cfg else conditioning
    merged = merged.to(device)
    cache = model.gen_cond_cache(
        merged.byt5, merged.clip, merged.clip_image,
        byt5_mask=merged.byt5_mask, clip_mask=merged.clip_mask,
        clip_image_mask=merged.clip_image_mask,
    )
    w_out = model.head_weight()

    sampled = init_noise
    for i in range(cfg.steps):
        t = torch.full((b,), float(t_list[i]), dtype=torch.float32, device=device)
        if do_cfg:
            feats = model(
                torch.cat([sampled, sampled]), torch.cat([t, t]),
                return_features=True, cond_cache=cache,
            )
            feat_c, feat_u = feats[:b].contiguous(), feats[b:].contiguous()
        else:
            feat_c = model(sampled, t, return_features=True, cond_cache=cache).contiguous()
            feat_u = None
        tokens = fused_head_categorical(
            cat_seeds[i], feat_c, feat_u, float(cfgs[i]), w_out, float(temperatures[i])
        )
        if i < cfg.renoise_steps:
            # renoise toward the SAME init noise (src_distributed/utils.py:123-125)
            u = _hash_uniform(noise_seeds[i], (h, w))
            tokens = torch.where(u <= float(t_list[i + 1]), init_noise, tokens)
        sampled = tokens
    return sampled
