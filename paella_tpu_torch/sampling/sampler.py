"""Iterative renoising sampler with classifier-free guidance, the counterpart
of `paella_tpu/sampling/sampler.py::sample` in its per-image mode, with the
editing inputs (`init_x`, `fixed_mask`/`fixed_tokens`, `cond_reweight`) and
the latent helpers `interpolate_latents` and `outpaint_canvas`.

Every random draw comes from the per-image counter hash
(kernels/sampling.py), keyed by each image's (2,) uint32 seed pair — the
key data of the JAX package's batched key — and a per-(step, draw) salt, so
an image's tokens depend on its own seeds only, and the port's tokens can be
held token for token against the JAX package given the same seed pairs.

Per step: one batch-2B forward (cond and uncond merged by masks) returning
the pre-head features (batch B, conditional inputs only, past
`sampling_conditional_steps`); then the head and draw by
`SampleConfig.categorical_impl`, as in the JAX package:
  "pallas"  the fused head kernel mixes CFG, projects, applies the
            temperature and draws a Gumbel argmax, with f32 logits;
  "xla"     (the default) the CFG mix in f32, the head as a product in the
            compute dtype (its logits rounded to it, as the JAX XLA head's
            are), then the Gumbel kernel over those logits;
then the tokens are renoised toward the fixed init noise, and pinned positions
are reset.

`sample` runs in two halves, as the JAX package runs its single jit
`_sample_jit`: `prepare_sample` on the host checks the arguments and puts
every input on the model's device, the schedules included (t, temperature,
CFG weight and a renoise flag per step, f32 device tensors, as the JAX
sampler's scan indexes them); `sample_body` is the device work on tensors
alone, with no host value and no host sync. On a CUDA device `sample` runs
the body as one captured CUDA graph per structure (sampling/graph.py), so a
new cfg weight, temperature, t span or renoise count captures nothing new;
on the CPU, and through `sample_eager` on a card, the body runs op by op.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..config import SampleConfig
from ..kernels.quantize import fused_codebook_lookup
from ..kernels.sampling import Scalar, fused_head_categorical, gumbel_categorical, step_scalar
from ..kernels.sampling import hash_bits as _hash_bits
from ..kernels.sampling import hash_uniform as _hash_uniform
from ..kernels.sampling import mix32 as _mix32
from ..utils import tracing
from . import graph

_M32 = 0xFFFFFFFF
# draw tags of derive_seeds: 0 init noise, 1 categorical, 2 renoise (the JAX
# sampler's); 3 the outpainting canvas, which the JAX package draws from
# jax.random instead
_CANVAS_TAG = 3
_COND_FIELDS = ("byt5", "clip", "clip_image", "byt5_mask", "clip_mask", "clip_image_mask")


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


def draw_tokens(
    categorical_impl: str,
    seeds: torch.Tensor,
    feat_c: torch.Tensor,
    feat_u: Optional[torch.Tensor],
    cfg_weight: Scalar,
    w_out: torch.Tensor,
    temperature: Scalar,
) -> torch.Tensor:
    """One step's head and categorical draw from the pre-head features
    (B, h, w, C) (feat_u None: no CFG mix), w_out (K, C) in the compute
    dtype; (B, h, w) int32 tokens, by the JAX sampler's two routes
    (paella_tpu/sampling/sampler.py:401-426):
      "pallas"  the fused head kernel, f32 logits;
      "xla"     the CFG mix in f32, the head product in the compute dtype (the
                JAX XLA head's rounding point, sampler.py:361-362), then the
                Gumbel kernel over those logits.
    cfg_weight and temperature are step scalars (kernels/sampling.py): Python
    floats or one-element f32 tensors on the features' device.
    """
    if categorical_impl == "pallas":
        return fused_head_categorical(seeds, feat_c, feat_u, cfg_weight, w_out, temperature)
    feat = feat_c
    if feat_u is not None:
        w = step_scalar(cfg_weight, feat_c.device)  # f32, as the JAX sampler's traced weight and 1 - w
        feat = feat_c.float() * w + feat_u.float() * (1.0 - w)
    logits = torch.matmul(feat.to(w_out.dtype), w_out.t())
    return gumbel_categorical(seeds, logits, temperature)


@dataclasses.dataclass(frozen=True)
class SampleStructure:
    """What a generation's device work is built from besides tensor values:
    the latent shape (B, h, w), the step count, the CFG steps (0 without
    CFG) and the categorical route. With the shapes and dtypes of the inputs
    it keys the captured graphs; schedule values never enter it."""

    latent_shape: tuple
    steps: int
    n_cfg: int
    categorical_impl: str


def prepare_sample(
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
) -> tuple[SampleStructure, dict]:
    """The host half of :func:`sample` (arguments as there): check the
    arguments, then put every input of the device body on the model's
    device. Returns the structure and the inputs, a dict of tensors (None
    where absent): "seeds" (B, 2) int64; "schedule" (4, steps + 1) f32, rows
    t (steps + 1 values), temperature, CFG weight and a renoise flag (1.0
    where step i < renoise_steps), each computed on the host in f32 as the
    JAX sampler's schedules are; the conditioning fields as "cond.<field>"
    and "uncond.<field>" (the unconditional ones None without CFG); and
    "init_x", "fixed_mask", "fixed_tokens", "cond_reweight"."""
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
    if (fixed_mask is None) != (fixed_tokens is None):
        raise ValueError("fixed_mask and fixed_tokens must be passed together")
    if cfg.categorical_impl not in ("xla", "pallas"):
        raise ValueError(f"categorical_impl {cfg.categorical_impl!r}: 'xla' or 'pallas'")
    do_cfg = cfg.cfg is not None and unconditional is not None
    n_cfg = min(cfg.sampling_conditional_steps, cfg.steps) if do_cfg else 0
    device = model.head_weight().device

    schedule = np.zeros((4, cfg.steps + 1), np.float32)
    schedule[0] = linspace_f32(cfg.t_start, cfg.t_end, cfg.steps + 1)
    schedule[1, : cfg.steps] = linspace_f32(*cfg.temperature, cfg.steps)
    schedule[2, : cfg.steps] = linspace_f32(*(cfg.cfg if do_cfg else (0.0, 0.0)), cfg.steps)
    schedule[3, : cfg.steps] = np.arange(cfg.steps) < cfg.renoise_steps
    inputs = {
        "seeds": seeds.to(dtype=torch.int64).to(device) & _M32,
        "schedule": torch.from_numpy(schedule).to(device),
    }
    for side, c in (("cond", conditioning), ("uncond", unconditional if n_cfg > 0 else None)):
        for f in _COND_FIELDS:
            v = None if c is None else getattr(c, f)
            inputs[f"{side}.{f}"] = None if v is None else v.to(device)
    as_dev = lambda v, dt: None if v is None else v.to(device=device, dtype=dt)  # noqa: E731
    inputs.update(
        init_x=as_dev(init_x, torch.int32), fixed_mask=as_dev(fixed_mask, torch.bool),
        fixed_tokens=as_dev(fixed_tokens, torch.int32), cond_reweight=as_dev(cond_reweight, torch.float32),
    )
    return SampleStructure(tuple(latent_shape), cfg.steps, n_cfg, cfg.categorical_impl), inputs


def sample_body(model: Any, structure: SampleStructure, inputs: dict) -> torch.Tensor:
    """The device half of :func:`sample`: the cond caches, the init noise,
    the derived seeds and the step loop, from the tensors of
    :func:`prepare_sample` and the structure alone. It reads no schedule
    value on the host and never waits for the device, so one CUDA graph
    capture of it replays any values of the same structure."""
    b, h, w = structure.latent_shape
    steps, n_cfg = structure.steps, structure.n_cfg
    seeds = inputs["seeds"]
    device = seeds.device
    t_sched, temperatures, cfgs, renoise = inputs["schedule"]

    init_seeds = derive_seeds(seeds, 0, torch.zeros(1, dtype=torch.int64, device=device))[0]
    init_noise = (_hash_bits(init_seeds, (h, w)) % model.config.num_labels).to(torch.int32)
    step_idx = torch.arange(steps, dtype=torch.int64, device=device)
    cat_seeds = derive_seeds(seeds, 1, step_idx)
    noise_seeds = derive_seeds(seeds, 2, step_idx)

    def conditioning(side: str) -> Conditioning:
        return Conditioning(*(inputs[f"{side}.{f}"] for f in _COND_FIELDS))

    def cond_cache(c: Conditioning) -> dict:
        return model.gen_cond_cache(
            c.byt5, c.clip, c.clip_image,
            byt5_mask=c.byt5_mask, clip_mask=c.clip_mask, clip_image_mask=c.clip_image_mask,
        )

    # the cond-only phase past the cutoff runs batch B on the conditional
    # inputs alone, with its own cache (built only when that phase has steps)
    cache_cfg = cond_cache(merge_cfg_pair(conditioning("cond"), conditioning("uncond"))) if n_cfg > 0 else None
    cache_cond = cond_cache(conditioning("cond")) if n_cfg < steps else None
    cond_reweight, fixed_mask, fixed_tokens = inputs["cond_reweight"], inputs["fixed_mask"], inputs["fixed_tokens"]
    w_out = model.head_weight()

    sampled = init_noise if inputs["init_x"] is None else inputs["init_x"]
    if fixed_mask is not None:
        sampled = torch.where(fixed_mask, fixed_tokens, sampled)
    for i in range(steps):
        t = t_sched[i].expand(b)
        if i < n_cfg:
            feats = model(
                torch.cat([sampled, sampled]), torch.cat([t, t]),
                cond_reweight=cond_reweight, return_features=True, cond_cache=cache_cfg,
            )
            feat_c, feat_u = feats[:b].contiguous(), feats[b:].contiguous()
        else:
            feat_c = model(
                sampled, t, cond_reweight=cond_reweight, return_features=True, cond_cache=cache_cond,
            ).contiguous()
            feat_u = None
        tokens = draw_tokens(structure.categorical_impl, cat_seeds[i], feat_c, feat_u, cfgs[i], w_out, temperatures[i])
        # renoise toward the SAME init noise (src_distributed/utils.py:123-125)
        # at the steps the flag marks, a device value as in the JAX scan
        u = _hash_uniform(noise_seeds[i], (h, w))
        tokens = torch.where((renoise[i] > 0) & (u <= t_sched[i + 1]), init_noise, tokens)
        if fixed_mask is not None:
            tokens = torch.where(fixed_mask, fixed_tokens, tokens)
        sampled = tokens
    return sampled


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
    CFG runs when both `unconditional` and config.cfg are given, for the first
    config.sampling_conditional_steps steps. init_x (B, h, w) is the img2img
    start (with config.t_start the strength); fixed_mask (B, h, w) bool pins
    fixed_tokens where True, at the start and after every step; cond_reweight
    (B or 1, S_cond) multiplies the attention paid to each conditioning token.

    On a CUDA device the steps run as one captured CUDA graph, replayed for
    every call of the same structure (sampling/graph.py); :func:`sample_eager`
    runs the same work op by op.
    """
    with tracing.span("sample"):
        structure, inputs = prepare_sample(
            model, seeds, conditioning, latent_shape, unconditional, config, init_x, fixed_mask, fixed_tokens,
            cond_reweight,
        )
        if inputs["seeds"].device.type == "cuda":
            return graph.run(sample_body, model, structure, inputs)
        return sample_body(model, structure, inputs)


def sample_eager(
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
    """:func:`sample` without the CUDA graph: the device body run op by op,
    as the CPU always runs it. On a card it gives the graph's tokens bit for
    bit, and serves to compare the two."""
    structure, inputs = prepare_sample(
        model, seeds, conditioning, latent_shape, unconditional, config, init_x, fixed_mask, fixed_tokens, cond_reweight
    )
    return sample_body(model, structure, inputs)


def interpolate_latents(
    idx_a: torch.Tensor, idx_b: torch.Tensor, codebook: torch.Tensor, alphas: torch.Tensor
) -> torch.Tensor:
    """Latent interpolation between two token grids (a reference-notebook
    capability, readme.md:41): embed both grids with the codebook, lerp, and
    re-quantize each blend to the nearest code (kernel K4).

    idx_a/idx_b: (h, w) int. alphas: (n,) in [0, 1]. Returns (n, h, w) int32.
    """
    cb = codebook.float()
    za, zb = cb[idx_a.long()], cb[idx_b.long()]
    a = alphas.to(device=cb.device, dtype=torch.float32)[:, None, None, None]
    blends = za[None] * (1 - a) + zb[None] * a
    return fused_codebook_lookup(blends.contiguous(), cb.contiguous())


def outpaint_canvas(
    tokens: torch.Tensor, canvas_hw: tuple[int, int], offset: tuple[int, int], num_labels: int,
    seeds: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Build (init_x, fixed_mask) for outpainting: place `tokens` (B, h, w) on
    a canvas of random tokens at `offset`; the placed region is pinned every
    step. The canvas comes from each image's seed pair (B, 2) under a draw tag
    of its own; the JAX package draws it from jax.random, a stream the port
    cannot reproduce, so the canvas matches it in distribution only."""
    b, h, w = tokens.shape
    ch, cw = canvas_hw
    oy, ox = offset
    dev = tokens.device
    seeds = seeds.to(device=dev, dtype=torch.int64) & _M32
    canvas_seeds = derive_seeds(seeds, _CANVAS_TAG, torch.zeros(1, dtype=torch.int64, device=dev))[0]
    canvas = (_hash_bits(canvas_seeds, (ch, cw)) % num_labels).to(torch.int32)
    canvas[:, oy : oy + h, ox : ox + w] = tokens.to(torch.int32)
    mask = torch.zeros((b, ch, cw), dtype=torch.bool, device=dev)
    mask[:, oy : oy + h, ox : ox + w] = True
    return canvas, mask
