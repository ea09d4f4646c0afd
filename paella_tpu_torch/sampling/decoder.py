"""Stage B's sampler: the continuous DDPM of diffusers'
`DDPMWuerstchenScheduler` (s = 0.008, scaler 1) at guidance 0, as
`StableCascadeDecoderPipeline` runs it by default: one forward of the batch
a step, on the arithmetic of the prior's sampler (sampling/prior.py:
`schedule`, `ddpm_step`, `gaussian`).

    for t, t_prev in linspace(1, 0, steps + 1) pairs:
        eps = StageB(x, t, clip, effnet)
        x   = ddpm_step(x, eps, t, t_prev, z)

The scheduler's arithmetic is float32 and x is rounded to the model's dtype
after each step. x_init and each step's z are N(0, 1) drawn on the device
from the image's seed pair by the counter hash, under tags of their own (the
prior's are 3 and 4), so a call of the prior and of the decoder on the same
seeds draw apart.

On a CUDA device the cond cache and every step run as one captured CUDA
graph per structure (latent shape, steps; sampling/graph.py::run).

Spans: decoder.sample around a call, decoder.cond around the cond cache
(inside the graph on a card, so recorded on the CPU and in a graph's first
run).
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..config import DecoderSampleConfig
from ..utils import tracing
from . import graph
from .prior import ddpm_step, gaussian, schedule
from .sampler import derive_seeds

INIT_TAG, STEP_TAG = 5, 6  # derive_seeds tags of x_init and of each step's z


@dataclasses.dataclass
class DecoderConditioning:
    """Stage B's conditioning: the pooled CLIP-bigG text feature (B, 1,
    c_clip) and Stage C's latents (B, h, w, c_effnet)."""

    clip: torch.Tensor
    effnet: torch.Tensor


class DecoderStructure(NamedTuple):
    latent_shape: tuple  # (B, H, W, C)
    steps: int


def decoder_body(model: Any, structure: DecoderStructure, inputs: dict) -> torch.Tensor:
    """The device half of :func:`sample_decoder`: the cond cache, x_init and
    the steps, reading no value on the host (one graph replays any seeds
    and conditioning of the structure)."""
    b, h, w, c = structure.latent_shape
    p = model.config.patch_size
    seeds, t = inputs["seeds"], inputs["t"]
    dev, dt = seeds.device, model.config.compute_dtype
    with tracing.span("decoder.cond"):
        cache = model.gen_cond_cache(inputs["clip"], inputs["effnet"], (h // p, w // p))
    x = gaussian(derive_seeds(seeds, INIT_TAG, torch.zeros(1, dtype=torch.int64, device=dev))[0], (h, w, c)).to(dt)
    z_seeds = derive_seeds(seeds, STEP_TAG, torch.arange(structure.steps, dtype=torch.int64, device=dev))
    for i in range(structure.steps):
        e = model(x, t[i].expand(b), cond_cache=cache)
        x = ddpm_step(x, e, t[i], t[i + 1], gaussian(z_seeds[i], (h, w, c))).to(dt)
    return x


def sample_decoder(
    model: Any,
    seeds: torch.Tensor,
    cond: DecoderConditioning,
    latent_shape: tuple,
    config: DecoderSampleConfig = DecoderSampleConfig(),
) -> torch.Tensor:
    """Stage A latents (B, H, W, C) in the model's dtype, on its device.
    seeds: (B, 2) uint32 values, one pair an image."""
    with tracing.span("decoder.sample"):
        dev = next(model.parameters()).device
        inputs = {
            "seeds": seeds.to(dev, torch.int64),
            "t": schedule(config.steps).to(dev),
            "clip": cond.clip.to(dev),
            "effnet": cond.effnet.to(dev),
        }
        structure = DecoderStructure(tuple(latent_shape), config.steps)
        if dev.type == "cuda":
            return graph.run(decoder_body, model, structure, inputs)
        return decoder_body(model, structure, inputs)
