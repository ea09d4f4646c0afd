"""Stage C's sampler: the continuous DDPM of diffusers'
`DDPMWuerstchenScheduler` (s = 0.008, scaler 1) with classifier-free
guidance, as `StableCascadePriorPipeline` runs it.

    abar(t) = clamp(cos((t + s) / (1 + s) * pi / 2)^2 / cos(s / (1 + s) * pi / 2)^2, 1e-4, 0.9999)
    for t, t_prev in linspace(1, 0, steps + 1) pairs:
        eps   = lerp(eps_uncond, eps_text, cfg)           # one batch-2B forward
        alpha = abar(t) / abar(t_prev)
        mu    = alpha^-1/2 (x - (1 - alpha) eps / sqrt(1 - abar(t)))
        x     = mu + [t_prev != 0] sqrt((1 - alpha)(1 - abar(t_prev)) / (1 - abar(t))) z

The scheduler's arithmetic is float32 and x is rounded to the model's dtype
after each step (diffusers returns `prev_sample` in the model output's
dtype). x_init and each step's z are N(0, 1) drawn on the device from the
image's seed pair by the counter hash of kernels/sampling.py (Box-Muller
over two uniforms an element), so a reference can draw them again; this
departs from torch's Philox stream, which diffusers draws from.

On a CUDA device the cond cache and every step run as one captured CUDA
graph per structure (sampling/graph.py::run); the guidance scale and t are
device inputs, so other guidance scales replay the same graph.

Spans: prior.sample around a call, prior.cond around the cond cache (inside
the graph on a card, so recorded on the CPU and in a graph's first run).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..config import PriorSampleConfig
from ..kernels.sampling import hash_bits, uniform_from_bits
from ..utils import tracing
from . import graph
from .sampler import derive_seeds

S = 0.008
INIT_ALPHA = math.cos(S / (1 + S) * math.pi * 0.5) ** 2
INIT_TAG, STEP_TAG = 3, 4  # derive_seeds tags of x_init and of each step's z


@dataclasses.dataclass
class PriorConditioning:
    """Stage C's conditioning: the text tower's last hidden states (B, S,
    c_clip_text), its projected EOT feature (B, 1, c_clip_text_pooled) and
    the image embeddings (B, 1, c_clip_img)."""

    clip_text: torch.Tensor
    clip_text_pooled: torch.Tensor
    clip_img: torch.Tensor

    def tensors(self) -> dict:
        """The fields by name (dataclasses.asdict would copy the tensors)."""
        return {f.name: getattr(self, f.name) for f in dataclasses.fields(self)}

    def pair(self, uncond: "PriorConditioning") -> "PriorConditioning":
        """[self | uncond] along the batch, one forward for both sides."""
        u = uncond.tensors()
        return PriorConditioning(**{k: torch.cat([v, u[k].to(v.dtype)]) for k, v in self.tensors().items()})


class PriorStructure(NamedTuple):
    latent_shape: tuple  # (B, H, W, C)
    steps: int


def alpha_cumprod(t: torch.Tensor) -> torch.Tensor:
    """DDPMWuerstchenScheduler._alpha_cumprod at scaler 1, in float32 with s
    and the normalizer cos(s / (1 + s) pi / 2)^2 as Python scalars (no host
    tensor, so a CUDA graph can capture it)."""
    return (torch.cos((t.float() + S) / (1 + S) * (math.pi * 0.5)) ** 2 / INIT_ALPHA).clamp(0.0001, 0.9999)


def ddpm_step(x: torch.Tensor, eps: torch.Tensor, t: torch.Tensor, t_prev: torch.Tensor,
              z: torch.Tensor) -> torch.Tensor:
    """One scheduler step in float32 (the module docstring's x update)."""
    ac, ap = alpha_cumprod(t), alpha_cumprod(t_prev)
    alpha = ac / ap
    mu = (1.0 / alpha).sqrt() * (x.float() - (1 - alpha) * eps.float() / (1 - ac).sqrt())
    std = ((1 - alpha) * (1.0 - ap) / (1.0 - ac)).sqrt()
    return mu + std * z * (t_prev != 0).float()


def gaussian(seeds: torch.Tensor, shape: tuple) -> torch.Tensor:
    """(B, *shape) float32 N(0, 1) from seed pairs (B, 2): element i takes the
    hash's uniforms u1 (counter i) and u2 (counter n + i), and gives
    sqrt(-2 ln u1) cos(2 pi u2)."""
    n = math.prod(shape)
    u = uniform_from_bits(hash_bits(seeds, (2, n)))
    z = torch.sqrt(-2.0 * torch.log(u[:, 0])) * torch.cos((2.0 * math.pi) * u[:, 1])
    return z.reshape(seeds.shape[0], *shape)


def prior_body(model: Any, structure: PriorStructure, inputs: dict) -> torch.Tensor:
    """The device half of :func:`sample_prior`: the cond cache, x_init and
    the steps, reading no value on the host (one graph replays any seeds,
    CFG and t values of the structure)."""
    b, h, w, c = structure.latent_shape
    seeds, t, cfg = inputs["seeds"], inputs["t"], inputs["cfg"]
    dev, dt = seeds.device, model.config.compute_dtype
    with tracing.span("prior.cond"):
        cache = model.gen_cond_cache(inputs["clip_text"], inputs["clip_text_pooled"], inputs["clip_img"])
    x = gaussian(derive_seeds(seeds, INIT_TAG, torch.zeros(1, dtype=torch.int64, device=dev))[0], (h, w, c)).to(dt)
    z_seeds = derive_seeds(seeds, STEP_TAG, torch.arange(structure.steps, dtype=torch.int64, device=dev))
    for i in range(structure.steps):
        r = t[i].expand(b)
        e = model(torch.cat([x, x]), torch.cat([r, r]), cond_cache=cache)
        eps = torch.lerp(e[b:].float(), e[:b].float(), cfg)
        x = ddpm_step(x, eps, t[i], t[i + 1], gaussian(z_seeds[i], (h, w, c))).to(dt)
    return x


def schedule(steps: int) -> torch.Tensor:
    """t = linspace(1, 0, steps + 1): 1 + i * (-1 / steps) in float64, the
    last point 0, correctly rounded to float32."""
    t = 1.0 + torch.arange(steps + 1, dtype=torch.float64) * (-1.0 / steps)
    t[-1] = 0.0
    return t.float()


def sample_prior(
    model: Any,
    seeds: torch.Tensor,
    cond: PriorConditioning,
    latent_shape: tuple,
    uncond: PriorConditioning,
    config: PriorSampleConfig = PriorSampleConfig(),
) -> torch.Tensor:
    """Latents (B, H, W, C) in the model's dtype, on its device. seeds: (B, 2)
    uint32 values, one pair an image; uncond the unconditional side of the
    guidance (the empty prompt's conditioning)."""
    with tracing.span("prior.sample"):
        dev = next(model.parameters()).device
        inputs = {
            "seeds": seeds.to(dev, torch.int64),
            "t": schedule(config.steps).to(dev),
            "cfg": torch.tensor(float(config.cfg), dtype=torch.float32, device=dev),
            **{k: v.to(dev) for k, v in cond.pair(uncond).tensors().items()},
        }
        structure = PriorStructure(tuple(latent_shape), config.steps)
        if dev.type == "cuda":
            return graph.run(prior_body, model, structure, inputs)
        return prior_body(model, structure, inputs)
