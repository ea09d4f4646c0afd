"""The sampler's draws and schedules, worked out again in plain torch.

Frozen copies of the counter hash and the draw rules of
`paella_tpu_torch/kernels/sampling.py` (mix32, hash_bits, uniform_from_bits)
and `paella_tpu_torch/sampling/sampler.py` (derive_seeds, linspace_f32, the
schedule rows, the init noise and the renoise rule), which restate the JAX
package's `paella_tpu/sampling/sampler.py`. Every value is uint32 arithmetic
in int64, masked to 32 bits after each step.
"""
from __future__ import annotations

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """The murmur3 finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_bits(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) int64 counter-hash bits of element i of each image's seed pair."""
    s = seeds.to(torch.int64) & M32
    idx = torch.arange(n, dtype=torch.int64, device=seeds.device)[None, :]
    return mix32((mix32(idx ^ s[:, :1]) + s[:, 1:]) & M32)


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """(0, 1) float32 from the high 24 bits, offset by 2^-25."""
    return (bits >> 8).to(torch.float32) * (2.0**-24) + (2.0**-25)


def derive_seeds(seeds: torch.Tensor, tag: int, step: int) -> torch.Tensor:
    """(B, 2) seed pairs of draw `tag` (0 init noise, 1 categorical, 2
    renoise) at step `step`."""
    s = seeds.to(torch.int64) & M32
    salt = mix32(torch.tensor((step * 0x9E3779B9 + ((tag * 0x85EBCA6B) & M32) + 1) & M32, device=seeds.device))
    return torch.stack([mix32(s[:, 0] ^ salt), mix32((s[:, 1] + salt) & M32)], dim=-1)


def linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    return np.linspace(np.float32(start), np.float32(stop), num, dtype=np.float64).astype(np.float32)


def schedule(steps: int, temperature, cfg) -> dict:
    """The per-step schedules as the sampler computes them on the host in f32
    (t from 1 to 0, every step but the last renoised)."""
    renoise_steps = steps - 1
    return {
        "t": linspace_f32(1.0, 0.0, steps + 1),
        "temperature": linspace_f32(*temperature, steps),
        "cfg": linspace_f32(*cfg, steps),
        "renoise": np.arange(steps) < renoise_steps,
    }


def init_noise(seeds: torch.Tensor, n: int, num_labels: int) -> torch.Tensor:
    """(B, n) int64 init tokens."""
    return hash_bits(derive_seeds(seeds, 0, 0), n) % num_labels


def gumbel(seeds: torch.Tensor, step: int, rows: int, k: int) -> torch.Tensor:
    """(B, rows, k) float32 Gumbel noise of step `step`'s categorical draw:
    element (row, label) uses the image-local counter row * k + label."""
    u = uniform(hash_bits(derive_seeds(seeds, 1, step), rows * k)).reshape(-1, rows, k)
    return -torch.log(-torch.log(u))


def renoised(seeds: torch.Tensor, step: int, n: int, t_next: float) -> torch.Tensor:
    """(B, n) bool: the positions step `step` sets back to the init noise."""
    return uniform(hash_bits(derive_seeds(seeds, 2, step), n)) <= np.float32(t_next)
