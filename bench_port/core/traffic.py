"""The one traffic generator. A mix is a JSON file of parameters
(`traffic/<mix>.json`); every draw comes from the run's --seed.

kind "text_requests": calls of `batch` images each, one prompt and one image
seed per image.
  prompt_bytes   {"min", "max", "dist": "loguniform" | "uniform"}: the prompt
                 lengths in bytes. Each block of `block` prompts takes the
                 block's quantiles of the distribution in a seeded order, so
                 every seed sends the same sizes, in another order.
  pool           "fresh": every prompt is new; an integer n: n prompts drawn
                 once, every call sends the same batch of them.
  words          a word list beside the mix; prompts are words joined by
                 spaces, cut to their length.
  image seeds    a fresh uint32 per image.

kind "train_batches": one batch a step, drawn on the device by the entry
from a generator seeded here (`batch_seed`).
"""
from __future__ import annotations

import math
import zlib
from pathlib import Path

import numpy as np

from .cell import BENCH


def _rng(seed: int, salt: str) -> np.random.Generator:
    return np.random.Generator(np.random.PCG64([int(seed) % 2**64, zlib.crc32(salt.encode())]))


def _quantiles(spec: dict, k: int) -> list:
    lo, hi = float(spec["min"]), float(spec["max"])
    q = (np.arange(k) + 0.5) / k
    if spec.get("dist", "uniform") == "loguniform":
        vals = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    else:
        vals = lo + q * (hi - lo)
    return [int(round(v)) for v in vals]


def words(mix: dict) -> list:
    path = BENCH / "traffic" / mix["words"]
    return [w for w in Path(path).read_text().split() if w.isascii() and w.isalpha()]


def _prompt(rng: np.random.Generator, vocab: list, n: int) -> str:
    parts, size = [], -1
    while size < n:
        w = vocab[int(rng.integers(len(vocab)))]
        parts.append(w)
        size += len(w) + 1
    return " ".join(parts)[:n].rstrip().ljust(n, "s")


class TextRequests:
    """calls(seed) -> call i: {"prompts": [...], "seeds": [uint32, ...]}."""

    def __init__(self, mix: dict, seed: int):
        self.mix, self.batch = mix, int(mix["batch"])
        self.vocab = words(mix)
        self.rng = _rng(seed, "prompts")
        self.seed_rng = _rng(seed, "image-seeds")
        self.block = int(mix.get("block", 16))
        self.seen: set = set()
        self.lengths: list = []
        pool = mix.get("pool", "fresh")
        self.pool = None if pool == "fresh" else [self._new() for _ in range(int(pool))]

    def _length(self) -> int:
        if not self.lengths:
            self.lengths = list(self.rng.permutation(_quantiles(self.mix["prompt_bytes"], self.block)))
        return int(self.lengths.pop())

    def _new(self) -> str:
        n = self._length()
        while True:
            p = _prompt(self.rng, self.vocab, n)
            if p not in self.seen:
                self.seen.add(p)
                return p

    def next(self) -> dict:
        if self.pool is not None:
            prompts = list(self.pool[: self.batch])
        else:
            prompts = [self._new() for _ in range(self.batch)]
        seeds = [int(s) for s in self.seed_rng.integers(0, 2**32, self.batch, dtype=np.uint64)]
        return {"prompts": prompts, "seeds": seeds}


def generator(mix: dict, seed: int):
    kind = mix["kind"]
    if kind == "text_requests":
        return TextRequests(mix, seed)
    if kind == "train_batches":
        return TrainBatches(mix, seed)
    raise ValueError(f"traffic kind {kind!r}")


class TrainBatches:
    """next() -> {"step": i, "batch_seed": int}: the entry draws the batch on
    the device from a generator seeded with batch_seed."""

    def __init__(self, mix: dict, seed: int):
        self.mix = mix
        self.rng = _rng(seed, "batches")
        self.step = 0

    def next(self) -> dict:
        out = {"step": self.step, "batch_seed": int(self.rng.integers(0, 2**62))}
        self.step += 1
        return out


def train_batch(spec: dict, train: dict, num_labels: int, latent_hw: tuple, batch_seed: int, device) -> dict:
    """One training step's inputs and draws, made on the device from
    `batch_seed` (spec: the configuration's "batch"; train: its TrainConfig
    fields): images (B, H, W, 3) in [0, 1]; ByT5 states (B, S, D) with masks
    of seeded lengths 1..S; CLIP text and image embeddings; the three
    conditioning-dropout coins, u (t = clip(1 - u + t_min, t_min, 1)), the
    noise mask (u' <= t), the replacement ids and the dropout seed."""
    import torch

    g = torch.Generator(device=device).manual_seed(int(batch_seed))
    b, hw, s = int(spec["images"]), int(spec["image_hw"]), int(spec["byt5_len"])
    d, c = int(spec["byt5_embd"]), int(spec["clip_embd"])

    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device)

    out = {"images": rand(b, hw, hw, 3), "byt5": torch.randn(b, s, d, generator=g, device=device)}
    lengths = torch.randint(1, s + 1, (b, 1), generator=g, device=device)
    out["byt5_mask"] = torch.arange(s, device=device)[None, :] < lengths
    out["clip"] = torch.randn(b, c, generator=g, device=device)
    out["clip_image"] = torch.randn(b, c, generator=g, device=device)
    out["drop_byt5"] = rand(b) < train["byt5_drop_prob"]
    out["drop_clip"] = rand(b) < train["clip_text_drop_prob"]
    out["drop_image"] = rand(b) < train["clip_image_drop_prob"]
    out["u"] = rand(b)
    t = torch.clamp(1.0 - out["u"] + train["t_min"], train["t_min"], 1.0)
    out["noise_mask"] = (rand(b, *latent_hw) <= t[:, None, None]).to(torch.int32)
    out["random_x"] = torch.randint(0, num_labels, (b, *latent_hw), generator=g, device=device)
    out["dropout_seed"] = int(torch.randint(0, 2**62, (1,), generator=g, device=device).item())
    return out


def null_cond(spec: dict, seed: int, device) -> dict:
    """The frozen encoders' stand-in for the empty prompt, fixed for a run."""
    import torch

    g = torch.Generator(device=device).manual_seed((int(seed) * 31 + 7) % 2**63)
    n, d, c = int(spec["null_byt5_len"]), int(spec["byt5_embd"]), int(spec["clip_embd"])
    return {"byt5": torch.randn(1, n, d, generator=g, device=device),
            "byt5_mask": torch.ones(1, n, dtype=torch.bool, device=device),
            "clip": torch.randn(1, c, generator=g, device=device)}
