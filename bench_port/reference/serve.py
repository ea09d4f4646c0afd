"""What decides `correct` for a served generation: the reference run over the
program's own step inputs (teacher forcing), and its decode of the served
tokens.

A generation draws token = argmax_k(logit_k / T + G_k) at every position of
every step, G the counter-hash Gumbel noise of the image's seeds. The
reference recomputes, at each step, the conditioning from the prompt (ByT5,
CLIP text), the CFG pair's features from the step's input grid (the
program's, read from the timed call), the head, and the same noise, all in
float32. Its score of the token the program drew lies below its best score
by a gap that is 0 in exact arithmetic: `logit_gap` is the widest such gap,
`logit_mean_gap` their mean over every draw checked (0 where the draws
agree).
The draws are observed where the next step's input keeps them (positions not
renoised) and in the output; the other positions of each input must hold
the init noise (`renoise_mismatch`, exact). `image_max_gap` and
`image_mean_gap` compare the delivered image with the reference's decode of
the served tokens.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from . import codec, denoiser, sampling, text
from .nn import Params


@dataclasses.dataclass
class Served:
    """One image as the timed path served it."""

    prompt: str
    seeds: tuple  # the image's seed pair
    inputs: torch.Tensor  # (steps, h, w) the denoiser's input grid at each step
    tokens: torch.Tensor  # (h, w) the sampler's output
    image: torch.Tensor  # (H, W, 3) as delivered: uint8 PNG pixels or float in [0, 1]


class Reference:
    """The reference over one configuration's weights ({part: state dict})."""

    def __init__(self, weights: dict, sizes: dict, merges, cast: Optional[Callable] = None):
        self.sizes = sizes
        self.P = {part: Params(sd, cast=cast) for part, sd in weights.items()}
        self.tok = text.ClipBPE(merges)
        self.device = next(iter(weights["denoiser"].values())).device

    @torch.no_grad()
    def conditioning(self, prompts: list) -> tuple:
        """(c_embed (B, S, c_cond), mask (B, S)) of prompts, each at its own
        length, padded with masked positions."""
        cfg = self.sizes["denoiser"]
        states = [text.t5_encode(self.P["byt5"], self.sizes["byt5"],
                                 torch.tensor([text.byt5_ids(p)], device=self.device)) for p in prompts]
        s = max(x.shape[1] for x in states)
        byt5 = torch.cat([torch.nn.functional.pad(x, (0, 0, 0, s - x.shape[1])) for x in states])
        mask = torch.stack([torch.arange(s, device=self.device) < x.shape[1] for x in states])
        clip = text.clip_text(self.P["clip_text"], self.sizes["clip_text"], self.tok(prompts).to(self.device))
        return denoiser.cond_embedding(self.P["denoiser"], cfg, byt5, mask, clip)

    @torch.no_grad()
    def scores(self, c_embed, cond_mask, x: torch.Tensor, t: float, w: float, temperature: float,
               seeds: torch.Tensor, step: int) -> torch.Tensor:
        """(h*w, K) float32 scores of one image's step from input grid x (h, w)."""
        cfg = self.sizes["denoiser"]
        P = self.P["denoiser"]
        xs = x[None].expand(2, *x.shape).to(self.device)
        r = torch.full((2,), float(t), device=self.device)
        f = denoiser.features(P, cfg, xs, r, c_embed, cond_mask)
        mixed = f[0] * np.float32(w) + f[1] * (np.float32(1.0) - np.float32(w))
        logits = denoiser.head(P, mixed).reshape(-1, cfg["num_labels"])
        g = sampling.gumbel(seeds[None].to(self.device), step, logits.shape[0], logits.shape[1])[0]
        return logits * (np.float32(1.0) / np.float32(temperature)) + g

    @torch.no_grad()
    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        return codec.decode_indices(self.P["codec"], self.sizes["codec"], tokens[None].to(self.device))[0]


def walk(ref: Reference, s: Served, sample: dict, draw: Optional[Callable] = None):
    """Per step of one served image: (step, scores, observed mask (h*w,), the
    program's drawn tokens there (h*w,), renoise mismatches). `draw(step,
    x)` gives other drawn tokens in place of the program's (the control)."""
    steps = s.inputs.shape[0]
    sch = sampling.schedule(steps, sample["temperature"], (sample["cfg"], sample["cfg"]))
    seeds = torch.tensor(s.seeds, dtype=torch.int64, device=ref.device)
    h, w = s.tokens.shape
    n = h * w
    noise = sampling.init_noise(seeds[None], n, ref.sizes["denoiser"]["num_labels"])[0]
    pair = ref.conditioning([s.prompt, ""])
    inputs = s.inputs.to(ref.device).reshape(steps, n).long()
    keep_prev = torch.zeros(n, dtype=torch.bool, device=ref.device)  # step 0: every position is noise
    for i in range(steps):
        mismatch = int(((inputs[i] != noise) & ~keep_prev).sum())
        sc = ref.scores(*pair, s.inputs[i], sch["t"][i], sch["cfg"][i], sch["temperature"][i], seeds, i)
        if i + 1 < steps:
            back = sampling.renoised(seeds[None], i, n, sch["t"][i + 1])[0] & bool(sch["renoise"][i])
            observed, served = ~back, inputs[i + 1]
        else:
            back = torch.zeros(n, dtype=torch.bool, device=ref.device)
            observed, served = ~back, s.tokens.to(ref.device).reshape(n).long()
        if draw is not None:
            served = draw(i, s.inputs[i]).to(ref.device).reshape(n).long()
        yield i, sc, observed, served, mismatch
        keep_prev = ~back


def gaps(scores: torch.Tensor, observed: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best score each observed served token's
    score lies (inf for a token out of range). A draw whose uniform rounds
    to 1 has Gumbel noise +inf and wins its row; the served token that is
    that one lies 0 below it, not inf - inf."""
    best = scores.max(dim=-1).values
    got = scores.gather(-1, served.clamp(0, scores.shape[-1] - 1)[:, None])[:, 0]
    bad = (served < 0) | (served >= scores.shape[-1])
    g = torch.where(got == best, torch.zeros_like(best), best - got)
    return torch.where(bad, torch.full_like(best, float("inf")), g)[observed]


def delivered_gap(ref: Reference, s: Served, image: Optional[torch.Tensor] = None) -> tuple:
    """(widest, mean) difference between the delivered image (or `image`)
    and the reference's decode of the served tokens: in 8-bit levels for PNG
    pixels (the reference truncated as the server truncates), else in [0, 1]
    units."""
    img = ref.decode(s.tokens).clamp(0.0, 1.0)
    got = (s.image if image is None else image).to(ref.device)
    if got.dtype == torch.uint8:
        d = (got.int() - (img * 255).to(torch.uint8).int()).abs().float()
    else:
        d = (got.float() - img).abs()
    return float(d.max()), float(d.mean())


def check(ref: Reference, served: list, sample: dict) -> dict:
    """The numbers `correct` compares, over the served images checked."""
    logit_gap, total, mismatch, draws, widest, means = 0.0, 0.0, 0, 0, 0.0, []
    for s in served:
        for _, sc, observed, tok, mm in walk(ref, s, sample):
            g = gaps(sc, observed, tok)
            if g.numel():
                logit_gap, total = max(logit_gap, float(g.max())), total + float(g.sum())
            mismatch += mm
            draws += g.numel()
        w, m = delivered_gap(ref, s)
        widest, means = max(widest, w), means + [m]
    return {"logit_gap": logit_gap, "logit_mean_gap": total / max(draws, 1), "renoise_mismatch": mismatch,
            "image_max_gap": widest, "image_mean_gap": max(means) if means else 0.0, "draws_checked": draws}
