"""The training step's reference: the loss of dome272/Paella
`src_distributed/train.py:79-110` (per-example conditioning dropout, t =
clip(1 - u + t_min), the frozen codec's nearest-code labels, Bernoulli(t)
noising toward uniform ids, the label-smoothed cross-entropy weighted per
token by 1 - (1 - mask)(1 - t)(1 - min_val), normalized per image, averaged
over images) and AdamW as the JAX package's optax chain
(clip_by_global_norm, Adam with bias correction, decoupled weight decay
0.01, a linear warm-up from 0). Plain float32 torch; the batch and every
draw come from core/traffic.py::train_batch.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import codec, denoiser
from .nn import Params

B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01


def conditioning(batch: dict, null: dict):
    """(byt5, byt5_mask, clip, clip_image, clip_image_mask) after the coins."""
    s = batch["byt5"].shape[1]
    n = null["byt5"].shape[1]
    null_byt5 = F.pad(null["byt5"], (0, 0, 0, max(0, s - n)))[:, :s]
    null_mask = F.pad(null["byt5_mask"], (0, max(0, s - n)))[:, :s]
    db, dc = batch["drop_byt5"], batch["drop_clip"]
    byt5 = torch.where(db[:, None, None], null_byt5, batch["byt5"])
    mask = torch.where(db[:, None], null_mask, batch["byt5_mask"])
    clip = torch.where(dc[:, None], null["clip"], batch["clip"])
    return byt5, mask, clip, batch["clip_image"], ~batch["drop_image"]


def loss(P: Params, Pc: Params, sizes: dict, bn: tuple, batch: dict, null: dict, train: dict,
         rows: slice) -> torch.Tensor:
    """The mean over `rows` of the images' weighted losses, differentiable in
    P's tensors."""
    cfg = sizes["denoiser"]
    pick = {k: (v[rows] if torch.is_tensor(v) and v.dim() > 0 else v) for k, v in batch.items()}
    byt5, mask, clip, clip_image, image_mask = conditioning(pick, null)
    t = torch.clamp(1.0 - pick["u"] + train["t_min"], train["t_min"], 1.0)
    with torch.no_grad():
        labels = codec.encode_indices(Pc, sizes["codec"], pick["images"], *bn)
    nm = pick["noise_mask"].long()
    noised = labels * (1 - nm) + pick["random_x"].long() * nm
    weight = 1.0 - (1.0 - nm.float()) * ((1.0 - t[:, None, None]) * (1.0 - train["loss_weight_min"]))
    c_embed, cmask = denoiser.cond_embedding(P, cfg, byt5, mask, clip, None, clip_image, image_mask)
    dropout = (batch["dropout_seed"], rows, batch["images"].shape[0])
    logits = denoiser.head(P, denoiser.features(P, cfg, noised, t, c_embed, cmask, dropout))
    lse = torch.logsumexp(logits, dim=-1)
    nll = lse - logits.gather(-1, labels[..., None])[..., 0]
    s = train["label_smoothing"]
    tok = (1.0 - s) * nll + s * (lse - logits.mean(dim=-1))
    return ((tok * weight).sum(dim=(1, 2)) / weight.sum(dim=(1, 2))).mean()


def learning_rate(train: dict, count: int) -> float:
    w = train["warmup_updates"]
    if w <= 0:
        return 0.0
    f32 = np.float32
    frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
    return float(f32(0.0 - train["lr"]) * frac + f32(train["lr"]))


class Trainer:
    """The reference's parameters (f32 leaves), moments and count."""

    def __init__(self, params: dict, train: dict):
        self.params = {k: v.detach().float().clone().requires_grad_(True) for k, v in params.items()}
        self.mu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.params.items()}
        self.train, self.count = train, 0

    def step(self, sizes, codec_sd, bn, batch, null, micro: int, cast=None) -> tuple:
        """One update; -> (loss, {leaf: the clipped gradient})."""
        n = batch["images"].shape[0]
        P = Params(self.params, cast=cast)
        Pc = Params(codec_sd, cast=cast)
        grads = {k: torch.zeros_like(v) for k, v in self.params.items()}
        total = 0.0
        for r0 in range(0, n, micro):
            rows = slice(r0, min(n, r0 + micro))
            part = loss(P, Pc, sizes, bn, batch, null, self.train, rows) * ((rows.stop - rows.start) / n)
            gs = torch.autograd.grad(part, list(self.params.values()), allow_unused=True)
            for (k, _), g in zip(self.params.items(), gs):
                if g is not None:
                    grads[k] += g
            total += float(part.detach())
        with torch.no_grad():
            norm = torch.sqrt(sum(g.square().sum() for g in grads.values()))
            if not bool(norm < self.train["grad_clip"]):
                grads = {k: g / norm * self.train["grad_clip"] for k, g in grads.items()}
            count = self.count + 1
            f32 = np.float32
            c1, c2 = float(f32(1) - f32(B1) ** count), float(f32(1) - f32(B2) ** count)
            lr = learning_rate(self.train, self.count)
            for k, p in self.params.items():
                g = grads[k]
                self.mu[k].mul_(B1).add_(g, alpha=1.0 - B1)
                self.nu[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                upd = (self.mu[k] / c1) / (torch.sqrt(self.nu[k] / c2) + EPS) + WEIGHT_DECAY * p
                p.add_(upd * -lr)
            self.count = count
        return total, grads
