"""VQGAN codec pretraining: reconstruction + codebook + adversarial losses,
the counterpart of `paella_tpu/codec/trainer.py`.

The reference ships a patch Discriminator (src/vqgan.py:115-140) but no codec
training loop. One step (`make_codec_train_step`), in the JAX package's
order: the generator loss (L1 + L2 reconstruction, VQ + 0.25 commitment and,
from `disc_start` on, the non-saturating adversarial term scored by the
discriminator as it was before this step), clipped AdamW on the codec (the
codebook exempt from weight decay), dead-code revival from `code_age`, then
the discriminator's BCE loss on the detached reconstruction and clipped
AdamW on it. The codec's BatchNorm statistics and the discriminator's
spectral-norm state are updated in place. The encode's nearest-code search
is kernel K4 on the card, one launch a step.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import TrainConfig
from ..train.trainer import AdamW
from .vqgan import Discriminator, VQModel


@dataclasses.dataclass(frozen=True)
class CodecTrainConfig:
    lr: float = 1e-4
    disc_lr: float = 1e-4
    recon_l1_weight: float = 1.0
    recon_l2_weight: float = 1.0
    vq_weight: float = 1.0  # applied to (vq_loss + 0.25 * commit), src/vqgan.py:95
    adv_weight: float = 0.1
    disc_start: int = 0  # steps before adversarial loss kicks in
    grad_clip: float = 1.0
    # Dead-code revival (0 disables): a code unused for `revive_after`
    # consecutive steps is re-seeded to a random encoder latent from the
    # current batch. Gradient-based VQ collapses without it: a handful of
    # early winners absorb all gradient while weight decay shrinks the rest.
    revive_after: int = 100


class CodecAdamW(AdamW):
    """optax.adamw(lr) after clip_by_global_norm, as the JAX codec trainer
    chains them: the trainer's AdamW with optax.adamw's default weight
    decay, 1e-4, a constant learning rate (no warmup: the first update is
    at lr) and every update applied (no finiteness gate). A parameter group
    may set its own `weight_decay` (0 exempts the codebook)."""

    WEIGHT_DECAY = 1e-4

    def __init__(self, params, lr: float, grad_clip: float):
        super().__init__(params, TrainConfig(lr=lr, grad_clip=grad_clip, skip_nonfinite_updates=False))

    def learning_rate(self, count: int) -> float:
        return float(np.float32(self.cfg.lr))


@dataclasses.dataclass
class CodecTrainState:
    """The two optimizers, each code's count of consecutive unused steps,
    the generator of revival's draws and the number of steps taken."""

    gen_opt: CodecAdamW
    disc_opt: CodecAdamW
    code_age: torch.Tensor  # (K,) int32
    generator: torch.Generator
    step: int = 0


def create_codec_train_state(
    vq: VQModel, disc: Discriminator, cfg: CodecTrainConfig = CodecTrainConfig(),
    generator: Optional[torch.Generator] = None,
) -> CodecTrainState:
    """Optimizers over the (already initialized) codec and discriminator;
    revival's draws from `generator`, by default one on the codec's device
    seeded with 0x5EED (the JAX trainer's revival key)."""
    device = vq.vquantizer.codebook.weight.device
    codebook = vq.vquantizer.codebook.weight
    rest = [p for p in vq.parameters() if p is not codebook]
    gen_opt = CodecAdamW([{"params": rest}, {"params": [codebook], "weight_decay": 0.0}], cfg.lr, cfg.grad_clip)
    disc_opt = CodecAdamW(disc.parameters(), cfg.disc_lr, cfg.grad_clip)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0x5EED)
    code_age = torch.zeros(vq.config.codebook_size, dtype=torch.int32, device=device)
    return CodecTrainState(gen_opt, disc_opt, code_age, generator)


def _apply(opt: CodecAdamW, params: list, grads) -> None:
    for p, g in zip(params, grads):
        p.grad = g
    opt.step()
    for p in params:
        p.grad = None


def make_codec_train_step(vq: VQModel, disc: Discriminator, cfg: CodecTrainConfig = CodecTrainConfig()):
    """step(state, images, revive_rows=None) -> metrics: one codec update and
    one discriminator update, in place on both models and `state`.
    images (B, H, W, 3) in [0, 1]. revive_rows (K,) pins the batch latent
    each code would be re-seeded from (the JAX step draws it with
    jax.random from the step); None draws it from the state's generator."""

    def step(state: CodecTrainState, images: torch.Tensor, revive_rows: Optional[torch.Tensor] = None) -> dict:
        gen_params = [p for g in state.gen_opt.param_groups for p in g["params"]]
        disc_params = list(disc.parameters())

        # --- generator ----------------------------------------------------
        qe, z, idx, vq_loss = vq.encode_train(images)
        recon = vq.decode_train(qe)
        l1 = torch.mean(torch.abs(recon - images))
        l2 = torch.mean(torch.square(recon - images))
        loss = cfg.recon_l1_weight * l1 + cfg.recon_l2_weight * l2 + cfg.vq_weight * vq_loss
        d_fake = disc(recon, update_stats=False)
        g_adv = -torch.mean(torch.log(d_fake + 1e-6))  # non-saturating, on the sigmoid patch map
        adv_on = float(state.step >= cfg.disc_start)
        g_loss = loss + cfg.adv_weight * adv_on * g_adv
        _apply(state.gen_opt, gen_params, torch.autograd.grad(g_loss, gen_params))

        # --- dead-code revival --------------------------------------------
        k = vq.config.codebook_size
        used = torch.zeros(k, dtype=torch.int32, device=idx.device)
        used[idx.reshape(-1).long()] = 1
        n_revived = torch.zeros((), dtype=torch.int64, device=idx.device)
        if cfg.revive_after > 0:
            age = torch.where(used > 0, 0, state.code_age + 1).to(torch.int32)
            revive = age >= cfg.revive_after
            # BatchNorm-space latents: encode returns z / scale_factor
            zf = (z.detach() * vq.config.scale_factor).reshape(-1, vq.config.c_latent).float()
            if revive_rows is None:
                revive_rows = torch.randint(0, zf.shape[0], (k,), generator=state.generator, device=zf.device)
            cb = vq.vquantizer.codebook.weight
            with torch.no_grad():
                cb.copy_(torch.where(revive[:, None], zf[revive_rows.to(zf.device).long()].to(cb.dtype), cb))
            state.code_age = torch.where(revive, 0, age).to(torch.int32)
            n_revived = revive.sum()
        if hasattr(vq, "drop_derived"):
            vq.drop_derived()

        # --- discriminator --------------------------------------------------
        # both terms from the spectral norm's u as it was; d_real then stores the new u
        d_fake_d = disc(recon.detach(), update_stats=False)
        d_real = disc(images, update_stats=True)
        d_loss = -torch.mean(torch.log(d_real + 1e-6)) - torch.mean(torch.log(1.0 - d_fake_d + 1e-6))
        _apply(state.disc_opt, disc_params, torch.autograd.grad(d_loss, disc_params))
        if hasattr(disc, "drop_derived"):
            disc.drop_derived()

        state.step += 1
        return {
            "g_loss": g_loss.detach(),
            "d_loss": d_loss.detach(),
            "recon_l1": l1.detach(),
            "vq_loss": vq_loss.detach(),
            "d_real": d_real.detach().mean(),
            "d_fake": d_fake_d.detach().mean(),
            "codes_used_batch": used.sum(),
            "codes_revived": n_revived,
        }

    return step
