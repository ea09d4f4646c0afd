"""VQGAN f4 codec: 256x256x3 image <-> 64x64 grid of tokens, the counterpart
of `paella_tpu/codec/vqgan.py` (encoder, encode, decoder, decode,
decode_indices, and the patch `Discriminator` of codec training).

Parameters keep the reference torch model's names (src/vqgan.py:45-112), so a
reference-layout state dict loads with `strict=True`. The encoder ends in a
BatchNorm evaluated with its running statistics in float32; its latents go to
the quantizer (codec/quantize.py), whose nearest-code search is the port's
CUDA kernel K4. The convolutions, blocks and decoder are plain torch: no
Pallas kernel runs there in the JAX package either. A float32 codec's
encoder and decoder round as IEEE float32 on the card whatever the caller's
TF32 flags (nn/functional.py::exact_f32).

The inference methods run under no_grad with BatchNorm's running statistics.
Codec training (codec/trainer.py) takes `encode_train` and `decode_train`:
the same computation with gradients, BatchNorm normalizing with the batch's
statistics and updating the running ones as flax does (momentum 0.9 on the
running value, the biased batch variance).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import VQConfig
from ..nn import init
from ..nn.functional import depth_to_space, exact_f32, gelu, layer_norm, replication_pad_2d, space_to_depth
from .quantize import VectorQuantize


def _lin(m: nn.Module, x: torch.Tensor, dt) -> torch.Tensor:
    """A 1x1 conv or Linear on the last axis of NHWC x, in dtype dt."""
    w = m.weight if m.weight.dim() == 2 else m.weight[:, :, 0, 0]
    bias = None if m.bias is None else m.bias.to(dt)
    return F.linear(x.to(dt), w.to(dt), bias)


class VQResBlock(nn.Module):
    """Dual-branch residual block gated by 6 learned scalars (reference:
    src/vqgan.py:6-42); gammas zero-initialized, so the identity at init. The
    gated sums run in float32, as the JAX package's type promotion does."""

    def __init__(self, c: int, c_hidden: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.gammas = nn.Parameter(torch.zeros(6))
        self.depthwise = nn.Sequential(nn.Identity(), nn.Conv2d(c, c, 3, groups=c))  # 0: ReplicationPad2d(1)
        self.channelwise = nn.Sequential(nn.Linear(c, c_hidden), nn.GELU(), nn.Linear(c_hidden, c))

    def reset_parameters(self, gen: torch.Generator) -> None:
        init.zeros_(self.gammas)
        for m in (self.depthwise[1], self.channelwise[0], self.channelwise[2]):
            init.xavier_uniform_(m.weight, gen)
            init.zeros_(m.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        g = self.gammas.float()
        h = layer_norm(x).float() * (1 + g[0]) + g[1]
        h = replication_pad_2d(h, 1).to(dt)
        conv = self.depthwise[1]
        h = F.conv2d(h.permute(0, 3, 1, 2), conv.weight.to(dt), conv.bias.to(dt), groups=conv.groups)
        x = x.float() + h.permute(0, 2, 3, 1).float() * g[2]
        h = layer_norm(x) * (1 + g[3]) + g[4]
        h = _lin(self.channelwise[2], gelu(_lin(self.channelwise[0], h, dt)), dt)
        return x + h.float() * g[5]


class VQModel(nn.Module):
    """f4 codec (reference: src/vqgan.py:45-112).

      encode(x)          -> (qe/scale, z/scale, indices, vq_loss + 0.25*commit)
      decode(z)          -> image from continuous (scaled) latents
      decode_indices(ix) -> image from a token grid
    """

    def __init__(self, config: VQConfig):
        super().__init__()
        cfg = self.config = config
        dt = cfg.compute_dtype
        c_levels = [cfg.c_hidden // (2**i) for i in reversed(range(cfg.levels))]
        self.c_levels = c_levels

        # -- encoder --
        self.in_block = nn.Sequential(nn.Identity(), nn.Conv2d(3 * 4, c_levels[0], kernel_size=1))
        down = []
        for i in range(cfg.levels):
            if i > 0:
                down.append(nn.Conv2d(c_levels[i - 1], c_levels[i], kernel_size=4, stride=2, padding=1))
            down.append(VQResBlock(c_levels[i], c_levels[i] * 4, dtype=dt))
        down.append(
            nn.Sequential(
                nn.Conv2d(c_levels[-1], cfg.c_latent, kernel_size=1, bias=False),
                nn.BatchNorm2d(cfg.c_latent),
            )
        )
        self.down_blocks = nn.Sequential(*down)
        self.vquantizer = VectorQuantize(cfg.c_latent, cfg.codebook_size)

        # -- decoder --
        up = [nn.Sequential(nn.Conv2d(cfg.c_latent, c_levels[-1], kernel_size=1))]
        for i in range(cfg.levels):
            c = c_levels[cfg.levels - 1 - i]
            for _ in range(cfg.bottleneck_blocks if i == 0 else 1):
                up.append(VQResBlock(c, c * 4, dtype=dt))
            if i < cfg.levels - 1:
                up.append(
                    nn.ConvTranspose2d(c, c_levels[cfg.levels - 2 - i], kernel_size=4, stride=2, padding=1)
                )
        self.up_blocks = nn.Sequential(*up)
        self.out_block = nn.Sequential(nn.Conv2d(c_levels[0], 3 * 4, kernel_size=1))  # + PixelShuffle(2)

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The JAX package's init (paella_tpu/codec/vqgan.py:103-175), drawn
        from `gen`: decoder, codebook U(+-1/K), then encoder; BatchNorm at
        scale 1, bias 0 and running statistics (0, 1)."""
        cfg = self.config
        from_latent = self.up_blocks[0][0]
        init.kaiming_uniform_leaky_(from_latent.weight, gen)
        init.torch_default_bias_(from_latent.bias, cfg.c_latent, gen)
        for m in self.up_blocks[1:]:
            if isinstance(m, VQResBlock):
                m.reset_parameters(gen)
            else:  # ConvTranspose2d: torch's fan reads the out channels
                init.kaiming_uniform_leaky_(m.weight, gen)
                init.torch_default_bias_(m.bias, m.out_channels * 4 * 4, gen)
        out = self.out_block[0]
        init.kaiming_uniform_leaky_(out.weight, gen)
        init.torch_default_bias_(out.bias, self.c_levels[0], gen)
        self.vquantizer.reset_parameters(gen)
        in_conv = self.in_block[1]
        init.kaiming_uniform_leaky_(in_conv.weight, gen)
        init.torch_default_bias_(in_conv.bias, 3 * 4, gen)
        for m in self.down_blocks[:-1]:
            if isinstance(m, VQResBlock):
                m.reset_parameters(gen)
            else:  # the stride-2 4x4 conv
                init.kaiming_uniform_leaky_(m.weight, gen)
                init.torch_default_bias_(m.bias, m.in_channels * 4 * 4, gen)
        to_latent, norm = self.down_blocks[-1]
        init.kaiming_uniform_leaky_(to_latent.weight, gen)
        norm.reset_parameters()

    @torch.no_grad()
    def encoder(self, x: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) image -> (B, H/f, W/f, c_latent) float32 pre-quantization
        latents, f = config.downscale; BatchNorm in eval mode (running
        statistics, eps 1e-5)."""
        return self._encoder(x, train=False)

    def _encoder(self, x: torch.Tensor, train: bool) -> torch.Tensor:
        dt = self.config.compute_dtype
        with exact_f32(dt):
            h = _lin(self.in_block[1], space_to_depth(x.to(dt), 2), dt)
            for m in self.down_blocks[:-1]:
                if isinstance(m, VQResBlock):
                    h = m(h)
                else:
                    y = F.conv2d(
                        h.to(dt).permute(0, 3, 1, 2), m.weight.to(dt), m.bias.to(dt),
                        stride=m.stride, padding=m.padding,
                    )
                    h = y.permute(0, 2, 3, 1)
            to_latent, norm = self.down_blocks[-1]
            h = _lin(to_latent, h, dt).float()
        if train:  # flax: var = max(0, E[x^2] - E[x]^2), running = 0.9 * running + (1 - 0.9) * batch
            mean = h.mean(dim=(0, 1, 2))
            var = torch.clamp((h * h).mean(dim=(0, 1, 2)) - mean * mean, min=0.0)
            with torch.no_grad():
                norm.running_mean.copy_(0.9 * norm.running_mean + (1 - 0.9) * mean)
                norm.running_var.copy_(0.9 * norm.running_var + (1 - 0.9) * var)
                norm.num_batches_tracked += 1
        else:
            mean, var = norm.running_mean.float(), norm.running_var.float()
        # flax BatchNorm's order: (x - mean) * (rsqrt(var + eps) * scale) + bias
        mul = torch.rsqrt(var + norm.eps) * norm.weight.float()
        return (h - mean) * mul + norm.bias.float()

    @torch.no_grad()
    def encode(self, x: torch.Tensor):
        """Image -> (qe / s, z / s, indices, vq_loss + 0.25 * commit_loss), s the
        scale_factor (reference: src/vqgan.py:91-95)."""
        return self._encode(x, train=False)

    def encode_train(self, x: torch.Tensor):
        """`encode` for codec training (JAX's encode(x, train=True)):
        differentiable, BatchNorm on the batch's statistics, its running
        statistics updated in place; qe is the straight-through value."""
        return self._encode(x, train=True)

    def _encode(self, x: torch.Tensor, train: bool):
        z = self._encoder(x, train)
        qe, (vq_loss, commit_loss), idx = self.vquantizer.quantize(z)
        s = self.config.scale_factor
        return qe / s, z / s, idx, vq_loss + commit_loss * 0.25

    @torch.no_grad()
    def decoder(self, z: torch.Tensor) -> torch.Tensor:
        """(B, h, w, c_latent) latents -> (B, 4h, 4w, 3) image."""
        return self._decoder(z)

    def _decoder(self, z: torch.Tensor) -> torch.Tensor:
        dt = self.config.compute_dtype
        with exact_f32(dt):
            h = _lin(self.up_blocks[0][0], z, dt)
            for m in self.up_blocks[1:]:
                if isinstance(m, VQResBlock):
                    h = m(h)
                else:
                    y = F.conv_transpose2d(
                        h.to(dt).permute(0, 3, 1, 2), m.weight.to(dt), m.bias.to(dt),
                        stride=m.stride, padding=m.padding,
                    )
                    h = y.permute(0, 2, 3, 1)
            return depth_to_space(_lin(self.out_block[0], h, dt), 2)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """Continuous (scaled) latents -> image (reference: src/vqgan.py:97-101)."""
        return self.decoder(z * self.config.scale_factor)

    def decode_train(self, z: torch.Tensor) -> torch.Tensor:
        """`decode` with gradients, for codec training."""
        return self._decoder(z * self.config.scale_factor)

    def decode_indices(self, indices: torch.Tensor) -> torch.Tensor:
        """Token grid (B, h, w) -> image (reference: src/vqgan.py:103-107).
        The unscaled codebook vectors go to the decoder: no scale_factor."""
        return self.decoder(self.vquantizer.idx2vq(indices))


def _l2_normalize(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).sum() + eps)


class SpectralNormConv(nn.Module):
    """A stride-2 3x3 conv, padding 1 (NHWC in and out), whose kernel is
    divided by its largest singular value, estimated by one power iteration: flax
    `nn.SpectralNorm(nn.Conv(...))` with n_steps 1 and eps 1e-12. The kernel
    is flattened as flax flattens it, (kh * kw * c_in, c_out); the vector u
    (1, c_out) and the estimate sigma are buffers, updated only under
    `update_stats=True`. u and v carry no gradient; sigma does, through the
    kernel."""

    EPS = 1e-12

    def __init__(self, c_in: int, c_out: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(c_out, c_in, 3, 3))
        self.bias = nn.Parameter(torch.zeros(c_out))
        self.register_buffer("u", torch.zeros(1, c_out))
        self.register_buffer("sigma", torch.ones(()))

    def reset_parameters(self, gen: torch.Generator) -> None:
        init.kaiming_uniform_leaky_(self.weight, gen)
        init.zeros_(self.bias)
        with torch.no_grad():
            self.u.copy_(torch.randn(self.u.shape, generator=gen, device=gen.device))
            self.sigma.fill_(1.0)

    def normalized_weight(self, update_stats: bool = False) -> torch.Tensor:
        w = self.weight.permute(2, 3, 1, 0).reshape(-1, self.weight.shape[0])  # flax (kh, kw, in, out) flattened
        with torch.no_grad():
            v = _l2_normalize(self.u @ w.T, self.EPS)
            u = _l2_normalize(v @ w, self.EPS)
        sigma = (v @ w @ u.T)[0, 0]
        w = w / torch.where(sigma != 0, sigma, torch.ones_like(sigma))
        if update_stats:
            with torch.no_grad():
                self.u.copy_(u)
                self.sigma.copy_(sigma)
        kh, kw = self.weight.shape[2:]
        return w.reshape(kh, kw, self.weight.shape[1], self.weight.shape[0]).permute(3, 2, 0, 1)

    def forward(self, x: torch.Tensor, update_stats: bool = False) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), self.normalized_weight(update_stats), self.bias, stride=2, padding=1)
        return y.permute(0, 2, 3, 1)


class Discriminator(nn.Module):
    """Patch discriminator for codec training (reference: src/vqgan.py:115-140),
    the counterpart of `paella_tpu/codec/vqgan.py::Discriminator`:
    spectral-normalized strided 3x3 convs, instance norm (eps 1e-5, no
    affine) after all but the first, leaky ReLU 0.2, an optional broadcast
    conditioning concat, the 1-wide `shuffle` linear and a sigmoid patch map.
    NHWC in and out, float32. Parameters and spectral-norm state load from
    the JAX package's variables with convert.discriminator_state_dict_from_jax."""

    def __init__(self, c_in: int = 3, c_cond: int = 0, c_hidden: int = 512, depth: int = 6):
        super().__init__()
        d = max(depth - 3, 3)
        chans = [c_hidden // (2**d)] + [c_hidden // (2 ** max(d - 1 - i, 0)) for i in range(depth - 1)]
        self.convs = nn.ModuleList(SpectralNormConv(a, b) for a, b in zip([c_in] + chans[:-1], chans))
        self.shuffle = nn.Linear(chans[-1] + c_cond, 1)

    def reset_parameters(self, gen: torch.Generator) -> None:
        for conv in self.convs:
            conv.reset_parameters(gen)
        init.kaiming_uniform_leaky_(self.shuffle.weight, gen)
        init.zeros_(self.shuffle.bias)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None, update_stats: bool = False) -> torch.Tensor:
        h = x.float()
        for i, conv in enumerate(self.convs):
            h = conv(h, update_stats=update_stats)
            if i > 0:  # InstanceNorm: per-sample, per-channel spatial normalization
                mean = h.mean(dim=(1, 2), keepdim=True)
                var = (h - mean).square().mean(dim=(1, 2), keepdim=True)
                h = (h - mean) * torch.rsqrt(var + 1e-5)
            h = F.leaky_relu(h, 0.2)
        if cond is not None:
            h = torch.cat([h, cond[:, None, None, :].expand(*h.shape[:3], cond.shape[-1])], dim=-1)
        return torch.sigmoid(self.shuffle(h))
