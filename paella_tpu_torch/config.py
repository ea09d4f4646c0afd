"""Configuration dataclasses, field for field the JAX package's
(`paella_tpu/config.py`), so a config built for one package reads the same in
the other.

Fields that steer TPU-only workarounds are kept so that configs stay
interchangeable, but the port reads none of them: `attn_qkvo_2d`,
`split_skip_levels`, `fused_blocks` (PaellaConfig), `lookup_impl` (VQConfig)
and `cond_cache` (SampleConfig). Where the JAX package chooses between its
XLA path and a Pallas kernel there, the port's inference `Paella.forward`
has one path: every ResBlock(+FiLM) pair goes through kernels/resblock.py
(the port always runs the JAX forward of fused_blocks=True) and every
codebook lookup through kernels/quantize.py, whose wrappers launch the CUDA
kernel on a CUDA tensor and take the plain torch version only on a CPU
tensor. The training forward (`Paella.forward_train`) is the JAX forward at
fused_blocks=False and reads `dropout`, `remat` and `remat_levels`.

Read, because their routes round differently:
- `SampleConfig.categorical_impl`: "pallas" takes the fused head
  (kernels/sampling.py::fused_head_categorical, f32 logits), "xla" the head
  product in the compute dtype and then the Gumbel kernel
  (kernels/sampling.py::gumbel_categorical), as the JAX sampler does.
- `PaellaConfig.attention_impl` and `attn_block_kernel`: "pallas" makes
  repetition 0 of each attention level take kernel K5
  (kernels/attention.py) as its attention core; `attn_block_kernel` runs the
  AttnBlock of every later repetition as kernel K6 (kernels/attn_block.py).
  Otherwise attention is plain torch, as in the JAX forward at
  fused_blocks=True (models/denoiser.py).
- `PaellaConfig.act_quant`: the ResBlocks of a model quantized by
  quant.quantize_paella_int8 run kernel K1b as W8A8 (s8 activations) instead
  of weight-only int8, where the JAX forward does (models/denoiser.py); it
  changes nothing on float weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class PaellaConfig:
    """Denoiser hyperparameters (reference: src/modules.py:110-112 defaults)."""

    c_in: int = 256
    c_out: int = 256
    num_labels: int = 8192
    c_r: int = 64
    patch_size: int = 2
    c_cond: int = 1024
    c_hidden: Tuple[int, ...] = (640, 1280, 1280)
    nhead: Tuple[int, ...] = (-1, 16, 16)
    blocks: Tuple[int, ...] = (6, 16, 6)
    level_config: Tuple[str, ...] = ("CT", "CTA", "CTA")
    clip_embd: int = 1024
    byt5_embd: int = 1536
    clip_seq_len: int = 4
    kernel_size: int = 3
    dropout: Tuple[float, ...] = (0.1, 0.1, 0.1)  # per level, read by forward_train with a dropout seed
    self_attn: bool = True
    dtype: str = "float32"  # compute dtype
    remat: bool = False  # forward_train: recompute every repetition >= 1 of a level in the backward
    remat_levels: Optional[Tuple[bool, ...]] = None  # per-level override of `remat` (None: `remat` everywhere)
    attention_impl: str = "xla"  # "xla": plain torch attention; "pallas": K5 in repetition 0
    fused_blocks: bool = False  # inert: the fused kernel is the only path
    attn_block_kernel: bool = False  # K6 for the AttnBlock of repetitions >= 1
    attn_qkvo_2d: bool = False  # inert
    split_skip_levels: Tuple[int, ...] = ()  # inert
    act_quant: bool = False  # W8A8 for int8 ResBlocks (quant.quantize_paella_int8)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def v1_byt5_xl(cls) -> "PaellaConfig":
        """Config trained by the distributed reference trainer
        (reference: src_distributed/train.py:48, byt5_embd=2560 for ByT5-XL)."""
        return cls(byt5_embd=2560)

    @classmethod
    def v1_byt5_xl_inference(cls) -> "PaellaConfig":
        """The flagship config on the inference path: bf16 compute and the
        fused ResBlock/FiLM kernel."""
        return cls(byt5_embd=2560, dtype="bfloat16", fused_blocks=True)

    @classmethod
    def tiny(cls) -> "PaellaConfig":
        """Small config for tests and dry runs."""
        return cls(
            c_in=16,
            c_out=16,
            num_labels=128,
            c_r=16,
            c_cond=32,
            c_hidden=(32, 64, 64),
            nhead=(-1, 4, 4),
            blocks=(1, 2, 1),
            byt5_embd=24,
            clip_embd=32,
            dropout=(0.0, 0.0, 0.0),
        )


@dataclasses.dataclass(frozen=True)
class VQConfig:
    """f4 codec hyperparameters (reference: src/vqgan.py:46-47)."""

    levels: int = 2
    bottleneck_blocks: int = 12
    c_hidden: int = 384
    c_latent: int = 4
    codebook_size: int = 8192
    scale_factor: float = 0.3764
    dtype: str = "float32"
    lookup_impl: str = "xla"  # inert: every lookup takes kernels/quantize.py

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @property
    def downscale(self) -> int:
        """Total spatial downsampling: PixelUnshuffle(2) x stride-2 per extra level."""
        return 2 * (2 ** (self.levels - 1))

    @classmethod
    def tiny(cls) -> "VQConfig":
        return cls(bottleneck_blocks=2, c_hidden=32, codebook_size=128)


@dataclasses.dataclass(frozen=True)
class SampleConfig:
    """Sampler schedule (reference: src_distributed/utils.py:97 signature).

    renoise_steps / sampling_conditional_steps of None mean steps-1 / steps, as in
    the reference (src_distributed/utils.py:99-102).
    """

    steps: int = 12
    renoise_steps: Optional[int] = None
    temperature: Tuple[float, float] = (0.7, 0.3)
    # scalar cfg or a (start, end) per-step schedule; None disables
    cfg: Optional[object] = (8.0, 8.0)
    t_start: float = 1.0
    t_end: float = 0.0
    sampling_conditional_steps: Optional[int] = None
    categorical_impl: str = "xla"  # "xla": head product + Gumbel kernel; "pallas": fused head
    cond_cache: bool = True  # inert: the port always builds the cond cache

    def resolved(self) -> "SampleConfig":
        cfg = self.cfg
        if isinstance(cfg, (int, float)):
            cfg = (float(cfg), float(cfg))
        temperature = self.temperature
        if isinstance(temperature, (int, float)):
            temperature = (float(temperature), float(temperature))
        return dataclasses.replace(
            self,
            cfg=cfg,
            temperature=temperature,
            renoise_steps=self.steps - 1 if self.renoise_steps is None else self.renoise_steps,
            sampling_conditional_steps=(
                self.steps
                if self.sampling_conditional_steps is None
                else self.sampling_conditional_steps
            ),
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters (reference: src_distributed/train.py:14-30),
    field for field the JAX package's."""

    updates: int = 1_500_000
    warmup_updates: int = 10_000
    batch_size: int = 2048
    grad_accum_steps: int = 1
    lr: float = 1e-4
    grad_clip: float = 1.0
    label_smoothing: float = 0.1
    loss_weight_min: float = 0.3  # reference: src_distributed/modules.py:283 min_val
    # conditioning dropout probabilities (reference: src_distributed/train.py:79-97)
    byt5_drop_prob: float = 0.05
    clip_text_drop_prob: float = 0.9
    clip_image_drop_prob: float = 0.9
    t_min: float = 0.001  # reference: src_distributed/train.py:99 clamp
    checkpoint_every: int = 2000
    seed: int = 0
    # storage dtype of BOTH Adam moments ("float32" | "bfloat16"); the moment
    # math is float32 either way (train/trainer.py::AdamW)
    adam_moment_dtype: str = "float32"
    # skip an update whose gradients are not all finite: parameters, moments
    # and the update count untouched, `nonfinite_skips` counts it
    skip_nonfinite_updates: bool = True


@dataclasses.dataclass(frozen=True)
class StageCConfig:
    """Stable Cascade's Stage C, the text-conditional prior (Würstchen v3,
    arXiv:2306.00637; StableCascade `modules/stage_c.py` defaults, which are
    `stabilityai/stable-cascade-prior`'s `prior/config.json`): continuous
    c_in-channel latents in, the noise estimate out. The port runs the
    published level layout only: block_repeat 1 and switch_level False (a
    1x1 conv between two levels of one resolution)."""

    c_in: int = 16
    c_out: int = 16
    c_r: int = 64
    patch_size: int = 1
    c_cond: int = 2048
    c_hidden: Tuple[int, ...] = (2048, 2048)
    nhead: Tuple[int, ...] = (32, 32)
    blocks: Tuple[Tuple[int, ...], ...] = ((8, 24), (24, 8))
    block_repeat: Tuple[Tuple[int, ...], ...] = ((1, 1), (1, 1))
    level_config: Tuple[str, ...] = ("CTA", "CTA")
    c_clip_text: int = 1280
    c_clip_text_pooled: int = 1280
    c_clip_img: int = 768
    c_clip_seq: int = 4
    kernel_size: int = 3
    dropout: Tuple[float, ...] = (0.1, 0.1)  # inert: inference only
    self_attn: bool = True
    t_conds: Tuple[str, ...] = ("sca", "crp")
    switch_level: Tuple[bool, ...] = (False,)
    dtype: str = "float32"  # compute dtype
    act_quant: bool = False  # W8A8 for int8 ResBlocks (quant.quantize_paella_int8)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def published(cls) -> "StageCConfig":
        """The 3.6 B prior as served: bf16 compute."""
        return cls(dtype="bfloat16")

    @classmethod
    def tiny(cls) -> "StageCConfig":
        """Small config for tests."""
        return cls(c_in=4, c_out=4, c_r=16, c_cond=32, c_hidden=(32, 32), nhead=(4, 4), blocks=((1, 2), (2, 1)),
                   c_clip_text=24, c_clip_text_pooled=24, c_clip_img=16, dropout=(0.0, 0.0))


@dataclasses.dataclass(frozen=True)
class PriorSampleConfig:
    """Stage C's sampling, as diffusers' StableCascadePriorPipeline runs it by
    default: DDPMWuerstchenScheduler (s 0.008, scaler 1) over t =
    linspace(1, 0, steps + 1)[:-1], classifier-free guidance scale `cfg`
    against the empty prompt, latents (B, ceil(H / 42.67), ceil(W / 42.67),
    c_in)."""

    steps: int = 20
    cfg: float = 4.0


@dataclasses.dataclass(frozen=True)
class StageBConfig:
    """Stable Cascade's Stage B, the large decoder (Würstchen v3,
    arXiv:2306.00637; StableCascade `modules/stage_b.py` defaults, which are
    `stabilityai/stable-cascade`'s `decoder/config.json`): Stage A's
    c_in-channel latents in, the noise estimate out, conditioned on Stage C's
    latents (`c_effnet` channels), the pooled CLIP-bigG text feature and a
    pixel map. Levels of any widths, entered by LN and a stride-2 2x2 conv and
    left by LN and a stride-2 2x2 transposed conv; `block_repeat[d][i]` runs
    a level's blocks that many times (down d = 0, up d = 1, the up row read
    deepest level first, as StableCascade reads it), a 1x1 conv between
    runs."""

    c_in: int = 4
    c_out: int = 4
    c_r: int = 64
    patch_size: int = 2
    c_cond: int = 1280
    c_hidden: Tuple[int, ...] = (320, 640, 1280, 1280)
    nhead: Tuple[int, ...] = (-1, -1, 20, 20)
    blocks: Tuple[Tuple[int, ...], ...] = ((2, 6, 28, 6), (6, 28, 6, 2))
    block_repeat: Tuple[Tuple[int, ...], ...] = ((1, 1, 1, 1), (3, 3, 2, 2))
    level_config: Tuple[str, ...] = ("CT", "CT", "CTA", "CTA")
    c_clip: int = 1280
    c_clip_seq: int = 4
    c_effnet: int = 16
    c_pixels: int = 3
    kernel_size: int = 3
    dropout: Tuple[float, ...] = (0.0, 0.0, 0.1, 0.1)  # inert: inference only
    self_attn: bool = True
    t_conds: Tuple[str, ...] = ("sca",)
    dtype: str = "float32"  # compute dtype
    act_quant: bool = False  # W8A8 for int8 ResBlocks (quant.quantize_paella_int8)

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def published(cls) -> "StageBConfig":
        """The 1.5 B decoder as served: bf16 compute."""
        return cls(dtype="bfloat16")

    @classmethod
    def tiny(cls) -> "StageBConfig":
        """Small config for tests: three levels of three widths, attention at
        the two lower ones, a repeated level on the way down and every level
        repeated on the way up."""
        return cls(c_r=16, c_cond=32, c_hidden=(16, 24, 32), nhead=(-1, 4, 4), blocks=((1, 1, 1), (1, 2, 1)),
                   block_repeat=((1, 2, 1), (3, 2, 2)), level_config=("CT", "CTA", "CTA"), c_clip=24, c_effnet=8,
                   dropout=(0.0, 0.0, 0.0))


@dataclasses.dataclass(frozen=True)
class DecoderSampleConfig:
    """Stage B's sampling, as diffusers' StableCascadeDecoderPipeline runs it
    by default: DDPMWuerstchenScheduler (s 0.008, scaler 1) over t =
    linspace(1, 0, steps + 1)[:-1] at guidance 0 (no unconditional side: one
    forward of the batch a step), latents (B, H / 4, W / 4, c_in) for images
    of H x W."""

    steps: int = 10
