"""Configuration dataclasses, field for field the JAX package's
(`paella_tpu/config.py`), so a config built for one package reads the same in
the other.

Fields that steer TPU-only workarounds or training are kept so that configs
stay interchangeable, but the port reads none of them: `remat`,
`remat_levels`, `attn_qkvo_2d`, `split_skip_levels`, `act_quant`,
`fused_blocks` (PaellaConfig), `lookup_impl` (VQConfig) and `cond_cache`
(SampleConfig). Where the JAX package chooses between its XLA path and a
Pallas kernel there, the port has one path: every ResBlock(+FiLM) pair goes
through kernels/resblock.py (the port always runs the JAX forward of
fused_blocks=True) and every codebook lookup through kernels/quantize.py,
whose wrappers launch the CUDA kernel on a CUDA tensor and take the plain
torch version only on a CPU tensor.

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
    dropout: Tuple[float, ...] = (0.1, 0.1, 0.1)
    self_attn: bool = True
    dtype: str = "float32"  # compute dtype
    remat: bool = False  # inert in the port (inference only)
    remat_levels: Optional[Tuple[bool, ...]] = None  # inert
    attention_impl: str = "xla"  # "xla": plain torch attention; "pallas": K5 in repetition 0
    fused_blocks: bool = False  # inert: the fused kernel is the only path
    attn_block_kernel: bool = False  # K6 for the AttnBlock of repetitions >= 1
    attn_qkvo_2d: bool = False  # inert
    split_skip_levels: Tuple[int, ...] = ()  # inert
    act_quant: bool = False  # inert until the int8 modes are ported

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
