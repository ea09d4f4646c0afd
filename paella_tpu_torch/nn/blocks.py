"""Denoiser building blocks (NHWC), the counterparts of
`paella_tpu/nn/blocks.py`.

Parameters keep the reference torch modules' names and layouts
(src/modules.py:7-106), so a reference-layout state dict loads with
`strict=True`. Every block computes in its compute dtype; weights that a
kernel or a matmul wants in another layout are derived once
(:class:`DerivedWeights`) and never per call.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels._build import capturing
from ..kernels.attention import fused_attention
from ..kernels.attn_block import AttnBlockWeights, fused_attn_block, prepare_attn_block_weights
from ..kernels.resblock import ResBlockWeights, fused_resblock, prepare_resblock_weights
from . import init
from .attention import MultiheadAttention, dot_product_attention
from .functional import layer_norm


class DerivedWeights(nn.Module):
    """A module whose forward reads weights derived from its parameters (a
    kernel's layout, the compute dtype). They are computed on first use and
    dropped whenever parameters are loaded (`load_state_dict`) or moved
    (`.to()`, `.cuda()`); after editing parameters in place, call
    :meth:`drop_derived`.

    `DerivedWeights.generation` counts the drops of any module in the
    process: a CUDA graph that captured a forward holds the addresses of the
    derived weights (and parameters) it read, and is replayed only while the
    generation it was captured at holds (sampling/graph.py). A derived
    weight is never made inside a graph capture, where it would be filled
    only by replays: the capture's warm-up run makes them all first."""

    generation = 0

    def __init__(self):
        super().__init__()
        self._derived: dict = {}

    def _drop(self) -> None:
        self._derived.clear()
        DerivedWeights.generation += 1

    def drop_derived(self) -> None:
        """Forget the derived weights of this module and all below it."""
        for m in self.modules():
            if isinstance(m, DerivedWeights):
                m._drop()

    def derived(self, key, make: Callable):
        if key not in self._derived:
            if capturing():
                raise RuntimeError(f"{type(self).__name__}: derived weight {key!r} would be made inside a CUDA "
                                   "graph capture; run the forward once before capturing it")
            with torch.no_grad():
                self._derived[key] = make()
        return self._derived[key]

    def _apply(self, fn, recurse=True):
        self._drop()
        return super()._apply(fn, recurse)

    def _load_from_state_dict(self, *args, **kwargs):
        self._drop()
        super()._load_from_state_dict(*args, **kwargs)


class GlobalResponseNorm(nn.Module):
    """ConvNeXt-V2 GRN (reference: src/modules.py:30-40), gamma/beta stored
    as the reference's (1, 1, 1, dim). f32 statistics over H and W."""

    def __init__(self, dim: int):
        super().__init__()
        self.gamma = nn.Parameter(torch.zeros(1, 1, 1, dim))
        self.beta = nn.Parameter(torch.zeros(1, 1, 1, dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x32 = x.float()
        gx = torch.sqrt(x32.square().sum(dim=(1, 2), keepdim=True))
        nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
        return (self.gamma.float() * (x32 * nx) + self.beta.float() + x32).to(x.dtype)


def _reset_channelwise(mlp: nn.Sequential, gen: torch.Generator, out_init_scale: float) -> None:
    """The c -> 4c -> c MLP of ResBlock and FeedForwardBlock: xavier fc
    weights, zero biases and GRN, fc2 scaled by out_init_scale."""
    fc1, grn, fc2 = mlp[0], mlp[2], mlp[4]
    init.xavier_uniform_(fc1.weight, gen)
    init.zeros_(fc1.bias)
    init.zeros_(grn.gamma)
    init.zeros_(grn.beta)
    init.xavier_uniform_(fc2.weight, gen)
    fc2.weight.mul_(out_init_scale)  # reference: src/modules.py:199-202
    init.zeros_(fc2.bias)


class ResBlock(DerivedWeights):
    """Depthwise conv + channelwise MLP residual block (reference:
    src/modules.py:43-62), with the following TimestepBlock's FiLM folded in:
    one call of kernels/resblock.py::fused_resblock, which is what the JAX
    package's FusedResBlock does. With c_skip = c the UNet skip is
    channel-concatenated before the grouped depthwise conv (groups = c, so
    group g reads concat channels 2g and 2g+1). Inference only.

    `level` and `rep` place the block in the UNet (quant.quantize_paella_int8
    picks blocks by them). Once quantized, fc1 and fc2 (channelwise.0 and .4)
    are quant.Int8Linear and fused_resblock runs kernel K1b: W8A8 where the
    caller passes act_quant, else weight-only."""

    def __init__(self, c: int, c_skip: int = 0, kernel_size: int = 3, dtype=torch.float32, level: int = 0, rep: int = 0):
        super().__init__()
        if kernel_size != 3 or c_skip not in (0, c):
            raise ValueError(f"ResBlock supports kernel_size 3 and c_skip in (0, c), got {kernel_size}, {c_skip}")
        self.c, self.dtype, self.level, self.rep = c, dtype, level, rep
        self.depthwise = nn.Conv2d(c + c_skip, c, kernel_size, padding=kernel_size // 2, groups=c)
        self.channelwise = nn.Sequential(
            nn.Linear(c, c * 4),
            nn.GELU(),
            GlobalResponseNorm(c * 4),
            nn.Identity(),  # the reference's Dropout
            nn.Linear(c * 4, c),
        )

    def reset_parameters(self, gen: torch.Generator, out_init_scale: float = 1.0) -> None:
        init.xavier_uniform_(self.depthwise.weight, gen)
        init.zeros_(self.depthwise.bias)
        _reset_channelwise(self.channelwise, gen, out_init_scale)

    @property
    def quantized(self) -> bool:
        return hasattr(self.channelwise[0], "weight_scale")

    def kernel_weights(self, act_quant: bool = False) -> ResBlockWeights:
        fc1, grn, fc2 = self.channelwise[0], self.channelwise[2], self.channelwise[4]
        act_quant = act_quant and self.quantized
        return self.derived(
            ("kernel", act_quant),
            lambda: prepare_resblock_weights(
                self.depthwise.weight, self.depthwise.bias, fc1.weight, fc1.bias,
                grn.gamma, grn.beta, fc2.weight, fc2.bias, self.dtype,
                fc1_scale=getattr(fc1, "weight_scale", None), fc2_scale=getattr(fc2, "weight_scale", None),
                act_quant=act_quant,
            ),
        )

    def forward(
        self,
        x: torch.Tensor,
        film: Optional[torch.Tensor] = None,
        skip: Optional[torch.Tensor] = None,
        act_quant: bool = False,
    ) -> torch.Tensor:
        """act_quant runs a quantized block as W8A8; a float block ignores it,
        as the JAX FusedResBlock does without kernel scales."""
        dt, c = self.dtype, self.c
        if self.quantized and (c % 128 or (4 * c) % 512):
            raise ValueError(
                f"ResBlock at level {self.level} holds int8 weights, but its width {c} fails the int8 "
                "kernel's alignment (c % 128 == 0, 4c % 512 == 0; quant.fuse_eligible_levels): keep this "
                "level float"
            )
        return fused_resblock(
            x.to(dt).contiguous(),
            self.kernel_weights(act_quant),
            film=None if film is None else film.to(dt).contiguous(),
            skip=None if skip is None else skip.to(dt).contiguous(),
        )

    def _load_from_state_dict(self, state_dict, prefix, *args, **kwargs):
        from ..quant import check_int8_state

        check_int8_state(self, state_dict, prefix)
        super()._load_from_state_dict(state_dict, prefix, *args, **kwargs)


class FeedForwardBlock(nn.Module):
    """LN + channelwise MLP residual (reference: src/modules.py:82-96), the
    counterpart of the JAX FeedForwardBlock: ResBlock's MLP without the
    depthwise conv, in plain torch (JAX runs it in XLA, not in a kernel)."""

    def __init__(self, c: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.channelwise = nn.Sequential(
            nn.Linear(c, c * 4),
            nn.GELU(),
            GlobalResponseNorm(c * 4),
            nn.Identity(),  # the reference's Dropout
            nn.Linear(c * 4, c),
        )

    def reset_parameters(self, gen: torch.Generator, out_init_scale: float = 1.0) -> None:
        _reset_channelwise(self.channelwise, gen, out_init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        fc1, grn, fc2 = self.channelwise[0], self.channelwise[2], self.channelwise[4]
        h = F.gelu(F.linear(layer_norm(x).to(dt), fc1.weight.to(dt), fc1.bias.to(dt)))
        h = F.linear(grn(h), fc2.weight.to(dt), fc2.bias.to(dt))
        return x + h


class TimestepBlock(nn.Module):
    """FiLM by the noise-level embedding (reference: src/modules.py:99-106);
    zero-initialized, so the identity at init."""

    def __init__(self, c: int, c_timestep: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.mapper = nn.Linear(c_timestep, c * 2)

    def reset_parameters(self, gen: torch.Generator) -> None:
        init.zeros_(self.mapper.weight)
        init.zeros_(self.mapper.bias)

    def film(self, r_embed: torch.Tensor) -> torch.Tensor:
        """(B, 2C) [a | b], what the fused ResBlock's FiLM epilogue takes."""
        dt = self.dtype
        return F.linear(r_embed.to(dt), self.mapper.weight.to(dt), self.mapper.bias.to(dt))

    def forward(self, x: torch.Tensor, r_embed: torch.Tensor) -> torch.Tensor:
        a, b = self.film(r_embed)[:, None, None, :].chunk(2, dim=-1)
        return x * (1 + a) + b


class _Attention2D(nn.Module):
    """Holds the reference's `attention.attn` parameter path."""

    def __init__(self, c: int, nhead: int, dtype):
        super().__init__()
        self.attn = MultiheadAttention(c, nhead, dtype=dtype)


class AttnBlock(DerivedWeights):
    """Joint self+cross attention over the spatial map (reference:
    src/modules.py:65-79): LN(x) pixel tokens followed by the mapped
    conditioning tokens form the kv sequence of one attention call.

    cond_mask (B, S_cond) masks absent conditioning tokens; cond_reweight
    multiplies post-softmax attention toward conditioning tokens. `kv` takes
    the precomputed kv_mapper output (Paella.gen_cond_cache); without it the
    block maps `cond` itself.

    `kernel` is the block's route, fixed when the model is built
    (models/denoiser.py, as the JAX forward picks it at fused_blocks=True):
      None          the module path with plain torch attention
      "attention"   the module path with kernel K5 as the attention core
                    (kernels/attention.py, the JAX attention_impl="pallas")
      "attn_block"  the whole block as kernel K6 (kernels/attn_block.py, the
                    JAX attn_block_kernel=True), kv from the cond cache
    A call with cond_reweight takes the plain module path whatever the route,
    and a block without self-attention has no kernel route."""

    ROUTES = (None, "attention", "attn_block")

    def __init__(
        self, c: int, c_cond: int, nhead: int, self_attn: bool = True, dtype=torch.float32,
        kernel: Optional[str] = None,
    ):
        super().__init__()
        if kernel not in self.ROUTES:
            raise ValueError(f"AttnBlock kernel {kernel!r}: one of {self.ROUTES}")
        self.self_attn, self.dtype, self.nhead = self_attn, dtype, nhead
        self.kernel = kernel if self_attn else None
        self.kv_mapper = nn.Sequential(nn.SiLU(), nn.Linear(c_cond, c))
        self.attention = _Attention2D(c, nhead, dtype)

    def reset_parameters(self, gen: torch.Generator) -> None:
        init.xavier_uniform_(self.kv_mapper[1].weight, gen)
        init.zeros_(self.kv_mapper[1].bias)
        self.attention.attn.reset_parameters(gen)

    def map_cond(self, cond: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        lin = self.kv_mapper[1]
        return F.linear(F.silu(cond).to(dt), lin.weight.to(dt), lin.bias.to(dt))

    def kernel_weights(self) -> AttnBlockWeights:
        a = self.attention.attn
        return self.derived(
            "kernel",
            lambda: prepare_attn_block_weights(
                a.in_proj_weight, a.in_proj_bias, a.out_proj.weight, a.out_proj.bias, self.dtype, self.nhead
            ),
        )

    def forward(
        self,
        x: torch.Tensor,
        cond: Optional[torch.Tensor] = None,
        cond_mask: Optional[torch.Tensor] = None,
        cond_reweight: Optional[torch.Tensor] = None,
        kv: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        b, h, w, c = x.shape
        if kv is None:
            kv = self.map_cond(cond)
        kernel = self.kernel if cond_reweight is None else None
        if kernel == "attn_block":
            dt = self.dtype
            return fused_attn_block(
                x.to(dt).contiguous(), kv.to(dt).contiguous(), self.kernel_weights(), self.nhead, cond_mask
            )
        tokens = layer_norm(x).reshape(b, h * w, c)
        n_pix = h * w if self.self_attn else 0
        kv_full = torch.cat([tokens.to(kv.dtype), kv], dim=1) if self.self_attn else kv
        kv_mask = None
        if cond_mask is not None:
            pix = torch.ones((b, n_pix), dtype=torch.bool, device=x.device)
            kv_mask = torch.cat([pix, cond_mask], dim=1)
        reweight = None
        if cond_reweight is not None:
            cw = torch.broadcast_to(cond_reweight, (b, kv.shape[1]))
            pix_w = torch.ones((b, n_pix), dtype=cw.dtype, device=x.device)
            reweight = torch.cat([pix_w, cw], dim=-1)[:, None, None, :]
        attention_fn = fused_attention if kernel == "attention" else dot_product_attention
        out = self.attention.attn(tokens, kv_full, kv_mask=kv_mask, reweight=reweight, attention_fn=attention_fn)
        return x + out.reshape(b, h, w, c).to(x.dtype)


class Downsample(DerivedWeights):
    """LN + strided 2x2 conv between UNet levels (reference:
    src/modules.py:152-156), parameters at the reference's `1.weight`
    (`0` is the parameter-free LayerNorm2d). kernel == stride, so the conv is
    one matmul over each pixel's disjoint 2x2 patch."""

    def __init__(self, c_in: int, c_out: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.add_module("0", nn.Identity())
        self.add_module("1", nn.Conv2d(c_in, c_out, kernel_size=2, stride=2))

    @property
    def conv(self) -> nn.Conv2d:
        return self._modules["1"]

    def reset_parameters(self, gen: torch.Generator) -> None:
        init.xavier_uniform_(self.conv.weight, gen)
        init.zeros_(self.conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        w, bias = self.derived(
            "mat",
            lambda: (  # (c_out, [p, q, c_in])
                self.conv.weight.permute(0, 2, 3, 1).reshape(self.conv.out_channels, -1).to(dt),
                self.conv.bias.to(dt),
            ),
        )
        b, hh, ww, c = x.shape
        x = layer_norm(x).to(dt)
        x = x.reshape(b, hh // 2, 2, ww // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
        return F.linear(x.reshape(b, hh // 2, ww // 2, 4 * c), w, bias)


class Upsample(DerivedWeights):
    """LN + 2x2 stride-2 transposed conv (reference: src/modules.py:171-175),
    torch ConvTranspose2d semantics and default init, parameters at `1.weight`
    ((c_in, c_out, 2, 2)). kernel == stride, so no outputs overlap: one matmul
    over c_in, then the 2x2 interleave."""

    def __init__(self, c_in: int, c_out: int, dtype=torch.float32):
        super().__init__()
        self.dtype = dtype
        self.add_module("0", nn.Identity())
        self.add_module("1", nn.ConvTranspose2d(c_in, c_out, kernel_size=2, stride=2))

    @property
    def conv(self) -> nn.ConvTranspose2d:
        return self._modules["1"]

    def reset_parameters(self, gen: torch.Generator) -> None:
        c_out = self.conv.out_channels
        init.kaiming_uniform_leaky_(self.conv.weight, gen)
        init.torch_default_bias_(self.conv.bias, c_out * 2 * 2, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        c_out = self.conv.out_channels
        w = self.derived(  # ([p, q, c_out], c_in)
            "mat", lambda: self.conv.weight.permute(2, 3, 1, 0).reshape(4 * c_out, -1).to(dt)
        )
        b, hh, ww, _ = x.shape
        z = F.linear(layer_norm(x).to(dt), w).reshape(b, hh, ww, 2, 2, c_out)
        z = z.permute(0, 1, 3, 2, 4, 5).reshape(b, hh * 2, ww * 2, c_out)
        return z + self.conv.bias.to(dt)
