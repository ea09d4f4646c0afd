"""Int8 inference (weight-only and W8A8) and its quality proxies, the
counterpart of `paella_tpu/quant.py` on torch modules.

Per-output-channel symmetric int8 on the denoiser's channelwise fc1/fc2
(the ResBlocks' dominant weight traffic) and on the ByT5 encoder's block
linears. A quantized linear is an :class:`Int8Linear`: its `weight` holds the
int8 codes in torch layout (out, in) and its `weight_scale` buffer the f32
scale of each output channel, so a quantized model's state dict carries
`<name>.weight` (int8) and `<name>.weight_scale` (f32) and round-trips through
`load_state_dict(strict=True)`.

The denoiser runs quantized ResBlocks through kernel K1b
(kernels/resblock.py::fused_resblock): weight-only by default, W8A8
(s8 x s8 products with per-row dynamic activation scales) under
`PaellaConfig.act_quant`. The ByT5 encoder (cond/t5.py) dequantizes its codes
before a float product, or runs `w8a8_dot` under `T5Config.act_quant`. Both
flags stay off by default, as in the JAX package.

Random streams: the proxies and `inject_weight_outliers` draw from explicit
torch.Generators. They cannot reproduce jax.random's bits; they keep its
structure (what is drawn, over which axes).
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

# the documented gate thresholds (docs/quantization.md): a proxy PASS means
# "enable act_quant once a real-checkpoint FID confirms"; it never flips the
# default alone
W8A8_PROXY_MAX_KL = 0.05  # nats/token
W8A8_PROXY_MAX_FLIP = 0.05


def quantize_dense_int8(weight: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, in) torch-layout weight -> (int8 codes (out, in), f32 scales
    (out,)): scale = max(amax over `in`, 1e-8) / 127, codes round(w / scale),
    half to even. Bit for bit the JAX package's codes and scales for the same
    f32 values (its kernels are (in, out), so its amax runs over axis -2)."""
    w = weight.detach().float()
    scale = w.abs().amax(dim=-1).clamp_min(1e-8) / 127.0
    q = torch.round(w / scale[..., None])
    return q.to(torch.int8), scale


def dequantize_dense_int8(q: torch.Tensor, scale: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    return (q.float() * scale[..., None]).to(dtype)


def w8a8_dot(x: torch.Tensor, weight_q: torch.Tensor, weight_scale: torch.Tensor, dtype) -> torch.Tensor:
    """x @ dequant(W)^T as a true W8A8 product: x quantized per row
    (x_scale = max(amax, 1e-8) * (1/127), codes round(x / x_scale) with no
    clip), s8 x s8 -> s32 (`torch._int_mm`), then f32(acc) * x_scale *
    weight_scale cast to `dtype`. weight_q (out, in) int8. The JAX package
    leaves this product to an XLA dot; on a card `torch._int_mm` (cuBLASLt)
    takes more than 16 rows, so fewer are padded with zero rows, and `in`,
    `out` multiples of 8 (it raises otherwise)."""
    x32 = x.float()
    x_scale = x32.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) * (1.0 / 127.0)
    xq = torch.round(x32 / x_scale).to(torch.int8).reshape(-1, x.shape[-1])
    rows = xq.shape[0]
    if xq.is_cuda and rows <= 16:
        xq = F.pad(xq, (0, 0, 0, 17 - rows))
    acc = torch._int_mm(xq, weight_q.t())[:rows].reshape(*x.shape[:-1], -1)
    return (acc.float() * x_scale * weight_scale).to(dtype)


class Int8Linear(nn.Module):
    """A linear layer holding int8 codes: `weight` (out, in) int8 (a
    parameter with requires_grad=False), `weight_scale` (out,) f32 buffer,
    optional float `bias`. Its forward is the weight-only product
    x @ dequant(W)^T + b in x's dtype (the ByT5 layers' int8 mode; the
    ResBlock never calls it, K1b reads the codes). A dtype cast of the model (`.to(torch.bfloat16)`) leaves the
    codes int8, as torch casts only float parameters, and leaves the scales
    in f32: they belong to the codes, and rounding them would change every
    dequantized weight."""

    def __init__(self, weight: torch.Tensor, weight_scale: torch.Tensor, bias: Optional[torch.Tensor] = None):
        super().__init__()
        if weight.dtype != torch.int8 or weight_scale.shape != weight.shape[:1]:
            raise ValueError(f"Int8Linear: int8 (out, in) codes and (out,) scales, got {weight.dtype} {tuple(weight.shape)}")
        self.weight = nn.Parameter(weight.contiguous(), requires_grad=False)
        self.bias = None if bias is None else nn.Parameter(bias.detach().clone(), requires_grad=False)
        self.register_buffer("weight_scale", weight_scale.float().contiguous())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = dequantize_dense_int8(self.weight, self.weight_scale, x.dtype)
        return F.linear(x, w, None if self.bias is None else self.bias.to(x.dtype))

    def _apply(self, fn, recurse=True):
        scale = self.weight_scale
        super()._apply(fn, recurse)
        self.weight_scale = scale.to(self.weight_scale.device)  # the device from fn, never its dtype
        return self


def check_int8_state(module: nn.Module, state_dict, prefix: str) -> None:
    """Raise where `state_dict` would put int8 codes into a float parameter
    of `module` (copy_ would turn the codes into floats without a word: the
    JAX package's hazard at models/denoiser.py:458-474), or floats into an
    int8 one. Called from the loaders of the modules that can hold codes."""
    for name, p in module.named_parameters(prefix=prefix.rstrip(".")):
        v = state_dict.get(name)
        if isinstance(v, torch.Tensor) and (v.dtype == torch.int8) != (p.dtype == torch.int8):
            raise ValueError(
                f"{name}: state dict holds {v.dtype}, the module {p.dtype}: int8 codes load only into a model "
                "quantized the same way (quant.quantize_paella_int8 / quantize_t5_int8)"
            )


def _to_int8(linear: nn.Module) -> Int8Linear:
    q, s = quantize_dense_int8(linear.weight)
    return Int8Linear(q, s, linear.bias).to(linear.weight.device)


def quantize_paella_int8(model: nn.Module, levels: Sequence[int] = (1, 2), include_first: bool = False) -> nn.Module:
    """A NEW denoiser whose ResBlocks at the given UNet levels hold int8
    fc1/fc2 (channelwise.0 and .4 as :class:`Int8Linear`): repetitions >= 1,
    and with include_first also repetition 0 (skip-concat blocks included),
    as the JAX function picks `{down,up}_{i}_rest` and `{down,up}_{i}_0_*_C`.
    The float model is left as it was. A level whose width fails the int8
    kernel's alignment refuses to run (ResBlock.forward), as in JAX."""
    from .nn.blocks import ResBlock

    out = copy.deepcopy(model)
    levels = set(levels)
    for blk in out.modules():
        if isinstance(blk, ResBlock) and blk.level in levels and (blk.rep > 0 or include_first):
            cw = blk.channelwise
            if not isinstance(cw[0], Int8Linear):
                cw[0], cw[4] = _to_int8(cw[0]), _to_int8(cw[4])
    out.drop_derived()
    return out


def quantize_t5_int8(model: nn.Module) -> nn.Module:
    """A NEW ByT5 encoder (cond/t5.py::T5Encoder) whose block linears (q, k,
    v, o, wi_0, wi_1, wo) hold per-output-channel int8 codes. Embedding,
    norms and the relative-attention bias stay float."""
    out = copy.deepcopy(model)
    for block in out.encoder.block:
        for holder, names in ((block.layer[0].SelfAttention, ("q", "k", "v", "o")),
                              (block.layer[1].DenseReluDense, ("wi_0", "wi_1", "wo"))):
            for n in names:
                lin = getattr(holder, n)
                if not isinstance(lin, Int8Linear):
                    setattr(holder, n, _to_int8(lin))
    return out


def fuse_eligible_levels(config) -> Tuple[int, ...]:
    """UNet levels whose widths satisfy the int8 kernel's alignment (the JAX
    fused kernel's tiles: c % 128 == 0, 4c % 512 == 0), the levels W8A8 can
    quantize. At the flagship: all three."""
    return tuple(i for i, c in enumerate(config.c_hidden) if c % 128 == 0 and (4 * c) % 512 == 0)


def _drift(ref: torch.Tensor, got: torch.Tensor) -> dict:
    """kl (mean KL(softmax ref || softmax got), nats/token), flip (argmax
    disagreement rate) and rel (mean |diff| / mean |ref|) of two logit maps."""
    ref, got = ref.float(), got.float()
    lp_ref, lp_got = F.log_softmax(ref, dim=-1), F.log_softmax(got, dim=-1)
    kl = (lp_ref.exp() * (lp_ref - lp_got)).sum(dim=-1).mean()
    flip = (ref.argmax(-1) != got.argmax(-1)).float().mean()
    rel = (got - ref).abs().mean() / (ref.abs().mean() + 1e-9)
    return {"kl": float(kl), "flip": float(flip), "rel": float(rel)}


def _with_act_quant(model: nn.Module) -> nn.Module:
    model.config = dataclasses.replace(model.config, act_quant=True)
    return model


@torch.no_grad()
def w8a8_quality_proxy(
    model: nn.Module,
    generator: torch.Generator,
    t_values: Sequence[float] = (0.9, 0.7, 0.5, 0.3, 0.1),
    batch: int = 2,
    latent_hw: Tuple[int, int] = (16, 16),
    byt5_len: int = 5,
    levels: Optional[Sequence[int]] = None,
) -> list:
    """The W8A8 go/no-go proxy without real weights: per noise level t, the
    float denoiser `model` against its W8A8 copy (quantize_paella_int8 with
    include_first over `levels`, fuse_eligible_levels by default, and
    act_quant) on the same inputs, as {"t", "kl", "flip", "rel"} rows
    (`_drift`). The documented gate (w8a8_proxy_verdict): worst kl <= 0.05
    nats/token and worst flip <= 5%, pending a real-checkpoint FID.
    Inputs come from `generator` and move to the model's device."""
    cfg = model.config
    dev = next(model.parameters()).device
    levels = fuse_eligible_levels(cfg) if levels is None else levels
    qmodel = _with_act_quant(quantize_paella_int8(model, levels=levels, include_first=True))
    h, w = latent_hw
    x = torch.randint(0, cfg.num_labels, (batch, h, w), generator=generator, device=generator.device).to(dev)
    byt5 = torch.randn(batch, byt5_len, cfg.byt5_embd, generator=generator, device=generator.device)
    clip = torch.randn(batch, cfg.clip_embd, generator=generator, device=generator.device)
    byt5, clip = (v.to(dev, cfg.compute_dtype) for v in (byt5, clip))
    rows = []
    for t in t_values:
        r = torch.full((batch,), float(t), device=dev)
        rows.append({"t": float(t), **_drift(model(x, r, byt5, clip), qmodel(x, r, byt5, clip))})
    return rows


@torch.no_grad()
def t5_w8a8_quality_proxy(
    t5: nn.Module,
    model: nn.Module,
    generator: torch.Generator,
    t_values: Sequence[float] = (0.9, 0.5, 0.1),
    batch: int = 2,
    latent_hw: Tuple[int, int] = (16, 16),
    byt5_len: int = 5,
) -> list:
    """The ByT5 act_quant proxy: the same token ids through the float
    encoder `t5` and its W8A8 copy (quantize_t5_int8 with act_quant), both
    states into the same float denoiser, and the logits' drift per noise
    level t as {"t", "kl", "flip", "rel"} rows for w8a8_proxy_verdict.
    Requires model.config.byt5_embd == t5.config.d_model."""
    cfg, t5_cfg = model.config, t5.config
    if cfg.byt5_embd != t5_cfg.d_model:
        raise ValueError(f"byt5_embd {cfg.byt5_embd} != t5 d_model {t5_cfg.d_model}")
    dev = next(model.parameters()).device
    enc_q = _with_act_quant(quantize_t5_int8(t5))
    h, w = latent_hw
    g_dev = generator.device
    x = torch.randint(0, cfg.num_labels, (batch, h, w), generator=generator, device=g_dev).to(dev)
    ids = torch.randint(0, t5_cfg.vocab_size, (batch, byt5_len), generator=generator, device=g_dev).to(dev)
    mask = torch.ones(batch, byt5_len, dtype=torch.bool, device=dev)
    clip = torch.randn(batch, cfg.clip_embd, generator=generator, device=g_dev).to(dev, cfg.compute_dtype)
    byt5_f, byt5_q = t5(ids, mask).to(cfg.compute_dtype), enc_q(ids, mask).to(cfg.compute_dtype)
    rows = []
    for t in t_values:
        r = torch.full((batch,), float(t), device=dev)
        rows.append({"t": float(t), **_drift(model(x, r, byt5_f, clip), model(x, r, byt5_q, clip))})
    return rows


def _reduction_axis(module: nn.Module, name: str) -> Optional[int]:
    """The input-feature axis of a float dense or conv kernel in torch
    layout (the JAX kernels' axis -2), None for anything else (biases,
    norms, embeddings, GRN, int8 codes)."""
    if name == "weight" and isinstance(module, nn.ConvTranspose2d):
        return 0  # (in, out, kh, kw)
    if name == "weight" and isinstance(module, (nn.Linear, nn.Conv2d)):
        return 1  # (out, in[, kh, kw])
    if name == "in_proj_weight":
        return 1  # packed q|k|v (3c, c)
    return None


@torch.no_grad()
def inject_weight_outliers(model: nn.Module, generator: torch.Generator, frac: float = 0.02, scale: float = 12.0) -> nn.Module:
    """Outlier-channel stress for the quality proxies: a NEW model in which a
    random `frac` of each float dense/conv kernel's reduction-axis (input)
    channels is scaled by `scale`, one Bernoulli draw per channel from
    `generator`, kernels in sorted name order. Norms, biases, embeddings and
    int8 codes are left as they were. Both arms of a proxy then see the same
    heavy-tailed weights."""
    out = copy.deepcopy(model)
    params = {}
    for mname, mod in out.named_modules():
        for pname, p in mod.named_parameters(recurse=False):
            axis = _reduction_axis(mod, pname)
            if axis is not None and p.dim() >= 2 and p.is_floating_point():
                params[f"{mname}.{pname}"] = (p, axis)
    for _, (p, axis) in sorted(params.items()):
        m = torch.rand(p.shape[axis], generator=generator, device=generator.device) < frac
        s = torch.where(m, scale, 1.0).to(p.device, p.dtype)
        p.mul_(s.reshape([-1 if a == axis else 1 for a in range(p.dim())]))
    if hasattr(out, "drop_derived"):
        out.drop_derived()
    return out


def w8a8_proxy_verdict(rows) -> Tuple[bool, str]:
    """Apply the documented thresholds to w8a8_quality_proxy rows."""
    worst_kl = max(r["kl"] for r in rows)
    worst_flip = max(r["flip"] for r in rows)
    ok = worst_kl <= W8A8_PROXY_MAX_KL and worst_flip <= W8A8_PROXY_MAX_FLIP
    msg = (
        f"worst KL {worst_kl:.4f} nats/token (gate {W8A8_PROXY_MAX_KL}), "
        f"worst argmax flip {worst_flip:.3%} (gate {W8A8_PROXY_MAX_FLIP:.0%}) -> "
        + (
            "PASS: W8A8 is a default-on candidate pending real-checkpoint FID"
            if ok
            else "FAIL: keep act_quant off"
        )
    )
    return ok, msg
