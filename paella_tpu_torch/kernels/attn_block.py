"""Fused attention block (K6) — the port of the Pallas kernel
`paella_tpu/kernels/attn_block.py::fused_attn_block_stacked`: one AttnBlock,

    t   = LN(x)                           eps 1e-6, f32 stats, rounded to dtype
    q   = t @ Wq^T + bq                   the pixel rows only
    k|v = [t ; kv] @ Wkv^T + bkv          pixels then cond tokens, per batch item
    a   = attention(q ; k, v)             K5's core; pixels always attend, cond
                                          tokens by cond_mask
    y   = a @ Wo^T + bo + x

each product accumulated in f32, the biases rounded to the dtype before they
are added, and t, q, k, v, a and y rounded to the dtype where the TPU kernel
stores them (attn_block.py:70-143). At bf16 they differ from the module
path's (nn/blocks.py::AttnBlock), which rounds the o-projection to the dtype
and then adds x in the dtype, rounding twice where the kernel rounds once, as
the JAX module does against the JAX kernel.

`fused_attn_block` launches the CUDA kernel (csrc/attn_block.cu) on CUDA
tensors and runs `attn_block_plain`, the same computation in torch ops, on CPU
tensors only. Weights stay in the reference's packed layout (in_proj_weight
(3C, C), q|k|v rows; out_proj (C, C)); only where C or the head dim D is not
a multiple of 8 (no shipped config) does `prepare_attn_block_weights` pad
them, each row to round8(C) columns and each head to round8(D) rows of q, k
and v (and Wo's columns to match) with zeros, so that the kernel's rows are
16-byte aligned: the products run over zero-padded K and the attention over
zero-padded heads, which add exactly nothing.

The kernel in bf16 (the flagship's path): LN; the q|k|v product over every
row ([pixels ; cond], the cond rows' q unread) on the Hopper wgmma tile of K1
(csrc/gemm_sm90.cuh, a 6-stage cp.async ring), with bias in the epilogue;
the attention phase on K5's kernel (csrc/attention.cuh) reading q, k and v
straight out of the product's output, the pixel keys as an always-attended
prefix of the cond mask; then the o-projection + bias + x on the same tile,
rounded once. `attn_block_plan` picks the products' tile widths and K splits
from one CFG pair's shapes, never from the batch, and every sum has a fixed
order: two runs are bitwise equal and an image's output does not depend on
its batchmates. f32 keeps 64x64 FMA tiles for the products. Any C that the
head count divides, any head dim. What bounds it, what was tried and what it
measured: csrc/attn_block.cu's header; PERF.md has the device time per
sub-kernel before and after this design.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ._build import check_operands, check_rc, load_library, stream_handle
from .attention import attention_core, score_scale
from .resblock import gemm_tiles, round8


class AttnBlockWeights(NamedTuple):
    """One AttnBlock's attention weights in the compute dtype, at the padded
    widths `padded_widths` gives (the true ones wherever C and D are
    multiples of 8)."""

    wqkv: torch.Tensor  # (3 H D8, Cp) in_proj_weight, q|k|v rows
    bqkv: torch.Tensor  # (3 H D8,)
    wo: torch.Tensor  # (C, H D8) out_proj.weight
    bo: torch.Tensor  # (C,)


def padded_widths(c: int, nhead: int) -> tuple[int, int]:
    """(Cp, D8): the kernel's row pitch and head pitch, C and C / nhead
    rounded up to multiples of 8."""
    return round8(c), round8(c // nhead)


@torch.no_grad()
def prepare_attn_block_weights(
    in_proj_weight: torch.Tensor,
    in_proj_bias: torch.Tensor,
    out_weight: torch.Tensor,
    out_bias: torch.Tensor,
    dtype: torch.dtype,
    nhead: int,
) -> AttnBlockWeights:
    """The weights in the dtype, zero-padded to `padded_widths` (a copy
    only where C or the head dim is not a multiple of 8)."""

    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(dtype).contiguous()

    w = AttnBlockWeights(cast(in_proj_weight), cast(in_proj_bias), cast(out_weight), cast(out_bias))
    c = w.wo.shape[0]
    cp, d8 = padded_widths(c, nhead)
    d = c // nhead
    if (cp, d8) == (c, d):
        return w
    wqkv = F.pad(w.wqkv.reshape(3, nhead, d, c), (0, cp - c, 0, d8 - d)).reshape(3 * nhead * d8, cp)
    bqkv = F.pad(w.bqkv.reshape(3, nhead, d), (0, d8 - d)).reshape(-1)
    wo = F.pad(w.wo.reshape(c, nhead, d), (0, d8 - d)).reshape(c, nhead * d8)
    return AttnBlockWeights(wqkv.contiguous(), bqkv.contiguous(), wo.contiguous(), w.bo)


def true_weights(w: AttnBlockWeights, c: int, nhead: int) -> AttnBlockWeights:
    """The weights at the true widths, their padding (if any) dropped."""
    if w.wqkv.shape == (3 * c, c):
        return w
    cp, d8 = padded_widths(c, nhead)
    d = c // nhead
    return AttnBlockWeights(
        w.wqkv.reshape(3, nhead, d8, cp)[:, :, :d, :c].reshape(3 * c, c), w.bqkv.reshape(3, nhead, d8)[:, :, :d].reshape(-1),
        w.wo.reshape(c, nhead, d8)[:, :, :d].reshape(c, c), w.bo,
    )


def attn_block_plain(
    x: torch.Tensor,
    kv: torch.Tensor,
    w: AttnBlockWeights,
    nhead: int,
    cond_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's computation in torch ops: x (B, H, W, C), kv (B, S_c, C)
    the block's kv-mapper output, cond_mask (B, S_c) bool (True = attend)."""
    attn_block_plain.launches += 1
    dt = x.dtype
    b, hh, ww, c = x.shape
    n = hh * ww
    w = true_weights(w, c, nhead)
    xf = x.float().reshape(b, n, c)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    t = ((xf - mean) * torch.rsqrt(var + 1e-6)).to(dt)
    rows = torch.cat([t, kv.to(dt)], dim=1).float()  # (B, S, C)
    s = rows.shape[1]
    wq, wkv = w.wqkv.float()[:c], w.wqkv.float()[c:]
    q = (rows[:, :n] @ wq.t() + w.bqkv[:c].float()).to(dt)
    k, v = (rows @ wkv.t() + w.bqkv[c:].float()).to(dt).split(c, dim=-1)
    mask = None
    if cond_mask is not None:
        mask = torch.cat([torch.ones((b, n), dtype=torch.bool, device=x.device), cond_mask], dim=1)
    d = c // nhead
    a = attention_core(q.reshape(b, n, nhead, d), k.reshape(b, s, nhead, d), v.reshape(b, s, nhead, d), mask)
    y = a.reshape(b, n, c).float() @ w.wo.float().t() + w.bo.float()
    y = y + xf
    return y.to(dt).reshape(b, hh, ww, c)


attn_block_plain.launches = 0


class AttnBlockPlan(NamedTuple):
    """How the bf16 kernel runs its two products (see `attn_block_plan`)."""

    bn_qkv: int  # tile width of the (B*S, 3C) q|k|v product (64 or 128)
    splits_qkv: int  # its K splits
    bn_o: int  # tile width of the o-projection
    splits_o: int  # its K splits


@functools.lru_cache(maxsize=None)
def attn_block_plan(n: int, s_c: int, c: int, nhead: int, dtype: torch.dtype, n_sm: int) -> AttnBlockPlan:
    """The bf16 kernel's tile widths and K splits for N pixel rows, S_cond
    cond rows and width C, from the row counts of one CFG pair (two images)
    and never from the batch, so an image's bits do not depend on its
    batchmates: K1's rule (`resblock.gemm_tiles`) for the (2S, 3C) q|k|v
    product and the (2N, C) o-projection, both over K = C, at the padded
    widths (`padded_widths`). At the flagship's levels on 132 SMs:
    (128, 1, 64, 1) at N 256 and (128, 1, 64, 4) at N 64. f32 takes no plan
    (its FMA tiles)."""
    if dtype != torch.bfloat16:
        return AttnBlockPlan(0, 1, 0, 1)
    cp, d8 = padded_widths(c, nhead)
    cq = nhead * d8
    return AttnBlockPlan(*gemm_tiles(2 * (n + s_c), 3 * cq, cp, n_sm), *gemm_tiles(2 * n, c, cq, n_sm))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_attn_block(
    x: torch.Tensor,
    kv: torch.Tensor,
    w: AttnBlockWeights,
    nhead: int,
    cond_mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x + o_proj(attention(LN(x) ; [LN(x) ; kv])) in one call: the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor. See the module
    docstring."""
    if x.device.type == "cpu":
        return attn_block_plain(x, kv, w, nhead, cond_mask)
    if x.device.type != "cuda":
        raise ValueError(f"fused_attn_block: no kernel for device {x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_attn_block: dtype {dt} (kernel takes float32 or bfloat16)")
    b, hh, ww, c = x.shape
    n = hh * ww
    s_c = kv.shape[1]
    if c % nhead:
        raise ValueError(f"fused_attn_block: C={c} must be a multiple of nhead={nhead}")
    if kv.shape != (b, s_c, c) or kv.dtype != dt:
        raise ValueError(f"fused_attn_block: kv must be ({b}, S, {c}) {dt}, got {tuple(kv.shape)} {kv.dtype}")
    cp, d8 = padded_widths(c, nhead)
    cq = nhead * d8
    if w.wqkv.shape != (3 * cq, cp) or w.bqkv.shape != (3 * cq,) or w.wo.shape != (c, cq) or w.bo.shape != (c,):
        raise ValueError(
            f"fused_attn_block: weight shapes do not fit C={c} with {nhead} heads "
            f"(prepare_attn_block_weights(..., nhead={nhead}) pads them)"
        )
    for name, t in w._asdict().items():
        if t.dtype != dt:
            raise ValueError(f"fused_attn_block: weight {name} is not {dt}")
    if cond_mask is not None and (cond_mask.shape != (b, s_c) or cond_mask.dtype != torch.bool):
        raise ValueError(f"fused_attn_block: cond_mask must be ({b}, {s_c}) bool")
    check_operands("fused_attn_block", x.device, {"x": x, "kv": kv, "cond_mask": cond_mask, **w._asdict()})
    out = _launch(x, kv, w, nhead, cond_mask, attn_block_plan(n, s_c, c, nhead, dt, _sm_count(x.device)))
    fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0


def _launch(x, kv, w: AttnBlockWeights, nhead: int, cond_mask, plan: AttnBlockPlan) -> torch.Tensor:
    """The kernel's launch on operands `fused_attn_block` has checked, tiled
    as `plan` says (scripts/k6_tilings.py times other plans through it)."""
    dt, dev = x.dtype, x.device
    b, hh, ww, c = x.shape
    n, s_c = hh * ww, kv.shape[1]
    s = n + s_c
    cp, d8 = padded_widths(c, nhead)
    cq = nhead * d8
    out = torch.empty_like(x)
    empty = lambda *shape, dtype=dt: torch.empty(shape, dtype=dtype, device=dev)  # noqa: E731
    rows, qkv, att = empty(b * s, cp), empty(b * s, 3 * cq), empty(b * n, cq)
    part_len = max(plan.splits_qkv * b * s * 3 * cq if plan.splits_qkv > 1 else 0,
                   plan.splits_o * b * n * c if plan.splits_o > 1 else 0)
    part = empty(part_len, dtype=torch.float32) if part_len else None
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = _library().paella_attn_block(
        ptr(x), ptr(kv), ptr(cond_mask), ptr(w.wqkv), ptr(w.bqkv), ptr(w.wo), ptr(w.bo), ptr(out),
        ptr(rows), ptr(qkv), ptr(att), ptr(part), b, n, s_c, c, nhead, score_scale(c // nhead),
        int(dt == torch.bfloat16), plan.bn_qkv, plan.splits_qkv, plan.bn_o, plan.splits_o, stream_handle(x),
    )
    check_rc(rc, "fused_attn_block")
    return out


def _library() -> ctypes.CDLL:
    lib = load_library("attn_block")
    fn = lib.paella_attn_block
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 5 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
