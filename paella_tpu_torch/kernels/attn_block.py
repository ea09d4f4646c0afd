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
(3C, C), q|k|v rows; out_proj (C, C)), with no head padding.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional

import torch

from ._build import check_operands, check_rc, load_library, stream_handle
from .attention import attention_core, check_head_dim, score_scale


class AttnBlockWeights(NamedTuple):
    """One AttnBlock's attention weights in the compute dtype."""

    wqkv: torch.Tensor  # (3C, C) in_proj_weight, q|k|v rows
    bqkv: torch.Tensor  # (3C,)
    wo: torch.Tensor  # (C, C) out_proj.weight
    bo: torch.Tensor  # (C,)


@torch.no_grad()
def prepare_attn_block_weights(
    in_proj_weight: torch.Tensor,
    in_proj_bias: torch.Tensor,
    out_weight: torch.Tensor,
    out_bias: torch.Tensor,
    dtype: torch.dtype,
) -> AttnBlockWeights:
    def cast(t: torch.Tensor) -> torch.Tensor:
        return t.detach().to(dtype).contiguous()

    return AttnBlockWeights(cast(in_proj_weight), cast(in_proj_bias), cast(out_weight), cast(out_bias))


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
    if c % 64 or c % nhead:
        raise ValueError(f"fused_attn_block: C={c} must be a multiple of 64 and of nhead={nhead}")
    check_head_dim(c // nhead, "fused_attn_block")
    if kv.shape != (b, s_c, c) or kv.dtype != dt:
        raise ValueError(f"fused_attn_block: kv must be ({b}, S, {c}) {dt}, got {tuple(kv.shape)} {kv.dtype}")
    if w.wqkv.shape != (3 * c, c) or w.bqkv.shape != (3 * c,) or w.wo.shape != (c, c) or w.bo.shape != (c,):
        raise ValueError(f"fused_attn_block: weight shapes do not fit C={c}")
    for name, t in w._asdict().items():
        if t.dtype != dt:
            raise ValueError(f"fused_attn_block: weight {name} is not {dt}")
    if cond_mask is not None and (cond_mask.shape != (b, s_c) or cond_mask.dtype != torch.bool):
        raise ValueError(f"fused_attn_block: cond_mask must be ({b}, {s_c}) bool")
    check_operands("fused_attn_block", x.device, {"x": x, "kv": kv, "cond_mask": cond_mask, **w._asdict()})

    s = n + s_c
    out = torch.empty_like(x)
    xn, qb, att = (torch.empty((b * n, c), dtype=dt, device=x.device) for _ in range(3))
    rows = torch.empty((b * s, c), dtype=dt, device=x.device)
    kvb = torch.empty((b * s, 2 * c), dtype=dt, device=x.device)
    rc = _library().paella_attn_block(
        x.data_ptr(), kv.data_ptr(), None if cond_mask is None else cond_mask.data_ptr(),
        w.wqkv.data_ptr(), w.bqkv.data_ptr(), w.wo.data_ptr(), w.bo.data_ptr(), out.data_ptr(),
        xn.data_ptr(), rows.data_ptr(), qb.data_ptr(), kvb.data_ptr(), att.data_ptr(),
        b, n, s_c, c, nhead, score_scale(c // nhead), int(dt == torch.bfloat16), stream_handle(x),
    )
    check_rc(rc, "fused_attn_block")
    fused_attn_block.launches += 1
    return out


fused_attn_block.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("attn_block")
    fn = lib.paella_attn_block
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
