"""Fused masked multi-head attention core (K5) — the port of the Pallas
kernel `paella_tpu/kernels/attention.py::fused_attention`.

    s = (q . k) * D^-1/2            f32 scores, the true head dim
    s = -1e9 where kv_mask is False
    p = exp(s - max) / sum(exp(s - max))     f32
    o = round(p, v.dtype) @ v       f32 accumulation, rounded to q's dtype

`fused_attention` launches the CUDA kernel (csrc/attention.cu) on CUDA
tensors and runs `attention_plain`, the same computation in torch ops with the
same rounding points, on CPU tensors only. A call with `reweight` (the
structural-editing hook) goes to `nn/attention.py::dot_product_attention`, as
the JAX kernel's does; that is decided from the arguments, before any launch.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ._build import check_operands, check_rc, load_library, stream_handle

MAX_HEAD_DIM = 128
NEG_INF = -1e9  # the mask fill of nn/attention.py and of the TPU kernel


def score_scale(d: int) -> float:
    """D^-1/2 as the f32 value both the kernel and the plain version use."""
    return float(np.float32(d**-0.5))


def attention_core(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The kernel's arithmetic in torch ops: q (B, N, H, D), k/v (B, S, H, D),
    kv_mask (B, S) bool (True = attend) -> (B, N, H, D) in q's dtype. Both
    products take f32 operands and accumulate in f32 (on a card, only with
    TF32 off). Shared by both plain versions; counts nothing."""
    s = torch.einsum("bnhd,bshd->bhns", q.float(), k.float()) * score_scale(q.shape[-1])
    if kv_mask is not None:
        s = s.masked_fill(~kv_mask[:, None, None, :], NEG_INF)
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhns,bshd->bnhd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, kv_mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """K5's plain version (see :func:`attention_core`)."""
    attention_plain.launches += 1
    return attention_core(q, k, v, kv_mask)


attention_plain.launches = 0


def check_head_dim(d: int, what: str) -> None:
    if d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"{what}: head dim {d} (the kernel takes multiples of 16 up to {MAX_HEAD_DIM})")


def _row_stride(t: torch.Tensor, name: str) -> int:
    """The row stride of (B, L, H, D) whose (H, D) rows are contiguous and
    evenly spaced (a head split of a projection's output, say)."""
    b, l, h, d = t.shape
    if t.stride(3) != 1 or t.stride(2) != d or (b > 1 and t.stride(0) != l * t.stride(1)):
        raise ValueError(f"fused_attention: {name} needs contiguous, evenly spaced (H, D) rows, strides {t.stride()}")
    if t.data_ptr() % 16 or (t.stride(1) * t.element_size()) % 16:
        raise ValueError(f"fused_attention: {name} rows must be 16-byte aligned")
    return t.stride(1)


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    reweight: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """dot_product_attention's contract, q (B, N, H, D), k/v (B, S, H, D),
    kv_mask (B, S) bool -> (B, N, H, D) contiguous: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, dot_product_attention for a
    reweight. The kernel takes q, k and v whose (H, D) rows are contiguous
    and evenly spaced, such as the k and v halves of one projection."""
    if reweight is not None:
        from ..nn.attention import dot_product_attention  # nn imports this module

        return dot_product_attention(q, k, v, kv_mask=kv_mask, reweight=reweight)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_attention: dtype {dt} (kernel takes float32 or bfloat16)")
    b, n, h, d = q.shape
    s = k.shape[1]
    if k.shape != (b, s, h, d) or v.shape != k.shape or s < 1:
        raise ValueError(f"fused_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.dtype != dt or v.dtype != dt:
        raise ValueError("fused_attention: q, k and v must share a dtype")
    if kv_mask is not None and (kv_mask.shape != (b, s) or kv_mask.dtype != torch.bool):
        raise ValueError(f"fused_attention: kv_mask must be ({b}, {s}) bool")
    check_head_dim(d, "fused_attention")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"fused_attention: {name} is on {t.device}, not {q.device}")
    check_operands("fused_attention", q.device, {"kv_mask": kv_mask})
    ldq, ldk, ldv = _row_stride(q, "q"), _row_stride(k, "k"), _row_stride(v, "v")

    out = torch.empty((b, n, h, d), dtype=dt, device=q.device)
    rc = _library().paella_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if kv_mask is None else kv_mask.data_ptr(),
        out.data_ptr(), b, n, s, h, d, ldq, ldk, ldv, score_scale(d), int(dt == torch.bfloat16),
        stream_handle(q),
    )
    check_rc(rc, "fused_attention")
    fused_attention.launches += 1
    return out


fused_attention.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("attention")
    fn = lib.paella_attention
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
