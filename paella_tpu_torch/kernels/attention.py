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
The kernel takes any head dim: up to 128 a warp keeps its outputs in
registers, wider heads split their output columns among blocks, and a head
dim that is not a multiple of 8 is padded with zeros (see `fused_attention`).

The keys and values may come from two sources, `k`, `v` then `k2`, `v2`
(Stage C's pixel keys out of its q|k|v product and its conditioning's out of
the per-block cache): the kernel reads each where it lies, the plain version
concatenates them. The kernel picks its design from the shapes
(`attention_design`): the latency-bound ring (Paella's shapes, every f32
call, K6) or, for bf16 heads of 64, the compute-bound wgmma variant: with K
and V resident in shared memory up to 768 keys ("wgmma", Stage C's), with K
resident and V streamed through a ring of slots up to 1536 keys
("streamed", Stage B's level 2). All keep the rounding points above, and the
wgmma variant's two forms give the same bits.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ._build import check_operands, check_rc, load_library, stream_handle

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
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    k2: Optional[torch.Tensor] = None,
    v2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """K5's plain version (see :func:`attention_core`); keys and values
    [k | k2] and [v | v2] where a second source is given."""
    attention_plain.launches += 1
    if k2 is not None:
        k, v = torch.cat([k, k2], dim=1), torch.cat([v, v2], dim=1)
    return attention_core(q, k, v, kv_mask)


attention_plain.launches = 0


def _row_stride(t: torch.Tensor, name: str) -> int:
    """The row stride of (B, L, H, D) whose (H, D) rows are contiguous and
    evenly spaced (a head split of a projection's output, say)."""
    b, l, h, d = t.shape
    if t.stride(3) != 1 or t.stride(2) != d or (b > 1 and t.stride(0) != l * t.stride(1)):
        raise ValueError(f"fused_attention: {name} needs contiguous, evenly spaced (H, D) rows, strides {t.stride()}")
    if t.data_ptr() % 16 or (t.stride(1) * t.element_size()) % 16:
        raise ValueError(f"fused_attention: {name} rows must be 16-byte aligned")
    return t.stride(1)


def _check_second_source(q: torch.Tensor, k: torch.Tensor, k2, v2) -> None:
    if (k2 is None) != (v2 is None):
        raise ValueError("fused_attention: k2 and v2 come together")
    if k2 is None:
        return
    b, _, h, d = q.shape
    s2 = k2.shape[1]
    if k2.dim() != 4 or k2.shape != (b, s2, h, d) or v2.shape != k2.shape or s2 < 1:
        raise ValueError(f"fused_attention: q {tuple(q.shape)}, k2 {tuple(k2.shape)}, v2 {tuple(v2.shape)}")
    if k2.dtype != k.dtype or v2.dtype != k.dtype:
        raise ValueError("fused_attention: k2 and v2 must share k's dtype")
    for name, t in (("k2", k2), ("v2", v2)):
        if t.device != q.device:
            raise ValueError(f"fused_attention: {name} is on {t.device}, not {q.device}")


def fused_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_mask: Optional[torch.Tensor] = None,
    reweight: Optional[torch.Tensor] = None,
    k2: Optional[torch.Tensor] = None,
    v2: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """dot_product_attention's contract, q (B, N, H, D), k/v (B, S, H, D),
    kv_mask (B, S) bool -> (B, N, H, D) contiguous: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors, dot_product_attention for a
    reweight. k2/v2 (B, S2, H, D), both or neither, are keys and values
    [S, S + S2) (kv_mask then covers S + S2 keys). The kernel takes q, k, v,
    k2 and v2 whose (H, D) rows are contiguous and evenly spaced, such as the
    k and v halves of one projection, at any head dim. Its rows are copied 16
    bytes at a time, so where D % 8 != 0 (no shipped config has such a head)
    this wrapper copies them into heads zero-padded to the next multiple of 8
    once a call, runs the kernel on them with the true head dim's scale (the
    zero columns add nothing to the scores, and their outputs are zero), and
    crops the output."""
    _check_second_source(q, k, k2, v2)
    if reweight is not None:
        from ..nn.attention import dot_product_attention  # nn imports this module

        if k2 is not None:
            k, v = torch.cat([k, k2], dim=1), torch.cat([v, v2], dim=1)
        return dot_product_attention(q, k, v, kv_mask=kv_mask, reweight=reweight)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_mask, k2, v2)
    return _launch(q, k, v, kv_mask, k2, v2, -1)


fused_attention.launches = 0
fused_attention.streamed_launches = 0  # the launches on the wgmma variant's streamed form

STREAMED = 256  # the C interface's code of the streamed form, plus its query tiles a block (csrc/attention.cuh::wgv)


def design_code(name: str, qtiles: int = 0) -> int:
    """The C interface's code of a design as `attention_design` names it:
    "ring", or the wgmma variant's form "wgmma" or "streamed" with `qtiles`
    query tiles a block."""
    return {"ring": 0, "wgmma": qtiles, "streamed": STREAMED + qtiles}[name]


def _launch(q, k, v, kv_mask, k2, v2, design: int) -> torch.Tensor:
    """The kernel on CUDA tensors; design -1 as `attention_design` picks,
    else a `design_code` (a measurement's or a test's choice)."""
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: no kernel for device {q.device}")
    dt = q.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_attention: dtype {dt} (kernel takes float32 or bfloat16)")
    b, n, h, d = q.shape
    s1 = k.shape[1]
    if k.shape != (b, s1, h, d) or v.shape != k.shape or s1 < 1:
        raise ValueError(f"fused_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    if k.dtype != dt or v.dtype != dt:
        raise ValueError("fused_attention: q, k and v must share a dtype")
    s = s1 + (0 if k2 is None else k2.shape[1])
    if kv_mask is not None and (kv_mask.shape != (b, s) or kv_mask.dtype != torch.bool):
        raise ValueError(f"fused_attention: kv_mask must be ({b}, {s}) bool")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"fused_attention: {name} is on {t.device}, not {q.device}")
    check_operands("fused_attention", q.device, {"kv_mask": kv_mask})
    d8 = -(-d // 8) * 8
    if d8 != d:  # heads zero-padded to whole 16-byte rows, once a call
        q, k, v = (F.pad(t, (0, d8 - d)) for t in (q, k, v))
        if k2 is not None:
            k2, v2 = F.pad(k2, (0, d8 - d)), F.pad(v2, (0, d8 - d))
    ldq, ldk, ldv = _row_stride(q, "q"), _row_stride(k, "k"), _row_stride(v, "v")
    ldk2 = ldv2 = 0
    if k2 is not None:
        ldk2, ldv2 = _row_stride(k2, "k2"), _row_stride(v2, "v2")

    lib = _library()
    if design < 0:
        design = lib.paella_attention_design(b, n, s, h, d8, int(dt == torch.bfloat16))
    out = torch.empty((b, n, h, d8), dtype=dt, device=q.device)
    rc = lib.paella_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if k2 is None else k2.data_ptr(),
        None if v2 is None else v2.data_ptr(), None if kv_mask is None else kv_mask.data_ptr(), out.data_ptr(),
        b, n, s, s1, h, d8, ldq, ldk, ldv, ldk2, ldv2, score_scale(d), int(dt == torch.bfloat16), design,
        stream_handle(q),
    )
    check_rc(rc, "fused_attention")
    fused_attention.launches += 1
    fused_attention.streamed_launches += design >= STREAMED
    return out if d8 == d else out[..., :d].contiguous()


def attention_design(b: int, n: int, s: int, h: int, d: int, dtype: torch.dtype) -> tuple[str, int]:
    """The design the kernel's policy takes for B x H heads of N queries over
    S keys at head dim d (padded to a multiple of 8, as the wrapper pads it):
    ("ring", 0), or the wgmma variant's form ("wgmma": K and V resident;
    "streamed": K resident, V streamed) and its query tiles a block;
    csrc/attention.cuh::attention_design. Builds the library."""
    d8 = -(-d // 8) * 8
    code = _library().paella_attention_design(b, n, s, h, d8, int(dtype == torch.bfloat16))
    if code >= STREAMED:
        return ("streamed", code - STREAMED)
    return ("wgmma", code) if code > 0 else ("ring", 0)


def _library() -> ctypes.CDLL:
    lib = load_library("attention")
    fn = lib.paella_attention
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_float] + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.paella_attention_design.argtypes = [ctypes.c_int] * 6
        lib.paella_attention_design.restype = ctypes.c_int
    return lib
