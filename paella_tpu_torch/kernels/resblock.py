"""Fused ResBlock (+ optional FiLM) — the port of the Pallas kernel
`paella_tpu/kernels/resblock.py::fused_resblock_stacked`.

    x_res = x
    x  = depthwise3x3([x | skip]) + dw_b   # skip: grouped conv, channel pairs (2c, 2c+1)
    x  = layer_norm(x)                      # affine-free, eps 1e-6, f32 stats
    h  = gelu(x @ W1^T + b1)                # exact erf
    h  = h * (gamma * nx + 1)               # GRN; beta enters as beta @ W2
    y  = h @ W2^T + beta @ W2 + b2 + x_res
    y  = y * (1 + film_a) + film_b          # TimestepBlock, optional

`fused_resblock` launches the CUDA kernel (csrc/resblock.cu) on CUDA tensors
and runs `resblock_plain`, the same computation in torch ops with the same
rounding points, on CPU tensors only. Weights come in the layout the kernel
reads (`ResBlockWeights`), derived once from the module's parameters by
`prepare_resblock_weights`.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ._build import check_operands, check_rc, load_library, stream_handle


class ResBlockWeights(NamedTuple):
    """One ResBlock's weights in the kernel's layout and compute dtype."""

    dw: torch.Tensor  # (3, 3, cpg, C) depthwise kernel
    dw_b: torch.Tensor  # (C,)
    w1: torch.Tensor  # (4C, C) fc1, torch Linear layout
    b1: torch.Tensor  # (4C,)
    gamma: torch.Tensor  # (4C,) float32
    w2: torch.Tensor  # (C, 4C) fc2, torch Linear layout
    bw2: torch.Tensor  # (C,) float32 = beta @ W2, beta rounded to the dtype
    b2: torch.Tensor  # (C,)


@torch.no_grad()
def prepare_resblock_weights(
    dw_weight: torch.Tensor,  # (C, cpg, 3, 3) torch Conv2d(groups=C) weight
    dw_bias: torch.Tensor,
    fc1_weight: torch.Tensor,  # (4C, C)
    fc1_bias: torch.Tensor,
    grn_gamma: torch.Tensor,  # (4C,) or the reference's (1, 1, 1, 4C)
    grn_beta: torch.Tensor,
    fc2_weight: torch.Tensor,  # (C, 4C)
    fc2_bias: torch.Tensor,
    dtype: torch.dtype,
) -> ResBlockWeights:
    def cast(t: torch.Tensor, dt: torch.dtype = dtype) -> torch.Tensor:
        return t.detach().to(dt).contiguous()

    w2 = cast(fc2_weight)
    return ResBlockWeights(
        dw=cast(dw_weight.permute(2, 3, 1, 0)),
        dw_b=cast(dw_bias),
        w1=cast(fc1_weight),
        b1=cast(fc1_bias),
        gamma=cast(grn_gamma.reshape(-1), torch.float32),
        w2=w2,
        bw2=(w2.float() @ cast(grn_beta.reshape(-1)).float()).contiguous(),
        b2=cast(fc2_bias),
    )


def resblock_plain(
    x: torch.Tensor,
    w: ResBlockWeights,
    film: Optional[torch.Tensor] = None,
    skip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """The kernel's computation in torch ops: x (B, H, W, C), film (B, 2C)
    [a | b], skip (B, H, W, C). Depthwise, LN, GELU and GRN run in f32; xn and
    h are rounded to x's dtype where the kernel stores them; both products
    take f32 operands (exact for bf16 values) and accumulate in f32 — on a
    card, only with TF32 off."""
    resblock_plain.launches += 1
    dt = x.dtype
    b, hh, ww, c = x.shape
    m = b * hh * ww
    if skip is None:
        planes = [x]
    else:
        cc = torch.cat([x, skip.to(dt)], dim=-1)
        planes = [cc[..., 0::2], cc[..., 1::2]]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j, plane in enumerate(planes):
        xp = F.pad(plane.float(), (0, 0, 1, 1, 1, 1))
        for ky in range(3):
            for kx in range(3):
                acc = acc + xp[:, ky : ky + hh, kx : kx + ww, :] * w.dw[ky, kx, j].float()
    acc = acc + w.dw_b.float()
    mean = acc.mean(dim=-1, keepdim=True)
    var = (acc - mean).square().mean(dim=-1, keepdim=True)
    xn = ((acc - mean) * torch.rsqrt(var + 1e-6)).to(dt).reshape(m, c)

    ht = F.gelu(xn.float() @ w.w1.float().t() + w.b1.float())  # (M, 4C) f32
    gx = ht.square().reshape(b, hh * ww, 4 * c).sum(dim=1).sqrt()  # (B, 4C)
    scale = w.gamma * (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)) + 1.0
    h = (ht.to(dt).float().reshape(b, hh * ww, 4 * c) * scale[:, None, :]).to(dt)

    y = h.reshape(m, 4 * c).float() @ w.w2.float().t()
    y = y + w.bw2
    y = y + w.b2.float()
    y = (y + x.float().reshape(m, c)).reshape(b, hh * ww, c)
    if film is not None:
        f = film.to(dt).float()
        y = y * (1.0 + f[:, None, :c]) + f[:, None, c:]
    return y.to(dt).reshape(b, hh, ww, c)


resblock_plain.launches = 0


def fc2_splits(m: int, c: int, n_sm: int) -> int:
    """How many K splits the kernel's fc2 phase runs for M rows: its
    (C/64) x (M/64) grid is doubled until it holds about two blocks per SM,
    while each split keeps at least 4 of the 32-deep K tiles. The wrapper
    passes the M of one CFG pair (two images), whatever the batch, so an
    image's sums do not depend on its batchmates. At the flagship's shapes on
    132 SMs: 1 at M 2048 x C 640, 2 at 512 x 1280, 8 at 128 x 1280."""
    blocks = (c // 64) * -(-m // 64)
    k_tiles = 4 * c // 32
    s = 1
    while blocks * s < 2 * n_sm and k_tiles % (2 * s) == 0 and k_tiles // (2 * s) >= 4:
        s *= 2
    return s


def grn_slots(b: int, hw: int) -> int:
    """The most batch items one 64-row M-tile of the kernel's fc1 phase
    touches: its GRN partials buffer holds that many slots per tile, so the
    per-(batch item, column) sums are written without atomics and added in
    tile order. 1 at the flagship's shapes (hw 1024, 256, 64)."""
    m = b * hw
    return max(min(m0 + 63, m - 1) // hw - m0 // hw + 1 for m0 in range(0, m, 64))


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def fused_resblock(
    x: torch.Tensor,
    w: ResBlockWeights,
    film: Optional[torch.Tensor] = None,
    skip: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """ResBlock(+FiLM) in one call: the CUDA kernel for a CUDA tensor, the
    plain version for a CPU tensor. See the module docstring."""
    if x.device.type == "cpu":
        return resblock_plain(x, w, film=film, skip=skip)
    if x.device.type != "cuda":
        raise ValueError(f"fused_resblock: no kernel for device {x.device}")
    dt = x.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_resblock: dtype {dt} (kernel takes float32 or bfloat16)")
    b, hh, ww, c = x.shape
    cpg = 1 if skip is None else 2
    if c % 64:
        raise ValueError(f"fused_resblock: C={c} must be a multiple of 64")
    if w.dw.shape != (3, 3, cpg, c) or w.w1.shape != (4 * c, c) or w.w2.shape != (c, 4 * c):
        raise ValueError(
            f"fused_resblock: weight shapes dw {tuple(w.dw.shape)}, w1 "
            f"{tuple(w.w1.shape)}, w2 {tuple(w.w2.shape)} do not fit x {tuple(x.shape)}"
        )
    if skip is not None and (skip.shape != x.shape or skip.dtype != dt):
        raise ValueError("fused_resblock: skip must match x in shape and dtype")
    if film is not None and (film.shape != (b, 2 * c) or film.dtype != dt):
        raise ValueError(f"fused_resblock: film must be ({b}, {2 * c}) {dt}")
    for name in ("dw", "dw_b", "w1", "b1", "w2", "b2"):
        if getattr(w, name).dtype != dt:
            raise ValueError(f"fused_resblock: weight {name} is not {dt}")
    if w.gamma.dtype != torch.float32 or w.bw2.dtype != torch.float32:
        raise ValueError("fused_resblock: gamma and bw2 must be float32")
    check_operands("fused_resblock", x.device, {"x": x, "skip": skip, "film": film, **w._asdict()})

    m = b * hh * ww
    splits = fc2_splits(2 * hh * ww, c, _sm_count(x.device))
    out = torch.empty_like(x)
    xn = torch.empty((m, c), dtype=dt, device=x.device)
    h = torch.empty((m, 4 * c), dtype=dt, device=x.device)
    slots = grn_slots(b, hh * ww)
    gx_part = torch.empty((-(-m // 64) * slots, 4 * c), dtype=torch.float32, device=x.device)
    scale = torch.empty((b, 4 * c), dtype=torch.float32, device=x.device)
    part = torch.empty((splits, m, c), dtype=torch.float32, device=x.device) if splits > 1 else None

    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.paella_resblock(
        ptr(x), ptr(skip), ptr(w.dw), ptr(w.dw_b), ptr(w.w1), ptr(w.b1), ptr(w.gamma),
        ptr(w.w2), ptr(w.bw2), ptr(w.b2), ptr(film), ptr(out), ptr(xn), ptr(h), ptr(gx_part),
        ptr(scale), ptr(part), slots, splits, b, hh, ww, c, int(dt == torch.bfloat16), stream_handle(x),
    )
    check_rc(rc, "fused_resblock")
    fused_resblock.launches += 1
    return out


fused_resblock.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("resblock")
    fn = lib.paella_resblock
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
