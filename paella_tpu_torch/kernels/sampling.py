"""The sampler's two kernels — the fused sampling head (the port of the Pallas
kernel `paella_tpu/kernels/sampling.py::fused_head_categorical`) and the
Gumbel categorical over materialized logits (`::gumbel_categorical`) — and
the per-image counter hash the sampler draws all its randomness from.

tokens = argmax_k((mix(feat) @ W_out^T)_k / T + G_k), G = -log(-log(U)): the
Gumbel reparameterization of categorical(softmax(logits / T)). U comes from
the murmur3 counter hash of (image-local row * K + k) and the image's seed
pair, so each image's draw depends on its own seeds only.

`fused_head_categorical` and `gumbel_categorical` launch their CUDA kernels
(csrc/sampling.cu) on CUDA tensors and run `head_categorical_plain` /
`gumbel_categorical_plain` on CPU tensors only. The fused head keeps the
logits in f32 (like the JAX kernel); the sampler's "xla" route rounds them to
the compute dtype first, as the JAX XLA head does, and then draws with
`gumbel_categorical`. At f32 the two routes are the same.

The hash is uint32 arithmetic. torch has no uint32 shift on the CPU, so the
plain hash runs in int64 and masks to 32 bits after every multiply, xor and
add; the multiplies are split so that no int64 product overflows.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ._build import check_rc, load_library, stream_handle

_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2^32 for h in [0, 2^32) int64 and a 32-bit constant c."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def mix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding uint32 values (the JAX
    package's kernels/sampling.py::_mix and sampler._mix32)."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def hash_bits(seeds: torch.Tensor, shape: tuple) -> torch.Tensor:
    """Counter-hash bits: seeds (B, 2) uint32 values -> (B, *shape) int64 in
    [0, 2^32). Element i of every image uses the image-LOCAL index i."""
    s = seeds.to(torch.int64) & _M32
    n = int(np.prod(shape))
    idx = torch.arange(n, dtype=torch.int64, device=seeds.device).reshape((1,) + tuple(shape))
    ex = (slice(None),) + (None,) * len(shape)
    return mix32((mix32(idx ^ s[:, 0][ex]) + s[:, 1][ex]) & _M32)


def hash_uniform(seeds: torch.Tensor, shape: tuple) -> torch.Tensor:
    """(0, 1) float32 from the high 24 bits (exact in f32), offset by 2^-25
    so log(log) never sees 0."""
    bits = hash_bits(seeds, shape)
    return (bits >> 8).to(torch.float32) * (2.0**-24) + (2.0**-25)


def _f32_inv(temperature: float) -> float:
    """1 / T rounded as f32 arithmetic (as the JAX kernels form it from an f32
    scalar), so a kernel and its plain version share it."""
    return float(np.float32(1.0) / np.float32(temperature))


def _f32_scalars(cfg_weight: float, temperature: float) -> tuple[float, float, float]:
    """w, 1 - w and 1 / T rounded as f32 arithmetic (as the JAX kernel forms
    them from f32 scalars), so the kernel and the plain version share them."""
    w = np.float32(cfg_weight)
    return float(w), float(np.float32(1.0) - w), _f32_inv(temperature)


def head_categorical_plain(
    seeds: torch.Tensor,
    feat_c: torch.Tensor,
    feat_u: Optional[torch.Tensor],
    cfg_weight: float,
    w_out: torch.Tensor,
    temperature: float,
) -> torch.Tensor:
    """The kernel's computation in torch ops. seeds (n_img, 2) uint32 values
    (any integer dtype); feat_c / feat_u (B, H, W, C) (feat_u None: no CFG
    mix); w_out (K, C), the head weight in torch layout. Returns (B, H, W)
    int32. The logits are f32 (f32 operands: on a card, only with TF32 off)."""
    head_categorical_plain.launches += 1
    dt = feat_c.dtype
    w, one_minus_w, inv_temp = _f32_scalars(cfg_weight, temperature)
    orig = feat_c.shape[:-1]
    c = feat_c.shape[-1]
    k = w_out.shape[0]
    f = feat_c.reshape(-1, c).float()
    if feat_u is not None:
        f = f * w + feat_u.reshape(-1, c).float() * one_minus_w
    logits = f.to(dt).float() @ w_out.to(dt).float().t()  # (M, K) f32
    m = logits.shape[0]
    n_img = seeds.shape[0]
    u = hash_uniform(seeds.to(feat_c.device), (m // n_img, k)).reshape(m, k)
    score = logits * inv_temp + (-torch.log(-torch.log(u)))
    return torch.argmax(score, dim=-1).to(torch.int32).reshape(orig)


head_categorical_plain.launches = 0


def fused_head_categorical(
    seeds: torch.Tensor,
    feat_c: torch.Tensor,
    feat_u: Optional[torch.Tensor],
    cfg_weight: float,
    w_out: torch.Tensor,
    temperature: float,
) -> torch.Tensor:
    """tokens = categorical(softmax((mix(feat) @ w_out^T) / T)) in one call:
    the CUDA kernel for a CUDA tensor, the plain version for a CPU tensor.
    Arguments as for :func:`head_categorical_plain`; the rows of feat_c split
    evenly into seeds.shape[0] images."""
    if feat_c.device.type == "cpu":
        return head_categorical_plain(seeds, feat_c, feat_u, cfg_weight, w_out, temperature)
    if feat_c.device.type != "cuda":
        raise ValueError(f"fused_head_categorical: no kernel for device {feat_c.device}")
    dt = feat_c.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"fused_head_categorical: dtype {dt} (kernel takes float32 or bfloat16)")
    orig = feat_c.shape[:-1]
    c = feat_c.shape[-1]
    k = w_out.shape[0]
    m = feat_c.numel() // c
    n_img = seeds.shape[0]
    if w_out.shape != (k, c) or w_out.dtype != dt:
        raise ValueError(f"fused_head_categorical: w_out must be (K, {c}) {dt}")
    if c % 32 or c > 256 or k % 64:
        raise ValueError(f"fused_head_categorical: C={c} (multiple of 32, <= 256), K={k} (multiple of 64)")
    if seeds.shape != (n_img, 2) or n_img == 0 or m % n_img:
        raise ValueError(f"fused_head_categorical: seeds {tuple(seeds.shape)} do not split {m} rows")
    if feat_u is not None and (feat_u.shape != feat_c.shape or feat_u.dtype != dt):
        raise ValueError("fused_head_categorical: feat_u must match feat_c")
    seeds32 = (seeds.to(torch.int64) & _M32).to(torch.int32).to(feat_c.device).contiguous()
    operands = {"feat_c": feat_c, "feat_u": feat_u, "w_out": w_out}
    for name, t in operands.items():
        if t is None:
            continue
        if t.device != feat_c.device or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"fused_head_categorical: {name} must be a contiguous, 16-byte aligned tensor on {feat_c.device}")
    w, one_minus_w, inv_temp = _f32_scalars(cfg_weight, temperature)
    out = torch.empty(m, dtype=torch.int32, device=feat_c.device)

    lib = _library()
    rc = lib.paella_head_categorical(
        feat_c.data_ptr(), None if feat_u is None else feat_u.data_ptr(), w, one_minus_w,
        w_out.data_ptr(), seeds32.data_ptr(), inv_temp, out.data_ptr(), m, c, k, m // n_img,
        int(dt == torch.bfloat16), stream_handle(feat_c),
    )
    check_rc(rc, "fused_head_categorical")
    fused_head_categorical.launches += 1
    return out.reshape(orig)


fused_head_categorical.launches = 0


def gumbel_categorical_plain(seeds: torch.Tensor, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """The Gumbel kernel's computation in torch ops. seeds (n_img, 2) uint32
    values (any integer dtype); logits (..., K) float32 or bfloat16, whose
    rows split evenly into n_img images, each drawing with image-local
    counter indices. score = f32(logit) * f32(1/T) + (-log(-log u)); returns
    the (...) int32 argmax, the first index on ties."""
    gumbel_categorical_plain.launches += 1
    orig = logits.shape[:-1]
    k = logits.shape[-1]
    flat = logits.reshape(-1, k).float()
    m = flat.shape[0]
    n_img = seeds.shape[0]
    inv_temp = _f32_inv(temperature)
    u = hash_uniform(seeds.to(logits.device), (m // n_img, k)).reshape(m, k)
    score = flat * inv_temp + (-torch.log(-torch.log(u)))
    return torch.argmax(score, dim=-1).to(torch.int32).reshape(orig)


gumbel_categorical_plain.launches = 0


def gumbel_categorical(seeds: torch.Tensor, logits: torch.Tensor, temperature: float) -> torch.Tensor:
    """tokens ~ categorical(softmax(logits / T)) by the Gumbel argmax with the
    per-image counter hash: the CUDA kernel for a CUDA tensor, the plain
    version for a CPU tensor. Arguments as for :func:`gumbel_categorical_plain`."""
    if logits.device.type == "cpu":
        return gumbel_categorical_plain(seeds, logits, temperature)
    if logits.device.type != "cuda":
        raise ValueError(f"gumbel_categorical: no kernel for device {logits.device}")
    dt = logits.dtype
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gumbel_categorical: dtype {dt} (kernel takes float32 or bfloat16)")
    orig = logits.shape[:-1]
    k = logits.shape[-1]
    m = logits.numel() // k if k else 0
    n_img = seeds.shape[0]
    if k == 0 or k % (16 // logits.element_size()) or not logits.is_contiguous() or logits.data_ptr() % 16:
        raise ValueError(
            f"gumbel_categorical: logits must be contiguous and 16-byte aligned with K={k} "
            "a multiple of 8 (bf16) or 4 (f32)"
        )
    if seeds.shape != (n_img, 2) or n_img == 0 or m == 0 or m % n_img:
        raise ValueError(f"gumbel_categorical: seeds {tuple(seeds.shape)} do not split {m} rows")
    seeds32 = (seeds.to(torch.int64) & _M32).to(torch.int32).to(logits.device).contiguous()
    inv_temp = _f32_inv(temperature)
    out = torch.empty(m, dtype=torch.int32, device=logits.device)
    rc = _library().paella_gumbel_categorical(
        logits.data_ptr(), seeds32.data_ptr(), inv_temp, out.data_ptr(), m, k, m // n_img,
        int(dt == torch.bfloat16), stream_handle(logits),
    )
    check_rc(rc, "gumbel_categorical")
    gumbel_categorical.launches += 1
    return out.reshape(orig)


gumbel_categorical.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("sampling")
    head, gumbel = lib.paella_head_categorical, lib.paella_gumbel_categorical
    if head.restype is not ctypes.c_int or not head.argtypes:
        head.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_float,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p,
        ]
        head.restype = ctypes.c_int
        gumbel.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        gumbel.restype = ctypes.c_int
    return lib
