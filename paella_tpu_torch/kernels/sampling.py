"""The sampler's two kernels — the fused sampling head (the port of the Pallas
kernel `paella_tpu/kernels/sampling.py::fused_head_categorical`) and the
Gumbel categorical over materialized logits (`::gumbel_categorical`) — and
the per-image counter hash the sampler draws all its randomness from.

tokens = argmax_k((mix(feat) @ W_out^T)_k / T + G_k), G = -log(-log(U)): the
Gumbel reparameterization of categorical(softmax(logits / T)). U comes from
the murmur3 counter hash of (image-local row * K + k) and the image's seed
pair, so each image's draw depends on its own seeds only.

The step scalars (the CFG weight w and the temperature T) are each a Python
float or a one-element f32 tensor: the kernels read them from device memory
(a float is rounded to f32 and staged there once), so a CUDA graph of the
sampler replays with new values, as the JAX kernels take them as on-device
scalar operands. Kernels and plain versions alike form 1 - w and 1 / T as
correctly rounded f32 operations, the arithmetic the JAX kernels do on their
f32 scalars.

`fused_head_categorical` and `gumbel_categorical` launch their CUDA kernels
(csrc/sampling.cu) on CUDA tensors, at any width (C and K >= 1) and, for the
Gumbel kernel, any alignment and row stride, and run `head_categorical_plain`
/ `gumbel_categorical_plain` on CPU tensors only. Both kernels draw with one
shared per-element routine (csrc/common.cuh::gumbel_score); `draw_noise` runs
its noise alone so that the card tests can hold it bit for bit against the
plain versions' over all 2^24 values of u. The fused head keeps the
logits in f32 (like the JAX kernel); the sampler's "xla" route rounds them to
the compute dtype first, as the JAX XLA head does, and then draws with
`gumbel_categorical`. At f32 the two routes are the same.

The hash is uint32 arithmetic. torch has no uint32 shift on the CPU, so the
plain hash runs in int64 and masks to 32 bits after every multiply, xor and
add; the multiplies are split so that no int64 product overflows.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Union

import numpy as np
import torch

from ._build import capturing, check_rc, load_library, stream_handle, stream_scratch

_M32 = 0xFFFFFFFF
Scalar = Union[float, torch.Tensor]  # a step scalar: a Python float or a one-element f32 tensor


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


def uniform_from_bits(bits: torch.Tensor) -> torch.Tensor:
    """(0, 1) float32 from hash bits (int64 holding uint32 values): the high
    24 bits, scaled by 2^-24 (exact in f32) and offset by 2^-25 so log(log)
    never sees 0; the kernels' csrc/common.cuh::uniform_from_bits."""
    return (bits >> 8).to(torch.float32) * (2.0**-24) + (2.0**-25)


def hash_uniform(seeds: torch.Tensor, shape: tuple) -> torch.Tensor:
    """(0, 1) float32 counter-hash uniforms: (B, *shape) for seeds (B, 2)."""
    return uniform_from_bits(hash_bits(seeds, shape))


def step_scalar(v: Scalar, device: torch.device) -> torch.Tensor:
    """A step scalar as one 0-d f32 value on `device`: a one-element f32
    tensor there as it is (a view: the kernels read its address); a float
    rounded to f32 as np.float32 rounds it, staged once per value on a CUDA
    device (never inside a graph capture, so no captured graph reads one)."""
    if isinstance(v, torch.Tensor):
        if v.numel() != 1 or v.dtype != torch.float32 or v.device != device:
            raise ValueError(f"a step scalar tensor holds one float32 on {device}, got {tuple(v.shape)} {v.dtype} "
                             f"on {v.device}")
        return v.reshape(())
    if device.type != "cuda":
        return torch.tensor(v, dtype=torch.float32, device=device)
    if capturing():
        raise RuntimeError("a Python float step scalar inside a CUDA graph capture: pass a device tensor")
    key = (device, float(np.float32(v)))
    staged = _STAGED.get(key)
    if staged is None:
        if len(_STAGED) >= 1024:
            _STAGED.clear()
        staged = _STAGED[key] = torch.tensor(key[1], dtype=torch.float32, device=device)
    return staged


# (device, f32 value) -> a float step scalar staged in device memory
_STAGED: dict = {}


def head_categorical_plain(
    seeds: torch.Tensor,
    feat_c: torch.Tensor,
    feat_u: Optional[torch.Tensor],
    cfg_weight: Scalar,
    w_out: torch.Tensor,
    temperature: Scalar,
) -> torch.Tensor:
    """The kernel's computation in torch ops. seeds (n_img, 2) uint32 values
    (any integer dtype); feat_c / feat_u (B, H, W, C) (feat_u None: no CFG
    mix); w_out (K, C), the head weight in torch layout; cfg_weight and
    temperature step scalars. Returns (B, H, W) int32. The logits are f32
    (f32 operands: on a card, only with TF32 off)."""
    head_categorical_plain.launches += 1
    dt = feat_c.dtype
    inv_temp = step_scalar(temperature, feat_c.device).reciprocal()
    orig = feat_c.shape[:-1]
    c = feat_c.shape[-1]
    k = w_out.shape[0]
    f = feat_c.reshape(-1, c).float()
    if feat_u is not None:
        w = step_scalar(cfg_weight, feat_c.device)
        f = f * w + feat_u.reshape(-1, c).float() * (1.0 - w)
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
    cfg_weight: Scalar,
    w_out: torch.Tensor,
    temperature: Scalar,
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
    m = feat_c.numel() // c if c else 0
    n_img = seeds.shape[0]
    if c == 0 or k == 0 or w_out.shape != (k, c) or w_out.dtype != dt:
        raise ValueError(f"fused_head_categorical: w_out {tuple(w_out.shape)} {w_out.dtype} must be (K >= 1, {c} >= 1) {dt}")
    if seeds.shape != (n_img, 2) or n_img == 0 or m == 0 or m % n_img:
        raise ValueError(f"fused_head_categorical: seeds {tuple(seeds.shape)} do not split {m} rows")
    if feat_u is not None and (feat_u.shape != feat_c.shape or feat_u.dtype != dt):
        raise ValueError("fused_head_categorical: feat_u must match feat_c")
    for name, t in {"feat_c": feat_c, "feat_u": feat_u, "w_out": w_out}.items():
        if t is not None and (t.device != feat_c.device or not t.is_contiguous()):
            raise ValueError(f"fused_head_categorical: {name} must be a contiguous tensor on {feat_c.device}")
    dev = feat_c.device
    cfg_w = None if feat_u is None else step_scalar(cfg_weight, dev)
    temp = step_scalar(temperature, dev)
    out = torch.empty(m, dtype=torch.int32, device=dev)
    seeds64 = _device_seeds(seeds, dev)
    stream = stream_handle(feat_c)
    # up to 16 blocks' partials a row and an arrival count a 128-row tile,
    # which the kernel leaves at zero
    partials, counters = stream_scratch("head_categorical", dev, stream, (16 * m, m // 128 + 1),
                                        (torch.int64, torch.int32))

    lib = _library()
    rc = lib.paella_head_categorical(
        feat_c.data_ptr(), None if feat_u is None else feat_u.data_ptr(), None if cfg_w is None else cfg_w.data_ptr(),
        w_out.data_ptr(), seeds64.data_ptr(), temp.data_ptr(), out.data_ptr(), m, c, k, m // n_img,
        int(dt == torch.bfloat16), partials.data_ptr(), counters.data_ptr(), stream,
    )
    check_rc(rc, "fused_head_categorical")
    fused_head_categorical.launches += 1
    return out.reshape(orig)


fused_head_categorical.launches = 0


def head_plan(m: int, c: int, k: int, dtype: torch.dtype) -> int:
    """The CUDA head's launch plan for M rows, width C and K labels (needs the
    card): how many blocks share one row tile's labels on the wgmma path (1
    to 16: more where the row tiles are too few to fill the card), or 0 where
    the SIMT kernel runs (f32, or bf16 past C 448). The tokens do not depend
    on it."""
    return int(_library().paella_head_plan(m, c, k, int(dtype == torch.bfloat16)))


def draw_noise(bits: torch.Tensor) -> torch.Tensor:
    """-log(-log u) for 32-bit hash values `bits` (int32 or int64 holding
    uint32 values, on the card) by the kernels' shared draw routine
    (csrc/common.cuh::gumbel_noise), for tests that hold it bit for bit
    against the plain versions' noise, -log(-log(uniform_from_bits(bits)))."""
    flat = bits.reshape(-1).to(torch.int32).contiguous()
    out = torch.empty(flat.shape, dtype=torch.float32, device=bits.device)
    check_rc(_library().paella_gumbel_noise(flat.data_ptr(), out.data_ptr(), flat.numel(), stream_handle(bits)),
             "draw_noise")
    return out.reshape(bits.shape)


def gumbel_categorical_plain(seeds: torch.Tensor, logits: torch.Tensor, temperature: Scalar) -> torch.Tensor:
    """The Gumbel kernel's computation in torch ops. seeds (n_img, 2) uint32
    values (any integer dtype); logits (..., K) float32 or bfloat16, whose
    rows split evenly into n_img images, each drawing with image-local
    counter indices; temperature a step scalar. score = f32(logit) *
    f32(1/T) + (-log(-log u)); returns the (...) int32 argmax, the first
    index on ties."""
    gumbel_categorical_plain.launches += 1
    orig = logits.shape[:-1]
    k = logits.shape[-1]
    flat = logits.reshape(-1, k).float()
    m = flat.shape[0]
    n_img = seeds.shape[0]
    inv_temp = step_scalar(temperature, logits.device).reciprocal()
    u = hash_uniform(seeds.to(logits.device), (m // n_img, k)).reshape(m, k)
    score = flat * inv_temp + (-torch.log(-torch.log(u)))
    return torch.argmax(score, dim=-1).to(torch.int32).reshape(orig)


gumbel_categorical_plain.launches = 0


def gumbel_categorical(seeds: torch.Tensor, logits: torch.Tensor, temperature: Scalar) -> torch.Tensor:
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
    if seeds.shape != (n_img, 2) or n_img == 0 or m == 0 or m % n_img:
        raise ValueError(f"gumbel_categorical: seeds {tuple(seeds.shape)} do not split {m} rows of K={k}")
    flat = logits.reshape(m, k)  # a view where the rows share one stride
    if flat.stride(1) != 1 or (m > 1 and flat.stride(0) < k):
        flat = flat.contiguous()
    temp = step_scalar(temperature, logits.device)
    out = torch.empty(m, dtype=torch.int32, device=logits.device)
    rc = _library().paella_gumbel_categorical(
        flat.data_ptr(), flat.stride(0), _device_seeds(seeds, logits.device).data_ptr(), temp.data_ptr(),
        out.data_ptr(), m, k, m // n_img, int(dt == torch.bfloat16), stream_handle(logits),
    )
    check_rc(rc, "gumbel_categorical")
    gumbel_categorical.launches += 1
    return out.reshape(orig)


gumbel_categorical.launches = 0


def _device_seeds(seeds: torch.Tensor, device: torch.device) -> torch.Tensor:
    """The (n_img, 2) seeds as the kernels read them: int64 on the device,
    contiguous (the kernels take each value's low 32 bits). The sampler's
    seeds already are, and pass without a copy or a launch."""
    if seeds.dtype != torch.int64 or seeds.device != device or not seeds.is_contiguous():
        seeds = seeds.to(device=device, dtype=torch.int64).contiguous()
    return seeds


def _library() -> ctypes.CDLL:
    lib = load_library("sampling")
    head, gumbel = lib.paella_head_categorical, lib.paella_gumbel_categorical
    if head.restype is not ctypes.c_int or not head.argtypes:
        head.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ]
        head.restype = ctypes.c_int
        gumbel.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        gumbel.restype = ctypes.c_int
        lib.paella_head_plan.argtypes = [ctypes.c_int] * 4
        lib.paella_head_plan.restype = ctypes.c_int
        lib.paella_gumbel_noise.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        lib.paella_gumbel_noise.restype = ctypes.c_int
    return lib
