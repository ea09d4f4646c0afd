"""Codebook nearest-neighbour search — the port of the Pallas kernel
`paella_tpu/kernels/quantize.py::fused_codebook_lookup` — for the codec's
quantizer (codec/quantize.py) and latent interpolation
(sampling/sampler.py::interpolate_latents).

idx = argmin_k |e_k|^2 - 2 z.e_k (|z|^2 is the same for every code and
dropped), the first index on ties. `fused_codebook_lookup` launches the CUDA
kernel (csrc/quantize.cu) on CUDA tensors and runs `codebook_lookup_plain` on
CPU tensors only. Both form the norms and dots as sequential f32 sums over
the latent width, in the same order, so they agree bit for bit; the JAX
package's XLA dot may sum in another order, so against it only near-ties can
differ.
"""
from __future__ import annotations

import ctypes

import torch

from ._build import check_rc, load_library, stream_handle

MAX_C = 8  # the widest latent the kernel takes (the codec's is 4)
_ROWS = 1024  # the plain version's row chunk: bounds its (rows, K) temporaries


def codebook_lookup_plain(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """The kernel's computation in torch ops. z (..., c), codebook (K, c),
    both float32. Returns the (...) int32 nearest-code indices."""
    codebook_lookup_plain.launches += 1
    c = z.shape[-1]
    flat = z.reshape(-1, c).float()
    cb = codebook.float()
    norms = cb[:, 0] * cb[:, 0]
    for j in range(1, c):
        norms = norms + cb[:, j] * cb[:, j]
    out = []
    for rows in flat.split(_ROWS):
        dots = rows[:, None, 0] * cb[None, :, 0]
        for j in range(1, c):
            dots = dots + rows[:, None, j] * cb[None, :, j]
        out.append(torch.argmin(norms[None, :] - 2.0 * dots, dim=-1))
    idx = torch.cat(out) if out else torch.zeros(0, dtype=torch.int64, device=z.device)
    return idx.to(torch.int32).reshape(z.shape[:-1])


codebook_lookup_plain.launches = 0


def fused_codebook_lookup(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Nearest-code indices of z (..., c) in codebook (K, c): the CUDA kernel
    for a CUDA tensor, the plain version for a CPU tensor. Both float32."""
    if z.device.type == "cpu":
        return codebook_lookup_plain(z, codebook)
    if z.device.type != "cuda":
        raise ValueError(f"fused_codebook_lookup: no kernel for device {z.device}")
    c = z.shape[-1]
    k = codebook.shape[0]
    m = z.numel() // c if c else 0
    if z.dtype != torch.float32 or codebook.dtype != torch.float32:
        raise ValueError(f"fused_codebook_lookup: z {z.dtype} and codebook {codebook.dtype} must be float32")
    if codebook.shape != (k, c) or not 1 <= c <= MAX_C or k == 0 or m == 0:
        raise ValueError(
            f"fused_codebook_lookup: z {tuple(z.shape)} against codebook {tuple(codebook.shape)} "
            f"(width 1..{MAX_C}, non-empty)"
        )
    for name, t in (("z", z), ("codebook", codebook)):
        if t.device != z.device or not t.is_contiguous():
            raise ValueError(f"fused_codebook_lookup: {name} must be a contiguous tensor on {z.device}")
    scratch = torch.empty(m, dtype=torch.int64, device=z.device)
    out = torch.empty(m, dtype=torch.int32, device=z.device)
    rc = _library().paella_codebook_lookup(
        z.data_ptr(), codebook.data_ptr(), scratch.data_ptr(), out.data_ptr(), m, k, c, stream_handle(z)
    )
    check_rc(rc, "fused_codebook_lookup")
    fused_codebook_lookup.launches += 1
    return out.reshape(z.shape[:-1])


fused_codebook_lookup.launches = 0


def _library() -> ctypes.CDLL:
    lib = load_library("quantize")
    fn = lib.paella_codebook_lookup
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
    return lib
