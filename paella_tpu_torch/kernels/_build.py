"""Build and load the port's CUDA kernels (csrc/*.cu).

Each kernel source is compiled with nvcc into a shared library with a plain
C interface and loaded with ctypes. Nothing is built when a module is
imported: the first call on a CUDA tensor builds, into the checkout's
`build/paella_tpu_torch/`, a library named by a hash of its sources and flags,
so an unchanged library is reused and a changed one is rebuilt.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "paella_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    nvcc = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if nvcc is None or not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from csrc/ with "
            "the CUDA toolkit (set CUDA_HOME)"
        )
    return nvcc


def library_path(name: str) -> Path:
    """Where the library for csrc/{name}.cu is built (hash of sources + flags)."""
    h = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for src in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """Compile csrc/{name}.cu unless an up-to-date library exists; the
    compiler's register/spill report goes beside it as a .log file."""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stdout}\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build(name)))


def stream_handle(t) -> int:
    """The current CUDA stream of t's device, as the C interface takes it."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_operands(what: str, device, tensors: dict) -> None:
    """Raise unless every tensor given (None skips) lies on `device`, is
    contiguous and starts 16-byte aligned, as the kernels' vector loads need."""
    for name, t in tensors.items():
        if t is None:
            continue
        if t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{what}: {name} must be 16-byte aligned")


def check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")
