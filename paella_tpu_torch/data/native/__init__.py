"""Native (C++) data-path kernels, the counterpart of
`paella_tpu/data/native/__init__.py`: JPEG decode (libjpeg) and bilinear
resize, built once with g++ at first use and loaded as a CPython extension,
with PIL as the fallback where the build or libjpeg is missing.

`paella_native.cpp` is a byte-for-byte copy of the JAX package's source. The
extension is built into the checkout's `build/paella_tpu_torch/` (beside the
CUDA libraries of kernels/_build.py), named by a hash of its source and
flags, never beside the source.
"""
from __future__ import annotations

import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading

from ...kernels._build import BUILD_DIR

_lock = threading.Lock()
_native = None
_tried = False

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "paella_native.cpp")
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")


def library_path() -> str:
    """Where the extension is built: a hash of the source and flags names it."""
    h = hashlib.sha1(" ".join(_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    suffix = sysconfig.get_config_var("EXT_SUFFIX") or ".so"
    return os.path.join(BUILD_DIR, f"paella_native-{h.hexdigest()[:12]}{suffix}")


def _build(out: str) -> bool:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    include = sysconfig.get_paths()["include"]
    cmd = ["g++", *_FLAGS, f"-I{include}", _SRC, "-ljpeg", "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        sys.stderr.write(f"[paella_native] build failed:\n{proc.stderr[:2000]}\n")
        return False
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return True


def get_native():
    """The compiled extension module, or None if unavailable."""
    global _native, _tried
    with _lock:
        if _tried:
            return _native
        _tried = True
        out = library_path()
        try:
            if not os.path.exists(out) and not _build(out):
                return None
            spec = importlib.util.spec_from_file_location("paella_native", out)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            _native = mod
        except (ImportError, OSError) as e:  # toolchain or ABI trouble: fall back to PIL
            sys.stderr.write(f"[paella_native] load failed: {e}\n")
            _native = None
        return _native


def jpeg_decoder() -> str:
    """Which decoder `data.decode_image` uses for a JPEG here: "native",
    "PIL" (the fallback) or "none" (no decoder: JPEG samples are skipped)."""
    if get_native() is not None:
        return "native"
    try:
        import PIL  # noqa: F401
    except ImportError:
        return "none"
    return "PIL"


def decode_jpeg(data: bytes):
    """JPEG bytes -> float32 RGB HWC in [0,1] via the native decoder, or None."""
    import numpy as np

    mod = get_native()
    if mod is None:
        return None
    try:
        h, w, rgb = mod.decode_jpeg_rgb(data)
    except ValueError:
        return None
    arr = np.frombuffer(rgb, np.uint8).reshape(h, w, 3)
    return arr.astype(np.float32) / 255.0


def resize_bilinear(img_u8, out_h: int, out_w: int):
    """uint8 HWC RGB -> resized uint8 HWC via the native kernel, or None."""
    import numpy as np

    mod = get_native()
    if mod is None:
        return None
    h, w = img_u8.shape[:2]
    out = mod.resize_bilinear_u8(np.ascontiguousarray(img_u8).tobytes(), h, w, out_h, out_w)
    return np.frombuffer(out, np.uint8).reshape(out_h, out_w, 3)
