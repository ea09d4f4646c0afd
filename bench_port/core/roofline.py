"""Peaks of the card and the least time of a kernel call.

Frozen copies of `chip_smoke.py::HBM_BYTES_S`, `PEAK_OPS_S`, `bound` and
`resblock_bound`: NVIDIA's published dense peaks of one H100 SXM at 700 W. A
call's least time is the larger of its bytes over HBM bandwidth (each input
read once, each output written once) and its operations over the peak of
their type.
"""
from __future__ import annotations

HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}
BF16_PEAK = PEAK_OPS_S["bf16"]


def bound_s(nbytes: float, ops: float, kind: str) -> float:
    return max(nbytes / HBM_BYTES_S, ops / PEAK_OPS_S[kind])


def resblock_bound_s(b: int, h: int, w: int, c: int, skip: bool, film: bool, itemsize: int = 2) -> float:
    """K1 (float weights) on x (b, h, w, c): x, skip and FiLM read, the output
    written, the weights read once (depthwise (c * cpg * 9 + c), fc1 (4c * c +
    4c), GRN (8c), fc2 (c * 4c + c), the fc2 beta product (c) in f32); the
    two products' 16 b h w c^2 operations at the bf16 peak (the depthwise
    conv, LN, GELU and GRN add under 1%)."""
    m = b * h * w
    cpg = 2 if skip else 1
    act = m * c * itemsize * (2 + (1 if skip else 0)) + (b * 2 * c * itemsize if film else 0)
    weights = (c * cpg * 9 + c + 4 * c * c + 4 * c + 8 * c + 4 * c * c + c) * itemsize + c * 4
    return bound_s(act + weights, 16.0 * m * c * c, "bf16" if itemsize == 2 else "f32")


def gumbel_bound_s(rows: int, k: int, itemsize: int = 2) -> float:
    """K3 over (rows, k) logits: the logits read once, one int32 token a row
    written; memory-bound (its hash and two logs an element are not
    products)."""
    return bound_s(rows * k * itemsize + rows * 4, 0.0, "bf16")
