"""The arithmetic of the yardstick on hand-made numbers: percentiles and
spreads, interval unions and gaps, the trace reduction, the bounds and a
roofline share."""
from __future__ import annotations

import statistics
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_port.core import guard, kernels, roofline, stats, trace  # noqa: E402


@pytest.mark.parametrize("q", [0, 5, 50, 95, 100])
def test_percentile_matches_numpy(q):
    xs = list(np.random.default_rng(3).exponential(size=201))
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)), rel=1e-12)


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 12.0, 13.0, 50.0, 9.0]
    q1, med, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / med)


def test_union_and_gaps():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (8, 9)]
    assert stats.union_length(iv) == pytest.approx(5.0)
    assert stats.gaps(iv, 0, 10) == [(3, 5), (6, 8), (9, 10)]
    assert stats.union_length([]) == 0.0


def _ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_reduce_trace_hand_made():
    events = [
        _ev("kernel", "k1", 0, 10), _ev("kernel", "k1", 5, 10),  # overlap counted once
        _ev("gpu_memcpy", "copy", 20, 5), _ev("kernel", "k2", 40, 10),
        _ev("kernel", "outside", 200, 10),
        _ev("user_annotation", "request", 0, 100), _ev("user_annotation", "clip_text", 25, 10),
    ]
    r = trace.reduce_trace(events, (0.0, 100.0))
    assert r["busy_s"] == pytest.approx(30e-6)
    assert r["window_s"] == pytest.approx(100e-6)
    assert r["launches"] == 3
    assert r["kernels"]["k1"] == (pytest.approx(20e-6), 2)
    idle = dict(r["idle_gaps"])
    # gaps 15-20 and 50-100 fall in "request"; 25-40 has its middle in
    # "clip_text", the innermost range there
    assert idle["clip_text"] == pytest.approx(15e-6)
    assert idle["request"] == pytest.approx(55e-6)
    assert [n for n, _ in r["device_ops"]][0] == "k1"


def test_bounds():
    # K1 at (2, 32, 32, 640), bf16: 16 M C^2 = 13.42 GFLOP at 989 TFLOP/s
    t = roofline.resblock_bound_s(2, 32, 32, 640, skip=False, film=True)
    assert t == pytest.approx(16 * 2048 * 640**2 / 989e12)
    # K3 over (4096, 8192) bf16 logits: 67.1 MB at 3.35 TB/s
    assert roofline.gumbel_bound_s(4096, 8192) == pytest.approx((4096 * 8192 * 2 + 4096 * 4) / 3.35e12)


def test_share_from_trace():
    run = SimpleNamespace(kernel_names={"K1": {"a", "b"}}, bound_per_call={"K1": 2e-6}, slice_calls=3,
                          trace={"kernels": {"a": (5e-6, 2), "b": (7e-6, 1), "c": (100e-6, 9)}})
    assert kernels.share(run, "K1") == pytest.approx(3 * 2e-6 / 12e-6 * 100)
    run.kernel_names = {"K1": set()}
    assert kernels.share(run, "K1") is None  # nothing to read: no value, never 0


def test_guard_compares_whole_top_level_names():
    assert guard.loaded_forbidden(["paella_tpu_torch", "paella_tpu_torch.sampling", "jaxtyping", "flaxen"]) == []
    assert guard.loaded_forbidden(["paella_tpu.models", "jax", "optax._src"]) == ["jax", "optax", "paella_tpu"]
