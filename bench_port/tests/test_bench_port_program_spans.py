"""The readers of the program's own spans (core/program.py and the metrics
that use it) on hand-made trace events and spans; each reader with no
recorder in the program (an older checkout); and traced runs at test size on
the CPU, whose lines carry the program_span metrics."""
from __future__ import annotations

import sys
import time
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
sys.path.insert(0, str(Path(__file__).parent))

import _tiny  # noqa: E402
from bench_port.core import cell, program, runner  # noqa: E402

NEW = {"png_ms.b1": "t2i-b1-fresh", "byt5_device_ms.b1": "t2i-b1-fresh", "clip_text_device_ms.b1": "t2i-b1-fresh",
       "forward_launches.train": "train-1b-b16", "backward_launches.train": "train-1b-b16",
       "optimizer_launches.train": "train-1b-b16", "host_blocked_ms.train": "train-1b-b16"}


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def serve_events():
    """Two requests; ByT5 launches kernels 1-3 (2 and 3 overlap on the
    device), CLIP kernel 4, the sampler's graph launch kernels 5 and 6."""
    return [
        _x("user_annotation", "serve.request", 0, 100), _x("user_annotation", "serve.request", 200, 100),
        _x("user_annotation", "cond.byt5", 10, 20), _x("user_annotation", "cond.byt5", 210, 20),
        _x("user_annotation", "cond.clip_text", 40, 10),
        _x("cuda_runtime", "cudaLaunchKernel", 12, 1, corr=1), _x("kernel", "t5_a", 15, 4, corr=1),
        _x("cuda_runtime", "cudaLaunchKernel", 212, 1, corr=2), _x("kernel", "t5_b", 220, 10, corr=2),
        _x("cuda_driver", "cuLaunchKernel", 229, 1, corr=3), _x("kernel", "t5_c", 225, 10, corr=3),
        _x("cuda_runtime", "cudaLaunchKernel", 45, 1, corr=4), _x("gpu_memcpy", "copy", 50, 6, corr=4),
        _x("cuda_runtime", "cudaGraphLaunch", 60, 1, corr=5), _x("kernel", "k1", 61, 30, corr=5),
        _x("kernel", "k3", 91, 5, corr=5),
        _x("cuda_runtime", "cudaLaunchKernel", 31, 1, corr=6), _x("kernel", "late", 35, 3, corr=6),  # after the range
        _x("kernel", "unmatched", 12, 3, corr=99),
    ]


def train_events():
    """One step: the forward launches 2 kernels, the backward 3 (two from
    autograd's own thread, inside the main thread's range by time), AdamW 1."""
    ev = [_x("user_annotation", "train.step", 0, 1000), _x("user_annotation", "train.forward", 10, 100),
          _x("user_annotation", "train.backward", 200, 300), _x("user_annotation", "train.optimizer", 600, 100),
          _x("user_annotation", "train.sync", 650, 40)]
    launches = [(20, 1), (30, 2), (210, 3), (300, 4), (400, 5), (660, 6), (800, 7)]
    for ts, corr in launches:
        ev += [_x("cuda_runtime", "cudaLaunchKernel", ts, 1, corr=corr), _x("kernel", f"k{corr}", ts + 5, 2, corr=corr)]
    return ev


def test_launched_in_matches_by_correlation_and_graph_launches():
    ev = serve_events()
    assert sorted(e["name"] for e in program.launched_in(ev, "cond.byt5")) == ["t5_a", "t5_b", "t5_c"]
    assert [e["name"] for e in program.launched_in(ev, "cond.clip_text")] == ["copy"]
    assert [e["name"] for e in program.launched_in(ev, "cond.clip_text", cats=("kernel",))] == []
    assert [e["name"] for e in program.launched_in(ev + [_x("user_annotation", "sample", 55, 10)], "sample")] == [
        "k1", "k3"]
    assert program.launched_in(ev, "no.such.range") == []


def test_device_and_launch_readers_on_hand_made_events():
    run = SimpleNamespace(program={"spans": []}, host_events=serve_events())
    # ByT5: 4 µs, then 220-235 (the union of 220-230 and 225-235): 19 µs over 2 requests
    assert cell.metric_reader("byt5_device_ms.b1")(run, {}) == pytest.approx(19e-3 / 2)
    assert cell.metric_reader("clip_text_device_ms.b1")(run, {}) == pytest.approx(6e-3 / 2)
    run = SimpleNamespace(program={"spans": []}, host_events=train_events())
    assert cell.metric_reader("forward_launches.train")(run, {}) == 2
    assert cell.metric_reader("backward_launches.train")(run, {}) == 3
    assert cell.metric_reader("optimizer_launches.train")(run, {}) == 1
    run.host_events = [e for e in run.host_events if e["name"] != "train.step"]
    assert cell.metric_reader("forward_launches.train")(run, {}) is None  # no step to divide by


def test_span_readers_on_hand_made_spans():
    S = lambda name, a, b: SimpleNamespace(name=name, start_ns=a, end_ns=b)  # noqa: E731
    spans = [S("serve.request", 0, 10**8), S("serve.png", 10, 2_000_010), S("serve.request", 0, 10**8),
             S("serve.png", 0, 1_000_000), S("serve.png", 5, 0)]  # an open span is left out
    run = SimpleNamespace(program={"spans": spans}, host_events=[])
    assert cell.metric_reader("png_ms.b1")(run, {}) == pytest.approx(1.5)
    spans = [S("train.step", 0, 10**9), S("train.sync", 0, 3_000_000), S("train.sync", 0, 1_000_000)]
    run = SimpleNamespace(program={"spans": spans}, host_events=[])
    assert cell.metric_reader("host_blocked_ms.train")(run, {}) == pytest.approx(4.0)
    run.program = None  # the slice found nothing
    assert cell.metric_reader("host_blocked_ms.train")(run, {}) is None


@pytest.mark.parametrize("name", sorted(NEW))
def test_readers_give_none_without_the_recorder(name, monkeypatch):
    import paella_tpu_torch.utils as utils

    monkeypatch.delattr(utils, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "paella_tpu_torch.utils.tracing", None)  # an import of it raises ImportError
    assert program.recorder() is None
    run = SimpleNamespace(spec=_tiny.spec(NEW[name]), spans=None, device=torch.device("cpu"), trace=None)
    assert cell.metric_reader(name)(run, {}) is None


def test_traced_runs_carry_the_program_span_metrics():
    """Whole traced runs at test size on the CPU (no device events there, so
    the device_trace readers find nothing)."""
    for name, want in (("t2i-b1-fresh", "png_ms.b1"), ("train-1b-b16", "host_blocked_ms.train")):
        out, _ = runner.run_cell(_tiny.spec(name, f32=True), 2**40 + 23, 0.3, True, torch.device("cpu"),
                                 time.perf_counter())
        assert out["correct"] and out["metrics"][want]["value"] > 0, (name, out["metrics"])
        assert not {m for m in NEW if m not in ("png_ms.b1", "host_blocked_ms.train")} & set(out["metrics"])
