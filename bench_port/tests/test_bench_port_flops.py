"""The model FLOPs behind mfu.*: the meta-tensor counts and their fits
against FlopCounterMode run on real tensors at test size."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import _tiny  # noqa: E402
from bench_port.core import cell, runner  # noqa: E402
from bench_port.reference import denoiser, flops, text  # noqa: E402
from bench_port.reference.nn import Params  # noqa: E402


def _count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.fixture(scope="module")
def serve():
    spec = _tiny.spec("t2i-b1-fresh", f32=True)
    builder = cell.builder_module(spec)
    built = builder.build(spec["config"], 3, torch.device("cpu"), runner.CACHE)
    sd = builder.reference_weights(spec["config"], built["layouts"], 3, torch.device("cpu"))
    sizes = {p: spec["config"]["parts"][p]["sizes"] for p in sd}
    return spec, built, sd, sizes


def test_serve_flops_fits(serve):
    spec, built, sd, sizes = serve
    fl = flops.ServeFlops(sizes, built["layouts"], spec["config"]["sample"])
    ids = torch.zeros(1, 23, dtype=torch.long)
    assert fl.t5(23) == pytest.approx(_count(lambda: text.t5_encode(Params(sd["byt5"]), sizes["byt5"], ids)), rel=1e-9)
    dz = sizes["denoiser"]
    ce, mask = torch.zeros(1, 31, dz["c_cond"]), torch.ones(1, 31, dtype=torch.bool)
    x, r = torch.zeros(1, fl.h, fl.w, dtype=torch.long), torch.full((1,), 0.5)
    direct = _count(lambda: denoiser.features(Params(sd["denoiser"]), dz, x, r, ce, mask))
    assert fl.denoiser(31) == pytest.approx(direct, rel=1e-9)
    steps = spec["config"]["sample"]["steps"]
    want = fl.t5(5) + fl.clip + fl.mapper + steps * (fl.denoiser(5 + 4) + fl.denoiser(1 + 4) + fl.head) + fl.decode
    assert fl.generation(["abcd"]) == pytest.approx(want)
    assert fl.head == 2 * fl.h * fl.w * dz["c_out"] * dz["num_labels"]


def test_train_flops_count_backward_once():
    spec = _tiny.spec("train-1b-b16", f32=True)
    builder = cell.builder_module(spec)
    built = builder.build(spec["config"], 3, torch.device("cpu"), runner.CACHE)
    sizes = {p: spec["config"]["parts"][p]["sizes"] for p in spec["config"]["parts"]}
    mix = dict(spec["traffic"], byt5_embd=sizes["denoiser"]["byt5_embd"], clip_embd=sizes["denoiser"]["clip_embd"])
    fl = flops.TrainFlops(sizes, built["layouts"], mix, (16, 16))
    meta = torch.device("meta")
    P = Params({n: torch.empty(s, device=meta) for n, s, _ in built["layouts"]["denoiser"]})
    dz, b = sizes["denoiser"], mix["images"]
    x = torch.zeros(b, 16, 16, dtype=torch.long, device=meta)
    ce, cm = torch.zeros(b, 16, dz["c_cond"], device=meta), torch.ones(b, 16, dtype=torch.bool, device=meta)
    fwd = _count(lambda: denoiser.head(P, denoiser.features(P, dz, x, torch.zeros(b, device=meta), ce, cm)))
    # the backward of products costs twice their forward: a step is about 3x a forward, never 4x (no remat)
    assert 2.5 * fwd < fl.denoiser < 3.5 * fwd
    assert fl.encode > 0
