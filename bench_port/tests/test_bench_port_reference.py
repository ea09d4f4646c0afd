"""The reference against the port at test size on the CPU: every part alone,
then whole cells, where a float32 program must read (all but) nought."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import _tiny  # noqa: E402
from bench_port.core import cell, runner, weights  # noqa: E402
from bench_port.reference import codec, denoiser, text  # noqa: E402
from bench_port.reference.nn import Params  # noqa: E402

CPU = torch.device("cpu")


def _built(name="t2i-b1-fresh", seed=5):
    spec = _tiny.spec(name, f32=True)
    builder = cell.builder_module(spec)
    built = builder.build(spec["config"], seed, CPU, runner.CACHE)
    sd = builder.reference_weights(spec["config"], built["layouts"], seed, CPU)
    sizes = {p: spec["config"]["parts"][p]["sizes"] for p in sd}
    return spec, builder, built, sd, sizes


def test_weights_regenerate_bit_for_bit():
    spec, builder, built, sd, _ = _built()
    for part, module in built["modules"].items():
        for name, p in module.named_parameters():
            assert torch.equal(p.detach(), sd[part][name]), (part, name)
    assert weights.scale_of("x.ln_1.weight", (8,), [])[0] == 1.0


@torch.no_grad()
def test_parts_against_the_port():
    spec, builder, built, sd, sizes = _built()
    pipe = built["pipeline"]
    ids = torch.tensor([text.byt5_ids("a red fox at dawn")])
    want = pipe.byt5_encode_fn(ids, torch.ones_like(ids, dtype=torch.bool))
    torch.testing.assert_close(text.t5_encode(Params(sd["byt5"]), sizes["byt5"], ids), want, rtol=1e-5, atol=1e-5)
    tok = text.ClipBPE(builder.synthetic_merges())
    torch.testing.assert_close(text.clip_text(Params(sd["clip_text"]), sizes["clip_text"], tok(["a red fox", ""])),
                               pipe.clip_text_fn(["a red fox", ""]), rtol=1e-5, atol=1e-5)
    idx = torch.randint(0, 128, (1, 16, 16), generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(codec.decode_indices(Params(sd["codec"]), sizes["codec"], idx),
                               pipe.vq.decode_indices(idx), rtol=1e-5, atol=1e-5)
    cond = pipe.conditioning(["a red fox"])
    x = torch.randint(0, 128, (1, 16, 16), generator=torch.Generator().manual_seed(2))
    r = torch.tensor([0.6])
    want = pipe.model(x, r, cond.byt5, cond.clip, byt5_mask=cond.byt5_mask, return_features=True)
    ce, cm = denoiser.cond_embedding(Params(sd["denoiser"]), sizes["denoiser"], cond.byt5, cond.byt5_mask, cond.clip)
    got = denoiser.features(Params(sd["denoiser"]), sizes["denoiser"], x, r, ce, cm)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["t2i-b1-fresh", "t2i-b8-cached"])
def test_f32_serving_cell_reads_nought(name):
    out, numbers = runner.run_cell(_tiny.spec(name, f32=True), 2**40 + 17, 0.5, False, CPU, time.perf_counter())
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert numbers["logit_gap"] <= 1e-4 and numbers["renoise_mismatch"] == 0
    assert numbers["image_max_gap"] <= 1e-5 and numbers["draws_checked"] > 0


def test_f32_training_cell_reads_nought(monkeypatch):
    spec = _tiny.spec("train-1b-b16", f32=True)
    # microbatches of one image draw their rows of the batch's dropout masks
    monkeypatch.setattr(cell.entry_module(spec), "MICRO", 1)
    out, numbers = runner.run_cell(spec, 2**40 + 19, 0.5, False, CPU, time.perf_counter())
    assert out["failed"] == 0
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_leaf_gap"] < 1e-4 and numbers["update_leaf_gap"] < 1e-3
