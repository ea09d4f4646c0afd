"""A run at test size with its timed path broken underneath sees `correct`
come out false under the cell's own limits, once for each fault the cell can
have (one card: no exchange between chips to leave out). The chip look is
skipped: the runs go through core/runner.py on the CPU."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import _tiny  # noqa: E402
from bench_port.core import runner  # noqa: E402


def _run(name: str, seed: int = 2**35 + 9):
    out, numbers = runner.run_cell(_tiny.spec(name, f32=True), seed, 0.5, False, torch.device("cpu"), time.perf_counter())
    return out, numbers


@pytest.mark.parametrize("name", ["t2i-b1-fresh", "t2i-b8-cached", "train-1b-b16"])
def test_sound_run_is_correct(name):
    out, _ = _run(name)
    assert out["correct"] and out["failed"] == 0


@pytest.mark.parametrize("name", ["t2i-b1-fresh", "t2i-b8-cached"])
def test_token_altered_where_drawn(name, monkeypatch):
    from paella_tpu_torch.sampling import sampler

    real = sampler.draw_tokens

    def altered(*args):
        tokens = real(*args)
        return (tokens + 1) % args[5].shape[0]

    monkeypatch.setattr(sampler, "draw_tokens", altered)
    out, numbers = _run(name)
    assert not out["correct"], numbers


def test_png_altered(monkeypatch):
    from paella_tpu_torch import serve

    real = serve.png_bytes
    monkeypatch.setattr(serve, "png_bytes", lambda img: real(np.clip(img.astype(np.int32) + 3, 0, 255).astype(np.uint8)))
    out, numbers = _run("t2i-b1-fresh")
    assert not out["correct"], numbers


def test_images_altered(monkeypatch):
    from paella_tpu_torch.pipeline import PaellaPipeline

    real = PaellaPipeline._decode_clipped
    monkeypatch.setattr(PaellaPipeline, "_decode_clipped", lambda self, tokens: (real(self, tokens) * 0.99))
    out, numbers = _run("t2i-b8-cached")
    assert not out["correct"], numbers


def test_state_left_unchanged(monkeypatch):
    from paella_tpu_torch.train import trainer

    monkeypatch.setattr(trainer.AdamW, "step", lambda self, closure=None: {"grad_norm": torch.tensor(1.0),
                                                                           "skipped": False})
    out, numbers = _run("train-1b-b16")
    assert not out["correct"] and numbers["update_leaf_gap"] > 0.9, numbers


def test_half_batch_left_out(monkeypatch):
    from paella_tpu_torch.train import trainer

    real = trainer.loss_fn

    def half(model, vq_model, cfg, batch, null, draws=None, generator=None, forward=None):
        n = batch.images.shape[0] // 2
        cut = trainer.Batch(*(getattr(batch, f)[:n] for f in ("images", "byt5", "byt5_mask", "clip", "clip_image")))
        d = trainer.Draws(*(v[:n] if torch.is_tensor(v) else v for v in (
            draws.drop_byt5, draws.drop_clip, draws.drop_image, draws.u, draws.noise_mask, draws.random_x,
            draws.dropout_seed)))
        return real(model, vq_model, cfg, cut, null, d, generator, forward)

    monkeypatch.setattr(trainer, "loss_fn", half)
    out, numbers = _run("train-1b-b16")
    assert not out["correct"], numbers
