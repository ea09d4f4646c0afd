"""The training step's two routes on the CPU (train/trainer.py): which route
a step takes, the draws the graph's route makes before its replay, and the
dropout masks every route reads from nn/blocks.py::DropoutMasks. The graph
itself runs only on a card (tests/test_torch_cuda_paths.py). The module
imports neither jax nor the JAX package.
"""
from __future__ import annotations

import dataclasses
import types

import pytest
import torch

from paella_tpu_torch import PaellaConfig, TrainConfig, VQConfig
from paella_tpu_torch.codec import VQModel
from paella_tpu_torch.models import Paella
from paella_tpu_torch.nn.blocks import DropoutMasks
from paella_tpu_torch.sampling import graph
from paella_tpu_torch.train import Batch, Draws, NullCond, create_train_state, make_train_step
from paella_tpu_torch.train import trainer
from paella_tpu_torch.utils import tracing

CFG = dataclasses.replace(PaellaConfig.tiny(), dropout=(0.1, 0.1, 0.1))
SEEDS = (11, 2**61 + 5)  # two dropout seeds, one past 32 bits


def tiny_models(remat: bool):
    model, vq = Paella(dataclasses.replace(CFG, remat=remat)), VQModel(VQConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(0))
    with torch.no_grad():  # the clf and the FiLM mappers are zero at init
        g = torch.Generator().manual_seed(1)
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=g) * 0.05)
    vq.reset_parameters(torch.Generator().manual_seed(2))
    return model, vq


def inputs(seed: int = 3):
    g = torch.Generator().manual_seed(seed)
    batch = Batch(torch.rand(2, 64, 64, 3, generator=g), torch.randn(2, 6, CFG.byt5_embd, generator=g),
                  torch.arange(6)[None, :] < torch.tensor([[6], [3]]), torch.randn(2, CFG.clip_embd, generator=g),
                  torch.randn(2, CFG.clip_embd, generator=g))
    null = NullCond(torch.randn(1, 2, CFG.byt5_embd, generator=g), torch.ones(1, 2, dtype=torch.bool),
                    torch.randn(1, CFG.clip_embd, generator=g))
    return batch, null


def forward(model, masks: DropoutMasks):
    batch, _ = inputs()
    x = torch.randint(0, CFG.num_labels, (2, 16, 16), generator=torch.Generator().manual_seed(4))
    return model.forward_train(x, torch.tensor([0.3, 0.8]), batch.byt5, batch.clip, batch.clip_image,
                               byt5_mask=batch.byt5_mask, dropout_masks=masks)


@pytest.mark.parametrize("remat", [False, True])
def test_masks_drawn_up_front_equal_the_in_block_draw(remat):
    """For two dropout seeds: every mask a training forward draws in its
    blocks (at first use) is dropout's draw from a fresh generator seeded by
    (seed, pass, block), and `redraw` of a table holding another seed's
    masks, the draw made before a replay, writes the same masks in place,
    bit for bit; the forward that reads the redrawn table gives the same
    logits."""
    model, _ = tiny_models(remat)
    in_block = {}
    for seed in SEEDS:
        masks = DropoutMasks(seed)
        logits = forward(model, masks)
        assert masks.masks, "no dropout block drew a mask"
        for key, (rate, m) in masks.masks.items():
            gen = torch.Generator().manual_seed((seed * 1_000_003 + key[0] * 4096 + key[1]) % 2**63)
            assert rate == 0.1 and torch.equal(m, torch.rand(m.shape, generator=gen) < 1.0 - rate), key
        in_block[seed] = masks, logits
    up_front, logits = in_block[SEEDS[0]]
    buffers = {k: m for k, (_, m) in up_front.masks.items()}
    up_front.redraw(SEEDS[1])
    want = in_block[SEEDS[1]][0].masks
    assert up_front.masks.keys() == want.keys()
    for k, (_, m) in up_front.masks.items():
        assert m is buffers[k] and torch.equal(m, want[k][1]), k
    assert torch.equal(forward(model, up_front), in_block[SEEDS[1]][1])
    assert not torch.equal(logits, in_block[SEEDS[1]][1]), "dropout inert"


@pytest.mark.parametrize("remat", [False, True])
def test_draws_made_up_front_give_the_step_bit_for_bit(remat):
    """Three steps with every draw left to the step's generator against
    three whose draws the graph's route makes before its replay
    (draw_missing over the latents' shape from the codec's downscale, then
    the dropout seed), from a generator seeded alike: the same draws, and
    loss, acc, grad_norm, every gradient and every parameter after each
    update bit for bit."""
    runs = []
    batch, null = inputs()
    for up_front in (False, True):
        model, vq = tiny_models(remat)
        cfg = TrainConfig(warmup_updates=1, lr=2e-3)
        state, step = create_train_state(model, cfg, torch.Generator().manual_seed(9)), make_train_step(model, vq, cfg)
        steps = []
        for _ in range(3):
            d = Draws()
            if up_front:
                f = vq.config.downscale
                trainer.draw_missing(cfg, d, (2, 64 // f, 64 // f), CFG.num_labels, state.generator, "cpu")
                d.dropout_seed = trainer._draw_dropout_seed(state.generator, "cpu")
            out = step(state, batch, null, [d])
            steps.append((d, {k: float(v) for k, v in out.items()}, [p.grad.clone() for p in model.parameters()],
                          [p.detach().clone() for p in model.parameters()]))
        runs.append(steps)
    for i, (eager, drawn) in enumerate(zip(*runs)):
        for k in trainer.DRAW_TENSORS:
            assert torch.equal(getattr(eager[0], k), getattr(drawn[0], k)), (i, k)
        assert eager[0].dropout_seed == drawn[0].dropout_seed
        assert eager[1] == drawn[1], (i, eager[1], drawn[1])
        for a, b in zip(eager[2] + eager[3], drawn[2] + drawn[3]):
            assert torch.equal(a, b), i


ROUTES = {
    "the card, alone": (True, dict(), True),
    "the CPU": (False, dict(), False),
    "a DDP wrapper": (True, dict(ddp=object()), False),
    "a mesh": (True, dict(mesh=object()), False),
    "two microbatches": (True, dict(microbatches=2), False),
}


@pytest.mark.parametrize("case", list(ROUTES))
def test_the_route_is_chosen_from_what_the_step_sees(case, monkeypatch):
    """The graph only for a batch on a card with no DDP wrapper, no mesh and
    one microbatch (a stand-in batch says where it lies; no capture is
    under way); eager on the CPU, under ddp, under a mesh and at
    grad_accum_steps 2."""
    on_card, kwargs, want = ROUTES[case]
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    images = types.SimpleNamespace(is_cuda=on_card)
    assert trainer.graph_route(images, **kwargs) is want


def test_a_cpu_step_takes_the_eager_route(monkeypatch):
    """A CPU step, at grad_accum_steps 1 and 2, never reaches the graph
    family: no train_graph counter, no graph kept, every microbatch's spans
    recorded."""
    def refuse(*args, **kwargs):
        raise AssertionError("a CPU step reached sampling/graph.py::train")

    monkeypatch.setattr(graph, "train", refuse)
    batch, null = inputs()
    tracing.reset()
    tracing.enable()
    try:
        for n in (1, 2):
            model, vq = tiny_models(remat=True)
            cfg = TrainConfig(warmup_updates=1, grad_accum_steps=n)
            make_train_step(model, vq, cfg)(create_train_state(model, cfg), batch, null)
        snap = tracing.snapshot()
    finally:
        tracing.disable()
    assert not any(k.startswith("train_graph.") for k in snap["counters"]) and not graph._TRAIN_GRAPHS
    assert sum(s.name == "train.forward" for s in snap["spans"]) == 3
