"""The production training step on one card:
`paella_tpu_torch/scripts/run_driver_e2e.py::make_geometry("1b")` (the
denoiser in f32 parameters with bf16 compute, remat, dropout 0.1) with the
frozen f32 `VQConfig()` codec, under `TrainConfig()`, through
`train.make_train_step`, with the benchmark's seeded weights.
"""
from __future__ import annotations

from pathlib import Path

import torch

from bench_port.core import weights
from bench_port.core.build import dataclass_from, empty

PARTS = ("denoiser", "codec")


def build(config: dict, seed: int, device: torch.device, cache_dir: Path) -> dict:
    from paella_tpu_torch import PaellaConfig, TrainConfig, VQConfig
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.train import create_train_state, make_train_step

    parts = config["parts"]
    p_cfg = dataclass_from(PaellaConfig, parts["denoiser"]["sizes"])
    vq_cfg = dataclass_from(VQConfig, parts["codec"]["sizes"])
    model = empty(lambda: Paella(p_cfg), device).to(getattr(torch, parts["denoiser"]["dtype"]))
    vq = empty(lambda: VQModel(vq_cfg), device).to(getattr(torch, parts["codec"]["dtype"])).eval()
    for m in vq.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
    layouts = {"denoiser": weights.fill_module(model, parts["denoiser"].get("init"), seed, "denoiser"),
               "codec": weights.fill_module(vq, parts["codec"].get("init"), seed, "codec")}
    model.drop_derived()
    cfg = dataclass_from(TrainConfig, config["train"])
    state = create_train_state(model, cfg)
    return {"model": model, "vq": vq, "state": state, "step": make_train_step(model, vq, cfg), "layouts": layouts,
            "train_config": cfg}


def reference_weights(config: dict, layouts: dict, seed: int, device) -> dict:
    return {p: weights.regenerate(layouts[p], config["parts"][p].get("init"), seed, p, device) for p in PARTS}

