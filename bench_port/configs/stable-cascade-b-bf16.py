"""Stable Cascade's decoder as `paella_tpu_torch.serve.build_decoder_pipeline`
assembles it, with the benchmark's seeded weights in place of checkpoint
files: Stage B in bf16, Stage A (the f4 codec) in f32, the CLIP-bigG text
tower with its products in bf16 as stable-cascade-c-bf16 builds it (graph
counters tagged `clip_g`, the synthetic merges, EOT padding), and a
CascadeDecoderPipeline over them.
"""
from __future__ import annotations

from pathlib import Path

import torch

from bench_port.core import cell, weights
from bench_port.core.build import dataclass_from, empty

PARTS = ("decoder", "codec", "clip_g")
PRIOR = cell.load_module(cell.BENCH / "configs" / "stable-cascade-c-bf16.py")


def synthetic_merges() -> list:
    return PRIOR.synthetic_merges()


def build(config: dict, seed: int, device: torch.device, cache_dir: Path) -> dict:
    from paella_tpu_torch import CascadeDecoderPipeline, StageBConfig, VQConfig
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.cond.clip import CLIPTextConfig, CLIPTextEncoder
    from paella_tpu_torch.cond.tokenizers import CLIPTokenizer, write_merges_file
    from paella_tpu_torch.models import StageB

    parts = config["parts"]
    b_cfg = dataclass_from(StageBConfig, {k: PRIOR._tuples(v) for k, v in parts["decoder"]["sizes"].items()})
    t_cfg = dataclass_from(CLIPTextConfig, parts["clip_g"]["sizes"])
    model = empty(lambda: StageB(b_cfg), device).to(getattr(torch, parts["decoder"]["dtype"])).eval()
    vq = empty(lambda: VQModel(dataclass_from(VQConfig, parts["codec"]["sizes"])), device)
    vq = vq.to(getattr(torch, parts["codec"]["dtype"])).eval()
    for m in vq.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
    clip = empty(lambda: CLIPTextEncoder(t_cfg, graph_tag="clip_g"), device).cast_products().eval()
    modules = {"decoder": model, "codec": vq, "clip_g": clip}
    layouts = {p: weights.fill_module(modules[p], parts[p].get("init"), seed, p) for p in PARTS}
    model.drop_derived()

    merges = synthetic_merges()
    cache_dir.mkdir(parents=True, exist_ok=True)
    merges_path = cache_dir / "clip_merges.txt"
    if not merges_path.exists():
        write_merges_file(merges, str(merges_path))
    tokenizer = CLIPTokenizer(str(merges_path))
    pipe = CascadeDecoderPipeline(model, vq, clip, tokenizer.with_mask)
    return {"pipeline": pipe, "modules": modules, "layouts": layouts, "merges": merges}


def reference_weights(config: dict, layouts: dict, seed: int, device) -> dict:
    """{part: state dict} of the values `build` gave, drawn again."""
    return {p: weights.regenerate(layouts[p], config["parts"][p].get("init"), seed, p, device) for p in PARTS}
