"""Stable Cascade's prior as `paella_tpu_torch.serve.build_prior_pipeline`
assembles it, with the benchmark's seeded weights in place of checkpoint
files: Stage C in bf16, the CLIP-bigG text tower with its products in bf16
(`cond/clip.py::_Tower.cast_products`, graph counters tagged `clip_g`), its
tokenizer padding with the EOT id, and a CascadePriorPipeline over them.
"""
from __future__ import annotations

from pathlib import Path

import torch

from bench_port.core import cell, weights
from bench_port.core.build import dataclass_from, empty

PARTS = ("prior", "clip_g")
SERVE = cell.load_module(cell.BENCH / "configs" / "paella-v1-serve-bf16.py")


def _tuples(v):
    """Nested lists as the nested tuples the frozen config holds."""
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def synthetic_merges() -> list:
    return SERVE.synthetic_merges()


def build(config: dict, seed: int, device: torch.device, cache_dir: Path) -> dict:
    from paella_tpu_torch import CascadePriorPipeline, StageCConfig
    from paella_tpu_torch.cond.clip import CLIPTextConfig, CLIPTextEncoder
    from paella_tpu_torch.cond.tokenizers import CLIPTokenizer, write_merges_file
    from paella_tpu_torch.models import StageC

    parts = config["parts"]
    c_cfg = dataclass_from(StageCConfig, {k: _tuples(v) for k, v in parts["prior"]["sizes"].items()})
    t_cfg = dataclass_from(CLIPTextConfig, parts["clip_g"]["sizes"])
    model = empty(lambda: StageC(c_cfg), device).to(getattr(torch, parts["prior"]["dtype"])).eval()
    clip = empty(lambda: CLIPTextEncoder(t_cfg, graph_tag="clip_g"), device).cast_products().eval()
    modules = {"prior": model, "clip_g": clip}
    layouts = {p: weights.fill_module(modules[p], parts[p].get("init"), seed, p) for p in PARTS}
    model.drop_derived()

    merges = synthetic_merges()
    cache_dir.mkdir(parents=True, exist_ok=True)
    merges_path = cache_dir / "clip_merges.txt"
    if not merges_path.exists():
        write_merges_file(merges, str(merges_path))
    tokenizer = CLIPTokenizer(str(merges_path))
    pipe = CascadePriorPipeline(model, clip, tokenizer.with_mask)
    return {"pipeline": pipe, "modules": modules, "layouts": layouts, "merges": merges}


def reference_weights(config: dict, layouts: dict, seed: int, device) -> dict:
    """{part: state dict} of the values `build` gave, drawn again."""
    return {p: weights.regenerate(layouts[p], config["parts"][p].get("init"), seed, p, device) for p in PARTS}
