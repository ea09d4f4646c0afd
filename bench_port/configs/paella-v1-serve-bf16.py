"""The served flagship as `paella_tpu_torch.serve.build_pipeline` assembles
it, with the benchmark's seeded weights in place of checkpoint files: the
denoiser in bf16, the f32 codec, ByT5-XL with its block linears in bf16
(`cond/loader.py::load_byt5`), the CLIP text tower with its products in bf16
(`cond/clip.py::_Tower.cast_products`), and a PaellaPipeline over them.
"""
from __future__ import annotations

from pathlib import Path

import torch

from bench_port.core import weights
from bench_port.core.build import dataclass_from, empty

PARTS = ("denoiser", "codec", "byt5", "clip_text")


def synthetic_merges() -> list:
    """5408 merges over lowercase letters (letter pairs, word-final pairs,
    word-final triples): a frozen copy of `chip_smoke.py::synthetic_merges`."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    merges = [(a, b) for a in letters for b in letters]
    merges += [(a, b + "</w>") for a in letters for b in letters]
    merges += [(a + b, c + "</w>") for a in letters for b in letters for c in "aeiost"]
    return merges


def build(config: dict, seed: int, device: torch.device, cache_dir: Path) -> dict:
    from paella_tpu_torch import PaellaConfig, PaellaPipeline, VQConfig
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.cond.clip import CLIPTextConfig, CLIPTextEncoder
    from paella_tpu_torch.cond.t5 import T5Config, T5Encoder
    from paella_tpu_torch.cond.tokenizers import CLIPTokenizer, write_merges_file
    from paella_tpu_torch.models import Paella

    parts = config["parts"]
    cfgs = {
        "denoiser": dataclass_from(PaellaConfig, parts["denoiser"]["sizes"]),
        "codec": dataclass_from(VQConfig, parts["codec"]["sizes"]),
        "byt5": dataclass_from(T5Config, parts["byt5"]["sizes"]),
        "clip_text": dataclass_from(CLIPTextConfig, parts["clip_text"]["sizes"]),
    }
    model = empty(lambda: Paella(cfgs["denoiser"]), device).to(getattr(torch, parts["denoiser"]["dtype"])).eval()
    vq = empty(lambda: VQModel(cfgs["codec"]), device).to(getattr(torch, parts["codec"]["dtype"])).eval()
    for m in vq.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.reset_running_stats()
    t5 = empty(lambda: T5Encoder(cfgs["byt5"]), device).eval()
    for m in t5.modules():  # the block linears in the compute dtype, as load_byt5 holds them
        if isinstance(m, torch.nn.Linear):
            m.weight.data = m.weight.data.to(cfgs["byt5"].compute_dtype)
    clip = empty(lambda: CLIPTextEncoder(cfgs["clip_text"]), device).cast_products().eval()
    modules = {"denoiser": model, "codec": vq, "byt5": t5, "clip_text": clip}
    layouts = {p: weights.fill_module(modules[p], parts[p].get("init"), seed, p) for p in PARTS}
    model.drop_derived()

    merges = synthetic_merges()
    cache_dir.mkdir(parents=True, exist_ok=True)
    merges_path = cache_dir / "clip_merges.txt"
    if not merges_path.exists():
        write_merges_file(merges, str(merges_path))
    tokenizer = CLIPTokenizer(str(merges_path))

    def clip_text_encode(prompts):
        return clip(torch.as_tensor(tokenizer(prompts), device=device))

    pipe = PaellaPipeline(model, vq, t5, clip_text_fn=clip_text_encode)
    return {"pipeline": pipe, "modules": modules, "layouts": layouts, "merges": merges}


def reference_weights(config: dict, layouts: dict, seed: int, device) -> dict:
    """{part: state dict} of the values `build` gave, drawn again."""
    return {p: weights.regenerate(layouts[p], config["parts"][p].get("init"), seed, p, device) for p in PARTS}
