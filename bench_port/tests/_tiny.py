"""Cells at test size: each configuration's widths and depths cut, the
traffic's batches and lengths kept small, every part float32 where asked."""
from __future__ import annotations

import copy
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_port.core import cell  # noqa: E402

TINY_DENOISER = dict(c_in=16, c_out=16, num_labels=128, c_r=16, c_cond=32, c_hidden=[32, 64, 64], nhead=[-1, 4, 4],
                     blocks=[1, 2, 1], byt5_embd=32, clip_embd=32)
TINY_CODEC = dict(bottleneck_blocks=2, c_hidden=32, codebook_size=128)


def spec(name: str, f32: bool = False) -> dict:
    out = cell.cell_spec(name)
    c = copy.deepcopy(out["config"])
    parts = c["parts"]
    parts["denoiser"]["sizes"].update(TINY_DENOISER)
    if out["entry"] != "train_step":
        parts["denoiser"]["sizes"]["dropout"] = [0.0, 0.0, 0.0]
    parts["codec"]["sizes"].update(TINY_CODEC)
    if "byt5" in parts:
        parts["byt5"]["sizes"].update(d_model=32, d_kv=8, num_heads=4, d_ff=64, num_layers=2)
        parts["clip_text"]["sizes"].update(vocab_size=6000, width=32, heads=4, layers=2, embed_dim=32)
        c["sample"]["image_hw"] = [64, 64]
    else:
        out["traffic"] = dict(out["traffic"], images=2, image_hw=64, byt5_len=8)
    if f32:
        for p in parts.values():
            p["dtype"] = "float32"
            p["sizes"]["dtype"] = "float32"
    out["config"] = c
    return out
