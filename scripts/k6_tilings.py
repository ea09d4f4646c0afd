#!/usr/bin/env python3
"""Time every tiling of K6's two bf16 products on one card, beside the one
`attn_block_plan` picks.

    python scripts/k6_tilings.py

For the flagship's attention levels 1 and 2 (N 256 and 64) and the level-2
shapes of 256x384 and 384x384 canvases (N 96 and 144), all at CFG batch 2
with S_cond 72 and 16 heads of 80: each q|k|v tiling and each o tiling
(tile width 128 or 64, K split 1, 2 or 4) runs through the kernel's launcher
with that plan, is checked against `attn_block_plain` (2e-2 of the largest
output), and is timed by torch.profiler, device µs per product in a call
(a split's reduce joined to its product; chip_smoke.k6_roles). Then, per
product, the plan's pick, the fastest tiling, and the pick's time over the
fastest. Prints the card's name and power limit. Needs one NVIDIA GPU.
"""
from __future__ import annotations

import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = [  # (name, B, H, W, S_cond, heads, head dim)
    ("level 1", 2, 16, 16, 72, 16, 80),
    ("level 2", 2, 8, 8, 72, 16, 80),
    ("256x384 level 2", 2, 8, 12, 72, 16, 80),
    ("384x384 level 2", 2, 12, 12, 72, 16, 80),
]
TILINGS = [(bn, splits) for bn in (128, 64) for splits in (1, 2, 4)]


def main() -> int:
    sys.path.insert(0, REPO)
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    import torch

    if not torch.cuda.is_available():
        print("k6_tilings: no CUDA device", file=sys.stderr)
        return 1
    from paella_tpu_torch.kernels import attn_block as kblk

    tag = cs.card()
    cs.phase_build(tag)
    gen = torch.Generator(device="cuda").manual_seed(62)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    report = {}
    for name, b, hh, ww, s_c, h, d in SHAPES:
        c, n = h * d, hh * ww
        r = lambda *shape, std: torch.randn(*shape, generator=gen, device="cuda") * std  # noqa: E731
        w = kblk.prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5),
                                            r(c, std=0.05), torch.bfloat16, h)
        x, kv = r(b, hh, ww, c, std=1.0).to(torch.bfloat16), r(b, s_c, c, std=1.0).to(torch.bfloat16)
        cmask = torch.rand(b, s_c, generator=gen, device="cuda") < 0.7
        cmask[:, 0] = True
        want = kblk.attn_block_plain(x, kv, w, h, cmask).float()
        limit = 2e-2 * want.abs().max().item()
        times = {"q|k|v": {}, "o": {}}
        for (bn, sp), (bn_o, sp_o) in zip(TILINGS, TILINGS[1:] + TILINGS[:1]):  # each tiling once per product
            plan = kblk.AttnBlockPlan(bn, sp, bn_o, sp_o)
            call = lambda: kblk._launch(x, kv, w, h, cmask, plan)  # noqa: E731
            err = (call().float() - want).abs().max().item()
            cs.check(err <= limit, f"K6 {name} plan {plan}: max abs error {err} > {limit}")
            roles = dict(cs.k6_roles(cs.kernel_sequence(call)))
            cs.check(bool(roles), f"K6 {name} plan {plan}: torch.profiler traced nothing")
            times["q|k|v"][(bn, sp)], times["o"][(bn_o, sp_o)] = roles["q|k|v"], roles["o"]
        pick = kblk.attn_block_plan(n, s_c, c, h, torch.bfloat16, n_sm)
        picks = {"q|k|v": (pick.bn_qkv, pick.splits_qkv), "o": (pick.bn_o, pick.splits_o)}
        report[name] = {}
        for product, by_tiling in times.items():
            best = min(by_tiling, key=by_tiling.get)
            ratio = by_tiling[picks[product]] / by_tiling[best]
            print(f"[K6 tilings] {name} {product}, device µs by (tile width, splits): "
                  + ", ".join(f"{t} {us:.2f}" for t, us in by_tiling.items())
                  + f"; attn_block_plan picks {picks[product]}, fastest {best}, pick / fastest {ratio:.3f} ({tag})")
            report[name][product] = {"us": {f"{bn}x{sp}": us for (bn, sp), us in by_tiling.items()},
                                     "pick": list(picks[product]), "fastest": list(best), "pick_over_fastest": ratio}
    print(json.dumps(report))
    print(tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
