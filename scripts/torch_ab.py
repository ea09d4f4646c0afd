#!/usr/bin/env python3
"""Compare the PyTorch port's kernels on two checkouts, in turns on one card.

    python scripts/torch_ab.py PARENT_DIR

PARENT_DIR is another checkout of the repository, for example the parent
commit unpacked from `git archive` under build/ (gitignored). Each turn runs
in its own process, with that tree's paella_tpu_torch first on sys.path and
this checkout's chip_smoke.py for the measurements, in the order parent,
change, change, parent. A turn builds its tree's kernels, then measures on
seeded inputs (the same in every turn):
  - K6 at attention levels 1 and 2 (bf16, masked): device µs per sub-kernel
    (chip_smoke.k6_split);
  - K1 in bf16 at the four flagship shapes: device µs per call
    (chip_smoke.k1_split);
  - K5 at levels 1 and 2 (bf16, masked): device µs per call.
It prints each turn's JSON line, then each measurement's range per tree,
with the card's name and power limit. Needs one NVIDIA GPU.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "TORCH_AB "


def child(tree: str) -> None:
    import importlib.util

    sys.path.insert(0, os.path.abspath(tree))  # the tree's paella_tpu_torch
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)  # this checkout's measurements
    spec.loader.exec_module(cs)
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    tag = cs.card()
    cs.phase_build(tag)
    import paella_tpu_torch
    from paella_tpu_torch.kernels.attention import fused_attention
    from paella_tpu_torch.kernels.attn_block import prepare_attn_block_weights

    cs.check(os.path.abspath(paella_tpu_torch.__file__).startswith(os.path.abspath(tree)), "the tree's package")
    out = {"tree": tree, "card": tag}
    gen = torch.Generator(device="cuda").manual_seed(61)
    for b, hh, ww, c, with_skip in cs.RESBLOCK_SHAPES:
        w = cs.random_resblock(c, 2 if with_skip else 1, torch.bfloat16, gen)
        x = torch.randn(b, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16)
        skip = torch.randn(b, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16) if with_skip else None
        film = (torch.randn(b, 2 * c, generator=gen, device="cuda") * 0.2).to(torch.bfloat16)
        split = cs.k1_split(x, w, film, skip, tag)
        out[f"k1_{b}x{hh}x{ww}x{c}{'_skip' if with_skip else ''}"] = {"device_us": split["device_us"],
                                                                       "roles": split["sub_kernels_us"]}
    for level, (b, n, s_c, h, d) in enumerate(cs.ATTN_LEVELS, start=1):
        c, side = h * d, int(n**0.5)
        r = lambda *shape, std: torch.randn(*shape, generator=gen, device="cuda") * std  # noqa: E731
        w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5),
                                       r(c, std=0.05), torch.bfloat16)
        x, kv = r(b, side, side, c, std=1.0).to(torch.bfloat16), r(b, s_c, c, std=1.0).to(torch.bfloat16)
        cmask, mask = cs.attention_masks(b, n, s_c, gen)
        split = cs.k6_split(x, kv, w, h, cmask, tag, f"level {level}")
        out[f"k6_level{level}"] = {"device_us": split["device_us"], "roles": split["sub_kernels_us"]}
        q, k, v = (r(b, ln, h, d, std=1.0).to(torch.bfloat16) for ln in (n, n + s_c, n + s_c))
        out[f"k5_level{level}_us"] = cs.device_us(lambda: fused_attention(q, k, v, mask))
    untraced = [k for k, v in out.items() if (v["device_us"] if isinstance(v, dict) else v) is None]
    cs.check(not untraced, f"torch.profiler traced no device time for {untraced}")
    print(MARK + json.dumps(out), flush=True)


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        child(sys.argv[2])
        return 0
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(sys.argv[1])
    runs = []
    for tree in (parent, REPO, REPO, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree], capture_output=True, text=True)
        lines = [ln[len(MARK):] for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    for key in runs[0]:
        if key in ("tree", "card"):
            continue
        val = lambda r: r[key]["device_us"] if isinstance(r[key], dict) else r[key]  # noqa: E731
        p, ch = [val(runs[0]), val(runs[3])], [val(runs[1]), val(runs[2])]
        print(f"{key}: parent {min(p):.2f}-{max(p):.2f} µs, change {min(ch):.2f}-{max(ch):.2f} µs, "
              f"change / parent {max(ch) / min(p):.3f} at most ({runs[0]['card']})")
        if isinstance(runs[0][key], dict):  # per sub-kernel, the first turn of each tree
            for name, r in (("parent", runs[0]), ("change", runs[1])):
                print(f"  {name}: " + ", ".join(f"{k} {us:.2f}" for k, us in r[key]["roles"].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
