#!/usr/bin/env python3
"""Compare the PyTorch port's kernels on two checkouts, in turns on one card.

    python scripts/torch_ab.py PARENT_DIR [--only GROUP]

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
  - K1b in both int8 modes (bf16) at the same shapes: device µs per
    sub-kernel (chip_smoke.k1_split on weights quantized as
    quant.quantize_paella_int8 does);
  - K5 at levels 1 and 2 (bf16, masked): device µs per call;
  - a generation's K1b: torch.profiler over one 8-step CFG generation of the
    flagship with every ResBlock quantized, per mode: the ResBlock kernels'
    device ms and launches;
  - K2 at the flagship step (features (1,64,64,256) x2, W_out (8192,256))
    and K3 over (1,64,64,8192) logits, bf16: device µs per call; the 8-step
    CFG generation on the fused-head route: K2's device ms in one profiled
    generation and the p50 of 5 generations;
  - K4 at the codec's encode shape (z (4096, 4) against (8192, 4)) and at
    M 8 x 4096: device µs per call, every kernel of a call summed;
  - 8-step CFG generations of the flagship at batch 1 (tokens only), plain
    and attention config: p50 of 5 through `sample` (a tree that has the
    sampler's CUDA graph replays it; an older one runs its eager loop);
    then, plain config, a rotation through six structures a pipeline and a
    server cycle through, three rounds: each round's wall ms and each call's
    (a tree with the graph meets every structure first in round 1: a miss).
`--only sampling` (or resblock, attention, int8, quantize, graph) measures
one group alone.
It prints each turn's JSON line, then each measurement's range per tree,
with the card's name and power limit. Needs one NVIDIA GPU.
"""
from __future__ import annotations

import dataclasses
import inspect
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MARK = "TORCH_AB "


def int8_generation(cs, tag: str) -> dict:
    """The ResBlock kernels' device ms and launches in one profiled 8-step
    CFG generation of the flagship, every ResBlock quantized, per mode."""
    import torch

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.quant import fuse_eligible_levels, quantize_paella_int8
    from paella_tpu_torch.sampling import sample

    gen = torch.Generator(device="cuda").manual_seed(63)
    model, _, p_cfg = cs.build_flagship(gen)
    cond, uncond = cs.flagship_conditioning(p_cfg, gen)
    seeds = torch.tensor([[7, 0x1B8]], dtype=torch.int64)
    out = {}
    for mode in ("int8", "w8a8"):
        q = quantize_paella_int8(model, levels=fuse_eligible_levels(p_cfg), include_first=True)
        q.config = dataclasses.replace(p_cfg, act_quant=mode == "w8a8")
        kernels, wall = cs.profile_kernels(lambda: sample(q, seeds, cond, cs.LATENT, uncond, SampleConfig(steps=cs.STEPS)))
        groups = cs.group_kernels(kernels, cs.GENERATION_GROUPS)
        ms, launches = groups["K1"][0] / 1e3, groups["K1"][1]
        print(f"[ab] {mode} generation ({cs.STEPS} steps): ResBlock kernels {ms:.2f} ms ({launches:g} launches) of "
              f"{sum(us for us, _ in kernels.values()) / 1e3:.2f} ms of kernels, {wall:.2f} ms wall ({tag})", flush=True)
        out[f"k1b_generation_{mode}_ms"] = ms if kernels else None
        del q
    del model
    torch.cuda.empty_cache()
    return out


def sampling_kernels(cs, tag: str) -> dict:
    """K2 and K3 at the flagship step, bf16: device µs per call; then the
    8-step CFG generation of the flagship on the fused-head route
    (categorical_impl "pallas"): K2's device ms in one profiled generation
    and the p50 of 5 generations (host wall clock, tokens only)."""
    import time

    import torch

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.kernels.sampling import fused_head_categorical, gumbel_categorical
    from paella_tpu_torch.sampling import sample

    gen = torch.Generator(device="cuda").manual_seed(64)
    args = cs.head_case(1, torch.bfloat16, gen)
    logits = (torch.randn(1, 64, 64, 8192, generator=gen, device="cuda") * 2.0).to(torch.bfloat16)
    seeds = args[0]
    out = {"k2_us": cs.device_us(lambda: fused_head_categorical(*args)),
           "k3_us": cs.device_us(lambda: gumbel_categorical(seeds, logits, 0.7))}
    model, _, p_cfg = cs.build_flagship(gen)
    cond, uncond = cs.flagship_conditioning(p_cfg, gen)
    s_cfg = SampleConfig(steps=cs.STEPS, categorical_impl="pallas")
    generate = lambda: sample(model, seeds, cond, cs.LATENT, uncond, s_cfg)  # noqa: E731
    kernels, _ = cs.profile_kernels(generate)
    # the parent tree's head kernel is head_kernel, this tree's head_wgmma_kernel
    k2 = [v for k, v in kernels.items() if "head_kernel" in k or "head_wgmma_kernel" in k]
    walls = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["k2_generation_ms"] = sum(us for us, _ in k2) / 1e3 if k2 else None
    out["fused_head_8step_p50_ms"] = sorted(walls)[2]
    print(f"[ab] fused-head generation ({cs.STEPS} steps): K2 {out['k2_generation_ms']} ms "
          f"({sum(n for _, n in k2):g} launches), p50 {out['fused_head_8step_p50_ms']:.2f} ms ({tag})", flush=True)
    del model
    torch.cuda.empty_cache()
    return out


def quantize_kernel(cs, tag: str) -> dict:
    """K4's device µs per call (torch.profiler, all the kernels of a call)
    at M 4096 and 8 x 4096, C 4, an N(0,1) codebook of 8192."""
    import torch

    from paella_tpu_torch.kernels.quantize import fused_codebook_lookup

    gen = torch.Generator(device="cuda").manual_seed(65)
    cb = torch.randn(8192, 4, generator=gen, device="cuda")
    out = {}
    for m in (4096, 8 * 4096):
        z = torch.randn(m, 4, generator=gen, device="cuda")
        out[f"k4_m{m}_us"] = cs.device_us(lambda: fused_codebook_lookup(z, cb))
        print(f"[ab] K4 z ({m},4) vs (8192,4): {cs.us_text(out[f'k4_m{m}_us'])} µs on the device a call ({tag})", flush=True)
    return out


def graph_generation(cs, tag: str) -> dict:
    """The 8-step CFG generation of the flagship at batch 1 (tokens only,
    the default "xla" route), plain and attention config on the same
    weights: p50 of 5 `sample` calls after a warm-up, host wall clock."""
    import time

    import torch

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling import sample

    gen = torch.Generator(device="cuda").manual_seed(66)
    model, _, p_cfg = cs.build_flagship(gen)
    cond, uncond = cs.flagship_conditioning(p_cfg, gen)
    with torch.device("cuda"):
        attn = Paella(dataclasses.replace(p_cfg, **cs.ATTN_FLAGS))
    attn.load_state_dict(model.state_dict())
    out = {}
    for name, m in (("plain", model), ("attention", attn.to(torch.bfloat16).eval())):
        generate = lambda i: sample(m, torch.tensor([[i, 0xAB]]), cond, cs.LATENT, uncond, SampleConfig(steps=cs.STEPS))  # noqa: E731
        generate(999)
        walls = []
        for i in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            generate(i).cpu()
            walls.append((time.perf_counter() - t0) * 1e3)
        out[f"{name}_8step_p50_ms"] = sorted(walls)[2]
        print(f"[ab] {name} config, {cs.STEPS}-step CFG generation: p50 {sorted(walls)[2]:.2f} ms (runs "
              f"{', '.join(f'{w:.2f}' for w in walls)}) ({tag})", flush=True)
    out.update(rotation(cs, model, p_cfg, gen, tag))
    del model, attn
    torch.cuda.empty_cache()
    return out


def rotation(cs, model, p_cfg, gen, tag: str, rounds: int = 3) -> dict:
    """8-step CFG calls of `sample` through six structures in turn, `rounds`
    times: text_to_image at batch 1, at batch 2 (a server's padded
    micro-batch) and at batch 1 with a prompt of ByT5 bucket 32; img2img
    (init_x, t_start 0.7), inpaint (init_x and a fixed left quarter) and
    outpaint (a 64x96 latent, the 256x256 image kept). Host wall ms of each
    round and of each call, every call synchronized. A tree with the
    sampler's graph starts with none kept, so round 1 misses on every call."""
    import time

    import torch

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.sampling import Conditioning, sample

    try:
        from paella_tpu_torch.sampling import graph
    except ImportError:  # a tree from before the graph: its loop runs eagerly
        graph = None
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731

    def conditioning(b: int, length: int = cs.BYT5_LEN):
        return (Conditioning(byt5=r(b, length, p_cfg.byt5_embd), clip=r(b, p_cfg.clip_embd), clip_image=r(b, p_cfg.clip_embd)),
                Conditioning(byt5=r(b, 2, p_cfg.byt5_embd), clip=r(b, p_cfg.clip_embd)))

    def tokens(*shape):
        return torch.randint(0, p_cfg.num_labels, shape, generator=gen, device="cuda")

    one, two, short = conditioning(1), conditioning(2), conditioning(1, 32)
    base = SampleConfig(steps=cs.STEPS)
    edit = SampleConfig(steps=cs.STEPS, t_start=0.7)
    x, wide = tokens(1, 64, 64), tokens(1, 64, 96)
    left = torch.zeros(1, 64, 64, dtype=torch.bool, device="cuda")
    left[..., :16] = True
    kept = torch.zeros(1, 64, 96, dtype=torch.bool, device="cuda")
    kept[..., 16:80] = True
    calls = {
        "text_to_image": (one, (1, 64, 64), base, {}),
        "text_to_image_b2": (two, (2, 64, 64), base, {}),
        "text_to_image_bucket32": (short, (1, 64, 64), base, {}),
        "img2img": (one, (1, 64, 64), edit, dict(init_x=x)),
        "inpaint": (one, (1, 64, 64), edit, dict(init_x=x, fixed_mask=left, fixed_tokens=x)),
        "outpaint": (one, (1, 64, 96), base, dict(init_x=wide, fixed_mask=kept, fixed_tokens=wide)),
    }
    if graph is not None:
        graph.clear()
    out = {}
    for k in range(rounds):
        walls = {}
        for i, (name, ((cond, uncond), shape, s_cfg, extra)) in enumerate(calls.items()):
            seeds = torch.tensor([[k * 16 + i + j, 0xAC] for j in range(shape[0])])
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sample(model, seeds, cond, shape, uncond, s_cfg, **extra).cpu()
            walls[name] = (time.perf_counter() - t0) * 1e3
        out[f"rotation_round{k + 1}_ms"] = sum(walls.values())
        print(f"[ab] rotation of {len(calls)} structures, round {k + 1}: {sum(walls.values()):.2f} ms ("
              + ", ".join(f"{n} {w:.2f}" for n, w in walls.items()) + f")"
              + (f"; {graph.captures} captures so far" if graph is not None else "") + f" ({tag})", flush=True)
    if graph is not None:
        print(f"[ab] rotation: graph pools (bytes) {json.dumps(graph.pool_bytes())} ({tag})", flush=True)
        graph.clear()
    return out


def child(tree: str, only: str | None) -> None:
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
    # trees from before the any-width repair take no head count
    takes_nhead = "nhead" in inspect.signature(prepare_attn_block_weights).parameters
    out = {"tree": tree, "card": tag}
    gen = torch.Generator(device="cuda").manual_seed(61)
    for b, hh, ww, c, with_skip in cs.RESBLOCK_SHAPES if only in (None, "resblock") else ():
        x = torch.randn(b, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16)
        skip = torch.randn(b, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16) if with_skip else None
        film = (torch.randn(b, 2 * c, generator=gen, device="cuda") * 0.2).to(torch.bfloat16)
        name = f"{b}x{hh}x{ww}x{c}{'_skip' if with_skip else ''}"
        for mode in ("float", "int8", "w8a8"):
            w = cs.random_resblock(c, 2 if with_skip else 1, torch.bfloat16, gen, mode)
            split = cs.k1_split(x, w, film, skip, tag)
            out[f"{'k1' if mode == 'float' else 'k1b_' + mode}_{name}"] = {
                "device_us": split["device_us"], "roles": split["sub_kernels_us"]}
    for level, (b, n, s_c, h, d) in enumerate(cs.ATTN_LEVELS if only in (None, "attention") else (), start=1):
        c, side = h * d, int(n**0.5)
        r = lambda *shape, std: torch.randn(*shape, generator=gen, device="cuda") * std  # noqa: E731
        w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5),
                                       r(c, std=0.05), torch.bfloat16, *([h] if takes_nhead else []))
        x, kv = r(b, side, side, c, std=1.0).to(torch.bfloat16), r(b, s_c, c, std=1.0).to(torch.bfloat16)
        cmask, mask = cs.attention_masks(b, n, s_c, gen)
        split = cs.k6_split(x, kv, w, h, cmask, tag, f"level {level}")
        out[f"k6_level{level}"] = {"device_us": split["device_us"], "roles": split["sub_kernels_us"]}
        q, k, v = (r(b, ln, h, d, std=1.0).to(torch.bfloat16) for ln in (n, n + s_c, n + s_c))
        out[f"k5_level{level}_us"] = cs.device_us(lambda: fused_attention(q, k, v, mask))
    if only in (None, "int8"):
        out.update(int8_generation(cs, tag))
    if only in (None, "sampling"):
        out.update(sampling_kernels(cs, tag))
    if only in (None, "quantize"):
        out.update(quantize_kernel(cs, tag))
    if only in (None, "graph"):
        out.update(graph_generation(cs, tag))
    untraced = [k for k, v in out.items() if (v["device_us"] if isinstance(v, dict) else v) is None]
    cs.check(not untraced, f"torch.profiler traced no device time for {untraced}")
    print(MARK + json.dumps(out), flush=True)


def main() -> int:
    args = sys.argv[1:]
    only = None
    if len(args) >= 2 and args[-2] == "--only":
        only, args = args[-1], args[:-2]
    if len(args) == 2 and args[0] == "--child":
        child(args[1], only)
        return 0
    if len(args) != 1 or only not in (None, "resblock", "attention", "int8", "sampling", "quantize", "graph"):
        print(__doc__, file=sys.stderr)
        return 2
    parent = os.path.abspath(args[0])
    runs = []
    for tree in (parent, REPO, REPO, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", tree, *(["--only", only] if only else [])],
                              capture_output=True, text=True)
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
        unit = "ms" if key.endswith("_ms") else "µs"
        print(f"{key}: parent {min(p):.2f}-{max(p):.2f} {unit}, change {min(ch):.2f}-{max(ch):.2f} {unit}, "
              f"change / parent {max(ch) / min(p):.3f} at most ({runs[0]['card']})")
        if isinstance(runs[0][key], dict):  # per sub-kernel, the first turn of each tree
            for name, r in (("parent", runs[0]), ("change", runs[1])):
                print(f"  {name}: " + ", ".join(f"{k} {us:.2f}" for k, us in r[key]["roles"].items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
