#!/usr/bin/env python3
"""The readings the limits of the cell cascade-b-b4-fresh are set from: for
each seed, one run of the cell as the benchmark runs it (the program's own
numbers, the lower reading), then its controls on the same kept calls (the
upper readings): Stage B with the fc1 / fc2 of every ResBlock whose width
the int8 kernel takes (K1b W8A8; levels 1-3 at the published widths, the
channelwise-skip blocks included), teacher-forced on the timed path's own
latents and conditioning (eps_gap); the reference's Stage A decode under
TF32 (image_gap); the reference's CLIP-bigG tower with its product weights
in float8 (clip_pooled_gap); the scheduler's step in bfloat16 arithmetic
(step_gap). Each against the same exact reference.

    python3 bench_port/controls_stage_b.py --seeds 1,2,3 --seconds 6

One JSON line a seed on standard output; exits 2 without a card. Not run by
the benchmark's runs.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

WORKLOAD = "cascade-b-b4-fresh"


def decoder_readings(spec: dict, seeds: list, seconds: float, device):
    from bench_port.core import cell, runner
    from paella_tpu_torch.quant import fuse_eligible_levels, quantize_paella_int8

    mod = cell.entry_module(spec)
    builder = cell.builder_module(spec)
    for seed in seeds:
        out, numbers, entry = runner.run_cell(spec, seed, seconds, False, device, time.perf_counter(), keep_entry=True)
        kept = entry.keeper.checked()
        built = builder.build(spec["config"], seed, device, runner.CACHE)
        float_model = built["pipeline"].model
        model = quantize_paella_int8(float_model, levels=fuse_eligible_levels(float_model.config), include_first=True)
        model.config = dataclasses.replace(model.config, act_quant=True)
        del built, float_model
        sd = mod.PRIOR.reference_weights(entry.run, device)
        control = mod.check(spec["config"], sd, builder.synthetic_merges(), kept, device,
                            control=lambda x, r, clip, effnet: model(x, r, clip, effnet),
                            decode=lambda z: tf32(lambda: mod.ref.stage_a_decode(
                                sd["codec"], spec["config"]["parts"]["codec"]["sizes"], z)))
        del model
        runner._free_program(device)
        control.update(tower_and_step(spec["config"], sd, builder.synthetic_merges(), kept, device, mod))
        yield {"workload": spec["name"], "seed": seed, "program": numbers, "control": control,
               "correct": out["correct"], "attempted": out["attempted"]}
        del sd, entry
        runner._free_program(device)


def tf32(fn):
    """fn() with TF32 products and convolutions, the flags restored after."""
    import torch

    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        return fn()
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


def tower_and_step(config: dict, sd: dict, merges: list, kept: list, device, mod) -> dict:
    """The tower's pooled gap with its product weights in float8, and the
    step's in bfloat16 arithmetic, against the exact reference."""
    import torch

    from bench_port.reference.nn import fp8_round

    ref = mod.ref
    tz = config["parts"]["clip_g"]["sizes"]
    low = {k: (fp8_round(v) if v.dim() == 2 and "embedding" not in k else v) for k, v in sd["clip_g"].items()}
    out = dict.fromkeys(("clip_pooled_gap", "step_gap"), 0.0)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            for k in kept:
                ids, mask = mod.tokens(merges, k["prompts"], device)
                want, got = ref.clip_text(sd["clip_g"], tz, ids, mask)[1], ref.clip_text(low, tz, ids, mask)[1]
                out["clip_pooled_gap"] = max(out["clip_pooled_gap"], mod.rows(got, want))
                steps = k["x"].shape[0]
                t = ref.schedule(steps).to(device)
                seeds = torch.tensor(k["seeds"], dtype=torch.int64, device=device)
                for i in range(steps):
                    x, eps = k["x"][i].to(device), k["eps"][i].to(device)
                    z = ref.noise(seeds, tuple(k["x"].shape[2:]), ref.STEP_TAG, i)
                    exact = ref.ddpm_step(x, eps, t[i], t[i + 1], z).to(x.dtype)
                    bf = torch.bfloat16
                    ac, ap = ref._c.alpha_cumprod(t[i]).to(bf), ref._c.alpha_cumprod(t[i + 1]).to(bf)
                    alpha = ac / ap
                    mu = (1.0 / alpha).sqrt() * (x.to(bf) - (1 - alpha) * eps.to(bf) / (1 - ac).sqrt())
                    std = ((1 - alpha) * (1.0 - ap) / (1.0 - ac)).sqrt()
                    low_step = (mu + std * z.to(bf) * (t[i + 1] != 0).to(bf)).to(x.dtype)
                    out["step_gap"] = max(out["step_gap"], mod.rows(low_step, exact))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return out


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)

    import torch

    from bench_port.core import cell

    spec = cell.cell_spec(WORKLOAD)
    if not torch.cuda.is_available():
        print(f"controls_stage_b: {WORKLOAD} needs a CUDA device", file=sys.stderr)
        return 2
    for line in decoder_readings(spec, [int(s) for s in args.seeds.split(",")], args.seconds, torch.device("cuda:0")):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
