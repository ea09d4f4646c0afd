#!/usr/bin/env python3
"""The readings the limits of the cell cascade-c-b4-fresh are set from
(control.py reads the other cells'): for each seed, one run of the cell as
the benchmark runs it (the program's own numbers, the lower reading), then
its controls on the same inputs (the upper readings): Stage C with every
ResBlock's fc1 / fc2 as int8 x int8 products (K1b W8A8, the
channelwise-skip block included), teacher-forced on the timed path's own
latents and conditioning (eps_gap, cfg_eps_gap); the reference's CLIP-bigG
tower with its product weights in float8 (clip_hidden_gap,
clip_pooled_gap); the scheduler's step in bfloat16 arithmetic (step_gap).
Each against the same exact reference.

    python3 bench_port/controls.py --workload <cell> --seeds 1,2,3 --seconds 6

One JSON line a seed on standard output; exits 2 without the cell's cards.
Not run by the benchmark's runs.
"""
from __future__ import annotations

import dataclasses
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def prior_readings(spec: dict, seeds: list, seconds: float, device):
    import torch

    from bench_port.core import cell, runner
    from bench_port.reference import stage_c as ref
    from bench_port.reference.nn import fp8_round
    from paella_tpu_torch.quant import quantize_paella_int8

    mod = cell.entry_module(spec)
    builder = cell.builder_module(spec)
    for seed in seeds:
        out, numbers, entry = runner.run_cell(spec, seed, seconds, False, device, time.perf_counter(), keep_entry=True)
        kept = entry.keeper.checked()
        built = builder.build(spec["config"], seed, device, runner.CACHE)
        model = quantize_paella_int8(built["pipeline"].model, levels=(0, 1), include_first=True)
        model.config = dataclasses.replace(model.config, act_quant=True)
        del built
        sd = mod.reference_weights(entry.run, device)
        control = mod.check(spec["config"], sd, builder.synthetic_merges(), kept, device,
                            control=lambda x, r, *cond: model(x, r, *cond))
        del model
        runner._free_program(device)
        control.update(tower_and_step(spec["config"], sd, builder.synthetic_merges(), kept, device, ref, mod,
                                      fp8_round))
        yield {"workload": spec["name"], "seed": seed, "program": numbers, "control": control,
               "correct": out["correct"], "attempted": out["attempted"]}
        del sd, entry
        runner._free_program(device)


def tower_and_step(config: dict, sd: dict, merges: list, kept: list, device, ref, mod, fp8_round) -> dict:
    """The tower's gaps with its product weights in float8, and the step's in
    bfloat16 arithmetic, against the exact reference."""
    import torch

    tz = config["parts"]["clip_g"]["sizes"]
    low = {k: (fp8_round(v) if v.dim() == 2 and "embedding" not in k else v) for k, v in sd["clip_g"].items()}
    out = dict.fromkeys(("clip_hidden_gap", "clip_pooled_gap", "step_gap"), 0.0)
    guidance = float(config["sample"]["cfg"])
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        with torch.no_grad():
            for k in kept:
                b = len(k["prompts"])
                ids, mask = mod.tokens(merges, [*k["prompts"], ""], device)
                want = ref.clip_text(sd["clip_g"], tz, ids, mask)
                got = ref.clip_text(low, tz, ids, mask)
                out["clip_hidden_gap"] = max(out["clip_hidden_gap"], mod.rows(got[0], want[0]))
                out["clip_pooled_gap"] = max(out["clip_pooled_gap"], mod.rows(got[1], want[1]))
                steps = k["x"].shape[0]
                t = ref.schedule(steps).to(device)
                seeds = torch.tensor(k["seeds"], dtype=torch.int64, device=device)
                for i in range(steps):
                    x = k["x"][i].to(device)
                    eps = ref.cfg_mix(k["eps"][i, :b], k["eps"][i, b:], guidance).to(device)
                    z = ref.noise(seeds, tuple(k["x"].shape[2:]), ref.STEP_TAG, i)
                    exact = ref.ddpm_step(x, eps, t[i], t[i + 1], z).to(x.dtype)
                    bf = torch.bfloat16
                    ac, ap = ref.alpha_cumprod(t[i]).to(bf), ref.alpha_cumprod(t[i + 1]).to(bf)
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
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)

    import torch

    from bench_port.core import cell

    spec = cell.cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec["chips"]):
        print(f"controls: {args.workload} needs {spec['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    for line in prior_readings(spec, [int(s) for s in args.seeds.split(",")], args.seconds, torch.device("cuda:0")):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
