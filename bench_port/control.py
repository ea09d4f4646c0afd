#!/usr/bin/env python3
"""The readings a cell's limits are set from: for each seed, one run of the
cell as the benchmark runs it (the program's own numbers, the lower
reading), then its control on the same inputs (the upper reading):

- serving, the logit gaps: the program with its int8 path switched on, W8A8
  (every ResBlock's fc1 / fc2 as int8 x int8 products through K1b,
  ByT5-XL's block linears through quant.w8a8_dot), teacher-forced on the
  timed path's own step inputs; its drawn tokens are judged by the
  reference as the program's are.
- serving, the image gaps: the reference's decode in TF32 (the precision
  below the codec's float32) in place of the program's.
- training: the reference with its products in float8, and the planted
  fault of half a batch (`train_readings`).

    python3 bench_port/control.py --workload <cell> --seeds 1,2,3 --seconds 6

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


def control_draws(run_spec: dict, seed: int, kept: list, device) -> list:
    """Per kept image: the int8 program's drawn tokens at each step, from the
    program's own step inputs."""
    import torch

    from bench_port.core import cell
    from bench_port.core.runner import CACHE
    from paella_tpu_torch import PaellaPipeline
    from paella_tpu_torch.quant import quantize_paella_int8, quantize_t5_int8
    from paella_tpu_torch.sampling.sampler import derive_seeds, draw_tokens, merge_cfg_pair
    from bench_port.reference import sampling

    builder = cell.builder_module(run_spec)
    built = builder.build(run_spec["config"], seed, device, CACHE)
    pipe = built["pipeline"]
    model = quantize_paella_int8(pipe.model, levels=(0, 1, 2), include_first=True)
    model.config = dataclasses.replace(model.config, act_quant=True)
    t5 = quantize_t5_int8(pipe.byt5_encode_fn)
    t5.config = dataclasses.replace(t5.config, act_quant=True)
    pipe8 = PaellaPipeline(model, pipe.vq, t5, clip_text_fn=pipe.clip_text_fn, text_cache_size=0)
    del built, pipe
    sample = run_spec["config"]["sample"]
    out = []
    with torch.no_grad():
        for k in kept:
            for j, prompt in enumerate(k.prompts):
                steps = k.inputs.shape[0]
                sch = sampling.schedule(steps, sample["temperature"], (sample["cfg"], sample["cfg"]))
                c = pipe8.conditioning([prompt])
                u = pipe8.conditioning([""])
                merged = merge_cfg_pair(c, u)
                cache = model.gen_cond_cache(merged.byt5, merged.clip, None, byt5_mask=merged.byt5_mask,
                                             clip_mask=merged.clip_mask)
                seeds = torch.tensor([k.seeds[j]], dtype=torch.int64, device=device)
                cat = derive_seeds(seeds, 1, torch.arange(steps, device=device))
                draws = []
                for i in range(steps):
                    x = k.inputs[i, j][None].to(device)
                    t = torch.full((2,), float(sch["t"][i]), device=device)
                    f = model(torch.cat([x, x]), t, return_features=True, cond_cache=cache)
                    w = torch.tensor(float(sch["cfg"][i]), dtype=torch.float32, device=device)
                    temp = torch.tensor(float(sch["temperature"][i]), dtype=torch.float32, device=device)
                    draws.append(draw_tokens(sample["categorical_impl"], cat[i], f[:1].contiguous(), f[1:].contiguous(),
                                             w, model.head_weight(), temp)[0].cpu())
                out.append(draws)
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
        # readings that set a limit come from the port's path on the card,
        # never from the plain versions its wrappers run on the CPU
        print(f"control: {args.workload} needs {spec['chips']} CUDA device(s)", file=sys.stderr)
        return 2
    device = torch.device("cuda:0")
    seeds = [int(s) for s in args.seeds.split(",")]
    lines = (train_readings if spec["entry"] == "train_step" else readings)(spec, seeds, args.seconds, device)
    for line in lines:
        print(json.dumps(line), flush=True)
    return 0


def train_readings(spec: dict, seeds: list, seconds: float, device):
    """Per seed: the program's numbers against the reference, then the
    reference with its products in float8 (the precision below the
    configuration's bfloat16) and with half of each batch left out (the mean
    taken over the rest), each against the same exact reference. A state left
    unchanged reads 1 by update_leaf_gap's measure and needs no run."""
    from bench_port.core import cell, runner
    from bench_port.reference.nn import fp8_round

    mod = cell.entry_module(spec)
    for seed in seeds:
        out, numbers, entry = runner.run_cell(spec, seed, seconds, False, device, time.perf_counter(), keep_entry=True)
        t_ref = time.perf_counter()
        sd = entry.run.builder.reference_weights(spec["config"], entry.run.built_layouts, seed, device)
        args = (spec["config"], sd, entry.mix, entry.latent_hw, seed, entry.check_seeds, mod.MICRO, device)
        lines = {name: mod.compare(mod.follow(*args, cast=cast, rows=rows), entry.reference)
                 for name, cast, rows in (("control_fp8", fp8_round, 0),
                                          ("fault_half_batch", None, int(entry.mix["images"]) // 2))}
        yield {"workload": spec["name"], "seed": seed, "program": numbers, **lines,
               "correct": out["correct"], "attempted": out["attempted"], "control_s": time.perf_counter() - t_ref}
        del sd, entry
        runner._free_program(device)


def readings(spec: dict, seeds: list, seconds: float, device):
    """Yield, per seed, the program's numbers and its control's."""
    import torch

    from bench_port.core import runner, serving
    from bench_port.reference import serve as ref_serve

    for seed in seeds:
        out, numbers, entry = runner.run_cell(spec, seed, seconds, False, device, time.perf_counter(),
                                              keep_entry=True)
        kept = entry.rec.checked()
        draws = control_draws(spec, seed, kept, device)
        runner._free_program(device)
        sd = entry.run.builder.reference_weights(spec["config"], entry.run.built_layouts, seed, device)
        sizes = {p: spec["config"]["parts"][p]["sizes"] for p in sd}
        ref = ref_serve.Reference(sd, sizes, entry.run.builder.synthetic_merges())
        served = serving.served_images(kept)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        logit_gap, total, n = 0.0, 0.0, 0
        for s, d in zip(served, draws):
            for i, sc, observed, tok, _ in ref_serve.walk(ref, s, spec["config"]["sample"], draw=lambda i, x, d=d: d[i]):
                g = ref_serve.gaps(sc, observed, tok)
                logit_gap, total, n = max(logit_gap, float(g.max())), total + float(g.sum()), n + g.numel()
        widest, mean = 0.0, 0.0
        for s in served:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
            low = ref.decode(s.tokens).clamp(0.0, 1.0)
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
            image = (low * 255).to(torch.uint8).cpu() if s.image.dtype == torch.uint8 else low
            w, m = ref_serve.delivered_gap(ref, ref_serve.Served(s.prompt, s.seeds, s.inputs, s.tokens, image))
            widest, mean = max(widest, w), max(mean, m)
        control = {"logit_gap": logit_gap, "logit_mean_gap": total / max(n, 1), "image_max_gap": widest,
                   "image_mean_gap": mean}
        yield {"workload": spec["name"], "seed": seed, "program": numbers, "control": control,
               "correct": out["correct"], "attempted": out["attempted"]}
        del ref, sd, entry
        runner._free_program(device)


if __name__ == "__main__":
    sys.exit(main())
