#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json, bench_port/ and the
port (paella_tpu_torch/). Set-up (the seeded weights on the card, the
kernels' build, the warm-up of the cell's shapes) is timed as setup_s; the
window then runs for --seconds; --trace 1 reports the per-layer metrics of a
profiled slice instead of the end-to-end ones. Last, the reference checks
what the window produced. The last line of standard output is one JSON
object; the numbers the check compared, each beside its limit, are the last
lines of standard error. Exits 2 without a card (or with fewer than the
cell asks for), 3 if JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache at a fixed path inside the checkout, before torch is imported
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "bench_port" / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "bench_port" / "torch_extensions")
os.environ["USE_FLAX"] = "0"
# one process, few threads: the port's host work is one thread's launches
os.environ["OMP_NUM_THREADS"] = "1"
os.environ["MKL_NUM_THREADS"] = "1"
os.environ["USE_JAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from bench_port.core import cell, guard, runner

    spec = cell.cell_spec(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(spec["chips"]):
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench_port: {args.workload} needs {spec['chips']} CUDA device(s), found {found}", file=sys.stderr)
        return 2
    result, numbers = runner.run_cell(spec, args.seed, args.seconds, bool(args.trace), torch.device("cuda:0"), T_START)
    found = guard.loaded_forbidden()
    if found:
        print(f"bench_port: loaded {', '.join(found)} (JAX or the JAX package) in the measuring process",
              file=sys.stderr)
        return 3
    print("check: " + json.dumps(numbers), file=sys.stderr)
    for name, v in result["checked"].items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
