"""One run of one cell: set-up, the measured window, the traced slice, the
check, and the result line."""
from __future__ import annotations

import gc
import sys
import time
import traceback

import torch

from . import cell, trace
from .cell import ROOT

CACHE = ROOT / "build" / "bench_port"


class Run:
    """What an entry and the metric readers see of a run."""

    def __init__(self, spec: dict, seed: int, device: torch.device):
        self.spec, self.seed, self.device = spec, int(seed), device
        self.spans = trace.Spans(False, device)  # on for the window of a traced run
        self.builder = cell.builder_module(spec)
        self.built = None
        self.built_layouts = None
        # filled for the readers
        self.window_s = 0.0
        self.calls = 0
        self.slice_calls = 0
        self.trace = None
        self.kernel_names: dict = {}
        self.bound_per_call: dict = {}
        self.slice_flops = None
        self.peak_window_bytes = 0


def _log(msg: str):
    print(f"[bench_port] {msg}", file=sys.stderr, flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(spec: dict, seed: int, seconds: float, traced: bool, device: torch.device, t_start: float,
             keep_entry: bool = False):
    """-> (the result line's object, every number the check computed)."""
    run = Run(spec, seed, device)
    _log(f"imports {time.perf_counter() - t_start:.2f} s")
    run.built = run.builder.build(spec["config"], run.seed, device, CACHE)
    run.built_layouts = run.built["layouts"]
    _sync(device)
    t_built = time.perf_counter() - t_start
    entry = cell.entry_module(spec).Entry(run)
    entry.warmup()
    _sync(device)
    setup_s = time.perf_counter() - t_start
    _log(f"set-up {setup_s:.2f} s: start and weights {t_built:.2f} s, warm-up {setup_s - t_built:.2f} s")
    cuda = device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)

    attempted = failed = images = 0

    def step():
        nonlocal attempted, failed, images
        try:
            images += entry.step(attempted)
        except Exception:
            failed += 1
            if failed == 1:
                traceback.print_exc()
        attempted += 1

    run.spans.enabled = traced
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        step()
    _sync(device)
    run.window_s = time.perf_counter() - t0
    run.calls = attempted - failed
    if cuda:
        run.peak_window_bytes = torch.cuda.max_memory_allocated(device)
        peak = max(peak, run.peak_window_bytes)

    metrics = {}
    if not traced:
        e2e = entry.end_to_end(run.window_s, images) if run.calls else {}
        e2e["setup_s"] = setup_s
        for m in spec["end_to_end"]:
            if m["name"] in e2e:
                metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    else:
        counter = entry.flop_counter() if hasattr(entry, "flop_counter") else None
        # the profiled slice follows the window, so the profiler's cost
        # stays out of the window's spans
        run.spans.tag = "slice"
        n_slice = int(spec["params"].get("slice_calls", 4))
        # the device alone first, with the spans off, so its calls run as an
        # untraced window's do (busy and idle time, kernels, launches, the
        # slice's model FLOPs); then with the host and the spans (what the
        # host did in each idle gap)
        for host in (False, True):
            run.spans.enabled = host
            prof = trace.Profiled(device, host=host)
            prof.start()
            first = attempted
            for _ in range(n_slice):
                step()
            prof.stop()
            _log(f"slice of {attempted - first} calls ({'device and host' if host else 'device'}): "
                 f"{len(prof.events)} trace events; stop {prof.stop_s:.2f} s")
            if prof.slice is None:
                continue
            reduced = trace.reduce_trace(prof.events, prof.slice)
            if not host:
                run.trace, run.slice_calls = reduced, attempted - first
                run.slice_flops = entry.flops(counter, first, attempted) if counter is not None else None
            elif run.trace is not None:
                run.trace["idle_gaps"] = reduced["idle_gaps"]
        if hasattr(entry, "probe"):
            entry.probe()
        for m in spec["per_layer"]:
            value = cell.metric_reader(m["name"])(run, m)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    entry.release()
    run.built = None
    _free_program(device)
    t_check = time.perf_counter()
    numbers = entry.check(device)
    _log(f"window {run.window_s:.2f} s, {attempted} calls; check {time.perf_counter() - t_check:.2f} s")
    limits = spec["check"].get("limits", {})
    checked = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    correct = failed == 0 and run.calls > 0 and all(v["value"] <= v["limit"] for v in checked.values())
    dev = {"platform": "gpu" if cuda else device.type,
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": int(spec["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": bool(correct), "attempted": attempted, "failed": failed, "metrics": metrics, "device": dev}
    if traced and run.trace is not None:
        dev["busy_s"], dev["window_s"] = run.trace["busy_s"], run.trace["window_s"]
        out["breakdown"] = {"device_ops": run.trace["device_ops"], "idle_gaps": run.trace["idle_gaps"]}
    out["checked"] = checked
    return (out, numbers, entry) if keep_entry else (out, numbers)


def _free_program(device):
    from paella_tpu_torch.sampling import graph

    graph.clear()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()

