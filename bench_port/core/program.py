"""The program's own spans and counters (paella_tpu_torch/utils/tracing.py)
in a traced run, and the device work launched inside them.

The runner's two slices run with the program's recorder off, and it keeps
neither the recorder's snapshot nor the host slice's raw events. So the
first reader that asks runs a slice of its own after them, with the
benchmark's own spans off (they synchronize) and the recorder on, through
the run's entry (found on the stack of the call that reads the metrics):

- `2 x slice_calls` calls as an untraced window runs them, the recorder on:
  its `snapshot()` becomes `run.program` (the program_span metrics);
- `slice_calls` calls under `torch.profiler` with the host: the raw events
  of that slice become `run.host_events` (the device_trace metrics, by the
  trace's correlation ids), and their idle gaps, put down to the innermost
  host range (the program's spans among them), replace the breakdown's.

A run that already holds `program` and `host_events` is read as it is. A
program without the recorder (an older checkout) gives None, and every
reader then returns None.
"""
from __future__ import annotations

import bisect
import sys
import traceback

from . import trace
from .stats import union_length

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def recorder():
    """The program's recorder module, or None where the program has none."""
    try:
        from paella_tpu_torch.utils import tracing
    except ImportError:
        return None
    return tracing


def _entry(run):
    """The object whose `step(i)` makes one call of the run (its entry)."""
    frame = sys._getframe(1)
    while frame is not None:
        for v in frame.f_locals.values():
            try:
                if getattr(v, "run", None) is run and callable(getattr(v, "step", None)):
                    return v
            except Exception:  # a local whose attributes cannot be read is not the entry
                continue
        frame = frame.f_back
    return None


def program_slice(run) -> bool:
    """Fill `run.program` and `run.host_events` once (see the module
    docstring); False where there is nothing to read."""
    if hasattr(run, "program"):
        return run.program is not None and run.host_events is not None
    run.program = run.host_events = None
    rec = recorder()
    entry = _entry(run) if rec is not None else None
    if entry is None:
        return False
    n = int(run.spec["params"].get("slice_calls", 4))
    outside = run.spans.enabled
    run.spans.enabled = False
    prof = trace.Profiled(run.device, host=True)
    try:
        rec.reset()
        rec.enable()
        for i in range(2 * n):
            entry.step(i)
        program = rec.snapshot()
        rec.reset()
        prof.start()
        for i in range(n):
            entry.step(i)
        prof.stop()
    except Exception:  # the metrics are left out of the line; the run goes on to its check
        traceback.print_exc()
        if prof.prof is not None:
            prof.prof.__exit__(None, None, None)
        return False
    finally:
        rec.disable()
        run.spans.enabled = outside
    if prof.slice is None:
        return False
    run.program = program
    run.host_events = prof.events
    if run.trace is not None:
        run.trace["idle_gaps"] = trace.reduce_trace(prof.events, prof.slice)["idle_gaps"]
    print(f"[bench_port] program slice: {2 * n} calls with the recorder on, {n} profiled; "
          f"{len(program['spans'])} spans, {program['dropped']} dropped", file=sys.stderr, flush=True)
    return True


def _merged(ranges: list) -> tuple:
    """Sorted, disjoint (starts, ends) covering `ranges`."""
    starts, ends = [], []
    for s, t in sorted(ranges):
        if ends and s <= ends[-1]:
            ends[-1] = max(ends[-1], t)
        else:
            starts.append(s)
            ends.append(t)
    return starts, ends


def ranges(events: list, name: str) -> list:
    """(start, end) in µs of each host range `name` (a program span)."""
    return [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in events
            if e.get("cat") == "user_annotation" and e.get("name") == name]


def launched_in(events: list, name: str, cats=trace.DEVICE_CATS) -> list:
    """The device events of `cats` whose launch call (an event of
    `LAUNCH_CATS`, matched by the trace's correlation id) started inside a
    host range `name`, on any thread (autograd runs the backward on a thread
    of its own). The kernels a `cudaGraphLaunch` runs carry that call's id."""
    starts, ends = _merged(ranges(events, name))
    if not starts:
        return []
    ids = set()
    for e in events:
        if e.get("cat") in LAUNCH_CATS:
            ts, corr = float(e["ts"]), e.get("args", {}).get("correlation")
            i = bisect.bisect_right(starts, ts) - 1
            if corr is not None and i >= 0 and ts <= ends[i]:
                ids.add(corr)
    return [e for e in events if e.get("cat") in cats and e.get("args", {}).get("correlation") in ids]


def device_ms(run, name: str, per: str):
    """The union of the device intervals launched inside `name` ranges, in
    ms, over the number of `per` ranges in the profiled slice."""
    if not program_slice(run):
        return None
    n = len(ranges(run.host_events, per))
    dev = launched_in(run.host_events, name)
    if not n or not dev:
        return None
    return union_length([(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in dev]) * 1e-3 / n


def launches(run, name: str, per: str):
    """Kernels launched inside `name` ranges over the `per` ranges of the
    profiled slice."""
    if not program_slice(run):
        return None
    n = len(ranges(run.host_events, per))
    k = len(launched_in(run.host_events, name, cats=("kernel",)))
    return k / n if n and k else None


def span_ms(run, name: str, per: str):
    """The program's `name` spans summed, in ms, over its `per` spans, from
    the calls run with the recorder on and no profiler."""
    if not program_slice(run):
        return None
    spans = run.program["spans"]
    n = sum(1 for s in spans if s.name == per)
    v = [s.end_ns - s.start_ns for s in spans if s.name == name and s.end_ns]
    return sum(v) * 1e-6 / n if n and v else None
