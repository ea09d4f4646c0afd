"""Spans, the profiled slice and its reduction.

Spans are opened by the benchmark around its calls into the program's
layers. With tracing on, each span synchronizes the device at its start and
its end and takes the host clock there, so it covers the device work of the
call; it also opens a `torch.profiler.record_function` range of its name, so
the device trace's idle gaps can be put down to the layer the host was in.
With tracing off a span does nothing. Spans stay in memory.

`Profiled` runs `torch.profiler` over a bounded slice (a few requests or
steps, opened and closed at request boundaries). `reduce_trace` reads its
Chrome trace: device intervals (kernels, copies, sets), their union, the idle
gaps, the top device operations and the kernel launches.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import tempfile
import time
from collections import defaultdict

import numpy as np
import torch

from .stats import gaps, union_length

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ATTRIBUTED_GAPS = 3000  # the longest idle gaps, each put down to a host range
NAME_CHARS = 160  # a breakdown entry's name, cut


@dataclasses.dataclass
class Span:
    name: str
    start: float
    end: float
    parent: int  # index of the enclosing span, -1 at the top
    tag: str  # "window", or "slice" for the profiled calls after it


class Spans:
    def __init__(self, enabled: bool, device: torch.device):
        self.enabled, self.device = enabled, device
        self.spans: list = []
        self._stack: list = []
        self.tag = "window"

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.enabled:
            yield
            return
        self._sync()
        idx = len(self.spans)
        self.spans.append(Span(name, time.perf_counter(), 0.0, self._stack[-1] if self._stack else -1, self.tag))
        self._stack.append(idx)
        try:
            with torch.profiler.record_function(name):
                yield
                self._sync()
        finally:
            self._stack.pop()
            self.spans[idx].end = time.perf_counter()

    def wrap(self, name: str, fn):
        def wrapped(*args, **kwargs):
            with self(name):
                return fn(*args, **kwargs)

        wrapped.__wrapped__ = fn
        return wrapped

    def durations(self, name: str) -> list:
        """The window's `name` spans' durations."""
        return [s.end - s.start for s in self.spans if s.name == name and s.tag == "window"]

    def self_times(self, name: str) -> list:
        """Each of the window's `name` spans' duration less the time its
        direct children cover."""
        kids = defaultdict(list)
        for s in self.spans:
            if s.parent >= 0:
                kids[s.parent].append((s.start, s.end))
        return [(s.end - s.start) - union_length(kids[i]) for i, s in enumerate(self.spans)
                if s.name == name and s.tag == "window"]


class Profiled:
    """torch.profiler over a slice: start(), stop(), then `events` holds the
    slice's Chrome trace events and `slice` its bounds on the trace's clock.

    host=False traces the device alone, which costs the host far less: the
    slice's bounds are then a marker kernel launched at start() on an idle
    device and one launched at stop() after the slice's work, the first and
    last device events of the trace. host=True adds the host's operators and
    ranges (the spans' names), marks the slice with a range of its own, and
    serves to put the idle gaps down to what the host was doing."""

    def __init__(self, device: torch.device, host: bool = True):
        self.device, self.host = device, host
        self.prof = None
        self.events: list = []
        self.slice = None  # (start_us, end_us) of the slice on the trace's clock
        self.stop_s = 0.0

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = ([ProfilerActivity.CPU] if self.host or self.device.type != "cuda" else []) + (
            [ProfilerActivity.CUDA] if self.device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self._range = torch.profiler.record_function("bench.slice")
        self._range.__enter__()
        self._mark()

    def _mark(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.ones(1, device=self.device).add_(1)

    def stop(self):
        t0 = time.perf_counter()
        self._mark()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._range.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        tmp = tempfile.mkdtemp(prefix="bench_port_trace_")
        try:
            path = os.path.join(tmp, "trace.json")
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                self.events = [e for e in json.load(f).get("traceEvents", []) if e.get("ph") == "X"]
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.prof = None
        self.stop_s = time.perf_counter() - t0
        if self.host:
            marks = [e for e in self.events if e.get("name") == "bench.slice" and e.get("cat") == "user_annotation"]
            if marks:
                m = marks[0]
                self.slice = (float(m["ts"]), float(m["ts"]) + float(m["dur"]))
        else:
            dev = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))) for e in self.events
                   if e.get("cat") in DEVICE_CATS]
            if dev:
                self.slice = (min(s for s, _ in dev), max(t for _, t in dev))


def reduce_trace(events: list, window: tuple, top: int = 10) -> dict:
    """The slice's device intervals (µs) reduced: busy_s (their union),
    window_s, launches (kernels), device_ops (top `top` by total seconds),
    idle_gaps (gap seconds by the innermost host range covering each gap's
    middle), and kernels {name: (seconds, launches)}."""
    w0, w1 = window
    dev, host = [], []
    for e in events:
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        if e.get("cat") in DEVICE_CATS:
            s, t = max(ts, w0), min(ts + dur, w1)
            if t > s:
                dev.append((e.get("name", "?"), s, t, e.get("cat")))
        elif e.get("cat") in ("cpu_op", "user_annotation", "python_function", "cuda_runtime", "cuda_driver"):
            host.append((e.get("name", "?"), ts, ts + dur))
    busy_us = union_length([(s, t) for _, s, t, _ in dev])
    kernels: dict = defaultdict(lambda: [0.0, 0])
    for name, s, t, cat in dev:
        kernels[name][0] += (t - s) * 1e-6
        kernels[name][1] += 1 if cat == "kernel" else 0
    by_host: dict = defaultdict(float)
    idle_spans = sorted(gaps([(s, t) for _, s, t, _ in dev], w0, w1), key=lambda g: g[0] - g[1])
    host = [h for h in host if h[0] != "bench.slice"]
    h_start = np.array([b for _, b, _ in host], dtype=np.float64)
    h_end = np.array([e for _, _, e in host], dtype=np.float64)
    for k, (s, t) in enumerate(idle_spans):
        if k >= ATTRIBUTED_GAPS:  # the shortest gaps, together
            by_host["(shorter gaps)"] += (t - s) * 1e-6
            continue
        mid = (s + t) / 2
        cover = np.nonzero((h_start <= mid) & (h_end >= mid))[0]
        name = host[cover[np.argmin(h_end[cover] - h_start[cover])]][0] if len(cover) else "(no host range)"
        by_host[name] += (t - s) * 1e-6
    ops = sorted(((n[:NAME_CHARS], v[0]) for n, v in kernels.items()), key=lambda x: -x[1])[:top]
    idle = sorted(by_host.items(), key=lambda x: -x[1])[:top]
    return {
        "busy_s": busy_us * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "launches": sum(1 for _, _, _, cat in dev if cat == "kernel"),
        "device_ops": [[n, v] for n, v in ops],
        "idle_gaps": [[n, v] for n, v in idle],
        "kernels": {n: tuple(v) for n, v in kernels.items()},
    }


def kernel_names(fn, device: torch.device) -> set:
    """The names of the kernels that one call of fn() launches (profiled
    after a first, unprofiled call)."""
    fn()
    torch.cuda.synchronize(device)
    p = Profiled(device)
    p.start()
    fn()
    p.stop()
    if p.slice is None:
        return set()
    return {e["name"] for e in p.events if e.get("cat") == "kernel" and p.slice[0] <= float(e["ts"]) <= p.slice[1]}
