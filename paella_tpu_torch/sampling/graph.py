"""The sampler's step loop as one captured CUDA graph, the counterpart of the
JAX package's single jit `paella_tpu/sampling/sampler.py::_sample_jit`: a
generation costs the host one replay instead of thousands of launches.

`run(body, model, structure, inputs)` runs `body(model, structure, inputs)`
(sampler.py::sample_body) through a graph captured for the call's structure:
the model (its identity, its config, which picks the forward's kernels, and
the process's derived-weight generation, nn/blocks.py::DerivedWeights), the
device, the sampler's structure (latent shape, steps, CFG steps, categorical
route) and the shape and dtype of every input, None where absent. Input
values are never part of the key: a call copies its inputs (seeds,
conditioning, schedules, editing inputs) into the graph's static buffers,
replays it and returns a copy of its output. On a miss the body runs once
eagerly, which builds the kernels, sets their shared-memory limits and makes
every derived weight and kernel scratch outside the capture; that run's
output is the call's answer, and then the graph is captured for the next
call of the structure. So a miss costs an eager run and a capture, and a hit
one replay. A failed capture or replay raises; nothing carries on eagerly.

Every capture and replay on a device runs on one stream of that process,
ordered after the caller's current stream and before it again, under one
lock: so a graph never replays on two streams at once, and the scratch a
kernel keeps per stream (kernels/_build.py::stream_scratch) is shared only
by calls that never overlap. The kernels' Python launch counters tick in the
warm-up and in the capture, never in a replay: a graph keeps what its
capture added to each, and each replay adds that to the recorder's
`launches.<wrapper>` counters (utils/tracing.py).

Recorded (utils/tracing.py): spans graph.replay (the input copies and the
replay) and graph.capture (the eager warm-up and the capture), counters
graph.hit, graph.miss and graph.evicted, and the gauge graph.pool_bytes,
the sum of `pool_bytes()`.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import Callable

import torch

from ..kernels import launch_counts
from ..nn.blocks import DerivedWeights
from ..utils import tracing

# Graphs kept, least recently used dropped first. The structures a process
# cycles through: a PaellaServer pads its micro-batches to 1, 2, 4 or 8 images
# and keys them by steps, size and the prompts' ByT5 buckets, and a
# PaellaPipeline adds init_x (img2img), a fixed mask (inpaint) and the outpaint
# canvas's latent shape. Each graph holds a private pool (pool_bytes()).
MAX_GRAPHS = 16

_LOCK = threading.Lock()
_GRAPHS: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
_STREAMS: dict = {}  # device -> the stream its captures and replays run on
captures = 0  # graphs captured in this process


@dataclasses.dataclass
class _Graph:
    model: weakref.ref
    graph: torch.cuda.CUDAGraph
    inputs: dict  # the static input buffers (None where absent)
    output: torch.Tensor
    pool_bytes: int  # device memory reserved while it was captured: its private pool
    launches: dict  # "launches.<wrapper>" -> the wrapper's calls in the capture: one replay's launches


def graph_key(model, structure, inputs: dict) -> tuple:
    """The key a call's graph is kept under (see the module docstring)."""
    shapes = tuple((name, None if t is None else (tuple(t.shape), t.dtype)) for name, t in inputs.items())
    return id(model), model.config, DerivedWeights.generation, str(inputs["seeds"].device), structure, shapes


def run(body: Callable, model, structure, inputs: dict) -> torch.Tensor:
    """body(model, structure, inputs) through its captured graph, on the
    CUDA device of inputs["seeds"]; a new tensor holding the output."""
    key = graph_key(model, structure, inputs)
    device = inputs["seeds"].device
    with _LOCK, torch.no_grad(), torch.cuda.device(device):
        stream = _STREAMS.get(device)
        if stream is None:
            stream = _STREAMS[device] = torch.cuda.Stream(device)
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            entry = _GRAPHS.get(key)
            missed = entry is None or entry.model() is not model
            if missed:
                tracing.count("graph.miss")
                _drop_stale(key)
                with tracing.span("graph.capture"):
                    out, _GRAPHS[key] = _capture(body, model, structure, inputs)
            else:
                tracing.count("graph.hit")
                _GRAPHS.move_to_end(key)
                with tracing.span("graph.replay"):
                    for name, t in inputs.items():
                        if t is not None:
                            entry.inputs[name].copy_(t)
                    entry.graph.replay()
                    out = entry.output.clone()
                for name, n in entry.launches.items():
                    tracing.count(name, n)
        caller.wait_stream(stream)
        out.record_stream(caller)
    if missed:
        tracing.gauge("graph.pool_bytes", sum(pool_bytes()))
    return out


def _capture(body: Callable, model, structure, inputs: dict) -> tuple[torch.Tensor, _Graph]:
    """The warm-up's output (the call's answer) and the graph captured after it."""
    global captures
    static = {name: None if t is None else t.clone() for name, t in inputs.items()}
    out = body(model, structure, static)  # the warm-up, eager, on the capture stream
    graph = torch.cuda.CUDAGraph()
    device = inputs["seeds"].device
    before = torch.cuda.memory_reserved(device)
    calls = launch_counts()
    graph.capture_begin(capture_error_mode="thread_local")
    try:
        output = body(model, structure, static)
    except BaseException:
        with contextlib.suppress(Exception):
            graph.capture_end()
        raise
    graph.capture_end()
    captures += 1
    launches = {f"launches.{k}": n - calls[k] for k, n in launch_counts().items() if n != calls[k]}
    return out, _Graph(weakref.ref(model), graph, static, output, torch.cuda.memory_reserved(device) - before,
                       launches)


def _drop_stale(key: tuple) -> None:
    """Drop the graph under `key` (its model is gone), the graphs captured
    before the derived-weight generation moved, whose weights may no longer
    exist, and the least recently used past MAX_GRAPHS - 1."""
    n = len(_GRAPHS)
    _GRAPHS.pop(key, None)
    for k in [k for k, g in _GRAPHS.items() if k[2] != DerivedWeights.generation or g.model() is None]:
        del _GRAPHS[k]
    while len(_GRAPHS) >= MAX_GRAPHS:
        _GRAPHS.popitem(last=False)
    if len(_GRAPHS) < n:
        tracing.count("graph.evicted", n - len(_GRAPHS))


def pool_bytes() -> list:
    """The private pool bytes of each graph kept, least recently used first."""
    with _LOCK:
        return [g.pool_bytes for g in _GRAPHS.values()]


def clear() -> None:
    """Drop every graph kept (their pools return to the allocator's cache)."""
    with _LOCK:
        _GRAPHS.clear()
        tracing.gauge("graph.pool_bytes", 0)
