"""Captured CUDA graphs: the sampler's step loop, the counterpart of the JAX
package's single jit `paella_tpu/sampling/sampler.py::_sample_jit`, the
forwards of the frozen text towers (cond/t5.py::T5Encoder,
cond/clip.py::CLIPTextEncoder), and a training step's loss and backward
(train/trainer.py). A call costs the host one replay instead of hundreds or
thousands of launches.

One capture-and-replay mechanism serves all three. A call's inputs are tensors by
name (None where absent); input values are never part of a graph's key: a
call copies its inputs into the graph's static buffers, replays it and
returns a new tensor holding its output, or a tuple of them where the work
returns a tuple (a clone, so a caller may keep it:
the pipeline's text LRU keeps tower outputs, and the next replay of the same
graph rewrites its output buffer). On a miss the work runs once eagerly,
which builds the kernels, sets their shared-memory limits and makes every
derived weight and kernel scratch outside the capture; that run's output is
the call's answer, and then the graph is captured for the next call with
the same key. So a miss costs an eager run and a capture, and a hit one
replay. A failed capture or replay raises; nothing carries on eagerly. The
device is the inputs'.

`run(body, model, structure, inputs)` runs `body(model, structure, inputs)`
(sampler.py::sample_body) through a graph keyed by the model (its identity,
its config, which picks the forward's kernels, and the process's
derived-weight generation, nn/blocks.py::DerivedWeights: a derived weight
dropped or rebuilt moves it), the device of inputs["seeds"], the sampler's
structure (latent shape, steps, CFG steps, categorical route) and the shape
and dtype of every input. At most MAX_GRAPHS are kept.

`tower(module, name, forward, inputs)` runs `forward(**inputs)` through a
graph keyed by the module's identity, its config (frozen; T5Config holds
`act_quant`), the device, the shape and dtype of every input, and the data
pointers of its parameters and buffers (`reads`): a weight swapped with
`.data = ...`, a dtype or device move, or a submodule replaced captures
anew, while weights overwritten in place (`load_state_dict`) are read by
the graph as they are. The key does not hold the derived-weight
generation: it moves after every training update, the towers are frozen and
derive nothing, and keying on it would recapture a tower at every step of a
training run with the towers in the loop. A forward stays eager only where no graph can be taken: inputs on the
CPU (so a CPU forward is the plain op-by-op forward, bit for bit), and a
call made while the current stream is capturing (the tower's work then
belongs to the outer graph). The tower graphs have their own LRU budget,
MAX_TOWER_GRAPHS, so a tower graph never evicts a sampler graph. A replay
keeps the matmul precision flags in force at its capture.

`train(model, extra, step, inputs, seed, params)` runs `step(inputs,
masks)`, a microbatch's loss and its backward, which sets each parameter's
.grad and returns (loss, acc), through a graph keyed by the model's
identity and config, the device, the shape and dtype of every input (the
batch, the null conditioning and every draw), `reads(model)` (so a restore
that replaces tensors captures anew, while the optimizer's updates in place
are read as they are), the matmul and cuDNN precision flags in force, and
`extra` (the codec and the TrainConfig the step was made with); not the
derived-weight generation, which moves after every update. Unlike the other
two families it runs with autograd on. On a miss `step` runs once eagerly on
static copies of the inputs with fresh dropout masks (nn/blocks.py::
DropoutMasks), whose loss, acc and gradients are the call's answer; then the
graph is captured on the same buffers and masks, and the capture's
gradients, the graph's static ones, are kept aside. On a hit the inputs are
copied in, the masks drawn anew from `seed` into their static buffers, the
graph replayed, each parameter's .grad pointed at its static gradient (a
later replay rewrites it), and clones of loss and acc returned. No draw runs
inside the capture. At most MAX_TRAIN_GRAPHS (one) is kept: its private pool
holds about a step's activations.

Every capture and replay on a device runs on one stream of that process,
ordered after the caller's current stream and before it again, under one
lock: so a graph never replays on two streams at once, and the scratch a
kernel keeps per stream (kernels/_build.py::stream_scratch) is shared only
by calls that never overlap. The kernels' Python launch counters tick in the
warm-up and in the capture, never in a replay: a graph keeps what its
capture added to each, and each replay adds that to the recorder's
`launches.<wrapper>` counters (utils/tracing.py).

Recorded (utils/tracing.py): for the sampler, spans graph.replay (the input
copies and the replay) and graph.capture (the eager warm-up and the
capture), counters graph.hit, graph.miss and graph.evicted, and the gauge
graph.pool_bytes, the sum of `pool_bytes()`; for the towers, spans
tower_graph.replay and tower_graph.capture, counters tower_graph.hit.<name>
and tower_graph.miss.<name> per tower (byt5, clip_text, clip_g) and
tower_graph.evicted, and the gauge tower_graph.pool_bytes, the sum of
`tower_pool_bytes()`; for training, spans train_graph.replay (the input
copies, the mask draws and the replay) and train_graph.capture (the eager
step and the capture), counters train_graph.hit, train_graph.miss and
train_graph.evicted, and the gauge train_graph.pool_bytes.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import weakref
from typing import Callable

import torch
from torch.nn.modules import module as _module

from ..kernels import launch_counts
from ..nn.blocks import DerivedWeights, DropoutMasks
from ..utils import tracing

# Sampler graphs kept, least recently used dropped first. The structures a
# process cycles through: a PaellaServer pads its micro-batches to 1, 2, 4 or
# 8 images and keys them by steps, size and the prompts' ByT5 buckets, and a
# PaellaPipeline adds init_x (img2img), a fixed mask (inpaint) and the
# outpaint canvas's latent shape. Each graph holds a private pool
# (pool_bytes()).
MAX_GRAPHS = 16
# Tower graphs kept, apart from the sampler's: a server at max_batch 8 runs
# ByT5 at 4 batch sizes over 5 buckets (pad_bucket) and CLIP at 4.
MAX_TOWER_GRAPHS = 24
# Training graphs kept: one. Its private pool is about a step's activations
# (~20 GB for the 1b denoiser at 16 images of 256x256), so a second
# signature evicts the first rather than holding another pool.
MAX_TRAIN_GRAPHS = 1

_LOCK = threading.Lock()
_GRAPHS: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()  # the sampler's
_TOWER_GRAPHS: "collections.OrderedDict[tuple, _Graph]" = collections.OrderedDict()
_TRAIN_GRAPHS: "collections.OrderedDict[tuple, _TrainGraph]" = collections.OrderedDict()
_STREAMS: dict = {}  # device -> the stream its captures and replays run on
captures = 0  # graphs captured in this process


@dataclasses.dataclass
class _Graph:
    model: weakref.ref
    graph: torch.cuda.CUDAGraph
    inputs: dict  # the static input buffers (None where absent)
    output: object  # a tensor, or a tuple of tensors
    pool_bytes: int  # device memory reserved while it was captured: its private pool
    launches: dict  # "launches.<wrapper>" -> the wrapper's calls in the capture: one replay's launches


@dataclasses.dataclass
class _TrainGraph(_Graph):
    masks: DropoutMasks  # the static dropout masks, drawn anew before each replay
    grads: dict  # id(parameter) -> its static gradient


@dataclasses.dataclass(frozen=True)
class _Family:
    """Graphs kept under one LRU budget, recorded under `<prefix>.*`."""

    prefix: str
    graphs: collections.OrderedDict
    limit: Callable[[], int]
    stale: Callable[[tuple, _Graph, tuple], bool]  # (a kept key, its graph, the key being captured)


def _sampler_stale(k: tuple, g: _Graph, key: tuple) -> bool:
    """Captured before the derived-weight generation moved (its weights may
    no longer exist), or its model is gone."""
    return k[2] != DerivedWeights.generation or g.model() is None


def _tower_stale(k: tuple, g: _Graph, key: tuple) -> bool:
    """Its module is gone, or is the module being captured with other
    weights (the storage it read may be freed)."""
    return g.model() is None or (k[0] == key[0] and k[4] != key[4])


def _train_stale(k: tuple, g: _Graph, key: tuple) -> bool:
    return g.model() is None


_SAMPLER = _Family("graph", _GRAPHS, lambda: MAX_GRAPHS, _sampler_stale)
_TOWERS = _Family("tower_graph", _TOWER_GRAPHS, lambda: MAX_TOWER_GRAPHS, _tower_stale)
_TRAIN = _Family("train_graph", _TRAIN_GRAPHS, lambda: MAX_TRAIN_GRAPHS, _train_stale)


def graph_key(model, structure, inputs: dict) -> tuple:
    """The key a sampler call's graph is kept under (see the module docstring)."""
    return id(model), model.config, DerivedWeights.generation, str(inputs["seeds"].device), structure, _shapes(inputs)


def tower_key(module, inputs: dict) -> tuple:
    """The key a tower call's graph is kept under (see the module docstring)."""
    return id(module), module.config, str(_device(inputs)), _shapes(inputs), reads(module)


def train_key(model, extra, inputs: dict) -> tuple:
    """The key a training step's graph is kept under (see the module docstring)."""
    matmul = torch.backends.cuda.matmul
    flags = (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction,
             matmul.allow_fp16_reduced_precision_reduction, torch.backends.cudnn.allow_tf32)
    return id(model), model.config, str(_device(inputs)), _shapes(inputs), reads(model), flags, extra


def _shapes(inputs: dict) -> tuple:
    return tuple((name, None if t is None else (tuple(t.shape), t.dtype)) for name, t in inputs.items())


def _device(inputs: dict) -> torch.device:
    return next(t.device for t in inputs.values() if t is not None)


# module -> (the tower it belongs to, weakly), for each module of a tower
# whose tensors `reads` keeps; a parameter, buffer or submodule registered
# into one of them drops that tower's list. Registrations into other modules
# (an `nn.Sequential` sliced in a forward builds a new one) leave it.
_WATCHED: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_READS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()  # tower -> its parameters and buffers


def _on_registration(module, name, value) -> None:
    ref = _WATCHED.get(module)
    tower = None if ref is None else ref()
    if tower is not None:
        _READS.pop(tower, None)


for _hook in (_module.register_module_parameter_registration_hook,
              _module.register_module_buffer_registration_hook,
              _module.register_module_module_registration_hook):
    _hook(_on_registration)


def reads(module) -> tuple:
    """The data pointers of the module's parameters and buffers: the storage
    a graph of its forward reads. The list of tensors is kept between calls
    (walking a 36-layer module costs about a millisecond of host time) and
    made again after a registration into one of the module's own modules."""
    tensors = _READS.get(module)
    if tensors is None:
        tensors = _READS[module] = [*module.parameters(), *module.buffers()]
        ref = weakref.ref(module)
        for m in module.modules():
            _WATCHED[m] = ref
    return tuple(t.data_ptr() for t in tensors)


def run(body: Callable, model, structure, inputs: dict) -> torch.Tensor:
    """body(model, structure, inputs) through its captured graph, on the
    CUDA device of the inputs; a new tensor holding the output."""
    return _call(_SAMPLER, graph_key(model, structure, inputs), lambda static: body(model, structure, static), model,
                 inputs)


def tower(module, name: str, forward: Callable, inputs: dict) -> torch.Tensor:
    """forward(**inputs), a frozen tower's eager forward, through its captured
    graph; eagerly for CPU inputs and inside a capture. `name` tags the
    tower's hit and miss counters."""
    if not all(t.is_cuda for t in inputs.values() if t is not None) or torch.cuda.is_current_stream_capturing():
        return forward(**inputs)
    return _call(_TOWERS, tower_key(module, inputs), lambda static: forward(**static), module, inputs, f".{name}")


def _stream(device) -> torch.cuda.Stream:
    """The device's capture-and-replay stream; under _LOCK."""
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


def _call(family: _Family, key: tuple, fn: Callable, model, inputs: dict, tag: str = "") -> torch.Tensor:
    """fn(inputs) through the graph kept under `key`, captured on a miss."""
    device = _device(inputs)
    with _LOCK, torch.no_grad(), torch.cuda.device(device):
        stream = _stream(device)
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            entry = family.graphs.get(key)
            missed = entry is None or entry.model() is not model
            if missed:
                tracing.count(f"{family.prefix}.miss{tag}")
                _drop_stale(family, key)
                with tracing.span(f"{family.prefix}.capture"):
                    out, family.graphs[key] = _capture(fn, model, inputs, device)
            else:
                tracing.count(f"{family.prefix}.hit{tag}")
                family.graphs.move_to_end(key)
                with tracing.span(f"{family.prefix}.replay"):
                    for name, t in inputs.items():
                        if t is not None:
                            entry.inputs[name].copy_(t)
                    entry.graph.replay()
                    out = _outputs(entry.output, torch.Tensor.clone)
                for name, n in entry.launches.items():
                    tracing.count(name, n)
        caller.wait_stream(stream)
        _outputs(out, lambda t: t.record_stream(caller))
    if missed:
        tracing.gauge(f"{family.prefix}.pool_bytes", sum(_pool_bytes(family)))
    return out


def _outputs(out, fn: Callable):
    """fn over a call's output: a tensor, or each tensor of a tuple."""
    return tuple(fn(t) for t in out) if isinstance(out, tuple) else fn(out)


def _capture(fn: Callable, model, inputs: dict, device) -> tuple[torch.Tensor, _Graph]:
    """The warm-up's output (the call's answer) and the graph captured after it."""
    global captures
    static = {name: None if t is None else t.clone() for name, t in inputs.items()}
    out = fn(static)  # the warm-up, eager, on the capture stream
    graph = torch.cuda.CUDAGraph()
    before = torch.cuda.memory_reserved(device)
    calls = launch_counts()
    graph.capture_begin(capture_error_mode="thread_local")
    try:
        output = fn(static)
    except BaseException:
        with contextlib.suppress(Exception):
            graph.capture_end()
        raise
    graph.capture_end()
    captures += 1
    launches = {f"launches.{k}": n - calls[k] for k, n in launch_counts().items() if n != calls[k]}
    return out, _Graph(weakref.ref(model), graph, static, output, torch.cuda.memory_reserved(device) - before,
                       launches)


def train(model, extra, step: Callable, inputs: dict, seed: int, params: list) -> tuple:
    """step(inputs, masks) -> (loss, acc), a microbatch's loss and its
    backward, through its captured graph on the CUDA device of the inputs,
    with every parameter of `params` given its .grad (see the module
    docstring); `seed` draws the dropout masks."""
    device = _device(inputs)
    key = train_key(model, extra, inputs)
    with _LOCK, torch.cuda.device(device):
        stream = _stream(device)
        caller = torch.cuda.current_stream(device)
        stream.wait_stream(caller)
        with torch.cuda.stream(stream):
            entry = _TRAIN_GRAPHS.get(key)
            missed = entry is None or entry.model() is not model
            if missed:
                tracing.count("train_graph.miss")
                _drop_stale(_TRAIN, key)
                with tracing.span("train_graph.capture"):
                    out, grads, _TRAIN_GRAPHS[key] = _capture_train(step, model, inputs, seed, params, device)
            else:
                tracing.count("train_graph.hit")
                _TRAIN_GRAPHS.move_to_end(key)
                with tracing.span("train_graph.replay"):
                    for name, t in inputs.items():
                        entry.inputs[name].copy_(t)
                    entry.masks.redraw(seed)
                    entry.graph.replay()
                    out = tuple(t.clone() for t in entry.output)
                grads = [entry.grads.get(id(p)) for p in params]
                for name, n in entry.launches.items():
                    tracing.count(name, n)
        caller.wait_stream(stream)
        # the eager step's gradients, like the outputs, were made on the
        # graph's stream (the static ones live as long as their graph)
        for t in (*out, *(grads if missed else ())):
            if t is not None:
                t.record_stream(caller)
    for p, g in zip(params, grads):
        p.grad = g
    if missed:
        tracing.gauge("train_graph.pool_bytes", sum(_pool_bytes(_TRAIN)))
    return out


def _capture_train(step: Callable, model, inputs: dict, seed: int, params: list, device) -> tuple:
    """The eager step's (loss, acc) and gradients (the call's answer), and
    the graph captured after it."""
    global captures
    static = {name: t.clone() for name, t in inputs.items()}
    masks = DropoutMasks(seed)
    out = step(static, masks)  # the warm-up, eager, on the capture stream; draws every mask
    eager = [p.grad for p in params]
    for p in params:
        p.grad = None  # so the captured backward allocates the static gradients in the graph's pool
    # the warm-up's activations go back to the device: the capture's pool
    # needs as much again, and no cached block can be freed during a capture
    torch.cuda.synchronize(device)
    torch.cuda.empty_cache()
    graph = torch.cuda.CUDAGraph()
    before = torch.cuda.memory_reserved(device)
    calls = launch_counts()
    graph.capture_begin(capture_error_mode="thread_local")
    try:
        output = step(static, masks)
    except BaseException:
        with contextlib.suppress(Exception):
            graph.capture_end()
        raise
    graph.capture_end()
    captures += 1
    grads = {id(p): p.grad for p in params if p.grad is not None}
    launches = {f"launches.{k}": n - calls[k] for k, n in launch_counts().items() if n != calls[k]}
    return out, eager, _TrainGraph(weakref.ref(model), graph, static, output,
                                   torch.cuda.memory_reserved(device) - before, launches, masks, grads)


def _drop_stale(family: _Family, key: tuple) -> None:
    """Drop from `family` the graph under `key` (its model is gone), the
    graphs `family.stale` finds, and the least recently used past its limit
    less one; the other family's graphs are never touched."""
    graphs = family.graphs
    n = len(graphs)
    graphs.pop(key, None)
    for k in [k for k, g in graphs.items() if family.stale(k, g, key)]:
        del graphs[k]
    while len(graphs) >= family.limit():
        graphs.popitem(last=False)
    if len(graphs) < n:
        tracing.count(f"{family.prefix}.evicted", n - len(graphs))


def _pool_bytes(family: _Family) -> list:
    with _LOCK:
        return [g.pool_bytes for g in family.graphs.values()]


def pool_bytes() -> list:
    """The private pool bytes of each sampler graph kept, least recently used first."""
    return _pool_bytes(_SAMPLER)


def tower_pool_bytes() -> list:
    """The private pool bytes of each tower graph kept, least recently used first."""
    return _pool_bytes(_TOWERS)


def clear() -> None:
    """Drop every graph kept, the sampler's, the towers' and the training
    step's (their pools return to the allocator's cache once no tensor of
    theirs is held)."""
    with _LOCK:
        for family in (_SAMPLER, _TOWERS, _TRAIN):
            family.graphs.clear()
            tracing.gauge(f"{family.prefix}.pool_bytes", 0)
