"""What the two serving entries share: the wrappers the benchmark hands the
pipeline (spans around the text encoders, the sampler and the decode), the
record of the calls kept for the check, and the check itself.

Keeping a call for the check needs the denoiser's input grid at each of its
steps. A forward pre-hook on the model keeps a reference to its input during
the sampler graph's capture (the capture's own buffer, which each replay of
that graph rewrites); after a call that is kept, the sampler wrapper copies
those buffers out. Eager calls (a graph's first call, and every call on the
CPU) hand the hook their inputs directly. Which calls are kept is decided
when each call starts, by a reservoir sample seeded from --seed, plus, where
every call sends new prompts, the call with the longest prompt so far:
nothing is copied for the others.
"""
from __future__ import annotations

import dataclasses
import random

import torch

from bench_port.core import traffic
from bench_port.reference import serve as ref_serve


@dataclasses.dataclass
class Kept:
    prompts: list
    seeds: list  # one (s0, s1) pair per image
    inputs: torch.Tensor = None  # (steps, B, h, w)
    tokens: torch.Tensor = None  # (B, h, w)
    images: list = None  # per image as delivered


class Recorder:
    def __init__(self, model, k: int, seed: int, keep_longest: bool):
        self.k, self.rng, self.keep_longest = k, random.Random(seed), keep_longest
        self.captured: dict = {}  # structure key -> [input buffers]
        self._capture: list = []
        self._eager = None
        self.reservoir: list = []
        self.longest = None
        self.seen = 0
        model.register_forward_pre_hook(self._hook)

    def _hook(self, module, args):
        x = args[0]
        if x.is_cuda and torch.cuda.is_current_stream_capturing():
            self._capture.append(x)
        elif self._eager is not None:
            self._eager.append(x.detach().clone())

    def wants(self, prompts: list):
        """At a call's start: (keep it for the check, replaces) by the
        reservoir or as the longest prompt so far."""
        i = self.seen
        self.seen += 1
        slot = None
        if i < self.k:
            slot = len(self.reservoir)
        else:
            j = self.rng.randrange(i + 1)
            slot = j if j < self.k else None
        if not self.keep_longest:
            return slot, False
        longest = max(len(p.encode()) for p in prompts)
        is_longest = self.longest is None or longest > max(len(p.encode()) for p in self.longest.prompts)
        return slot, is_longest

    def wrap_sample(self, sample, spans, current):
        """The sampler as the pipeline calls it, recording and spanned.
        current() -> (Kept or None) for the call in progress."""
        from paella_tpu_torch.sampling import graph

        def wrapped(model, seeds, cond, latent_shape, uncond=None, config=None, **kw):
            kept = current()
            self._capture, self._eager = [], ([] if kept is not None else None)
            before = graph.captures
            with spans("sample"):
                out = sample(model, seeds, cond, latent_shape, uncond, config, **kw)
            key = (tuple(latent_shape), tuple(cond.byt5.shape), None if uncond is None else tuple(uncond.byt5.shape))
            if graph.captures != before:
                self.captured[key] = self._capture
            if kept is not None:
                b = latent_shape[0]
                # eager (a graph's first call runs eagerly once before its
                # capture, and the CPU always does): the hook's copies;
                # a replay: the captured buffers it just rewrote
                steps = self._eager if self._eager else self.captured[key]
                kept.inputs = torch.stack([x[:b] for x in steps]).clone()
                kept.tokens = out.clone()
            self._capture, self._eager = [], None
            return out

        return wrapped

    def keep(self, kept: Kept, slot, is_longest: bool):
        if slot is not None:
            if slot == len(self.reservoir):
                self.reservoir.append(kept)
            else:
                self.reservoir[slot] = kept
        if is_longest:
            self.longest = kept

    def checked(self) -> list:
        out = list(self.reservoir)
        if self.longest is not None and all(k is not self.longest for k in out):
            out.append(self.longest)
        return out


def wrap_layers(pipe, spans):
    """Spans around the callables the benchmark hands the pipeline and
    around the codec instance's decode."""
    pipe.byt5_encode_fn = spans.wrap("byt5_encode", pipe.byt5_encode_fn)
    if pipe.clip_text_fn is not None:
        pipe.clip_text_fn = spans.wrap("clip_text", pipe.clip_text_fn)
    pipe.vq.decode_indices = spans.wrap("decode", pipe.vq.decode_indices)


def served_images(kept: list) -> list:
    out = []
    for k in kept:
        for j, prompt in enumerate(k.prompts):
            out.append(ref_serve.Served(prompt, tuple(k.seeds[j]), k.inputs[:, j].cpu(), k.tokens[j].cpu(),
                                        k.images[j]))
    return out


def check(builder, config: dict, layouts: dict, seed: int, kept: list, device) -> dict:
    """The numbers `correct` compares for the kept calls, from the reference
    over weights drawn again from the seed (the program's state is freed
    before this runs)."""
    sd = builder.reference_weights(config, layouts, seed, device)
    sizes = {p: config["parts"][p]["sizes"] for p in sd}
    ref = ref_serve.Reference(sd, sizes, builder.synthetic_merges())
    served = served_images(kept)
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        out = ref_serve.check(ref, served, config["sample"])
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    out["images_checked"] = len(served)
    return out


class ServingEntry:
    """What both serving entries do around their own call: the spans and the
    recording wrappers handed to the pipeline, the traffic, and the parts of
    a traced run (the kernels' probe and the model FLOPs of the calls).
    A subclass gives `warmup`, `step` and `end_to_end`, and appends each
    call it makes to `self.calls`."""

    def __init__(self, run):
        from paella_tpu_torch import pipeline as pipeline_mod

        self.run = run
        spec = run.spec
        self.sample_cfg = spec["config"]["sample"]
        self.image_hw = tuple(self.sample_cfg["image_hw"])
        self.pipe = run.built["pipeline"]
        wrap_layers(self.pipe, run.spans)
        fresh = spec["traffic"].get("pool", "fresh") == "fresh"
        self.rec = Recorder(self.pipe.model, int(spec["check"]["calls"]), run.seed, keep_longest=fresh)
        self._current = None
        self._pipeline_mod = pipeline_mod
        self._real_sample = pipeline_mod.sample
        pipeline_mod.sample = self.rec.wrap_sample(self._real_sample, run.spans, lambda: self._current)
        self.gen = traffic.generator(spec["traffic"], run.seed)
        self.calls: list = []

    def release(self):
        self._pipeline_mod.sample = self._real_sample
        self.rec.captured.clear()
        self.pipe = None

    def check(self, device) -> dict:
        run = self.run
        return check(run.builder, run.spec["config"], run.built_layouts, run.seed, self.rec.checked(), device)

    def probe(self):
        from bench_port.core.kernels import probe_sampler

        if self.run.device.type == "cuda":
            model = self.run.built["pipeline"].model
            f = 2 * 2 ** (self.run.spec["config"]["parts"]["codec"]["sizes"]["levels"] - 1)
            h, w = (s // f for s in self.image_hw)
            probe_sampler(self.run, model, int(self.run.spec["traffic"]["batch"]), (h, w), self.sample_cfg["steps"])

    def flop_counter(self):
        from bench_port.reference.flops import ServeFlops

        cfg = self.run.spec["config"]
        sizes = {p: cfg["parts"][p]["sizes"] for p in cfg["parts"]}
        return ServeFlops(sizes, self.run.built_layouts, cfg["sample"])

    def flops(self, fl, first: int, stop: int) -> float:
        """Model FLOPs of the calls numbered first to stop - 1."""
        return sum(fl.generation(c["prompts"]) for c in self.calls[first:stop])
