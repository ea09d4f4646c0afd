"""`CascadePriorPipeline.text_to_latents` at the mix's batch, closed loop:
each call a batch of prompts and one seed an image at the configuration's
image size, steps and CFG, the latents on the device at its end (the call's
work ends in a synchronize).

Keeping a call for the check needs Stage C's input and output at each of
its steps: hooks on the model keep references to them during the sampler
graph's capture (buffers each replay rewrites, and a call replays the graph
once) and copy them on an eager call; after a call that is kept, those
buffers and the call's conditioning are copied out. Which calls are kept: a
reservoir of check.calls calls seeded from --seed, plus the call with the
longest prompt so far. The check looks at every image of each kept call.

The check (reference/stage_c.py, float32, TF32 off, over weights drawn
again from the seed): the CLIP-bigG tower's two outputs from the prompts
(tokenized by reference/text.py's BPE) against the program's; then at
every step, teacher-forced on the program's own latents and conditioning,
Stage C's eps for each image's CFG pair (`eps_gap`, the worse side) and
after the CFG mix (`cfg_eps_gap`), and the scheduler's step from the
program's own mixed eps with the reference's z against the program's next
latent (`step_gap`). Each gap is relative: ||program - reference|| /
||reference|| of one image, the largest over steps and images.
"""
from __future__ import annotations

import math
import random

import torch

from bench_port.core import traffic, weights
from bench_port.reference import stage_c as ref
from bench_port.reference import text as ref_text


class Keeper:
    """Stage C's per-step inputs and outputs of the calls kept for the check."""

    def __init__(self, model, k: int, seed: int):
        self.k, self.rng = k, random.Random(seed)
        self.captured: dict = {}  # latent shape -> [(x, eps)] buffers of the capture
        self._capture: list = []
        self._eager = None
        self._x = None
        self._captures = 0
        self.reservoir: list = []
        self.longest = None
        self.seen = 0
        model.register_forward_pre_hook(self._pre)
        model.register_forward_hook(self._post)

    def _pre(self, module, args):
        self._x = args[0]

    def _post(self, module, args, out):
        if out.is_cuda and torch.cuda.is_current_stream_capturing():
            self._capture.append((self._x, out))
        elif self._eager is not None:
            self._eager.append((self._x.detach().clone(), out.detach().clone()))
        self._x = None

    def wants(self, prompts: list) -> tuple:
        i = self.seen
        self.seen += 1
        slot = len(self.reservoir) if i < self.k else self.rng.randrange(i + 1)
        slot = slot if slot < self.k else None
        longest = max(len(p.encode()) for p in prompts)
        is_longest = self.longest is None or longest > max(len(p.encode()) for p in self.longest["prompts"])
        return slot, is_longest

    def begin(self, keep: bool):
        """Before a call: record its eager steps if it is kept."""
        from paella_tpu_torch.sampling import graph

        self._capture, self._eager = [], ([] if keep else None)
        self._captures = graph.captures

    def end(self, out: torch.Tensor, kept) -> None:
        """After a call: the capture it made, and the kept call's per-step
        latents and eps (CFG rows: the images', then their unconditional
        sides) and its output."""
        from paella_tpu_torch.sampling import graph

        key = tuple(out.shape)
        if graph.captures != self._captures:
            self.captured[key] = self._capture
        if kept is not None:
            b = out.shape[0]
            steps = self._eager if self._eager else self.captured[key]
            kept["x"] = torch.stack([x[:b] for x, _ in steps]).clone()
            kept["eps"] = torch.stack([e for _, e in steps]).clone()
            kept["out"] = out.clone()
        self._capture, self._eager = [], None

    def keep(self, kept: dict, slot, is_longest: bool):
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


class Entry:
    def __init__(self, run):
        from paella_tpu_torch import PriorSampleConfig

        self.run = run
        spec = run.spec
        s = spec["config"]["sample"]
        self.config = PriorSampleConfig(steps=int(s["steps"]), cfg=float(s["cfg"]))
        self.image_hw = tuple(s["image_hw"])
        self.pipe = run.built["pipeline"]
        conditioning = run.spans.wrap("clip_text", self.pipe.conditioning)
        self._cond = None

        def recorded(prompts):
            self._cond = conditioning(prompts)
            return self._cond

        self.pipe.conditioning = recorded
        self.keeper = Keeper(self.pipe.model, int(spec["check"]["calls"]), run.seed)
        self.gen = traffic.generator(spec["traffic"], run.seed)

    def _call(self, prompts: list, seeds: list, kept=None) -> torch.Tensor:
        pairs = torch.tensor([[0, s & 0xFFFFFFFF] for s in seeds], dtype=torch.int64)
        self.keeper.begin(kept is not None)
        out = self.pipe.text_to_latents(prompts, pairs, self.image_hw, self.config)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.keeper.end(out, kept)
        return out

    def warmup(self):
        """Prompts the traffic never sends, with seeds it does not draw: the
        kernels' build, the tower's and the sampler's captures, then a
        replay of each."""
        b = int(self.run.spec["traffic"]["batch"])
        for i in range(2):
            self._call([f"warmup {i} {j}" for j in range(b)], [7 + j for j in range(b)])

    def step(self, i: int) -> int:
        call = self.gen.next()
        slot, longest = self.keeper.wants(call["prompts"])
        kept = None
        if slot is not None or longest:
            kept = {"prompts": call["prompts"], "seeds": [(0, s & 0xFFFFFFFF) for s in call["seeds"]]}
        with self.run.spans("call"):
            out = self._call(call["prompts"], call["seeds"], kept)
        if kept is not None:
            kept["cond"] = self._cond
            kept["uncond"] = self.pipe.null_conditioning(out.shape[0])
            self.keeper.keep(kept, slot, longest)
        return out.shape[0]

    def end_to_end(self, window_s: float, images: int) -> dict:
        return {"images_per_s": images / window_s}

    def release(self):
        self.keeper.captured.clear()
        self.pipe = None

    def check(self, device) -> dict:
        run = self.run
        return check(run.spec["config"], reference_weights(run, device), run.builder.synthetic_merges(),
                     self.keeper.checked(), device)

    def probe(self):
        if self.run.device.type == "cuda":
            from bench_port.core.stage_c_roofline import probe_prior

            probe_prior(self.run, self.run.built["pipeline"].model, int(self.run.spec["traffic"]["batch"]),
                        self.latent_hw(), self.config.steps)

    def latent_hw(self) -> tuple:
        m = float(self.run.spec["config"]["sample"]["resolution_multiple"])
        return tuple(math.ceil(s / m) for s in self.image_hw)

    def flop_counter(self):
        return PriorFlops(self.run.spec["config"], self.run.built_layouts, self.latent_hw(),
                          int(self.run.spec["traffic"]["batch"]))

    def flops(self, fl, first: int, stop: int) -> float:
        """Model FLOPs of the calls numbered first to stop - 1."""
        return fl.call() * (stop - first)


class PriorFlops:
    """FLOPs of one call, from the reference under FlopCounterMode on meta
    tensors: the tower over the batch's prompts (the empty prompt's
    conditioning is kept by the pipeline), then per step Stage C over the
    CFG pair's batch."""

    def __init__(self, config: dict, layouts: dict, latent_hw: tuple, batch: int):
        from bench_port.reference.flops import count

        meta = torch.device("meta")
        sizes = {p: config["parts"][p]["sizes"] for p in config["parts"]}
        P = {p: {n: torch.empty(s, device=meta) for n, s, _ in layouts[p]} for p in layouts}
        dz, tz = sizes["prior"], sizes["clip_g"]
        s = tz["context_length"]
        ids = torch.zeros(batch, s, dtype=torch.long, device=meta)
        mask = torch.ones(batch, s, dtype=torch.bool, device=meta)
        self.tower = count(lambda: ref.clip_text(P["clip_g"], tz, ids, mask))
        b2 = 2 * batch
        x = torch.zeros(b2, *latent_hw, dz["c_in"], device=meta)
        cond = (torch.zeros(b2, s, dz["c_clip_text"], device=meta),
                torch.zeros(b2, 1, dz["c_clip_text_pooled"], device=meta),
                torch.zeros(b2, 1, dz["c_clip_img"], device=meta))
        self.forward = count(lambda: ref.stage_c(P["prior"], dz, x, torch.zeros(b2, device=meta), *cond))
        self.steps = int(config["sample"]["steps"])

    def call(self) -> float:
        return float(self.tower + self.steps * self.forward)


def reference_weights(run, device) -> dict:
    """The seeded weights drawn again, as float32 (one part at a time)."""
    out = {}
    for part in run.builder.PARTS:
        sd = weights.regenerate(run.built_layouts[part], run.spec["config"]["parts"][part].get("init"), run.seed, part,
                                device)
        out[part] = {k: sd.pop(k).float() for k in list(sd)}
    return out


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def tokens(merges: list, prompts: list, device) -> tuple:
    """(ids, mask) from reference/text.py's BPE, padded with the EOT id."""
    bpe = ref_text.ClipBPE(merges)
    return ref.pad_with_eot(bpe(prompts).to(device), bpe.eot)


def forced(config: dict, sd: dict, kept: dict, device, control=None):
    """Per step i of a kept call, teacher-forced on the program's latents and
    conditioning: (i, the reference's eps of every image's CFG pair, the
    program's, or `control(x, r, *cond)`'s), rows as the program's: the
    images', then their unconditional sides."""
    sizes = config["parts"]["prior"]["sizes"]
    t = ref.schedule(kept["x"].shape[0]).to(device)
    cond = [torch.cat([c, u]).to(device)
            for c, u in zip(kept["cond"].tensors().values(), kept["uncond"].tensors().values())]
    for i in range(kept["x"].shape[0]):
        x = kept["x"][i].to(device)
        x2 = torch.cat([x, x])
        r2 = t[i].expand(x2.shape[0])
        want = ref.stage_c(sd["prior"], sizes, x2.float(), r2, *(c.float() for c in cond))
        got = kept["eps"][i].to(device) if control is None else control(x2, r2, *cond)
        yield i, want, got


def rows(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest relative gap of a row (an image) of a against b's."""
    return max(rel(x, y) for x, y in zip(a, b))


def mixed_step_gap(kept: dict, mixed: torch.Tensor, i: int, t: torch.Tensor, device) -> float:
    """The program's latents after step i against the reference's step from
    the program's latents and mixed eps, with the reference's z."""
    steps = kept["x"].shape[0]
    seeds = torch.tensor(kept["seeds"], dtype=torch.int64, device=device)
    z = ref.noise(seeds, tuple(kept["x"].shape[2:]), ref.STEP_TAG, i)
    nxt = (kept["x"][i + 1] if i + 1 < steps else kept["out"]).to(device)
    return rows(nxt, ref.ddpm_step(kept["x"][i].to(device), mixed, t[i], t[i + 1], z).to(nxt.dtype))


def check(config: dict, sd: dict, merges: list, kept: list, device, control=None) -> dict:
    """The numbers `correct` compares (see the module docstring). `control`
    (x, r, *cond) -> eps takes the program's place in the eps gaps (the
    control's readings); the step and the tower are then not compared."""
    tz = config["parts"]["clip_g"]["sizes"]
    guidance = float(config["sample"]["cfg"])
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gaps = dict.fromkeys(("eps_gap", "cfg_eps_gap", "step_gap", "clip_hidden_gap", "clip_pooled_gap"), 0.0)
    images = 0
    try:
        with torch.no_grad():
            for k in kept:
                b = len(k["prompts"])
                images += b
                if control is None:
                    ids, mask = tokens(merges, [*k["prompts"], ""], device)
                    hidden, pooled = ref.clip_text(sd["clip_g"], tz, ids, mask)
                    for c, want in ((k["cond"], slice(0, b)), (k["uncond"], [b] * b)):
                        gaps["clip_hidden_gap"] = max(gaps["clip_hidden_gap"], rows(c.clip_text, hidden[want]))
                        gaps["clip_pooled_gap"] = max(gaps["clip_pooled_gap"],
                                                      rows(c.clip_text_pooled[:, 0], pooled[want]))
                t = ref.schedule(k["x"].shape[0]).to(device)
                for i, want, got in forced(config, sd, k, device, control):
                    gaps["eps_gap"] = max(gaps["eps_gap"], rows(got, want))
                    mixed = ref.cfg_mix(got[:b], got[b:], guidance)
                    exact = ref.cfg_mix(want[:b], want[b:], guidance)
                    gaps["cfg_eps_gap"] = max(gaps["cfg_eps_gap"], rows(mixed, exact))
                    if control is None:
                        gaps["step_gap"] = max(gaps["step_gap"], mixed_step_gap(k, mixed, i, t, device))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    gaps["images_checked"] = images
    return gaps
