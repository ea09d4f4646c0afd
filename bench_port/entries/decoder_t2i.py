"""`CascadeDecoderPipeline.latents_to_images` at the mix's batch, closed
loop: each call a batch of prompts, one seed an image, and Stage C latents
drawn from those seeds on the card (N(0, 1) in bf16, one generator an
image), at the configuration's image size and steps; the images (B, H, W, 3)
on the device at its end (the call's work ends in a synchronize; no PNG).

Keeping a call for the check needs Stage B's input and output at each of
its steps, as entries/prior_t2l.py's Keeper takes them (hooks on the model,
the capture's buffers copied out after a kept call), the final latents
and Stage A's output before the clamp (both recorded at the decode), the
images, the Stage C latents and the pooled text feature the call used.
Which calls are kept: a reservoir of
check.calls calls seeded from --seed, plus the call with the longest prompt
so far. The check looks at every image of each kept call.

The check (reference/stage_b.py, float32, TF32 off, over weights drawn
again from the seed): the CLIP-bigG tower's pooled feature from the prompts
(tokenized by reference/text.py's BPE) against the program's
(`clip_pooled_gap`); at every step, teacher-forced on the program's own
latents and conditioning, Stage B's eps of each image (`eps_gap`); the
scheduler's step from the program's eps with the reference's z against the
program's next latent, both rounded to the model's dtype (`step_gap`);
Stage A: the program's decode of its final latents against the
reference's f32 decode of the same latents, before the clamp (seeded
weights drive the latents far past a trained Stage B's scale, so most
pixels clamp) and after it, the images (`image_gap`, the larger). Each gap
is relative: ||program - reference|| / ||reference|| of one image, the
largest over steps and images.
"""
from __future__ import annotations

import torch

from bench_port.core import cell, traffic
from bench_port.reference import stage_b as ref

PRIOR = cell.load_module(cell.BENCH / "entries" / "prior_t2l.py")
rows, tokens = PRIOR.rows, PRIOR.tokens


def stage_c_latents(seeds: list, hw: tuple, channels: int, device) -> torch.Tensor:
    """(B, h, w, channels) N(0, 1) in bf16, image i from a generator seeded
    with seeds[i]."""
    return torch.stack([torch.randn(*hw, channels, device=device,
                                    generator=torch.Generator(device=device).manual_seed(int(s)))
                        for s in seeds]).to(torch.bfloat16)


class Entry:
    def __init__(self, run):
        from paella_tpu_torch import DecoderSampleConfig

        self.run = run
        spec = run.spec
        s = spec["config"]["sample"]
        self.config = DecoderSampleConfig(steps=int(s["steps"]))
        self.image_hw, self.effnet_hw = tuple(s["image_hw"]), tuple(s["effnet_hw"])
        self.pipe = run.built["pipeline"]
        conditioning = run.spans.wrap("clip_text", self.pipe.conditioning)
        decode = self.pipe.vq.decode
        self._cond = self._latents = self._decoded = None

        def recorded(prompts):
            self._cond = conditioning(prompts)
            return self._cond

        def decoded(z):
            self._latents = z
            self._decoded = decode(z)
            return self._decoded

        self.pipe.conditioning = recorded
        self.pipe.vq.decode = decoded
        self.keeper = PRIOR.Keeper(self.pipe.model, int(spec["check"]["calls"]), run.seed)
        self.gen = traffic.generator(spec["traffic"], run.seed)

    def _call(self, prompts: list, seeds: list, kept=None) -> torch.Tensor:
        pairs = torch.tensor([[0, s & 0xFFFFFFFF] for s in seeds], dtype=torch.int64)
        effnet = stage_c_latents(seeds, self.effnet_hw, self.pipe.model.config.c_effnet, self.run.device)
        self.keeper.begin(kept is not None)
        out = self.pipe.latents_to_images(prompts, effnet, pairs, self.image_hw, self.config)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        self.keeper.end(self._latents, kept)
        if kept is not None:
            kept["effnet"], kept["images"], kept["decoded"] = effnet, out, self._decoded
        return out

    def warmup(self):
        """Prompts the traffic never sends, with seeds it does not draw: the
        kernels' build, the tower's and the decoder's captures, then a replay
        of each."""
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
            kept["pooled"] = self._cond
            self.keeper.keep(kept, slot, longest)
        return out.shape[0]

    def end_to_end(self, window_s: float, images: int) -> dict:
        return {"images_per_s": images / window_s}

    def release(self):
        self.keeper.captured.clear()
        self.pipe = None

    def check(self, device) -> dict:
        run = self.run
        return check(run.spec["config"], PRIOR.reference_weights(run, device), run.builder.synthetic_merges(),
                     self.keeper.checked(), device)

    def latent_hw(self) -> tuple:
        f = 2 * 2 ** (int(self.run.spec["config"]["parts"]["codec"]["sizes"]["levels"]) - 1)
        return self.image_hw[0] // f, self.image_hw[1] // f

    def probe(self):
        if self.run.device.type == "cuda":
            from bench_port.core.stage_b_roofline import probe_decoder

            probe_decoder(self.run, self.run.built["pipeline"].model, int(self.run.spec["traffic"]["batch"]),
                          self.latent_hw(), self.config.steps)

    def flop_counter(self):
        return DecoderFlops(self.run.spec["config"], self.run.built_layouts, self.latent_hw(), self.effnet_hw,
                            int(self.run.spec["traffic"]["batch"]))

    def flops(self, fl, first: int, stop: int) -> float:
        """Model FLOPs of the calls numbered first to stop - 1."""
        return fl.call() * (stop - first)


class DecoderFlops:
    """FLOPs of one call, from the reference under FlopCounterMode on meta
    tensors: the tower over the batch's prompts, Stage B per step over the
    batch, Stage A's decode of the batch."""

    def __init__(self, config: dict, layouts: dict, latent_hw: tuple, effnet_hw: tuple, batch: int):
        from bench_port.reference.flops import count

        meta = torch.device("meta")
        sizes = {p: config["parts"][p]["sizes"] for p in config["parts"]}
        P = {p: {n: torch.empty(s, device=meta) for n, s, _ in layouts[p]} for p in layouts}
        dz, tz, az = sizes["decoder"], sizes["clip_g"], sizes["codec"]
        s = tz["context_length"]
        ids = torch.zeros(batch, s, dtype=torch.long, device=meta)
        mask = torch.ones(batch, s, dtype=torch.bool, device=meta)
        self.tower = count(lambda: ref.clip_text(P["clip_g"], tz, ids, mask))
        x = torch.zeros(batch, *latent_hw, dz["c_in"], device=meta)
        clip = torch.zeros(batch, 1, dz["c_clip"], device=meta)
        eff = torch.zeros(batch, *effnet_hw, dz["c_effnet"], device=meta)
        self.forward = count(lambda: ref.stage_b(P["decoder"], dz, x, torch.zeros(batch, device=meta), clip, eff))
        self.decode = count(lambda: ref.stage_a_decode(P["codec"], az, x))
        self.steps = int(config["sample"]["steps"])

    def call(self) -> float:
        return float(self.tower + self.steps * self.forward + self.decode)


def step_gap(kept: dict, i: int, t: torch.Tensor, device) -> float:
    """The program's latents after step i against the reference's step from
    the program's latents and eps, with the reference's z, rounded to the
    model's dtype as the program rounds it (the final latents are kept as
    the decode's float32 copy)."""
    steps = kept["x"].shape[0]
    seeds = torch.tensor(kept["seeds"], dtype=torch.int64, device=device)
    z = ref.noise(seeds, tuple(kept["x"].shape[2:]), ref.STEP_TAG, i)
    nxt = (kept["x"][i + 1] if i + 1 < steps else kept["out"]).to(device)
    want = ref.ddpm_step(kept["x"][i].to(device), kept["eps"][i].to(device), t[i], t[i + 1], z)
    return rows(nxt, want.to(kept["x"].dtype))


def check(config: dict, sd: dict, merges: list, kept: list, device, control=None, decode=None) -> dict:
    """The numbers `correct` compares (see the module docstring). `control`
    (x, r, clip, effnet) -> eps takes the program's place in eps_gap and
    `decode` (latents) -> Stage A's output before the clamp its place in
    image_gap (the controls' readings); with either, the step and the tower
    are not compared."""
    dz, tz, az = (config["parts"][p]["sizes"] for p in ("decoder", "clip_g", "codec"))
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    gaps = dict.fromkeys(("eps_gap", "step_gap", "image_gap", "clip_pooled_gap"), 0.0)
    exact = control is None and decode is None
    images = 0
    try:
        with torch.no_grad():
            for k in kept:
                b = len(k["prompts"])
                images += b
                pooled, effnet = k["pooled"].to(device).float(), k["effnet"].to(device).float()
                if exact:
                    ids, mask = tokens(merges, k["prompts"], device)
                    want = ref.clip_text(sd["clip_g"], tz, ids, mask)[1]
                    gaps["clip_pooled_gap"] = max(gaps["clip_pooled_gap"], rows(pooled[:, 0], want))
                if decode is None or control is not None:
                    t = ref.schedule(k["x"].shape[0]).to(device)
                    for i in range(k["x"].shape[0]):
                        x, r = k["x"][i].to(device), t[i].expand(b)
                        want = ref.stage_b(sd["decoder"], dz, x.float(), r, pooled, effnet)
                        got = k["eps"][i].to(device) if control is None else control(x, r, k["pooled"], k["effnet"])
                        gaps["eps_gap"] = max(gaps["eps_gap"], rows(got, want))
                        if exact:
                            gaps["step_gap"] = max(gaps["step_gap"], step_gap(k, i, t, device))
                if control is None or decode is not None:
                    latents = k["out"].to(device)
                    want = ref.stage_a_decode(sd["codec"], az, latents)
                    got = k["decoded"].to(device) if decode is None else decode(latents)
                    gap = max(rows(got, want), rows(got.clamp(0.0, 1.0), want.clamp(0.0, 1.0)))
                    if decode is None:  # the pipeline's images are its decode, clamped
                        gap = max(gap, rows(k["images"].to(device), want.clamp(0.0, 1.0)))
                    gaps["image_gap"] = max(gaps["image_gap"], gap)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    gaps["images_checked"] = images
    return gaps
