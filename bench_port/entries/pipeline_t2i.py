"""`PaellaPipeline.text_to_image` at the mix's batch, closed loop: each call
a batch of prompts and one seed an image, the (B, H, W, 3) images on the
device at its end (the call's work ends in a synchronize).

check.calls is the reservoir's size: every image of the kept calls is
checked.
"""
from __future__ import annotations

import torch

from bench_port.core import serving, traffic


class Entry(serving.ServingEntry):
    def __init__(self, run):
        from paella_tpu_torch import SampleConfig

        super().__init__(run)
        s = self.sample_cfg
        self.config = SampleConfig(steps=s["steps"], cfg=s["cfg"], temperature=tuple(s["temperature"]),
                                   categorical_impl=s["categorical_impl"])

    def _call(self, prompts, seeds):
        pairs = torch.tensor([[0, s & 0xFFFFFFFF] for s in seeds], dtype=torch.int64)
        out = self.pipe.text_to_image(prompts, pairs, self.image_hw, self.config)
        if out.is_cuda:
            torch.cuda.synchronize(out.device)
        return out

    def warmup(self):
        """The mix's own prompts (so the text cache holds them, as it does
        for every later call) with seeds the traffic does not draw: the
        graph's capture, then a replay."""
        call = traffic.generator(self.run.spec["traffic"], self.run.seed).next()
        for i in range(2):
            self._call(call["prompts"], [7 + i] * len(call["prompts"]))

    def step(self, i: int) -> int:
        call = self.gen.next()
        self.calls.append(call)
        slot, longest = self.rec.wants(call["prompts"])
        kept = None
        if slot is not None or longest:
            kept = serving.Kept(call["prompts"], [(0, s & 0xFFFFFFFF) for s in call["seeds"]])
        self._current = kept
        with self.run.spans("request"):
            images = self._call(call["prompts"], call["seeds"])
        self._current = None
        if kept is not None:
            kept.images = [im for im in images]
            self.rec.keep(kept, slot, longest)
        return images.shape[0]

    def end_to_end(self, window_s: float, images: int) -> dict:
        return {"images_per_s": images / window_s}
