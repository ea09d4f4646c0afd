"""`PaellaServer.generate` in process (no socket): one client in a closed
loop, each request a prompt and a seed, the PNG bytes in hand at its end.

Cell parameters: max_batch (the server's); check.calls is the reservoir's
size. The configuration's `sample` gives steps, cfg and the image size.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from bench_port.core import serving
from bench_port.core.stats import percentile


class Entry(serving.ServingEntry):
    def __init__(self, run):
        from paella_tpu_torch.serve import PaellaServer

        super().__init__(run)
        self.server = PaellaServer(self.pipe, host="127.0.0.1", port=0,
                                   max_batch=int(run.spec["params"]["max_batch"]))
        self.latencies: list = []

    def _request(self, prompt: str, seed: int) -> bytes:
        h, w = self.image_hw
        return self.server.generate({"prompt": prompt, "seed": seed, "steps": self.sample_cfg["steps"],
                                     "cfg": self.sample_cfg["cfg"], "height": h, "width": w})

    def warmup(self):
        """One request in each ByT5 bucket the mix's prompt lengths reach,
        with prompts the traffic never sends: builds the kernels, fills the
        null conditioning and captures each bucket's sampler graph."""
        from paella_tpu_torch.cond.tokenizers import pad_bucket

        mix = self.run.spec["traffic"]["prompt_bytes"]
        sizes = {}
        for n in range(int(mix["min"]), int(mix["max"]) + 1):
            sizes.setdefault(pad_bucket(n + 1), n)
        for i, n in enumerate(sorted(sizes.values())):
            for _ in range(2):  # the graph's capture, then a replay
                self._request(("warmup " * 64)[:n], 1000 + i)

    def step(self, i: int) -> int:
        call = self.gen.next()
        self.calls.append(call)
        prompt, seed = call["prompts"][0], call["seeds"][0]
        slot, longest = self.rec.wants([prompt])
        kept = serving.Kept([prompt], [(0, seed & 0xFFFFFFFF)]) if (slot is not None or longest) else None
        self._current = kept
        t0 = time.perf_counter()
        with self.run.spans("request"):
            png = self._request(prompt, seed)
        self.latencies.append(time.perf_counter() - t0)
        self._current = None
        if kept is not None:
            from paella_tpu_torch.serve import png_pixels

            kept.images = [torch.from_numpy(png_pixels(png))]
            self.rec.keep(kept, slot, longest)
        return 1

    def end_to_end(self, window_s: float, images: int) -> dict:
        ms = np.asarray(self.latencies) * 1e3
        return {"latency_p50_ms": percentile(ms, 50), "latency_p95_ms": percentile(ms, 95),
                "images_per_s": images / window_s}

    def release(self):
        super().release()
        self.server = None
