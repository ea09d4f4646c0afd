"""Model FLOPs from the reference, counted once by
`torch.utils.flop_counter.FlopCounterMode` on meta tensors (shapes only,
nothing computed): products and convolutions as a plain implementation does
them, so neither padding nor any recomputation of the program counts.

ByT5 is exactly quadratic in the prompt's tokens and the denoiser exactly
affine in the conditioning length, so each is counted at three (two) lengths
and evaluated at the rest; the lengths counted are past a few tokens, where
torch's einsum takes the batched products it takes at every served length.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from . import codec, denoiser, text
from .nn import Params


T5_AT = (8, 16, 24)
DEN_AT = (8, 16)


def meta_params(layout: list) -> Params:
    return Params({n: torch.empty(s, device="meta", dtype=torch.float32) for n, s, _ in layout})


def count(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return int(fc.get_total_flops())


class ServeFlops:
    """FLOPs of text-to-image generations of one serving configuration."""

    def __init__(self, sizes: dict, layouts: dict, sample: dict):
        self.sizes, self.sample = sizes, sample
        P = {p: meta_params(layouts[p]) for p in layouts}
        meta = torch.device("meta")
        dz = sizes["denoiser"]
        f = 2 * 2 ** (sizes["codec"]["levels"] - 1)
        self.h, self.w = sample["image_hw"][0] // f, sample["image_hw"][1] // f
        t5 = [count(lambda n=n: text.t5_encode(P["byt5"], sizes["byt5"], torch.zeros(1, n, dtype=torch.long, device=meta)))
              for n in T5_AT]
        self.t5_coef = np.polyfit(T5_AT, t5, 2)
        self.clip = count(lambda: text.clip_text(P["clip_text"], sizes["clip_text"],
                                                 torch.zeros(1, 77, dtype=torch.long, device=meta)))
        x = torch.zeros(1, self.h, self.w, dtype=torch.long, device=meta)
        r = torch.zeros(1, device=meta)

        def den(s):
            ce = torch.zeros(1, s, dz["c_cond"], device=meta)
            mask = torch.ones(1, s, dtype=torch.bool, device=meta)
            return count(lambda: denoiser.features(P["denoiser"], dz, x, r, ce, mask))

        d1, d2 = den(DEN_AT[0]), den(DEN_AT[1])
        self.den_b = (d2 - d1) / (DEN_AT[1] - DEN_AT[0])
        self.den_a = d1 - self.den_b * DEN_AT[0]
        self.head = count(lambda: denoiser.head(P["denoiser"], torch.zeros(1, self.h, self.w, dz["c_out"], device=meta)))
        self.decode = count(lambda: codec.decode_indices(P["codec"], sizes["codec"], x))
        self.mapper = count(lambda: denoiser.cond_embedding(
            P["denoiser"], dz, torch.zeros(1, 1, dz["byt5_embd"], device=meta), torch.ones(1, 1, dtype=torch.bool, device=meta),
            torch.zeros(1, dz["clip_embd"], device=meta)))

    def t5(self, n: int) -> float:
        return float(np.polyval(self.t5_coef, n))

    def denoiser(self, s: int) -> float:
        return self.den_a + self.den_b * s

    def generation(self, prompts: list) -> float:
        """One call: the prompts' encodes (the empty prompt's is kept by the
        pipeline), then per step the CFG pair's forwards and the head, and
        each image's decode."""
        steps, clip_seq = self.sample["steps"], self.sizes["denoiser"]["clip_seq_len"]
        total = 0.0
        for p in prompts:
            n = len(p.encode()) + 1
            total += self.t5(n) + self.clip + self.mapper
            total += steps * (self.denoiser(n + clip_seq) + self.denoiser(1 + clip_seq) + self.head)
            total += self.decode
        return total


class TrainFlops:
    """FLOPs of one training step: the frozen encode's forward, and the
    denoiser's forward and backward at the step's batch (no recomputation)."""

    def __init__(self, sizes: dict, layouts: dict, mix: dict, latent_hw: tuple):
        meta = torch.device("meta")
        dz = sizes["denoiser"]
        b, s = int(mix["images"]), int(mix["byt5_len"])
        P = Params({n: torch.empty(sh, device=meta, dtype=torch.float32, requires_grad=True)
                    for n, sh, _ in layouts["denoiser"]})
        Pc = meta_params(layouts["codec"])
        c_latent = sizes["codec"]["c_latent"]
        images = torch.zeros(b, mix["image_hw"], mix["image_hw"], 3, device=meta)
        self.encode = count(lambda: codec.encode_indices(Pc, sizes["codec"], images, torch.zeros(c_latent, device=meta),
                                                         torch.ones(c_latent, device=meta)))

        def fwd_bwd():
            x = torch.zeros(b, *latent_hw, dtype=torch.long, device=meta)
            byt5 = torch.zeros(b, s, dz["byt5_embd"], device=meta)
            clip = torch.zeros(b, dz["clip_embd"], device=meta)
            mask = torch.ones(b, s, dtype=torch.bool, device=meta)
            ce, cm = denoiser.cond_embedding(P, dz, byt5, mask, clip, None, clip, None)
            logits = denoiser.head(P, denoiser.features(P, dz, x, torch.zeros(b, device=meta), ce, cm))
            logits.float().logsumexp(-1).sum().backward()

        with FlopCounterMode(display=False) as fc:
            fwd_bwd()
        by_op = {str(k): v for k, v in fc.get_flop_counts()["Global"].items()}
        # FlopCounterMode's convolution_backward counts a grouped (depthwise)
        # convolution as if it were dense; its backward is two products of
        # the forward's cost (input and weight gradients)
        conv_bwd = by_op.get("aten.convolution_backward.default", by_op.get("aten.convolution_backward", 0))
        conv_fwd = by_op.get("aten.convolution.default", by_op.get("aten.convolution", 0))
        self.denoiser = int(fc.get_total_flops()) - conv_bwd + 2 * conv_fwd

    def step(self) -> float:
        return float(self.encode + self.denoiser)
