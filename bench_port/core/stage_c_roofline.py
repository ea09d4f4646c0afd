"""K1's roofline in Stable Cascade's Stage C: the least time of its ResBlock
calls, the channelwise-skip call among them, and the names of the kernels K1
launches at those shapes, learnt from direct calls in the run (as
core/kernels.py does for Paella's calls)."""
from __future__ import annotations

import torch

from . import roofline, trace

KEY = "K1.c4"


def resblock_bound_s(b: int, h: int, w: int, c: int, skip: bool, film: bool, itemsize: int = 2) -> float:
    """K1 on x (b, h, w, c) with Stage C's skip, joined into fc1 (K = 2c):
    x, skip and FiLM read and the output written once; the weights read once
    (depthwise (9c + c), fc1 (4c * k + 4c) with k = 2c with the skip else c,
    GRN (8c), fc2 (c * 4c + c), the fc2 beta product (c) in f32); the two
    products' 2 m (k 4c + 4c c) operations at the bf16 peak."""
    m = b * h * w
    k = 2 * c if skip else c
    act = m * c * itemsize * (2 + (1 if skip else 0)) + (b * 2 * c * itemsize if film else 0)
    weights = (9 * c + c + 4 * c * k + 4 * c + 8 * c + 4 * c * c + c) * itemsize + c * 4
    return roofline.bound_s(act + weights, 2.0 * m * (k * 4 * c + 4 * c * c), "bf16" if itemsize == 2 else "f32")


def probe_prior(run, model, batch: int, latent_hw: tuple, steps: int):
    """K1 for a prior call of `batch` images (CFG pairs: 2 x batch rows):
    the kernel names of a direct call at every shape a forward runs, and the
    least time of the steps' ResBlock calls."""
    from paella_tpu_torch.kernels.resblock import fused_resblock
    from paella_tpu_torch.nn.blocks import ResBlock, TimestepBlock

    dev, dt = run.device, model.config.compute_dtype
    rows = 2 * batch
    hh, ww = latent_hw
    bound, seen, names = 0.0, {}, set()
    for blocks in (*model.down_blocks, *model.up_blocks):
        for j, blk in enumerate(blocks):
            if isinstance(blk, ResBlock):
                skip = blk.channelwise[0].in_features == 2 * blk.c
                film = j + 1 < len(blocks) and isinstance(blocks[j + 1], TimestepBlock)
                bound += resblock_bound_s(rows, hh, ww, blk.c, skip, film, torch.empty((), dtype=dt).element_size())
                seen.setdefault((blk.c, skip, film), blk)
    g = torch.Generator(device=dev).manual_seed(0)
    for (c, skip, film), blk in seen.items():
        x = torch.randn(rows, hh, ww, c, generator=g, device=dev).to(dt)
        f = torch.randn(rows, 2 * c, generator=g, device=dev).to(dt) * 0.1 if film else None
        s = torch.randn(rows, hh, ww, c, generator=g, device=dev).to(dt) if skip else None
        w = blk.kernel_weights(model.config.act_quant)
        names |= trace.kernel_names(lambda: fused_resblock(x, w, film=f, skip=s), dev)
    run.kernel_names[KEY] = names
    run.bound_per_call[KEY] = steps * bound
