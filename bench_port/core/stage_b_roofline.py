"""K1's and K5's rooflines in Stable Cascade's Stage B: the least time of a
decoder call's ResBlock and attention executions (a repeated level counted
once a run), and the names of the kernels each launches at those shapes,
learnt from direct calls in the run (as core/stage_c_roofline.py does for
Stage C's ResBlocks)."""
from __future__ import annotations

import torch

from . import roofline, trace
from .stage_c_roofline import resblock_bound_s

K1, K5 = "K1.d4", "K5.d4"


def attention_bound_s(b: int, n: int, s: int, h: int, d: int, itemsize: int = 2) -> float:
    """K5 on b x h heads of n queries over s keys at head dim d: q and the
    keys and values read once, the output written once; QK^T's and p.V's
    4 b h n s d operations at the bf16 peak."""
    nbytes = (2 * b * n * h * d + 2 * b * s * h * d) * itemsize
    return roofline.bound_s(nbytes, 4.0 * b * h * n * s * d, "bf16" if itemsize == 2 else "f32")


def executions(model, latent_hw: tuple):
    """(block, the next block, level size (h, w), runs a forward) of every
    block of Stage B, a repeated level's blocks once with its run count."""
    cfg = model.config
    n, p = len(cfg.c_hidden), cfg.patch_size
    for path, mappers in ((model.down_blocks, model.down_repeat_mappers), (model.up_blocks, model.up_repeat_mappers)):
        up = path is model.up_blocks
        for li, blocks in enumerate(path):
            i = n - 1 - li if up else li
            hw = (latent_hw[0] // p // 2**i, latent_hw[1] // p // 2**i)
            for j, blk in enumerate(blocks):
                yield blk, blocks[j + 1] if j + 1 < len(blocks) else None, hw, len(mappers[li]) + 1


def probe_decoder(run, model, batch: int, latent_hw: tuple, steps: int):
    """K1 and K5 for a decoder call of `batch` images: the kernel names of
    direct calls at every shape a forward runs, and the least time of the
    steps' ResBlock and attention executions."""
    from paella_tpu_torch.kernels.attention import fused_attention
    from paella_tpu_torch.kernels.resblock import fused_resblock
    from paella_tpu_torch.nn.blocks import AttnBlock, ResBlock, TimestepBlock

    dev, dt = run.device, model.config.compute_dtype
    size = torch.empty((), dtype=dt).element_size()
    seq = model.config.c_clip_seq
    k1 = k5 = 0.0
    res, att = {}, {}
    for blk, nxt, (hh, ww), runs in executions(model, latent_hw):
        if isinstance(blk, ResBlock):
            skip = blk.channelwise[0].in_features == 2 * blk.c
            film = isinstance(nxt, TimestepBlock)
            k1 += runs * resblock_bound_s(batch, hh, ww, blk.c, skip, film, size)
            res.setdefault((blk.c, hh, ww, skip, film), blk)
        elif isinstance(blk, AttnBlock):
            c = blk.attention.attn.c
            k5 += runs * attention_bound_s(batch, hh * ww, hh * ww + seq, blk.nhead, c // blk.nhead, size)
            att.setdefault((c, blk.nhead, hh * ww), blk)
    g = torch.Generator(device=dev).manual_seed(0)
    names = set()
    for (c, hh, ww, skip, film), blk in res.items():
        x = torch.randn(batch, hh, ww, c, generator=g, device=dev).to(dt)
        f = torch.randn(batch, 2 * c, generator=g, device=dev).to(dt) * 0.1 if film else None
        s = torch.randn(batch, hh, ww, c, generator=g, device=dev).to(dt) if skip else None
        w = blk.kernel_weights(model.config.act_quant)
        names |= trace.kernel_names(lambda: fused_resblock(x, w, film=f, skip=s), dev)
    run.kernel_names[K1], run.bound_per_call[K1] = names, steps * k1
    names = set()
    for (c, nh, tokens), blk in att.items():  # the model's layout: q|k|v of one product, the cond's k|v of another
        q, k, v = torch.randn(batch, tokens, 3 * c, generator=g, device=dev).to(dt).split(c, dim=-1)
        k2, v2 = torch.randn(batch, seq, 2 * c, generator=g, device=dev).to(dt).split(c, dim=-1)
        heads = [t.reshape(batch, t.shape[1], nh, c // nh) for t in (q, k, v, k2, v2)]
        names |= trace.kernel_names(lambda: fused_attention(*heads[:3], k2=heads[3], v2=heads[4]), dev)
    run.kernel_names[K5], run.bound_per_call[K5] = names, steps * k5
