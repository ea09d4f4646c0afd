"""Kernel rooflines: which kernels are a port kernel's is learnt in the run,
from a direct call of the port's entry for it, profiled; their device time
in the slice is then set against the least time of the work the slice did."""
from __future__ import annotations

import torch

from . import roofline, trace


def share(run, key: str):
    names = run.kernel_names.get(key)
    t = run.trace
    if not names or t is None or not run.slice_calls or key not in run.bound_per_call:
        return None
    seconds = sum(t["kernels"][n][0] for n in names if n in t["kernels"])
    if seconds <= 0:
        return None
    return run.slice_calls * run.bound_per_call[key] / seconds * 100.0


def probe_sampler(run, model, batch: int, latent_hw: tuple, steps: int, cfg_pairs: bool = True):
    """K1 and K3 for a sampler call of `batch` images: their kernel names
    from direct calls at every shape the call runs, and the least time of
    one sampler call's work."""
    from paella_tpu_torch.kernels.resblock import fused_resblock
    from paella_tpu_torch.kernels.sampling import gumbel_categorical
    from paella_tpu_torch.nn.blocks import ResBlock, TimestepBlock

    dev, dt = run.device, model.config.compute_dtype
    cfg = model.config
    rows = batch * (2 if cfg_pairs else 1)
    p = cfg.patch_size
    bound, seen, names = 0.0, {}, set()
    for levels, up in ((model.down_blocks, False), (model.up_blocks, True)):
        n = len(levels)
        for li, blocks in enumerate(levels):
            i = n - 1 - li if up else li
            hh, ww = latent_hw[0] // p // 2**i, latent_hw[1] // p // 2**i
            for j, blk in enumerate(blocks):
                if not isinstance(blk, ResBlock):
                    continue
                skip = blk.depthwise.weight.shape[1] == 2
                film = j + 1 < len(blocks) and isinstance(blocks[j + 1], TimestepBlock)
                bound += roofline.resblock_bound_s(rows, hh, ww, blk.c, skip, film, torch.empty((), dtype=dt).element_size())
                seen.setdefault((blk.c, hh, ww, skip, film), blk)
    g = torch.Generator(device=dev).manual_seed(0)
    for (c, hh, ww, skip, film), blk in seen.items():
        x = torch.randn(rows, hh, ww, c, generator=g, device=dev).to(dt)
        f = torch.randn(rows, 2 * c, generator=g, device=dev).to(dt) * 0.1 if film else None
        s = torch.randn(rows, hh, ww, c, generator=g, device=dev).to(dt) if skip else None
        w = blk.kernel_weights()
        names |= trace.kernel_names(lambda: fused_resblock(x, w, film=f, skip=s), dev)
    run.kernel_names["K1"] = names
    run.bound_per_call["K1"] = steps * bound

    k = cfg.num_labels
    logits = torch.randn(batch, latent_hw[0], latent_hw[1], k, generator=g, device=dev).to(dt)
    seeds = torch.zeros(batch, 2, dtype=torch.int64, device=dev)
    temp = torch.tensor(0.7, dtype=torch.float32, device=dev)
    run.kernel_names["K3"] = trace.kernel_names(lambda: gumbel_categorical(seeds, logits, temp), dev)
    run.bound_per_call["K3"] = steps * roofline.gumbel_bound_s(batch * latent_hw[0] * latent_hw[1], k,
                                                               torch.empty((), dtype=dt).element_size())
