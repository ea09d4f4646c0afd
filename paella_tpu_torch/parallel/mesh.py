"""Data parallelism for training, the counterpart of the data axes of
`paella_tpu/parallel/mesh.py`.

JAX shards the batch over a (dp, fsdp) mesh and lets GSPMD insert the
gradient reductions. Here the batch is split across processes (each rank
steps on its own batch, data/loader.py shards the input by rank) and DDP
averages the gradients (`data_parallel`); FSDP's wrapping is the JAX FSDP
rule, a parameter of at least `min_size` elements sharded
(`fsdp_auto_wrap_policy`). The GSPMD and tensor-parallel specs and the
sharding constraints are TPU layout and are not ported.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

FSDP_MIN_SIZE = 2**14


class TrainForward(nn.Module):
    """The model's training forward (`forward_train`) as a module's forward,
    so a DDP wrapper runs its hooks around it."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, *args, **kwargs):
        return self.model.forward_train(*args, **kwargs)


def data_parallel(model: nn.Module, process_group=None, **ddp_kwargs):
    """DistributedDataParallel over `model`'s training forward, on the
    model's device (its card, or the CPU under gloo). DDP broadcasts rank
    0's parameters and buffers into every rank in place, so the model's
    derived weights are dropped after. Pass the result as
    `make_train_step(..., ddp=)`."""
    from torch.nn.parallel import DistributedDataParallel

    dev = next(model.parameters()).device
    ddp = DistributedDataParallel(
        TrainForward(model), device_ids=[dev.index] if dev.type == "cuda" else None,
        process_group=process_group, **ddp_kwargs,
    )
    if hasattr(model, "drop_derived"):
        model.drop_derived()
    return ddp


def fsdp_param_spec(shape: Sequence[int], fsdp_size: int, min_size: int = FSDP_MIN_SIZE) -> Optional[int]:
    """The JAX FSDP rule (paella_tpu/parallel/mesh.py::fsdp_param_spec) for
    a parameter of `shape`: the axis it is sharded along, the largest one
    the fsdp size divides (ties to the trailing axis), or None to replicate
    it (scalars, fewer than min_size elements, no divisible axis)."""
    numel = 1
    for d in shape:
        numel *= d
    if not shape or numel < min_size or fsdp_size <= 1:
        return None
    candidates = [d for d in range(len(shape)) if shape[d] % fsdp_size == 0 and shape[d] > 1]
    if not candidates:
        return None
    return max(candidates, key=lambda d: (shape[d], d))


def fsdp_auto_wrap_policy(min_size: int = FSDP_MIN_SIZE):
    """An `auto_wrap_policy` for torch's FullyShardedDataParallel: a module
    becomes its own FSDP unit where it holds (directly) a parameter of at
    least `min_size` elements, the parameters the JAX rule shards; smaller
    ones stay with their parent's unit."""

    def policy(module: nn.Module, recurse: bool, nonwrapped_numel: int) -> bool:
        if recurse:
            return True
        return any(p.numel() >= min_size for p in module.parameters(recurse=False))

    return policy
