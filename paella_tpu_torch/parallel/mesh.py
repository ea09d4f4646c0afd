"""Data parallelism and FSDP for training, the counterpart of
`paella_tpu/parallel/mesh.py`.

JAX shards the batch over a (dp, fsdp) mesh and lets GSPMD insert the
gradient reductions. Here the batch is split across processes (each rank
steps on its own batch, data/loader.py shards the input by rank). At
fsdp 1 DDP averages the gradients (`data_parallel`). At fsdp > 1
`shard_model` builds the same (dp, fsdp) mesh as a 2-D DeviceMesh and runs
FSDP2 (`fully_shard`) over it: replicated over dp, sharded over fsdp (HSDP
where dp > 1), each parameter along the axis the JAX FSDP rule picks
(`fsdp_param_spec`). FSDP2 cannot keep a parameter whole inside a unit, so
the parameters JAX replicates (fewer than `min_size` elements, no divisible
axis, the depthwise kernels) are sharded along axis 0 here: a difference of
layout only, since a unit gathers every parameter whole before it runs. The
GSPMD and tensor-parallel specs and the sharding constraints are TPU layout
and are not ported.
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


def fsdp_placement(shape: Sequence[int], fsdp_size: int):
    """The FSDP2 placement of a parameter of `shape` over an fsdp axis of
    `fsdp_size`: Shard(the axis fsdp_param_spec picks), and Shard(0) for a
    parameter JAX replicates (FSDP2 has no replicated parameter in a unit)."""
    from torch.distributed.tensor import Shard

    axis = fsdp_param_spec(shape, fsdp_size)
    return Shard(0 if axis is None else axis)


def fsdp_units(model: nn.Module) -> list:
    """The modules that become FSDP units of their own, innermost first:
    each block of the denoiser's `down_blocks` / `up_blocks`. Everything
    else (the mappers, the embedding, clf, out_mapper: modules whose
    parameters `forward_train` reads directly) stays in the root unit."""
    return [blk for levels in (model.down_blocks, model.up_blocks) for blocks in levels for blk in blocks]


def make_mesh(fsdp: int, world: Optional[int] = None, device_type: str = "cuda"):
    """The JAX driver's mesh (paella_tpu/parallel/mesh.py::make_mesh at tp
    1) over `world` ranks (default: the process group's size) as a 2-D
    DeviceMesh ("dp", "fsdp") of shape (world // fsdp, fsdp). Raises
    ValueError where fsdp does not divide the world, as make_mesh does."""
    from .distributed import process_count

    world = process_count() if world is None else world
    dp = world // fsdp if fsdp > 0 else 0
    if fsdp < 1 or dp * fsdp != world:
        raise ValueError(f"mesh {dp}x{fsdp} != {world} devices")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dp, fsdp), mesh_dim_names=("dp", "fsdp"))


def shard_model(model: nn.Module, fsdp: int):
    """Shard `model` (a Paella on its device, every rank of the process
    group calling this) with FSDP2 over `make_mesh(fsdp)` in place, and
    return the mesh. Pass it as `make_train_step(..., mesh=)`; build
    the optimizer after this call, over the sharded parameters.

    Rank 0's parameters and buffers are broadcast first (fully_shard shards
    whatever each rank holds; JAX's one PRNGKey init gives every process the
    same tree). Units: `fsdp_units`, then the root; placements:
    `fsdp_placement`. No mixed-precision policy: parameters gather and
    gradients reduce in float32, and `forward_train` casts to the compute
    dtype itself, as unsharded. `forward_train` is registered as a forward
    method of the root and of each unit that has one (the denoiser calls
    the blocks' `forward_train` directly, which would skip the gather), so
    remat's recompute gathers again too. The derived weights are dropped."""
    import torch.distributed as dist
    from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

    device = next(model.parameters()).device
    mesh = make_mesh(fsdp, device_type=device.type)
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            dist.broadcast(t, src=0)
    placement = lambda p: fsdp_placement(p.shape, fsdp)  # noqa: E731
    for unit in fsdp_units(model) + [model]:
        fully_shard(unit, mesh=mesh, shard_placement_fn=placement)
        if hasattr(unit, "forward_train"):
            register_fsdp_forward_method(unit, "forward_train")
    model.drop_derived()
    return mesh
