"""Training: masked-token cross-entropy on the denoiser's training forward,
the counterpart of `paella_tpu/train/trainer.py` (reference:
src_distributed/train.py:33-189).

One step (`make_train_step`): per microbatch, conditioning dropout per
example, t ~ (t_min, 1], the frozen codec's encode (its nearest-code search
is kernel K4 on the card), Bernoulli(t) noising, `Paella.forward_train`, the
label-smoothed weighted cross-entropy and its backward; gradients averaged
over `grad_accum_steps` microbatches; then one `AdamW` update. The JAX step
takes a key and splits it; here every draw of a microbatch (`Draws`) can be
pinned from outside, and what is not pinned comes from the state's
`torch.Generator`, so a test can feed the JAX package's draws to this step.

On a CUDA device with one microbatch and no DDP or mesh, the loss and its
backward replay as one captured CUDA graph (`make_train_step`,
sampling/graph.py::train); the draws, the dropout masks and the optimizer
stay outside it.

Spans (utils/tracing.py): train.step, and under it per microbatch
train.encode (the frozen codec's encode), train.noise (conditioning
dropout, t, the noising and the loss weights), train.forward, train.loss
and train.backward, then train.allreduce (loss and acc over the ranks) and
train.optimizer (`AdamW.step` and the derived weights' drop); train.sync
covers each host read that waits for the device (the dropout seed drawn
when not pinned, AdamW's non-finite test and its clipping test). On the
graph's route a replay (train_graph.replay) takes the place of the
microbatch's spans, and its first step records them under
train_graph.capture.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..config import TrainConfig
from ..models.noise import add_noise, draw_noise, get_loss_weight
from ..nn.blocks import DropoutMasks
from ..sampling import graph
from ..utils import tracing


@dataclasses.dataclass
class Batch:
    """One training batch: images (B, H, W, 3) in [0, 1], NHWC, and the
    frozen encoders' conditioning; byt5_mask marks real (non-pad) tokens."""

    images: torch.Tensor
    byt5: torch.Tensor
    byt5_mask: torch.Tensor
    clip: torch.Tensor
    clip_image: torch.Tensor

    def split(self, n: int) -> List["Batch"]:
        """n microbatches along the batch axis, in order."""
        fields = (getattr(self, f.name) for f in dataclasses.fields(self))
        return [Batch(*parts) for parts in zip(*(t.chunk(n) for t in fields))]


BATCH_FIELDS = tuple(f.name for f in dataclasses.fields(Batch))


@dataclasses.dataclass
class NullCond:
    """The frozen encoders' embeddings of "" that conditioning dropout swaps
    in: byt5 (1, S0, D), byt5_mask (1, S0), clip (1, C)."""

    byt5: torch.Tensor
    byt5_mask: torch.Tensor
    clip: torch.Tensor


NULL_FIELDS = tuple(f.name for f in dataclasses.fields(NullCond))


@dataclasses.dataclass
class Draws:
    """The random draws of one microbatch's loss. A field left None is drawn
    from the step's generator, in this order: the three dropout coins, u, the
    noise mask, the noise ids, the dropout seed."""

    drop_byt5: Optional[torch.Tensor] = None  # (B,) bool: swap in the null ByT5 states
    drop_clip: Optional[torch.Tensor] = None  # (B,) bool: swap in the null CLIP text embedding
    drop_image: Optional[torch.Tensor] = None  # (B,) bool: mask the CLIP image tokens off
    u: Optional[torch.Tensor] = None  # (B,) U[0, 1): t = clip(1 - u + t_min, t_min, 1)
    noise_mask: Optional[torch.Tensor] = None  # (B, h, w) int, 1 = token replaced
    random_x: Optional[torch.Tensor] = None  # (B, h, w) replacement ids
    dropout_seed: Optional[int] = None  # Paella.forward_train's dropout seed


DRAW_TENSORS = ("drop_byt5", "drop_clip", "drop_image", "u", "noise_mask", "random_x")


class _SmoothedWeightedCE(torch.autograd.Function):
    """The loss of `smoothed_weighted_ce`. Its backward recomputes the
    softmax from the saved logits and log-sum-exp, one image at a time, so
    the only float32 tensor it keeps is (B, H, W), never (B, H, W, K): what
    jax.checkpoint buys the JAX loss."""

    @staticmethod
    def forward(ctx, logits, labels, weight, smoothing: float):
        lse = torch.empty(labels.shape, dtype=torch.float32, device=logits.device)
        loss = torch.empty_like(lse)
        for i in range(logits.shape[0]):
            x = logits[i].float()
            lse[i] = torch.logsumexp(x, dim=-1)
            nll = lse[i] - x.gather(-1, labels[i, ..., None])[..., 0]
            loss[i] = (1.0 - smoothing) * nll + smoothing * (lse[i] - x.mean(dim=-1))
        per_image = (loss * weight).sum(dim=(1, 2)) / weight.sum(dim=(1, 2))
        ctx.save_for_backward(logits, labels, weight, lse)
        ctx.smoothing = smoothing
        return per_image.mean()

    @staticmethod
    def backward(ctx, grad_out):
        logits, labels, weight, lse = ctx.saved_tensors
        s, b, k = ctx.smoothing, logits.shape[0], logits.shape[-1]
        # d loss / d x_k = coef * (softmax_k - (1 - s) [k = label] - s / K)
        coef = grad_out * weight / weight.sum(dim=(1, 2), keepdim=True) / b
        grad = torch.empty_like(logits)
        for i in range(b):
            g = torch.exp(logits[i].float() - lse[i, ..., None]) - s / k
            g.scatter_add_(-1, labels[i, ..., None], torch.full_like(lse[i, ..., None], -(1.0 - s)))
            grad[i] = g * coef[i, ..., None]
        return grad, None, None, None


def smoothed_weighted_ce(logits: torch.Tensor, labels: torch.Tensor, weight: torch.Tensor, smoothing: float) -> torch.Tensor:
    """CrossEntropyLoss(label_smoothing, reduction='none') over logits
    (B, H, W, K) in float32, normalized per image by its weights and averaged
    over images: ((loss * w).sum(H, W) / w.sum(H, W)).mean() (reference:
    src_distributed/train.py:106-107), in logsumexp form with no one-hot."""
    return _SmoothedWeightedCE.apply(logits, labels.long(), weight.float(), float(smoothing))


def _coin(p: float, b: int, generator, device) -> torch.Tensor:
    return torch.rand(b, generator=generator, device=device) < p


def _draw_coins(cfg: TrainConfig, draws: Draws, b: int, generator, device) -> None:
    if draws.drop_byt5 is None:
        draws.drop_byt5 = _coin(cfg.byt5_drop_prob, b, generator, device)
    if draws.drop_clip is None:
        draws.drop_clip = _coin(cfg.clip_text_drop_prob, b, generator, device)
    if draws.drop_image is None:
        draws.drop_image = _coin(cfg.clip_image_drop_prob, b, generator, device)


def noise_level(cfg: TrainConfig, u: torch.Tensor) -> torch.Tensor:
    """t = clip(1 - u + t_min, t_min, 1) (reference: src_distributed/train.py:99)."""
    return torch.clamp(1.0 - u + cfg.t_min, cfg.t_min, 1.0)


def draw_missing(cfg: TrainConfig, draws: Draws, latent_shape, num_labels: int, generator, device,
                 dtype: torch.dtype = torch.int32) -> None:
    """Fill every field of `draws` left None but the dropout seed from
    `generator`, in `Draws`' order: the three coins, u, the noise mask, the
    noise ids (over latents of `latent_shape`, ids of `dtype`). Both routes
    of a step draw through here, so they consume the same draws in the same
    order; the frozen encode between draws none."""
    _draw_coins(cfg, draws, latent_shape[0], generator, device)
    if draws.u is None:
        draws.u = torch.rand(latent_shape[0], generator=generator, device=device)
    if draws.noise_mask is None or draws.random_x is None:
        draws.noise_mask, draws.random_x = draw_noise(latent_shape, noise_level(cfg, draws.u), num_labels, generator,
                                                      draws.noise_mask, draws.random_x, dtype, device)


def _draw_dropout_seed(generator, device) -> int:
    """The last draw of `Draws`' order, read by the host."""
    with tracing.span("train.sync"):
        return int(torch.randint(0, 2**62, (1,), generator=generator, device=device).item())


def apply_cond_dropout(cfg: TrainConfig, batch: Batch, null: NullCond, draws: Draws, generator=None):
    """Per-example conditioning dropout (reference: src_distributed/train.py:79-97):
    the null ByT5 states (padded or cut to S) at byt5_drop_prob, the null
    CLIP text embedding at clip_text_drop_prob, the CLIP image tokens masked
    off at clip_image_drop_prob. Fills the coins of `draws` that are None.
    Returns (byt5, byt5_mask, clip, clip_image, clip_image_mask)."""
    _draw_coins(cfg, draws, batch.images.shape[0], generator, batch.images.device)
    s, s0 = batch.byt5.shape[1], null.byt5.shape[1]
    pad = max(0, s - s0)
    null_byt5 = F.pad(null.byt5, (0, 0, 0, pad))[:, :s].to(batch.byt5.dtype)
    null_mask = F.pad(null.byt5_mask, (0, pad))[:, :s]
    byt5 = torch.where(draws.drop_byt5[:, None, None], null_byt5, batch.byt5)
    byt5_mask = torch.where(draws.drop_byt5[:, None], null_mask, batch.byt5_mask)
    clip = torch.where(draws.drop_clip[:, None], null.clip.to(batch.clip.dtype), batch.clip)
    return byt5, byt5_mask, clip, batch.clip_image, ~draws.drop_image


def loss_fn(model, vq_model, cfg: TrainConfig, batch: Batch, null: NullCond, draws: Optional[Draws] = None,
            generator: Optional[torch.Generator] = None, forward: Optional[Callable] = None,
            dropout_masks: Optional[DropoutMasks] = None):
    """(loss, acc) of one microbatch, differentiable in the denoiser's
    parameters. The draws that `draws` did not pin are drawn
    (`draw_missing`, then the dropout seed) and written into it. `forward`
    runs the training forward in place of `model.forward_train` (a DDP
    wrapper of it, parallel/mesh.py). `dropout_masks` (the training graph's)
    supplies the dropout masks in place of the seed's."""
    draws = Draws() if draws is None else draws
    dev = batch.images.device
    with tracing.span("train.encode"):
        latents = vq_model.encode(batch.images)[2]  # frozen: encode runs under no_grad
    with tracing.span("train.noise"):
        draw_missing(cfg, draws, latents.shape, model.config.num_labels, generator, dev, latents.dtype)
        byt5, byt5_mask, clip, clip_image, clip_image_mask = apply_cond_dropout(cfg, batch, null, draws)
        t = noise_level(cfg, draws.u)
        noised, mask = add_noise(latents, t, model.config.num_labels, None, draws.noise_mask, draws.random_x)
        weight = get_loss_weight(t, mask, cfg.loss_weight_min)
    if draws.dropout_seed is None:
        draws.dropout_seed = _draw_dropout_seed(generator, dev)
    forward = model.forward_train if forward is None else forward
    with tracing.span("train.forward"):
        logits = forward(noised, t, byt5, clip, clip_image, byt5_mask=byt5_mask, clip_image_mask=clip_image_mask,
                         dropout_seed=draws.dropout_seed, dropout_masks=dropout_masks)
    with tracing.span("train.loss"):
        loss = smoothed_weighted_ce(logits, latents, weight, cfg.label_smoothing)
        acc = (logits.argmax(dim=-1) == latents).float().mean()
    return loss, acc


def graph_route(images: torch.Tensor, ddp=None, mesh=None, microbatches: int = 1) -> bool:
    """Whether a step takes the training graph (`make_train_step`): its
    batch on a CUDA device, no DDP wrapper, no mesh, one microbatch, and no
    capture under way on the current stream."""
    return (images.is_cuda and ddp is None and mesh is None and microbatches == 1
            and not torch.cuda.is_current_stream_capturing())


def _graph_step(model, vq_model, cfg: TrainConfig, batch: Batch, null: NullCond, draws: Draws, generator,
                params: list) -> tuple:
    """(loss, acc) of one microbatch with every parameter's .grad set,
    through the training graph (sampling/graph.py::train). Every unpinned
    draw is made here first, in `Draws`' order, the latents' shape from the
    codec's downscale; the graph reads them, and the dropout masks drawn
    from the seed before its replay, from its static buffers."""
    b, h, w = batch.images.shape[:3]
    f, dev = vq_model.config.downscale, batch.images.device
    draw_missing(cfg, draws, (b, h // f, w // f), model.config.num_labels, generator, dev)
    if draws.dropout_seed is None:
        draws.dropout_seed = _draw_dropout_seed(generator, dev)
    inputs = {**{f"batch.{k}": getattr(batch, k) for k in BATCH_FIELDS},
              **{f"null.{k}": getattr(null, k) for k in NULL_FIELDS}, **{k: getattr(draws, k) for k in DRAW_TENSORS}}

    def step(x: dict, masks: DropoutMasks) -> tuple:
        mb = Batch(*(x[f"batch.{k}"] for k in BATCH_FIELDS))
        nl = NullCond(*(x[f"null.{k}"] for k in NULL_FIELDS))
        d = Draws(*(x[k] for k in DRAW_TENSORS), dropout_seed=masks.seed)
        loss, acc = loss_fn(model, vq_model, cfg, mb, nl, d, dropout_masks=masks)
        with tracing.span("train.backward"):
            loss.backward()
        return loss.detach(), acc

    return graph.train(model, (id(vq_model), vq_model.config, graph.reads(vq_model), cfg), step, inputs,
                       draws.dropout_seed, params)


class AdamW(torch.optim.Optimizer):
    """The JAX package's `make_optimizer` as one torch optimizer, update for
    update optax's chain: clip_by_global_norm(grad_clip), then Adam (b1 0.9,
    b2 0.999, eps 1e-8 outside the square root, bias correction from the
    int count of applied updates), then decoupled weight decay 0.01 on every
    parameter, then -lr(count) with optax.linear_schedule(0, lr,
    warmup_updates): the first update has lr 0. Both moments are stored in
    `adam_moment_dtype`, the math is float32. Under skip_nonfinite_updates a
    step whose gradients are not all finite changes nothing, not even the
    count (optax.apply_if_finite), and `nonfinite_skips` counts it.

    `torch.optim.AdamW` cannot store bf16 moments with f32 math, nor skip a
    non-finite step. The count and skips live in each parameter group, so
    `state_dict()` carries them, and `load_state_dict` keeps the moments in
    `adam_moment_dtype` (torch's would cast them to the parameters' dtype)."""

    B1, B2, EPS, WEIGHT_DECAY = 0.9, 0.999, 1e-8, 0.01

    def __init__(self, params, cfg: TrainConfig):
        super().__init__(params, dict(count=0, nonfinite_skips=0, weight_decay=self.WEIGHT_DECAY))
        self.cfg = cfg
        self.moment_dtype = getattr(torch, cfg.adam_moment_dtype)

    def load_state_dict(self, state_dict: dict) -> None:
        super().load_state_dict(state_dict)
        for s in self.state.values():
            for k in ("mu", "nu"):
                s[k] = s[k].to(self.moment_dtype)

    @property
    def count(self) -> int:
        return self.param_groups[0]["count"]

    @property
    def nonfinite_skips(self) -> int:
        return self.param_groups[0]["nonfinite_skips"]

    def learning_rate(self, count: int) -> float:
        """optax.linear_schedule(0, lr, warmup_updates)(count), computed in
        float32 as optax computes it."""
        w = self.cfg.warmup_updates
        if w <= 0:  # optax: a constant schedule at its initial value
            return 0.0
        f32 = np.float32
        frac = f32(1) - f32(min(max(count, 0), w)) / f32(w)
        return float(f32(0.0 - self.cfg.lr) * frac + f32(self.cfg.lr))

    @torch.no_grad()
    def step(self, closure=None) -> dict:
        """One update from the parameters' .grad (None counts as zeros), in
        multi-tensor (`torch._foreach_*`) ops: a few launches for all
        parameters. Returns {"grad_norm": the gradients' global norm before
        clipping, "skipped": bool}.

        Over FSDP2's sharded parameters (DTensors) the update runs on each
        rank's local shards, and the norm and the non-finite test are the
        whole gradient's, the same on every rank (`_global_norm`)."""
        cfg = self.cfg
        params = [p for g in self.param_groups for p in g["params"]]
        grads = [_local(p.grad).float() if p.grad is not None else torch.zeros_like(_local(p), dtype=torch.float32)
                 for p in params]
        norm, nonfinite = _global_norm(params, grads)
        if cfg.skip_nonfinite_updates and nonfinite:
            for group in self.param_groups:
                group["nonfinite_skips"] += 1
            return {"grad_norm": norm, "skipped": True}
        with tracing.span("train.sync"):
            clip = not bool(norm < cfg.grad_clip)
        if clip:  # optax: g / norm * max_norm
            grads = torch._foreach_div(grads, norm)
            torch._foreach_mul_(grads, cfg.grad_clip)
        count = self.count + 1
        f32 = np.float32
        c1, c2 = float(f32(1) - f32(self.B1) ** count), float(f32(1) - f32(self.B2) ** count)
        for p in params:
            if not self.state[p]:
                self.state[p]["mu"] = torch.zeros_like(p, dtype=self.moment_dtype)
                self.state[p]["nu"] = torch.zeros_like(p, dtype=self.moment_dtype)
        stored = [_local(self.state[p]["mu"]) for p in params], [_local(self.state[p]["nu"]) for p in params]
        mu, nu = ([t.float() for t in ts] for ts in stored)  # no copy where the moments are float32
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.B1)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.B2)
        del grads
        den = torch._foreach_div(nu, c2)
        torch._foreach_sqrt_(den)
        torch._foreach_add_(den, self.EPS)
        upd = torch._foreach_div(mu, c1)
        torch._foreach_div_(upd, den)
        local = [_local(p) for p in params]
        i = 0
        for group in self.param_groups:
            n = len(group["params"])
            if group["weight_decay"]:
                torch._foreach_add_(upd[i:i + n], [p.float() for p in local[i:i + n]], alpha=group["weight_decay"])
            i += n
        torch._foreach_mul_(upd, -self.learning_rate(self.count))
        torch._foreach_add_(local, upd)
        if self.moment_dtype != torch.float32:
            torch._foreach_copy_(stored[0], mu)
            torch._foreach_copy_(stored[1], nu)
        for group in self.param_groups:
            group["count"] = count
        return {"grad_norm": norm, "skipped": False}


def _dtensor_type():
    """torch's DTensor class, or None where torch.distributed is not built."""
    if not torch.distributed.is_available():
        return None
    from torch.distributed.tensor import DTensor

    return DTensor


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard (a view: writing to it writes the shard), any
    other tensor itself."""
    dtensor = _dtensor_type()
    return t.to_local() if dtensor is not None and isinstance(t, dtensor) else t


def _global_norm(params: list, grads: list) -> tuple:
    """(the 2-norm of the whole gradient, whether any element of it is not
    finite) from `grads`, the local float32 gradients of `params`.

    Unsharded, the norm is the sum of the tensors' squared norms. Over
    DTensor parameters a rank's tensors are shards and torch._foreach_norm
    gives partial norms, so the squared norms are summed over every rank of
    the mesh, each shard counted once: a rank adds a shard only where its
    coordinate is 0 on every mesh axis that replicates it (HSDP's dp). The
    non-finite test counts every rank's shards, so a NaN or inf on one rank
    makes every rank skip."""
    sq = torch.stack(torch._foreach_norm(grads)).square()
    # NaN or inf where a gradient is; a rank's shard may be empty, which has no inf-norm
    peak = torch.stack(torch._foreach_norm([g for g in grads if g.numel()], float("inf")))
    dtensor = _dtensor_type()
    if dtensor is None or not any(isinstance(p, dtensor) for p in params):
        norm = sq.sum().sqrt()
        with tracing.span("train.sync"):
            return norm, not bool(torch.isfinite(peak).all())
    import torch.distributed as dist

    mesh = next(p.device_mesh for p in params if isinstance(p, dtensor))
    coord = mesh.get_coordinate()
    owned = torch.tensor([not isinstance(p, dtensor) or all(coord[d] == 0 for d, pl in enumerate(p.placements)
                                                            if not pl.is_shard()) for p in params], device=sq.device)
    sums = torch.stack([torch.where(owned, sq, 0.0).sum(), (~torch.isfinite(peak)).sum().float()])
    for d in range(mesh.ndim):
        dist.all_reduce(sums, group=mesh.get_group(d))
    norm = sums[0].sqrt()
    with tracing.span("train.sync"):
        return norm, bool(sums[1] > 0)


@dataclasses.dataclass
class TrainState:
    """The optimizer over the denoiser's parameters, the number of steps
    taken (skipped ones included, as the JAX TrainState counts them) and the
    generator of the draws that are not pinned."""

    optimizer: AdamW
    generator: torch.Generator
    step: int = 0


def create_train_state(model, cfg: TrainConfig, generator: Optional[torch.Generator] = None) -> TrainState:
    """AdamW over every parameter of `model`; the draws from `generator`,
    by default one on the model's device seeded with cfg.seed."""
    if generator is None:
        generator = torch.Generator(device=next(model.parameters()).device).manual_seed(cfg.seed)
    return TrainState(AdamW(model.parameters(), cfg), generator)


def _mean_over_ranks(t: torch.Tensor, group=None, mesh=None) -> torch.Tensor:
    """t averaged over the ranks of `group`, or of every axis of `mesh`
    (SUM, then a division: gloo has no AVG)."""
    import torch.distributed as dist

    t = t.clone()
    groups = [group] if mesh is None else [mesh.get_group(d) for d in range(mesh.ndim)]
    for g in groups:
        dist.all_reduce(t, group=g)
    return t / (dist.get_world_size(group) if mesh is None else mesh.size())


def make_train_step(model, vq_model, cfg: TrainConfig, ddp=None, mesh=None):
    """train_step(state, batch, null, draws=None) -> metrics: one optimizer
    update from grad_accum_steps microbatches (the batch split along its
    first axis), in place on the model and `state`. `draws` is one `Draws`
    per microbatch, or None to draw everything.
    Metrics: loss, acc (microbatch means), grad_norm (the averaged
    gradients' global norm before clipping) and, under
    skip_nonfinite_updates, nonfinite_skips.

    Two routes, chosen per step from what it can observe (`graph_route`):
    a batch on a CUDA device, with no ddp, no mesh, grad_accum_steps 1 and
    no capture under way, runs its loss and backward as one captured CUDA
    graph (sampling/graph.py::train): the benchmark's training cell,
    train/driver.py at world size 1 and examples/train_minimal.py take it.
    Every other step runs eagerly, op by op: the CPU, DDP, FSDP2 and
    gradient accumulation, whose hooks, reduce-scatters and per-microbatch
    buffers a graph's static buffers do not share. The graph's route draws
    every unpinned draw before its replay from the state's generator, in
    `Draws`' order (the numbers the eager route draws), and each dropout
    mask from the seed as the eager route does (nn/blocks.py::DropoutMasks);
    its first step for a signature runs eagerly, which is that step's
    answer, and captures the graph after. The update, the derived weights'
    drop and the metrics are eager on both routes; the metrics returned are
    the step's own tensors (clones of the graph's on a replay).

    After an update the model's derived weights are dropped
    (`DerivedWeights.drop_derived`), so an inference forward or a sampler
    graph that follows reads the new parameters; a skipped update changes
    nothing and drops nothing.

    ddp: a DistributedDataParallel wrapper of the model's training forward
    (parallel/mesh.py::data_parallel). Each rank then steps on its own
    batch, the gradients are averaged over the ranks (synchronized on the
    last microbatch only, under `no_sync` before it), and loss and acc are
    averaged over the ranks too, as the global batch's.

    mesh: the DeviceMesh of a model sharded by parallel/mesh.py::shard_model
    (FSDP2). Each rank steps on its own batch; every microbatch's backward
    reduce-scatters its gradients over the mesh, averaged, into the sharded
    gradient (memory: one gradient shard, never a whole unsharded gradient
    held across microbatches); HSDP's all-reduce over dp runs on the last
    microbatch only (`set_requires_all_reduce`). Loss and acc are averaged
    over every rank of the mesh."""
    n = max(1, cfg.grad_accum_steps)

    def train_step(state: TrainState, batch: Batch, null: NullCond, draws: Optional[Sequence[Draws]] = None) -> dict:
        draws = [Draws() for _ in range(n)] if draws is None else list(draws)
        if len(draws) != n:
            raise ValueError(f"train_step: {len(draws)} Draws for {n} microbatches")
        with tracing.span("train.step"):
            params = [p for g in state.optimizer.param_groups for p in g["params"]]
            for p in params:
                p.grad = None
            if graph_route(batch.images, ddp, mesh, n):
                loss, acc = _graph_step(model, vq_model, cfg, batch, null, draws[0], state.generator, params)
            else:
                loss, acc = _eager_step(model, vq_model, cfg, batch, null, draws, state.generator, params, ddp, mesh)
            with tracing.span("train.optimizer"):
                out = state.optimizer.step()
                if not out["skipped"]:
                    model.drop_derived()
        state.step += 1
        metrics = {"loss": loss, "acc": acc, "grad_norm": out["grad_norm"]}
        if cfg.skip_nonfinite_updates:
            metrics["nonfinite_skips"] = state.optimizer.nonfinite_skips
        return metrics

    return train_step


def _eager_step(model, vq_model, cfg: TrainConfig, batch: Batch, null: NullCond, draws: list, generator, params: list,
                ddp, mesh) -> tuple:
    """(loss, acc) over the microbatches with every parameter's .grad their
    mean gradient, op by op (see make_train_step)."""
    n = len(draws)
    loss = acc = 0.0
    for i, (mb, d) in enumerate(zip(batch.split(n) if n > 1 else [batch], draws)):
        if mesh is not None:
            model.set_requires_all_reduce(i == n - 1)
        with ddp.no_sync() if ddp is not None and i < n - 1 else contextlib.nullcontext():
            mb_loss, mb_acc = loss_fn(model, vq_model, cfg, mb, null, d, generator, forward=ddp)
            with tracing.span("train.backward"):
                mb_loss.backward()
        loss, acc = loss + mb_loss.detach(), acc + mb_acc
    if n > 1:
        for p in params:
            if p.grad is not None:
                p.grad.div_(n)
        loss, acc = loss / n, acc / n
    if ddp is not None or mesh is not None:
        group = ddp.process_group if ddp is not None else None
        with tracing.span("train.allreduce"):
            loss, acc = _mean_over_ranks(torch.stack([loss, acc]), group, mesh)
    return loss, acc
