"""Training driver: the end-to-end loop the reference runs per GPU process
(reference: src_distributed/train.py:33-189), the counterpart of
`paella_tpu/train/driver.py`.

Per iteration: fetch a batch, run the frozen conditioning encoders
(`encode_batch`), take one train step (train/trainer.py: the frozen codec's
encode, noising, the training forward and backward, AdamW); every
`log_every` steps a JSONL metric line; every `eval_every` steps a checkpoint
and the eval grid (five rows of images decoded through the codec); a
checkpoint at `total_steps` and on SIGTERM / SIGINT. A run whose workdir
holds a checkpoint resumes from its latest step: parameters, optimizer
moments and count, step and the draw generator's state.

Several processes: call `parallel.initialize_distributed` first; each rank
then steps on its own batch (data/loader.py shards the input by rank), and
only rank 0 writes checkpoints, metrics and eval images. At
`DriverConfig.fsdp` 1 DDP averages the gradients
(parallel/mesh.py::data_parallel). At fsdp > 1 the model is sharded with
FSDP2 over the JAX driver's (dp, fsdp) mesh (parallel/mesh.py::shard_model,
HSDP where dp > 1) and AdamW updates the shards. A checkpoint then holds the
whole state, gathered onto rank 0's CPU: one file, the same at every world
size, so a run resumes at another world size or fsdp. Rank 0 draws the eval
grid from a plain inference copy of the model loaded from that gathered
state.

Besides the step metrics, metrics.jsonl gets a record with the seconds of
each checkpoint write (`checkpoint_s`), eval grid (`eval_s`) and restore
(`restore_s`), host clock, under the step they belong to.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from ..config import SampleConfig, TrainConfig
from ..data.prefetch import map_tensors, background_iterator
from ..kernels.quantize import fused_codebook_lookup
from ..models.denoiser import Paella
from ..models.noise import add_noise
from ..parallel.distributed import is_main_process, process_count, process_index
from ..parallel.mesh import data_parallel, shard_model
from ..sampling.sampler import Conditioning, derive_seeds, sample
from ..utils.logging import MetricLogger, StepTimer, save_image_grid
from .checkpoints import CheckpointManager
from .trainer import Batch, NullCond, TrainState, _dtensor_type, _local, create_train_state, make_train_step

EncodeFn = Callable[[np.ndarray, Sequence[str]], Batch]
EVAL_SEED_TAG = 4  # derive_seeds' draw tag of the eval grid's per-image seeds (the sampler uses 0-3)


@dataclasses.dataclass
class DriverConfig:
    workdir: str = "runs/paella"
    total_steps: int = 1_500_000  # reference: updates=1.5M (src_distributed/train.py:14)
    log_every: int = 50
    eval_every: int = 2000  # reference: print_every (src_distributed/train.py:19)
    eval_prompts: Tuple[str, ...] = (
        "a photo of a corgi wearing a top hat",
        "an oil painting of a lighthouse in a storm",
    )
    eval_steps: int = 8
    fsdp: int = 1
    max_keep: int = 3
    # save a final checkpoint and return cleanly on SIGTERM/SIGINT (the
    # reference loses up to print_every=2000 steps of work on preemption;
    # here at most one step)
    graceful_preemption: bool = True
    # overlap the NEXT batch's conditioning encodes with the current train
    # step: a producer thread pulls batch N+1 and runs the frozen encoders
    # while step N runs. 0 = synchronous. The role torch DataLoader workers
    # play for the reference (src_distributed/utils.py:62), extended to the
    # encoders.
    encode_prefetch: int = 1


class _PreemptionGuard:
    """Converts SIGTERM/SIGINT into a cooperative stop flag for the training
    loop: the loop checks `stop_requested` each iteration, saves a final
    checkpoint, and returns. A SECOND signal restores the previous handler
    and re-delivers, so a stuck step (a blocked data iterator) can still be
    killed with a repeated Ctrl-C/SIGTERM instead of requiring SIGKILL.
    No-ops when not on the main thread (signal.signal raises there)."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.stop_requested = False
        self._prev = {}

    def __enter__(self):
        if not self.enabled:
            return self
        import signal

        def handler(signum, frame):
            if self.stop_requested:  # second signal: give up on gracefulness
                signal.signal(signum, self._prev.get(signum, signal.SIG_DFL))
                os.kill(os.getpid(), signum)
                return
            self.stop_requested = True
            print(f"[driver] caught signal {signum}: finishing step, saving, exiting")

        try:
            for sig in (signal.SIGTERM, signal.SIGINT):
                self._prev[sig] = signal.signal(sig, handler)
        except ValueError:  # not the main thread
            self._prev = {}
        return self

    def __exit__(self, *exc):
        import signal

        for sig, prev in self._prev.items():
            signal.signal(sig, prev)
        return False


def _sharded(model) -> bool:
    """Whether `model`'s parameters are FSDP2 shards (DTensors)."""
    dtensor = _dtensor_type()
    return dtensor is not None and any(isinstance(p, dtensor) for p in model.parameters())


def checkpoint_state(model, state: TrainState, group=None) -> dict:
    """What a checkpoint holds: the model's state dict, the AdamW state dict
    (moments in their own dtype; count and skips in its param groups), the
    step, the draw generator's state and, over several ranks, every rank's
    generator state (a collective: every rank calls this).

    A sharded model's parameters and moments are gathered whole onto rank
    0's CPU (get_model_state_dict with full_state_dict and cpu_offload, and
    each moment's full_tensor in parameter order); the other ranks' dicts
    hold no tensors. The keys, shapes and dtypes are those of the unsharded
    model's and optimizer's state dicts."""
    if _sharded(model):
        from torch.distributed.checkpoint.state_dict import StateDictOptions, get_model_state_dict

        weights = get_model_state_dict(model, options=StateDictOptions(full_state_dict=True, cpu_offload=True))
        optimizer = state.optimizer.state_dict()
        main, dtensor = is_main_process(), _dtensor_type()
        whole = lambda v: v.full_tensor() if isinstance(v, dtensor) else v  # noqa: E731
        gathered = {i: {k: whole(v) for k, v in s.items()} for i, s in optimizer["state"].items()}
        optimizer["state"] = {i: {k: v.cpu() for k, v in s.items()} for i, s in gathered.items()} if main else {}
    else:
        weights, optimizer = model.state_dict(), state.optimizer.state_dict()
    out = {"model": weights, "optimizer": optimizer, "step": state.step, "generator": state.generator.get_state()}
    if process_count() > 1:
        import torch.distributed as dist

        gens = [None] * dist.get_world_size(group)
        dist.all_gather_object(gens, out["generator"], group=group)
        out["generators"] = gens
    return out


def load_state(model, state: TrainState, saved: dict) -> None:
    """Load a `checkpoint_state` dict into the model and the train state in
    place, whatever world size wrote it: into a sharded model each rank
    takes its shards of the whole tensors (set_model_state_dict; the moments
    by distribute_tensor on the parameters' placements, no communication).
    This rank's generator state where the writer saved one for it, else
    the saved generator's (a resume at another world size is then not bit
    for bit in its draws)."""
    optimizer = saved["optimizer"]
    if _sharded(model):
        from torch.distributed.checkpoint.state_dict import StateDictOptions, set_model_state_dict
        from torch.distributed.tensor import distribute_tensor

        set_model_state_dict(model, saved["model"], options=StateDictOptions(full_state_dict=True))
        params = [p for g in state.optimizer.param_groups for p in g["params"]]
        shard = lambda p, v: distribute_tensor(v.to(_local(p).device), p.device_mesh, p.placements,  # noqa: E731
                                               src_data_rank=None)
        optimizer = dict(optimizer, state={i: {k: shard(params[i], v) for k, v in s.items()}
                                           for i, s in optimizer["state"].items()})
    else:
        model.load_state_dict(saved["model"])
    state.optimizer.load_state_dict(optimizer)
    state.step = int(saved["step"])
    gens = saved.get("generators")
    state.generator.set_state(gens[process_index()] if gens and len(gens) > process_index() else saved["generator"])


def restore_checkpoint(ckpt: CheckpointManager, model, state: TrainState, step: Optional[int] = None) -> bool:
    """Load `step` (default: the latest) of `ckpt` into the model and the
    train state in place (`load_state`). Returns False when there is no
    checkpoint."""
    saved, _ = ckpt.restore(None, step=step)
    if saved is None:
        return False
    load_state(model, state, saved)
    return True


def inference_copy(model, weights: dict, copy: Optional[Paella] = None) -> Paella:
    """A plain (unsharded) Paella of `model`'s config on its device, holding
    `weights` (a whole state dict): `copy` reloaded, or a new one built on
    the meta device and materialized there. Loading drops the copy's derived
    weights, so the sampler's kept graphs of it recapture (C6)."""
    if copy is None:
        with torch.device("meta"):
            copy = Paella(model.config)
        copy = copy.to_empty(device=_local(next(model.parameters())).device)
    copy.load_state_dict(weights)
    return copy


def run_training(
    model,
    vq,
    data_iter: Iterator[Tuple[np.ndarray, Sequence[str]]],
    encode_batch: EncodeFn,
    null_cond: NullCond,
    train_cfg: TrainConfig = TrainConfig(),
    driver_cfg: DriverConfig = DriverConfig(),
    sample_eval: bool = True,
    process_group=None,
) -> TrainState:
    """Run (or resume) training of `model` (a Paella on its device) with the
    frozen codec `vq`. Returns the final TrainState.

    data_iter yields (images NHWC [0,1] numpy, captions); encode_batch runs
    the frozen conditioning encoders (ByT5/CLIP) and assembles a Batch.
    With a torch.distributed process group up (or `process_group` given) of
    more than one rank, the step runs under DDP over that group; at
    driver_cfg.fsdp > 1 under FSDP2 over the whole process group instead
    (`shard_model`, which raises ValueError where fsdp does not divide the
    world size).
    """
    workdir = driver_cfg.workdir
    os.makedirs(workdir, exist_ok=True)
    main = is_main_process()
    device = next(model.parameters()).device
    world = process_count()
    mesh = None
    if driver_cfg.fsdp > 1:
        if process_group is not None:
            raise ValueError("run_training: FSDP (driver_cfg.fsdp > 1) shards over the whole process group; "
                             "process_group is DDP's")
        mesh = shard_model(model, driver_cfg.fsdp)
    logger = MetricLogger(workdir, print_every=driver_cfg.log_every) if main else None
    ckpt = CheckpointManager(
        os.path.join(workdir, "checkpoints"),
        max_to_keep=driver_cfg.max_keep,
        save_interval=driver_cfg.eval_every,
    )
    gen = torch.Generator(device=device).manual_seed(train_cfg.seed + process_index())
    state = create_train_state(model, train_cfg, gen)  # over the shards, where sharded
    # init or resume (the reference restores model/optimizer/scheduler/scaler,
    # src_distributed/train.py:60-67; here the whole train state round-trips)
    t0 = time.perf_counter()
    if restore_checkpoint(ckpt, model, state):
        restore_s = time.perf_counter() - t0
        print(f"[driver] resumed at step {state.step} in {restore_s:.2f} s")
        if logger is not None:
            logger.log(state.step, {"restore_s": restore_s})
    ddp = data_parallel(model, process_group) if mesh is None and (world > 1 or process_group is not None) else None
    step_fn = make_train_step(model, vq, train_cfg, ddp=ddp, mesh=mesh)
    timer = StepTimer()

    def save(step: int, force: bool) -> dict:
        t0 = time.perf_counter()
        snapshot = checkpoint_state(model, state, process_group)  # every rank: a collective
        if main and ckpt.save(step, snapshot, force=force) and logger is not None:
            logger.log(step, {"checkpoint_s": time.perf_counter() - t0})
        return snapshot

    eval_model = model if mesh is None else None  # sharded: rank 0's inference copy, made at the first grid

    def _encoded_batches():
        """(images, captions, ready-to-step Batch) stream. Run through a
        background thread (encode_prefetch > 0) this does batch N+1's host
        decode, tokenization and encoder calls while step N runs. Eval
        batches are drawn from THIS stream too (a single consumer of
        data_iter)."""
        for images, captions in data_iter:
            batch = encode_batch(images, captions)
            yield images, captions, map_tensors(lambda t: t.to(device, non_blocking=True), batch)

    enc_iter = (
        background_iterator(_encoded_batches(), depth=driver_cfg.encode_prefetch)
        if driver_cfg.encode_prefetch > 0
        else _encoded_batches()
    )
    with _PreemptionGuard(driver_cfg.graceful_preemption) as guard:
        for _ in range(state.step, driver_cfg.total_steps):
            images, captions, batch = next(enc_iter)
            metrics = step_fn(state, batch, null_cond)
            timer.tick()

            step = state.step
            if logger is not None and step % driver_cfg.log_every == 0:
                metrics = {k: float(v) for k, v in metrics.items()}
                metrics["steps_per_sec"] = timer.steps_per_sec
                metrics["images_per_sec"] = timer.steps_per_sec * images.shape[0] * world
                logger.log(step, metrics)

            if guard.stop_requested:
                save(step, force=True)
                print(f"[driver] preemption checkpoint saved at step {step}")
                break

            if step % driver_cfg.eval_every == 0 or step == driver_cfg.total_steps:
                # force at total_steps: the save interval would otherwise skip
                # the FINAL checkpoint whenever total_steps isn't a multiple of
                # eval_every
                snapshot = save(step, force=step == driver_cfg.total_steps)
                if sample_eval:
                    eval_images, eval_captions, _ = next(enc_iter)
                    if main:
                        t0 = time.perf_counter()
                        if mesh is not None:  # the grid's graphs cannot gather: sample the saved state, unsharded
                            eval_model = inference_copy(model, snapshot["model"], eval_model)
                        _eval_grid(eval_model, vq, encode_batch, driver_cfg, step, workdir,
                                   images=eval_images, captions=eval_captions, logger=logger)
                        logger.log(step, {"eval_s": time.perf_counter() - t0})
                del snapshot
    ckpt.wait()
    if logger is not None:
        logger.close()
    return state


def eval_seeds(step: int, b: int) -> torch.Tensor:
    """(b, 2) per-image seed pairs of the eval grid at `step`, derived from
    the pair (0, step), the key words of jax.random.PRNGKey(step), by the
    sampler's own derive_seeds under a tag of its own. The JAX eval grid
    samples with the unbatched key itself (jax.random draws), a stream the
    port cannot reproduce: the grid's tokens match JAX's in distribution only."""
    return derive_seeds(torch.tensor([[0, step & 0xFFFFFFFF]]), EVAL_SEED_TAG, torch.arange(b))[:, 0]


@torch.no_grad()
def _diag_rows(model, vq, images: torch.Tensor, batch: Batch, step: int):
    """The diagnostic rows: codec encode -> noise -> one inference forward ->
    soft-argmax re-quantize (K4) -> decode the noised and the reconstructed
    tokens. t and the noise come from a generator seeded by `step`."""
    b = images.shape[0]
    gen = torch.Generator(device=images.device).manual_seed(step)
    latents = vq.encode(images)[2]
    t = torch.clamp(1.0 - torch.rand(b, generator=gen, device=images.device) + 0.001, 0.001, 1.0)
    noised, _ = add_noise(latents, t, model.config.num_labels, gen)
    logits = model(noised, t, batch.byt5, batch.clip, batch.clip_image, byt5_mask=batch.byt5_mask)
    codebook = vq.vquantizer.codebook.weight.float()
    soft = torch.softmax(logits.float() / 0.1, dim=-1) @ codebook
    pred_tokens = fused_codebook_lookup(soft.contiguous(), codebook.contiguous())
    return vq.decode_indices(noised), vq.decode_indices(pred_tokens)


def _eval_grid(
    model, vq, encode_batch, driver_cfg, step, workdir, images=None, captions=None, logger=None,
):
    """The reference's per-checkpoint eval collage (src_distributed/train.py:140-183):
    five rows (originals / noised inputs / single-forward soft-argmax
    reconstruction / sampled with CLIP image conditioning / sampled without
    it) written as one jpg (where PIL is present), and beside it
    eval_<step>.npz with every row as uint8, the sampled tokens ("tokens",
    and "tokens_noimg") and the captions. Returns the rows' names.

    With no `images` supplied it samples driver_cfg.eval_prompts only (the
    sampled row). As in the JAX package, all rows use the same eval batch,
    and the reconstruction is a T=0.1 softmax @ codebook re-quantized to the
    nearest code (here kernel K4), where the reference takes a hard argmax.
    """
    if images is None:
        captions = list(driver_cfg.eval_prompts)
        images = np.zeros((len(captions), 256, 256, 3), np.float32)
        with_diag_rows = False
    else:
        captions = list(captions)
        with_diag_rows = True
    images = np.asarray(images, np.float32)
    b, res = len(captions), images.shape[1]
    device = model.head_weight().device
    on_dev = lambda x: map_tensors(lambda t: t.to(device), x)  # noqa: E731

    batch = on_dev(encode_batch(images, captions))
    uncond_batch = on_dev(encode_batch(np.zeros_like(images), [""] * b))
    cond = Conditioning(byt5=batch.byt5, clip=batch.clip,
                        clip_image=batch.clip_image if with_diag_rows else None, byt5_mask=batch.byt5_mask)
    cond_noimg = Conditioning(byt5=batch.byt5, clip=batch.clip, byt5_mask=batch.byt5_mask)
    uncond = Conditioning(byt5=uncond_batch.byt5, clip=uncond_batch.clip, byt5_mask=uncond_batch.byt5_mask)

    f = vq.config.downscale
    latent = (b, res // f, res // f)
    s_cfg = SampleConfig(steps=driver_cfg.eval_steps)
    seeds = eval_seeds(step, b)
    host = lambda t: t.float().cpu().numpy()  # noqa: E731

    rows, names, tokens = [], [], {}
    if with_diag_rows:
        noised_img, pred_img = _diag_rows(model, vq, batch.images.float(), batch, step)
        rows += [images, host(noised_img), host(pred_img)]
        names += ["orig", "noised", "reconstructed"]

    tokens["tokens"] = sample(model, seeds, cond, latent, uncond, s_cfg)
    sampled = host(vq.decode_indices(tokens["tokens"]))
    rows.append(sampled)
    names.append("sampled")
    table = {"Sampled": sampled}
    if with_diag_rows:
        tokens["tokens_noimg"] = sample(model, seeds, cond_noimg, latent, uncond, s_cfg)
        sampled_noimg = host(vq.decode_indices(tokens["tokens_noimg"]))
        rows.append(sampled_noimg)
        names.append("sampled_noimg")
        table = {"Sampled": sampled, "Sampled NoImg": sampled_noimg, "Orig": rows[0]}

    rows = [np.clip(r, 0, 1) for r in rows]
    np.savez(os.path.join(workdir, f"eval_{step:07d}.npz"),
             **{n: (r * 255).astype(np.uint8) for n, r in zip(names, rows)},
             **{k: v.cpu().numpy() for k, v in tokens.items()}, captions=np.asarray(captions))
    out = os.path.join(workdir, f"eval_{step:07d}.jpg")
    if save_image_grid(out, rows):
        print(f"[driver] wrote {out} (rows: {', '.join(names)})")
    if logger is not None:
        logger.log_images(step, table, captions=captions)
    return names


def make_synthetic_encode_fn(
    byt5_embd: int, clip_embd: int, seq_len: int = 16, device="cuda",
) -> tuple[EncodeFn, NullCond]:
    """Deterministic hash-based 'encoders' for smoke tests without real
    ByT5/CLIP, the JAX package's (paella_tpu/train/driver.py:388-418):
    caption -> pseudo-embeddings, stable across calls for the same caption
    within a process (str hashes are salted per process). Returns a Batch
    and a NullCond on `device`."""

    def embed_text(caption: str) -> np.ndarray:
        seed = abs(hash(caption)) % (2**31)
        rng = np.random.default_rng(seed)
        return rng.standard_normal((seq_len, byt5_embd), dtype=np.float32) * 0.1

    def encode(images: np.ndarray, captions: Sequence[str]) -> Batch:
        b = images.shape[0]
        byt5 = np.stack([embed_text(c) for c in captions])
        clip = byt5[:, 0, : min(clip_embd, byt5_embd)]
        if clip.shape[1] < clip_embd:
            clip = np.pad(clip, ((0, 0), (0, clip_embd - clip.shape[1])))
        return Batch(
            images=torch.as_tensor(images).to(device),
            byt5=torch.from_numpy(byt5).to(device),
            byt5_mask=torch.ones((b, seq_len), dtype=torch.bool, device=device),
            clip=torch.from_numpy(np.ascontiguousarray(clip)).to(device),
            clip_image=torch.zeros((b, clip_embd), dtype=torch.float32, device=device),
        )

    null = NullCond(
        byt5=torch.from_numpy(embed_text(""))[None].to(device),
        byt5_mask=torch.ones((1, seq_len), dtype=torch.bool, device=device),
        clip=torch.zeros((1, clip_embd), dtype=torch.float32, device=device),
    )
    return encode, null
