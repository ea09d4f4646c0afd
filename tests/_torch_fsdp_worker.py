"""Worker for tests/test_torch_fsdp.py: one of N CPU processes that join a
gloo process group through parallel.initialize_distributed and train the
tiny denoiser of `_torch_ddp_worker.build_case` sharded with FSDP2
(parallel.shard_model) over the (dp, fsdp) mesh.

Usage: python _torch_fsdp_worker.py <coordinator> <num_processes> <process_id> <fsdp> <out_dir> [<ckpt_dir>]

<coordinator> is host:port or an init URL (file:///path/rendezvous).

Every rank builds its model from a seed of its own (rank), so equal results
pin shard_model's broadcast. Phases, each writing rank<i>_<phase>.pt into
out_dir:
  steps   two train steps on this rank's slice of the global batch (two
          microbatches), then the gathered gradients and parameters, the
          metrics, and each parameter's local shard shape and placement;
          the global batch is build_case's, repeated as often as the mesh's
          dp axis (a copy per replica group, so the mean is unchanged)
  skip    a third step with an inf written into one gradient element on the
          last rank only, before AdamW runs: the metrics and parameters
  driver  (with a ckpt_dir; world 2 only) run_training at `fsdp` for 2
          steps, eval_every 2, from SyntheticDataset; then run_training in
          ckpt_dir (a world-size-1 run's workdir at step 2) resumes at
          `fsdp` with nothing left to run, and the gathered state is written
"""
import dataclasses
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tests._torch_ddp_worker import B, build_case, rows  # noqa: E402

DRIVER = dict(total_steps=2, log_every=1, eval_every=2, eval_steps=2, encode_prefetch=0)


def gathered(model) -> dict:
    """The model's whole parameters (a collective)."""
    return {k: p.detach().full_tensor().clone() for k, p in model.named_parameters()}


def driver_train_config():
    from paella_tpu_torch.config import TrainConfig

    return TrainConfig(warmup_updates=1, lr=1e-3, adam_moment_dtype="bfloat16")


def driver_case(seed: int):
    """The driver phase's model, codec, encoders and data, the same in the
    test's world-size-1 runs: build_case's models, the hash encoders of
    make_synthetic_encode_fn on the CPU, SyntheticDataset batch 4 at 64x64
    from a seed of this rank's."""
    from paella_tpu_torch.data import SyntheticDataset
    from paella_tpu_torch.train import make_synthetic_encode_fn

    model, vq, _, _, _, _ = build_case(seed=seed)
    enc, null = make_synthetic_encode_fn(model.config.byt5_embd, model.config.clip_embd, seq_len=8, device="cpu")
    return model, vq, enc, null, iter(SyntheticDataset(batch_size=B, image_size=64, seed=seed))


def regrid(d_cfg, vq, enc) -> list:
    """For each of the grid's sampled rows: whether a plain Paella loaded
    from the run's step-2 checkpoint draws the same tokens from the grid's
    own images and captions."""
    import numpy as np

    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.train import CheckpointManager
    from paella_tpu_torch.train.driver import _eval_grid

    grid = np.load(os.path.join(d_cfg.workdir, "eval_0000002.npz"))
    fresh = Paella(build_case()[0].config)
    fresh.load_state_dict(CheckpointManager(os.path.join(d_cfg.workdir, "checkpoints")).restore(None, 2)[0]["model"])
    again_dir = os.path.join(d_cfg.workdir, "again")
    os.makedirs(again_dir)
    _eval_grid(fresh, vq, enc, d_cfg, 2, again_dir, images=grid["orig"].astype(np.float32) / 255.0,
               captions=list(grid["captions"]))
    again = np.load(os.path.join(again_dir, "eval_0000002.npz"))
    return [bool((again[k] == grid[k]).all()) for k in ("tokens", "tokens_noimg")]


def main() -> None:
    coordinator, n, rank, fsdp, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), int(sys.argv[4]), sys.argv[5]
    ckpt_dir = sys.argv[6] if len(sys.argv) > 6 else None
    from paella_tpu_torch.parallel import initialize_distributed, shard_model
    from paella_tpu_torch.train import DriverConfig, create_train_state, make_train_step, run_training
    from paella_tpu_torch.train.driver import checkpoint_state

    info = initialize_distributed(coordinator, n, rank)
    assert info["process_count"] == n and info["process_index"] == rank and info["backend"] == "gloo", info
    save = lambda phase, obj: torch.save(obj, os.path.join(out, f"rank{rank}_{phase}.pt"))  # noqa: E731

    model, vq, cfg, batch, null, draws = build_case(seed=rank)
    mesh = shard_model(model, fsdp)
    dp = n // fsdp
    batch = dataclasses.replace(batch, **{f.name: getattr(batch, f.name).repeat(dp, *[1] * (getattr(batch, f.name).dim() - 1))
                                          for f in dataclasses.fields(batch)})
    draws = [dataclasses.replace(d, **{f.name: getattr(d, f.name).repeat(dp, *[1] * (getattr(d, f.name).dim() - 1))
                                      for f in dataclasses.fields(d) if isinstance(getattr(d, f.name), torch.Tensor)})
             for d in draws]
    per = B * dp // n
    mb = per // cfg.grad_accum_steps
    lo = rank * per
    state, step = create_train_state(model, cfg), make_train_step(model, vq, cfg, mesh=mesh)
    shards = {k: (tuple(p.to_local().shape), tuple(p.shape), [str(pl) for pl in p.placements])
              for k, p in model.named_parameters()}
    metrics, grads = [], []
    for d in draws:
        mine = rows(d, lo, lo + per)
        m = step(state, rows(batch, lo, lo + per), null, [rows(mine, i * mb, (i + 1) * mb) for i in range(cfg.grad_accum_steps)])
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.full_tensor().clone() for k, p in model.named_parameters()})
    save("steps", {"metrics": metrics, "grads": grads, "params": gathered(model), "shards": shards,
                   "mesh": list(mesh.shape), "count": state.optimizer.count})

    # skip: an inf in the last rank's first non-empty local gradient element only
    before = gathered(model)
    adamw_step = state.optimizer.step

    def poisoned_step():
        if rank == n - 1:
            with torch.no_grad():
                g = next(p.grad.to_local() for p in model.parameters() if p.grad.to_local().numel())
                g.view(-1)[0] = float("inf")
        return adamw_step()

    state.optimizer.step = poisoned_step
    d = draws[0]
    mine = rows(d, lo, lo + per)
    m = step(state, rows(batch, lo, lo + per), null, [rows(mine, i * mb, (i + 1) * mb) for i in range(cfg.grad_accum_steps)])
    state.optimizer.step = adamw_step
    save("skip", {"metrics": {k: float(v) for k, v in m.items()}, "before": before, "after": gathered(model),
                  "count": state.optimizer.count})

    if ckpt_dir is not None:
        model, vq, enc, null, data = driver_case(seed=rank)
        t_cfg = driver_train_config()
        d_cfg = DriverConfig(workdir=os.path.join(out, "fsdp_run"), fsdp=fsdp, **DRIVER)
        state = run_training(model, vq, data, enc, null, t_cfg, d_cfg)
        out_driver = {"params": gathered(model), "step": state.step, "count": state.optimizer.count}
        if rank == 0:  # the grid's tokens against a plain model loaded from the step-2 checkpoint (same encoders)
            out_driver["grid_tokens_equal"] = regrid(d_cfg, vq, enc)
        save("driver", out_driver)

        model, vq, enc, null, data = driver_case(seed=10 + rank)
        state = run_training(model, vq, data, enc, null, t_cfg, dataclasses.replace(d_cfg, workdir=ckpt_dir))
        snap = checkpoint_state(model, state)
        save("resumed", {"params": gathered(model), "snapshot": {k: snap[k] for k in ("model", "optimizer", "step")}})
    print(f"WORKER_OK process={rank}", flush=True)


if __name__ == "__main__":
    main()
