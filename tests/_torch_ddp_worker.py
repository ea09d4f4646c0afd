"""Worker for tests/test_torch_distributed.py: one of N CPU processes that
join a gloo process group through parallel.initialize_distributed, read a
WebDatasetLoader with the default (rank / world size) sharding, and take two
DDP train steps of the tiny denoiser on their slice of one global batch.
The global case (`build_case`) is shared with the single-process reference.

Usage: python _torch_ddp_worker.py <coordinator> <num_processes> <process_id> <shard_dir> <out_file>
"""
import dataclasses
import glob
import sys

import numpy as np
import torch

B, IMG, STEPS = 4, 64, 2


def build_case(seed: int = 0):
    """(model, vq, cfg, batch, null, draws per step) of the global batch: the
    tiny denoiser (weights from `seed`) and codec (always the same: it is
    frozen, and DDP does not broadcast it), TrainConfig(warmup_updates=1,
    lr=1e-3, grad_accum_steps=2) and every draw pinned, so a rank's slice of
    the batch and of the draws is a microbatch of the global step."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, TrainConfig, VQConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.train import Batch, Draws, NullCond

    cfg = PaellaConfig.tiny()
    model, vq = Paella(cfg), VQModel(VQConfig.tiny())
    gen = torch.Generator().manual_seed(seed)
    model.reset_parameters(gen)
    vq.reset_parameters(torch.Generator().manual_seed(100))
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    rng = np.random.default_rng(1)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    batch = Batch(t(rng.uniform(size=(B, IMG, IMG, 3)).astype(np.float32)),
                  t(rng.standard_normal((B, 6, cfg.byt5_embd)).astype(np.float32)),
                  t(np.arange(6)[None] < rng.integers(1, 7, (B, 1))),
                  t(rng.standard_normal((B, cfg.clip_embd)).astype(np.float32)),
                  t(rng.standard_normal((B, cfg.clip_embd)).astype(np.float32)))
    null = NullCond(t(rng.standard_normal((1, 2, cfg.byt5_embd)).astype(np.float32)), torch.ones(1, 2, dtype=torch.bool),
                    t(rng.standard_normal((1, cfg.clip_embd)).astype(np.float32)))
    hw = IMG // 4
    draws = [Draws(*(t(rng.uniform(size=B) < p) for p in (0.3, 0.5, 0.5)), u=t(rng.uniform(size=B).astype(np.float32)),
                   noise_mask=t(rng.integers(0, 2, (B, hw, hw)).astype(np.int32)),
                   random_x=t(rng.integers(0, cfg.num_labels, (B, hw, hw)).astype(np.int32)), dropout_seed=0)
             for _ in range(STEPS)]
    return model, vq, TrainConfig(warmup_updates=1, lr=1e-3, grad_accum_steps=2), batch, null, draws


def rows(x, lo: int, hi: int):
    """Rows lo:hi of every tensor field of a Batch or Draws."""
    return dataclasses.replace(x, **{f.name: getattr(x, f.name)[lo:hi] for f in dataclasses.fields(x)
                                     if isinstance(getattr(x, f.name), torch.Tensor)})


def main() -> None:
    coordinator, n, rank, shard_dir, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4], sys.argv[5]
    from paella_tpu_torch.data import WebDatasetLoader
    from paella_tpu_torch.parallel import data_parallel, initialize_distributed
    from paella_tpu_torch.train import create_train_state, make_train_step

    info = initialize_distributed(coordinator, n, rank)
    assert info["process_count"] == n and info["process_index"] == rank and info["backend"] == "gloo", info
    loader = WebDatasetLoader(sorted(glob.glob(f"{shard_dir}/*.tar")), batch_size=2, image_size=32,
                              shuffle_buffer=1, filter=None, resample=False)
    caps = [c for _, captions in loader for c in captions]
    print(f"CAPS={';'.join(sorted(caps))}", flush=True)

    model, vq, cfg, batch, null, draws = build_case(seed=rank)  # DDP broadcasts rank 0's weights
    per = B // n
    mb = per // cfg.grad_accum_steps
    lo = rank * per
    ddp = data_parallel(model)
    state, step = create_train_state(model, cfg), make_train_step(model, vq, cfg, ddp=ddp)
    metrics, grads = [], []
    for d in draws:
        mine = rows(d, lo, lo + per)
        m = step(state, rows(batch, lo, lo + per), null, [rows(mine, i * mb, (i + 1) * mb) for i in range(cfg.grad_accum_steps)])
        metrics.append({k: float(v) for k, v in m.items()})
        grads.append({k: p.grad.clone() for k, p in model.named_parameters()})
    torch.save({"metrics": metrics, "grads": grads, "params": model.state_dict()}, out)
    print(f"WORKER_OK process={rank}", flush=True)


if __name__ == "__main__":
    main()
