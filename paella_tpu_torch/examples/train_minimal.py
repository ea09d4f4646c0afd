"""Minimal single-host training example, the counterpart of the JAX repo's
`examples/train_minimal.py` (the reference's pedagogical trainer,
src/train.py, with its two known bugs fixed: the unreduced loss and the
missing optimizer step).

Runs the tiny config on synthetic data out of the box:
    python -m paella_tpu_torch.examples.train_minimal --steps 20

Point it at real WebDataset shards + reference checkpoints for actual training:
    python -m paella_tpu_torch.examples.train_minimal --shards 'data/{00000..00099}.tar' \\
        --vqgan vqgan_f4.pt --byt5 byt5_xl.pt --batch 64

`--fsdp n` shards the denoiser over n processes (train/driver.py), one a
card, launched by torchrun; a single process runs fsdp 1.
"""
from __future__ import annotations

import argparse
import glob

import numpy as np
import torch


def byt5_encode_fns(byt5, clip_embd: int, device):
    """The frozen ByT5 encoder `byt5` ((ids, mask) -> states) as run_training's
    (encode_batch, NullCond): captions padded to pad_bucket(1) bytes, zero
    CLIP rows, and the null conditioning of "" at its own length."""
    from ..cond import byt5_batch_encode, pad_bucket
    from ..train import Batch, NullCond

    def states(ids: np.ndarray, mask: np.ndarray):
        ids_t, mask_t = torch.from_numpy(ids).to(device), torch.from_numpy(mask).to(device)
        with torch.no_grad():
            return byt5(ids_t, mask_t), mask_t

    def encode(images, captions) -> Batch:
        ids, mask = byt5_batch_encode(captions, max_length=768, pad_to=pad_bucket(1))
        byt5_states, mask_t = states(ids, mask)
        b = images.shape[0]
        return Batch(
            images=torch.as_tensor(images).to(device),
            byt5=byt5_states,
            byt5_mask=mask_t,
            clip=torch.zeros((b, clip_embd), dtype=torch.float32, device=device),
            clip_image=torch.zeros((b, clip_embd), dtype=torch.float32, device=device),
        )

    null_states, null_mask = states(*byt5_batch_encode([""]))
    null = NullCond(byt5=null_states, byt5_mask=null_mask,
                    clip=torch.zeros((1, clip_embd), dtype=torch.float32, device=device))
    return encode, null


def main(argv=None):
    """Train; returns the final TrainState."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--shards", default=None)
    ap.add_argument("--vqgan", default=None)
    ap.add_argument("--byt5", default=None)
    ap.add_argument("--workdir", default="runs/minimal")
    ap.add_argument("--fsdp", type=int, default=1)
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from ..codec import VQModel
    from ..cond.loader import resolve_device
    from ..config import PaellaConfig, TrainConfig, VQConfig
    from ..data import SyntheticDataset, WebDatasetLoader
    from ..models import Paella
    from ..train.driver import DriverConfig, make_synthetic_encode_fn, run_training

    if args.fsdp > 1:  # the ranks' rendezvous from torchrun's variables
        from ..parallel import initialize_distributed

        initialize_distributed()
    device = resolve_device(args.device)
    if args.vqgan:
        from ..cond.loader import load_vqgan

        vq = load_vqgan(args.vqgan, device=device)
        p_cfg = PaellaConfig.v1_byt5_xl()
        image_size = 256
    else:
        p_cfg = PaellaConfig.tiny()
        with torch.device(device):
            vq = VQModel(VQConfig.tiny())
        vq.reset_parameters(torch.Generator(device=device).manual_seed(0))
        image_size = 64

    with torch.device(device):
        model = Paella(p_cfg)
    model.reset_parameters(torch.Generator(device=device).manual_seed(0))

    if args.byt5:
        from ..cond import T5Config
        from ..cond.loader import load_byt5

        encode, null = byt5_encode_fns(load_byt5(args.byt5, T5Config.byt5_xl(), device=device), p_cfg.clip_embd, device)
    else:
        encode, null = make_synthetic_encode_fn(p_cfg.byt5_embd, p_cfg.clip_embd, device=device)

    if args.shards:
        data = iter(WebDatasetLoader(sorted(glob.glob(args.shards)), args.batch, image_size))
    else:
        data = iter(SyntheticDataset(args.batch, image_size))

    return run_training(
        model,
        vq.eval(),
        data,
        encode,
        null,
        TrainConfig(warmup_updates=min(100, args.steps)),
        DriverConfig(
            workdir=args.workdir,
            total_steps=args.steps,
            log_every=1,
            eval_every=max(args.steps // 2, 1),
            fsdp=args.fsdp,
        ),
        sample_eval=False,
    )


if __name__ == "__main__":
    main()
