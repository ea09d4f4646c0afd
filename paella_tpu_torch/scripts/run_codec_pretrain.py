"""VQGAN codec pretraining, the counterpart of the JAX repo's
`scripts/run_codec_pretrain.py`: the f4 VQGAN (L1 + L2 reconstruction, VQ +
commitment, the non-saturating GAN term against the spectral-norm patch
discriminator from `--disc-start` on, BatchNorm statistics) trained on the
driver's synthetic tar shards (codec/trainer.py), with a fixed eval batch's
reconstruction L1 and codebook usage at init, every `--collage-every` steps
and at the end.

    python -m paella_tpu_torch.scripts.run_codec_pretrain --steps 2000   # on the card
    python -m paella_tpu_torch.scripts.run_codec_pretrain --smoke        # tiny, on the CPU

Writes <workdir>/codec_vars.npz in the JAX package's flat layout
({params, batch_stats} keys joined by '/', float32), which the driver and
eval scripts of either package take through `--codec`; metrics.jsonl;
recon_<tag>.jpg collages where PIL is present; and summary.json, whose
JSON is also the last line of standard output.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from . import run_driver_e2e as drv


def main(argv=None):
    ap = argparse.ArgumentParser(description="paella_tpu_torch VQGAN codec pretraining")
    ap.add_argument("--workdir", default="runs/codec_pretrain")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=256)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--collage-every", type=int, default=500)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--per-shard", type=int, default=512)
    ap.add_argument("--lr", type=float, default=2e-4)
    ap.add_argument("--adv-weight", type=float, default=0.05)
    ap.add_argument("--disc-start", type=int, default=500, help="recon-only warmup before the GAN loss kicks in")
    ap.add_argument("--smoke", action="store_true", help="tiny geometry on the CPU (a rehearsal of this script)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from ..codec import CodecTrainConfig, Discriminator, VQModel, create_codec_train_state, make_codec_train_step
    from ..config import VQConfig
    from ..convert import vqgan_variables_to_jax
    from ..data import background_iterator
    from ..train import save_params_npz
    from ..utils.logging import MetricLogger, save_image_grid

    if args.smoke:
        args.image, args.batch, args.per_shard = 64, 4, 24
        args.steps = min(args.steps, 30)
        args.log_every, args.collage_every = 5, 20
        args.disc_start = 10
    device = drv.device_of(args)
    print(f"[codec] device: {drv.device_name(device)}", flush=True)
    os.makedirs(args.workdir, exist_ok=True)

    stream, data_text = drv.image_stream(os.path.join(args.workdir, "shards"), args, 1,
                                         shards=args.shards, per_shard=args.per_shard)
    data_iter = background_iterator(stream, depth=2)

    # float32 training; the production VQConfig geometry, so the trained
    # variables drop into the driver and eval scripts as they are
    vq_cfg = VQConfig.tiny() if args.smoke else VQConfig()
    with torch.device(device):
        vq = VQModel(vq_cfg)
        disc = Discriminator(c_hidden=32, depth=4) if args.smoke else Discriminator()
    gen = torch.Generator(device=device).manual_seed(0)
    vq.reset_parameters(gen)
    disc.reset_parameters(gen)
    c_cfg = CodecTrainConfig(lr=args.lr, disc_lr=args.lr, adv_weight=args.adv_weight, disc_start=args.disc_start)
    state = create_codec_train_state(vq, disc, c_cfg)
    n_gen = sum(p.numel() for p in vq.parameters())
    print(f"[codec] generator params: {n_gen / 1e6:.1f}M", flush=True)
    step_fn = make_codec_train_step(vq, disc, c_cfg)

    # the fixed eval batch: the init-against-trained comparison and the collages
    eval_images = torch.from_numpy(next(data_iter)[0]).to(device)

    @torch.no_grad()
    def recon_eval(images):
        qe, _z, idx, _ = vq.encode(images)
        recon = vq.decode(qe)
        return recon.clamp(0.0, 1.0), torch.mean(torch.abs(recon - images)), idx

    def eval_snapshot(tag: str, step: int) -> dict:
        recon, l1, idx = recon_eval(eval_images)
        recon, l1, idx = recon.float().cpu().numpy(), float(l1), idx.cpu().numpy()
        usage = len(np.unique(idx)) / float(vq_cfg.codebook_size)
        out = os.path.join(args.workdir, f"recon_{tag}.jpg")
        if save_image_grid(out, [eval_images.cpu().numpy(), recon]):
            print(f"[codec] wrote {out}", flush=True)
        print(f"[codec] {tag}: eval recon_l1={l1:.4f} codebook_usage={usage:.3f}", flush=True)
        return {"step": step, "eval_recon_l1": l1, "codebook_usage": usage}

    logger = MetricLogger(args.workdir, print_every=args.log_every)
    init_snap = eval_snapshot("init", 0)

    t0 = time.time()
    t_mark, s_mark = t0, 0
    for _ in range(args.steps):
        images, _caps = next(data_iter)
        metrics = step_fn(state, torch.from_numpy(images).to(device))
        step = state.step
        if step % args.log_every == 0:
            metrics = {k: float(v) for k, v in metrics.items()}
            now = time.time()
            metrics["images_per_sec"] = (step - s_mark) * args.batch / max(now - t_mark, 1e-9)
            t_mark, s_mark = now, step
            logger.log(step, metrics)
        if step % args.collage_every == 0:
            eval_snapshot(f"{step:06d}", step)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.time() - t0

    final_snap = eval_snapshot("final", state.step)
    out_path = os.path.join(args.workdir, "codec_vars.npz")
    save_params_npz(out_path, vqgan_variables_to_jax(vq.state_dict(), vq_cfg))
    print(f"[codec] saved {out_path}", flush=True)

    summary = {
        "metric": "VQGAN codec pretraining (recon + VQ + GAN, spectral-norm discriminator, BatchNorm statistics)",
        "steps": state.step,
        "wall_s": round(wall, 1),
        "images_per_sec": round(args.steps * args.batch / wall, 2),
        "init_eval_recon_l1": round(init_snap["eval_recon_l1"], 4),
        "final_eval_recon_l1": round(final_snap["eval_recon_l1"], 4),
        "init_codebook_usage": round(init_snap["codebook_usage"], 4),
        "final_codebook_usage": round(final_snap["codebook_usage"], 4),
        "improvement_x": round(init_snap["eval_recon_l1"] / max(final_snap["eval_recon_l1"], 1e-9), 2),
        "generator_params_m": round(n_gen / 1e6, 1),
        "batch": args.batch,
        "image": args.image,
        "data": data_text,
        "device": drv.device_name(device),
        "peak_bytes": drv.peak_bytes(device),
        "launches": drv.kernel_launches(),
    }
    logger.close()
    with open(os.path.join(args.workdir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
