"""The checkpoint eval end to end, the counterpart of the JAX repo's
`scripts/run_eval_e2e.py`:

    restore a driver run's denoiser checkpoint (parameters only)
    -> frozen ByT5-XL + CLIP ViT-H text conditioning (run_driver_e2e's towers)
    -> the production sampler (8 steps, batched CFG, a CUDA graph on a card)
    -> f4 VQGAN decode_indices -> InceptionV3 pool3 ("fid" variant) over the
       generated set and over real images from the run's own tar shards
    -> float64 Fréchet distance (eval/metrics.py)

The featurizer's weights are seeded (`synth_inception_state_dict`, at
eval/inception.py's INCEPTION_SHAPES), so the FID value is a random-
projection Fréchet distance, comparable across arms of one run and not to
published numbers; real weights are a `load_inception(path)` away.

    python -m paella_tpu_torch.scripts.run_eval_e2e --workdir runs/driver_e2e --n 256

Options, as in the JAX script: `--real-recon` scores against the codec's
encode -> decode reconstructions of the real set; `--space tokens` scores
in token space (no decoder, no featurizer): a Fréchet distance over a
random projection of each image's code histogram, its codebook-embedding
field statistics and quadrant means (`token_stats`), and the marginal
Jensen-Shannon divergence (`js_div`), generated tokens against encode(real);
`--trend` scores the untrained init and every checkpoint (`--trend-steps`);
`--w8a8` adds a twin of every trend arm, the same parameters quantized by
quant.quantize_paella_int8 over fuse_eligible_levels with include_first and
sampled W8A8 (act_quant, kernel K1b), with its token flip rate against the
bf16 arm. Writes <workdir>/eval_fid.json, eval_token.json,
eval_fid_trend.json or eval_token_trend.json (with _w8a8 and _trainedcodec
suffixes as in JAX) and prints it as the last line.

Each batch samples from (B, 2) seed pairs derived from (0, 1000 + batch
index) under a tag of its own (`batch_seeds`), where the JAX script takes
the key fast_key(1000 + batch index): the tokens match JAX's in
distribution only. Under `--smoke` (the tiny geometry on the CPU) a workdir
with no checkpoint is scored with the JAX script's synthetic arms (the
init and a perturbed init); one that holds checkpoints is restored from.
"""
from __future__ import annotations

import argparse
import dataclasses
import gc
import json
import os
import time
import types

import numpy as np
import torch

from . import run_driver_e2e as drv

SAMPLE_SEED_TAG = 5  # derive_seeds' draw tag of the eval batches' seeds (the sampler uses 0-3, the eval grid 4)


def batch_seeds(i: int, b: int, device="cpu") -> torch.Tensor:
    """(b, 2) seed pairs of eval batch i, from the pair (0, 1000 + i) (the
    words of the JAX script's fast_key(1000 + i)) by the sampler's
    derive_seeds under SAMPLE_SEED_TAG."""
    from ..sampling.sampler import derive_seeds

    return derive_seeds(torch.tensor([[0, 1000 + i]]), SAMPLE_SEED_TAG, torch.arange(b))[:, 0].to(device)


def synth_inception_state_dict(seed: int = 0) -> dict:
    """A seeded InceptionV3 state dict (numpy, torch layout) at
    INCEPTION_SHAPES: He-scaled conv weights (activations stay alive through
    its depth), BatchNorm scale 1 + 0.1 N, bias and mean 0.05 N, var
    1 + 0.3 U, and the classifier keys the converter ignores. The stand-in
    for pt_inception-2015-12-05, drawn in the JAX tests' order."""
    from ..eval.inception import INCEPTION_SHAPES, conv_weight_shape

    rng = np.random.default_rng(seed)
    sd = {}
    for block, units in INCEPTION_SHAPES.items():
        for unit, (cin, cout, k) in units.items():
            shape = conv_weight_shape(cin, cout, k)
            p = block if unit is None else f"{block}.{unit}"
            sd[f"{p}.conv.weight"] = rng.standard_normal(shape, dtype=np.float32) * (2.0 / (cin * shape[2] * shape[3])) ** 0.5
            sd[f"{p}.bn.weight"] = (1 + 0.1 * rng.standard_normal(cout)).astype(np.float32)
            sd[f"{p}.bn.bias"] = (0.05 * rng.standard_normal(cout)).astype(np.float32)
            sd[f"{p}.bn.running_mean"] = (0.05 * rng.standard_normal(cout)).astype(np.float32)
            sd[f"{p}.bn.running_var"] = (1 + 0.3 * rng.uniform(size=cout)).astype(np.float32)
    sd["fc.weight"] = np.zeros((1008, 2048), np.float32)
    sd["fc.bias"] = np.zeros((1008,), np.float32)
    return sd


def token_projection(k: int) -> np.ndarray:
    """The (K, 64) float32 random projection of a code histogram."""
    r = np.random.default_rng(7).standard_normal((k, 64)).astype(np.float32)
    r /= np.sqrt(64.0)
    return r


def token_stats(tok_batches, codebook: np.ndarray, projection: np.ndarray):
    """Per-image token-space features: the projected code histogram (64) |
    the codebook-embedding field's mean and std (2c) | its 2x2 quadrant
    means (4c), float64; and the mean marginal histogram."""
    toks = np.concatenate(tok_batches, 0)
    b, h, w = toks.shape
    k = codebook.shape[0]
    hist = np.zeros((b, k), np.float32)
    for bi in range(b):
        hist[bi] = np.bincount(toks[bi].ravel(), minlength=k)
    hist /= float(h * w)
    emb = codebook[toks]
    h2, w2 = h // 2, w // 2
    quads = [emb[:, :h2, :w2], emb[:, :h2, w2:], emb[:, h2:, :w2], emb[:, h2:, w2:]]
    feats = np.concatenate([hist @ projection, emb.mean((1, 2)), emb.std((1, 2))] + [q.mean((1, 2)) for q in quads], -1)
    return feats.astype(np.float64), hist.mean(0)


def js_div(p, q, eps: float = 1e-10) -> float:
    """Jensen-Shannon divergence (nats) of two histograms, each smoothed by
    eps and normalized."""
    p = np.asarray(p, np.float64) + eps
    q = np.asarray(q, np.float64) + eps
    p, q = p / p.sum(), q / q.sum()
    m = 0.5 * (p + q)
    kl = lambda a, c: float(np.sum(a * np.log(a / c)))  # noqa: E731
    return 0.5 * kl(p, m) + 0.5 * kl(q, m)


def perturbed_(model, scale: float = 0.02, seed: int = 5):
    """Every parameter plus scale * N(0, 1) from a generator seeded `seed`
    (the JAX script's _perturbed: the zero-init head samples uniformly)."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype) * scale)
    model.drop_derived()
    return model


def main(argv=None):
    ap = argparse.ArgumentParser(description="paella_tpu_torch checkpoint eval: sample -> decode -> Inception -> FID")
    ap.add_argument("--workdir", default="runs/driver_e2e")
    ap.add_argument("--n", type=int, default=256, help="images per set")
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image", type=int, default=256)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--cfg", default="8,8", help="CFG schedule 'start,end' (default 8,8; '0,0' disables CFG)")
    ap.add_argument("--byt5-bucket", type=int, default=64)
    ap.add_argument("--byt5", default="w8a8", choices=["bf16", "int8", "w8a8"],
                    help="frozen ByT5-XL mode (run_driver_e2e.build_encoders); match the driver run's")
    ap.add_argument("--geometry", default="small", choices=["small", "mid", "1b"],
                    help="denoiser geometry of the workdir's checkpoints (run_driver_e2e.make_geometry)")
    ap.add_argument("--adam-moments", default="f32", choices=["f32", "bf16"],
                    help="Adam moment dtype the checkpoints were saved with")
    ap.add_argument("--smoke", action="store_true", help="tiny geometry on the CPU")
    ap.add_argument("--trend", action="store_true", help="FID per denoiser state (untrained init + checkpoints)")
    ap.add_argument("--trend-steps", default="all", help="comma-separated checkpoint steps for --trend (default: all)")
    ap.add_argument("--real-recon", action="store_true",
                    help="score against the codec's encode -> decode reconstruction of the real set")
    ap.add_argument("--space", choices=("image", "tokens"), default="image",
                    help="'tokens': Fréchet over projected code histograms and codebook-field statistics, and "
                         "the marginal Jensen-Shannon divergence, generated tokens against encode(real)")
    ap.add_argument("--codec", default=None, help="codec_vars.npz from run_codec_pretrain (either package's)")
    ap.add_argument("--w8a8", action="store_true",
                    help="add a W8A8 twin of every --trend arm: the same parameters int8-quantized "
                         "(fuse-eligible levels + first repetitions), sampled with act_quant, same seeds")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)
    token_space = args.space == "tokens"
    if token_space and args.real_recon:
        raise SystemExit("--real-recon is an image-space option")
    if args.w8a8 and not args.trend:
        raise SystemExit("--w8a8 is a --trend mode option")
    if args.smoke:
        args.n, args.batch, args.image, args.byt5_bucket = 8, 4, 64, 16
    if args.n % args.batch:
        raise SystemExit("n must be a multiple of batch")

    from ..codec import VQModel
    from ..config import PaellaConfig, SampleConfig, TrainConfig, VQConfig
    from ..eval import convert_inception, features_over_batches, fid_from_features, inception_features
    from ..eval.inception import _tree_map
    from ..models import Paella
    from ..quant import _with_act_quant, fuse_eligible_levels, quantize_paella_int8
    from ..sampling import Conditioning, sample
    from ..train import CheckpointManager, create_train_state
    from ..train.driver import restore_checkpoint

    device = drv.device_of(args)
    print(f"[eval] device: {drv.device_name(device)}", flush=True)

    # --- models at the driver run's geometry ------------------------------
    if args.smoke:
        p_cfg = dataclasses.replace(PaellaConfig.tiny(), byt5_embd=32, clip_embd=24, dtype="bfloat16")
        vq_cfg = VQConfig.tiny()
    else:
        p_cfg, vq_cfg = drv.make_geometry(args.geometry)
    q_levels = None
    if args.w8a8:
        # quant.w8a8_quality_proxy's recipe: the fuse-eligible levels' fc
        # weights, first repetitions included, sampled with act_quant
        q_levels = fuse_eligible_levels(p_cfg)
        if not args.smoke and not q_levels:
            raise SystemExit(f"--w8a8 at geometry {p_cfg.c_hidden} quantizes nothing: no fuse-eligible level "
                             "(c % 128 == 0)")
    with torch.device(device):
        vq = VQModel(vq_cfg)
    if args.codec:
        drv.load_codec(vq, args.codec)
        print(f"[eval] loaded trained codec vars from {args.codec}", flush=True)
    else:
        vq.reset_parameters(torch.Generator(device=device).manual_seed(1))
    vq.eval()
    hw = args.image // vq_cfg.downscale

    ckpt_dir = os.path.join(args.workdir, "checkpoints")
    mgr = None
    if os.path.isdir(ckpt_dir) and any(s.isdigit() for s in os.listdir(ckpt_dir)):
        mgr = CheckpointManager(ckpt_dir)
    elif not args.smoke:
        raise SystemExit(f"no checkpoint under {args.workdir}: run run_driver_e2e first")
    t_cfg = TrainConfig(warmup_updates=100, batch_size=args.batch,
                        adam_moment_dtype="bfloat16" if args.adam_moments == "bf16" else "float32")

    def empty_model():
        with torch.device("meta"):
            m = Paella(p_cfg)
        return m.to_empty(device=device)

    def init_model():
        m = empty_model()
        m.reset_parameters(torch.Generator(device=device).manual_seed(0))
        return m

    def restore_step(step=None):
        """The step's denoiser (latest by default): the checkpoint restored
        through train.driver.restore_checkpoint, then its optimizer state
        dropped; only the parameters sample."""
        m = empty_model()
        state = create_train_state(m, t_cfg)
        if not restore_checkpoint(mgr, m, state, step):
            raise SystemExit(f"no checkpoint under {args.workdir}: run run_driver_e2e first")
        s = state.step
        del state
        print(f"[eval] restored step-{s} denoiser", flush=True)
        return m, s

    # --- frozen conditioning towers, the driver run's build ----------------
    enc_args = types.SimpleNamespace(smoke=args.smoke, byt5=args.byt5, byt5_bucket=args.byt5_bucket)
    encode_batch, null, byt5_embd, clip_embd = drv.build_encoders(enc_args, device)
    if (byt5_embd, clip_embd) != (p_cfg.byt5_embd, p_cfg.clip_embd):
        raise ValueError(f"towers give ({byt5_embd}, {clip_embd}), the denoiser takes ({p_cfg.byt5_embd}, {p_cfg.clip_embd})")
    prompts = [f"{s} a {o}" for s in drv.CAPTION_STYLES for o in drv.CAPTION_OBJECTS]
    prompts = (prompts * (args.n // len(prompts) + 1))[: args.n]
    b = args.batch
    uncond = Conditioning(byt5=null.byt5.expand(b, -1, -1), byt5_mask=null.byt5_mask.expand(b, -1),
                          clip=null.clip.expand(b, -1))
    cfg_sched = tuple(float(v) for v in args.cfg.split(","))
    if len(cfg_sched) != 2:
        raise SystemExit("--cfg wants 'start,end'")
    s_cfg = SampleConfig(steps=args.steps, cfg=None if cfg_sched == (0.0, 0.0) else cfg_sched)
    t0_all = time.time()

    # every batch's text conditioning once (text only: byt5 states + CLIP
    # text, the eval grid's cond_noimg form); then the towers go before any
    # denoiser is made: towers and train states never coexist
    conds = []
    for i in range(args.n // b):
        byt5, mask, clip_vec = encode_batch.encode_text(prompts[i * b : (i + 1) * b])
        conds.append(Conditioning(byt5=byt5, clip=clip_vec, byt5_mask=mask))
    del encode_batch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    # --- the real set: the run's own tar shards ----------------------------
    shard_dir = os.path.join(args.workdir, "shards")
    make = args.smoke and not os.path.isdir(shard_dir)
    stream, data_text = drv.image_stream(shard_dir, args, None, shards=1 if make else None, per_shard=16)
    real_batches = []
    for images, _caps in stream:
        real_batches.append(images)
        if len(real_batches) * b >= args.n:
            break
    if len(real_batches) * b != args.n:
        raise SystemExit(f"shards under {shard_dir} yielded only {len(real_batches) * b} of the requested {args.n} "
                         "real images: lower --n or add shards")

    def on_dev(x):
        return torch.as_tensor(np.asarray(x)).to(device)

    with torch.no_grad():
        if args.real_recon:
            real_batches = [vq.decode_indices(vq.encode(on_dev(im))[2]).clamp(0.0, 1.0).float().cpu().numpy()
                            for im in real_batches]

        half = args.n // 2
        t_feat = [0.0]
        if token_space:
            # the token-space featurizer: no decoder, no Inception
            codebook = vq.vquantizer.codebook.weight.detach().float().cpu().numpy()
            proj = token_projection(codebook.shape[0])
            t0 = time.time()
            real_tok = [vq.encode(on_dev(im))[2].cpu().numpy() for im in real_batches]
            real_feats, real_hist = token_stats(real_tok, codebook, proj)
            t_feat[0] += time.time() - t0
            floor = fid_from_features(real_feats[:half], real_feats[half:])
            js_floor = js_div(token_stats(real_tok[: len(real_tok) // 2], codebook, proj)[1],
                              token_stats(real_tok[len(real_tok) // 2 :], codebook, proj)[1])
        else:
            # the classic InceptionV3 pool3 featurizer, built once and shared by the arms
            params = convert_inception(synth_inception_state_dict(seed=0))
            extract = inception_features(_tree_map(lambda a: a.to(device), params), variant="fid")
            t0 = time.time()
            real_feats = features_over_batches(extract, real_batches)
            t_feat[0] += time.time() - t0
            # the small-n noise floor: the real set against itself, split in half
            floor = fid_from_features(real_feats[:half], real_feats[half:])

    def generate(m):
        """(n sampled token grids (numpy), images/s of sampling)."""
        toks, t_sample = [], 0.0
        for i in range(args.n // b):
            t0 = time.time()
            tokens = sample(m, batch_seeds(i, b, device), conds[i], (b, hw, hw), uncond, s_cfg)
            toks.append(tokens)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            t_sample += time.time() - t0
            print(f"[eval] gen batch {i + 1}/{args.n // b}", flush=True)
        return toks, args.n / t_sample

    arm_hists, arm_tokens = {}, {}  # per arm: the marginal histogram and the raw token grids (flip rate)

    @torch.no_grad()
    def eval_arm(m, label=None):
        """(metric fields, sampling images/s, the headline Fréchet value)."""
        toks, rate = generate(m)
        if token_space:
            tok_batches = [t.cpu().numpy() for t in toks]
            t0 = time.time()
            feats, hist = token_stats(tok_batches, codebook, proj)
            t_feat[0] += time.time() - t0
            if label is not None:
                arm_hists[label] = hist
                arm_tokens[label] = np.concatenate(tok_batches, 0)
            fr = float(fid_from_features(real_feats, feats))
            return {"token_frechet": round(fr, 4), "token_js_to_real": round(js_div(hist, real_hist), 4)}, rate, fr
        t0 = time.time()
        imgs = [vq.decode_indices(t).clamp(0.0, 1.0).float().cpu().numpy() for t in toks]
        feats = features_over_batches(extract, imgs)
        t_feat[0] += time.time() - t0
        fr = float(fid_from_features(real_feats, feats))
        return {"fid_synthetic_featurizer": round(fr, 4)}, rate, fr

    def quantized(m):
        return _with_act_quant(quantize_paella_int8(m, levels=q_levels, include_first=True))

    if args.trend:
        # arms are made one at a time: one denoiser (and its twin) resident
        if mgr is None:
            specs = [("init", 0, init_model), ("perturbed-init", 0, lambda: perturbed_(init_model()))]
        else:
            steps = mgr.all_steps() if args.trend_steps == "all" else [int(s) for s in args.trend_steps.split(",")]
            specs = [("init", 0, init_model)] + [(f"step-{s}", s, lambda s=s: restore_step(s)[0]) for s in steps]
        arms, frechets = [], []
        for label, s, make_model in specs:
            m = make_model()
            vals, rate, fr = eval_arm(m, label)
            frechets.append(fr)
            arms.append({"arm": label, "denoiser_step": s, **vals, "sampling_images_per_sec": round(rate, 2)})
            print(f"[eval] {label}: {vals}", flush=True)
            if args.w8a8:
                qlabel = label + "-w8a8"
                qm = quantized(m)
                qvals, qrate, _ = eval_arm(qm, qlabel)
                del qm
                if token_space:
                    qvals["token_js_to_bf16_twin"] = round(js_div(arm_hists[qlabel], arm_hists[label]), 6)
                    # the twins' per-position disagreement on the same seeds
                    qvals["token_flip_to_bf16_twin"] = round(float((arm_tokens[qlabel] != arm_tokens[label]).mean()), 6)
                arms.append({"arm": qlabel, "denoiser_step": s, **qvals, "sampling_images_per_sec": round(qrate, 2)})
                print(f"[eval] {qlabel}: {qvals}", flush=True)
            del m
            gc.collect()
        if token_space:
            out = {
                "metric": "token-space Frechet + marginal JS vs training step (generated tokens vs encode(real))",
                "token_frechet_floor_real_vs_real": round(float(floor), 4),
                "token_js_floor_real_vs_real": round(js_floor, 4),
            }
            path = os.path.join(args.workdir, "eval_token_trend.json")
        else:
            out = {
                "metric": "FID vs training step (sample -> decode -> inception pool3 -> FID)",
                "caveat": "seeded featurizer: a random-projection FID, comparable across arms (same featurizer and "
                          "real set), not to published numbers",
                "real_set": "codec-recon" if args.real_recon else "jpeg",
                "fid_noise_floor_real_vs_real": round(float(floor), 4),
            }
            path = os.path.join(args.workdir, "eval_fid_trend.json")
        if args.w8a8:
            out["w8a8"] = {"levels": list(q_levels), "include_first": True,
                           "note": "per-step '-w8a8' twin = the same restored parameters quantized, act_quant "
                                   "sampling, same seeds"}
            path = path.replace(".json", "_w8a8.json")
        if args.codec:
            path = path.replace(".json", "_trainedcodec.json")
        out.update({"arms": arms, "monotone_improving": bool(all(a > c for a, c in zip(frechets, frechets[1:])))})
    else:
        if mgr is None:
            m, step = perturbed_(init_model()), 0  # the zero-init head would sample uniformly
        else:
            m, step = restore_step()
        vals, gen_rate, _ = eval_arm(m)
        del m
        if token_space:
            out = {
                "metric": "token-space eval (sample -> token Frechet/JS vs encode(real))",
                "token_frechet_floor_real_vs_real": round(float(floor), 4),
                "token_js_floor_real_vs_real": round(js_floor, 4),
            }
            path = os.path.join(args.workdir, "eval_token.json")
        else:
            out = {
                "metric": "eval pipeline e2e (sample -> decode -> inception pool3 -> FID)",
                "caveat": "seeded featurizer and seeded towers: the FID value is an execution proof, not a quality claim",
                "real_set": "codec-recon" if args.real_recon else "jpeg",
                "fid_noise_floor_real_vs_real": round(float(floor), 4),
            }
            path = os.path.join(args.workdir, "eval_fid.json")
        out.update({"denoiser_step": step, **vals, "sampling_images_per_sec": round(gen_rate, 2)})
    out.update({
        "device": drv.device_name(device),
        "codec": args.codec or "random-init",
        "n_per_set": args.n,
        "image": args.image,
        "sampler_steps": args.steps,
        "cfg": args.cfg,
        "byt5": args.byt5,
        "real_data": data_text,
        "featurize_wall_s": round(t_feat[0], 1),
        "total_wall_s": round(time.time() - t0_all, 1),
        "peak_bytes": drv.peak_bytes(device),
        "launches": drv.kernel_launches(),
    })
    with open(path, "w") as fh:
        json.dump(out, fh, indent=1)
    print(f"wrote {path}", flush=True)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
