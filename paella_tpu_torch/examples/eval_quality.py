"""Quality-evaluation workflow: CLIP score + (CLIP-)FID for a prompt set, the
counterpart of the JAX repo's `examples/eval_quality.py`.

With no arguments it runs the whole workflow on tiny random-weight models
(scores are meaningless, the plumbing is real), on the card unless given
`--device cpu`:

    python -m paella_tpu_torch.examples.eval_quality [--device cpu]

--w8a8-proxy prints the W8A8 quantization quality-proxy table (logits KL +
argmax token-flip rate against the float path, across noise levels t) and
the go/no-go recommendation against the documented thresholds
(quant.w8a8_proxy_verdict). Without --ckpt it runs on a synthetic
fuse-eligible model; with --ckpt, on the flagship geometry (bf16 compute)
loaded from a reference denoiser checkpoint, at a 64x64 latent:

    python -m paella_tpu_torch.examples.eval_quality --w8a8-proxy [--ckpt paella_v3.pt]

--byt5-w8a8-proxy [--stress] [--geometry tiny|small] prints the ByT5
act_quant proxy: float vs W8A8 text encode -> the same denoiser -> logits
drift; --stress adds an arm with outlier channels injected into the encoder
(quant.inject_weight_outliers: 2% of reduction-axis channels scaled 12x).

Weights are drawn by torch generators seeded as the JAX example's PRNGKeys
are numbered; the demo's two images come from the seed pairs
serve.request_seeds([3, 4]) where JAX samples both from the key PRNGKey(3).
"""
from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

PROMPTS = ["a corgi wearing a top hat", "an oil painting of a lighthouse"]


def seeded(module, device, seed: int, perturb: bool = False):
    """`module` drawn from a generator seeded `seed` on `device`; with
    `perturb`, every parameter plus 0.02 N(0, 1) from one seeded seed + 1
    (the zero-init head and FiLM leaves would make the proxies vacuous)."""
    from ..scripts.run_eval_e2e import perturbed_

    module.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return (perturbed_(module, 0.02, seed + 1) if perturb else module).eval()


def tiny_demo(device):
    """4-step text_to_image of PROMPTS at 64x64 on the tiny models, their CLIP
    scores from the tiny CLIP towers, and the CLIP-FID against noised
    copies of the same images. Returns {"images", "scores", "fid"}."""
    from ..codec import VQModel
    from ..cond import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder, T5Config, T5Encoder
    from ..config import PaellaConfig, SampleConfig, VQConfig
    from ..eval import clip_image_features, clip_score, features_over_batches, fid_from_features
    from ..models import Paella
    from ..pipeline import PaellaPipeline
    from ..serve import request_seeds

    t5_cfg = T5Config.tiny()
    with torch.device(device):
        model = seeded(Paella(dataclasses.replace(PaellaConfig.tiny(), byt5_embd=t5_cfg.d_model)), device, 0)
        vq = seeded(VQModel(VQConfig.tiny()), device, 1)
        t5 = seeded(T5Encoder(t5_cfg), device, 2)
        tm = seeded(CLIPTextEncoder(CLIPTextConfig.tiny()), device, 4)
        vm = seeded(CLIPVisionEncoder(CLIPVisionConfig.tiny()), device, 5)
    pipe = PaellaPipeline(model, vq, t5)
    images = pipe.text_to_image(PROMPTS, request_seeds(range(3, 3 + len(PROMPTS))), (64, 64), SampleConfig(steps=4))

    # tiny tokenizer stand-in: mod-vocab byte ids (real path:
    # cond/tokenizers.py::CLIPTokenizer with a merge table)
    ids = np.stack(
        [np.pad(np.frombuffer(p.encode()[:16], np.uint8) % 64, (0, 16))[:16] for p in PROMPTS]
    ).astype(np.int32)
    with torch.no_grad():
        text_feats = tm(torch.from_numpy(ids).to(device))
        extract = clip_image_features(vm)
        scores = clip_score(text_feats, extract(images))
        print("CLIP scores:", np.round(scores.cpu().numpy(), 2))

        # CLIP-FID: generated vs a stand-in "real" set (here: noised copies)
        gen = images.float().cpu().numpy()
        gen_feats = features_over_batches(extract, [gen])
        real = np.clip(gen + np.random.default_rng(0).normal(0, 0.05, gen.shape), 0, 1).astype(np.float32)
        real_feats = features_over_batches(extract, [real])
    fid = fid_from_features(real_feats, gen_feats)
    print("CLIP-FID (gen vs noised-gen):", round(fid, 4))
    return {"images": images, "scores": scores, "fid": fid}


def synthetic_proxy_config():
    """The smallest fuse-eligible geometry, the JAX example's synthetic
    stand-in for --w8a8-proxy without --ckpt."""
    from ..config import PaellaConfig

    return dataclasses.replace(
        PaellaConfig.tiny(),
        c_hidden=(128, 128),
        nhead=(-1, 4),
        blocks=(2, 3),
        level_config=("CT", "CTA"),
        dropout=(0.0, 0.0),
    )


def proxy_model(ckpt, device):
    """(model, latent_hw) of --w8a8-proxy: the flagship geometry in bf16
    compute loaded from `ckpt`, or the synthetic geometry, seeded and
    perturbed."""
    from ..config import PaellaConfig
    from ..models import Paella

    if ckpt is not None:
        from ..cond.loader import load_state_dict

        cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl(), dtype="bfloat16")
        with torch.device(device):
            model = Paella(cfg)
        model.load_state_dict(load_state_dict(ckpt), strict=True)
        return model.eval(), (64, 64)
    with torch.device(device):
        return seeded(Paella(synthetic_proxy_config()), device, 0, perturb=True), (16, 16)


def print_rows(rows) -> None:
    print(f"{'t':>5}  {'KL nats/tok':>12}  {'argmax flip':>12}  {'rel |dlogit|':>12}")
    for r in rows:
        print(f"{r['t']:5.2f}  {r['kl']:12.5f}  {r['flip']:12.3%}  {r['rel']:12.4f}")


def w8a8_proxy_demo(ckpt, device):
    """The denoiser W8A8 proxy's table and verdict; returns (rows, ok)."""
    from ..quant import w8a8_proxy_verdict, w8a8_quality_proxy

    model, latent_hw = proxy_model(ckpt, device)
    rows = w8a8_quality_proxy(model, torch.Generator(device=device).manual_seed(2), latent_hw=latent_hw)
    print_rows(rows)
    ok, msg = w8a8_proxy_verdict(rows)
    print(msg)
    return rows, ok


def byt5_w8a8_proxy_demo(device, stress: bool = False, geometry: str = "tiny"):
    """The ByT5 act_quant proxy on synthetic weights, one arm (two with
    `stress`): float vs W8A8 encode into the same denoiser. The encoder is
    frozen in training, so the stress arm stands in for pretrained weights'
    outlier channels. Returns ({arm: rows}, ok)."""
    from ..cond import T5Config, T5Encoder
    from ..config import PaellaConfig
    from ..models import Paella
    from ..quant import inject_weight_outliers, t5_w8a8_quality_proxy, w8a8_proxy_verdict

    t5_cfg = T5Config.tiny() if geometry == "tiny" else T5Config.byt5_small_like()
    with torch.device(device):
        model = seeded(Paella(dataclasses.replace(PaellaConfig.tiny(), byt5_embd=t5_cfg.d_model)), device, 0, perturb=True)
        t5 = seeded(T5Encoder(t5_cfg), device, 2)
    arms = {"synthetic": t5}
    if stress:
        arms["synthetic_outliers"] = inject_weight_outliers(t5, torch.Generator(device=device).manual_seed(4))

    out, ok_all = {}, True
    for name, enc in arms.items():
        rows = out[name] = t5_w8a8_quality_proxy(enc, model, torch.Generator(device=device).manual_seed(3))
        print(f"\n== {name} ({geometry}) ==")
        print_rows(rows)
        ok, msg = w8a8_proxy_verdict(rows)
        ok_all = ok_all and ok
        print("byt5 act_quant:", msg)
    return out, ok_all


def main(argv=None):
    """Run the mode the flags name; returns what it made (the demo's dict,
    or a proxy's rows and verdict)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt", default=None, help="reference denoiser checkpoint")
    ap.add_argument(
        "--w8a8-proxy", action="store_true",
        help="print the W8A8 quality-proxy table + recommendation",
    )
    ap.add_argument(
        "--byt5-w8a8-proxy", action="store_true",
        help="print the ByT5 act_quant downstream quality-proxy table",
    )
    ap.add_argument(
        "--stress", action="store_true",
        help="add an outlier-injected arm to the ByT5 proxy",
    )
    ap.add_argument(
        "--geometry", default="tiny", choices=("tiny", "small"),
        help="ByT5 proxy geometry: tiny or byt5_small_like (1472 wide, 12 layers)",
    )
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' runs the plain versions)")
    args, _ = ap.parse_known_args(argv)
    if args.ckpt is not None and not (args.w8a8_proxy or args.byt5_w8a8_proxy):
        raise SystemExit(
            "real-weights evaluation: load the models with paella_tpu_torch.serve.build_pipeline "
            "(or paella_tpu_torch.cond.loader), then follow tiny_demo()'s metric calls "
            "(paella_tpu_torch.eval)"
        )
    from ..cond.loader import resolve_device

    device = resolve_device(args.device)
    if args.byt5_w8a8_proxy:
        return byt5_w8a8_proxy_demo(device, stress=args.stress, geometry=args.geometry)
    if args.w8a8_proxy:
        return w8a8_proxy_demo(args.ckpt, device)
    return tiny_demo(device)


if __name__ == "__main__":
    main()
