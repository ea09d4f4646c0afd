"""Text-to-image / inpaint / outpaint / img2img / interpolation / structural
editing through PaellaPipeline, the counterpart of the JAX repo's
`examples/generate.py`.

With reference checkpoints (the denoiser as a torch `.pt` or the JAX
package's `.npz`; no CLIP tower, as in the JAX example):
    python -m paella_tpu_torch.examples.generate --vqgan vqgan_f4.pt \\
        --denoiser paella_v3.pt --byt5 byt5_xl.pt --prompt "a corgi wearing a top hat"

Without checkpoints it runs the tiny demo config with seeded random weights
(the whole API and its timing; the images are noise).

Where the JAX example takes the keys fast_key(42) and fast_key(1..5), the
port takes the seed pairs serve.request_seeds([n]), the words of
jax.random.PRNGKey(n): an rbg key's stream cannot be reproduced.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch


def build_pipeline(args):
    """The flagship from checkpoint files (serve.build_pipeline at
    PaellaConfig.v1_byt5_xl_inference(), no CLIP tower), or the tiny demo:
    PaellaConfig.tiny() at byt5_embd 32, VQConfig.tiny() and a
    T5Config.tiny() encoder drawn from generators seeded 0, 1 and 2."""
    from ..cond.loader import resolve_device

    device = resolve_device(args.device)
    if args.denoiser:
        from ..serve import build_pipeline as build

        return build(args.denoiser, args.vqgan, args.byt5, device=device)

    from ..codec import VQModel
    from ..cond import T5Config, T5Encoder
    from ..config import PaellaConfig, VQConfig
    from ..models import Paella
    from ..pipeline import PaellaPipeline

    print("[demo] no checkpoints given - tiny random-weight demo")
    with torch.device(device):
        model = Paella(dataclasses.replace(PaellaConfig.tiny(), byt5_embd=32))
        vq = VQModel(VQConfig.tiny())
        t5 = T5Encoder(T5Config.tiny())
    for module, seed in ((model, 0), (vq, 1), (t5, 2)):
        module.reset_parameters(torch.Generator(device=device).manual_seed(seed))
    return PaellaPipeline(model.eval(), vq.eval(), t5.eval())


def main(argv=None) -> dict:
    """Run the six calls; returns their images by name and each call's ms."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--prompt", default="a painting of a corgi wearing a top hat")
    ap.add_argument("--vqgan", default=None)
    ap.add_argument("--denoiser", default=None)
    ap.add_argument("--byt5", default=None)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--size", type=int, default=None, help="image size (default: 256 full / 64 demo)")
    ap.add_argument("--out", default="out")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from ..cond.tokenizers import pad_bucket
    from ..config import SampleConfig
    from ..sampling.editing import reweight_for_phrase
    from ..serve import request_seeds
    from ..utils.logging import save_image_grid

    pipe = build_pipeline(args)
    size = args.size or (256 if args.denoiser else 64)
    cfg = SampleConfig(steps=args.steps)
    device = pipe.device
    out, ms = {}, {}

    def timed(name: str, fn):
        t0 = time.perf_counter()
        img = fn()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        ms[name] = (time.perf_counter() - t0) * 1e3
        out[name] = img
        print(f"{name}: {tuple(img.shape)} in {ms[name] / 1e3:.2f}s")
        return img

    def save(path: str, images) -> None:
        if not save_image_grid(path, images.float().cpu().numpy()):
            print(f"(no PIL: {path} not written)")

    # 1. text-to-image (the first call of a structure builds the kernels and captures its graph)
    img = timed("text_to_image", lambda: pipe.text_to_image([args.prompt], request_seeds([42]), (size, size), cfg))
    save(f"{args.out}_t2i.jpg", img)

    # 2. inpaint the right half of that image
    f = pipe.vq.config.downscale
    keep = torch.zeros((1, size // f, size // f), dtype=torch.bool, device=device)
    keep[:, :, : size // f // 2] = True
    img2 = timed("inpaint", lambda: pipe.inpaint([args.prompt + ", sunset"], img, keep, request_seeds([1]), cfg))
    save(f"{args.out}_inpaint.jpg", img2)

    # 3. outpaint onto a double-width canvas
    img3 = timed("outpaint", lambda: pipe.outpaint([args.prompt], img, (size, size * 2), (0, size // 2),
                                                   request_seeds([2]), cfg))
    save(f"{args.out}_outpaint.jpg", img3)

    # 4. img2img at reduced strength
    timed("img2img", lambda: pipe.img2img([args.prompt + ", watercolor"], img, request_seeds([3]), strength=0.6,
                                          config=cfg))

    # 5. latent interpolation between two samples
    img_b = timed("text_to_image_b", lambda: pipe.text_to_image([args.prompt + " at night"], request_seeds([4]),
                                                                (size, size), cfg))
    frames = timed("interpolate", lambda: pipe.interpolate(img[0], img_b[0], n=5))
    save(f"{args.out}_interp.jpg", frames)

    # 6. structural editing: boost attention to one phrase. One prompt's
    # (1, S) weights stacked for the CFG batch's two halves, S the prompt's
    # ByT5 bucket (no CLIP tokens: the pipeline has no CLIP tower)
    phrase = args.prompt.split()[-1]
    ids_len = len(args.prompt.encode("utf-8")) + 1
    w = reweight_for_phrase(args.prompt, phrase, 3.0, pad_bucket(ids_len), has_clip=False)
    reweight = torch.from_numpy(np.concatenate([w, w], 0))
    timed("edited", lambda: pipe.text_to_image([args.prompt], request_seeds([5]), (size, size), cfg,
                                               cond_reweight=reweight))
    print(f"edited (boosted {phrase!r}): {tuple(out['edited'].shape)}")
    return {"images": out, "ms": ms, "pipeline": pipe}


if __name__ == "__main__":
    main()
