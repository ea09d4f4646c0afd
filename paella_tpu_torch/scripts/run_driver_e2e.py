"""The production training driver end to end, the counterpart of the JAX
repo's `scripts/run_driver_e2e.py` (the reference's per-process trainer,
src_distributed/train.py:74-183), on one card:

    WebDataset tar shards -> metadata filter -> JPEG decode/resize/crop
    -> frozen ByT5-XL + CLIP ViT-H (text and vision) conditioning encodes
    -> train step (the frozen codec's encode, the denoiser forward and
       backward, AdamW) -> checkpoints at an interval -> eval collages
    -> SIGTERM preemption -> a fresh process resumes.

The towers' weights are seeded (no checkpoint is at hand) at the real
geometries (T5Config.byt5_xl, CLIPText/VisionConfig.vit_h_14), cast to
bf16, the frozen towers' serving dtype; every code path is the production
one. Protocol:

    python -m paella_tpu_torch.scripts.run_driver_e2e --steps 500 &   # phase A
    kill -TERM <pid>                                                  # preemption
    python -m paella_tpu_torch.scripts.run_driver_e2e --steps 500     # phase B: resume to 500

The last line of standard output is one JSON summary (also written to
<workdir>/summary.json) with the steady-state images/s of data, encoders and
step together, the peak device memory and the kernels' launch counts.
`--smoke` runs the tiny geometry on the CPU. `--codec` takes a
codec_vars.npz in the JAX package's flat layout, written by either
package's codec pretraining script.

The shared helpers (`make_geometry`, `make_shards`, `build_encoders`,
`make_encode_fns`, `clip_tokenize`) are imported by run_codec_pretrain and
run_eval_e2e, as the JAX scripts share theirs.
"""
from __future__ import annotations

import argparse
import dataclasses
import io
import json
import os
import time
from typing import Sequence

import numpy as np
import torch

CAPTION_OBJECTS = (
    "corgi", "lighthouse", "teapot", "mountain", "sailboat", "violin",
    "cactus", "library", "waterfall", "bicycle", "lantern", "fox",
)
CAPTION_STYLES = (
    "a photo of", "an oil painting of", "a watercolor of", "a sketch of",
    "a macro shot of", "a studio portrait of",
)
TOWER_SEEDS = {"byt5": 10, "clip_text": 11, "clip_vision": 12}  # the JAX script's PRNGKey(10/11/12)


def make_geometry(name: str):
    """(PaellaConfig, VQConfig) of a named production-shaped geometry, the
    JAX script's values exactly (reference production config:
    src_distributed/train.py:32,48). run_eval_e2e restores checkpoints at the
    geometry the driver trained them."""
    from ..config import PaellaConfig, VQConfig

    if name == "mid":
        # the flagship's depth (blocks 6/16/6) and head count at 80% width
        p_cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl(), c_hidden=(512, 1024, 1024), dtype="bfloat16", remat=True)
    elif name == "1b":
        # the reference's production 1B config: c_hidden 640/1280/1280, blocks 6/16/6, byt5_embd 2560
        p_cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl(), dtype="bfloat16", remat=True)
    else:
        if name != "small":
            raise ValueError(f"geometry {name!r}: one of small, mid, 1b")
        # half the flagship's width and depth, ByT5-XL conditioning widths
        p_cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl(), c_hidden=(320, 640, 640), nhead=(-1, 8, 8),
                                    blocks=(4, 12, 4), dtype="bfloat16", remat=True)
    return p_cfg, dataclasses.replace(VQConfig(), dtype="bfloat16")


def synth_image(rng: np.random.Generator, size: int) -> np.ndarray:
    """A low-frequency random image: an 8x8 colour field upsampled to `size`
    with three rectangles, so JPEG compresses it sanely and crops differ."""
    base = rng.uniform(0.0, 1.0, (8, 8, 3)).astype(np.float32)
    img = np.kron(base, np.ones((size // 8, size // 8, 1), np.float32))
    for _ in range(3):
        y, x = rng.integers(0, size - 16, 2)
        h, w = rng.integers(8, size // 3, 2)
        img[y : y + h, x : x + w] = rng.uniform(0, 1, 3)
    return np.clip(img, 0.0, 1.0)


def make_shards(shard_dir: str, n_shards: int, per_shard: int, size: int, seed: int = 0) -> list:
    """Write WebDataset-layout tar shards (jpg + txt + json) that pass the
    production SampleFilter; a shard already on disk is kept."""
    from PIL import Image

    from ..data import write_tar_shard

    os.makedirs(shard_dir, exist_ok=True)
    paths = []
    for s in range(n_shards):
        path = os.path.join(shard_dir, f"shard-{s:04d}.tar")
        paths.append(path)
        if os.path.exists(path):
            continue
        rng = np.random.default_rng(seed + s)

        def samples():
            for i in range(per_shard):
                img = synth_image(rng, size)
                buf = io.BytesIO()
                Image.fromarray((img * 255 + 0.5).astype(np.uint8)).save(buf, format="JPEG", quality=92)
                cap = (f"{CAPTION_STYLES[int(rng.integers(len(CAPTION_STYLES)))]} a "
                       f"{CAPTION_OBJECTS[int(rng.integers(len(CAPTION_OBJECTS)))]}")
                meta = {"original_width": size * 2, "original_height": size * 2, "pwatermark": 0.1,
                        "aesthetic": 6.0, "punsafe": 0.0}
                yield f"{s:04d}{i:06d}", {"jpg": buf.getvalue(), "txt": cap.encode(), "json": json.dumps(meta).encode()}

        write_tar_shard(path, samples())
        print(f"[shards] wrote {path}", flush=True)
    return paths


def jpeg_shards_possible() -> tuple[bool, str]:
    """Whether JPEG shards can be written (PIL) and read (a decoder) here,
    and what was found."""
    from ..data import jpeg_decoder

    try:
        import PIL  # noqa: F401
        pil = True
    except ImportError:
        pil = False
    decoder = jpeg_decoder()
    return pil and decoder != "none", f"PIL {'present' if pil else 'absent'}, JPEG decoder {decoder}"


def image_stream(shard_dir: str, args, num_workers: int | None, shards=None, per_shard=None):
    """(an iterator of (images, captions) batches, what it reads): the
    WebDatasetLoader over JPEG tar shards in `shard_dir` (written first when
    `shards` is given), or, only where no JPEG can be written or read on
    this machine, the seeded SyntheticDataset, said so on standard output."""
    from ..data import SampleFilter, SyntheticDataset, WebDatasetLoader

    ok, found = jpeg_shards_possible()
    if not ok:
        text = f"SyntheticDataset(seed=0) ({found}: no JPEG shard can be written or read)"
        print(f"[data] {text}", flush=True)
        return iter(SyntheticDataset(batch_size=args.batch, image_size=args.image, seed=0)), text
    if shards is not None:
        paths = make_shards(shard_dir, shards, per_shard, args.image)
    else:
        paths = sorted(os.path.join(shard_dir, s) for s in os.listdir(shard_dir) if s.endswith(".tar"))
    kw = {} if num_workers is None else {"num_workers": num_workers}
    loader = WebDatasetLoader(shards=paths, batch_size=args.batch, image_size=args.image, shuffle_buffer=64,
                              filter=SampleFilter(min_size=args.image), shard_offset=0, shard_stride=1, **kw)
    text = f"WebDatasetLoader over {len(paths)} JPEG tar shards ({found})"
    print(f"[data] {text}", flush=True)
    return iter(loader), text


def clip_tokenize(prompts: Sequence[str], vocab_size: int, context_length: int) -> np.ndarray:
    """The stand-in CLIP tokenizer of the JAX script (the byte BPE needs a
    merge table no run here has): byte ids, SOT and EOT the two highest ids,
    so the encoder's cost and shape are the real tokenizer's and EOT keeps
    the highest-id convention the text tower's pooling reads."""
    sot, eot = vocab_size - 2, vocab_size - 1
    ids = np.zeros((len(prompts), context_length), np.int32)
    for i, p in enumerate(prompts):
        body = [1 + (b % (sot - 1)) for b in p.encode("utf-8")[: context_length - 2]]
        seq = [sot] + body + [eot]
        ids[i, : len(seq)] = seq
    return ids


def make_encode_fns(t5, clip_text, clip_vision, bucket: int, device):
    """(encode_batch, null) over given towers: encode_batch(images (B, H, W,
    3) in [0, 1], captions) -> train.Batch on `device` (ByT5 states at a
    fixed byte bucket and its mask, the CLIP text embedding of the stand-in
    tokens, the CLIP image embedding of the preprocessed images), with
    `encode_batch.encode_text(captions)` -> (byt5, byt5_mask, clip), the
    generation-time subset; null = the towers' outputs for "" (the reference
    recomputes them per batch, src_distributed/train.py:79-91)."""
    from ..cond import byt5_batch_encode, clip_preprocess
    from ..train import Batch, NullCond

    txt, size = clip_text.config, clip_vision.config.image_size
    on = lambda a: torch.from_numpy(a).to(device)  # noqa: E731

    def byt5(captions):
        ids, mask = byt5_batch_encode(list(captions), pad_to=bucket)
        mask = on(mask)
        return t5(on(ids), mask), mask

    def clip_text_encode(captions):
        return clip_text(on(clip_tokenize(list(captions), txt.vocab_size, txt.context_length)))

    def encode_text(captions):
        states, mask = byt5(captions)
        return states, mask, clip_text_encode(captions)

    def encode_batch(images, captions) -> Batch:
        imgs = torch.as_tensor(np.asarray(images, np.float32)).to(device)
        states, mask, clip = encode_text(captions)
        return Batch(images=imgs, byt5=states, byt5_mask=mask, clip=clip,
                     clip_image=clip_vision(clip_preprocess(imgs, size)))

    encode_batch.encode_text = encode_text
    states, mask, clip = encode_text([""])
    return encode_batch, NullCond(byt5=states, byt5_mask=mask, clip=clip)


def build_encoders(args, device):
    """The frozen conditioning towers at the production geometry (tiny under
    args.smoke), seeded and cast to bf16 on `device`: ByT5-XL (int8 weights
    under args.byt5 "int8", W8A8 under "w8a8", quant.quantize_t5_int8), CLIP
    ViT-H-14 text and vision. Returns (encode_batch, null, byt5_embd,
    clip_embd), make_encode_fns' pair at args.byt5_bucket."""
    from ..cond import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder, T5Config, T5Encoder
    from ..quant import quantize_t5_int8

    if args.smoke:
        t5_cfg, txt_cfg, vis_cfg = T5Config.tiny(), CLIPTextConfig.tiny(), CLIPVisionConfig.tiny()
    else:
        t5_cfg, txt_cfg, vis_cfg = T5Config.byt5_xl(), CLIPTextConfig.vit_h_14(), CLIPVisionConfig.vit_h_14()
    if args.byt5 == "w8a8":  # int8 weights and per-row int8 activations (quant.w8a8_dot)
        t5_cfg = dataclasses.replace(t5_cfg, act_quant=True)

    def seeded(module, seed):
        module.reset_parameters(torch.Generator(device=device).manual_seed(seed))
        return module.to(torch.bfloat16).eval()  # every float tensor, as the JAX script casts the trees

    t0 = time.perf_counter()
    with torch.device(device):
        t5 = seeded(T5Encoder(t5_cfg), TOWER_SEEDS["byt5"])
    n_t5 = sum(p.numel() for p in t5.parameters())
    print(f"[encoders] byt5 d_model={t5_cfg.d_model} params={n_t5 / 1e9:.2f}B init {time.perf_counter() - t0:.1f}s",
          flush=True)
    if args.byt5 in ("int8", "w8a8"):
        t5 = quantize_t5_int8(t5)
        print(f"[encoders] byt5 weights quantized to int8 (mode={args.byt5})", flush=True)
    with torch.device(device):
        clip_text = seeded(CLIPTextEncoder(txt_cfg), TOWER_SEEDS["clip_text"])
        clip_vision = seeded(CLIPVisionEncoder(vis_cfg), TOWER_SEEDS["clip_vision"])
    n_clip = sum(p.numel() for m in (clip_text, clip_vision) for p in m.parameters())
    print(f"[encoders] clip text+vision params={n_clip / 1e6:.0f}M", flush=True)
    encode_batch, null = make_encode_fns(t5, clip_text, clip_vision, args.byt5_bucket, device)
    return encode_batch, null, t5_cfg.d_model, txt_cfg.embed_dim


def load_codec(vq, path: str) -> None:
    """Load a codec_vars.npz (the JAX package's flat {params, batch_stats}
    layout, as either package's codec pretraining writes it) into `vq`."""
    from ..convert import load_params_npz, vqgan_state_dict_from_jax

    sd = vqgan_state_dict_from_jax(load_params_npz(path), vq.config)
    vq.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}, strict=True)


def kernel_launches() -> dict:
    """Every kernel wrapper's launch count in this process (K1 and K1b also
    by mode) and its plain version's, which a run on the card keeps at 0."""
    from ..kernels import attention, attn_block, quantize, resblock, sampling

    fns = (resblock.fused_resblock, sampling.fused_head_categorical, sampling.gumbel_categorical,
           quantize.fused_codebook_lookup, attention.fused_attention, attn_block.fused_attn_block,
           resblock.resblock_plain, sampling.head_categorical_plain, sampling.gumbel_categorical_plain,
           quantize.codebook_lookup_plain, attention.attention_plain, attn_block.attn_block_plain)
    out = {f.__name__: f.launches for f in fns}
    out.update({f"fused_resblock[{m}]": n for m, n in resblock.fused_resblock.launches_by_mode.items()})
    return out


def device_of(args) -> torch.device:
    """The run's device: the CPU under --smoke, else --device, which raises
    where it names a CUDA device and no card is present."""
    from ..cond.loader import resolve_device

    return resolve_device("cpu" if args.smoke else args.device)


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def peak_bytes(device: torch.device):
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def main(argv=None):
    ap = argparse.ArgumentParser(description="paella_tpu_torch production training driver, end to end")
    ap.add_argument("--workdir", default="runs/driver_e2e")
    ap.add_argument("--steps", type=int, default=500)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--image", type=int, default=256)
    ap.add_argument("--log-every", type=int, default=25)
    ap.add_argument("--eval-every", type=int, default=150)
    ap.add_argument("--shards", type=int, default=2)
    ap.add_argument("--per-shard", type=int, default=512)
    ap.add_argument("--byt5", default="bf16", choices=["bf16", "int8", "w8a8"],
                    help="frozen ByT5-XL residency: int8/w8a8 halve its 5.2 GB of weights; w8a8 also runs "
                         "int8 x int8 products")
    ap.add_argument("--geometry", default="small", choices=["small", "mid", "1b"],
                    help="denoiser geometry: 'small' = half width and depth; 'mid' = flagship depth at 80%% "
                         "width; '1b' = the reference's production config (src_distributed/train.py:32,48)")
    ap.add_argument("--adam-moments", default="f32", choices=["f32", "bf16"], help="Adam moment dtype")
    ap.add_argument("--byt5-bucket", type=int, default=64, help="fixed byte-token pad length")
    ap.add_argument("--workers", type=int, default=2)
    ap.add_argument("--encode-prefetch", type=int, default=1,
                    help="overlap batch N+1's conditioning encodes with step N (DriverConfig.encode_prefetch; "
                         "0 = synchronous)")
    ap.add_argument("--codec", default=None,
                    help="codec_vars.npz from run_codec_pretrain (either package's): train against a trained "
                         "codec instead of the seeded one")
    ap.add_argument("--smoke", action="store_true", help="tiny geometry on the CPU: a rehearsal of this script")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda; 'cpu' runs the plain versions)")
    args = ap.parse_args(argv)

    from ..codec import VQModel
    from ..config import PaellaConfig, TrainConfig, VQConfig
    from ..data import background_iterator
    from ..models import Paella
    from ..train import DriverConfig, run_training

    if args.smoke:
        args.image, args.batch, args.per_shard, args.byt5_bucket = 64, 4, 24, 16
    device = device_of(args)
    print(f"[driver-e2e] device: {device_name(device)}", flush=True)

    stream, data_text = image_stream(os.path.join(args.workdir, "shards"), args, args.workers,
                                     shards=args.shards, per_shard=args.per_shard)
    data_iter = background_iterator(stream, depth=2)

    if args.smoke:
        p_cfg = dataclasses.replace(PaellaConfig.tiny(), byt5_embd=32, clip_embd=24, dtype="bfloat16", remat=True)
        vq_cfg = VQConfig.tiny()
    else:
        p_cfg, vq_cfg = make_geometry(args.geometry)

    encode_batch, null, byt5_embd, clip_embd = build_encoders(args, device)
    if (byt5_embd, clip_embd) != (p_cfg.byt5_embd, p_cfg.clip_embd):
        raise ValueError(f"towers give ({byt5_embd}, {clip_embd}), the denoiser takes ({p_cfg.byt5_embd}, {p_cfg.clip_embd})")

    with torch.device(device):
        vq = VQModel(vq_cfg)
    if args.codec:
        load_codec(vq, args.codec)
        print(f"[driver-e2e] loaded trained codec vars from {args.codec}", flush=True)
    else:
        vq.reset_parameters(torch.Generator(device=device).manual_seed(1))
    vq.eval()

    # a fresh run initializes the denoiser; on resume run_training loads the
    # checkpoint into uninitialized storage, and no init is made
    with torch.device("meta"):
        model = Paella(p_cfg)
    model = model.to_empty(device=device)
    n_params = sum(p.numel() for p in model.parameters())
    ckpt_dir = os.path.join(args.workdir, "checkpoints")
    resuming = os.path.isdir(ckpt_dir) and any(s.isdigit() for s in os.listdir(ckpt_dir))
    if resuming:
        print(f"denoiser params: {n_params / 1e6:.0f}M (resuming: init skipped)", flush=True)
    else:
        model.reset_parameters(torch.Generator(device=device).manual_seed(0))
        print(f"denoiser params: {n_params / 1e6:.0f}M", flush=True)

    t_cfg = TrainConfig(warmup_updates=100, batch_size=args.batch,
                        adam_moment_dtype="bfloat16" if args.adam_moments == "bf16" else "float32")
    d_cfg = DriverConfig(workdir=args.workdir, total_steps=args.steps, log_every=args.log_every,
                         eval_every=args.eval_every, eval_steps=8, max_keep=3, encode_prefetch=args.encode_prefetch)

    t0 = time.time()
    state = run_training(model, vq, data_iter, encode_batch, null, t_cfg, d_cfg)
    wall = time.time() - t0

    # the steady-state rate from the run's own metrics: the rolling images/s
    # of the last logged rows, leaving out the rows right after an eval step
    rates = []
    with open(os.path.join(args.workdir, "metrics.jsonl")) as fh:
        for line in fh:
            row = json.loads(line)
            if row.get("images_per_sec") and row["step"] % args.eval_every > args.log_every:
                rates.append(row["images_per_sec"])
    steady = float(np.median(rates[-6:])) if rates else None

    summary = {
        "metric": "driver e2e (data + frozen encoders + train step, one device)",
        "final_step": int(state.step),
        "wall_s": round(wall, 1),
        "steady_state_images_per_sec": round(steady, 2) if steady else None,
        "batch": args.batch,
        "image": args.image,
        "byt5": args.byt5,
        "geometry": args.geometry,
        "adam_moments": args.adam_moments,
        "encode_prefetch": args.encode_prefetch,
        "data": data_text,
        "device": device_name(device),
        "peak_bytes": peak_bytes(device),
        "launches": kernel_launches(),
    }
    with open(os.path.join(args.workdir, "summary.json"), "w") as fh:
        json.dump(summary, fh, indent=1)
    print(json.dumps(summary), flush=True)


if __name__ == "__main__":
    main()
