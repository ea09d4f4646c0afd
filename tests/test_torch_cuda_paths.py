"""The port's paths on an NVIDIA GPU at the widths users run them: the
flagship's generation, pipeline, server and serving entry point, the int8
path, the sampler's CUDA graphs, the training step, driver, codec trainer,
DDP and FSDP, the production scripts and the examples. Each test checks what
its path launches (the kernel wrappers' counts, and a graph replay's kernels
from torch.profiler) and what it gives against the plain versions, the CPU or
the uninterrupted run. Every test carries the `cuda` marker and skips without
a card; the module imports neither jax nor the JAX package, so it also runs
on a machine that has only the port:

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda_paths.py
"""
import dataclasses
import gc
import itertools
import json
import math
import os
import shutil
import signal
import socket
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch
from _cuda_flagship import (
    ATTN_FLAGS,
    BYT5_LEN,
    GRAPH_PASSES,
    K1_PER_FORWARD,
    K5_PER_FORWARD,
    K6_PER_FORWARD,
    LATENT,
    STEPS,
    build_flagship,
    check_launches,
    counted,
    flagship_conditioning,
    flagship_generation,
    perturb_,
)

pytestmark = pytest.mark.cuda

REPO = Path(__file__).resolve().parents[1]
# the kernels of a trace by the name of one kernel each call launches once
REPLAY_KERNELS = {"K1": ("dw_ln_kernel",), "K2": ("head_wgmma_kernel", "head_simt_kernel"), "K3": ("gumbel_kernel",),
                  "K4": ("lookup_kernel",), "K5": ("attention_ring_kernel",), "K6": ("block_attention_kernel",)}
TRAIN_BATCH, TRAIN_HW, TRAIN_BYT5_LEN = 8, 256, 77


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    flags = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # the plain versions' f32 products
    yield torch.device("cuda")
    from paella_tpu_torch.sampling import graph

    graph.clear()
    # a failed test's frames (and the models in them) stay reachable from sys.last_traceback
    sys.last_type = sys.last_value = sys.last_traceback = None
    gc.collect()
    torch.cuda.empty_cache()
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def replay_counts(fn) -> dict:
    """The calls of each kernel of REPLAY_KERNELS in one fn() call after a
    warm-up (a generation whose graph is captured: a replay), from a
    torch.profiler trace (five tries: the card's tracer now and then catches
    nothing)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        kernels = {e.key: e.count for e in prof.key_averages() if e.device_type != DeviceType.CPU
                   and not getattr(e, "is_user_annotation", False) and e.self_device_time_total > 0}
        if kernels:
            return {k: sum(n for name, n in kernels.items() if any(m in name for m in marks))
                    for k, marks in REPLAY_KERNELS.items()}
    pytest.fail("torch.profiler traced no kernel of a replay in 5 tries")


def flagship_towers(p_cfg, gen):
    """Seeded stand-ins for the text towers, on the card: a table from byte
    ids to (B, S, byt5_embd) states, and CLIP-text features summed from a
    table over each prompt's bytes (the real towers:
    test_serving_entry_point_from_checkpoint_files)."""
    table = torch.randn(260, p_cfg.byt5_embd, generator=gen, device="cuda").to(torch.bfloat16)
    text_proj = torch.randn(256, p_cfg.clip_embd, generator=gen, device="cuda") / 16

    def byt5_encode_fn(ids, mask):
        return table[ids.long()]

    def clip_text_fn(prompts):
        rows = [text_proj[torch.tensor(list(p.encode("utf-8")), dtype=torch.long, device="cuda")].sum(0) for p in prompts]
        return torch.stack(rows).to(torch.bfloat16)

    return byt5_encode_fn, clip_text_fn


def to_uint8(img):
    return (img.float().clamp(0, 1) * 255).to(torch.uint8)


def image_ok(img, shape: tuple) -> bool:
    return (tuple(img.shape) == shape and bool(torch.isfinite(img).all())
            and 0.0 <= img.min().item() <= img.max().item() <= 1.0)


def rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (bound, then released for the server)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tail_of(log) -> str:
    log.flush()
    log.seek(0)
    return log.read()[-3000:]


def jsonl(path) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("config", ["fused_head", "attention"])
def test_flagship_generation(cuda, config):
    """8-step CFG sampling at the flagship (seeded bf16 weights), batch 1,
    and the codec decode of its tokens: the kernels a generation launches in
    its graph's warm-up and capture and in one replay, tokens in range and
    not all equal, a finite uint8 256x256 image. "fused_head": the default
    config drawing through K2 (categorical_impl "pallas"); "attention": the
    attention config (K5, K6) on the default "xla" draw (K3)."""
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.sampling import sample

    attention = config == "attention"
    gen = torch.Generator(device=cuda).manual_seed(7 if attention else 0)
    model, vq, p_cfg = build_flagship(gen, **(ATTN_FLAGS if attention else {}))
    cond, uncond = flagship_conditioning(p_cfg, gen)
    draw = "xla" if attention else "pallas"
    mark = 0xA77E if attention else 0x5EED
    tokens, _ = flagship_generation(model, cond, uncond, torch.tensor([[42, mark]], dtype=torch.int64), draw, attention)
    s_cfg = SampleConfig(steps=STEPS, categorical_impl=draw)
    k2, k3 = (0, STEPS) if attention else (STEPS, 0)
    k5, k6 = (K5_PER_FORWARD, K6_PER_FORWARD) if attention else (0, 0)
    seeds = torch.tensor([[43, mark]], dtype=torch.int64)
    assert replay_counts(lambda: sample(model, seeds, cond, LATENT, uncond, s_cfg)) == {
        "K1": K1_PER_FORWARD * STEPS, "K2": k2, "K3": k3, "K4": 0, "K5": k5 * STEPS, "K6": k6 * STEPS}
    assert tuple(tokens.shape) == LATENT and tokens.dtype == torch.int32, (tuple(tokens.shape), tokens.dtype)
    assert bool(((tokens >= 0) & (tokens < p_cfg.num_labels)).all())
    assert int(torch.unique(tokens).numel()) > 1, "all tokens equal"
    img = vq.decode_indices(tokens)
    image = to_uint8(img)
    assert bool(torch.isfinite(img.float()).all())
    assert tuple(image.shape) == (1, 256, 256, 3) and image.dtype == torch.uint8


def test_attention_config_forward_against_f32(cuda):
    """One CFG forward of the flagship in the attention config: 56 K1, 4 K5
    and 40 K6 launches, and features against the same weights' plain-
    attention forward in f32. The two bf16 routes round at different points,
    so each lies about its bf16 rounding error from the f32 forward (and the
    two about sqrt(2) times that apart): the attention route must come
    within 1.5x the plain bf16 route's distance to it."""
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling.sampler import merge_cfg_pair

    gen = torch.Generator(device=cuda).manual_seed(7)
    model, _, p_cfg = build_flagship(gen, **ATTN_FLAGS)
    cond, uncond = flagship_conditioning(p_cfg, gen)
    with torch.device("cuda"):
        plain = Paella(dataclasses.replace(p_cfg, attention_impl="xla", attn_block_kernel=False))
    plain.load_state_dict(model.state_dict())
    plain = plain.to(torch.bfloat16).eval()
    pair = merge_cfg_pair(cond, uncond)
    cache_args = (pair.byt5, pair.clip, pair.clip_image)
    cache_kw = dict(byt5_mask=pair.byt5_mask, clip_mask=pair.clip_mask, clip_image_mask=pair.clip_image_mask)
    x = torch.randint(0, p_cfg.num_labels, (2, 64, 64), generator=gen, device="cuda")
    r = torch.full((2,), 0.6, device="cuda")
    cache = model.gen_cond_cache(*cache_args, **cache_kw)
    feats, launches = counted(lambda: model(x, r, return_features=True, cond_cache=cache))
    check_launches("attention-config forward", launches,
                   {"fused_resblock": K1_PER_FORWARD, "fused_attention": K5_PER_FORWARD, "fused_attn_block": K6_PER_FORWARD})
    want = plain(x, r, return_features=True, cond_cache=plain.gen_cond_cache(*cache_args, **cache_kw)).float()
    with torch.device("cuda"):
        f32 = Paella(dataclasses.replace(plain.config, dtype="float32"))
    f32.load_state_dict(plain.state_dict())
    ref = f32.eval()(x, r, return_features=True, cond_cache=f32.gen_cond_cache(*(t.float() for t in cache_args), **cache_kw))
    assert bool(torch.isfinite(feats).all())
    err, floor = rel_l2(feats, ref), rel_l2(want, ref)
    assert err <= 1.5 * floor, (err, floor)


def test_pipeline_entry_points_at_the_flagship(cuda):
    """PaellaPipeline at the flagship width with the VQConfig() codec
    (encoder included) and seeded tower stand-ins: text_to_image (the default
    SampleConfig: 12 steps, CFG 8, the "xla" draw), img2img, inpaint (the
    kept tokens equal the encoded ones), outpaint (the placed region equals
    the encoded tokens), interpolate and a phrase reweight (which changes
    the image), each with its launch counts and a finite image in [0, 1]."""
    from paella_tpu_torch import PaellaPipeline
    from paella_tpu_torch.sampling.editing import reweight_for_phrase

    gen = torch.Generator(device=cuda).manual_seed(5)
    model, vq, p_cfg = build_flagship(gen)
    byt5_encode_fn, clip_text_fn = flagship_towers(p_cfg, gen)
    pipe = PaellaPipeline(model, vq, byt5_encode_fn, clip_text_fn=clip_text_fn)
    steps = 12
    taps = []  # token grids on their way to the decoder
    decode_clipped = pipe._decode_clipped
    pipe._decode_clipped = lambda tokens: (taps.append(tokens), decode_clipped(tokens))[1]
    prompt = "a red car on a beach"
    seeds = torch.tensor([[0, 0xC0FFEE]], dtype=torch.int64)

    def run(name, fn, expect: dict, shape: tuple):
        taps.clear()
        out, launches = counted(fn)
        assert image_ok(out, shape), f"{name}: image {tuple(out.shape)} (want {shape}), finite and in [0, 1]"
        check_launches(name, launches, expect)
        return out, taps[0] if taps else None

    gen_counts = {"fused_resblock[float]": GRAPH_PASSES * K1_PER_FORWARD * steps, "fused_head_categorical": 0,
                  "gumbel_categorical": GRAPH_PASSES * steps, "fused_attention": 0, "fused_attn_block": 0}
    image, _ = run("text_to_image", lambda: pipe.text_to_image([prompt], seeds), {**gen_counts, "fused_codebook_lookup": 0},
                   (1, 256, 256, 3))
    edited, _ = run("img2img strength 0.8", lambda: pipe.img2img([prompt], image, seeds, strength=0.8),
                    {**gen_counts, "fused_codebook_lookup": 1}, (1, 256, 256, 3))
    tokens0 = pipe.encode_image_tokens(image)
    keep = torch.zeros(1, 64, 64, dtype=torch.bool, device="cuda")
    keep[:, :, :32] = True  # keep the left half
    _, tokens = run("inpaint (left half kept)", lambda: pipe.inpaint([prompt], image, keep, seeds),
                    {**gen_counts, "fused_codebook_lookup": 1}, (1, 256, 256, 3))
    assert torch.equal(tokens[keep], tokens0[keep]), "inpaint: kept tokens differ from the encoded ones"
    _, tokens = run("outpaint 256x256 -> 256x384 at (0, 64)",
                    lambda: pipe.outpaint([prompt], image, (256, 384), (0, 64), seeds),
                    {**gen_counts, "fused_codebook_lookup": 1}, (1, 256, 384, 3))
    assert tuple(tokens.shape) == (1, 64, 96) and torch.equal(tokens[:, :, 16:80], tokens0), \
        "outpaint: the placed region differs from the encoded tokens"
    run("interpolate n=4", lambda: pipe.interpolate(image[0], edited[0], 4),
        {"fused_resblock": 0, "gumbel_categorical": 0, "fused_codebook_lookup": 3}, (4, 256, 256, 3))
    rew = torch.from_numpy(reweight_for_phrase(prompt, "red", 3.0, byt5_len=64, has_clip=True))
    reweighted, _ = run("text_to_image, 'red' x3", lambda: pipe.text_to_image([prompt], seeds, cond_reweight=rew),
                        {**gen_counts, "fused_codebook_lookup": 0}, (1, 256, 256, 3))
    assert not torch.equal(reweighted, image), "the phrase reweight changed nothing"


# PaellaConfig.tiny() in the default and attention configs, drawing through
# the fused head, and in the attention config at widths the kernels take
# since C3's repair (C and head dims not multiples of 8; heads past 128)
TINY_CASES = {
    "default": ({}, "xla"),
    "attention": (ATTN_FLAGS, "xla"),
    "default_fused_head": ({}, "pallas"),
    "attention_odd_widths": ({**ATTN_FLAGS, "c_hidden": (36, 60, 60), "nhead": (-1, 4, 4)}, "xla"),  # head dim 15
    "attention_wide_heads": ({**ATTN_FLAGS, "c_hidden": (32, 320, 320), "nhead": (-1, 2, 2)}, "xla"),  # head dim 160
}


def tiny_on_cpu(flags: dict, categorical_impl: str):
    """PaellaConfig.tiny() with `flags`, seeded and perturbed on the CPU, a
    CFG forward's inputs and 4-step CFG sampling's, and the CPU's tokens."""
    from paella_tpu_torch.config import PaellaConfig, SampleConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling import Conditioning, sample

    cfg = dataclasses.replace(PaellaConfig.tiny(), **flags)
    gen = torch.Generator().manual_seed(3)
    cpu = Paella(cfg)
    cpu.reset_parameters(gen)
    perturb_(cpu, gen, scale=0.05)
    g = torch.Generator().manual_seed(4)
    cond = Conditioning(torch.randn(2, 6, cfg.byt5_embd, generator=g), torch.randn(2, cfg.clip_embd, generator=g),
                        torch.randn(2, cfg.clip_embd, generator=g))
    uncond = Conditioning(torch.randn(2, 3, cfg.byt5_embd, generator=g), torch.randn(2, cfg.clip_embd, generator=g))
    x = torch.randint(0, cfg.num_labels, (2, 16, 16), generator=g)
    r = torch.rand(2, generator=g)
    seeds = torch.tensor([[1, 2], [3, 4]])
    s_cfg = SampleConfig(steps=4, temperature=(1.0, 0.5), cfg=(3.0, 3.0), categorical_impl=categorical_impl)
    tokens = sample(cpu, seeds, cond, (2, 16, 16), uncond, s_cfg)
    return cpu, cond, uncond, x, r, seeds, s_cfg, tokens


@pytest.mark.parametrize("case", list(TINY_CASES))
def test_tiny_model_on_card_matches_cpu(cuda, case):
    """A tiny config's f32 model on the card (the kernels) against the same
    weights on the CPU (the plain versions): a CFG forward's features within
    1e-3, running K1 (and K5 and K6 in the attention config), and 4-step CFG
    tokens agreeing on 95%, the draw's kernel launched GRAPH_PASSES x 4
    times (K2 at the config's c_out and num_labels on the fused head)."""
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling import sample

    flags, impl = TINY_CASES[case]
    cpu, cond, uncond, x, r, seeds, s_cfg, t_cpu = tiny_on_cpu(flags, impl)
    dev = Paella(cpu.config).cuda()
    dev.load_state_dict(cpu.state_dict())
    f_cpu = cpu(x, r, cond.byt5, cond.clip, cond.clip_image, return_features=True)
    f_dev, launches = counted(lambda: dev(x.cuda(), r.cuda(), cond.byt5.cuda(), cond.clip.cuda(), cond.clip_image.cuda(),
                                          return_features=True))
    t_dev, s_launches = counted(lambda: sample(dev, seeds, cond.to("cuda"), (2, 16, 16), uncond.to("cuda"), s_cfg))
    drawer = "fused_head_categorical" if impl == "pallas" else "gumbel_categorical"
    assert s_launches[drawer] == GRAPH_PASSES * 4, s_launches
    ferr = (f_cpu - f_dev.cpu()).abs().max().item()
    assert ferr <= 1e-3, ferr
    agree = (t_cpu == t_dev.cpu()).float().mean().item()
    assert agree >= 0.95, agree
    assert launches["fused_resblock"] > 0, launches
    if cpu.config.attention_impl == "pallas":
        assert launches["fused_attention"] > 0 and launches["fused_attn_block"] > 0, launches


def test_tiny_codec_on_card_matches_cpu(cuda):
    """The tiny f32 codec on the card against the same weights on the CPU:
    the decode of the attention-config tiny model's CPU tokens within 1e-3;
    with the encoder's BatchNorm statistics away from (0, 1), the encoder
    within 1e-3 and encode's indices (K4 on the card) agreeing on 99.9% of
    4x32x32."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import VQConfig

    cpu_model, *_, t_cpu = tiny_on_cpu(*TINY_CASES["attention"])
    gen = torch.Generator().manual_seed(3)
    g = torch.Generator().manual_seed(5)
    vcfg = dataclasses.replace(VQConfig.tiny(), codebook_size=cpu_model.config.num_labels)
    vq_cpu = VQModel(vcfg)
    vq_cpu.reset_parameters(gen)
    perturb_(vq_cpu, gen, scale=0.05)
    vq_dev = VQModel(vcfg).cuda()
    vq_dev.load_state_dict(vq_cpu.state_dict())
    ierr = (vq_cpu.decode_indices(t_cpu) - vq_dev.decode_indices(t_cpu.cuda()).cpu()).abs().max().item()
    assert ierr <= 1e-3, ierr
    norm = vq_cpu.down_blocks[-1][1]
    norm.running_mean.uniform_(-0.5, 0.5, generator=gen)
    norm.running_var.uniform_(0.5, 2.0, generator=gen)
    vq_dev.load_state_dict(vq_cpu.state_dict())
    x = torch.rand(4, 128, 128, 3, generator=g)
    zerr = (vq_cpu.encoder(x) - vq_dev.encoder(x.cuda()).cpu()).abs().max().item()
    assert zerr <= 1e-3, zerr
    agree = (vq_cpu.encode(x)[2] == vq_dev.encode(x.cuda())[2].cpu()).float().mean().item()
    assert agree >= 0.999, agree


def http_get(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        assert resp.status == 200, f"GET {url}: {resp.status}"
        return resp.read()


def http_generate(port: int, req: dict) -> bytes:
    import urllib.request

    body = json.dumps(req).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=600) as resp:
        assert resp.status == 200 and resp.headers["Content-Type"] == "image/png", f"POST /generate: {resp.status}"
        return resp.read()


def test_server_images_equal_the_pipeline(cuda):
    """PaellaServer at the attention config on 127.0.0.1: /healthz; a
    request's launches; three single requests whose PNGs equal the
    pipeline's images for their seed pairs exactly; a repeated request
    byte-identical; micro-batches (max_batch 4) of three concurrent requests
    at 256x256 and at 256x384 (level 2 holds 96 pixels, which K1's 128-row
    fc1 tiles do not divide) with at least 99% of pixels equal to the single
    path's."""
    from paella_tpu_torch import PaellaPipeline
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.serve import PaellaServer, png_pixels, request_seeds
    from paella_tpu_torch.serve import to_uint8 as serve_uint8

    gen = torch.Generator(device=cuda).manual_seed(8)
    model, vq, p_cfg = build_flagship(gen, **ATTN_FLAGS)
    byt5_encode_fn, clip_text_fn = flagship_towers(p_cfg, gen)
    pipe = PaellaPipeline(model, vq, byt5_encode_fn, clip_text_fn=clip_text_fn)
    prompts = ["a red car on a beach", "a lighthouse in a storm, oil on canvas", "a corgi"]
    seeds = [11, 12, 13]

    def req(i, hw=(256, 256)):
        return {"prompt": prompts[i], "seed": seeds[i], "steps": STEPS, "height": hw[0], "width": hw[1]}

    def pipeline_image(i, hw=(256, 256)):
        img = pipe.text_to_image([prompts[i]], request_seeds([seeds[i]]), hw, SampleConfig(steps=STEPS, cfg=8.0))
        return serve_uint8(img[0]).cpu().numpy()

    srv = PaellaServer(pipe, host="127.0.0.1", port=0)
    srv.start()
    try:
        assert http_get(f"http://127.0.0.1:{srv.port}/healthz") == b"ok"
        http_generate(srv.port, req(0))  # warm-up
        png0, launches = counted(lambda: http_generate(srv.port, req(0)))
        check_launches("served request", launches, {
            "fused_resblock": GRAPH_PASSES * K1_PER_FORWARD * STEPS, "gumbel_categorical": GRAPH_PASSES * STEPS,
            "fused_attention": GRAPH_PASSES * K5_PER_FORWARD * STEPS, "fused_attn_block": GRAPH_PASSES * K6_PER_FORWARD * STEPS,
        })
        for i in range(3):
            got = png_pixels(http_generate(srv.port, req(i)))
            assert got.shape == (256, 256, 3), got.shape
            assert bool((got == pipeline_image(i)).all()), f"request {i}: the PNG differs from pipeline.text_to_image"
        assert http_generate(srv.port, req(0)) == png0, "a repeated request gave other bytes"
    finally:
        srv.stop()

    wide = (256, 384)
    singles = {"256x256": [pipeline_image(i) for i in range(3)], "256x384": [pipeline_image(i, wide) for i in range(3)]}
    batched = PaellaServer(pipe, host="127.0.0.1", port=0, max_batch=4, batch_window_ms=200)
    batched.start()
    try:
        pngs = {}
        for name, hw in (("256x256", (256, 256)), ("256x384", wide)):
            with ThreadPoolExecutor(3) as pool:
                pngs[name] = list(pool.map(lambda i: http_generate(batched.port, req(i, hw)), range(3)))
    finally:
        batched.stop()
    for name, got in pngs.items():
        pixels = [png_pixels(p) for p in got]
        assert all(p.shape == w.shape for p, w in zip(pixels, singles[name])), f"{name} PNG shapes"
        same = [float((p == w).mean()) for p, w in zip(pixels, singles[name])]
        assert min(same) >= 0.99, f"micro-batched {name} images agree {same} with the single path"


def seeded_inception_state(gen, device) -> dict:
    """The Inception featurizer's state dict at its real shapes, seeded:
    He-scaled convolutions, BatchNorm near identity."""
    from paella_tpu_torch.eval.inception import INCEPTION_SHAPES, conv_weight_shape

    sd = {}
    for block, units in INCEPTION_SHAPES.items():
        for unit, shape in units.items():
            p = block if unit is None else f"{block}.{unit}"
            w = conv_weight_shape(*shape)
            sd[f"{p}.conv.weight"] = torch.randn(w, generator=gen, device=device) * (2.0 / (w[1] * w[2] * w[3])) ** 0.5
            c = w[0]
            sd[f"{p}.bn.weight"] = 1 + 0.1 * torch.randn(c, generator=gen, device=device)
            sd[f"{p}.bn.bias"] = 0.05 * torch.randn(c, generator=gen, device=device)
            sd[f"{p}.bn.running_mean"] = 0.05 * torch.randn(c, generator=gen, device=device)
            sd[f"{p}.bn.running_var"] = 1 + 0.3 * torch.rand(c, generator=gen, device=device)
    return sd


def test_f32_codec_and_inception_ignore_the_callers_tf32(cuda):
    """Fault C5 at full width: with TF32 on in the caller, the f32
    VQConfig() decode of 2 x 64 x 64 tokens (uint8 pixels) and the Inception
    pool3 features of 32 images at 299x299 equal their outputs in two runs
    under TF32 off bit for bit (the codec and the featurizer pin IEEE
    float32 themselves), and the features lie within 5e-3 of the largest
    of the same weights' on the CPU."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import VQConfig
    from paella_tpu_torch.eval import convert_inception, inception_features

    gen = torch.Generator().manual_seed(40)
    vq_cpu = VQModel(VQConfig())
    vq_cpu.reset_parameters(gen)
    perturb_(vq_cpu, gen, scale=0.05)
    vq_dev = VQModel(VQConfig()).cuda()
    vq_dev.load_state_dict(vq_cpu.state_dict())
    idx = torch.randint(0, 8192, (2, 64, 64), generator=gen)
    sd = seeded_inception_state(gen, "cpu")
    inc_cpu = inception_features(convert_inception(sd))
    inc_dev = inception_features(convert_inception({k: v.cuda() for k, v in sd.items()}))
    images = torch.rand(32, 299, 299, 3, generator=gen)
    want_f = inc_cpu(images)

    def run():
        return to_uint8(vq_dev.decode_indices(idx.cuda())).cpu(), inc_dev(images.cuda()).cpu()

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        on = run()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    off, again = run(), run()
    assert all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(on, off, again)), \
        "the f32 codec decode or the Inception features depend on the caller's TF32 flags"
    rel = (on[1] - want_f).abs().max().item() / want_f.abs().max().item()
    assert rel <= 5e-3, rel


def test_clip_towers_on_card_match_cpu(cuda):
    """The ViT-H-14 widths at depth 2, seeded: the bf16 text and image towers
    on the card against the same weights' f32 towers on the CPU, (2, 1024)
    bf16 features at cosine >= 0.999 for each row."""
    from paella_tpu_torch.cond import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder
    from paella_tpu_torch.cond.clip import clip_preprocess

    gen = torch.Generator().manual_seed(31)
    towers = {}
    for name, cfg_cls, enc_cls in (("text", CLIPTextConfig, CLIPTextEncoder), ("image", CLIPVisionConfig, CLIPVisionEncoder)):
        cfg = dataclasses.replace(cfg_cls.vit_h_14(), layers=2)
        cpu = enc_cls(dataclasses.replace(cfg, dtype="float32"))
        cpu.reset_parameters(gen)
        with torch.device("cuda"):
            dev = enc_cls(cfg)
        dev.load_state_dict(cpu.state_dict())
        dev.cast_products()
        towers[name] = (cpu.eval(), dev.eval())
    # two token rows as the tokenizer lays them out: SOT, ids, EOT (the highest id), zeros
    tokens = torch.zeros(2, 77, dtype=torch.long)
    for row, n in enumerate((8, 40)):
        tokens[row, 0], tokens[row, n + 1] = 49406, 49407
        tokens[row, 1 : n + 1] = torch.randint(0, 49406, (n,), generator=gen)
    images = torch.rand(2, 256, 256, 3, generator=gen)
    feats = {
        "text": (towers["text"][0](tokens), towers["text"][1](tokens.cuda())),
        "image": (towers["image"][0](clip_preprocess(images)), towers["image"][1](clip_preprocess(images.cuda()))),
    }
    for name, (want, got) in feats.items():
        assert got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 1024), (name, got.dtype, tuple(got.shape))
        cos = torch.nn.functional.cosine_similarity(got.float().cpu(), want, dim=-1)
        assert cos.min().item() >= 0.999, (name, cos.tolist())


def synthetic_merges() -> list:
    """A merge table of 5408 merges over lowercase letters (letter pairs,
    word-final pairs, word-final triples), standing in for the
    bpe_simple_vocab_16e6 table, which is not in the repository."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    merges = [(a, b) for a in letters for b in letters]
    merges += [(a, b + "</w>") for a in letters for b in letters]
    merges += [(a + b, c + "</w>") for a in letters for b in letters for c in "aeiost"]
    return merges


def save_bf16(path, modules: dict, extra: dict | None = None) -> None:
    """Modules' state dicts in bf16 (integer buffers as they are), each key
    under its module's prefix in `modules` ({prefix: module}), and `extra`
    as it is, to one torch file."""
    sd = {prefix + k: (v.to(torch.bfloat16) if v.is_floating_point() else v).cpu()
          for prefix, module in modules.items() for k, v in module.state_dict().items()}
    sd.update(extra or {})
    torch.save(sd, path)


def write_entry_checkpoints(d: Path, seed: int) -> dict:
    """Seeded full-width checkpoint files in the layouts the loaders read:
    the flagship denoiser (reference layout), VQConfig()'s codec, the
    ByT5-XL encoder (HF T5EncoderModel layout), open_clip ViT-H-14 (both
    towers and logit_scale) and a synthetic merge table; built on the card one
    at a time and written in bf16. Returns their paths."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.cond import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder, T5Config, T5Encoder
    from paella_tpu_torch.cond.tokenizers import write_merges_file
    from paella_tpu_torch.config import PaellaConfig, VQConfig
    from paella_tpu_torch.models import Paella

    gen = torch.Generator(device="cuda").manual_seed(seed)
    paths = {k: str(d / f) for k, f in (("denoiser", "denoiser.pt"), ("vqgan", "vqgan.pt"), ("byt5", "byt5.pt"),
                                          ("clip", "clip.pt"), ("bpe", "merges.txt"))}
    with torch.device("cuda"):
        model = Paella(PaellaConfig.v1_byt5_xl_inference())
    model.reset_parameters(gen)
    perturb_(model, gen)
    save_bf16(paths["denoiser"], {"": model})
    del model
    with torch.device("cuda"):
        vq = VQModel(VQConfig())
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    save_bf16(paths["vqgan"], {"": vq})
    del vq
    with torch.device("cuda"):
        t5 = T5Encoder(T5Config.byt5_xl())
    t5.reset_parameters(gen)
    save_bf16(paths["byt5"], {"": t5})
    del t5
    with torch.device("cuda"):
        text, vision = CLIPTextEncoder(CLIPTextConfig.vit_h_14()), CLIPVisionEncoder(CLIPVisionConfig.vit_h_14())
    text.reset_parameters(gen)
    vision.reset_parameters(gen)
    save_bf16(paths["clip"], {"": text, "visual.": vision}, {"logit_scale": torch.tensor(4.6052)})
    del text, vision
    write_merges_file(synthetic_merges(), paths["bpe"])
    torch.cuda.empty_cache()
    return paths


def test_serving_entry_point_from_checkpoint_files(cuda, tmp_path):
    """serve.build_pipeline on the card from seeded full-width files
    (ByT5-XL and CLIP ViT-H-14 towers): text_to_image with CLIP conditioning
    (8 steps, CFG 8, 256x256) with its launches, CLIP text features, best-of-2
    reranked by the CLIP towers (scores finite, in [0, 100]); then `python -m
    paella_tpu_torch.serve` on the same files, under torch's TF32 defaults,
    answers /healthz within 600 s, and its PNG equals the pipeline's image
    made under TF32 off for the same prompt and seed (the f32 decode pins
    IEEE either way), three requests byte-identical."""
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.serve import build_pipeline, png_pixels, request_seeds
    from paella_tpu_torch.serve import to_uint8 as serve_uint8

    paths = write_entry_checkpoints(tmp_path, 30)
    pipe = build_pipeline(paths["denoiser"], paths["vqgan"], paths["byt5"], clip_path=paths["clip"],
                          clip_bpe_path=paths["bpe"], device="cuda")
    prompt, seed, hw = "a red car on a beach", 17, (256, 256)
    s_cfg = SampleConfig(steps=STEPS, cfg=8.0)
    image, launches = counted(lambda: pipe.text_to_image([prompt], request_seeds([seed]), hw, s_cfg))
    check_launches("entry text_to_image", launches, {
        "fused_resblock[float]": GRAPH_PASSES * K1_PER_FORWARD * STEPS, "gumbel_categorical": GRAPH_PASSES * STEPS,
        "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0, "fused_codebook_lookup": 0,
    })
    assert image_ok(image, (1, 256, 256, 3))
    clip_feats = pipe.clip_text_fn([prompt])
    assert tuple(clip_feats.shape) == (1, 1024) and bool(torch.isfinite(clip_feats.float()).all())
    best, scores = pipe.text_to_image_best_of([prompt], request_seeds([21, 22]), 2, hw, s_cfg, return_scores=True)
    assert tuple(best.shape) == (1, 256, 256, 3) and tuple(scores.shape) == (1, 2)
    assert bool(torch.isfinite(scores).all()) and bool(((scores >= 0) & (scores <= 100)).all()), scores.tolist()
    want = serve_uint8(pipe.text_to_image([prompt], request_seeds([seed]), hw, s_cfg)[0]).cpu().numpy()
    del pipe, image, best, clip_feats
    gc.collect()
    torch.cuda.empty_cache()

    port = free_port()
    cmd = [sys.executable, "-m", "paella_tpu_torch.serve", "--denoiser", paths["denoiser"], "--vqgan", paths["vqgan"],
           "--byt5", paths["byt5"], "--clip", paths["clip"], "--clip-bpe", paths["bpe"], "--host", "127.0.0.1",
           "--port", str(port)]
    with open(tmp_path / "serve.log", "w+") as log:
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        try:
            t0 = time.perf_counter()
            while True:
                assert proc.poll() is None, f"the server exited with {proc.returncode}: {tail_of(log)}"
                assert time.perf_counter() - t0 <= 600, f"the server did not answer /healthz in 600 s: {tail_of(log)}"
                try:
                    assert http_get(f"http://127.0.0.1:{port}/healthz") == b"ok"
                    break
                except OSError:
                    time.sleep(0.5)
            req = {"prompt": prompt, "seed": seed, "steps": STEPS, "height": hw[0], "width": hw[1]}
            pngs = [http_generate(port, req) for _ in range(3)]
        finally:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
    got = png_pixels(pngs[0])
    assert got.shape == want.shape and bool((got == want).all()), "the served PNG differs from build_pipeline's image"
    assert pngs[1] == pngs[0] == pngs[2], "repeated requests gave other bytes"


def test_inception_featurizer_on_card_matches_cpu(cuda):
    """The Inception featurizer ('fid' variant, seeded weights on the card):
    pool3 features (2, 2048) of 2 images at 128x128 within 5e-3 (of the
    largest feature, at least 1) of the same weights' on the CPU."""
    from paella_tpu_torch.eval import convert_inception, inception_features

    gen = torch.Generator(device=cuda).manual_seed(33)
    sd = seeded_inception_state(gen, "cuda")
    small = torch.rand(2, 128, 128, 3, generator=gen, device="cuda")
    want = inception_features(convert_inception({k: v.cpu() for k, v in sd.items()}))(small.cpu())
    got = inception_features(convert_inception(sd))(small)
    err = float((got.cpu() - want).abs().max())
    assert tuple(got.shape) == (2, 2048) and err <= 5e-3 * max(1.0, float(want.abs().max())), err


def test_int8_path_at_the_flagship(cuda):
    """The flagship with every ResBlock quantized (quantize_paella_int8 over
    fuse_eligible_levels, which are (0, 1, 2), include_first), weight-only
    and W8A8: one CFG forward each launches 56 K1b of its mode and no K1,
    with features finite and, against the f32 forward of the same codes
    (plain versions), within 1.5x the plain versions' bf16 route's distance
    to it; the seeded ByT5-XL encoder and its two int8 modes give finite
    (1, bucket, 2560) states; text_to_image at 8 steps with each mode's
    denoiser and encoder launches its mode's kernels and gives a finite image
    in [0, 1]; the two W8A8 quality proxies' rows are finite."""
    from paella_tpu_torch import PaellaPipeline
    from paella_tpu_torch.cond import T5Config, T5Encoder, byt5_batch_encode, pad_bucket
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.kernels.resblock import resblock_plain
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.nn import blocks
    from paella_tpu_torch.quant import (
        fuse_eligible_levels,
        quantize_paella_int8,
        quantize_t5_int8,
        t5_w8a8_quality_proxy,
        w8a8_quality_proxy,
    )
    from paella_tpu_torch.sampling.sampler import merge_cfg_pair

    gen = torch.Generator(device=cuda).manual_seed(9)
    model, vq, p_cfg = build_flagship(gen)
    levels = fuse_eligible_levels(p_cfg)
    assert levels == (0, 1, 2), levels
    denoisers = {"bf16": model}
    for mode in ("int8", "w8a8"):
        q = quantize_paella_int8(model, levels=levels, include_first=True)
        q.config = dataclasses.replace(p_cfg, act_quant=mode == "w8a8")
        denoisers[mode] = q
    cond, uncond = flagship_conditioning(p_cfg, gen)
    pair = merge_cfg_pair(cond, uncond)
    cache_args = (pair.byt5, pair.clip, pair.clip_image)
    cache_kw = dict(byt5_mask=pair.byt5_mask, clip_mask=pair.clip_mask, clip_image_mask=pair.clip_image_mask)
    x = torch.randint(0, p_cfg.num_labels, (2, 64, 64), generator=gen, device="cuda")
    r = torch.full((2,), 0.6, device="cuda")
    with torch.device("cuda"):
        f32 = quantize_paella_int8(Paella(dataclasses.replace(p_cfg, dtype="float32")), levels=levels, include_first=True)
    f32.load_state_dict(denoisers["int8"].state_dict())
    f32.eval()
    kernel = blocks.fused_resblock
    for mode in ("int8", "w8a8"):
        qm = denoisers[mode]
        cache = qm.gen_cond_cache(*cache_args, **cache_kw)
        feats, launches = counted(lambda: qm(x, r, return_features=True, cond_cache=cache))
        check_launches(f"{mode} forward", launches, {
            "fused_resblock[float]": 0, "fused_resblock[int8]": K1_PER_FORWARD if mode == "int8" else 0,
            "fused_resblock[w8a8]": K1_PER_FORWARD if mode == "w8a8" else 0})
        f32.config = dataclasses.replace(qm.config, dtype="float32")
        # every int8 ResBlock through K1b's plain version (its wrapper would launch the kernel)
        blocks.fused_resblock = lambda x, w, film=None, skip=None: resblock_plain(x, w, film=film, skip=skip)
        try:
            want = qm(x, r, return_features=True, cond_cache=cache)
            ref = f32(x, r, return_features=True, cond_cache=f32.gen_cond_cache(*(t.float() for t in cache_args), **cache_kw))
        finally:
            blocks.fused_resblock = kernel
        assert bool(torch.isfinite(feats).all()), mode
        err, floor = rel_l2(feats, ref), rel_l2(want, ref)
        assert err <= 1.5 * floor, (mode, err, floor)
    del f32
    torch.cuda.empty_cache()

    t5_cfg = T5Config.byt5_xl()
    with torch.device("cuda"):
        t5 = T5Encoder(t5_cfg)
    t5.reset_parameters(gen)
    t5 = t5.to(torch.bfloat16).eval()
    encoders = {"bf16": t5}
    for mode in ("int8", "w8a8"):
        enc = quantize_t5_int8(t5)
        enc.config = dataclasses.replace(t5_cfg, act_quant=mode == "w8a8")
        encoders[mode] = enc
    prompt = "a red car on a beach"
    ids, mask = byt5_batch_encode([prompt], max_length=768)
    width = pad_bucket(ids.shape[1])
    ids = torch.nn.functional.pad(torch.from_numpy(ids), (0, width - ids.shape[1])).cuda()
    mask = torch.nn.functional.pad(torch.from_numpy(mask), (0, width - mask.shape[1])).cuda()
    for m, enc in encoders.items():
        s = enc(ids, mask)
        assert tuple(s.shape) == (1, width, t5_cfg.d_model) and bool(torch.isfinite(s).all()), m

    _, clip_text_fn = flagship_towers(p_cfg, gen)
    s_cfg = SampleConfig(steps=STEPS)
    per_gen = GRAPH_PASSES * K1_PER_FORWARD * STEPS
    for m in denoisers:
        pipe = PaellaPipeline(denoisers[m], vq, encoders[m], clip_text_fn=clip_text_fn, text_cache_size=0)
        img, launches = counted(lambda: pipe.text_to_image([prompt], torch.tensor([[42, 0x1B8]], dtype=torch.int64),
                                                           config=s_cfg))
        check_launches(f"{m} text_to_image", launches, {
            "fused_resblock[float]": per_gen if m == "bf16" else 0, "fused_resblock[int8]": per_gen if m == "int8" else 0,
            "fused_resblock[w8a8]": per_gen if m == "w8a8" else 0, "gumbel_categorical": GRAPH_PASSES * STEPS,
            "fused_head_categorical": 0})
        assert image_ok(img, (1, 256, 256, 3)), m
    del pipe, encoders
    torch.cuda.empty_cache()
    rows = w8a8_quality_proxy(model, torch.Generator(device="cuda").manual_seed(21))
    t5_rows = t5_w8a8_quality_proxy(t5, model, torch.Generator(device="cuda").manual_seed(22))
    for name, rs in (("denoiser", rows), ("ByT5", t5_rows)):
        assert all(math.isfinite(v) for row in rs for v in row.values()), (name, rs)


def graph_conditioning(p_cfg, b: int, gen):
    """flagship_conditioning of b images, and the editing inputs: init_x, a
    fixed left quarter and a (1, 72) reweight."""
    cond, uncond = flagship_conditioning(p_cfg, gen, b)
    init_x = torch.randint(0, p_cfg.num_labels, (b,) + LATENT[1:], generator=gen, device="cuda")
    keep = torch.zeros((b,) + LATENT[1:], dtype=torch.bool, device="cuda")
    keep[:, :, :16] = True
    rew = torch.ones(1, BYT5_LEN + 8, device="cuda")
    rew[0, 1:6] = 3.0
    return cond, uncond, dict(init_x=init_x, fixed_mask=keep, fixed_tokens=init_x.flip(0), cond_reweight=rew)


@pytest.mark.parametrize("config", ["plain", "attention", "int8", "w8a8"])
def test_sampler_graph_equals_eager_at_the_flagship(cuda, config):
    """The sampler's CUDA graph at the flagship's width, in the plain,
    attention and int8 configurations on the same seeded weights: on both
    routes at batch 1 and 3, with CFG, a conditional cutoff (3 of 4 steps),
    init_x, a fixed mask and cond_reweight, the capturing call's and a
    replay's tokens are the eager body's bit for bit; another cfg,
    temperature, t_start and renoise_steps capture nothing and equal the
    eager body; and one replay of an 8-step CFG generation at batch 1 runs
    the configuration's kernels (torch.profiler)."""
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.quant import fuse_eligible_levels, quantize_paella_int8
    from paella_tpu_torch.sampling import graph, sample, sample_eager

    gen = torch.Generator(device=cuda).manual_seed(16)
    model, vq, p_cfg = build_flagship(gen)
    del vq
    if config == "attention":
        with torch.device("cuda"):
            attn = Paella(dataclasses.replace(p_cfg, **ATTN_FLAGS))
        attn.load_state_dict(model.state_dict())
        model = attn.to(torch.bfloat16).eval()
    elif config != "plain":
        q = quantize_paella_int8(model, levels=fuse_eligible_levels(p_cfg), include_first=True)
        q.config = dataclasses.replace(p_cfg, act_quant=config == "w8a8")
        model = q
    inputs = {b: graph_conditioning(p_cfg, b, gen) for b in (1, 3)}
    edit_cfg = dict(steps=4, sampling_conditional_steps=3, t_start=0.8, temperature=(1.0, 0.5), cfg=(8.0, 6.0))
    graph.clear()
    for impl in ("xla", "pallas"):
        for b in (1, 3):
            cond, uncond, extra = inputs[b]
            s_cfg = SampleConfig(**edit_cfg, categorical_impl=impl)
            seeds = torch.tensor([[b, 0x6A]] * b) + torch.arange(b)[:, None]
            want = sample_eager(model, seeds, cond, (b,) + LATENT[1:], uncond, s_cfg, **extra)
            for call in ("first (warm-up, capture)", "second (replay)"):
                got = sample(model, seeds, cond, (b,) + LATENT[1:], uncond, s_cfg, **extra)
                assert torch.equal(got, want), f"{impl} B {b}: the {call} call's tokens differ from the eager body's"
    captured = graph.captures
    cond, uncond, extra = inputs[1]
    other = SampleConfig(steps=4, sampling_conditional_steps=3, t_start=0.6, temperature=(0.8, 0.3), cfg=(5.0, 3.0),
                         renoise_steps=2)
    seeds = torch.tensor([[5, 6]])
    again = sample(model, seeds, cond, LATENT, uncond, other, **extra)
    assert graph.captures == captured, "new schedule values captured a graph"
    assert torch.equal(again, sample_eager(model, seeds, cond, LATENT, uncond, other, **extra))
    cond, uncond, _ = inputs[1]
    s_cfg = SampleConfig(steps=STEPS)
    k5, k6 = (K5_PER_FORWARD * STEPS, K6_PER_FORWARD * STEPS) if config == "attention" else (0, 0)
    got = replay_counts(lambda: sample(model, torch.tensor([[77, 0x6B]]), cond, LATENT, uncond, s_cfg))
    want = {"K1": K1_PER_FORWARD * STEPS, "K3": STEPS}
    if config in ("plain", "attention"):
        want.update(K5=k5, K6=k6)
    assert {k: got[k] for k in want} == want, got


def train_inputs(p_cfg, b: int, hw: int, gen, device):
    """A seeded training batch (images in [0, 1], ByT5 states with masks of
    seeded lengths, CLIP text and image embeddings) and a seeded NullCond."""
    from paella_tpu_torch.train import Batch, NullCond

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    lengths = torch.randint(1, TRAIN_BYT5_LEN + 1, (b, 1), generator=gen, device=device)
    batch = Batch(torch.rand(b, hw, hw, 3, generator=gen, device=device), r(b, TRAIN_BYT5_LEN, p_cfg.byt5_embd),
                  torch.arange(TRAIN_BYT5_LEN, device=device)[None, :] < lengths, r(b, p_cfg.clip_embd),
                  r(b, p_cfg.clip_embd))
    null = NullCond(r(1, 2, p_cfg.byt5_embd), torch.ones(1, 2, dtype=torch.bool, device=device), r(1, p_cfg.clip_embd))
    return batch, null


def train_1b(gen):
    """The JAX package's "1b" training configuration (v1_byt5_xl in bf16
    with remat and dropout 0.1 at every level) and its frozen bf16
    VQConfig() codec, seeded and perturbed on the card (f32 parameters)."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, VQConfig
    from paella_tpu_torch.models import Paella

    p_cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl(), dtype="bfloat16", remat=True)
    with torch.device("cuda"):
        model = Paella(p_cfg)
        vq = VQModel(dataclasses.replace(VQConfig(), dtype="bfloat16"))
    model.reset_parameters(gen)
    perturb_(model, gen)
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    return model, vq, p_cfg


# a train step's launches: K4 once a microbatch, nothing else of the port's kernels
STEP_LAUNCHES = {"fused_codebook_lookup": 1, "fused_resblock": 0, "fused_head_categorical": 0, "gumbel_categorical": 0,
                 "fused_attention": 0, "fused_attn_block": 0}
# on the training graph's route: K4 in the first step's eager run and in its capture, none in a replay
GRAPH_STEP_LAUNCHES = {**STEP_LAUNCHES, "fused_codebook_lookup": GRAPH_PASSES}
REPLAY_LAUNCHES = {**STEP_LAUNCHES, "fused_codebook_lookup": 0}


def test_train_step_at_the_1b_configuration(cuda):
    """The training step at the "1b" configuration, full width and depth,
    TrainConfig(warmup_updates=1), batch 8 at 256x256: seven steps on the
    training graph's route (K4 in the first one's eager run and capture,
    then six replays, each adding K4's one launch to the recorder's
    `launches.fused_codebook_lookup`), with finite metrics and no skipped
    update; the first update (lr 0) moves no parameter and the second moves
    90% of the tensors; two steps at grad_accum_steps=2 take the eager
    route and launch K4 twice each; K4 on a step's latents gives its plain
    version's indices."""
    from paella_tpu_torch.config import TrainConfig
    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup
    from paella_tpu_torch.train import create_train_state, make_train_step
    from paella_tpu_torch.utils import tracing

    gen = torch.Generator(device=cuda).manual_seed(45)
    model, vq, p_cfg = train_1b(gen)
    assert p_cfg.dropout == (0.1, 0.1, 0.1), p_cfg.dropout
    cfg = TrainConfig(warmup_updates=1)
    state = create_train_state(model, cfg, torch.Generator(device="cuda").manual_seed(46))
    step = make_train_step(model, vq, cfg)
    batch, null = train_inputs(p_cfg, TRAIN_BATCH, TRAIN_HW, gen, "cuda")
    before = [p.detach().clone() for p in model.parameters()]
    start = tracing.snapshot()["counters"]
    for i in range(7):
        m, launches = counted(lambda: step(state, batch, null), keep_graphs=i > 0)
        check_launches(f"train step {i + 1}", launches, GRAPH_STEP_LAUNCHES if i == 0 else REPLAY_LAUNCHES)
        m = {k: float(v) for k, v in m.items()}
        assert math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) and m["nonfinite_skips"] == 0, (i + 1, m)
        if i == 0:
            assert all(torch.equal(p.detach(), q) for p, q in zip(model.parameters(), before)), \
                "the first update (lr 0) moved parameters"
        if i == 1:
            moved = sum(not torch.equal(p.detach(), q) for p, q in zip(model.parameters(), before))
            assert moved >= 0.9 * len(before), f"the second update moved {moved} of {len(before)} parameter tensors"
            del before
    grew = counter_growth(start, "train_graph.miss", "train_graph.hit", "launches.fused_codebook_lookup")
    assert grew == {"train_graph.miss": 1, "train_graph.hit": 6, "launches.fused_codebook_lookup": 6}, grew
    accum = make_train_step(model, vq, dataclasses.replace(cfg, grad_accum_steps=2))
    for _ in range(2):
        m, launches = counted(lambda: accum(state, batch, null))
        check_launches("train step at grad_accum_steps=2", launches, {"fused_codebook_lookup": 2, "fused_resblock": 0})
        assert math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"])), m
    z = vq.encoder(batch.images).contiguous()
    cb = vq.vquantizer.codebook.weight.detach().float().contiguous()
    assert torch.equal(fused_codebook_lookup(z, cb), codebook_lookup_plain(z, cb))


def test_tiny_train_step_on_card_matches_cpu(cuda):
    """Two train steps of PaellaConfig.tiny() with VQConfig.tiny() (f32,
    TrainConfig(warmup_updates=1), batch 2 at 64x64) on the card and on the
    CPU from the same weights and the same pinned draws: the frozen encodes
    equal, loss within 1e-4 and grad_norm within 1e-3 relative at both
    steps, and after step 2 (the first with lr > 0) every parameter within
    2.1 lr of the CPU's and 99% of them within 0.05 lr (Adam divides each
    gradient by its own size, so a small gradient's rounding moves its
    update the most)."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, TrainConfig, VQConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.train import Batch, Draws, NullCond, create_train_state, make_train_step

    gen = torch.Generator().manual_seed(50)
    p_cfg, cfg = PaellaConfig.tiny(), TrainConfig(warmup_updates=1)
    cpu, vq_cpu = Paella(p_cfg), VQModel(VQConfig.tiny())
    cpu.reset_parameters(gen)
    perturb_(cpu, gen, scale=0.05)
    vq_cpu.reset_parameters(gen)
    perturb_(vq_cpu, gen, scale=0.05)
    dev, vq_dev = Paella(p_cfg).cuda(), VQModel(VQConfig.tiny()).cuda()
    dev.load_state_dict(cpu.state_dict())
    vq_dev.load_state_dict(vq_cpu.state_dict())
    batch, null = train_inputs(p_cfg, 2, 64, gen, "cpu")
    latents = vq_cpu.encode(batch.images)[2]
    assert torch.equal(vq_dev.encode(batch.images.cuda())[2].cpu(), latents), "the frozen encodes differ, card vs CPU"
    draws = []
    for _ in range(2):
        coins = [torch.rand(2, generator=gen) < p for p in (0.05, 0.9, 0.9)]
        u = torch.rand(2, generator=gen)
        t = torch.clamp(1.0 - u + cfg.t_min, cfg.t_min, 1.0)
        mask = (torch.rand(latents.shape, generator=gen) <= t[:, None, None]).int()
        ids = torch.randint(0, p_cfg.num_labels, latents.shape, generator=gen, dtype=latents.dtype)
        draws.append(Draws(*coins, u=u, noise_mask=mask, random_x=ids, dropout_seed=0))
    on_dev = lambda d: Draws(*(t.cuda() for t in dataclasses.astuple(d)[:-1]), dropout_seed=d.dropout_seed)  # noqa: E731
    batch_dev = Batch(*(t.cuda() for t in (batch.images, batch.byt5, batch.byt5_mask, batch.clip, batch.clip_image)))
    null_dev = NullCond(null.byt5.cuda(), null.byt5_mask.cuda(), null.clip.cuda())
    runs = {}
    for name, m, vq, b, n in (("cpu", cpu, vq_cpu, batch, null), ("card", dev, vq_dev, batch_dev, null_dev)):
        state = create_train_state(m, cfg)
        step = make_train_step(m, vq, cfg)
        put = (lambda d: d) if name == "cpu" else on_dev
        metrics = [step(state, b, n, [put(dataclasses.replace(d))]) for d in draws]
        runs[name] = ([(float(x["loss"]), float(x["grad_norm"])) for x in metrics],
                      {k: v.detach().float().cpu() for k, v in m.named_parameters()})
    (m_cpu, p_cpu), (m_dev, p_dev) = runs["cpu"], runs["card"]
    loss_err = max(abs(a[0] - b[0]) / abs(a[0]) for a, b in zip(m_cpu, m_dev))
    norm_err = max(abs(a[1] - b[1]) / abs(a[1]) for a, b in zip(m_cpu, m_dev))
    assert loss_err <= 1e-4 and norm_err <= 1e-3, (loss_err, norm_err)
    d = torch.cat([((p_dev[k] - v).abs() / cfg.lr).reshape(-1) for k, v in p_cpu.items()])
    p99, worst = torch.quantile(d, 0.99).item(), d.max().item()
    assert p99 <= 0.05 and worst <= 2.1, (p99, worst)


def counter_growth(start: dict, *names) -> dict:
    """How far each of the recorder's counters `names` grew since `start`
    (a snapshot's counters)."""
    from paella_tpu_torch.utils import tracing

    now = tracing.snapshot()["counters"]
    return {k: now.get(k, 0) - start.get(k, 0) for k in names}


def tiny_train_models(gen):
    """PaellaConfig.tiny() with dropout 0.1 at every level and remat (f32),
    and VQConfig.tiny(), seeded and perturbed on the card."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, VQConfig
    from paella_tpu_torch.models import Paella

    p_cfg = PaellaConfig.tiny()
    p_cfg = dataclasses.replace(p_cfg, dropout=(0.1,) * len(p_cfg.c_hidden), remat=True)
    with torch.device("cuda"):
        model, vq = Paella(p_cfg), VQModel(VQConfig.tiny())
    model.reset_parameters(gen)
    perturb_(model, gen, scale=0.05)
    vq.reset_parameters(gen)
    return model, vq, p_cfg


def test_train_graph_matches_the_eager_route(cuda, monkeypatch):
    """Three steps of the tiny denoiser (dropout 0.1, remat, f32) on three
    batches, every draw left to the state's generator, on the training
    graph's route against three on the eager route (`graph_route` patched
    off) from the same weights and generator seed, under cuDNN's
    deterministic algorithms. Two eager runs first give the footing: the
    graph's losses, first gradients and parameters after step 3 lie no
    farther from the first eager run's than the second eager run's do. The
    graph's counters read one miss, then hits."""
    from paella_tpu_torch.config import TrainConfig
    from paella_tpu_torch.sampling import graph
    from paella_tpu_torch.train import create_train_state, make_train_step, trainer
    from paella_tpu_torch.utils import tracing

    gen = torch.Generator(device=cuda).manual_seed(47)
    base, vq, p_cfg = tiny_train_models(gen)
    inputs = [train_inputs(p_cfg, 2, 64, gen, "cuda") for _ in range(3)]
    cfg = TrainConfig(warmup_updates=1)
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False

    def run(route: str) -> tuple:
        m = copy_module(base)
        with monkeypatch.context() as mp:
            if route == "eager":
                mp.setattr(trainer, "graph_route", lambda *args: False)
            state = create_train_state(m, cfg, torch.Generator(device="cuda").manual_seed(48))
            step = make_train_step(m, vq, cfg)
            start = tracing.snapshot()["counters"]
            losses, grads = [], None
            for i, (batch, null) in enumerate(inputs):
                losses.append(float(step(state, batch, null)["loss"]))
                if i == 0:
                    grads = [p.grad.clone() for p in m.parameters()]
            grew = counter_growth(start, "train_graph.miss", "train_graph.hit")
        return losses, grads, [p.detach().clone() for p in m.parameters()], grew

    try:
        graph.clear()
        eager, again, graphed = run("eager"), run("eager"), run("graph")
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    assert eager[3] == again[3] == {"train_graph.miss": 0, "train_graph.hit": 0}, (eager[3], again[3])
    assert graphed[3] == {"train_graph.miss": 1, "train_graph.hit": 2}, graphed[3]

    def gaps(run) -> tuple:
        loss = max(abs(a - b) for a, b in zip(run[0], eager[0]))
        grad = max((a - b).abs().max().item() for a, b in zip(run[1], eager[1]))
        param = max((a - b).abs().max().item() for a, b in zip(run[2], eager[2]))
        return loss, grad, param

    footing, got = gaps(again), gaps(graphed)
    assert all(g <= f for g, f in zip(got, footing)), f"graph {got} against two eager runs' {footing}"


def copy_module(module):
    """A new module of the same class and config on the card holding `module`'s state."""
    with torch.device("cuda"):
        m = type(module)(module.config)
    m.load_state_dict(module.state_dict())
    return m


def test_train_graph_counts_evicts_recaptures_and_keeps_returned_losses(cuda):
    """The tiny step on the training graph's route (dropout 0.1, remat):
    one miss, then hits, a replay calling no kernel wrapper and adding K4's
    one launch to the recorder's `launches.fused_codebook_lookup`; the loss
    tensors earlier steps returned unchanged after later replays; a replay
    recorded as train_graph.replay under train.step, after the unpinned
    dropout seed's read and with no train.forward span; a batch of another shape evicts the kept graph (one pool kept,
    the pool gauge its size); flipping the TF32 flag captures anew, and
    flipping it back again."""
    from paella_tpu_torch.config import TrainConfig
    from paella_tpu_torch.kernels import launch_counts
    from paella_tpu_torch.sampling import graph
    from paella_tpu_torch.train import create_train_state, make_train_step
    from paella_tpu_torch.utils import tracing

    gen = torch.Generator(device=cuda).manual_seed(49)
    model, vq, p_cfg = tiny_train_models(gen)
    cfg = TrainConfig(warmup_updates=1)
    state, step = create_train_state(model, cfg), make_train_step(model, vq, cfg)
    batches = [train_inputs(p_cfg, 2, 64, gen, "cuda") for _ in range(3)]
    names = ("train_graph.miss", "train_graph.hit", "train_graph.evicted", "launches.fused_codebook_lookup")
    graph.clear()
    start = tracing.snapshot()["counters"]
    kept = []
    for i, (batch, null) in enumerate(batches):
        wrappers = launch_counts()
        out = step(state, batch, null)
        kept.append((out["loss"], float(out["loss"])))
        if i:
            assert launch_counts() == wrappers, "a replay called a kernel wrapper"
    assert counter_growth(start, *names) == dict(zip(names, (1, 2, 0, 2))), counter_growth(start, *names)
    assert all(float(t) == v for t, v in kept), f"a replay rewrote a returned loss: {kept}"
    assert len({v for _, v in kept}) == 3, kept

    tracing.enable()
    try:
        first = len(tracing.snapshot()["spans"])
        step(state, *batches[0])
        spans = tracing.snapshot()["spans"][first:]
    finally:
        tracing.disable()
    top = [i for i, s in enumerate(spans) if s.name == "train.step"]
    assert len(top) == 1 and [s.name for s in spans if s.parent == first + top[0]] == [
        "train.sync", "train_graph.replay", "train.optimizer"], [(s.name, s.parent) for s in spans]
    assert not any(s.name == "train.forward" for s in spans)

    start = tracing.snapshot()["counters"]
    other, null = train_inputs(p_cfg, 3, 64, gen, "cuda")
    step(state, other, null)
    assert counter_growth(start, *names[:3]) == dict(zip(names[:3], (1, 0, 1)))
    (entry,) = graph._TRAIN_GRAPHS.values()  # one pool kept
    assert tracing.snapshot()["gauges"]["train_graph.pool_bytes"] == entry.pool_bytes > 0
    start = tracing.snapshot()["counters"]
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        step(state, other, null)
        step(state, other, null)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    step(state, other, null)
    assert counter_growth(start, *names[:3]) == dict(zip(names[:3], (2, 1, 2))), counter_growth(start, *names[:3])


DRIVER_STEPS, DRIVER_EVAL_EVERY, DRIVER_SHARDS, DRIVER_PER_SHARD = 4, 2, 2, 16


def driver_data(d: Path):
    """WebDatasetLoader over JPEG tar shards written by write_tar_shard where
    PIL (to encode them) and a JPEG decoder are present, else
    SyntheticDataset; both at 256x256, batch 8, seeded."""
    import io

    from paella_tpu_torch.data import SampleFilter, SyntheticDataset, WebDatasetLoader, jpeg_decoder, write_tar_shard

    decoder = jpeg_decoder()
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is None or decoder == "none":
        return SyntheticDataset(batch_size=TRAIN_BATCH, image_size=TRAIN_HW, seed=0)
    rng = np.random.default_rng(0)
    meta = json.dumps({"original_width": 512, "original_height": 512, "pwatermark": 0.1, "aesthetic": 6.0,
                       "punsafe": 0.0}).encode()
    paths = []
    for s in range(DRIVER_SHARDS):
        samples = []
        for i in range(DRIVER_PER_SHARD):
            img = np.kron(rng.uniform(0, 255, (8, 8, 3)), np.ones((40, 40, 1))).astype(np.uint8)  # 320x320
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, format="JPEG", quality=92)
            samples.append((f"{s:04d}{i:06d}", {"jpg": buf.getvalue(), "txt": f"a photo of thing {s}.{i}".encode(),
                                                "json": meta}))
        paths.append(str(d / f"shard-{s:04d}.tar"))
        write_tar_shard(paths[-1], samples)
    return WebDatasetLoader(paths, batch_size=TRAIN_BATCH, image_size=TRAIN_HW, shuffle_buffer=8,
                            filter=SampleFilter(min_size=256), num_workers=4, shard_offset=0, shard_stride=1)


def driver_launches(steps: int, grids: int) -> dict:
    """The kernel launches of a run_training call at the flagship's depth:
    K4 in the first train step's eager run and capture (the training
    graph's route at world size 1: later steps replay, calling no wrapper)
    and twice an eval grid (the diagnostic encode and the reconstruction's
    lookup); per grid K1 in the diagnostic forward and, with K3, in two
    8-step CFG generations, each captured as a graph (GRAPH_PASSES passes
    through the wrappers); nothing else."""
    generations = grids * 2 * GRAPH_PASSES * STEPS
    return {"fused_codebook_lookup": (GRAPH_PASSES if steps else 0) + 2 * grids, "fused_resblock": grids * K1_PER_FORWARD + generations * K1_PER_FORWARD,
            "gumbel_categorical": generations, "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0}


def test_driver_checkpoints_eval_grid_and_resume(cuda, tmp_path):
    """run_training at the "1b" configuration with bf16 Adam moments, batch 8
    at 256x256, the hash encoders of make_synthetic_encode_fn at the ByT5-XL
    / CLIP widths (77 tokens), JPEG tar shards: 4 steps with eval_every 2
    (two checkpoints, two eval grids) and its launches; the step-4 grid's
    tokens equal a fresh model's loaded from the step-4 checkpoint (fault C6
    on the card); prefetch_to_device gives the host batches bit for bit; K4
    on step 4's latents gives its plain version's indices; fresh objects
    resumed from the step-2 checkpoint end within two Adam steps of the
    uninterrupted run."""
    from paella_tpu_torch.config import TrainConfig
    from paella_tpu_torch.data import prefetch_to_device
    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.train import CheckpointManager, DriverConfig, make_synthetic_encode_fn, run_training
    from paella_tpu_torch.train.driver import _eval_grid

    gen = torch.Generator(device=cuda).manual_seed(60)
    model, vq, p_cfg = train_1b(gen)
    init = {k: v.detach().clone() for k, v in model.named_parameters()}
    enc, null = make_synthetic_encode_fn(p_cfg.byt5_embd, p_cfg.clip_embd, seq_len=TRAIN_BYT5_LEN, device="cuda")
    data = driver_data(tmp_path)
    t_cfg = TrainConfig(warmup_updates=1, adam_moment_dtype="bfloat16")
    d_cfg = DriverConfig(workdir=str(tmp_path / "run"), total_steps=DRIVER_STEPS, log_every=1,
                         eval_every=DRIVER_EVAL_EVERY, eval_steps=STEPS)
    state, launches = counted(lambda: run_training(model, vq, iter(data), enc, null, t_cfg, d_cfg))
    assert state.step == DRIVER_STEPS and state.optimizer.count == DRIVER_STEPS, state.step
    recs = jsonl(tmp_path / "run" / "metrics.jsonl")
    steps = {r["step"]: r for r in recs if "loss" in r}
    assert sorted(steps) == list(range(1, DRIVER_STEPS + 1)), sorted(steps)
    assert all(math.isfinite(r["loss"]) and r["nonfinite_skips"] == 0 for r in steps.values()), steps
    ckpt = CheckpointManager(str(tmp_path / "run" / "checkpoints"))
    assert ckpt.all_steps() == [2, 4]
    assert len([r for r in recs if "checkpoint_s" in r]) == 2 and len([r for r in recs if "eval_s" in r]) == 2
    check_launches("driver", launches, driver_launches(DRIVER_STEPS, DRIVER_STEPS // DRIVER_EVAL_EVERY))

    grid = np.load(tmp_path / "run" / f"eval_{DRIVER_STEPS:07d}.npz")
    with torch.device("cuda"):
        fresh = Paella(p_cfg)
    fresh.load_state_dict(ckpt.restore(None, DRIVER_STEPS)[0]["model"])
    assert all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), model.state_dict().values())), \
        "the step-4 checkpoint holds other parameters than the trained model"
    (tmp_path / "check").mkdir()
    _eval_grid(fresh, vq, enc, d_cfg, DRIVER_STEPS, str(tmp_path / "check"),
               images=grid["orig"].astype(np.float32) / 255.0, captions=list(grid["captions"]))
    again = np.load(tmp_path / "check" / f"eval_{DRIVER_STEPS:07d}.npz")
    for name in ("tokens", "tokens_noimg"):
        assert np.array_equal(again[name], grid[name]), f"C6: the trained model's {name} differ from a freshly loaded model's"
    moved = sum(not torch.equal(v, init[n]) for n, v in model.named_parameters())
    assert moved > 0.9 * len(init), f"only {moved} tensors moved"
    del fresh, init

    # the stream's first 6 batches through pinned memory and the side stream, each read on the compute stream as yielded
    host = list(itertools.islice(iter(data), 6))
    got = [t.clone() for t, _ in prefetch_to_device(iter(host), size=3)]
    torch.cuda.synchronize()
    assert all(torch.equal(g.cpu(), torch.from_numpy(h)) for g, (h, _) in zip(got, host)), \
        "prefetch_to_device gave other values than the host batches"

    # K4 on step 4's latents (item 4 of the stream: steps 1, 2, the step-2 eval batch, step 3, step 4)
    images4, _ = next(itertools.islice(iter(data), 4, None))
    z = vq.encoder(torch.from_numpy(images4).cuda()).contiguous()
    cb = vq.vquantizer.codebook.weight.detach().float().contiguous()
    assert torch.equal(fused_codebook_lookup(z, cb), codebook_lookup_plain(z, cb))

    # resume: fresh objects from the step-2 checkpoint, the same data stream from item 3 on
    final = {n: v.detach().clone() for n, v in model.state_dict().items()}
    del state, model
    torch.cuda.empty_cache()
    with torch.device("cuda"):
        resumed = Paella(p_cfg)
    resumed.reset_parameters(torch.Generator(device="cuda").manual_seed(61))
    r_cfg = dataclasses.replace(d_cfg, workdir=str(tmp_path / "resumed"))
    (tmp_path / "resumed" / "checkpoints" / "2").mkdir(parents=True)
    os.link(Path(ckpt.directory) / "2" / "state.pt", tmp_path / "resumed" / "checkpoints" / "2" / "state.pt")
    shutil.rmtree(Path(ckpt.directory) / "4")
    r_state, r_launches = counted(lambda: run_training(resumed, vq, itertools.islice(iter(data), 3, None), enc, null,
                                                       t_cfg, r_cfg))
    r_recs = jsonl(tmp_path / "resumed" / "metrics.jsonl")
    r_steps = {r["step"]: r for r in r_recs if "loss" in r}
    assert r_state.step == DRIVER_STEPS and r_state.optimizer.count == DRIVER_STEPS and sorted(r_steps) == [3, 4]
    assert len([r for r in r_recs if "restore_s" in r]) == 1
    check_launches("resumed driver", r_launches, driver_launches(2, 1))
    diff = max((v.float() - final[n].float()).abs().max().item() for n, v in resumed.state_dict().items())
    loss_gap = max(abs(r_steps[s]["loss"] - steps[s]["loss"]) for s in (3, 4))
    assert diff <= 2.1 * 2 * t_cfg.lr and loss_gap <= 1e-2 * abs(steps[4]["loss"]), (diff, loss_gap)


def test_codec_trainer_at_full_width(cuda):
    """codec/trainer.py at VQConfig() in float32 with the default
    Discriminator and CodecTrainConfig(), batch 8 at 256x256 of seeded
    images: five steps, each launching K4 once and no K1, with finite
    metrics; K4 on the batch's latents gives its plain version's indices."""
    from paella_tpu_torch.codec import (CodecTrainConfig, Discriminator, VQModel, create_codec_train_state,
                                        make_codec_train_step)
    from paella_tpu_torch.config import VQConfig
    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup

    gen = torch.Generator(device=cuda).manual_seed(70)
    with torch.device("cuda"):
        vq, disc = VQModel(VQConfig()), Discriminator()
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    disc.reset_parameters(gen)
    cfg = CodecTrainConfig()
    state = create_codec_train_state(vq, disc, cfg)
    step = make_codec_train_step(vq, disc, cfg)
    images = torch.rand(TRAIN_BATCH, TRAIN_HW, TRAIN_HW, 3, generator=gen, device="cuda")
    for i in range(5):
        m, launches = counted(lambda: step(state, images))
        check_launches(f"codec step {i + 1}", launches, {"fused_codebook_lookup": 1, "fused_resblock": 0})
        assert all(math.isfinite(float(v)) for v in m.values()), (i + 1, m)
    z = vq.encoder(images).contiguous()
    cb = vq.vquantizer.codebook.weight.detach().float().contiguous()
    assert torch.equal(fused_codebook_lookup(z, cb), codebook_lookup_plain(z, cb))


def test_ddp_step_at_world_size_one_is_the_plain_step(cuda):
    """parallel/ at world size 1 on NCCL: initialize_distributed joins a
    one-rank group, and one train step of PaellaConfig.tiny() (f32,
    VQConfig.tiny(), batch 4 at 64x64, pinned draws, grad_accum_steps=2)
    through data_parallel equals the same step without DDP, loss, acc,
    grad_norm and every gradient bit for bit, under cuDNN's deterministic
    algorithms; two plain steps are compared first, to show the step itself
    repeats bit for bit."""
    import torch.distributed as dist

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, TrainConfig, VQConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.parallel import data_parallel, initialize_distributed
    from paella_tpu_torch.train import Draws, create_train_state, make_train_step

    gen = torch.Generator(device=cuda).manual_seed(80)
    p_cfg = PaellaConfig.tiny()
    with torch.device("cuda"):
        base, vq = Paella(p_cfg), VQModel(VQConfig.tiny())
    base.reset_parameters(gen)
    perturb_(base, gen, scale=0.05)
    vq.reset_parameters(gen)
    batch, null = train_inputs(p_cfg, 4, 64, gen, "cuda")
    cfg = TrainConfig(warmup_updates=1, grad_accum_steps=2)
    hw = 16
    draws = [Draws(*(torch.rand(2, generator=gen, device="cuda") < p for p in (0.3, 0.5, 0.5)),
                   u=torch.rand(2, generator=gen, device="cuda"),
                   noise_mask=(torch.rand(2, hw, hw, generator=gen, device="cuda") < 0.5).int(),
                   random_x=torch.randint(0, p_cfg.num_labels, (2, hw, hw), generator=gen, device="cuda", dtype=torch.int32),
                   dropout_seed=0) for _ in range(2)]
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    info = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        assert info["backend"] == "nccl" and info["process_count"] == 1, info
        runs = []
        for wrap in (False, False, True):
            with torch.device("cuda"):
                m = Paella(p_cfg)
            m.load_state_dict(base.state_dict())
            ddp = data_parallel(m) if wrap else None
            state = create_train_state(m, cfg)
            out = make_train_step(m, vq, cfg, ddp=ddp)(state, batch, null, [dataclasses.replace(d) for d in draws])
            torch.cuda.synchronize()
            runs.append(({k: float(v) for k, v in out.items()}, {n: p.grad.clone() for n, p in m.named_parameters()}))
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags

    def same(a, b):
        return a[0] == b[0] and all(torch.equal(g, b[1][n]) for n, g in a[1].items())

    assert same(runs[0], runs[1]), "two plain tiny train steps differ on the card: the comparison has no footing"
    assert same(runs[0], runs[2]), "the world-size-1 DDP step differs from the plain step"


def test_fsdp_at_world_size_one_matches_plain_and_restores(cuda, tmp_path):
    """parallel.shard_model (FSDP2 over a (1, 1) dp x fsdp mesh) at world size
    1 on NCCL, at the "1b" configuration with bf16 Adam moments, batch 8 at
    256x256, every draw pinned: steps 1 and 2 in turns with the plain model
    from the same weights (metrics within 1e-5 relative; after step 2 at most
    0.1% of the parameters more than 0.02 lr and none more than 2.1 lr from
    the plain ones), K4 once a sharded step (the plain step takes the
    training graph's route: K4 in its eager run and capture, the kept graph
    dropped before each); the whole-state gather a checkpoint
    makes lands on the CPU; rank 0's eval grid from a plain copy loaded from
    it (run_training at fsdp > 1) launches a grid's kernels and gives the
    plain model's grid tokens; a freshly built and sharded model restored
    from the gathered state takes step 3 within the same tolerances of the
    uninterrupted sharded step 3, which stays within them of the plain one."""
    import torch.distributed as dist

    from paella_tpu_torch.config import TrainConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.parallel import initialize_distributed, shard_model
    from paella_tpu_torch.train import DriverConfig, Draws, create_train_state, make_synthetic_encode_fn, make_train_step
    from paella_tpu_torch.train.driver import _eval_grid, checkpoint_state, inference_copy, load_state

    gen = torch.Generator(device=cuda).manual_seed(90)
    plain, vq, p_cfg = train_1b(gen)
    cfg = TrainConfig(warmup_updates=1, adam_moment_dtype="bfloat16")
    batch, null = train_inputs(p_cfg, TRAIN_BATCH, TRAIN_HW, gen, "cuda")
    hw, b = TRAIN_HW // 4, TRAIN_BATCH
    draws = [Draws(*(torch.rand(b, generator=gen, device="cuda") < p for p in (0.05, 0.9, 0.9)),
                   u=torch.rand(b, generator=gen, device="cuda"),
                   noise_mask=(torch.rand(b, hw, hw, generator=gen, device="cuda") < 0.5).int(),
                   random_x=torch.randint(0, p_cfg.num_labels, (b, hw, hw), generator=gen, device="cuda",
                                          dtype=torch.int32), dropout_seed=i + 1) for i in range(3)]
    info = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        assert info["backend"] == "nccl" and info["process_count"] == 1, info

        def sharded_copy(state_dict=None):
            with torch.device("cuda"):
                m = Paella(p_cfg)
            if state_dict is not None:
                m.load_state_dict(state_dict)
            return m, shard_model(m, fsdp=1)

        sharded, mesh = sharded_copy(plain.state_dict())
        routes = {"plain": (plain, create_train_state(plain, cfg), make_train_step(plain, vq, cfg)),
                  "fsdp": (sharded, create_train_state(sharded, cfg), make_train_step(sharded, vq, cfg, mesh=mesh))}
        metrics = {}

        def run(name: str, i: int) -> None:
            _, state, step = routes[name]
            out, launches = counted(lambda: step(state, batch, null, [dataclasses.replace(draws[i])]))
            check_launches(f"{name} step {i + 1}", launches, GRAPH_STEP_LAUNCHES if name == "plain" else STEP_LAUNCHES)
            m = metrics[name] = {k: float(v) for k, v in out.items()}
            assert math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) and m["nonfinite_skips"] == 0, (name, i + 1, m)

        def check_gap(a: str, b: str) -> None:
            """The metrics within 1e-5 relative; at most 0.1% of the
            parameters more than 0.02 lr apart and none more than 2.1 lr."""
            rel = max(abs(metrics[a][k] - metrics[b][k]) / max(abs(metrics[b][k]), 1e-12) for k in ("loss", "acc", "grad_norm"))
            local = lambda p: p.to_local() if hasattr(p, "to_local") else p  # noqa: E731
            over = worst = total = 0
            with torch.no_grad():
                for p, q in zip(routes[a][0].parameters(), routes[b][0].parameters()):
                    d = (local(p) - local(q)).abs() / cfg.lr
                    over += int((d > 0.02).sum())
                    worst = max(worst, d.max().item())
                    total += d.numel()
            assert rel <= 1e-5 and over / total <= 1e-3 and worst <= 2.1, (a, b, rel, over / total, worst)

        for i in range(2):
            run("plain", i)
            run("fsdp", i)
        check_gap("fsdp", "plain")

        snap = checkpoint_state(sharded, routes["fsdp"][1])
        tensors = list(snap["model"].values()) + [v for s in snap["optimizer"]["state"].values() for v in s.values()]
        assert all(t.device.type == "cpu" for t in tensors), "the gathered state is not on the CPU"
        del tensors
        enc, _ = make_synthetic_encode_fn(p_cfg.byt5_embd, p_cfg.clip_embd, seq_len=TRAIN_BYT5_LEN, device="cuda")
        images, captions = batch.images.float().cpu().numpy(), [f"a photo of thing {i}" for i in range(b)]
        d_cfg = DriverConfig(eval_steps=STEPS)
        copy = inference_copy(sharded, snap["model"])
        grid_launches = {}
        for name, m in (("copy", copy), ("plain", plain)):
            (tmp_path / name).mkdir()
            _, grid_launches[name] = counted(lambda: _eval_grid(m, vq, enc, d_cfg, 2, str(tmp_path / name), images=images,
                                                                captions=captions))
        del copy
        check_launches("the eval grid from the gathered copy", grid_launches["copy"], driver_launches(0, 1))
        got, want = (np.load(tmp_path / n / "eval_0000002.npz") for n in ("copy", "plain"))
        for k in ("tokens", "tokens_noimg"):
            assert np.array_equal(got[k], want[k]), f"the grid from the gathered copy differs from the plain model's {k}"

        restored, _ = sharded_copy()
        r_state = create_train_state(restored, cfg)
        load_state(restored, r_state, snap)
        del snap
        routes["restored"] = (restored, r_state, make_train_step(restored, vq, cfg, mesh=mesh))
        for name in ("plain", "fsdp", "restored"):
            run(name, 2)
        check_gap("restored", "fsdp")
        check_gap("fsdp", "plain")
    finally:
        dist.destroy_process_group()


PROD_BATCH, PROD_CODEC_STEPS, PROD_CODEC_DISC_START, PROD_CODEC_COLLAGE = 8, 6, 3, 3
PROD_EVAL_N, PROD_EVAL_BATCH, PROD_EVAL_EVERY = 32, 16, 2


def run_script(name: str, args: list, log_path: Path, timeout: float) -> tuple[dict, str]:
    """`python -m paella_tpu_torch.scripts.<name> *args` from this checkout, a
    process of its own, killed at `timeout`: (its last line as JSON, its
    output)."""
    with open(log_path, "w+") as log:
        try:
            rc = subprocess.run([sys.executable, "-m", f"paella_tpu_torch.scripts.{name}", *args], cwd=REPO,
                                stdout=log, stderr=subprocess.STDOUT, timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            pytest.fail(f"{name} ran past {timeout} s: {tail_of(log)}")
        assert rc == 0, f"{name} {' '.join(args)} exited {rc}: {tail_of(log)}"
        log.seek(0)
        text = log.read()
    return json.loads(text.strip().splitlines()[-1]), text


def check_script_launches(what: str, got: dict, expect: dict) -> None:
    """A script's launch counts (its summary's `launches`, read at the end of
    its process, which started at 0): no plain version ran, and `expect`."""
    ran = {k: n for k, n in got.items() if k.endswith("_plain") and n}
    assert not ran, f"{what}: plain versions ran on the card: {ran}"
    check_launches(what, got, expect)


def test_production_scripts_round_trip(cuda, tmp_path):
    """The port's production entry points (paella_tpu_torch/scripts/), each a
    process of its own on the card: run_codec_pretrain (VQConfig() f32 +
    Discriminator(), batch 8 at 256x256, 6 steps, the GAN term from step 3),
    whose codec_vars.npz reads back bit for bit; run_driver_e2e at "1b" (bf16
    moments, batch 8, the frozen ByT5-XL + ViT-H-14 towers, against that
    codec) stopped by SIGTERM after its first checkpoint and eval grid, then
    resumed by a fresh process to the next even step, and again with --byt5
    w8a8 for 2 steps; run_eval_e2e over the bf16 run's checkpoints with --n 32
    --trend, in image space with --real-recon and in token space with the
    W8A8 twins (K1b). Each with its launches and finite results."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import VQConfig
    from paella_tpu_torch.convert import load_params_npz, vqgan_state_dict_from_jax, vqgan_variables_to_jax
    from paella_tpu_torch.train import save_params_npz

    codec_dir, run_dir, w8_dir = (str(tmp_path / d) for d in ("codec", "run", "run_w8a8"))
    npz = os.path.join(codec_dir, "codec_vars.npz")

    codec, _ = run_script("run_codec_pretrain", [
        "--workdir", codec_dir, "--steps", str(PROD_CODEC_STEPS), "--batch", "8", "--disc-start",
        str(PROD_CODEC_DISC_START), "--log-every", "1", "--collage-every", str(PROD_CODEC_COLLAGE),
        "--shards", "1", "--per-shard", "16"], tmp_path / "codec.log", 300)
    snapshots = 2 + PROD_CODEC_STEPS // PROD_CODEC_COLLAGE  # init, every collage step, final
    check_script_launches("run_codec_pretrain", codec["launches"], {
        "fused_codebook_lookup": PROD_CODEC_STEPS + snapshots, "fused_resblock": 0, "gumbel_categorical": 0})
    assert codec["steps"] == PROD_CODEC_STEPS, codec
    assert all(math.isfinite(codec[k]) for k in ("init_eval_recon_l1", "final_eval_recon_l1")), codec
    tree = load_params_npz(npz)
    with torch.device("cuda"):
        vq = VQModel(VQConfig())
    vq.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                        for k, v in vqgan_state_dict_from_jax(tree, VQConfig()).items()}, strict=True)
    again = str(tmp_path / "codec_vars_again.npz")
    save_params_npz(again, vqgan_variables_to_jax(vq.state_dict(), VQConfig()))
    with np.load(npz) as f, np.load(again) as g:
        saved, flat = {k: f[k] for k in f.files}, {k: g[k] for k in g.files}
    assert set(flat) == set(saved), "codec_vars.npz does not read back: other arrays"
    assert all(saved[k].dtype == np.float32 and np.array_equal(flat[k], saved[k]) for k in saved), \
        "codec_vars.npz does not read back bit for bit"
    tokens = torch.randint(0, VQConfig().codebook_size, (2, 64, 64), generator=torch.Generator(device="cuda").manual_seed(82),
                           device="cuda")
    assert bool(torch.isfinite(vq.decode_indices(tokens)).all())
    del vq

    # the driver at "1b" with the towers: SIGTERM after the first checkpoint and grid, a fresh resume
    common = ["--workdir", run_dir, "--geometry", "1b", "--adam-moments", "bf16", "--batch", str(PROD_BATCH),
              "--log-every", "1", "--eval-every", str(PROD_EVAL_EVERY), "--shards", "1", "--per-shard", "32",
              "--workers", "4", "--codec", npz]
    metrics_path = os.path.join(run_dir, "metrics.jsonl")
    with open(tmp_path / "driver_a.log", "w+") as log:
        proc = subprocess.Popen([sys.executable, "-m", "paella_tpu_torch.scripts.run_driver_e2e", *common, "--steps", "40"],
                                cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        try:
            deadline = time.time() + 400
            while time.time() < deadline and proc.poll() is None:
                if os.path.exists(metrics_path) and any("eval_s" in r for r in jsonl(metrics_path)):
                    break
                time.sleep(0.2)
            assert proc.poll() is None, f"run_driver_e2e ended before its first eval grid: {tail_of(log)}"
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=300)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        log.seek(0)
        out_a = log.read()
    assert rc == 0 and "preemption checkpoint saved" in out_a, f"phase A exited {rc}: {out_a[-3000:]}"
    summary_a = json.loads(out_a.strip().splitlines()[-1])
    final_a = summary_a["final_step"]
    steps_b = final_a + 2 - final_a % 2  # the next even step: a grid and a forced save
    summary_b, out_b = run_script("run_driver_e2e", [*common, "--steps", str(steps_b)], tmp_path / "driver_b.log", 400)
    assert f"resumed at step {final_a}" in out_b and "init skipped" in out_b and summary_b["final_step"] == steps_b, \
        f"phase B did not resume from step {final_a}: {out_b[-3000:]}"
    recs = jsonl(metrics_path)
    grids = [r["step"] for r in recs if "eval_s" in r]
    ckpts = sorted(int(s) for s in os.listdir(os.path.join(run_dir, "checkpoints")) if s.isdigit())
    for what, summary, first, last in (("phase A", summary_a, 0, final_a), ("phase B", summary_b, final_a, steps_b)):
        n_grids = sum(first < s <= last for s in grids)
        check_script_launches(f"run_driver_e2e {what}", summary["launches"], {
            **driver_launches(last - first, n_grids), "fused_resblock[int8]": 0, "fused_resblock[w8a8]": 0})
    assert all(math.isfinite(r["loss"]) and r["nonfinite_skips"] == 0 for r in recs if "loss" in r), "driver losses"

    w8a8, _ = run_script("run_driver_e2e", [*[w8_dir if a == run_dir else a for a in common], "--byt5", "w8a8",
                                            "--steps", str(PROD_EVAL_EVERY)], tmp_path / "driver_w8a8.log", 400)
    check_script_launches("run_driver_e2e --byt5 w8a8", w8a8["launches"], {
        **driver_launches(PROD_EVAL_EVERY, 1), "fused_resblock[int8]": 0, "fused_resblock[w8a8]": 0})
    assert all(math.isfinite(r["loss"]) for r in jsonl(os.path.join(w8_dir, "metrics.jsonl")) if "loss" in r), \
        "w8a8 driver losses"
    shutil.rmtree(os.path.join(w8_dir, "checkpoints"))

    arms = 1 + len(ckpts)
    gens = arms * GRAPH_PASSES  # each arm's model captures its graph at its first batch, then replays
    ev_common = ["--workdir", run_dir, "--geometry", "1b", "--adam-moments", "bf16", "--byt5", "bf16", "--n",
                 str(PROD_EVAL_N), "--batch", str(PROD_EVAL_BATCH), "--trend", "--codec", npz]
    image, _ = run_script("run_eval_e2e", [*ev_common, "--real-recon"], tmp_path / "eval_image.log", 400)
    check_script_launches("run_eval_e2e image space", image["launches"], {
        "fused_resblock[float]": gens * STEPS * K1_PER_FORWARD, "fused_resblock[w8a8]": 0, "fused_resblock[int8]": 0,
        "gumbel_categorical": gens * STEPS, "fused_codebook_lookup": PROD_EVAL_N // PROD_EVAL_BATCH,
        "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0})
    assert len(image["arms"]) == arms and all(math.isfinite(a["fid_synthetic_featurizer"]) for a in image["arms"]) \
        and math.isfinite(image["fid_noise_floor_real_vs_real"]), image
    tokens, _ = run_script("run_eval_e2e", [*ev_common, "--space", "tokens", "--w8a8"], tmp_path / "eval_tokens.log", 500)
    check_script_launches("run_eval_e2e token space with W8A8 twins", tokens["launches"], {
        "fused_resblock[float]": gens * STEPS * K1_PER_FORWARD, "fused_resblock[w8a8]": gens * STEPS * K1_PER_FORWARD,
        "fused_resblock[int8]": 0, "gumbel_categorical": 2 * gens * STEPS,
        "fused_codebook_lookup": PROD_EVAL_N // PROD_EVAL_BATCH, "fused_head_categorical": 0,
        "fused_attention": 0, "fused_attn_block": 0})
    assert len(tokens["arms"]) == 2 * arms and tokens["w8a8"]["levels"] == [0, 1, 2], tokens
    assert all(math.isfinite(a["token_frechet"]) and 0 <= a["token_js_to_real"] <= math.log(2) + 1e-6
               for a in tokens["arms"]), tokens


EXAMPLE_TRAIN_STEPS, EXAMPLE_TRAIN_BATCH = 4, 8  # train_minimal's --steps and --batch
EXAMPLE_CALLS = ("text_to_image", "inpaint", "outpaint", "img2img", "text_to_image_b", "interpolate", "edited")
# the structures generate's main captures: text_to_image (its second prompt
# replays it), inpaint (a fixed mask), outpaint (another latent shape),
# img2img (init_x) and the edit (cond_reweight)
EXAMPLE_CAPTURES = 5
PROXY_T_VALUES = 5  # quant.w8a8_quality_proxy's noise levels, one float and one W8A8 forward each


@pytest.fixture(scope="module")
def example_files(tmp_path_factory):
    """write_entry_checkpoints' seeded full-width files for the examples,
    removed after the module's last test that reads them."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    d = tmp_path_factory.mktemp("examples")
    yield write_entry_checkpoints(d, 31)
    shutil.rmtree(d, ignore_errors=True)


def test_generate_example_at_full_width(cuda, example_files, tmp_path):
    """examples/generate.py's main on the full-width files (the flagship
    denoiser, VQConfig(), ByT5-XL; no CLIP tower, as in the JAX example), 8
    steps: its images' shapes, finite and in [0, 1], five sampler graphs
    captured (the `graph.miss` counter: `graph.captures` counts the text
    towers' captures too), the launches of five captured 8-step generations
    and six encodes, and inpaint's kept left half equal to the source
    image's encoded tokens."""
    from paella_tpu_torch import PaellaPipeline
    from paella_tpu_torch.examples import generate
    from paella_tpu_torch.utils import tracing

    taps = []  # the token grids on their way to the decoder
    tapped = PaellaPipeline._decode_clipped
    PaellaPipeline._decode_clipped = lambda self, tokens: (taps.append(tokens), tapped(self, tokens))[1]
    misses = lambda: tracing.snapshot()["counters"].get("graph.miss", 0)  # noqa: E731
    try:
        before = misses()
        out, launches = counted(lambda: generate.main([
            "--vqgan", example_files["vqgan"], "--denoiser", example_files["denoiser"], "--byt5", example_files["byt5"],
            "--steps", str(STEPS), "--out", str(tmp_path / "gen")]))
        captures = misses() - before
    finally:
        PaellaPipeline._decode_clipped = tapped
    images, pipe = out["images"], out["pipeline"]
    want = {k: (1, 256, 256, 3) for k in EXAMPLE_CALLS}
    want.update(outpaint=(1, 256, 512, 3), interpolate=(5, 256, 256, 3))
    assert {k: tuple(v.shape) for k, v in images.items()} == want
    for k, v in images.items():
        assert image_ok(v, want[k]), k
    assert captures == EXAMPLE_CAPTURES, captures
    forwards = GRAPH_PASSES * EXAMPLE_CAPTURES * STEPS
    check_launches("generate", launches, {
        "fused_resblock[float]": forwards * K1_PER_FORWARD, "fused_resblock[int8]": 0, "fused_resblock[w8a8]": 0,
        "gumbel_categorical": forwards,
        "fused_codebook_lookup": 6,  # the encodes of inpaint, outpaint and img2img; interpolate's two and its requantization
        "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0})
    # inpaint (the second decode) kept the left half of the latent: the source's tokens there
    keep = torch.zeros(1, 64, 64, dtype=torch.bool, device="cuda")
    keep[:, :, :32] = True
    source = pipe.encode_image_tokens(images["text_to_image"])
    assert torch.equal(taps[1][keep], source[keep]), "inpaint's kept tokens differ from the encoded source"


def test_train_minimal_example_at_full_width(cuda, example_files, tmp_path):
    """examples/train_minimal.py's main at the released v1_byt5_xl() (f32,
    dropout 0.1) with the frozen ByT5-XL and the codec from the files, batch
    8 at 256x256, 4 steps: it ends at step 4 with four finite losses,
    checkpoints at steps 2 and 4, and K4 in the first step's eager run and
    capture (the later steps replay the training graph) and nothing else."""
    from paella_tpu_torch.examples import train_minimal

    workdir = tmp_path / "train"
    state, launches = counted(lambda: train_minimal.main([
        "--vqgan", example_files["vqgan"], "--byt5", example_files["byt5"], "--steps", str(EXAMPLE_TRAIN_STEPS),
        "--batch", str(EXAMPLE_TRAIN_BATCH), "--workdir", str(workdir)]))
    assert int(state.step) == EXAMPLE_TRAIN_STEPS, state.step
    losses = [r["loss"] for r in jsonl(workdir / "metrics.jsonl") if "loss" in r]
    assert len(losses) == EXAMPLE_TRAIN_STEPS and all(math.isfinite(v) for v in losses), losses
    assert sorted(int(s) for s in os.listdir(workdir / "checkpoints")) == [2, 4]
    check_launches("train_minimal", launches, {
        "fused_codebook_lookup": GRAPH_PASSES, "fused_resblock": 0, "gumbel_categorical": 0,
        "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0})
    del state
    shutil.rmtree(workdir)


def test_eval_quality_w8a8_proxy_on_the_denoiser_file(cuda, example_files):
    """examples/eval_quality.py --w8a8-proxy --ckpt on the full-width
    denoiser file (64x64 latent): five finite rows, from five float (K1) and
    five W8A8 (K1b) forwards."""
    from paella_tpu_torch.examples import eval_quality

    (rows, _), launches = counted(lambda: eval_quality.main(["--w8a8-proxy", "--ckpt", example_files["denoiser"]]))
    assert len(rows) == PROXY_T_VALUES and all(math.isfinite(v) for r in rows for v in r.values()), rows
    check_launches("eval_quality --w8a8-proxy", launches, {
        "fused_resblock[float]": PROXY_T_VALUES * K1_PER_FORWARD, "fused_resblock[w8a8]": PROXY_T_VALUES * K1_PER_FORWARD,
        "fused_resblock[int8]": 0, "gumbel_categorical": 0, "fused_codebook_lookup": 0})


def test_eval_quality_byt5_proxy_and_demo_on_the_card(cuda):
    """examples/eval_quality.py's ByT5 W8A8 proxy with its stress arm at the
    byt5_small_like geometry (both arms' rows finite; K1 in its float arm, no
    K1b W8A8), and its tiny CLIP demo (finite CLIP scores and CLIP-FID, K1,
    K3 once a step of a captured 4-step generation)."""
    from paella_tpu_torch.examples import eval_quality

    (arms, _), launches = counted(lambda: eval_quality.main(["--byt5-w8a8-proxy", "--stress", "--geometry", "small"]))
    assert list(arms) == ["synthetic", "synthetic_outliers"], list(arms)
    assert all(math.isfinite(v) for rs in arms.values() for r in rs for v in r.values()), arms
    assert launches["fused_resblock[float]"] > 0 and launches["fused_resblock[w8a8]"] == 0, launches
    demo, launches = counted(lambda: eval_quality.main([]))
    assert all(math.isfinite(v) for v in demo["scores"].tolist()) and math.isfinite(demo["fid"]), demo
    assert launches["fused_resblock[float]"] > 0 and launches["gumbel_categorical"] == GRAPH_PASSES * 4, launches
