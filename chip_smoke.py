#!/usr/bin/env python3
"""Run the PyTorch port's main path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, one line each (every time printed beside the card's name and power
limit):
  1. build     compile the five CUDA libraries (paella_tpu_torch/csrc:
               resblock, sampling, quantize, attention, attn_block) from
               source, in parallel
  2. K1        fused ResBlock(+FiLM) kernel against its plain torch version
               at the flagship's shapes, f32 (TF32 off) and bf16, and two runs
               bitwise equal
  3. K2        fused sampling head against its plain torch version at the
               flagship's shape, and with a zero head (tokens from the hash alone)
  4. K3        Gumbel categorical against its plain version over flagship
               logits (1,64,64,8192), bf16 and f32
  5. K4        codebook lookup against its plain version at the codec's
               encode shape, two codebooks
  6. e2e       the flagship config (PaellaConfig.v1_byt5_xl_inference, seeded
               random weights): 8-step CFG sampling through the fused head at
               batch 1 and the codec decode to a uint8 256x256 image, with
               launch counts, output checks and p50 times
  7. pipeline  PaellaPipeline at the flagship width with VQConfig() and its
               encoder: text_to_image (default SampleConfig, 12 steps, "xla"
               route), img2img, inpaint, outpaint, interpolate and a phrase
               reweight, each with its launch counts, output checks and p50
  8. small     a small f32 model and codec on the card against the same
               weights on the CPU (plain versions), encoder included
  9. K5, K6    fused attention core and fused attention block against their
               plain versions at the flagship's level-1 and level-2 shapes,
               bf16 and f32, and two runs bitwise equal
 10. attn e2e  the flagship config with attention_impl="pallas" and
               attn_block_kernel=True: one forward's launch counts and
               features against the same weights' plain-attention forward,
               then 8-step CFG sampling and decode, with launch counts and
               p50s beside the plain-attention config's
 11. serve     PaellaServer at the attention config on 127.0.0.1: /healthz,
               single requests whose PNGs equal the pipeline's images, a
               repeated request byte-identical, a micro-batch of three
               concurrent requests against the single path, HTTP p50
Then a JSON line of the kernels, the card's name and power limit, and, last,
{"ok": true, "device": {...}}. Any failed check raises; without a CUDA device
the script exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
STEPS = 8
LATENT = (1, 64, 64)
BYT5_LEN = 64
RESBLOCK_SHAPES = [  # (B, H, W, C, skip): the flagship's CFG batch-2 levels
    (2, 32, 32, 640, False),
    (2, 32, 32, 640, True),
    (2, 16, 16, 1280, False),
    (2, 8, 8, 1280, False),
]
K1_SHAPE = (2, 16, 16, 1280, False)  # 31 of the 56 calls per forward
TIMED_RUNS = 5
PIPELINE_RUNS = 3  # timed runs of each pipeline call, after its counted run
LIBRARIES = ("resblock", "sampling", "quantize", "attention", "attn_block")
ATTN_LEVELS = [  # (B, N, S_cond, heads, head dim) of attention levels 1 and 2 at CFG batch 2
    (2, 256, 72, 16, 80),  # 16x16 pixels; S_cond = ByT5 64 + CLIP 4 + CLIP-image 4
    (2, 64, 72, 16, 80),  # 8x8
]
ATTN_FLAGS = dict(attention_impl="pallas", attn_block_kernel=True)
# launches per flagship forward in the attention config: K5 at repetition 0
# of levels 1 and 2 each way, K6 at the other 15 + 5 repetitions each way
K5_PER_FORWARD, K6_PER_FORWARD, K1_PER_FORWARD = 4, 40, 56


class CheckFailed(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise CheckFailed(what)


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


def cuda_time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of one fn() call, from CUDA events around `iters` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def alternate(kernel, plain) -> tuple[float, float]:
    """Times of kernel and plain, measured plain, kernel, kernel, plain."""
    p1, k1, k2, p2 = cuda_time_ms(plain), cuda_time_ms(kernel), cuda_time_ms(kernel), cuda_time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def launch_counters():
    """(kernel wrappers, plain versions), each with its `launches` count."""
    from paella_tpu_torch.kernels import attention as k_att
    from paella_tpu_torch.kernels import attn_block as k_blk
    from paella_tpu_torch.kernels import quantize as k_q
    from paella_tpu_torch.kernels import resblock as k_res
    from paella_tpu_torch.kernels import sampling as k_samp

    kernels = (k_res.fused_resblock, k_samp.fused_head_categorical, k_samp.gumbel_categorical,
               k_q.fused_codebook_lookup, k_att.fused_attention, k_blk.fused_attn_block)
    plains = (k_res.resblock_plain, k_samp.head_categorical_plain, k_samp.gumbel_categorical_plain,
              k_q.codebook_lookup_plain, k_att.attention_plain, k_blk.attn_block_plain)
    return kernels, plains


def counted(fn):
    """Run fn() with every launch count set to 0 just before; return its
    result and the counts read just after (synchronized)."""
    import torch

    kernels, plains = launch_counters()
    for f in kernels + plains:
        f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in kernels + plains}
    for f in plains:
        check(launches[f.__name__] == 0, f"{f.__name__} ran on the card")
    return out, launches


def check_launches(what: str, launches: dict, expect: dict) -> None:
    for k, n in expect.items():
        check(launches[k] == n, f"{what}: {k} launched {launches[k]} times, want {n}")


def phase_build(tag: str) -> dict:
    from paella_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, all at once
        paths = dict(zip(LIBRARIES, pool.map(_build.build, LIBRARIES)))
    regs = {}
    for name, path in paths.items():
        _build.load_library(name)
        log = path.with_suffix(".log").read_text()
        regs[name] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    secs = time.perf_counter() - t0
    print(f"[build] {' + '.join(n + '.cu' for n in LIBRARIES)} built and loaded in {secs:.1f} s ({tag})")
    for name, lines in regs.items():
        for ln in lines:
            print(f"[build]   {name}: {ln}")
    return {"build_s": secs}


def random_resblock(c: int, cpg: int, dtype, gen):
    import torch

    from paella_tpu_torch.kernels.resblock import prepare_resblock_weights

    dev = "cuda"
    r = lambda *s, std: torch.randn(*s, generator=gen, device=dev) * std  # noqa: E731
    return prepare_resblock_weights(
        r(c, cpg, 3, 3, std=0.2), r(c, std=0.1),
        r(4 * c, c, std=c**-0.5), r(4 * c, std=0.1),
        r(4 * c, std=0.2), r(4 * c, std=0.2),
        r(c, 4 * c, std=(4 * c) ** -0.5), r(c, std=0.1),
        dtype,
    )


def phase_k1(tag: str) -> dict:
    import torch

    from paella_tpu_torch.kernels.resblock import fused_resblock, resblock_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    result = {"max_abs_err": 0.0}
    for b, hh, ww, c, with_skip in RESBLOCK_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            w = random_resblock(c, 2 if with_skip else 1, dtype, gen)
            x = torch.randn(b, hh, ww, c, generator=gen, device="cuda").to(dtype)
            skip = torch.randn(b, hh, ww, c, generator=gen, device="cuda").to(dtype) if with_skip else None
            film = (torch.randn(b, 2 * c, generator=gen, device="cuda") * 0.2).to(dtype)
            got = fused_resblock(x, w, film=film, skip=skip).float()
            want = resblock_plain(x, w, film=film, skip=skip).float()
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "K1 output not finite")
            err = (got - want).abs().max().item()
            rel = err / want.abs().max().item()
            ms, plain_ms = alternate(
                lambda: fused_resblock(x, w, film=film, skip=skip),
                lambda: resblock_plain(x, w, film=film, skip=skip),
            )
            dname = "f32" if dtype == torch.float32 else "bf16"
            print(
                f"[K1] fused_resblock ({b},{hh},{ww},{c}) skip={with_skip} {dname}: "
                f"max_abs_err {err:.3e} rel {rel:.3e} (limit {'abs 1e-3' if dtype == torch.float32 else 'rel 2e-2'}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({tag})"
            )
            if (b, hh, ww, c, with_skip, dtype) == (2, 32, 32, 640, False, torch.bfloat16):
                same = torch.equal(fused_resblock(x, w, film=film), fused_resblock(x, w, film=film))
                print(f"[K1] ({b},{hh},{ww},{c}) bf16 + FiLM, two runs bitwise equal: {same} ({tag})")
                check(same, "K1 gave different outputs on two runs of the same input")
                result["deterministic"] = same
            if dtype == torch.float32:
                check(err <= 1e-3, f"K1 f32 max abs error {err} > 1e-3")
            else:
                check(rel <= 2e-2, f"K1 bf16 relative error {rel} > 2e-2")
                result["max_abs_err"] = max(result["max_abs_err"], err)
                if (b, hh, ww, c, with_skip) == K1_SHAPE:
                    result.update(ms=ms, plain_ms=plain_ms)
    return result


def phase_k2(tag: str) -> dict:
    import torch

    from paella_tpu_torch.kernels.sampling import (
        fused_head_categorical,
        hash_uniform,
        head_categorical_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(12)
    seeds = torch.tensor([[0x9E3779B9, 12345]], dtype=torch.int64)
    result = {}
    k, c = 8192, 256
    for dtype in (torch.bfloat16, torch.float32):
        fc = torch.randn(1, 64, 64, c, generator=gen, device="cuda").to(dtype)
        fu = torch.randn(1, 64, 64, c, generator=gen, device="cuda").to(dtype)
        w_out = (torch.randn(k, c, generator=gen, device="cuda") * (1.0 / k) ** 0.5).to(dtype)
        args = (seeds, fc, fu, 8.0, w_out, 0.7)
        got = fused_head_categorical(*args)
        want = head_categorical_plain(*args)
        torch.cuda.synchronize()
        agree = (got == want).float().mean().item()
        # size of the flips: the plain scores' gap between the two choices
        f = (fc.float() * 8.0 + fu.float() * -7.0).to(dtype).float().reshape(-1, c)
        score = (f @ w_out.float().t()) * (1 / 0.7) - torch.log(-torch.log(hash_uniform(seeds.cuda(), (64 * 64, k))[0]))
        flips = (got != want).reshape(-1)
        gap = 0.0
        if flips.any():
            rows = score[flips]
            gap = (rows.gather(1, want.reshape(-1, 1)[flips].long()) - rows.gather(1, got.reshape(-1, 1)[flips].long())).abs().max().item()
        dname = "f32" if dtype == torch.float32 else "bf16"
        ms, plain_ms = alternate(lambda: fused_head_categorical(*args), lambda: head_categorical_plain(*args))
        print(
            f"[K2] fused_head_categorical (1,64,64,{c})x({k},{c}) cfg 8 T 0.7 {dname}: "
            f"tokens agree {agree:.6f} (limit 0.999), max score gap at flips {gap:.3e}; "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms ({tag})"
        )
        check(agree >= 0.999, f"K2 {dname} token agreement {agree} < 0.999")
        check(bool(((got >= 0) & (got < k)).all()), "K2 tokens out of range")
        if dtype == torch.bfloat16:
            result.update(agree=agree, max_abs_err=gap, ms=ms, plain_ms=plain_ms)
        zero = torch.zeros_like(w_out)
        z_args = (seeds, fc, fu, 8.0, zero, 0.7)
        z_agree = (fused_head_categorical(*z_args) == head_categorical_plain(*z_args)).float().mean().item()
        print(f"[K2] W_out = 0 (hash alone) {dname}: tokens agree {z_agree:.6f} (limit 0.9999) ({tag})")
        check(z_agree >= 0.9999, f"K2 {dname} hash-only agreement {z_agree} < 0.9999")
    return result


def score_gap(logits, seeds, got, want, temperature: float) -> float:
    """The plain scores' largest gap between the two choices where the
    kernel and the plain version picked different tokens (0.0 if none); one
    image, seeds (1, 2)."""
    import torch

    from paella_tpu_torch.kernels.sampling import _f32_inv, hash_uniform

    flips = (got != want).reshape(-1)
    if not flips.any():
        return 0.0
    k = logits.shape[-1]
    rows = logits.reshape(-1, k)[flips].float() * _f32_inv(temperature)
    u = hash_uniform(seeds.to(logits.device), (logits.numel() // k, k))[0][flips]
    score = rows - torch.log(-torch.log(u))
    pick = lambda t: score.gather(1, t.reshape(-1, 1)[flips].long())  # noqa: E731
    return (pick(want) - pick(got)).abs().max().item()


def phase_k3(tag: str) -> dict:
    import torch

    from paella_tpu_torch.kernels.sampling import gumbel_categorical, gumbel_categorical_plain

    gen = torch.Generator(device="cuda").manual_seed(13)
    seeds = torch.tensor([[0x9E3779B9, 54321]], dtype=torch.int64)
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        logits = (torch.randn(1, 64, 64, 8192, generator=gen, device="cuda") * 2.0).to(dtype)
        got = gumbel_categorical(seeds, logits, 0.7)
        want = gumbel_categorical_plain(seeds, logits, 0.7)
        torch.cuda.synchronize()
        agree = (got == want).float().mean().item()
        gap = score_gap(logits, seeds, got, want, 0.7)
        ms, plain_ms = alternate(lambda: gumbel_categorical(seeds, logits, 0.7), lambda: gumbel_categorical_plain(seeds, logits, 0.7))
        nbytes = logits.numel() * logits.element_size() + got.numel() * 4
        dname = "f32" if dtype == torch.float32 else "bf16"
        print(
            f"[K3] gumbel_categorical (1,64,64,8192) T 0.7 {dname}: tokens agree {agree:.6f} (limit 1.000000), "
            f"max score gap at flips {gap:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; "
            f"{nbytes / 1e6:.1f} MB moved, {nbytes / ms / 1e6:.1f} GB/s = {nbytes / ms / 3.35e9:.3f} of 3.35 TB/s HBM ({tag})"
        )
        check(agree == 1.0, f"K3 {dname} token agreement {agree} < 1")
        check(bool(((got >= 0) & (got < 8192)).all()), "K3 tokens out of range")
        if dtype == torch.bfloat16:
            result.update(max_abs_err=gap, ms=ms, plain_ms=plain_ms)
    return result


def phase_k4(tag: str) -> dict:
    import torch

    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup

    gen = torch.Generator(device="cuda").manual_seed(14)
    z = torch.randn(1, 64, 64, 4, generator=gen, device="cuda")
    codebooks = {
        "U(+-1/8192)": (torch.rand(8192, 4, generator=gen, device="cuda") * 2 - 1) / 8192,
        "N(0,1)": torch.randn(8192, 4, generator=gen, device="cuda"),
    }
    result = {"max_abs_err": 0.0}
    for name, cb in codebooks.items():
        got, want = fused_codebook_lookup(z, cb), codebook_lookup_plain(z, cb)
        torch.cuda.synchronize()
        bad = (got != want).reshape(-1)
        gap = 0.0
        if bad.any():  # each mismatch must be a near-tie: distances (f64) within 1e-6 * max(1, |d|)
            zz, cbd = z.reshape(-1, 4)[bad].double(), cb.double()

            def dist(idx):
                e = cbd[idx.reshape(-1)[bad].long()]
                return (e * e).sum(-1) - 2 * (zz * e).sum(-1)

            d_got, d_want = dist(got), dist(want)
            gap = ((d_got - d_want).abs() / d_want.abs().clamp(min=1.0)).max().item()
        ms, plain_ms = alternate(lambda: fused_codebook_lookup(z, cb), lambda: codebook_lookup_plain(z, cb))
        nbytes = (z.numel() + cb.numel()) * 4 + got.numel() * (4 + 2 * 8)  # + the 64-bit merge words
        flops = z.numel() // 4 * 8192 * 10
        print(
            f"[K4] fused_codebook_lookup z (1,64,64,4) vs {name} codebook (8192,4) f32: "
            f"{int(bad.sum())} mismatches of 4096, max relative distance gap {gap:.3e} (limit 1e-6); "
            f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {nbytes / 1e6:.3f} MB moved "
            f"({nbytes / ms / 3.35e9:.5f} of 3.35 TB/s), {flops / 1e9:.2f} GFLOP "
            f"({flops / ms / 67e9:.3f} of 67 TFLOP/s f32) ({tag})"
        )
        check(gap <= 1e-6, f"K4 {name}: a mismatch is not a near-tie (gap {gap})")
        check(bool(((got >= 0) & (got < 8192)).all()), "K4 indices out of range")
        result["max_abs_err"] = max(result["max_abs_err"], gap)
        if name == "N(0,1)":
            result.update(ms=ms, plain_ms=plain_ms, mismatches=int(bad.sum()))
    return result


def perturb_(module, gen, scale: float = 0.02) -> None:
    """Add scale * N(0, 1) to every parameter: the zero-initialized clf and
    FiLM mappers (and codec gammas) would otherwise make outputs trivial."""
    import torch

    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype) * scale)
    if hasattr(module, "drop_derived"):
        module.drop_derived()


def build_flagship(gen, **flags):
    import torch

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, VQConfig
    from paella_tpu_torch.models import Paella

    p_cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl_inference(), **flags)
    with torch.device("cuda"):
        model = Paella(p_cfg)
        vq = VQModel(dataclasses.replace(VQConfig(), dtype="bfloat16"))
    model.reset_parameters(gen)
    perturb_(model, gen)
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    # inference weights in bf16, as the JAX package's bench.py does; the
    # encoder's BatchNorm and the codebook stay f32, as the JAX codec keeps
    # its statistics and its lookup in f32
    vq = vq.to(torch.bfloat16)
    vq.down_blocks[-1][1].float()
    vq.vquantizer.float()
    return model.to(torch.bfloat16).eval(), vq.eval(), p_cfg


def flagship_conditioning(p_cfg, gen):
    import torch

    from paella_tpu_torch.sampling import Conditioning

    def r(*s):
        return torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)

    cond = Conditioning(byt5=r(1, BYT5_LEN, p_cfg.byt5_embd), clip=r(1, p_cfg.clip_embd), clip_image=r(1, p_cfg.clip_embd))
    uncond = Conditioning(byt5=r(1, 2, p_cfg.byt5_embd), clip=r(1, p_cfg.clip_embd), clip_image=None)
    return cond, uncond


def to_uint8(img):
    import torch

    return (img.float().clamp(0, 1) * 255).to(torch.uint8)


def phase_e2e(tag: str) -> dict:
    import torch

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.sampling import sample

    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    model, vq, p_cfg = build_flagship(gen)
    cond, uncond = flagship_conditioning(p_cfg, gen)
    s_cfg = SampleConfig(steps=STEPS, categorical_impl="pallas")
    torch.cuda.synchronize()
    print(f"[e2e] flagship weights built on the card in {time.perf_counter() - t0:.1f} s")

    def seeds_for(i: int):
        return torch.tensor([[i, 0x5EED]], dtype=torch.int64)

    tokens, launches = counted(lambda: sample(model, seeds_for(42), cond, LATENT, uncond, s_cfg))
    img = vq.decode_indices(tokens)
    image = to_uint8(img)
    print(f"[e2e] launches in one generation: {json.dumps(launches)}")
    check_launches("8-step generation", launches, {
        "fused_resblock": K1_PER_FORWARD * STEPS, "fused_head_categorical": STEPS, "gumbel_categorical": 0,
        "fused_attention": 0, "fused_attn_block": 0,
    })
    check(tuple(tokens.shape) == LATENT and tokens.dtype == torch.int32, f"tokens {tuple(tokens.shape)} {tokens.dtype}")
    check(bool(((tokens >= 0) & (tokens < p_cfg.num_labels)).all()), "tokens out of [0, num_labels)")
    check(bool(torch.isfinite(img.float()).all()), "decoded image not finite")
    check(tuple(image.shape) == (1, 256, 256, 3) and image.dtype == torch.uint8, f"image {tuple(image.shape)} {image.dtype}")
    n_distinct = int(torch.unique(tokens).numel())
    print(f"[e2e] tokens {tuple(tokens.shape)} in [0, {p_cfg.num_labels}), {n_distinct} distinct; image {tuple(image.shape)} uint8, finite")
    check(n_distinct > 1, "all tokens equal")

    def generate(i):
        return to_uint8(vq.decode_indices(sample(model, seeds_for(i), cond, LATENT, uncond, s_cfg))).cpu()

    def sample_only(i):
        return sample(model, seeds_for(i), cond, LATENT, uncond, s_cfg).cpu()

    generate(1000)  # warm-up
    e2e, samp = [], []
    for i in range(TIMED_RUNS):
        t1 = time.perf_counter()
        generate(i)
        e2e.append(time.perf_counter() - t1)
    for i in range(TIMED_RUNS):
        t1 = time.perf_counter()
        sample_only(100 + i)
        samp.append(time.perf_counter() - t1)
    e2e_p50 = sorted(e2e)[TIMED_RUNS // 2] * 1e3
    samp_p50 = sorted(samp)[TIMED_RUNS // 2] * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(
        f"[e2e] 256x256 text-to-image, {STEPS} steps CFG, batch 1, bf16: p50 end-to-end {e2e_p50:.2f} ms "
        f"(min {min(e2e) * 1e3:.2f}, max {max(e2e) * 1e3:.2f}), p50 sampling only {samp_p50:.2f} ms "
        f"(min {min(samp) * 1e3:.2f}, max {max(samp) * 1e3:.2f}) over {TIMED_RUNS} runs; "
        f"peak device memory {peak:.1f} GiB ({tag})"
    )
    del model, vq
    torch.cuda.empty_cache()
    return {"launches": launches, "e2e_p50_ms": e2e_p50, "sample_p50_ms": samp_p50}


def flagship_towers(p_cfg, gen):
    """Seeded stand-ins for the text towers (not ported yet), on the card: a
    table from byte ids to (B, S, byt5_embd) states, and CLIP-text features
    summed from a table over each prompt's bytes."""
    import torch

    table = torch.randn(260, p_cfg.byt5_embd, generator=gen, device="cuda").to(torch.bfloat16)
    text_proj = torch.randn(256, p_cfg.clip_embd, generator=gen, device="cuda") / 16

    def byt5_encode_fn(ids, mask):
        return table[ids.long()]

    def clip_text_fn(prompts):
        rows = [text_proj[torch.tensor(list(p.encode("utf-8")), dtype=torch.long, device="cuda")].sum(0) for p in prompts]
        return torch.stack(rows).to(torch.bfloat16)

    return byt5_encode_fn, clip_text_fn


def phase_pipeline(tag: str) -> dict:
    """PaellaPipeline's entry points at the flagship width, each run once with
    every launch count set to 0 just before and read just after, then timed."""
    import torch

    from paella_tpu_torch import PaellaPipeline
    from paella_tpu_torch.sampling.editing import reweight_for_phrase

    gen = torch.Generator(device="cuda").manual_seed(5)
    t0 = time.perf_counter()
    model, vq, p_cfg = build_flagship(gen)
    byt5_encode_fn, clip_text_fn = flagship_towers(p_cfg, gen)
    pipe = PaellaPipeline(model, vq, byt5_encode_fn, clip_text_fn=clip_text_fn)
    torch.cuda.synchronize()
    print(f"[pipeline] flagship denoiser + VQConfig() codec (encoder included) built on the card in {time.perf_counter() - t0:.1f} s")
    steps = 12  # SampleConfig() as users call it: 12 steps, cfg 8, the "xla" route
    forward = K1_PER_FORWARD * steps
    kernels, _ = launch_counters()
    taps = []  # token grids on their way to the decoder
    decode_clipped = pipe._decode_clipped
    pipe._decode_clipped = lambda tokens: (taps.append(tokens), decode_clipped(tokens))[1]
    prompt = "a red car on a beach"
    result = {"calls": {}, "launches": {fn.__name__: 0 for fn in kernels}}

    def seeds(i: int):
        return torch.tensor([[i, 0xC0FFEE]], dtype=torch.int64)

    def run(name, fn, expect: dict, shape: tuple):
        taps.clear()
        out, launches = counted(lambda: fn(0))
        tokens = taps[0] if taps else None
        times = []
        for i in range(PIPELINE_RUNS):
            t1 = time.perf_counter()
            fn(1 + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t1)
        p50 = sorted(times)[PIPELINE_RUNS // 2] * 1e3
        ok = tuple(out.shape) == shape and bool(torch.isfinite(out).all()) and 0.0 <= out.min().item() and out.max().item() <= 1.0
        print(
            f"[pipeline] {name}: launches {json.dumps(launches)}; image {tuple(out.shape)} in [0, 1], finite: {ok}; "
            f"p50 {p50:.2f} ms (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) over {PIPELINE_RUNS} runs ({tag})"
        )
        check(ok, f"{name}: image {tuple(out.shape)} (want {shape}), finite and in [0, 1]")
        check_launches(name, launches, expect)
        for f in kernels:
            result["launches"][f.__name__] += launches[f.__name__]
        result["calls"][name] = {"p50_ms": p50, "launches": {f.__name__: launches[f.__name__] for f in kernels}}
        return out, tokens

    gen_counts = {"fused_resblock": forward, "fused_head_categorical": 0, "gumbel_categorical": steps,
                  "fused_attention": 0, "fused_attn_block": 0}
    image, _ = run("text_to_image", lambda i: pipe.text_to_image([prompt], seeds(i)),
                   {**gen_counts, "fused_codebook_lookup": 0}, (1, 256, 256, 3))
    edited, _ = run("img2img strength 0.8", lambda i: pipe.img2img([prompt], image, seeds(i), strength=0.8),
                    {**gen_counts, "fused_codebook_lookup": 1}, (1, 256, 256, 3))
    tokens0 = pipe.encode_image_tokens(image)
    keep = torch.zeros(1, 64, 64, dtype=torch.bool, device="cuda")
    keep[:, :, :32] = True  # keep the left half
    _, tokens = run("inpaint (left half kept)", lambda i: pipe.inpaint([prompt], image, keep, seeds(i)),
                    {**gen_counts, "fused_codebook_lookup": 1}, (1, 256, 256, 3))
    check(torch.equal(tokens[keep], tokens0[keep]), "inpaint: kept tokens differ from the encoded ones")
    print(f"[pipeline] inpaint: the {int(keep.sum())} kept tokens equal the encoded tokens exactly")
    _, tokens = run("outpaint 256x256 -> 256x384 at (0, 64)",
                    lambda i: pipe.outpaint([prompt], image, (256, 384), (0, 64), seeds(i)),
                    {**gen_counts, "fused_codebook_lookup": 1}, (1, 256, 384, 3))
    check(tuple(tokens.shape) == (1, 64, 96) and torch.equal(tokens[:, :, 16:80], tokens0),
          "outpaint: the placed region differs from the encoded tokens")
    print("[pipeline] outpaint: canvas tokens (1, 64, 96), the placed 64x64 region equals the encoded tokens exactly")
    frames, _ = run("interpolate n=4", lambda i: pipe.interpolate(image[0], edited[0], 4),
                    {"fused_resblock": 0, "gumbel_categorical": 0, "fused_codebook_lookup": 3}, (4, 256, 256, 3))
    rew = torch.from_numpy(reweight_for_phrase(prompt, "red", 3.0, byt5_len=64, has_clip=True))
    reweighted, _ = run("text_to_image, 'red' x3", lambda i: pipe.text_to_image([prompt], seeds(i), cond_reweight=rew),
                        {**gen_counts, "fused_codebook_lookup": 0}, (1, 256, 256, 3))
    check(not torch.equal(reweighted, image), "the phrase reweight changed nothing")
    del pipe, model, vq
    torch.cuda.empty_cache()
    return result


def phase_small_reference(tag: str) -> None:
    """A small f32 model and codec on the card (kernels) against the same
    weights on the CPU (plain versions): features, tokens and image."""
    import torch

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, SampleConfig, VQConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling import Conditioning, sample

    cfg = dataclasses.replace(
        PaellaConfig.tiny(), c_in=32, c_out=32, c_hidden=(64, 128, 128), nhead=(-1, 4, 4), num_labels=256
    )
    gen = torch.Generator().manual_seed(3)
    cpu = Paella(cfg)
    cpu.reset_parameters(gen)
    perturb_(cpu, gen, scale=0.05)
    dev = Paella(cfg).cuda()
    dev.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(4)
    cond = Conditioning(torch.randn(2, 6, cfg.byt5_embd, generator=g), torch.randn(2, cfg.clip_embd, generator=g),
                        torch.randn(2, cfg.clip_embd, generator=g))
    uncond = Conditioning(torch.randn(2, 3, cfg.byt5_embd, generator=g), torch.randn(2, cfg.clip_embd, generator=g))
    x = torch.randint(0, cfg.num_labels, (2, 16, 16), generator=g)
    r = torch.rand(2, generator=g)
    f_cpu = cpu(x, r, cond.byt5, cond.clip, cond.clip_image, return_features=True)
    f_dev = dev(x.cuda(), r.cuda(), cond.byt5.cuda(), cond.clip.cuda(), cond.clip_image.cuda(), return_features=True).cpu()
    ferr = (f_cpu - f_dev).abs().max().item()
    seeds = torch.tensor([[1, 2], [3, 4]])
    s_cfg = SampleConfig(steps=4, temperature=(1.0, 0.5), cfg=(3.0, 3.0))
    t_cpu = sample(cpu, seeds, cond, (2, 16, 16), uncond, s_cfg)
    t_dev = sample(dev, seeds, cond.to("cuda"), (2, 16, 16), uncond.to("cuda"), s_cfg).cpu()
    agree = (t_cpu == t_dev).float().mean().item()
    vcfg = dataclasses.replace(VQConfig.tiny(), codebook_size=cfg.num_labels)
    vq_cpu = VQModel(vcfg)
    vq_cpu.reset_parameters(gen)
    perturb_(vq_cpu, gen, scale=0.05)
    vq_dev = VQModel(vcfg).cuda()
    vq_dev.load_state_dict(vq_cpu.state_dict())
    i_cpu = vq_cpu.decode_indices(t_cpu)
    i_dev = vq_dev.decode_indices(t_cpu.cuda()).cpu()
    ierr = (i_cpu - i_dev).abs().max().item()
    print(
        f"[small] small f32 model, card vs CPU: features max_abs_err {ferr:.3e} (limit 1e-3), 4-step CFG "
        f"tokens agree {agree:.4f} (limit 0.95), decode max_abs_err {ierr:.3e} (limit 1e-3) ({tag})"
    )
    check(ferr <= 1e-3, f"small model features differ by {ferr}")
    check(agree >= 0.95, f"small model tokens agree {agree} < 0.95")
    check(ierr <= 1e-3, f"small codec decode differs by {ierr}")
    # the encoder (BatchNorm statistics away from (0, 1)) and encode, K4 on the card
    norm = vq_cpu.down_blocks[-1][1]
    norm.running_mean.uniform_(-0.5, 0.5, generator=gen)
    norm.running_var.uniform_(0.5, 2.0, generator=gen)
    vq_dev.load_state_dict(vq_cpu.state_dict())
    x = torch.rand(4, 128, 128, 3, generator=g)
    zerr = (vq_cpu.encoder(x) - vq_dev.encoder(x.cuda()).cpu()).abs().max().item()
    idx_agree = (vq_cpu.encode(x)[2] == vq_dev.encode(x.cuda())[2].cpu()).float().mean().item()
    print(
        f"[small] small f32 codec, card vs CPU: encoder z max_abs_err {zerr:.3e} (limit 1e-3), "
        f"encode indices agree {idx_agree:.4f} of 4x32x32 (limit 0.999) ({tag})"
    )
    check(zerr <= 1e-3, f"small codec encoder differs by {zerr}")
    check(idx_agree >= 0.999, f"small codec encode indices agree {idx_agree} < 0.999")


def attention_error(got, want) -> tuple[float, float, bool]:
    """(max abs error, its limit, within it): f32 1e-5 + 1e-5 |want| (f32
    arithmetic in another order); bf16 2^-7 of the largest output, two bf16
    ulps (the output is rounded to bf16, and a p or q/k/v value on a rounding
    boundary may round to the neighbouring value)."""
    import torch

    err = (got.float() - want.float()).abs().max().item()
    if want.dtype == torch.float32:
        limit = 1e-5 + 1e-5 * want.float().abs().max().item()
    else:
        limit = 2**-7 * want.float().abs().max().item()
    return err, limit, err <= limit


def attention_masks(b: int, n: int, s_c: int, gen):
    """A CFG pair's cond mask (B, S_cond): the conditional half attends to
    every token, the unconditional half to its first two ByT5 tokens and its
    CLIP-text tokens (merge_cfg_pair masks the rest), and its K5 mask over
    [pixels ; cond]."""
    import torch

    cmask = torch.ones(b, s_c, dtype=torch.bool, device="cuda")
    cmask[b // 2 :, 2:64] = False
    cmask[b // 2 :, 68:] = False
    return cmask, torch.cat([torch.ones(b, n, dtype=torch.bool, device="cuda"), cmask], dim=1)


def phase_k5(tag: str) -> dict:
    import torch

    from paella_tpu_torch.kernels.attention import attention_plain, fused_attention

    gen = torch.Generator(device="cuda").manual_seed(15)
    result = {"max_abs_err": 0.0}
    for level, (b, n, s_c, h, d) in enumerate(ATTN_LEVELS, start=1):
        s = n + s_c
        _, mask = attention_masks(b, n, s_c, gen)
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v = (torch.randn(b, ln, h, d, generator=gen, device="cuda").to(dtype) for ln in (n, s, s))
            got = fused_attention(q, k, v, mask)
            want = attention_plain(q, k, v, mask)
            again = fused_attention(q, k, v, mask)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "K5 output not finite")
            err, limit, ok = attention_error(got, want)
            same = torch.equal(got, again)
            ms, plain_ms = alternate(lambda: fused_attention(q, k, v, mask), lambda: attention_plain(q, k, v, mask))
            flops = 4 * b * h * n * s * d
            dname = "f32" if dtype == torch.float32 else "bf16"
            print(
                f"[K5] fused_attention level {level} q ({b},{n},{h},{d}) k/v ({b},{s},{h},{d}) masked {dname}: "
                f"max_abs_err {err:.3e} (limit {limit:.3e}), two runs bitwise equal: {same}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; {flops / 1e9:.3f} GFLOP "
                f"= {flops / ms / 1e9:.2f} TFLOP/s ({tag})"
            )
            check(ok, f"K5 level {level} {dname} max abs error {err} > {limit}")
            check(same, f"K5 level {level} {dname} gave different outputs on two runs")
            if dtype == torch.bfloat16:
                result["max_abs_err"] = max(result["max_abs_err"], err)
                result.setdefault("levels", {})[level] = {"ms": ms, "plain_ms": plain_ms}
    result.update(result["levels"][1])
    return result


def phase_k6(tag: str) -> dict:
    import torch

    from paella_tpu_torch.kernels.attn_block import attn_block_plain, fused_attn_block, prepare_attn_block_weights

    gen = torch.Generator(device="cuda").manual_seed(16)
    result = {"max_abs_err": 0.0}
    for level, (b, n, s_c, h, d) in enumerate(ATTN_LEVELS, start=1):
        c, side = h * d, int(n**0.5)
        cmask, _ = attention_masks(b, n, s_c, gen)
        for dtype in (torch.float32, torch.bfloat16):
            r = lambda *shape, std: torch.randn(*shape, generator=gen, device="cuda") * std  # noqa: E731
            w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05), dtype)
            x = r(b, side, side, c, std=1.0).to(dtype)
            kv = r(b, s_c, c, std=1.0).to(dtype)
            got = fused_attn_block(x, kv, w, h, cmask)
            want = attn_block_plain(x, kv, w, h, cmask)
            again = fused_attn_block(x, kv, w, h, cmask)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "K6 output not finite")
            err = (got.float() - want.float()).abs().max().item()
            limit = 1e-4 if dtype == torch.float32 else 2e-2 * want.float().abs().max().item()
            same = torch.equal(got, again)
            ms, plain_ms = alternate(lambda: fused_attn_block(x, kv, w, h, cmask), lambda: attn_block_plain(x, kv, w, h, cmask))
            m_q, m_kv = b * n, b * (n + s_c)
            flops = 2 * c * c * (2 * m_q + 2 * m_kv) + 4 * b * h * n * (n + s_c) * d
            dname = "f32" if dtype == torch.float32 else "bf16"
            print(
                f"[K6] fused_attn_block level {level} x ({b},{side},{side},{c}) kv ({b},{s_c},{c}) {h} heads masked {dname}: "
                f"max_abs_err {err:.3e} (limit {limit:.3e}), two runs bitwise equal: {same}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; M_q {m_q}, M_kv {m_kv}, {flops / 1e9:.3f} GFLOP "
                f"= {flops / ms / 1e9:.2f} TFLOP/s ({tag})"
            )
            check(err <= limit, f"K6 level {level} {dname} max abs error {err} > {limit}")
            check(same, f"K6 level {level} {dname} gave different outputs on two runs")
            if dtype == torch.bfloat16:
                result["max_abs_err"] = max(result["max_abs_err"], err)
                result.setdefault("levels", {})[level] = {"ms": ms, "plain_ms": plain_ms}
    result.update(result["levels"][1])
    return result


def phase_attention_e2e(tag: str) -> dict:
    import torch

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling import sample
    from paella_tpu_torch.sampling.sampler import merge_cfg_pair

    gen = torch.Generator(device="cuda").manual_seed(7)
    model, vq, p_cfg = build_flagship(gen, **ATTN_FLAGS)
    cond, uncond = flagship_conditioning(p_cfg, gen)
    with torch.device("cuda"):
        plain = Paella(dataclasses.replace(p_cfg, attention_impl="xla", attn_block_kernel=False))
    plain.load_state_dict(model.state_dict())
    plain = plain.to(torch.bfloat16).eval()

    # one CFG forward: launch counts, and features against the same weights'
    # plain-attention forward in f32. The two bf16 routes round at different
    # points, so each lies about its bf16 rounding error from the f32 forward
    # (and the two about sqrt(2) times that apart): the attention route must
    # come within 1.5x the plain bf16 route's distance to it.
    pair = merge_cfg_pair(cond, uncond)
    cache_args = (pair.byt5, pair.clip, pair.clip_image)
    cache_kw = dict(byt5_mask=pair.byt5_mask, clip_mask=pair.clip_mask, clip_image_mask=pair.clip_image_mask)
    x = torch.randint(0, p_cfg.num_labels, (2, 64, 64), generator=gen, device="cuda")
    r = torch.full((2,), 0.6, device="cuda")
    cache = model.gen_cond_cache(*cache_args, **cache_kw)
    feats, launches = counted(lambda: model(x, r, return_features=True, cond_cache=cache))
    print(f"[attn e2e] launches in one CFG forward: {json.dumps(launches)}")
    check_launches("attention-config forward", launches,
                   {"fused_resblock": K1_PER_FORWARD, "fused_attention": K5_PER_FORWARD, "fused_attn_block": K6_PER_FORWARD})
    want = plain(x, r, return_features=True, cond_cache=plain.gen_cond_cache(*cache_args, **cache_kw)).float()
    with torch.device("cuda"):
        f32 = Paella(dataclasses.replace(plain.config, dtype="float32"))
    f32.load_state_dict(plain.state_dict())
    ref = f32.eval()(x, r, return_features=True,
                     cond_cache=f32.gen_cond_cache(*(t.float() for t in cache_args), **cache_kw))
    del f32
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    err, floor, apart = rel(feats.float(), ref), rel(want, ref), rel(feats.float(), want)
    print(
        f"[attn e2e] features (2,64,64,{p_cfg.c_out}), relative L2 to the plain-attention f32 forward: attention "
        f"config bf16 {err:.3e} (limit 1.5 x {floor:.3e}, the plain bf16 route's), max_abs_err "
        f"{(feats.float() - ref).abs().max().item():.3e}; the two bf16 routes {apart:.3e} apart ({tag})"
    )
    check(bool(torch.isfinite(feats).all()), "attention-config features not finite")
    check(err <= 1.5 * floor, f"attention-config features {err} from the f32 forward > 1.5 x {floor}")

    s_cfg = SampleConfig(steps=STEPS)  # the default "xla" draw: head product, then K3

    def seeds_for(i: int):
        return torch.tensor([[i, 0xA77E]], dtype=torch.int64)

    def generate(m, i):
        return to_uint8(vq.decode_indices(sample(m, seeds_for(i), cond, LATENT, uncond, s_cfg)))

    tokens, launches = counted(lambda: sample(model, seeds_for(42), cond, LATENT, uncond, s_cfg))
    image = to_uint8(vq.decode_indices(tokens))
    print(f"[attn e2e] launches in one {STEPS}-step CFG generation: {json.dumps(launches)}")
    check_launches("attention-config generation", launches, {
        "fused_resblock": K1_PER_FORWARD * STEPS, "gumbel_categorical": STEPS, "fused_head_categorical": 0,
        "fused_attention": K5_PER_FORWARD * STEPS, "fused_attn_block": K6_PER_FORWARD * STEPS,
    })
    check(tuple(tokens.shape) == LATENT and bool(((tokens >= 0) & (tokens < p_cfg.num_labels)).all()), "tokens out of range")
    check(int(torch.unique(tokens).numel()) > 1, "all tokens equal")
    check(tuple(image.shape) == (1, 256, 256, 3) and image.dtype == torch.uint8, f"image {tuple(image.shape)}")
    generate(model, 1000), generate(plain, 1000)  # warm-up
    times = {"attention": [], "plain": []}
    for i in range(TIMED_RUNS):  # in turns: plain, attention, attention, plain, ...
        for name, m in (("plain", plain), ("attention", model)) if i % 2 == 0 else (("attention", model), ("plain", plain)):
            t1 = time.perf_counter()
            generate(m, i).cpu()
            times[name].append(time.perf_counter() - t1)
    p50 = {k: sorted(v)[TIMED_RUNS // 2] * 1e3 for k, v in times.items()}
    print(
        f"[attn e2e] 256x256 text-to-image, {STEPS} steps CFG, batch 1, bf16, in turns: p50 attention config "
        f"{p50['attention']:.2f} ms (min {min(times['attention']) * 1e3:.2f}), plain attention {p50['plain']:.2f} ms "
        f"(min {min(times['plain']) * 1e3:.2f}) over {TIMED_RUNS} runs each ({tag})"
    )
    result = {"launches": launches, "p50_ms": p50, "feature_rel_l2": err, "feature_plain_rel_l2": floor}
    del model, plain, vq
    torch.cuda.empty_cache()
    return result


def http_get(url: str) -> bytes:
    import urllib.request

    with urllib.request.urlopen(url, timeout=60) as resp:
        check(resp.status == 200, f"GET {url}: {resp.status}")
        return resp.read()


def http_generate(port: int, req: dict) -> bytes:
    import urllib.request

    body = json.dumps(req).encode()
    r = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=body, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(r, timeout=600) as resp:
        check(resp.status == 200 and resp.headers["Content-Type"] == "image/png", f"POST /generate: {resp.status}")
        return resp.read()


def phase_serve(tag: str) -> dict:
    import torch

    from paella_tpu_torch import PaellaPipeline
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.serve import PaellaServer, png_pixels, request_seeds
    from paella_tpu_torch.serve import to_uint8 as serve_uint8

    gen = torch.Generator(device="cuda").manual_seed(8)
    model, vq, p_cfg = build_flagship(gen, **ATTN_FLAGS)
    byt5_encode_fn, clip_text_fn = flagship_towers(p_cfg, gen)
    pipe = PaellaPipeline(model, vq, byt5_encode_fn, clip_text_fn=clip_text_fn)
    prompts = ["a red car on a beach", "a lighthouse in a storm, oil on canvas", "a corgi"]
    seeds = [11, 12, 13]

    def req(i):
        return {"prompt": prompts[i], "seed": seeds[i], "steps": STEPS, "height": 256, "width": 256}

    def pipeline_image(i):
        img = pipe.text_to_image([prompts[i]], request_seeds([seeds[i]]), (256, 256), SampleConfig(steps=STEPS, cfg=8.0))
        return serve_uint8(img[0]).cpu().numpy()

    srv = PaellaServer(pipe, host="127.0.0.1", port=0)
    srv.start()
    try:
        check(http_get(f"http://127.0.0.1:{srv.port}/healthz") == b"ok", "/healthz")
        http_generate(srv.port, req(0))  # warm-up
        png0, launches = counted(lambda: http_generate(srv.port, req(0)))
        print(f"[serve] launches in one {STEPS}-step request: {json.dumps(launches)}")
        check_launches("served request", launches, {
            "fused_resblock": K1_PER_FORWARD * STEPS, "gumbel_categorical": STEPS,
            "fused_attention": K5_PER_FORWARD * STEPS, "fused_attn_block": K6_PER_FORWARD * STEPS,
        })
        singles, times = [], []
        for i in range(3):
            t1 = time.perf_counter()
            png = http_generate(srv.port, req(i))
            times.append(time.perf_counter() - t1)
            got = png_pixels(png)
            check(got.shape == (256, 256, 3), f"PNG {got.shape}")
            check(bool((got == pipeline_image(i)).all()), f"request {i}: the PNG differs from pipeline.text_to_image")
            singles.append(got)
        repeat = http_generate(srv.port, req(0))
        check(repeat == png0, "a repeated request gave other bytes")
        http_p50 = sorted(times)[1] * 1e3
        print(
            f"[serve] /healthz ok; 3 single requests ({STEPS} steps, 256x256): each PNG equals "
            f"pipeline.text_to_image for its seed pair exactly; a repeated request is byte-identical; "
            f"HTTP p50 {http_p50:.2f} ms (min {min(times) * 1e3:.2f}, max {max(times) * 1e3:.2f}) ({tag})"
        )
    finally:
        srv.stop()

    batched = PaellaServer(pipe, host="127.0.0.1", port=0, max_batch=4, batch_window_ms=200)
    batched.start()
    try:
        with ThreadPoolExecutor(3) as pool:
            pngs = list(pool.map(lambda i: http_generate(batched.port, req(i)), range(3)))
    finally:
        batched.stop()
    same = [float((png_pixels(p) == s).mean()) for p, s in zip(pngs, singles)]
    exact = all(v == 1.0 for v in same)
    print(
        f"[serve] max_batch=4, 3 concurrent requests (one batch of 4): share of pixels equal to the single path "
        f"{', '.join(f'{v:.6f}' for v in same)} (limit 0.99; {'exact' if exact else 'not exact'}) ({tag})"
    )
    check(min(same) >= 0.99, f"micro-batched images agree {min(same)} < 0.99 with the single path")
    del pipe, model, vq
    torch.cuda.empty_cache()
    return {"launches": launches, "http_p50_ms": http_p50, "batch_pixel_share": same, "batch_exact": exact}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    try:
        import paella_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port's package is not beside this script ({e})", file=sys.stderr)
        return 1
    if not os.path.abspath(paella_tpu_torch.__file__).startswith(os.path.join(REPO, "")):
        print(f"chip_smoke: paella_tpu_torch comes from {paella_tpu_torch.__file__}, not this checkout", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card()
    build = phase_build(tag)
    k1 = phase_k1(tag)
    k2 = phase_k2(tag)
    k3 = phase_k3(tag)
    k4 = phase_k4(tag)
    e2e = phase_e2e(tag)
    pipe = phase_pipeline(tag)
    phase_small_reference(tag)
    k5 = phase_k5(tag)
    k6 = phase_k6(tag)
    attn = phase_attention_e2e(tag)
    served = phase_serve(tag)
    launches = {}
    for counts in (e2e["launches"], pipe["launches"], attn["launches"], served["launches"]):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n
    kernels = [
        {
            "name": "fused_resblock", "route": "cuda", "source": "paella_tpu_torch/csrc/resblock.cu",
            "replaces": "paella_tpu/kernels/resblock.py:316",
            "launches": launches["fused_resblock"], "max_abs_err": k1["max_abs_err"],
            "ms": k1["ms"], "plain_ms": k1["plain_ms"], "shape": "x (2,16,16,1280) bf16 + FiLM",
        },
        {
            "name": "fused_head_categorical", "route": "cuda", "source": "paella_tpu_torch/csrc/sampling.cu",
            "replaces": "paella_tpu/kernels/sampling.py:151",
            "launches": launches["fused_head_categorical"], "max_abs_err": k2["max_abs_err"],
            "ms": k2["ms"], "plain_ms": k2["plain_ms"], "shape": "feat (1,64,64,256) x2, W_out (8192,256) bf16",
        },
        {
            "name": "gumbel_categorical", "route": "cuda", "source": "paella_tpu_torch/csrc/sampling.cu",
            "replaces": "paella_tpu/kernels/sampling.py:224",
            "launches": launches["gumbel_categorical"], "max_abs_err": k3["max_abs_err"],
            "ms": k3["ms"], "plain_ms": k3["plain_ms"], "shape": "logits (1,64,64,8192) bf16",
        },
        {
            "name": "fused_codebook_lookup", "route": "cuda", "source": "paella_tpu_torch/csrc/quantize.cu",
            "replaces": "paella_tpu/kernels/quantize.py:53",
            "launches": launches["fused_codebook_lookup"], "max_abs_err": k4["max_abs_err"],
            "ms": k4["ms"], "plain_ms": k4["plain_ms"], "shape": "z (1,64,64,4) f32, codebook (8192,4) f32",
        },
        {
            "name": "fused_attention", "route": "cuda", "source": "paella_tpu_torch/csrc/attention.cu",
            "replaces": "paella_tpu/kernels/attention.py:56",
            "launches": launches["fused_attention"], "max_abs_err": k5["max_abs_err"],
            "ms": k5["ms"], "plain_ms": k5["plain_ms"], "shape": "q (2,256,16,80), k/v (2,328,16,80) bf16, masked",
        },
        {
            "name": "fused_attn_block", "route": "cuda", "source": "paella_tpu_torch/csrc/attn_block.cu",
            "replaces": "paella_tpu/kernels/attn_block.py:178",
            "launches": launches["fused_attn_block"], "max_abs_err": k6["max_abs_err"],
            "ms": k6["ms"], "plain_ms": k6["plain_ms"], "shape": "x (2,16,16,1280), kv (2,72,1280) bf16, 16 heads, masked",
        },
    ]
    print(json.dumps({
        "kernels": kernels, "e2e_p50_ms": e2e["e2e_p50_ms"], "sample_p50_ms": e2e["sample_p50_ms"],
        "pipeline_p50_ms": {name: c["p50_ms"] for name, c in pipe["calls"].items()}, "build_s": build["build_s"],
        "attention_config_p50_ms": attn["p50_ms"], "k5_levels": k5["levels"], "k6_levels": k6["levels"],
        "serve_http_p50_ms": served["http_p50_ms"], "serve_batch_pixel_share": served["batch_pixel_share"],
    }))
    print(tag)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
