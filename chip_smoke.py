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
               bitwise equal; per bf16 shape its device time per sub-kernel
               (torch.profiler), the two products' TFLOP/s beside
               torch.matmul's, and the host's time to enqueue a call
  3. K2        fused sampling head against its plain torch version at the
               flagship's step (M 4096) and at batch 8 (M 32768), bf16 and
               f32, two runs bitwise equal, an image's tokens at B = 1 and
               inside B = 3 equal, and with a zero head (tokens from the hash
               alone); event ms in turns with the plain version and with the
               composed route (torch.matmul + K3), device µs of both,
               torch.matmul of the head product alone, and beside the bound
               an instruction-issue bound from the SASS's draw loop
  4. K3        Gumbel categorical against its plain version over flagship
               logits (1,64,64,8192), bf16 and f32, with its device µs and
               the instruction-issue bound beside the bytes bound
  5. K4        codebook lookup against its plain version, bit for bit, at
               the codec's encode shape (M 4096, two codebooks), at M 8 x 4096
               and at C 12, and a NaN token and an all-+inf one (index 0):
               device µs and the kernels a call launches (one) from torch.profiler,
               event ms in turns with the plain version, and an
               instruction-issue bound from the search loop's SASS
  6. e2e       the flagship config (PaellaConfig.v1_byt5_xl_inference, seeded
               random weights): 8-step CFG sampling through the fused head at
               batch 1 and the codec decode to a uint8 256x256 image, with
               launch counts, output checks and p50 times
  7. pipeline  PaellaPipeline at the flagship width with VQConfig() and its
               encoder: text_to_image (default SampleConfig, 12 steps, "xla"
               route), img2img, inpaint, outpaint, interpolate and a phrase
               reweight, each with its launch counts, output checks and p50
  8. small     PaellaConfig.tiny() in f32 (C 32/64/64, head dim 16) on the
               card against the same weights on the CPU (plain versions), in
               the default and in the attention config, two variants in the
               attention config at widths the kernels take since C3's repair
               (C 36/60/60 with head dim 15; C 32/320/320 with head dim 160),
               tiny() drawing through the fused head (categorical_impl
               "pallas", K2 at C 16), K2, K3 and K4 at widths off their vector
               and wgmma steps (fault C4) against their plain versions, and
               the tiny codec, encoder included
  9. K5, K6    fused attention core and fused attention block against their
               plain versions at the flagship's level-1 and level-2 shapes,
               bf16 and f32, and two runs bitwise equal; K5 in turns with
               SDPA, its device time beside SDPA's, and at S 1036 (the
               streamed path); K6's device time per sub-kernel at both
               levels (torch.profiler), its products' TFLOP/s beside
               torch.matmul's, and a ragged case (N 81, S_cond 7)
 10. attn e2e  the flagship config with attention_impl="pallas" and
               attn_block_kernel=True: one forward's launch counts and
               features against the same weights' plain-attention forward,
               then 8-step CFG sampling and decode, with launch counts and
               p50s beside the plain-attention config's, and a profile of one
               generation of each (kernel time by owner, busy share)
 11. serve     PaellaServer at the attention config on 127.0.0.1: /healthz,
               single requests whose PNGs equal the pipeline's images, a
               repeated request byte-identical, micro-batches of three
               concurrent requests against the single path at 256x256 and
               256x384, HTTP p50
 12. C5        fault C5 measured: with TF32 on in the caller, an f32
               VQConfig() decode's uint8 pixels and the Inception pool3
               features of 32 images, card vs CPU, before the repair (the
               exact_f32 pin switched off) and after it; after it the card's
               output under TF32 on equals two runs under TF32 off bit for bit
     entry     the serving entry point with real towers: seeded full-width
               checkpoint files written in bf16 (the flagship denoiser,
               VQConfig()'s codec, ByT5-XL, open_clip ViT-H-14 and a
               synthetic merge table), serve.build_pipeline on the card from
               them: text_to_image with CLIP conditioning (launch counts: K1
               and K3), best-of-2 reranked by the CLIP towers, the towers'
               encode p50s; the ViT-H-14 towers at depth 2, bf16 on the card
               against f32 on the CPU (cosine >= 0.999); `python -m
               paella_tpu_torch.serve` on the same files (torch's TF32
               defaults), whose PNG equals the pipeline's image made under the
               script's TF32 off; the Inception featurizer card vs CPU and its
               images/s at batch 32, 299x299
 13. K1b       the ResBlock kernel with int8 fc weights (quantized as
               quant.quantize_paella_int8 does), weight-only and W8A8, at the
               four K1 shapes in bf16 (weight-only also f32 at one): against
               its plain version, two runs bitwise equal, an image's output
               equal at batch 2 and 8, and timed beside the float K1; per
               bf16 shape its device time per sub-kernel (torch.profiler), the
               two products' TOP/s beside torch._int_mm's (W8A8) or
               torch.matmul's (weight-only, on the codes widened once, as a
               yardstick only), and the host's time to enqueue a call
 14. int8 e2e  the flagship with every ResBlock quantized
               (quantize_paella_int8 over fuse_eligible_levels, include_first),
               weight-only and W8A8: one CFG forward's launch counts (56 K1b,
               no K1) and features against the plain versions on the card;
               the ByT5-XL encoder (seeded, bf16, and quantize_t5_int8 in
               both modes) encode p50s; text_to_image at 8 steps with each
               mode's encoder as byt5_encode_fn, in turns with the bf16
               pipeline; the W8A8 quality proxies' rows
 15. graph     the sampler's CUDA graph in the plain, attention and int8
               (weight-only, W8A8) configurations at the flagship's width:
               replayed tokens bit for bit the eager body's (sample_eager) on
               both routes at batch 1 and 3 with CFG, a cutoff and the
               editing inputs; new schedule values capture nothing; graph
               and eager 8-step p50 in turns, a profile of each (busy share),
               the kernels of one replay by name, each graph's pool bytes
 16. train     the training step (train/trainer.py) at the JAX package's "1b"
               training configuration (v1_byt5_xl in bf16 with remat and
               dropout 0.1, the frozen bf16 VQConfig() codec), full width,
               seeded f32 parameters, batch 8 at 256x256: median step ms,
               images/s, peak memory, first and last loss, lr 0 on the first
               update, K4 once a microbatch, a profile of one step (kernel
               time by kind, busy share), grad_accum_steps=2, K4 on the
               step's latents vs plain, a step's FLOPs (torch.utils.
               flop_counter) and MFU; then PaellaConfig.tiny() two steps card
               vs CPU on pinned draws (loss, grad_norm, updated parameters)
 17. driver    train/driver.py::run_training at phase 16's "1b" configuration
               (bf16 Adam moments), batch 8 at 256x256, the hash encoders of
               make_synthetic_encode_fn at ByT5-XL / CLIP widths, data through
               WebDatasetLoader over JPEG tar shards (SyntheticDataset where
               PIL or a JPEG decoder is missing, printed as such): 4 steps,
               eval_every 2 (two checkpoints, two eval grids), then fresh
               objects resume from the step-2 checkpoint to step 4; step ms
               and images/s beside phase 16's, checkpoint bytes and save /
               restore seconds, eval-grid seconds, K1 / K3 / K4 launches, peak
               memory; the step-4 grid's tokens equal a fresh model's loaded
               from the step-4 checkpoint (fault C6), K4 on step 4's latents
               vs plain, the resumed run within two Adam steps of the
               uninterrupted one
 18. codec     codec/trainer.py at VQConfig() in f32 with the default
               Discriminator, batch 8 at 256x256: 5 steps (step ms, images/s,
               peak memory, losses, codes used and revived), K4 once a step,
               K4 on the batch's latents vs plain
 19. ddp       parallel/ at world size 1 on NCCL: one DDP train step of
               PaellaConfig.tiny() bit for bit the same step without DDP
 20. fsdp      parallel.shard_model (FSDP2 over a (1, 1) dp x fsdp mesh) at
               world size 1 on NCCL, at phase 16's "1b" configuration with
               bf16 moments, batch 8 at 256x256, pinned draws: two sharded
               steps in turns with two plain steps from the same weights
               (metrics and parameters held together; step ms and peak
               memory of each route), the whole-state gather a checkpoint
               makes (bytes, seconds), a restore into a freshly sharded
               model (seconds) whose third step equals the uninterrupted
               third step, K4 once a step
 21. production the port's entry points (paella_tpu_torch/scripts/), each
               a process of its own on the card: first, in this process,
               the "1b" step (bf16 moments, batch 8 at 256x256) fed as
               run_training feeds it by the frozen ByT5-XL + ViT-H-14 towers
               or phase 17's synthetic encoders, at encode_prefetch 0 and 1,
               in turns (step ms, images/s, the towers' encode ms a batch,
               peak memory); then run_codec_pretrain (VQConfig() f32, 6
               steps, the GAN term from step 3) and its codec_vars.npz read
               back bit for bit; run_driver_e2e --geometry 1b against that
               codec, SIGTERM after its first checkpoint and eval grid and a
               fresh process resuming, then --byt5 w8a8; run_eval_e2e over
               the run's checkpoints, --n 32 --trend, in image space with
               --real-recon and in token space with the W8A8 twins (K1b);
               each run's JSON line, K1 / K1b / K3 / K4 launches, seconds
 22. examples  the JAX repo's examples as the port's entry points
               (paella_tpu_torch/examples/), each main() in this process on
               seeded full-width files (phase 12's writer): generate at the
               flagship, 8 steps (the six calls at 256x256 and 256x512, each
               call's ms, five graph captures, K1 / K3 / K4 launches, the
               inpainted left half equal to the source's tokens);
               train_minimal at v1_byt5_xl() f32 with the frozen ByT5-XL,
               batch 8 at 256x256, 4 steps (losses, step ms, peak memory, two
               12 GB checkpoints, K4 once a step); eval_quality's W8A8 proxy
               on the denoiser file at a 64x64 latent (K1 and K1b W8A8), the
               ByT5 proxy with its stress arm at byt5_small_like, the tiny
               CLIP demo on the card
Then a line of each phase's seconds.
Generations run as captured CUDA graphs (sampling/graph.py): a counted
generation captures its graph, so its wrappers count the warm-up's and the
capture's launches (GRAPH_PASSES x one generation's), and the kernels of one
replay are counted from a torch.profiler trace.
Then a JSON line of the kernels (each with its time, plain version's time,
bound and, where one PyTorch call computes the same function, that call's
time; every kernel also with its device time alone,
`device_ms`, null where torch.profiler traced nothing; K2, K3 and K4 with
`issue_bound_ms`), the card's name and power limit, and, last, {"ok": true, "device":
{...}}. Any failed check raises; without a CUDA device the script exits
non-zero and prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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
# Stage C's AttnBlock at 1024² and CFG batch 8 (B, N pixels, S_cond, heads, head dim): K5's wgmma variant
STAGE_C_ATTN = (8, 576, 85, 32, 64)
K5_SWEEP = [(16, 40), (64, 136), (200, 130), (576, 661)]  # (N, S) at D 64, bf16
K5_PAIRS = [(8, 32), (4, 32), (2, 16), (1, 2)]  # (B, H): Stage C at batch 4 and 2 (CFG), Paella's pair, one item
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

    kernels = (k_res.fused_resblock, k_samp.fused_head_categorical,
               k_samp.gumbel_categorical, k_q.fused_codebook_lookup, k_att.fused_attention, k_blk.fused_attn_block)
    plains = (k_res.resblock_plain, k_samp.head_categorical_plain, k_samp.gumbel_categorical_plain,
              k_q.codebook_lookup_plain, k_att.attention_plain, k_blk.attn_block_plain)
    return kernels, plains


def counted(fn):
    """Run fn() with every launch count set to 0 just before; return its
    result and the counts read just after (synchronized). fused_resblock's
    launches are also read per mode, as `fused_resblock[float]` (K1),
    `fused_resblock[int8]` and `fused_resblock[w8a8]` (K1b). The sampler's
    kept CUDA graphs are dropped first, so a generation inside fn captures
    its graph: its warm-up and its capture each go through every wrapper
    once (GRAPH_PASSES), and a replay through none (replay_launches counts
    a replay's kernels from a trace instead)."""
    import torch

    from paella_tpu_torch.kernels.resblock import fused_resblock
    from paella_tpu_torch.sampling import graph

    graph.clear()
    kernels, plains = launch_counters()
    for f in kernels + plains:
        f.launches = 0
    by_mode = fused_resblock.launches_by_mode
    by_mode.update(dict.fromkeys(by_mode, 0))
    out = fn()
    torch.cuda.synchronize()
    launches = {f.__name__: f.launches for f in kernels + plains}
    launches.update({f"fused_resblock[{m}]": n for m, n in by_mode.items()})
    for f in plains:
        check(launches[f.__name__] == 0, f"{f.__name__} ran on the card")
    return out, launches


def check_launches(what: str, launches: dict, expect: dict) -> None:
    for k, n in expect.items():
        check(launches[k] == n, f"{what}: {k} launched {launches[k]} times, want {n}")


GRAPH_PASSES = 2  # wrapper calls a generation makes when its graph is captured: the warm-up and the capture
# the kernels of a trace by the name of one kernel each call launches once
REPLAY_KERNELS = {"K1": ("dw_ln_kernel",), "K2": ("head_wgmma_kernel", "head_simt_kernel"), "K3": ("gumbel_kernel",),
                  "K4": ("lookup_kernel",), "K5": ("attention_ring_kernel",), "K6": ("block_attention_kernel",)}


def replay_launches(fn) -> dict | None:
    """The kernel calls in one fn() call (a generation whose graph is
    captured: a replay), counted from a torch.profiler trace (five tries);
    None where the tracer caught nothing, which check_replay fails."""
    return replay_counts(profile_kernels(fn)[0])


def replay_counts(kernels: dict) -> dict | None:
    """The calls of each kernel in profile_kernels' entries, by REPLAY_KERNELS."""
    if not kernels:
        return None
    return {k: round(sum(n for name, (_, n) in kernels.items() if any(m in name for m in marks)))
            for k, marks in REPLAY_KERNELS.items()}


def check_replay(what: str, got: dict | None, expect: dict, tag: str) -> None:
    """The launches of one replay against `expect`: the only count of the
    kernels a replayed generation runs, so an untraced replay fails."""
    print(f"[{what}] kernels of one replay (torch.profiler): {json.dumps(got) if got else 'not traced'} ({tag})")
    check(got is not None, f"{what}: torch.profiler traced no kernel of a replay in 5 tries")
    for k, n in expect.items():
        check(got[k] == n, f"{what}: one replay launched {k} {got[k]} times, want {n}")


def phase_build(tag: str) -> dict:
    from paella_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, all at once
        paths = dict(zip(LIBRARIES, pool.map(_build.build, LIBRARIES)))
    regs = {}
    for name, path in paths.items():
        _build.load_library(name)
        log = path.with_suffix(".log").read_text()
        regs[name] = [ln.strip() for ln in log.splitlines()
                      if "registers" in ln or "spill" in ln or "warning" in ln.lower()]
    secs = time.perf_counter() - t0
    print(f"[build] {' + '.join(n + '.cu' for n in LIBRARIES)} built and loaded in {secs:.1f} s ({tag})")
    for name, lines in regs.items():
        for ln in lines:
            print(f"[build]   {name}: {ln}")
    return {"build_s": secs}


def random_resblock(c: int, cpg: int, dtype, gen, mode: str = "float"):
    """Random ResBlock weights in the kernel's layout; mode "int8" or "w8a8"
    quantizes fc1 and fc2 as quant.quantize_paella_int8 does."""
    import torch

    from paella_tpu_torch.kernels.resblock import prepare_resblock_weights
    from paella_tpu_torch.quant import quantize_dense_int8

    dev = "cuda"
    r = lambda *s, std: torch.randn(*s, generator=gen, device=dev) * std  # noqa: E731
    dw, dw_b, w1, b1 = r(c, cpg, 3, 3, std=0.2), r(c, std=0.1), r(4 * c, c, std=c**-0.5), r(4 * c, std=0.1)
    gamma, beta, w2, b2 = r(4 * c, std=0.2), r(4 * c, std=0.2), r(c, 4 * c, std=(4 * c) ** -0.5), r(c, std=0.1)
    scales = {}
    if mode != "float":
        (w1, s1), (w2, s2) = quantize_dense_int8(w1), quantize_dense_int8(w2)
        scales = dict(fc1_scale=s1, fc2_scale=s2, act_quant=mode == "w8a8")
    return prepare_resblock_weights(dw, dw_b, w1, b1, gamma, beta, w2, b2, dtype, **scales)


# published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet): the
# bound of a kernel is the larger of its bytes over HBM and its operations
# over the peak of their type
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bf16": 989e12, "int8": 1979e12, "f32": 67e12}


def bound(nbytes: float, ops: float, kind: str) -> dict:
    """bound_ms and bound_by for a call that must move `nbytes` (each input
    read once, each output written once) and do `ops` operations of `kind`."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S * 1e3, ops / PEAK_OPS_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def resblock_bound(x, w, film, skip) -> dict:
    """K1/K1b: inputs, weights and output bytes; the two products' 16 M C^2
    operations (the depthwise conv, LN, GELU and GRN add under 1%), at the
    rate of the type they run in: bf16 or f32 over the codes widened to x's
    dtype (float and weight-only), int8 (W8A8)."""
    import torch

    b, hh, ww, c = x.shape
    weights = [v for v in w if isinstance(v, torch.Tensor)]
    kind = "int8" if w.act_quant else ("bf16" if x.dtype == torch.bfloat16 else "f32")
    return bound(nbytes_of(x, film, skip, *weights) + nbytes_of(x), 16 * b * hh * ww * c * c, kind)


def profile_kernels(fn, runs: int = 1) -> tuple[dict, float]:
    """torch.profiler over `runs` calls of fn() after one warm-up: ({kernel
    name: (device µs per run, launches per run)}, host wall ms per run)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    kernels = {}
    for attempt in range(5):  # the card's tracer now and then catches nothing: take it again
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / runs
        for e in prof.key_averages():
            # device events only (kernels, memcpys, memsets): a host op's self
            # device time repeats its kernels' (torch.profiler's own total skips it too)
            if e.device_type == DeviceType.CPU or getattr(e, "is_user_annotation", False):
                continue  # a user-annotated range (Optimizer.step) on the device repeats its kernels' time too
            us = getattr(e, "self_device_time_total", None)
            if us is None:
                us = e.self_cuda_time_total
            if us > 0:
                kernels[e.key] = (us / runs, e.count / runs)
        if kernels:
            break
    else:
        print("[profile] torch.profiler traced no device activity in 5 tries", flush=True)
    return kernels, wall_ms


def device_us(fn, runs: int = 20) -> float | None:
    """Device time of one fn() call: the sum of its kernels' durations
    (torch.profiler), without the gaps between launches; None where the
    tracer caught nothing (the message before it says so), which the
    kernels line then carries as null."""
    kernels = profile_kernels(fn, runs)[0]
    return sum(us for us, _ in kernels.values()) if kernels else None


def us_text(us: float | None) -> str:
    return "not traced" if us is None else f"{us:.2f}"


def ms_of(us: float | None) -> float | None:
    return None if us is None else us / 1e3


def host_us(fn, runs: int = 50) -> float:
    """Host time to enqueue one fn() call (no synchronize inside the loop;
    the queue is far from full at these counts)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(runs):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e6 / runs


def group_kernels(kernels: dict, groups) -> dict:
    """Sum profile_kernels' entries into named groups: each kernel goes to
    the first (name, substrings) whose substring occurs in its name, else
    to "other". Values are [µs, launches]."""
    out = {name: [0.0, 0.0] for name, _ in groups}
    out["other"] = [0.0, 0.0]
    for key, (us, n) in kernels.items():
        name = next((g for g, subs in groups if any(s in key for s in subs)), "other")
        out[name][0] += us
        out[name][1] += n
    return out


# K1's and K1b's sub-kernels by name (csrc/resblock.cu), in launch order
K1_PHASES = [("dw+LN", ("dw_ln_kernel",)), ("fc1", ("fc1_",)), ("GRN scale", ("grn_scale_kernel",)),
             ("GRN apply", ("grn_apply_kernel",)), ("requant", ("requant_kernel",)),
             ("fc2 reduce", ("fc2_reduce_kernel",)), ("fc2", ("fc2_",))]
# a generation's kernels by owner (K6 before K5: block_attention_kernel)
GENERATION_GROUPS = [
    ("K1", ("dw_ln_kernel", "fc1_", "grn_scale_kernel", "grn_apply_kernel", "fc2_", "requant_kernel")),
    ("K6", ("ln_rows_kernel", "linear_kernel", "linear_wgmma_kernel", "linear_reduce_kernel", "block_attention_kernel")),
    ("K5", ("attention_kernel", "attention_ring_kernel")),
    ("K2, K3", ("head_wgmma_kernel", "head_simt_kernel", "gumbel_kernel")),
    ("cuBLAS/CUTLASS GEMMs", ("gemm", "cutlass", "xmma", "cublas", "Kernel2", "nvjet")),
    ("cuDNN conv", ("conv", "cudnn", "implicit")),
]


def k1_split(x, w, film, skip, tag: str) -> dict:
    """K1's (or, for int8 weights, K1b's) device time per sub-kernel
    (torch.profiler, 10 calls), its two products' rate, and one PyTorch call
    of each product as a printed yardstick (not a library_ms: no one PyTorch
    call is a ResBlock): torch.matmul of the bf16 products (weight-only: of
    the codes widened to bf16 once, outside the timing), torch._int_mm of
    the s8 products (W8A8)."""
    import torch

    from paella_tpu_torch.kernels.resblock import fused_resblock

    b, hh, ww, c = x.shape
    m = b * hh * ww
    mode = w.mode
    label = "K1" if mode == "float" else f"K1b {mode}"
    call = lambda: fused_resblock(x, w, film=film, skip=skip)  # noqa: E731
    split = group_kernels(profile_kernels(call, runs=10)[0], K1_PHASES)
    parts = ", ".join(f"{k} {us:.2f} ({n:g})" for k, (us, n) in split.items() if n)
    host = host_us(call)
    traced = bool(parts)  # else profile_kernels said so: no device time, and no rates
    dev = sum(us for us, _ in split.values()) if traced else None
    print(
        f"[{label}] ({b},{hh},{ww},{c}) skip={skip is not None} bf16 per sub-kernel, device µs per call (launches): "
        f"{parts or 'not traced'}; all {us_text(dev)} µs on the device, {host:.2f} µs on the host to enqueue a call ({tag})"
    )
    ops = 8 * m * c * c  # each product: 2 M C 4C
    w1, w2 = w.w1[:, :c], w.w2[:, : 4 * c]
    if mode == "w8a8":
        xn = torch.randint(-127, 128, (m, c), device="cuda", dtype=torch.int8)
        h = torch.randint(-127, 128, (m, 4 * c), device="cuda", dtype=torch.int8)
        mm1 = cuda_time_ms(lambda: torch._int_mm(xn, w1.t()))
        mm2 = cuda_time_ms(lambda: torch._int_mm(h, w2.t()))
        unit, yard = "TOP/s", "torch._int_mm"
    else:
        xn = torch.randn(m, c, device="cuda").to(torch.bfloat16)
        h = torch.randn(m, 4 * c, device="cuda").to(torch.bfloat16)
        w1, w2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
        mm1 = cuda_time_ms(lambda: xn @ w1.t())
        mm2 = cuda_time_ms(lambda: h @ w2.t())
        unit, yard = "TFLOP/s", "torch.matmul"
    fc1_us, fc2_us = (split["fc1"][0], split["fc2"][0] + split["fc2 reduce"][0]) if traced else (None, None)
    rate = lambda us: None if us is None else ops / us / 1e6  # noqa: E731
    text = lambda us: "not traced" if us is None else f"{us:.2f} µs = {rate(us):.1f} {unit}"  # noqa: E731
    print(
        f"[{label}] ({b},{hh},{ww},{c}) products, {ops / 1e9:.2f} GOP each: fc1 {text(fc1_us)}, fc2 (+ reduce) "
        f"{text(fc2_us)}; yardstick {yard} {mm1 * 1e3:.2f} µs = {ops / mm1 / 1e9:.1f} and {mm2 * 1e3:.2f} µs = "
        f"{ops / mm2 / 1e9:.1f} {unit} ({tag})"
    )
    return {"sub_kernels_us": {k: v[0] for k, v in split.items() if v[1]}, "device_us": dev, "host_us": host,
            "fc1_rate": rate(fc1_us), "fc2_rate": rate(fc2_us), "yardstick_rate": [ops / mm1 / 1e9, ops / mm2 / 1e9],
            "rate_unit": unit}


def phase_k1(tag: str) -> dict:
    import torch

    from paella_tpu_torch.kernels.resblock import fused_resblock, resblock_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    result = {"max_abs_err": 0.0, "shapes": {}}
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
            bd = resblock_bound(x, w, film, skip)
            print(
                f"[K1] fused_resblock ({b},{hh},{ww},{c}) skip={with_skip} {dname}: "
                f"max_abs_err {err:.3e} rel {rel:.3e} (limit {'abs 1e-3' if dtype == torch.float32 else 'rel 2e-2'}); "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) ({tag})"
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
                shape = result["shapes"][f"({b},{hh},{ww},{c}) skip={with_skip}"] = {
                    "ms": ms, "plain_ms": plain_ms, **bd, **k1_split(x, w, film, skip, tag)}
                if (b, hh, ww, c, with_skip) == K1_SHAPE:
                    result.update(ms=ms, plain_ms=plain_ms, device_ms=ms_of(shape["device_us"]), **bd)
    return result


# the first murmur3 multiplier as cuobjdump prints it (a signed 32-bit
# immediate, or hex); a draw has two murmur3 rounds, so two of them
HASH_MULTIPLIER = ("-0x7a143595", "0x85ebca6b")


def sass_draw_loops(name: str, path=None) -> dict:
    """Per kernel of the built library csrc/{name}.cu (mangled name): the loop
    (a branch back to an earlier address, cuobjdump -sass) that holds the
    most murmur3 rounds, as (SASS instructions in the loop, draws in it). The
    loop's instructions over its draws is the issue cost of one (row, label)
    element, the loop's own overhead shared among them."""
    return sass_loops(name, lambda ins: sum(ins.count(c) for c in HASH_MULTIPLIER) / 2, path)


def sass_loops(name: str, elements, path=None, innermost: bool = False) -> dict:
    """Per kernel of the built library csrc/{name}.cu (mangled name): the loop
    (a branch back to an earlier address, cuobjdump -sass) that holds the
    most elements, summed over its instructions by elements(instruction), or
    with `innermost` the loop with the fewest instructions an element (an
    inner loop rather than the loop around it), as (SASS instructions in the
    loop, elements in it)."""
    import re

    from torch.utils.cpp_extension import CUDA_HOME

    from paella_tpu_torch.kernels import _build

    exe = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([exe, "-sass", str(path or _build.library_path(name))], capture_output=True, text=True,
                          check=True).stdout
    out = {}
    for chunk in text.split("Function : ")[1:]:
        instrs = []  # (address, instruction)
        for ln in chunk.splitlines():
            hit = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;?\s*(?:/\*.*)?$", ln)
            if hit and hit.group(2):
                instrs.append((int(hit.group(1), 16), hit.group(2)))
        best = None
        for addr, ins in instrs:
            hit = re.search(r"\bBRA(?:\.\w+)*\s+(0x[0-9a-f]+)", ins)
            if hit and int(hit.group(1), 16) <= addr:
                loop = [x for a, x in instrs if int(hit.group(1), 16) <= a <= addr]
                draws = int(sum(elements(x) for x in loop))
                if draws and (best is None or (len(loop) / draws < best[0] / best[1] if innermost else draws > best[1])):
                    best = (len(loop), draws)
        if best:
            out[chunk.split()[0]] = best
    return out


def draw_cost(loops: dict, kernel: str) -> float | None:
    """SASS instructions per drawn element of the first kernel whose mangled
    name holds `kernel` (None where no draw loop was found)."""
    for fname, (n, draws) in sorted(loops.items()):
        if kernel in fname:
            return n / draws
    return None


def issue_rate() -> float:
    """Thread-instructions the card can issue a second: SMs x 4 schedulers x
    32 lanes x the SM's maximum clock (nvidia-smi clocks.max.sm)."""
    import torch

    mhz = float(subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                               capture_output=True, text=True, check=True).stdout.split()[0])
    return torch.cuda.get_device_properties(0).multi_processor_count * 4 * 32 * mhz * 1e6


def issue_bound_ms(elements: int, per_element: float | None) -> float | None:
    return None if per_element is None else elements * per_element / issue_rate() * 1e3


def in_turns(a, b, iters: int = 20) -> tuple[list, list]:
    """CUDA-event ms per call of a and b, measured a, b, b, a: ([a, a], [b, b])."""
    t = [cuda_time_ms(f, iters) for f in (a, b, b, a)]
    return [t[0], t[3]], [t[1], t[2]]


def span(v: list) -> str:
    return f"{min(v):.4f}-{max(v):.4f}"


HEAD_C, HEAD_K = 256, 8192  # the flagship's head: c_out 256 -> 8192 labels


def head_case(b: int, dtype, gen, c: int = HEAD_C, k: int = HEAD_K, hw: int = 64):
    """A flagship-shaped head call at batch b: seeds on the card (as the
    sampler holds them), features (b, hw, hw, c) x2, W_out (k, c)."""
    import torch

    seeds = torch.tensor([[0x9E3779B9 + 7 * i, 12345 + i] for i in range(b)], dtype=torch.int64, device="cuda")
    fc = torch.randn(b, hw, hw, c, generator=gen, device="cuda").to(dtype)
    fu = torch.randn(b, hw, hw, c, generator=gen, device="cuda").to(dtype)
    w_out = (torch.randn(k, c, generator=gen, device="cuda") * (1.0 / k) ** 0.5).to(dtype)
    return (seeds, fc, fu, 8.0, w_out, 0.7)


def head_flip_gap(args, got, want) -> float:
    """The plain f32 scores' largest gap between the kernel's and the plain
    version's choice where they differ (0.0 if they agree everywhere)."""
    import torch

    from paella_tpu_torch.kernels.sampling import hash_uniform, step_scalar

    seeds, fc, fu, cfg_w, w_out, temp = args
    flips = (got != want).reshape(-1)
    if not flips.any():
        return 0.0
    c, w, inv_t = fc.shape[-1], step_scalar(cfg_w, fc.device), step_scalar(temp, fc.device).reciprocal()
    f = (fc.float() * w + fu.float() * (1.0 - w)).to(fc.dtype).float().reshape(-1, c)[flips]
    rows = torch.nonzero(flips).reshape(-1)
    hw = fc.numel() // c // seeds.shape[0]
    u = hash_uniform(seeds, (hw, w_out.shape[0])).reshape(-1, w_out.shape[0])[rows]
    score = (f @ w_out.float().t()) * inv_t - torch.log(-torch.log(u))
    pick = lambda t: score.gather(1, t.reshape(-1, 1)[flips].long())  # noqa: E731
    return (pick(want) - pick(got)).abs().max().item()


def phase_k2(tag: str) -> dict:
    """K2 at the flagship step (M 4096) and at batch 8 (M 32768), bf16 and
    f32: tokens against the plain version, two runs bitwise equal; CUDA-event
    ms in turns with the plain version and with the composed "xla" route
    (the head product by torch.matmul, then K3), device µs (torch.profiler)
    of each, torch.matmul of the head product alone, the bytes/ops bound and
    the instruction-issue bound from the SASS; then batch invariance (an
    image's tokens at B = 1 and inside B = 3, whose launch plans differ)."""
    import torch

    from paella_tpu_torch.kernels.sampling import fused_head_categorical, head_categorical_plain, head_plan, step_scalar
    from paella_tpu_torch.sampling.sampler import draw_tokens

    gen = torch.Generator(device="cuda").manual_seed(12)
    loops = sass_draw_loops("sampling")
    per_el = {"bf16": draw_cost(loops, "head_wgmma_kernelILb0ELi4E"), "f32": draw_cost(loops, "head_simt_kernelIfLb1ELb0E")}
    print(f"[K2] SASS instructions per drawn element (draw loop / its draws): wgmma path "
          f"{per_el['bf16'] or 'not counted'}, SIMT f32 path {per_el['f32'] or 'not counted'}; "
          f"issue rate {issue_rate() / 1e12:.2f} T thread-instructions/s ({tag})")
    result = {"batches": {}}
    for b in (1, 8):
        for dtype in (torch.bfloat16, torch.float32):
            dname = "f32" if dtype == torch.float32 else "bf16"
            args = head_case(b, dtype, gen)
            seeds, fc, fu, cfg_w, w_out, temp = args
            m = fc.numel() // HEAD_C
            got = fused_head_categorical(*args)
            want = head_categorical_plain(*args)
            again = fused_head_categorical(*args)
            torch.cuda.synchronize()
            agree = (got == want).float().mean().item()
            gap = head_flip_gap(args, got, want)
            same = torch.equal(got, again)
            iters = 20 if b == 1 else 5
            k_ms, p_ms = in_turns(lambda: fused_head_categorical(*args), lambda: head_categorical_plain(*args), iters)
            k2_ms, x_ms = in_turns(lambda: fused_head_categorical(*args), lambda: draw_tokens("xla", *args), iters)
            w = step_scalar(cfg_w, fc.device)
            mixed = (fc.float() * w + fu.float() * (1.0 - w)).to(dtype).reshape(m, HEAD_C)
            mm_ms = cuda_time_ms(lambda: torch.matmul(mixed, w_out.t()), iters)
            dev = device_us(lambda: fused_head_categorical(*args))
            x_dev = device_us(lambda: draw_tokens("xla", *args))
            bd = bound(nbytes_of(fc, fu, w_out, got), 2 * m * HEAD_C * HEAD_K, dname)
            ib = issue_bound_ms(m * HEAD_K, per_el[dname])
            plan = head_plan(m, HEAD_C, HEAD_K, dtype)
            print(
                f"[K2] fused_head_categorical ({b},64,64,{HEAD_C})x2 x ({HEAD_K},{HEAD_C}) cfg 8 T 0.7 {dname}, "
                f"M {m}, plan {plan} (blocks sharing a row tile's labels; 0: SIMT): tokens agree {agree:.6f} (limit 0.999), max score gap "
                f"at flips {gap:.3e}, two runs bitwise equal {same}; kernel {span(k_ms + k2_ms)} ms "
                f"(events), device {us_text(dev)} µs; plain {span(p_ms)} ms; composed route (torch.matmul + K3) "
                f"{span(x_ms)} ms, device {us_text(x_dev)} µs; torch.matmul of the head product alone "
                f"{mm_ms:.4f} ms; bound {bd['bound_ms'] * 1e3:.1f} µs ({bd['bound_by']}), issue bound "
                f"{'not counted' if ib is None else f'{ib * 1e3:.1f} µs'} ({tag})"
            )
            check(agree >= 0.999, f"K2 {dname} M {m} token agreement {agree} < 0.999")
            check(same, f"K2 {dname} M {m} gave different tokens on two runs")
            check(bool(((got >= 0) & (got < HEAD_K)).all()), "K2 tokens out of range")
            entry = {"agree": agree, "max_abs_err": gap, "ms": sum(k_ms + k2_ms) / 4, "plain_ms": sum(p_ms) / 2,
                     "device_ms": ms_of(dev), "library_ms": sum(x_ms) / 2, "library_device_ms": ms_of(x_dev),
                     "matmul_ms": mm_ms, "issue_bound_ms": ib, "plan": plan, **bd}
            result["batches"][f"{b}_{dname}"] = entry
            if (b, dtype) == (1, torch.bfloat16):
                result.update(entry)
            if b == 1:
                check_head_batch_invariance(args, got, gen, tag)
            if b == 1:
                zero = torch.zeros_like(w_out)
                z_args = (seeds, fc, fu, cfg_w, zero, temp)
                z_agree = (fused_head_categorical(*z_args) == head_categorical_plain(*z_args)).float().mean().item()
                print(f"[K2] W_out = 0 (hash alone) {dname}: tokens agree {z_agree:.6f} (limit 0.9999) ({tag})")
                check(z_agree >= 0.9999, f"K2 {dname} hash-only agreement {z_agree} < 0.9999")
            del args, fc, fu, mixed
            torch.cuda.empty_cache()
    return result


def check_head_batch_invariance(args, got, gen, tag: str) -> None:
    """The B = 1 call's image, placed second in a batch of three (other
    images and seeds around it), draws the same tokens: the launch plan
    changes (the labels split among 8 blocks at M 4096, 2 at 12288)."""
    import torch

    from paella_tpu_torch.kernels.sampling import fused_head_categorical, head_plan

    seeds, fc, fu, cfg_w, w_out, temp = args
    other = head_case(2, fc.dtype, gen)
    seeds3 = torch.cat([other[0][:1], seeds, other[0][1:]])
    fc3, fu3 = (torch.cat([o[:1], f, o[1:]]) for o, f in ((other[1], fc), (other[2], fu)))
    got3 = fused_head_categorical(seeds3, fc3, fu3, cfg_w, w_out, temp)
    same = torch.equal(got3[1:2], got)
    plans = [head_plan(t.numel() // t.shape[-1], t.shape[-1], w_out.shape[0], t.dtype) for t in (fc, fc3)]
    print(f"[K2] {fc.dtype}: image at B = 1 (plan {plans[0]}) and inside B = 3 (plan {plans[1]}) "
          f"draws equal tokens: {same} ({tag})")
    check(same, f"K2 {fc.dtype} tokens depend on the batch")


def score_gap(logits, seeds, got, want, temperature: float) -> float:
    """The plain scores' largest gap between the two choices where the
    kernel and the plain version picked different tokens (0.0 if none); one
    image, seeds (1, 2)."""
    import torch

    from paella_tpu_torch.kernels.sampling import hash_uniform, step_scalar

    flips = (got != want).reshape(-1)
    if not flips.any():
        return 0.0
    k = logits.shape[-1]
    rows = logits.reshape(-1, k)[flips].float() * step_scalar(temperature, logits.device).reciprocal()
    u = hash_uniform(seeds.to(logits.device), (logits.numel() // k, k))[0][flips]
    score = rows - torch.log(-torch.log(u))
    pick = lambda t: score.gather(1, t.reshape(-1, 1)[flips].long())  # noqa: E731
    return (pick(want) - pick(got)).abs().max().item()


def phase_k3(tag: str) -> dict:
    """K3 over flagship logits (1,64,64,8192), bf16 and f32: tokens bit for
    bit the plain version's; CUDA-event ms in turns with the plain version,
    device µs (torch.profiler), the bytes bound and the instruction-issue
    bound from the SASS."""
    import torch

    from paella_tpu_torch.kernels.sampling import draw_noise, gumbel_categorical, gumbel_categorical_plain, uniform_from_bits

    bits = (torch.arange(2**24, device="cuda", dtype=torch.int64) << 8) | 0x5A  # every u
    same = torch.equal(draw_noise(bits).view(torch.int32), (-torch.log(-torch.log(uniform_from_bits(bits)))).view(torch.int32))
    print(f"[K3] the kernels' shared draw (common.cuh::gumbel_noise) over all 2^24 values of u: noise bit for bit "
          f"torch's {same} ({tag})")
    check(same, "the shared draw's noise differs from torch's")
    del bits
    gen = torch.Generator(device="cuda").manual_seed(13)
    seeds = torch.tensor([[0x9E3779B9, 54321]], dtype=torch.int64, device="cuda")
    loops = sass_draw_loops("sampling")
    result = {}
    for dtype in (torch.bfloat16, torch.float32):
        dname = "f32" if dtype == torch.float32 else "bf16"
        per_el = draw_cost(loops, f"gumbel_kernelI{'13__nv_bfloat16' if dtype == torch.bfloat16 else 'f'}Lb1E")
        logits = (torch.randn(1, 64, 64, 8192, generator=gen, device="cuda") * 2.0).to(dtype)
        got = gumbel_categorical(seeds, logits, 0.7)
        want = gumbel_categorical_plain(seeds, logits, 0.7)
        torch.cuda.synchronize()
        agree = (got == want).float().mean().item()
        gap = score_gap(logits, seeds, got, want, 0.7)
        ms, plain_ms = alternate(lambda: gumbel_categorical(seeds, logits, 0.7), lambda: gumbel_categorical_plain(seeds, logits, 0.7))
        dev = device_us(lambda: gumbel_categorical(seeds, logits, 0.7))
        nbytes = logits.numel() * logits.element_size() + got.numel() * 4
        ib = issue_bound_ms(logits.numel(), per_el)
        print(
            f"[K3] gumbel_categorical (1,64,64,8192) T 0.7 {dname}: tokens agree {agree:.6f} (limit 1.000000), "
            f"max score gap at flips {gap:.3e}; kernel {ms:.4f} ms (events), device {us_text(dev)} µs, plain "
            f"{plain_ms:.4f} ms; {nbytes / 1e6:.1f} MB moved, {nbytes / ms / 1e6:.1f} GB/s = "
            f"{nbytes / ms / 3.35e9:.3f} of 3.35 TB/s HBM; SASS instructions per element "
            f"{'not counted' if per_el is None else f'{per_el:.2f}'}, issue bound "
            f"{'not counted' if ib is None else f'{ib * 1e3:.1f} µs'} ({tag})"
        )
        check(agree == 1.0, f"K3 {dname} token agreement {agree} < 1")
        check(bool(((got >= 0) & (got < 8192)).all()), "K3 tokens out of range")
        if dtype == torch.bfloat16:
            # 3 f32 operations a logit (scale by 1/T, add the noise, compare); the
            # hash is integer work and the two logs go to the special-function units
            result.update(max_abs_err=gap, ms=ms, plain_ms=plain_ms, device_ms=ms_of(dev), issue_bound_ms=ib,
                          per_element=per_el, **bound(nbytes, 3 * logits.numel(), "f32"))
    return result


# K4's cases: (M, C, codebook); M 4096 is the codec's encode of a 256x256
# image, M 8 x 4096 an 8-frame interpolation; 8192 codes
K4_CASES = [(4096, 4, "N(0,1)"), (4096, 4, "U(+-1/8192)"), (8 * 4096, 4, "N(0,1)"), (4096, 12, "N(0,1)")]


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without namespace and template arguments."""
    import re

    hit = re.search(r"(\w+_kernel)\b", key)
    return hit.group(1) if hit else key


def k4_search_cost(elements) -> int:
    """Elements in a SASS instruction of K4's search loop: its n - 2 d, one
    FFMA by -2 an element."""
    return int(elements.startswith("FFMA") and ", -2," in elements)


def phase_k4(tag: str) -> dict:
    """K4 against its plain version, bit for bit (no allowance for near-ties),
    at K4_CASES, and at each a NaN token and a token whose every distance
    overflows to +inf (index 0, as the plain version gives): device µs
    (torch.profiler) and the kernels a call launches (one), from the trace;
    CUDA-event ms in turns with the plain version; the bytes/ops bound and an
    instruction-issue bound from the search loop's SASS (instructions an
    element)."""
    import torch

    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup

    loops = sass_loops("quantize", k4_search_cost, innermost=True)
    per_el = {4: draw_cost(loops, "lookup_kernelILi4ELb0E"), 12: draw_cost(loops, "lookup_kernelILi0ELb1E")}
    print(f"[K4] SASS instructions per (token, code) element of the search loop: C 4 {per_el[4] or 'not counted'}, "
          f"C 12 (wide) {per_el[12] or 'not counted'}; issue rate {issue_rate() / 1e12:.2f} T thread-instructions/s ({tag})")
    gen = torch.Generator(device="cuda").manual_seed(14)
    result = {"cases": {}}
    for m, c, cb_name in K4_CASES:
        z = torch.randn(m, c, generator=gen, device="cuda")
        if cb_name == "N(0,1)":
            cb = torch.randn(8192, c, generator=gen, device="cuda")
        else:
            cb = (torch.rand(8192, c, generator=gen, device="cuda") * 2 - 1) / 8192
        want = codebook_lookup_plain(z, cb)
        got = fused_codebook_lookup(z, cb)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        check(bad == 0, f"K4 M {m} C {c} {cb_name}: {bad} indices differ from the plain version")
        odd = z.clone()
        odd[0], odd[-1] = float("nan"), -3e38
        odd_cb = cb.abs() + 0.5  # codes >= 0.5: every dot of the -3e38 token is -inf
        odd_got, odd_want = fused_codebook_lookup(odd, odd_cb), codebook_lookup_plain(odd, odd_cb)
        check(int(odd_want[0]) == 0 and int(odd_want[-1]) == 0 and torch.equal(odd_got, odd_want),
              f"K4 M {m} C {c}: a NaN token or one with every distance +inf gave {int(odd_got[0])} / "
              f"{int(odd_got[-1])} (plain {int(odd_want[0])} / {int(odd_want[-1])}), or another index differs")
        kernels = profile_kernels(lambda: fused_codebook_lookup(z, cb), runs=20)[0]
        check(bool(kernels), f"K4 M {m} C {c}: torch.profiler traced no launch")
        dev = sum(us for us, _ in kernels.values())
        # launches a call, rounded: the tracer now and then misses one of the 20
        calls = {kernel_name(k): round(n) for k, (_, n) in kernels.items()}
        check(calls == {"lookup_kernel": 1}, f"K4 M {m} C {c}: a call launched {calls}, want one lookup_kernel")
        ms, plain_ms = alternate(lambda: fused_codebook_lookup(z, cb), lambda: codebook_lookup_plain(z, cb))
        ib = issue_bound_ms(m * 8192, per_el[c])
        bd = bound(nbytes_of(z, cb, want), m * 8192 * 2 * c, "f32")  # C products, C - 1 sums and n - 2 d
        print(
            f"[K4] fused_codebook_lookup z ({m},{c}) vs {cb_name} codebook (8192,{c}) f32: 0 of {m} indices differ "
            f"from the plain version, a NaN token and an all-+inf one give index 0 as it does; device µs a call "
            f"{us_text(dev)}; kernels a call {json.dumps(calls)}; events {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
            f"{bd['bound_ms'] * 1e3:.2f} µs ({bd['bound_by']}), issue bound "
            f"{'not counted' if ib is None else f'{ib * 1e3:.2f} µs'} ({tag})"
        )
        entry = {"device_us": dev, "ms": ms, "plain_ms": plain_ms, "issue_bound_ms": ib, **bd}
        result["cases"][f"{m}x{c} {cb_name}"] = entry
        if (m, c, cb_name) == K4_CASES[0]:
            result.update(max_abs_err=0.0, ms=ms, plain_ms=plain_ms, device_ms=ms_of(dev), issue_bound_ms=ib,
                          per_element=per_el[c], **bd)
        del z, cb, want, odd, odd_cb
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
    print(f"[e2e] launches in one generation (its graph's warm-up and capture): {json.dumps(launches)}")
    check_launches("8-step generation", launches, {
        "fused_resblock[float]": GRAPH_PASSES * K1_PER_FORWARD * STEPS, "fused_head_categorical": GRAPH_PASSES * STEPS,
        "gumbel_categorical": 0, "fused_attention": 0, "fused_attn_block": 0,
    })
    check_replay("e2e", replay_launches(lambda: sample(model, seeds_for(43), cond, LATENT, uncond, s_cfg)),
                 {"K1": K1_PER_FORWARD * STEPS, "K2": STEPS, "K3": 0, "K5": 0, "K6": 0}, tag)
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
    """Seeded stand-ins for the text towers, on the card, kept so that the
    kernel phases stay fast: a table from byte ids to (B, S, byt5_embd)
    states, and CLIP-text features summed from a table over each prompt's
    bytes. phase_entry runs the real towers (ByT5-XL, CLIP ViT-H-14)."""
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
    taps = []  # token grids on their way to the decoder
    decode_clipped = pipe._decode_clipped
    pipe._decode_clipped = lambda tokens: (taps.append(tokens), decode_clipped(tokens))[1]
    prompt = "a red car on a beach"
    result = {"calls": {}, "launches": {}}

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
        for k, n in launches.items():
            result["launches"][k] = result["launches"].get(k, 0) + n
        result["calls"][name] = {"p50_ms": p50, "launches": launches}
        return out, tokens

    gen_counts = {"fused_resblock[float]": GRAPH_PASSES * forward, "fused_head_categorical": 0,
                  "gumbel_categorical": GRAPH_PASSES * steps, "fused_attention": 0, "fused_attn_block": 0}
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


# PaellaConfig.tiny() variants at widths the kernels take since C3's repair:
# C and head dims not multiples of 8, and heads wider than 128
TINY_VARIANTS = {
    "odd widths": dict(c_hidden=(36, 60, 60), nhead=(-1, 4, 4)),  # head dim 15
    "wide heads": dict(c_hidden=(32, 320, 320), nhead=(-1, 2, 2)),  # head dim 160
}


def phase_small_reference(tag: str) -> None:
    """PaellaConfig.tiny() in f32 on the card (kernels; K1 at C 32, K5 and K6
    at head dim 16) against the same weights on the CPU (plain versions), in
    the default and in the attention config, and its two TINY_VARIANTS in
    the attention config: features, tokens; then the tiny codec: image,
    encoder and encode."""
    import torch

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, VQConfig

    for name, flags in (("default", {}), ("attention", ATTN_FLAGS)):
        cfg = dataclasses.replace(PaellaConfig.tiny(), **flags)
        t_cpu = small_model_against_cpu(cfg, name, tag)
    small_model_against_cpu(PaellaConfig.tiny(), "default", tag, categorical_impl="pallas")
    phase_c4_widths(tag)
    for name, widths in TINY_VARIANTS.items():
        small_model_against_cpu(dataclasses.replace(PaellaConfig.tiny(), **ATTN_FLAGS, **widths), f"attention, {name}", tag)
    gen = torch.Generator().manual_seed(3)
    g = torch.Generator().manual_seed(5)
    vcfg = dataclasses.replace(VQConfig.tiny(), codebook_size=cfg.num_labels)
    vq_cpu = VQModel(vcfg)
    vq_cpu.reset_parameters(gen)
    perturb_(vq_cpu, gen, scale=0.05)
    vq_dev = VQModel(vcfg).cuda()
    vq_dev.load_state_dict(vq_cpu.state_dict())
    i_cpu = vq_cpu.decode_indices(t_cpu)
    i_dev = vq_dev.decode_indices(t_cpu.cuda()).cpu()
    ierr = (i_cpu - i_dev).abs().max().item()
    print(f"[small] tiny f32 codec, card vs CPU: decode max_abs_err {ierr:.3e} (limit 1e-3) ({tag})")
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


C4_HEAD_WIDTHS = [(16, 128), (20, 200), (300, 8190), (520, 300)]  # (C, K); 520: bf16 past the wgmma path
C4_GUMBEL_WIDTHS = [8190, 201]


def phase_c4_widths(tag: str) -> None:
    """K2, K3 and K4 at widths off the flagship's vector and wgmma steps
    (fault C4), against their plain versions on the card: K2 at C4_HEAD_WIDTHS
    with and without CFG and a ragged row count, bf16 and f32; K3 at
    C4_GUMBEL_WIDTHS and on a view one element off 16-byte alignment; K4 at
    latent width 12."""
    import torch

    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup
    from paella_tpu_torch.kernels.sampling import (
        fused_head_categorical,
        gumbel_categorical,
        gumbel_categorical_plain,
        head_categorical_plain,
        head_plan,
    )

    gen = torch.Generator(device="cuda").manual_seed(15)
    seeds = torch.tensor([[5, 0xDEADBEEF], [0xFFFFFFFF, 7], [1, 2]], dtype=torch.int64, device="cuda")
    worst, plans = 1.0, {}
    for c, k in C4_HEAD_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            for with_cfg in (False, True):
                fc = torch.randn(3, 5, 7, c, generator=gen, device="cuda").to(dtype)  # 105 rows: a ragged tile
                fu = torch.randn(3, 5, 7, c, generator=gen, device="cuda").to(dtype) if with_cfg else None
                w_out = (torch.randn(k, c, generator=gen, device="cuda") * c**-0.5).to(dtype)
                args = (seeds, fc, fu, 3.0, w_out, 0.8)
                agree = (fused_head_categorical(*args) == head_categorical_plain(*args)).float().mean().item()
                worst = min(worst, agree)
                plans[f"{c}x{k}"] = head_plan(105, c, k, torch.bfloat16)
                check(agree >= 0.99, f"K2 at C {c} K {k} {dtype} cfg {with_cfg}: tokens agree {agree} < 0.99")
    print(f"[small] K2 at (C, K) {C4_HEAD_WIDTHS}, M 105 (3 images of 5x7), bf16 and f32, with and without CFG: "
          f"tokens agree >= {worst:.4f} with the plain version (limit 0.99: 105 rows, one flip is 0.0095); "
          f"bf16 plans {json.dumps(plans)} ({tag})")
    for k in C4_GUMBEL_WIDTHS:
        for dtype in (torch.bfloat16, torch.float32):
            logits = (torch.randn(3, 5, 7, k, generator=gen, device="cuda") * 3.0).to(dtype)
            buf = torch.empty(logits.numel() + 1, dtype=dtype, device="cuda")
            unaligned = buf[1:].view(logits.shape)  # one element off 16-byte alignment
            unaligned.copy_(logits)
            for name, t in (("aligned", logits), ("unaligned", unaligned)):
                same = torch.equal(gumbel_categorical(seeds, t, 0.7), gumbel_categorical_plain(seeds, t, 0.7))
                check(same, f"K3 at K {k} {dtype} {name}: tokens differ from the plain version")
    print(f"[small] K3 at K {C4_GUMBEL_WIDTHS}, bf16 and f32, aligned and one element off: tokens equal the "
          f"plain version's ({tag})")
    z = torch.randn(3, 16, 16, 12, generator=gen, device="cuda")
    cb = torch.randn(1000, 12, generator=gen, device="cuda")
    same = torch.equal(fused_codebook_lookup(z, cb), codebook_lookup_plain(z, cb))
    print(f"[small] K4 at latent width 12 (768 tokens, 1000 codes): indices equal the plain version's {same} ({tag})")
    check(same, "K4 at width 12 differs from the plain version")


def small_model_against_cpu(cfg, name: str, tag: str, categorical_impl: str = "xla"):
    """One config's f32 model on the card against the same weights on the
    CPU: a CFG forward's features, with its kernel launch counts, and 4-step
    CFG tokens drawn by `categorical_impl` ("pallas": the fused head, K2 at
    the config's c_out and num_labels). Returns the CPU's tokens."""
    import torch

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling import Conditioning, sample

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
    f_dev, launches = counted(lambda: dev(x.cuda(), r.cuda(), cond.byt5.cuda(), cond.clip.cuda(), cond.clip_image.cuda(),
                                          return_features=True))
    ferr = (f_cpu - f_dev.cpu()).abs().max().item()
    seeds = torch.tensor([[1, 2], [3, 4]])
    s_cfg = SampleConfig(steps=4, temperature=(1.0, 0.5), cfg=(3.0, 3.0), categorical_impl=categorical_impl)
    t_cpu = sample(cpu, seeds, cond, (2, 16, 16), uncond, s_cfg)
    t_dev, s_launches = counted(lambda: sample(dev, seeds, cond.to("cuda"), (2, 16, 16), uncond.to("cuda"), s_cfg))
    t_dev = t_dev.cpu()
    drawer = "fused_head_categorical" if categorical_impl == "pallas" else "gumbel_categorical"
    check(s_launches[drawer] == GRAPH_PASSES * 4,
          f"tiny {name} sampling launched {drawer} {s_launches[drawer]} times, want {GRAPH_PASSES} x 4")
    agree = (t_cpu == t_dev).float().mean().item()
    kernels = {k: n for k, n in launches.items() if n and "[" not in k}
    print(
        f"[small] PaellaConfig.tiny() f32 ({name} config, C {cfg.c_hidden}, heads {cfg.nhead}, "
        f"categorical_impl {categorical_impl!r}: {drawer} at c_out {cfg.c_out}, {cfg.num_labels} labels), card vs CPU: "
        f"features max_abs_err {ferr:.3e} (limit 1e-3), 4-step CFG tokens agree {agree:.4f} (limit 0.95); "
        f"kernel launches in one forward {json.dumps(kernels)} ({tag})"
    )
    check(ferr <= 1e-3, f"tiny {name} model features differ by {ferr}")
    check(agree >= 0.95, f"tiny {name} model tokens agree {agree} < 0.95")
    check(launches["fused_resblock"] > 0, f"tiny {name} model ran no K1")
    if cfg.attention_impl == "pallas":
        check(launches["fused_attention"] > 0 and launches["fused_attn_block"] > 0, f"tiny {name} model ran no K5 or K6")
    return t_cpu


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
    import torch.nn.functional as F

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
                # the yardstick: one PyTorch call of the same function, scaled dot
                # product attention with the mask as an additive -1e9 (timed only)
                qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
                add = torch.zeros(b, 1, 1, s, device="cuda", dtype=dtype).masked_fill(~mask[:, None, None, :], -1e9)
                sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add)  # noqa: E731
                lib_err, lib_limit, lib_ok = attention_error(sdpa().transpose(1, 2), want)
                call = lambda: fused_attention(q, k, v, mask)  # noqa: E731
                ms_again, library_ms = alternate(call, sdpa)
                dev = {"kernel": device_us(call), "sdpa": device_us(sdpa)}
                host = {"kernel": host_us(call), "sdpa": host_us(sdpa)}
                print(
                    f"[K5] level {level} bf16, in turns with F.scaled_dot_product_attention (additive mask): kernel "
                    f"{ms_again:.4f} ms, SDPA {library_ms:.4f} ms (its max_abs_err to the plain version {lib_err:.3e}, "
                    f"limit {lib_limit:.3e}); device µs per call (kernels only) {us_text(dev['kernel'])} vs SDPA "
                    f"{us_text(dev['sdpa'])}, host µs to enqueue {host['kernel']:.2f} vs {host['sdpa']:.2f} ({tag})"
                )
                check(lib_ok, f"SDPA computes another function at level {level}: error {lib_err}")
                result["max_abs_err"] = max(result["max_abs_err"], err)
                result.setdefault("levels", {})[level] = {
                    "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "device_us": dev, "host_us": host,
                    **bound(nbytes_of(q, k, v, mask, got), flops, "bf16"),  # QK^T and PV once each
                }
    # the streamed path: conditioning of ~780 tokens (S = 256 + 780), more
    # keys than the kernel keeps resident in shared memory; bf16, masked
    b, n, s, h, d = 2, 256, 1036, 16, 80
    mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
    mask[1, n + 2 :] = False
    q, k, v = (torch.randn(b, ln, h, d, generator=gen, device="cuda").to(torch.bfloat16) for ln in (n, s, s))
    got, want, again = fused_attention(q, k, v, mask), attention_plain(q, k, v, mask), fused_attention(q, k, v, mask)
    torch.cuda.synchronize()
    err, limit, ok = attention_error(got, want)
    same = torch.equal(got, again)
    ms, plain_ms = alternate(lambda: fused_attention(q, k, v, mask), lambda: attention_plain(q, k, v, mask))
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    add = torch.zeros(b, 1, 1, s, device="cuda", dtype=torch.bfloat16).masked_fill(~mask[:, None, None, :], -1e9)
    call = lambda: fused_attention(q, k, v, mask)  # noqa: E731
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add)  # noqa: E731
    ms_again, library_ms = alternate(call, sdpa)
    dev = {"kernel": device_us(call), "sdpa": device_us(sdpa)}
    print(
        f"[K5] fused_attention streamed q ({b},{n},{h},{d}) k/v ({b},{s},{h},{d}) masked bf16: max_abs_err {err:.3e} "
        f"(limit {limit:.3e}), two runs bitwise equal: {same}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; in turns "
        f"with SDPA: kernel {ms_again:.4f} ms, SDPA {library_ms:.4f} ms; device µs per call {us_text(dev['kernel'])} vs "
        f"SDPA {us_text(dev['sdpa'])} ({tag})"
    )
    check(bool(torch.isfinite(got).all()) and ok, f"K5 streamed max abs error {err} > {limit}")
    check(same, "K5 streamed gave different outputs on two runs")
    result["streamed"] = {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "max_abs_err": err, "device_us": dev}
    result["stage_c"] = k5_stage_c(gen, tag)
    result.update(result["levels"][1])
    return result


def stage_c_attention_inputs(gen, b: int, n: int, s_c: int, h: int, d: int) -> tuple:
    """q, k, v as the three views of one (B, N, 3C) q|k|v product and k2, v2
    as the two of a (B, S_cond, 2C) cond cache entry, as StageC._attend hands
    them to K5; bf16, N(0, 1)."""
    import torch

    c = h * d
    qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda").to(torch.bfloat16)
    kv = torch.randn(b, s_c, 2 * c, generator=gen, device="cuda").to(torch.bfloat16)
    q, k, v = (t.reshape(b, n, h, d) for t in qkv.split(c, dim=-1))
    k2, v2 = (t.reshape(b, s_c, h, d) for t in kv.split(c, dim=-1))
    return q, k, v, k2, v2


def k5_stage_c(gen, tag: str) -> dict:
    """K5 at Stage C's AttnBlock shape (STAGE_C_ATTN), keys and values from
    two sources: the design the policy picks there and at Paella's shapes,
    the wgmma variant against the plain version (error, bitwise repeat, item 0
    alone), the ring forced at the same shape, device µs of both beside the
    bound, the plain version's ms and SDPA's (the yardstick, timed only);
    then both designs forced over K5_SWEEP, the measurement behind the
    policy."""
    import torch
    import torch.nn.functional as F

    from paella_tpu_torch.kernels import attention as k5

    bf16 = torch.bfloat16
    b, n, s_c, h, d = STAGE_C_ATTN
    s = n + s_c
    designs = {"stage_c": k5.attention_design(b, n, s, h, d, bf16), "level1": k5.attention_design(2, 256, 328, 16, 80, bf16),
               "level2": k5.attention_design(2, 64, 136, 16, 80, bf16),
               "streamed": k5.attention_design(2, 256, 1036, 16, 80, bf16)}
    print(f"[K5] design by shape (name, query tiles a block): {json.dumps(designs)} ({tag})")
    check(designs == {"stage_c": ("wgmma", 3), "level1": ("ring", 0), "level2": ("ring", 0), "streamed": ("ring", 0)},
          f"K5's policy picks {designs}")
    q, k, v, k2, v2 = stage_c_attention_inputs(gen, b, n, s_c, h, d)
    call = lambda: k5.fused_attention(q, k, v, k2=k2, v2=v2)  # noqa: E731
    ring = lambda: k5._launch(q, k, v, None, k2, v2, 0)  # noqa: E731
    plain = lambda: k5.attention_plain(q, k, v, None, k2, v2)  # noqa: E731
    got, again, want, by_ring = call(), call(), plain(), ring()
    one = k5.fused_attention(q[:1], k[:1], v[:1], k2=k2[:1], v2=v2[:1])
    torch.cuda.synchronize()
    err, limit, ok = attention_error(got, want)
    ring_err, _, ring_ok = attention_error(by_ring, want)
    same, alone = torch.equal(got, again), torch.equal(one, got[:1])
    print(f"[K5] Stage C q ({b},{n},{h},{d}) k/v ({b},{n}+{s_c},{h},{d}) from two sources bf16: wgmma variant "
          f"max_abs_err {err:.3e} (limit {limit:.3e}), two runs bitwise equal: {same}, item 0 alone equal: {alone}; "
          f"the ring forced: max_abs_err {ring_err:.3e} ({tag})")
    check(bool(torch.isfinite(got).all()) and ok, f"K5 Stage C max abs error {err} > {limit}")
    check(ring_ok, f"K5 ring at Stage C's shape max abs error {ring_err} > {limit}")
    check(same and alone, f"K5 Stage C: repeat equal {same}, item 0 alone equal {alone}")
    ms, plain_ms = alternate(call, plain)
    kt, vt = torch.cat([k, k2], dim=1).transpose(1, 2), torch.cat([v, v2], dim=1).transpose(1, 2)
    qt = q.transpose(1, 2)
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt)  # noqa: E731
    lib_err, _, lib_ok = attention_error(sdpa().transpose(1, 2), want)
    check(lib_ok, f"SDPA computes another function at Stage C's shape: error {lib_err}")
    ms_again, library_ms = alternate(call, sdpa)
    dev = {"kernel": device_us(call), "ring": device_us(ring), "sdpa": device_us(sdpa)}
    flops = 4 * b * h * n * s * d
    bnd = bound(nbytes_of(q, k, v, k2, v2, got), flops, "bf16")
    t_ops, t_bytes = flops / PEAK_OPS_S["bf16"] * 1e6, nbytes_of(q, k, v, k2, v2, got) / HBM_BYTES_S * 1e6
    print(f"[K5] Stage C device µs a call: wgmma variant {us_text(dev['kernel'])}, ring {us_text(dev['ring'])}, SDPA "
          f"{us_text(dev['sdpa'])}; bound {t_ops:.1f} µs by operations ({flops / 1e9:.2f} GFLOP), {t_bytes:.1f} by bytes; "
          f"event ms: kernel {ms:.4f} / {ms_again:.4f}, plain {plain_ms:.4f}, SDPA {library_ms:.4f} ({tag})")
    sweep = {}
    for b_x, h_x in K5_PAIRS:
        for n_x, s_x in K5_SWEEP:
            qx, kx, vx = (torch.randn(b_x, ln, h_x, d, generator=gen, device="cuda").to(bf16) for ln in (n_x, s_x, s_x))
            tiles = -(-n_x // 192)
            runs = {f"wgmma x{z}" if z else "ring": (lambda z=z: k5._launch(qx, kx, vx, None, None, None, z))
                    for z in sorted({0, 1, tiles})}
            want_x = k5.attention_plain(qx, kx, vx)
            errs = {name: attention_error(fn(), want_x) for name, fn in runs.items()}
            check(all(e[2] for e in errs.values()), f"K5 forced designs at N {n_x} S {s_x}: {errs}")
            sweep[f"B{b_x}H{h_x} {n_x}x{s_x}"] = {"policy": k5.attention_design(b_x, n_x, s_x, h_x, d, bf16),
                                                  **{name: device_us(fn) for name, fn in runs.items()}}
    print(f"[K5] both designs forced, D 64 bf16, device µs a call by (B, H, N x S) and design (x: query tiles a block): "
          f"{json.dumps(sweep)} ({tag})")
    return {"ms": ms, "plain_ms": plain_ms, "library_ms": library_ms, "max_abs_err": err, "ring_max_abs_err": ring_err,
            "device_us": dev, "designs": designs, "designs_us": sweep, **bnd}


def kernel_sequence(fn, runs: int = 10) -> list:
    """torch.profiler over `runs` calls of fn() after one warm-up: the
    kernels of one call in launch order, [(short name, device µs averaged
    over the runs)]. Two more calls open the traced window, whose first
    events the trace may drop; the last `runs` calls, which must launch the
    same kernels each, are read."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(5):  # the card's tracer now and then catches nothing: take it again
        if attempt:
            time.sleep(1.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(runs + 2):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
        names = [e.name for e in events]
        per = next((p for p in range(1, len(names) // runs + 1) if names[-p * runs:] == names[-p:] * runs), 0)
        if per:
            break
    else:
        print(f"[profile] torch.profiler traced no repeating kernel sequence in 5 tries ({len(events)} events)",
              flush=True)
        return []
    last = events[-per * runs:]
    seq = []
    for i in range(per):
        name = names[-per + i].replace("(anonymous namespace)::", "").replace("void ", "")
        short = re.sub(r"^.*::", "", re.sub(r"\(.*$", "", name))
        seq.append((short, sum(last[r * per + i].time_range.elapsed_us() for r in range(runs)) / runs))
    return seq


def k6_roles(seq: list) -> list:
    """Each K6 kernel's role in launch order: LN, the products (a split's
    reduce joins its product) and attention: [(role, µs)]. Two products are
    q|k|v and o; trees from before the wgmma design ran three (q, k|v, o)."""
    roles, products = [], [n for n, _ in seq if "linear" in n and "reduce" not in n]
    names = ["q|k|v", "o"] if len(products) == 2 else ["q", "k|v", "o"]
    k = 0
    for name, us in seq:
        if "reduce" in name:
            roles[-1] = (roles[-1][0], roles[-1][1] + us)
        elif "linear" in name:
            roles.append((names[k], us))
            k += 1
        else:
            roles.append(("LN" if "ln_rows" in name else "attention", us))
    return roles


def k6_split(x, kv, w, nhead: int, cmask, tag: str, label: str) -> dict:
    """K6's device µs per sub-kernel (torch.profiler, 10 calls), each
    product's TFLOP/s (q|k|v: the (B*S, 3C) product it runs, the cond rows'
    q included), and torch.matmul of the same bf16 products as a printed
    yardstick."""
    import torch

    from paella_tpu_torch.kernels.attn_block import fused_attn_block

    call = lambda: fused_attn_block(x, kv, w, nhead, cmask)  # noqa: E731
    seq = kernel_sequence(call)
    roles = k6_roles(seq)
    b, hh, ww, c = x.shape
    n, s = hh * ww, hh * ww + kv.shape[1]
    flops = {"q": 2 * b * n * c * c, "k|v": 4 * b * s * c * c, "q|k|v": 6 * b * s * c * c, "o": 2 * b * n * c * c}
    rows = torch.randn(b * s, c, device="cuda").to(x.dtype)
    t = rows[: b * n]
    mm = {"q": cuda_time_ms(lambda: t @ w.wqkv[:c].t()), "k|v": cuda_time_ms(lambda: rows @ w.wqkv[c:].t()),
          "q|k|v": cuda_time_ms(lambda: rows @ w.wqkv.t()), "o": cuda_time_ms(lambda: t @ w.wo.t())}
    dev = sum(us for _, us in roles) if roles else None  # None: not traced (kernel_sequence said so)
    parts = ", ".join(f"{r} {us:.2f}" for r, us in roles) or "not traced"
    rates = ", ".join(f"{r} {flops[r] / us / 1e6:.1f} (matmul {flops[r] / mm[r] / 1e9:.1f})" for r, us in roles if r in flops)
    print(f"[K6] {label} bf16 per sub-kernel, device µs per call in launch order: {parts}; all {us_text(dev)} µs on "
          f"the device; products TFLOP/s (torch.matmul of the same bf16 product): {rates} ({tag})")
    return {"sub_kernels_us": dict(roles), "kernels": seq, "device_us": dev,
            "product_tflops": {r: flops[r] / us / 1e6 for r, us in roles if r in flops},
            "matmul_tflops": {r: flops[r] / mm[r] / 1e9 for r, _ in roles if r in flops}}


def phase_k6(tag: str) -> dict:
    import torch

    from paella_tpu_torch.kernels.attn_block import attn_block_plain, fused_attn_block, prepare_attn_block_weights

    gen = torch.Generator(device="cuda").manual_seed(16)
    result = {"max_abs_err": 0.0}
    cases = [(level, shape) for level, shape in enumerate(ATTN_LEVELS, start=1)]
    cases.append(("ragged", (2, 81, 7, 16, 80)))  # N 81 (9x9) not a multiple of 64, S_cond odd
    for level, (b, n, s_c, h, d) in cases:
        c, side = h * d, int(n**0.5)
        cmask = torch.rand(b, s_c, generator=gen, device="cuda") < 0.7
        if level != "ragged":
            cmask, _ = attention_masks(b, n, s_c, gen)
        cmask[:, 0] = True
        for dtype in (torch.float32, torch.bfloat16):
            r = lambda *shape, std: torch.randn(*shape, generator=gen, device="cuda") * std  # noqa: E731
            w = prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05),
                                           dtype, h)
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
            name = f"level {level}" if level != "ragged" else "ragged"
            print(
                f"[K6] fused_attn_block {name} x ({b},{side},{side},{c}) kv ({b},{s_c},{c}) {h} heads masked {dname}: "
                f"max_abs_err {err:.3e} (limit {limit:.3e}), two runs bitwise equal: {same}; "
                f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; M_q {m_q}, M_kv {m_kv}, {flops / 1e9:.3f} GFLOP "
                f"= {flops / ms / 1e9:.2f} TFLOP/s ({tag})"
            )
            check(err <= limit, f"K6 {name} {dname} max abs error {err} > {limit}")
            check(same, f"K6 {name} {dname} gave different outputs on two runs")
            if dtype == torch.bfloat16 and level != "ragged":
                result["max_abs_err"] = max(result["max_abs_err"], err)
                weights = [t for t in w if isinstance(t, torch.Tensor)]
                split = k6_split(x, kv, w, h, cmask, tag, name)
                result.setdefault("levels", {})[level] = {
                    "ms": ms, "plain_ms": plain_ms, "library_ms": None, "device_us": split["device_us"],
                    "sub_kernels_us": split["sub_kernels_us"], "product_tflops": split["product_tflops"],
                    "matmul_tflops": split["matmul_tflops"],
                    **bound(nbytes_of(x, kv, cmask, got, *weights), flops, "bf16"),
                }
    result.update(result["levels"][1])
    result["device_ms"] = ms_of(result["levels"][1]["device_us"])
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
    print(f"[attn e2e] launches in one {STEPS}-step CFG generation (its graph's warm-up and capture): "
          f"{json.dumps(launches)}")
    check_launches("attention-config generation", launches, {
        "fused_resblock": GRAPH_PASSES * K1_PER_FORWARD * STEPS, "gumbel_categorical": GRAPH_PASSES * STEPS,
        "fused_head_categorical": 0, "fused_attention": GRAPH_PASSES * K5_PER_FORWARD * STEPS,
        "fused_attn_block": GRAPH_PASSES * K6_PER_FORWARD * STEPS,
    })
    check_replay("attn e2e", replay_launches(lambda: sample(model, seeds_for(43), cond, LATENT, uncond, s_cfg)),
                 {"K1": K1_PER_FORWARD * STEPS, "K3": STEPS, "K5": K5_PER_FORWARD * STEPS,
                  "K6": K6_PER_FORWARD * STEPS}, tag)
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
    result = {"launches": launches, "p50_ms": p50, "feature_rel_l2": err, "feature_plain_rel_l2": floor, "profile": {}}
    for name, m in (("plain", plain), ("attention", model)):  # where the time goes, one profiled warm run each
        kernels, wall = profile_kernels(lambda: generate(m, 77))
        groups = group_kernels(kernels, GENERATION_GROUPS)
        busy = sum(us for us, _ in groups.values()) / 1e3
        parts = ", ".join(f"{k} {us / 1e3:.2f} ms ({n:g})" for k, (us, n) in groups.items() if n)
        print(
            f"[attn e2e] profile of one {STEPS}-step generation, {name} attention: {parts}; all kernels {busy:.2f} ms "
            f"of {wall:.2f} ms wall = {busy / wall:.0%} busy ({tag})"
        )
        result["profile"][name] = {"groups_ms": {k: v[0] / 1e3 for k, v in groups.items()}, "kernels_ms": busy,
                                   "wall_ms": wall}
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

    def req(i, hw=(256, 256)):
        return {"prompt": prompts[i], "seed": seeds[i], "steps": STEPS, "height": hw[0], "width": hw[1]}

    def pipeline_image(i, hw=(256, 256)):
        img = pipe.text_to_image([prompts[i]], request_seeds([seeds[i]]), hw, SampleConfig(steps=STEPS, cfg=8.0))
        return serve_uint8(img[0]).cpu().numpy()

    srv = PaellaServer(pipe, host="127.0.0.1", port=0)
    srv.start()
    try:
        check(http_get(f"http://127.0.0.1:{srv.port}/healthz") == b"ok", "/healthz")
        http_generate(srv.port, req(0))  # warm-up
        png0, launches = counted(lambda: http_generate(srv.port, req(0)))
        print(f"[serve] launches in one {STEPS}-step request (its graph's warm-up and capture): {json.dumps(launches)}")
        check_launches("served request", launches, {
            "fused_resblock": GRAPH_PASSES * K1_PER_FORWARD * STEPS, "gumbel_categorical": GRAPH_PASSES * STEPS,
            "fused_attention": GRAPH_PASSES * K5_PER_FORWARD * STEPS,
            "fused_attn_block": GRAPH_PASSES * K6_PER_FORWARD * STEPS,
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

    # 256x384: level 2 holds hw 96 pixels, which K1's 128-row fc1 tiles do not
    # divide, so an image's GRN sums need the per-image tiles to stay
    # batch-invariant there
    wide = (256, 384)
    singles_wide = [pipeline_image(i, wide) for i in range(3)]
    batched = PaellaServer(pipe, host="127.0.0.1", port=0, max_batch=4, batch_window_ms=200)
    batched.start()
    try:
        with ThreadPoolExecutor(3) as pool:
            pngs = list(pool.map(lambda i: http_generate(batched.port, req(i)), range(3)))
        with ThreadPoolExecutor(3) as pool:
            pngs_wide = list(pool.map(lambda i: http_generate(batched.port, req(i, wide)), range(3)))
    finally:
        batched.stop()
    shares = {}
    for name, got, want in (("256x256", pngs, singles), ("256x384", pngs_wide, singles_wide)):
        same = [float((png_pixels(p) == w).mean()) for p, w in zip(got, want)]
        check(all(png_pixels(p).shape == w.shape for p, w in zip(got, want)), f"{name} PNG shapes")
        exact = all(v == 1.0 for v in same)
        shares[name] = same
        print(
            f"[serve] max_batch=4, 3 concurrent {name} requests (one batch of 4): share of pixels equal to the single "
            f"path {', '.join(f'{v:.6f}' for v in same)} (limit 0.99; {'exact' if exact else 'not exact'}) ({tag})"
        )
        check(min(same) >= 0.99, f"micro-batched {name} images agree {min(same)} < 0.99 with the single path")
    del pipe, model, vq
    torch.cuda.empty_cache()
    return {"launches": launches, "http_p50_ms": http_p50, "batch_pixel_share": shares["256x256"],
            "batch_pixel_share_256x384": shares["256x384"], "batch_exact": all(v == 1.0 for v in sum(shares.values(), []))}


def synthetic_merges() -> list:
    """A merge table of 5408 merges over lowercase letters (letter pairs,
    word-final pairs, word-final triples), standing in for the
    bpe_simple_vocab_16e6 table, which is not in the repository."""
    letters = "abcdefghijklmnopqrstuvwxyz"
    merges = [(a, b) for a in letters for b in letters]
    merges += [(a, b + "</w>") for a in letters for b in letters]
    merges += [(a + b, c + "</w>") for a in letters for b in letters for c in "aeiost"]
    return merges


def save_bf16(path: str, modules: dict, extra: dict | None = None) -> int:
    """Modules' state dicts in bf16 (integer buffers as they are), each key
    under its module's prefix in `modules` ({prefix: module}), and `extra`
    as it is, to one torch file; returns its bytes."""
    import torch

    sd = {prefix + k: (v.to(torch.bfloat16) if v.is_floating_point() else v).cpu()
          for prefix, module in modules.items() for k, v in module.state_dict().items()}
    sd.update(extra or {})
    torch.save(sd, path)
    return os.path.getsize(path)


def write_entry_checkpoints(d: str, gen) -> dict:
    """Seeded full-width checkpoint files in the layouts the loaders read:
    the flagship denoiser (reference layout), VQConfig()'s codec, the
    ByT5-XL encoder (HF T5EncoderModel layout), open_clip ViT-H-14 (both
    towers and logit_scale) and a synthetic merge table. Built on the card one
    at a time and written in bf16."""
    import torch

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.cond import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder, T5Config, T5Encoder
    from paella_tpu_torch.cond.tokenizers import write_merges_file
    from paella_tpu_torch.config import PaellaConfig, VQConfig
    from paella_tpu_torch.models import Paella

    paths = {k: os.path.join(d, f) for k, f in (("denoiser", "denoiser.pt"), ("vqgan", "vqgan.pt"), ("byt5", "byt5.pt"),
                                                  ("clip", "clip.pt"), ("bpe", "merges.txt"))}
    sizes = {}
    with torch.device("cuda"):
        model = Paella(PaellaConfig.v1_byt5_xl_inference())
    model.reset_parameters(gen)
    perturb_(model, gen)
    sizes["denoiser"] = save_bf16(paths["denoiser"], {"": model})
    del model
    with torch.device("cuda"):
        vq = VQModel(VQConfig())
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    sizes["vqgan"] = save_bf16(paths["vqgan"], {"": vq})
    del vq
    with torch.device("cuda"):
        t5 = T5Encoder(T5Config.byt5_xl())
    t5.reset_parameters(gen)
    sizes["byt5"] = save_bf16(paths["byt5"], {"": t5})
    del t5
    with torch.device("cuda"):
        text, vision = CLIPTextEncoder(CLIPTextConfig.vit_h_14()), CLIPVisionEncoder(CLIPVisionConfig.vit_h_14())
    text.reset_parameters(gen)
    vision.reset_parameters(gen)
    sizes["clip"] = save_bf16(paths["clip"], {"": text, "visual.": vision}, {"logit_scale": torch.tensor(4.6052)})
    del text, vision
    write_merges_file(synthetic_merges(), paths["bpe"])
    torch.cuda.empty_cache()
    return {"paths": paths, "bytes": sizes}


@contextlib.contextmanager
def tf32_on():
    """cuDNN's and cuBLAS's TF32 switched on (a caller that never turned it
    off, or set it on), the script's own settings (off) after."""
    import torch

    mine = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = mine


@contextlib.contextmanager
def unpinned():
    """The f32 codec and Inception forwards as they were before fault C5's
    repair: exact_f32 replaced by a no-op where they call it, so the
    caller's TF32 flags decide their rounding."""
    from paella_tpu_torch.codec import vqgan
    from paella_tpu_torch.eval import inception

    saved = vqgan.exact_f32, inception.exact_f32
    vqgan.exact_f32 = inception.exact_f32 = lambda dtype: contextlib.nullcontext()
    try:
        yield
    finally:
        vqgan.exact_f32, inception.exact_f32 = saved


def phase_c5(tag: str) -> dict:
    """Fault C5 measured: with TF32 on in the caller, an f32 VQConfig()
    decode's uint8 pixels (seeded weights, 2 x 64 x 64 tokens) and the
    Inception pool3 features of 32 images at 299x299, each on the card
    against the same weights on the CPU, before the repair (unpinned) and
    after it; after it, the card's output under TF32 on equals its output
    in two runs under TF32 off, bit for bit."""
    import torch

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import VQConfig
    from paella_tpu_torch.eval import convert_inception, inception_features
    from paella_tpu_torch.eval.inception import INCEPTION_SHAPES, conv_weight_shape

    gen = torch.Generator().manual_seed(40)
    vq_cpu = VQModel(VQConfig())
    vq_cpu.reset_parameters(gen)
    perturb_(vq_cpu, gen, scale=0.05)
    vq_dev = VQModel(VQConfig()).cuda()
    vq_dev.load_state_dict(vq_cpu.state_dict())
    idx = torch.randint(0, 8192, (2, 64, 64), generator=gen)
    sd = {}
    for block, units in INCEPTION_SHAPES.items():
        for unit, shape in units.items():
            p = block if unit is None else f"{block}.{unit}"
            w = conv_weight_shape(*shape)
            sd[f"{p}.conv.weight"] = torch.randn(w, generator=gen) * (2.0 / (w[1] * w[2] * w[3])) ** 0.5
            c = w[0]
            sd[f"{p}.bn.weight"] = 1 + 0.1 * torch.randn(c, generator=gen)
            sd[f"{p}.bn.bias"] = 0.05 * torch.randn(c, generator=gen)
            sd[f"{p}.bn.running_mean"] = 0.05 * torch.randn(c, generator=gen)
            sd[f"{p}.bn.running_var"] = 1 + 0.3 * torch.rand(c, generator=gen)
    inc_cpu = inception_features(convert_inception(sd))
    inc_dev = inception_features(convert_inception({k: v.cuda() for k, v in sd.items()}))
    images = torch.rand(32, 299, 299, 3, generator=gen)
    want_px = to_uint8(vq_cpu.decode_indices(idx))
    want_f = inc_cpu(images)

    def run():
        return to_uint8(vq_dev.decode_indices(idx.cuda())).cpu(), inc_dev(images.cuda()).cpu()

    with tf32_on():
        with unpinned():
            before = run()
        after = run()
    off, again = run(), run()
    result = {}
    for name, (px, f) in (("before", before), ("after", after)):
        diff = (px.int() - want_px.int()).abs()
        ferr = (f - want_f).abs().max().item()
        result[name] = {"pixels_differ": float((diff > 0).float().mean()), "pixel_max_levels": int(diff.max()),
                        "pool3_max_abs_err": ferr, "pool3_rel_err": ferr / want_f.abs().max().item()}
    same = all(torch.equal(a, b) and torch.equal(a, c) for a, b, c in zip(after, off, again))
    for name, r in result.items():
        print(f"[c5] {name} the repair, TF32 on in the caller, card vs CPU: f32 VQConfig() decode (2x256x256x3 uint8) "
              f"{r['pixels_differ']:.6f} of pixel values differ, by up to {r['pixel_max_levels']} levels; Inception "
              f"pool3 (32x2048) max abs error {r['pool3_max_abs_err']:.3e} ({r['pool3_rel_err']:.3e} of the largest "
              f"feature) ({tag})")
    print(f"[c5] after the repair the card's decode and features under TF32 on equal those of two runs under TF32 "
          f"off bit for bit: {same} ({tag})")
    check(same, "C5: the f32 codec decode or the Inception features still depend on the caller's TF32 flags")
    check(result["after"]["pool3_rel_err"] <= 5e-3, f"C5: Inception card vs CPU {result['after']['pool3_rel_err']}")
    del vq_cpu, vq_dev, inc_dev
    torch.cuda.empty_cache()
    return result


def p50_ms(fn, runs: int = 7) -> tuple[float, float, float]:
    """(p50, min, max) host ms of fn() ending in a synchronize, after one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[runs // 2], min(times), max(times)


def clip_towers_against_cpu(tag: str) -> dict:
    """The ViT-H-14 widths at depth 2, seeded: bf16 towers on the card
    against the same weights' f32 towers on the CPU (plain torch both)."""
    import torch

    from paella_tpu_torch.cond import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder
    from paella_tpu_torch.cond.clip import clip_preprocess

    gen = torch.Generator().manual_seed(31)
    out = {}
    for name, cfg_cls, enc_cls in (("text", CLIPTextConfig, CLIPTextEncoder), ("image", CLIPVisionConfig, CLIPVisionEncoder)):
        cfg = dataclasses.replace(cfg_cls.vit_h_14(), layers=2)
        cpu = enc_cls(dataclasses.replace(cfg, dtype="float32"))
        cpu.reset_parameters(gen)
        with torch.device("cuda"):
            dev = enc_cls(cfg)
        dev.load_state_dict(cpu.state_dict())
        dev.cast_products()
        out[name] = (cpu.eval(), dev.eval())
    # two token rows as the tokenizer lays them out: SOT, ids, EOT (the
    # highest id), zeros
    tokens = torch.zeros(2, 77, dtype=torch.long)
    for row, n in enumerate((8, 40)):
        tokens[row, 0], tokens[row, n + 1] = 49406, 49407
        tokens[row, 1 : n + 1] = torch.randint(0, 49406, (n,), generator=gen)
    images = torch.rand(2, 256, 256, 3, generator=gen)
    feats = {
        "text": (out["text"][0](tokens), out["text"][1](tokens.cuda())),
        "image": (out["image"][0](clip_preprocess(images)), out["image"][1](clip_preprocess(images.cuda()))),
    }
    result = {}
    for name, (want, got) in feats.items():
        cos = torch.nn.functional.cosine_similarity(got.float().cpu(), want, dim=-1).tolist()
        result[name] = cos
        print(f"[entry] CLIP ViT-H-14 {name} tower at depth 2, bf16 on the card against f32 on the CPU: cosine "
              f"{', '.join(f'{c:.6f}' for c in cos)} (limit 0.999) ({tag})")
        check(got.dtype == torch.bfloat16 and tuple(got.shape) == (2, 1024), f"{name} features {got.dtype} {tuple(got.shape)}")
        check(min(cos) >= 0.999, f"CLIP {name} tower card vs CPU cosine {min(cos)} < 0.999")
    return result


def phase_entry(tag: str) -> dict:
    """The serving entry point with real towers: seeded full-width checkpoint
    files, serve.build_pipeline on the card from them (CLIP-conditioned
    text_to_image with its launch counts, best-of-N reranked by the CLIP
    towers, the towers' encode p50s), the depth-2 towers against the CPU,
    the Inception featurizer, and `python -m paella_tpu_torch.serve` on the
    same files answering a request with the pipeline's image."""
    import shutil
    import tempfile

    import torch

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.eval import convert_inception, inception_features
    from paella_tpu_torch.eval.inception import INCEPTION_SHAPES, conv_weight_shape
    from paella_tpu_torch.serve import build_pipeline, png_pixels, request_seeds
    from paella_tpu_torch.serve import to_uint8 as serve_uint8

    result = {}
    result["clip_cosine"] = clip_towers_against_cpu(tag)
    d = tempfile.mkdtemp(prefix="paella_entry_")
    proc = log = None
    try:
        t0 = time.perf_counter()
        files = write_entry_checkpoints(d, torch.Generator(device="cuda").manual_seed(30))
        write_s = time.perf_counter() - t0
        paths, sizes = files["paths"], files["bytes"]
        print(f"[entry] seeded full-width checkpoints written in bf16: {json.dumps(sizes)} bytes, "
              f"{sum(sizes.values()) / 1e9:.2f} GB in {write_s:.1f} s")
        t0 = time.perf_counter()
        pipe = build_pipeline(paths["denoiser"], paths["vqgan"], paths["byt5"], clip_path=paths["clip"],
                              clip_bpe_path=paths["bpe"], device="cuda")
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t0
        print(f"[entry] build_pipeline on the card from the files (denoiser, VQConfig() codec, ByT5-XL, CLIP ViT-H-14 "
              f"towers, the merge table) in {load_s:.1f} s; device memory {torch.cuda.memory_allocated() / 2**30:.1f} GiB")
        result.update(bytes=sizes, write_s=write_s, load_s=load_s)

        prompt, seed, hw = "a red car on a beach", 17, (256, 256)
        s_cfg = SampleConfig(steps=STEPS, cfg=8.0)
        image, launches = counted(lambda: pipe.text_to_image([prompt], request_seeds([seed]), hw, s_cfg))
        print(f"[entry] text_to_image with CLIP conditioning ({STEPS} steps, CFG, 256x256): launches {json.dumps(launches)}")
        check_launches("entry text_to_image", launches, {
            "fused_resblock[float]": GRAPH_PASSES * K1_PER_FORWARD * STEPS, "gumbel_categorical": GRAPH_PASSES * STEPS,
            "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0, "fused_codebook_lookup": 0,
        })
        ok = tuple(image.shape) == (1, 256, 256, 3) and bool(torch.isfinite(image).all()) and 0.0 <= image.min().item() <= image.max().item() <= 1.0
        check(ok, f"entry text_to_image: image {tuple(image.shape)}, finite and in [0, 1]")
        clip_feats = pipe.clip_text_fn([prompt])
        check(tuple(clip_feats.shape) == (1, 1024) and bool(torch.isfinite(clip_feats.float()).all()), "CLIP text features")
        result["launches"] = launches

        best, scores = pipe.text_to_image_best_of([prompt], request_seeds([21, 22]), 2, hw, s_cfg, return_scores=True)
        check(tuple(best.shape) == (1, 256, 256, 3) and tuple(scores.shape) == (1, 2), "best-of-2 shapes")
        check(bool(torch.isfinite(scores).all()) and bool(((scores >= 0) & (scores <= 100)).all()), f"best-of-2 scores {scores.tolist()}")
        print(f"[entry] text_to_image_best_of n=2 reranked by the CLIP towers: scores {scores.tolist()[0]}, image "
              f"{tuple(best.shape)}")

        prompts2 = [prompt, "a lighthouse in a storm, oil on canvas"]
        text_p50 = p50_ms(lambda: pipe.clip_text_fn(prompts2))
        images = {b: torch.rand(b, 256, 256, 3, device="cuda") for b in (1, 8)}
        image_p50 = {b: p50_ms(lambda b=b: pipe.clip_image_fn(images[b])) for b in (1, 8)}
        gen_p50 = p50_ms(lambda: pipe.text_to_image([prompt], request_seeds([seed + 1]), hw, s_cfg), runs=5)
        print(f"[entry] full-depth CLIP ViT-H-14, bf16: text encode (tokenize + tower) batch 2 x 77 tokens p50 "
              f"{text_p50[0]:.2f} ms (min {text_p50[1]:.2f}, max {text_p50[2]:.2f}); image encode (clip_preprocess "
              f"256 -> 224 + tower) p50 batch 1 {image_p50[1][0]:.2f} ms (min {image_p50[1][1]:.2f}), batch 8 "
              f"{image_p50[8][0]:.2f} ms (min {image_p50[8][1]:.2f}); text_to_image with ByT5-XL and CLIP text, "
              f"{STEPS} steps CFG, p50 {gen_p50[0]:.2f} ms (min {gen_p50[1]:.2f}, max {gen_p50[2]:.2f}) ({tag})")
        result.update(clip_text_p50_ms=text_p50[0], clip_image_p50_ms={b: v[0] for b, v in image_p50.items()},
                      text_to_image_p50_ms=gen_p50[0])

        # the same files through the command line, in a process of its own
        port = free_port()
        cmd = [sys.executable, "-m", "paella_tpu_torch.serve", "--denoiser", paths["denoiser"], "--vqgan", paths["vqgan"],
               "--byt5", paths["byt5"], "--clip", paths["clip"], "--clip-bpe", paths["bpe"], "--host", "127.0.0.1",
               "--port", str(port)]
        log = open(os.path.join(d, "serve.log"), "w+")
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
        while True:
            if proc.poll() is not None:
                raise CheckFailed(f"the server exited with {proc.returncode}: {tail_of(log)}")
            if time.perf_counter() - t0 > 600:
                raise CheckFailed(f"the server did not answer /healthz in 600 s: {tail_of(log)}")
            try:
                check(http_get(f"http://127.0.0.1:{port}/healthz") == b"ok", "/healthz")
                break
            except OSError:
                time.sleep(0.5)
        up_s = time.perf_counter() - t0
        req = {"prompt": prompt, "seed": seed, "steps": STEPS, "height": hw[0], "width": hw[1]}
        times, pngs = [], []
        for _ in range(3):
            t1 = time.perf_counter()
            pngs.append(http_generate(port, req))
            times.append((time.perf_counter() - t1) * 1e3)
        # the script runs with TF32 off; the served process with torch's
        # defaults (cuDNN TF32 on): the f32 decode pins IEEE either way (C5)
        want = serve_uint8(pipe.text_to_image([prompt], request_seeds([seed]), hw, s_cfg)[0]).cpu().numpy()
        got = png_pixels(pngs[0])
        share = float((got == want).mean()) if got.shape == want.shape else 0.0
        http_p50 = sorted(times)[1]
        print(f"[entry] python -m paella_tpu_torch.serve on the same files: /healthz after {up_s:.1f} s (load and "
              f"warm-up); its PNG against build_pipeline's image for the same prompt and seed: pixel share {share:.6f} "
              f"(want 1.0); repeats byte-identical: {pngs[1] == pngs[0] == pngs[2]}; HTTP p50 {http_p50:.2f} ms "
              f"(min {min(times):.2f}, max {max(times):.2f}) with ByT5-XL and CLIP ViT-H-14 ({tag})")
        check(share == 1.0, f"the served PNG differs from build_pipeline's image: pixel share {share}")
        check(pngs[1] == pngs[0] == pngs[2], "repeated requests gave other bytes")
        result.update(serve_up_s=up_s, http_p50_ms=http_p50, served_pixel_share=share)
        del pipe, clip_feats, images
        torch.cuda.empty_cache()
    finally:
        if proc is not None:
            proc.terminate()
            try:
                proc.wait(timeout=60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        if log is not None:
            log.close()
        shutil.rmtree(d, ignore_errors=True)

    # the Inception featurizer (seeded weights), batch 32 at 299x299, f32
    gen = torch.Generator(device="cuda").manual_seed(33)
    sd = {}
    for block, units in INCEPTION_SHAPES.items():
        for unit, shape in units.items():
            p = block if unit is None else f"{block}.{unit}"
            w = conv_weight_shape(*shape)
            sd[f"{p}.conv.weight"] = torch.randn(w, generator=gen, device="cuda") * (2.0 / (w[1] * w[2] * w[3])) ** 0.5
            c = w[0]
            sd[f"{p}.bn.weight"] = 1 + 0.1 * torch.randn(c, generator=gen, device="cuda")
            sd[f"{p}.bn.bias"] = 0.05 * torch.randn(c, generator=gen, device="cuda")
            sd[f"{p}.bn.running_mean"] = 0.05 * torch.randn(c, generator=gen, device="cuda")
            sd[f"{p}.bn.running_var"] = 1 + 0.3 * torch.rand(c, generator=gen, device="cuda")
    extract = inception_features(convert_inception(sd))
    small = torch.rand(2, 128, 128, 3, generator=gen, device="cuda")
    want = inception_features(convert_inception({k: v.cpu() for k, v in sd.items()}))(small.cpu())
    got = extract(small)
    err = float((got.cpu() - want).abs().max())
    check(tuple(got.shape) == (2, 2048) and err <= 5e-3 * max(1.0, float(want.abs().max())),
          f"Inception pool3 card vs CPU: max abs error {err}")
    batch = torch.rand(32, 299, 299, 3, device="cuda")
    inc = p50_ms(lambda: extract(batch), runs=5)
    print(f"[entry] Inception pool3 ('fid' variant, seeded weights) card vs CPU at (2,128,128,3): max abs error "
          f"{err:.2e}; batch 32 at 299x299, f32 (TF32 off): p50 {inc[0]:.2f} ms (min {inc[1]:.2f}, max {inc[2]:.2f}), "
          f"{32e3 / inc[0]:.1f} images/s ({tag})")
    result.update(inception_ms=inc[0], inception_images_per_s=32e3 / inc[0], inception_max_abs_err=err)
    return result


TRAIN_BATCH, TRAIN_HW, TRAIN_WARMUP, TRAIN_TIMED = 8, 256, 2, 5
# a training step's kernels by kind (plain torch but for K4)
TRAIN_GROUPS = [
    ("K4", ("lookup_kernel",)),
    ("GEMMs", ("gemm", "cutlass", "xmma", "cublas", "Kernel2", "sm90_", "nvjet")),
    ("cuDNN conv", ("conv", "cudnn", "implicit")),
    ("reductions", ("reduce", "norm", "softmax")),
    ("elementwise", ("elementwise", "vectorized", "Memcpy", "Memset", "copy")),
]
TRAIN_BYT5_LEN = 77


def train_inputs(p_cfg, b: int, hw: int, gen, device):
    """A seeded training batch (images in [0, 1], ByT5 states with masks of
    seeded lengths, CLIP text and image embeddings) and a seeded NullCond."""
    import torch

    from paella_tpu_torch.train import Batch, NullCond

    def r(*shape):
        return torch.randn(*shape, generator=gen, device=device)

    lengths = torch.randint(1, TRAIN_BYT5_LEN + 1, (b, 1), generator=gen, device=device)
    batch = Batch(torch.rand(b, hw, hw, 3, generator=gen, device=device), r(b, TRAIN_BYT5_LEN, p_cfg.byt5_embd),
                  torch.arange(TRAIN_BYT5_LEN, device=device)[None, :] < lengths, r(b, p_cfg.clip_embd),
                  r(b, p_cfg.clip_embd))
    null = NullCond(r(1, 2, p_cfg.byt5_embd), torch.ones(1, 2, dtype=torch.bool, device=device), r(1, p_cfg.clip_embd))
    return batch, null


def tiny_train_against_cpu(tag: str) -> dict:
    """Two train steps of PaellaConfig.tiny() with VQConfig.tiny() (f32,
    TrainConfig(warmup_updates=1), batch 2 at 64x64) on the card and on the
    CPU from the same weights and the same pinned draws: the frozen encodes
    equal, loss within 1e-4 and grad_norm within 1e-3 relative at both
    steps, and after step 2 (the first with lr > 0) every parameter within
    2.1 lr of the CPU's and 99% of them within 0.05 lr (Adam divides each
    gradient by its own size, so a small gradient's rounding moves its
    update the most)."""
    import torch

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
    agree = (vq_dev.encode(batch.images.cuda())[2].cpu() == latents).float().mean().item()
    check(agree == 1.0, f"tiny train step: the frozen encodes agree on {agree} of the tokens, card vs CPU")
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
    d = torch.cat([((p_dev[k] - v).abs() / cfg.lr).reshape(-1) for k, v in p_cpu.items()])
    p99, worst = torch.quantile(d, 0.99).item(), d.max().item()
    print(f"[train] PaellaConfig.tiny() + VQConfig.tiny() f32, 2 steps, card vs CPU on the same pinned draws: frozen "
          f"encodes equal; loss {[round(a[0], 6) for a in m_dev]} vs {[round(a[0], 6) for a in m_cpu]} (rel err "
          f"{loss_err:.2e}, limit 1e-4), grad_norm rel err {norm_err:.2e} (limit 1e-3); parameters after step 2: "
          f"99th percentile {p99:.2e} lr (limit 0.05), max {worst:.2e} lr (limit 2.1) ({tag})")
    check(loss_err <= 1e-4 and norm_err <= 1e-3, f"tiny train step card vs CPU: loss {loss_err}, grad norm {norm_err}")
    check(p99 <= 0.05 and worst <= 2.1, f"tiny train step card vs CPU: parameters {p99} / {worst} lr apart")
    return {"loss_rel_err": loss_err, "grad_norm_rel_err": norm_err, "param_p99_lr": p99, "param_max_lr": worst}


def phase_train(tag: str) -> dict:
    """The training step at the JAX package's "1b" training configuration
    (scripts/run_driver_e2e.py: PaellaConfig.v1_byt5_xl() in bf16 with
    remat, dropout 0.1 at every level; the frozen VQConfig() codec in bf16),
    full width and depth, seeded f32 parameters, TrainConfig(warmup_updates=1),
    batch 8 at 256x256: two warm-up steps and five timed ones (median step ms,
    images/s, peak memory, loss, K4 launched once per microbatch), the
    parameters unmoved by the first update (lr 0) and moved by the second,
    one step at grad_accum_steps=2, K4 on that step's latents against its
    plain version, a step's FLOPs (torch.utils.flop_counter) and the MFU they
    give at the bf16 peak, then the tiny step card vs CPU."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, TrainConfig, VQConfig
    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.train import create_train_state, make_train_step

    gen = torch.Generator(device="cuda").manual_seed(45)
    p_cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl(), dtype="bfloat16", remat=True)
    check(p_cfg.dropout == (0.1, 0.1, 0.1), f"dropout {p_cfg.dropout}")
    t0 = time.perf_counter()
    with torch.device("cuda"):
        model = Paella(p_cfg)
        vq = VQModel(dataclasses.replace(VQConfig(), dtype="bfloat16"))
    model.reset_parameters(gen)
    perturb_(model, gen)
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    n_params = sum(p.numel() for p in model.parameters())
    cfg = TrainConfig(warmup_updates=1)
    state = create_train_state(model, cfg, torch.Generator(device="cuda").manual_seed(46))
    step = make_train_step(model, vq, cfg)
    batch, null = train_inputs(p_cfg, TRAIN_BATCH, TRAIN_HW, gen, "cuda")
    torch.cuda.synchronize()
    print(f"[train] '1b' config (v1_byt5_xl, bf16 compute, remat, dropout 0.1; {n_params / 1e9:.3f} B f32 parameters) "
          f"and the frozen bf16 VQConfig() codec built on the card in {time.perf_counter() - t0:.1f} s")

    def timed(fn):
        t1 = time.perf_counter()
        out, launches = counted(fn)
        return out, launches, (time.perf_counter() - t1) * 1e3

    torch.cuda.reset_peak_memory_stats()
    before = [p.detach().clone() for p in model.parameters()]
    metrics, times, k4 = [], [], 0
    for i in range(TRAIN_WARMUP + TRAIN_TIMED):
        m, launches, ms = timed(lambda: step(state, batch, null))
        metrics.append({k: float(v) for k, v in m.items()})
        check_launches(f"train step {i + 1}", launches, {
            "fused_codebook_lookup": 1, "fused_resblock": 0, "fused_head_categorical": 0, "gumbel_categorical": 0,
            "fused_attention": 0, "fused_attn_block": 0,
        })
        k4 += launches["fused_codebook_lookup"]
        if i == 0:
            check(all(torch.equal(p.detach(), q) for p, q in zip(model.parameters(), before)),
                  "the first update (lr 0) moved parameters")
        if i == 1:
            moved = sum(not torch.equal(p.detach(), q) for p, q in zip(model.parameters(), before))
            check(moved >= 0.9 * len(before), f"the second update moved {moved} of {len(before)} parameter tensors")
            del before
        if i >= TRAIN_WARMUP:
            times.append(ms)
    peak = torch.cuda.max_memory_allocated()
    for i, m in enumerate(metrics):
        check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]), f"train step {i + 1}: {m}")
        check(m["nonfinite_skips"] == 0, f"train step {i + 1} skipped an update")
    med = sorted(times)[len(times) // 2]
    print(f"[train] batch {TRAIN_BATCH} at {TRAIN_HW}x{TRAIN_HW}: median step {med:.1f} ms of {TRAIN_TIMED} "
          f"(min {min(times):.1f}, max {max(times):.1f}), {TRAIN_BATCH * 1e3 / med:.2f} images/s; peak memory "
          f"{peak / 2**30:.2f} GiB; loss first {metrics[0]['loss']:.4f}, last {metrics[-1]['loss']:.4f}; grad_norm "
          f"{metrics[0]['grad_norm']:.3f} .. {metrics[-1]['grad_norm']:.3f}; first update moved nothing (lr 0), the "
          f"second moved the parameters; K4 launched {k4} times in {len(metrics)} steps ({tag})")

    kernels, wall = profile_kernels(lambda: step(state, batch, null))
    groups = group_kernels(kernels, TRAIN_GROUPS)
    busy = sum(us for us, _ in groups.values()) / 1e3
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:8]
    print(f"[train] profile of one step (torch.profiler): "
          f"{'; '.join(f'{k} {v[0] / 1e3:.1f} ms ({v[1]:.0f})' for k, v in groups.items())}; all kernels {busy:.1f} ms "
          f"of {wall:.1f} ms wall = {busy / wall:.0%} busy, {sum(n for _, n in kernels.values()):.0f} launches; the "
          f"largest: {'; '.join(f'{k[:100]} {us / 1e3:.1f} ms ({n:.0f})' for k, (us, n) in top)} ({tag})")

    accum = make_train_step(model, vq, dataclasses.replace(cfg, grad_accum_steps=2))
    accum_ms = []
    for _ in range(2):  # the first at the microbatch shapes is cold (allocator, GEMM heuristics)
        m, launches, ms = timed(lambda: accum(state, batch, null))
        check_launches("train step at grad_accum_steps=2", launches, {"fused_codebook_lookup": 2, "fused_resblock": 0})
        check(math.isfinite(float(m["loss"])) and math.isfinite(float(m["grad_norm"])), f"accumulated step {m}")
        k4 += launches["fused_codebook_lookup"]
        accum_ms.append(ms)

    z = vq.encoder(batch.images)
    cb = vq.vquantizer.codebook.weight.detach().float().contiguous()
    got, want = fused_codebook_lookup(z.contiguous(), cb), codebook_lookup_plain(z.contiguous(), cb)
    agree = (got == want).float().mean().item()
    print(f"[train] grad_accum_steps=2 (2 microbatches of {TRAIN_BATCH // 2}): one update in {accum_ms[0]:.1f} ms "
          f"(cold), then {accum_ms[1]:.1f} ms, loss {float(m['loss']):.4f}, K4 launched "
          f"{launches['fused_codebook_lookup']} times a step; K4 on that step's latents "
          f"z {tuple(z.shape)} against its plain version: indices agree {agree:.6f} (want 1.0) ({tag})")
    check(agree == 1.0, f"K4 on the training batch's latents agrees {agree} with its plain version")

    with FlopCounterMode(display=False) as flops:
        step(state, batch, null)
    total = flops.get_total_flops()
    mfu = total / (med * 1e-3) / PEAK_OPS_S["bf16"]
    print(f"[train] one step's FLOPs (torch.utils.flop_counter: products and convolutions, forward, remat "
          f"recompute and backward) {total / 1e12:.2f} T; at the median step time {total / (med * 1e-3) / 1e12:.1f} "
          f"TFLOP/s, MFU {mfu:.3f} of the H100 SXM's 989 TFLOP/s bf16 dense peak ({tag})")
    del model, vq, state, step, accum, batch, null
    torch.cuda.empty_cache()
    tiny = tiny_train_against_cpu(tag)
    return {"step_ms": med, "step_ms_all": times, "images_per_s": TRAIN_BATCH * 1e3 / med, "peak_bytes": peak,
            "loss_first": metrics[0]["loss"], "loss_last": metrics[-1]["loss"], "tflop_per_step": total / 1e12,
            "mfu": mfu, "launches": {"fused_codebook_lookup": k4}, "accum_step_ms": accum_ms, "tiny": tiny,
            "profile_ms": {k: v[0] / 1e3 for k, v in groups.items()}, "busy": busy / wall}


DRIVER_STEPS, DRIVER_EVAL_EVERY, DRIVER_BATCH, DRIVER_SHARDS, DRIVER_PER_SHARD = 4, 2, 8, 2, 16


def driver_data(d: str):
    """(the data iterable, what it is): WebDatasetLoader over JPEG tar shards
    written by write_tar_shard where PIL (to encode them) and a JPEG decoder
    are present, else SyntheticDataset; both at 256x256, batch 8, seeded."""
    import numpy as np

    from paella_tpu_torch.data import SampleFilter, SyntheticDataset, WebDatasetLoader, jpeg_decoder, write_tar_shard

    decoder = jpeg_decoder()
    try:
        from PIL import Image
    except ImportError:
        Image = None
    if Image is None or decoder == "none":
        return (SyntheticDataset(batch_size=DRIVER_BATCH, image_size=TRAIN_HW, seed=0),
                f"SyntheticDataset (JPEG decoder here: {decoder}; PIL {'absent' if Image is None else 'present'}, "
                "so no JPEG shard can be written or read)")
    import io

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
        paths.append(os.path.join(d, f"shard-{s:04d}.tar"))
        write_tar_shard(paths[-1], samples)
    loader = WebDatasetLoader(paths, batch_size=DRIVER_BATCH, image_size=TRAIN_HW, shuffle_buffer=8,
                              filter=SampleFilter(min_size=256), num_workers=4, shard_offset=0, shard_stride=1)
    return loader, f"WebDatasetLoader over {len(paths)} JPEG tar shards of {DRIVER_PER_SHARD} (decoder: {decoder})"


def driver_launches(steps: int, grids: int) -> dict:
    """The kernel launches of a run_training call at the flagship's depth:
    K4 once a train step and twice an eval grid (the diagnostic encode and
    the reconstruction's lookup); per grid K1 in the diagnostic forward and,
    with K3, in two 8-step CFG generations, each captured as a graph
    (GRAPH_PASSES passes through the wrappers); nothing else."""
    generations = grids * 2 * GRAPH_PASSES * STEPS
    return {"fused_codebook_lookup": steps + 2 * grids, "fused_resblock": grids * K1_PER_FORWARD + generations * K1_PER_FORWARD,
            "gumbel_categorical": generations, "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0}


def jsonl(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def phase_driver(tag: str, bare_step_ms: float) -> dict:
    """The training driver (train/driver.py::run_training) at the JAX
    package's "1b" training configuration (phase 16's: v1_byt5_xl in bf16
    with remat and dropout 0.1, the frozen bf16 VQConfig() codec), bf16 Adam
    moments, batch 8 at 256x256, make_synthetic_encode_fn at the ByT5-XL /
    CLIP widths (77 ByT5 tokens): 4 steps with eval_every=2 (two checkpoints,
    two eval grids of 8-step sampling), then a fresh model and state resume
    from the step-2 checkpoint (in a workdir of their own) and run to step 4
    on the same data stream. Checks: the eval grid's sampled tokens at step
    4 equal a fresh model's loaded from the step-4 checkpoint (fault C6 on
    the card), K4 on step 4's latents equals its plain version, and the
    resumed run ends within two Adam steps of the uninterrupted one."""
    import itertools
    import shutil
    import tempfile

    import numpy as np
    import torch

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, TrainConfig, VQConfig
    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.train import CheckpointManager, DriverConfig, make_synthetic_encode_fn, run_training
    from paella_tpu_torch.train.driver import _eval_grid

    root = tempfile.mkdtemp(prefix="paella_driver_")
    try:
        gen = torch.Generator(device="cuda").manual_seed(60)
        p_cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl(), dtype="bfloat16", remat=True)
        with torch.device("cuda"):
            model = Paella(p_cfg)
            vq = VQModel(dataclasses.replace(VQConfig(), dtype="bfloat16"))
        model.reset_parameters(gen)
        perturb_(model, gen)
        vq.reset_parameters(gen)
        perturb_(vq, gen)
        init = {k: v.detach().clone() for k, v in model.named_parameters()}
        enc, null = make_synthetic_encode_fn(p_cfg.byt5_embd, p_cfg.clip_embd, seq_len=TRAIN_BYT5_LEN, device="cuda")
        data, data_text = driver_data(root)
        t_cfg = TrainConfig(warmup_updates=1, adam_moment_dtype="bfloat16")
        d_cfg = DriverConfig(workdir=os.path.join(root, "run"), total_steps=DRIVER_STEPS, log_every=1,
                             eval_every=DRIVER_EVAL_EVERY, eval_steps=STEPS)
        print(f"[driver] '1b' config, bf16 Adam moments, batch {DRIVER_BATCH} at {TRAIN_HW}x{TRAIN_HW}; data: {data_text}; "
              f"run_training for {DRIVER_STEPS} steps, eval_every {DRIVER_EVAL_EVERY} ({tag})", flush=True)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        state, launches = counted(lambda: run_training(model, vq, iter(data), enc, null, t_cfg, d_cfg))
        run_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(state.step == DRIVER_STEPS and state.optimizer.count == DRIVER_STEPS, f"driver ended at step {state.step}")
        recs = jsonl(os.path.join(d_cfg.workdir, "metrics.jsonl"))
        steps = {r["step"]: r for r in recs if "loss" in r}
        check(sorted(steps) == list(range(1, DRIVER_STEPS + 1)), f"logged steps {sorted(steps)}")
        check(all(math.isfinite(r["loss"]) and r["nonfinite_skips"] == 0 for r in steps.values()), f"steps {steps}")
        step_ms = [(steps[2]["time"] - steps[1]["time"]) * 1e3, (steps[4]["time"] - steps[3]["time"]) * 1e3]
        ckpt_s = [r["checkpoint_s"] for r in recs if "checkpoint_s" in r]
        eval_s = [r["eval_s"] for r in recs if "eval_s" in r]
        ckpt = CheckpointManager(os.path.join(d_cfg.workdir, "checkpoints"))
        check(ckpt.all_steps() == [2, 4] and len(ckpt_s) == 2 and len(eval_s) == 2,
              f"checkpoints {ckpt.all_steps()}, saves {ckpt_s}, eval grids {eval_s}")
        ckpt_bytes = os.path.getsize(os.path.join(ckpt.directory, "4", "state.pt"))
        k = {n: launches[n] for n in ("fused_resblock", "gumbel_categorical", "fused_codebook_lookup",
                                      "fused_head_categorical", "fused_attention", "fused_attn_block")}
        check_launches("driver", k, driver_launches(DRIVER_STEPS, DRIVER_STEPS // DRIVER_EVAL_EVERY))
        check(k["fused_head_categorical"] == k["fused_attention"] == k["fused_attn_block"] == 0, f"off-path kernels ran {k}")
        print(f"[driver] {DRIVER_STEPS} steps + 2 saves + 2 eval grids in {run_s:.1f} s: step 2 {step_ms[0]:.1f} ms, step 4 "
              f"{step_ms[1]:.1f} ms ({DRIVER_BATCH * 1e3 / step_ms[1]:.2f} images/s; phase 16's bare step "
              f"{bare_step_ms:.1f} ms, {DRIVER_BATCH * 1e3 / bare_step_ms:.2f} images/s); loss "
              f"{[round(steps[s]['loss'], 4) for s in sorted(steps)]}; checkpoint {ckpt_bytes / 1e9:.2f} GB, saved in "
              f"{', '.join(f'{s:.1f}' for s in ckpt_s)} s; eval grid {', '.join(f'{s:.1f}' for s in eval_s)} s; launches "
              f"K1 {k['fused_resblock']}, K3 {k['gumbel_categorical']}, K4 {k['fused_codebook_lookup']}; peak memory "
              f"{peak / 2**30:.2f} GiB ({tag})", flush=True)

        # C6 on the card: the step-4 grid's tokens against a fresh model loaded from the step-4 checkpoint
        grid = np.load(os.path.join(d_cfg.workdir, f"eval_{DRIVER_STEPS:07d}.npz"))
        with torch.device("cuda"):
            fresh = Paella(p_cfg)
        fresh.load_state_dict(ckpt.restore(None, DRIVER_STEPS)[0]["model"])
        check(all(torch.equal(a, b) for a, b in zip(fresh.state_dict().values(), model.state_dict().values())),
              "the step-4 checkpoint holds other parameters than the trained model")
        os.makedirs(os.path.join(root, "check"))
        _eval_grid(fresh, vq, enc, d_cfg, DRIVER_STEPS, os.path.join(root, "check"),
                   images=grid["orig"].astype(np.float32) / 255.0, captions=list(grid["captions"]))
        again = np.load(os.path.join(root, "check", f"eval_{DRIVER_STEPS:07d}.npz"))
        same = [float((again[n] == grid[n]).mean()) for n in ("tokens", "tokens_noimg")]
        moved = sum(not torch.equal(v, init[n]) for n, v in model.named_parameters())
        print(f"[driver] C6: the step-4 eval grid's sampled tokens against a fresh model loaded from the step-4 "
              f"checkpoint: equal shares {same[0]:.6f} (with the image conditioning) and {same[1]:.6f} (without) "
              f"(want 1.0); {moved} of {len(init)} tensors moved by training ({tag})", flush=True)
        check(same == [1.0, 1.0], f"C6: the trained model's eval tokens differ from a freshly loaded model's: {same}")
        check(moved > 0.9 * len(init), f"only {moved} tensors moved")
        del fresh, init

        # prefetch_to_device: the stream's first 6 batches through pinned memory and the side stream, each
        # read on the compute stream as soon as it is yielded
        from paella_tpu_torch.data import prefetch_to_device

        host = list(itertools.islice(iter(data), 6))
        t0 = time.perf_counter()
        got = [t.clone() for t, _ in prefetch_to_device(iter(host), size=3)]
        torch.cuda.synchronize()
        pf_ms = (time.perf_counter() - t0) * 1e3
        pf_ok = all(torch.equal(g.cpu(), torch.from_numpy(h)) for g, (h, _) in zip(got, host))
        print(f"[driver] prefetch_to_device: {len(host)} batches {host[0][0].shape} f32 through pinned memory and a "
              f"side stream in {pf_ms:.1f} ms, each cloned on the compute stream as yielded: "
              f"{'bit for bit' if pf_ok else 'NOT equal to'} the host batches ({tag})", flush=True)
        check(pf_ok, "prefetch_to_device gave other values than the host batches")

        # K4 on step 4's latents (item 4 of the stream: steps 1, 2, the step-2 eval batch, step 3, step 4)
        images4, captions4 = next(itertools.islice(iter(data), 4, None))
        z = vq.encoder(torch.from_numpy(images4).cuda()).contiguous()
        cb = vq.vquantizer.codebook.weight.detach().float().contiguous()
        agree = (fused_codebook_lookup(z, cb) == codebook_lookup_plain(z, cb)).float().mean().item()
        check(agree == 1.0, f"K4 on step 4's latents agrees {agree} with its plain version")

        # resume: fresh objects from the step-2 checkpoint, the same data stream from item 3 on
        final = {n: v.detach().clone() for n, v in model.state_dict().items()}
        del state, model
        torch.cuda.empty_cache()
        with torch.device("cuda"):
            resumed = Paella(p_cfg)
        resumed.reset_parameters(torch.Generator(device="cuda").manual_seed(61))
        r_cfg = dataclasses.replace(d_cfg, workdir=os.path.join(root, "resumed"))
        os.makedirs(os.path.join(r_cfg.workdir, "checkpoints", "2"))
        os.link(os.path.join(ckpt.directory, "2", "state.pt"), os.path.join(r_cfg.workdir, "checkpoints", "2", "state.pt"))
        shutil.rmtree(os.path.join(ckpt.directory, "4"))
        t0 = time.perf_counter()
        r_state, r_launches = counted(lambda: run_training(resumed, vq, itertools.islice(iter(data), 3, None), enc, null,
                                                           t_cfg, r_cfg))
        resume_s = time.perf_counter() - t0
        r_recs = jsonl(os.path.join(r_cfg.workdir, "metrics.jsonl"))
        r_steps = {r["step"]: r for r in r_recs if "loss" in r}
        restore_s = [r["restore_s"] for r in r_recs if "restore_s" in r]
        check(r_state.step == DRIVER_STEPS and r_state.optimizer.count == DRIVER_STEPS and sorted(r_steps) == [3, 4]
              and len(restore_s) == 1, f"resumed run: step {r_state.step}, logged {sorted(r_steps)}")
        check_launches("resumed driver", r_launches, driver_launches(2, 1))
        diff = max((v.float() - final[n].float()).abs().max().item() for n, v in resumed.state_dict().items())
        bitwise = all(torch.equal(v, final[n]) for n, v in resumed.state_dict().items())
        loss_gap = max(abs(r_steps[s]["loss"] - steps[s]["loss"]) for s in (3, 4))
        print(f"[driver] resumed from the step-2 checkpoint (restored in {restore_s[0]:.1f} s) to step 4 in {resume_s:.1f} s: "
              f"loss at steps 3, 4 {[round(r_steps[s]['loss'], 4) for s in (3, 4)]} vs {[round(steps[s]['loss'], 4) for s in (3, 4)]} "
              f"(largest gap {loss_gap:.2e}); parameters {'bit for bit' if bitwise else 'not bit for bit'} the "
              f"uninterrupted run's, largest difference {diff:.3e} (limit 2 Adam steps, {2.1 * 2 * t_cfg.lr:.1e}); "
              f"launches K1 {r_launches['fused_resblock']}, K3 {r_launches['gumbel_categorical']}, K4 "
              f"{r_launches['fused_codebook_lookup']} ({tag})", flush=True)
        check(diff <= 2.1 * 2 * t_cfg.lr and loss_gap <= 1e-2 * abs(steps[4]["loss"]),
              f"the resumed run ends {diff} from the uninterrupted one (loss gap {loss_gap})")
        for n in ("fused_resblock", "fused_resblock[float]", "gumbel_categorical", "fused_codebook_lookup"):
            launches[n] += r_launches[n]
        del resumed, r_state, final
        torch.cuda.empty_cache()
        return {"step_ms": step_ms, "images_per_s": DRIVER_BATCH * 1e3 / step_ms[1], "bare_step_ms": bare_step_ms,
                "checkpoint_bytes": ckpt_bytes, "checkpoint_s": ckpt_s, "restore_s": restore_s[0], "eval_s": eval_s,
                "run_s": run_s, "resume_s": resume_s, "peak_bytes": peak, "resume_bitwise": bitwise,
                "resume_max_diff": diff, "data": data_text, "prefetch_ms": pf_ms,
                "launches": {n: launches[n] for n in ("fused_resblock", "fused_resblock[float]", "gumbel_categorical",
                                                      "fused_codebook_lookup")}}
    finally:
        shutil.rmtree(root, ignore_errors=True)


CODEC_BATCH, CODEC_STEPS = 8, 5


def phase_codec_train(tag: str) -> dict:
    """The codec trainer (codec/trainer.py) at VQConfig() in float32, the
    geometry scripts/run_codec_pretrain.py trains, with its default
    Discriminator (c_hidden 512, depth 6), CodecTrainConfig() (revive_after
    100), batch 8 at 256x256 of seeded images: five steps (median step ms of
    the last four, images/s, peak memory, losses, codes used and revived),
    K4 launched once a step, K4 on the latents of the step's batch against
    its plain version."""
    import torch

    from paella_tpu_torch.codec import (CodecTrainConfig, Discriminator, VQModel, create_codec_train_state,
                                        make_codec_train_step)
    from paella_tpu_torch.config import VQConfig
    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup

    gen = torch.Generator(device="cuda").manual_seed(70)
    with torch.device("cuda"):
        vq, disc = VQModel(VQConfig()), Discriminator()
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    disc.reset_parameters(gen)
    cfg = CodecTrainConfig()
    state = create_codec_train_state(vq, disc, cfg)
    step = make_codec_train_step(vq, disc, cfg)
    images = torch.rand(CODEC_BATCH, TRAIN_HW, TRAIN_HW, 3, generator=gen, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    metrics, times, k4 = [], [], 0
    for i in range(CODEC_STEPS):
        t0 = time.perf_counter()
        m, launches = counted(lambda: step(state, images))
        times.append((time.perf_counter() - t0) * 1e3)
        metrics.append({k: float(v) for k, v in m.items()})
        check_launches(f"codec step {i + 1}", launches, {"fused_codebook_lookup": 1, "fused_resblock": 0})
        k4 += launches["fused_codebook_lookup"]
        check(all(math.isfinite(v) for v in metrics[-1].values()), f"codec step {i + 1}: {metrics[-1]}")
    peak = torch.cuda.max_memory_allocated()
    med = sorted(times[1:])[len(times[1:]) // 2]
    z = vq.encoder(images).contiguous()
    cb = vq.vquantizer.codebook.weight.detach().float().contiguous()
    agree = (fused_codebook_lookup(z, cb) == codebook_lookup_plain(z, cb)).float().mean().item()
    first, last = metrics[0], metrics[-1]
    print(f"[codec train] VQConfig() f32 + Discriminator(c_hidden 512, depth 6), batch {CODEC_BATCH} at {TRAIN_HW}x{TRAIN_HW}, "
          f"{CODEC_STEPS} steps: median step {med:.1f} ms of the last {CODEC_STEPS - 1} (first {times[0]:.1f}), "
          f"{CODEC_BATCH * 1e3 / med:.2f} images/s; peak memory {peak / 2**30:.2f} GiB; g_loss {first['g_loss']:.4f} -> "
          f"{last['g_loss']:.4f}, d_loss {first['d_loss']:.4f} -> {last['d_loss']:.4f}, recon_l1 {first['recon_l1']:.4f} -> "
          f"{last['recon_l1']:.4f}; codes used {[int(m['codes_used_batch']) for m in metrics]}, revived "
          f"{[int(m['codes_revived']) for m in metrics]}; K4 launched {k4} times (one a step), on z {tuple(z.shape)} "
          f"against its plain version: indices agree {agree:.6f} (want 1.0) ({tag})", flush=True)
    check(agree == 1.0, f"K4 on the codec batch's latents agrees {agree} with its plain version")
    del vq, disc, state, step
    torch.cuda.empty_cache()
    return {"step_ms": med, "step_ms_all": times, "images_per_s": CODEC_BATCH * 1e3 / med, "peak_bytes": peak,
            "metrics_first": first, "metrics_last": last, "launches": {"fused_codebook_lookup": k4}}


def phase_ddp(tag: str) -> dict:
    """parallel/ at world size 1 on NCCL: initialize_distributed joins a
    one-rank group (tcp://127.0.0.1, a free port), and one train step of
    PaellaConfig.tiny() (f32, VQConfig.tiny(), batch 4 at 64x64, pinned
    draws, grad_accum_steps=2) through data_parallel equals the same step
    without DDP, bit for bit, under cuDNN's deterministic algorithms; two
    plain steps are compared first, to show the step itself repeats bit for
    bit."""
    import torch
    import torch.distributed as dist

    from paella_tpu_torch.parallel import data_parallel, initialize_distributed
    from paella_tpu_torch.train import Draws, create_train_state, make_train_step

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, TrainConfig, VQConfig
    from paella_tpu_torch.models import Paella

    gen = torch.Generator(device="cuda").manual_seed(80)
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
        check(info["backend"] == "nccl" and info["process_count"] == 1, f"process group {info}")
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
        same = lambda a, b: a[0] == b[0] and all(torch.equal(g, b[1][n]) for n, g in a[1].items())  # noqa: E731
        repeat, ddp_equal = same(runs[0], runs[1]), same(runs[0], runs[2])
        gap = max((g - runs[0][1][n]).abs().max().item() for n, g in runs[2][1].items())
        print(f"[ddp] initialize_distributed: {info}; PaellaConfig.tiny() f32, batch 4 at 64x64, grad_accum_steps=2: "
              f"two plain steps {'bit for bit alike' if repeat else 'NOT alike'}; the DDP step's loss, acc, grad_norm and "
              f"every gradient {'bit for bit' if ddp_equal else 'NOT bit for bit'} the plain step's (largest gradient "
              f"gap {gap:.2e}) ({tag})", flush=True)
        check(repeat, "two plain tiny train steps differ on the card: the comparison has no footing")
        check(ddp_equal, f"the world-size-1 DDP step differs from the plain step (gradient gap {gap})")
    finally:
        dist.destroy_process_group()
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    return {"repeat_bitwise": repeat, "ddp_bitwise": ddp_equal, "grad_gap": gap}


FSDP_STEPS = 3
# FSDP2's own device work, grouped ahead of TRAIN_GROUPS: the collectives, and the copies into and out of
# their buffers (all_gather_copy_in, split_with_sizes_copy, chunk_cat)
FSDP_GROUPS = [("NCCL", ("nccl",)), ("FSDP copies", ("chunk_cat", "split_with_sizes", "CatArrayBatchedCopy",
                                                     "all_gather_copy_in"))]


def phase_fsdp(tag: str) -> dict:
    """FSDP inside training at world size 1: initialize_distributed joins a
    one-rank NCCL group, and parallel.shard_model shards a copy of phase
    16's "1b" model (v1_byt5_xl in bf16 with remat and dropout 0.1, the
    frozen bf16 VQConfig() codec) over the (1, 1) mesh; TrainConfig with
    bf16 Adam moments, batch 8 at 256x256, every draw pinned (dropout by
    seed). Steps 1 and 2 run in turns, plain then sharded, from the same
    weights: loss, acc and grad_norm within 1e-5 relative, and after step 2
    at most 0.1% of the parameters more than 0.02 lr and none more than 2.1
    lr from the plain ones (tests/test_torch_fsdp.py's tolerances). Then the whole state
    is gathered as run_training's checkpoint does (checkpoint_state), loaded
    into a freshly built and sharded model (load_state), and step 3 runs on
    the plain, the uninterrupted sharded and the restored model in turns:
    the restored model's parameters within the same tolerances of the
    uninterrupted one's. Between them, rank 0's eval grid as run_training
    draws it at fsdp > 1: a plain copy of the model loaded from the
    gathered state (inference_copy), its grid's sampled tokens equal to the
    same grid drawn by the plain model (K1, K3, K4 launched). Each step's host ms (ending in a synchronize), its
    peak memory (max_memory_allocated, every model of the phase resident)
    and the rise above what was allocated before it; K4 once a step; then a
    profile of one more step of each route (kernel time by kind, NCCL and
    FSDP2's copies apart, busy share)."""
    import shutil
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, TrainConfig, VQConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.parallel import initialize_distributed, shard_model
    from paella_tpu_torch.train import DriverConfig, Draws, create_train_state, make_synthetic_encode_fn, make_train_step
    from paella_tpu_torch.train.driver import _eval_grid, checkpoint_state, inference_copy, load_state

    gen = torch.Generator(device="cuda").manual_seed(90)
    p_cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl(), dtype="bfloat16", remat=True)
    with torch.device("cuda"):
        plain = Paella(p_cfg)
        vq = VQModel(dataclasses.replace(VQConfig(), dtype="bfloat16"))
    plain.reset_parameters(gen)
    perturb_(plain, gen)
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    cfg = TrainConfig(warmup_updates=1, adam_moment_dtype="bfloat16")
    batch, null = train_inputs(p_cfg, TRAIN_BATCH, TRAIN_HW, gen, "cuda")
    hw, b = TRAIN_HW // 4, TRAIN_BATCH
    draws = [Draws(*(torch.rand(b, generator=gen, device="cuda") < p for p in (0.05, 0.9, 0.9)),
                   u=torch.rand(b, generator=gen, device="cuda"),
                   noise_mask=(torch.rand(b, hw, hw, generator=gen, device="cuda") < 0.5).int(),
                   random_x=torch.randint(0, p_cfg.num_labels, (b, hw, hw), generator=gen, device="cuda",
                                          dtype=torch.int32), dropout_seed=i + 1) for i in range(FSDP_STEPS)]
    info = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0)
    try:
        check(info["backend"] == "nccl" and info["process_count"] == 1, f"process group {info}")

        def sharded_copy(state_dict=None):
            with torch.device("cuda"):
                m = Paella(p_cfg)
            if state_dict is not None:
                m.load_state_dict(state_dict)
            t1 = time.perf_counter()
            return m, shard_model(m, fsdp=1), time.perf_counter() - t1

        sharded, mesh, wrap_s = sharded_copy(plain.state_dict())
        routes = {"plain": (plain, create_train_state(plain, cfg), make_train_step(plain, vq, cfg)),
                  "fsdp": (sharded, create_train_state(sharded, cfg), make_train_step(sharded, vq, cfg, mesh=mesh))}
        runs = {name: {"ms": [], "peak": [], "rise": [], "metrics": []} for name in ("plain", "fsdp", "restored")}
        k4 = 0

        def run(name: str, i: int) -> None:
            nonlocal k4
            _, state, step = routes[name]
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t1 = time.perf_counter()
            out, launches = counted(lambda: step(state, batch, null, [dataclasses.replace(draws[i])]))
            r = runs[name]
            r["ms"].append((time.perf_counter() - t1) * 1e3)
            r["peak"].append(torch.cuda.max_memory_allocated())
            r["rise"].append(r["peak"][-1] - base)
            r["metrics"].append({k: float(v) for k, v in out.items()})
            check_launches(f"fsdp phase, {name} step {i + 1}", launches, {
                "fused_codebook_lookup": 1, "fused_resblock": 0, "fused_head_categorical": 0, "gumbel_categorical": 0,
                "fused_attention": 0, "fused_attn_block": 0})
            k4 += launches["fused_codebook_lookup"]
            m = r["metrics"][-1]
            check(math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]) and m["nonfinite_skips"] == 0,
                  f"fsdp phase, {name} step {i + 1}: {m}")

        def gap(a, b) -> tuple[float, float, float, bool]:
            """The metrics' largest relative gap; the share of parameters
            more than 0.02 lr apart and the largest gap in lr; bit for bit
            or not."""
            ra, rb = runs[a]["metrics"][-1], runs[b]["metrics"][-1]
            rel = max(abs(ra[k] - rb[k]) / max(abs(rb[k]), 1e-12) for k in ("loss", "acc", "grad_norm"))
            local = lambda p: p.to_local() if hasattr(p, "to_local") else p  # noqa: E731
            over = worst = total = 0
            with torch.no_grad():
                for p, q in zip(routes[a][0].parameters(), routes[b][0].parameters()):
                    d = (local(p) - local(q)).abs() / cfg.lr
                    over += int((d > 0.02).sum())
                    worst = max(worst, d.max().item())
                    total += d.numel()
            return rel, over / total, worst, worst == 0.0

        for i in range(2):
            run("plain", i)
            run("fsdp", i)
        rel, share, worst, bitwise = gap("fsdp", "plain")
        print(f"[fsdp] shard_model over the mesh {tuple(mesh.shape)} ({', '.join(mesh.mesh_dim_names)}) on {info['backend']} "
              f"in {wrap_s:.2f} s; '1b', bf16 moments, batch {b} at {TRAIN_HW}x{TRAIN_HW}, pinned draws, in turns: step ms "
              f"plain {[round(x, 1) for x in runs['plain']['ms']]}, sharded {[round(x, 1) for x in runs['fsdp']['ms']]}; "
              f"peak memory (both models resident) plain {[round(x / 2**30, 2) for x in runs['plain']['peak']]} GiB, "
              f"sharded {[round(x / 2**30, 2) for x in runs['fsdp']['peak']]} GiB, the steps' rise above what was "
              f"allocated before them plain {[round(x / 2**30, 2) for x in runs['plain']['rise']]}, sharded "
              f"{[round(x / 2**30, 2) for x in runs['fsdp']['rise']]} GiB; after step 2 against the plain step: metrics "
              f"rel gap {rel:.2e} (limit 1e-5), parameters more than 0.02 lr apart {share:.2e} (limit 1e-3), max "
              f"{worst:.2e} lr (limit 2.1), {'bit for bit' if bitwise else 'not bit for bit'} ({tag})", flush=True)
        check(rel <= 1e-5 and share <= 1e-3 and worst <= 2.1,
              f"the sharded step differs from the plain one: {rel}, {share}, {worst}")

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = checkpoint_state(sharded, routes["fsdp"][1])
        gather_s = time.perf_counter() - t0
        tensors = list(snap["model"].values()) + [v for s in snap["optimizer"]["state"].values() for v in s.values()]
        gather_bytes = sum(t.numel() * t.element_size() for t in tensors)
        check(all(t.device.type == "cpu" for t in tensors), "the gathered state is not on the CPU")

        # rank 0's eval grid in run_training(fsdp > 1): a plain copy loaded from the gathered state, its
        # tokens against the same grid drawn by the plain model (bit for bit the sharded one after step 2)
        grid_dir = tempfile.mkdtemp(prefix="paella_fsdp_")
        try:
            enc, _ = make_synthetic_encode_fn(p_cfg.byt5_embd, p_cfg.clip_embd, seq_len=TRAIN_BYT5_LEN, device="cuda")
            images, captions = batch.images.float().cpu().numpy(), [f"a photo of thing {i}" for i in range(b)]
            d_cfg = DriverConfig(eval_steps=STEPS)
            t0 = time.perf_counter()
            copy = inference_copy(sharded, snap["model"])
            copy_s = time.perf_counter() - t0
            grids = {}
            for name, m in (("copy", copy), ("plain", plain)):
                os.makedirs(os.path.join(grid_dir, name))
                t0 = time.perf_counter()
                _, grids[name] = counted(lambda: _eval_grid(m, vq, enc, d_cfg, 2, os.path.join(grid_dir, name),
                                                            images=images, captions=captions))
                grids[name + "_s"] = time.perf_counter() - t0
            got, want = (np.load(os.path.join(grid_dir, n, "eval_0000002.npz")) for n in ("copy", "plain"))
            same = [float((got[k] == want[k]).mean()) for k in ("tokens", "tokens_noimg")]
        finally:
            shutil.rmtree(grid_dir, ignore_errors=True)
        del copy
        grid_launches = grids["copy"]
        check_launches("fsdp phase, the eval grid from the gathered copy", grid_launches, driver_launches(0, 1))
        print(f"[fsdp] the eval grid from the gathered state (run_training's rank 0 at fsdp > 1): plain copy built and "
              f"loaded in {copy_s:.2f} s, grid (batch {b}, two 8-step CFG generations) in {grids['copy_s']:.2f} s; its "
              f"sampled tokens against the plain model's grid: equal shares {same[0]:.6f} / {same[1]:.6f} (want 1.0); "
              f"launches K1 {grid_launches['fused_resblock[float]']}, K3 {grid_launches['gumbel_categorical']}, K4 "
              f"{grid_launches['fused_codebook_lookup']} ({tag})", flush=True)
        check(same == [1.0, 1.0], f"the grid from the gathered copy differs from the plain model's: {same}")
        t0 = time.perf_counter()
        restored, _, _ = sharded_copy()
        r_state = create_train_state(restored, cfg)
        load_state(restored, r_state, snap)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        del snap, tensors
        routes["restored"] = (restored, r_state, make_train_step(restored, vq, cfg, mesh=mesh))
        for name in ("plain", "fsdp", "restored"):
            run(name, 2)
        r_rel, r_share, r_worst, r_bitwise = gap("restored", "fsdp")
        p_rel, p_share, p_worst, _ = gap("fsdp", "plain")
        print(f"[fsdp] whole-state gather (checkpoint_state: parameters and bf16 moments to the CPU) "
              f"{gather_bytes / 1e9:.2f} GB in {gather_s:.2f} s ({gather_bytes / 1e9 / gather_s:.2f} GB/s); restore into "
              f"a freshly built and sharded model (build, shard_model, load_state) in {restore_s:.2f} s; step 3 in turns: "
              f"plain {runs['plain']['ms'][-1]:.1f} ms, sharded {runs['fsdp']['ms'][-1]:.1f} ms, restored "
              f"{runs['restored']['ms'][-1]:.1f} ms (its first); the restored step 3 against the uninterrupted one: "
              f"metrics rel gap {r_rel:.2e}, parameters more than 0.02 lr apart {r_share:.2e}, max {r_worst:.2e} lr, "
              f"{'bit for bit' if r_bitwise else 'not bit for bit'}; sharded vs plain after step 3: {p_rel:.2e}, "
              f"{p_share:.2e}, {p_worst:.2e} lr; K4 launched {k4} times ({tag})", flush=True)
        check(r_rel <= 1e-5 and r_share <= 1e-3 and r_worst <= 2.1,
              f"the restored step 3 differs from the uninterrupted one: {r_rel}, {r_share}, {r_worst}")
        check(p_rel <= 1e-5 and p_share <= 1e-3 and p_worst <= 2.1, f"step 3 sharded vs plain: {p_rel}, {p_share}, {p_worst}")
        profiles = {}
        for name in ("plain", "fsdp"):
            _, state, step = routes[name]
            kernels, wall = profile_kernels(lambda: step(state, batch, null, [dataclasses.replace(draws[2])]))
            groups = group_kernels(kernels, FSDP_GROUPS + TRAIN_GROUPS)
            busy = sum(us for us, _ in groups.values()) / 1e3
            profiles[name] = {"wall_ms": wall, "kernels_ms": busy, "busy": busy / wall if wall else None,
                              "launches": sum(n for _, n in groups.values()),
                              "groups_ms": {k: v[0] / 1e3 for k, v in groups.items()}}
        print(f"[fsdp] profile of one step of each route (torch.profiler): " + "; ".join(
            f"{name}: all kernels {p['kernels_ms']:.1f} ms of {p['wall_ms']:.1f} ms wall ({p['busy']:.0%} busy), "
            f"{p['launches']:.0f} launches, NCCL {p['groups_ms']['NCCL']:.1f} ms, FSDP copies "
            f"{p['groups_ms']['FSDP copies']:.1f} ms, elementwise {p['groups_ms']['elementwise']:.1f} ms"
            for name, p in profiles.items()) + f" ({tag})", flush=True)
        result = {"step_ms": {k: v["ms"] for k, v in runs.items()}, "peak_bytes": {k: v["peak"] for k, v in runs.items()},
                  "rise_bytes": {k: v["rise"] for k, v in runs.items()}, "wrap_s": wrap_s,
                  "step2_gap": {"metrics_rel": rel, "param_share_over_0.02lr": share, "param_max_lr": worst,
                                "bitwise": bitwise},
                  "gather_bytes": gather_bytes, "gather_s": gather_s, "restore_s": restore_s,
                  "restored_gap": {"metrics_rel": r_rel, "param_share_over_0.02lr": r_share, "param_max_lr": r_worst,
                                   "bitwise": r_bitwise},
                  "grid": {"copy_s": copy_s, "eval_s": grids["copy_s"], "plain_eval_s": grids["plain_s"],
                           "tokens_equal": same},
                  "profile": profiles,
                  "launches": {"fused_codebook_lookup": k4 + grid_launches["fused_codebook_lookup"],
                               "fused_resblock[float]": grid_launches["fused_resblock[float]"],
                               "gumbel_categorical": grid_launches["gumbel_categorical"]}}
    finally:
        dist.destroy_process_group()
    del plain, sharded, routes
    torch.cuda.empty_cache()
    return result


PROD_BATCH, PROD_TURNS, PROD_TURN_STEPS = 8, 3, 4
PROD_CODEC_STEPS, PROD_CODEC_DISC_START, PROD_CODEC_COLLAGE = 6, 3, 3
PROD_EVAL_N, PROD_EVAL_BATCH = 32, 16
PROD_EVAL_EVERY = 2


def run_script(name: str, args: list, log_path: str, timeout: float) -> tuple[dict, float, str]:
    """`python -m paella_tpu_torch.scripts.<name> *args` from this checkout, a
    process of its own, killed at `timeout`: (its last line as JSON, its
    seconds, its output)."""
    t0 = time.perf_counter()
    with open(log_path, "w+") as log:
        try:
            rc = subprocess.run([sys.executable, "-m", f"paella_tpu_torch.scripts.{name}", *args], cwd=REPO,
                                stdout=log, stderr=subprocess.STDOUT, timeout=timeout).returncode
        except subprocess.TimeoutExpired:
            raise CheckFailed(f"{name} ran past {timeout} s: {tail_of(log)}")
        check(rc == 0, f"{name} {' '.join(args)} exited {rc}: {tail_of(log)}")
        log.seek(0)
        text = log.read()
    return json.loads(text.strip().splitlines()[-1]), time.perf_counter() - t0, text


def check_script_launches(what: str, got: dict, expect: dict) -> None:
    """A script's launch counts (its summary's `launches`, read at the end of
    its process, which started at 0): no plain version ran, and `expect`."""
    for name, n in got.items():
        if name.endswith("_plain"):
            check(n == 0, f"{what}: {name} ran {n} times on the card")
    check_launches(what, got, expect)


def production_turns(tag: str) -> dict:
    """In this process: the "1b" train step (bf16 moments, batch 8 at
    256x256) fed as run_training feeds it (each host batch through
    encode_batch and onto the card, through background_iterator at
    encode_prefetch 1, inline at 0), with the frozen ByT5-XL + ViT-H-14
    towers of run_driver_e2e.build_encoders (bf16, bucket 64) or phase 17's
    synthetic hash encoders at the same widths and length; the four arms in
    turns (A B C D D C B A), each one untimed step then PROD_TURN_STEPS timed
    (host time between step ends, the loss read each step as the driver's
    log_every 1 does), and per step the host ms the loop waited for its
    batch and the host ms of the encode call (in the producer thread at
    prefetch 1); the towers' encode ms a batch alone; the towers' bytes and
    the peak memory above what this process held before (the earlier
    phases' kept sampler graphs dropped first)."""
    import gc
    import itertools
    import types

    import numpy as np
    import torch

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import TrainConfig
    from paella_tpu_torch.data import SyntheticDataset, background_iterator
    from paella_tpu_torch.data.prefetch import map_tensors
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.sampling import graph
    from paella_tpu_torch.scripts import run_driver_e2e as drv
    from paella_tpu_torch.train import create_train_state, make_synthetic_encode_fn, make_train_step

    graph.clear()
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    towers, null_towers, _, _ = drv.build_encoders(types.SimpleNamespace(smoke=False, byt5="bf16", byt5_bucket=64),
                                                   torch.device("cuda"))
    torch.cuda.synchronize()
    towers_s = time.perf_counter() - t0
    towers_bytes = torch.cuda.memory_allocated() - base
    p_cfg, vq_cfg = drv.make_geometry("1b")
    gen = torch.Generator(device="cuda").manual_seed(80)
    with torch.device("cuda"):
        model, vq = Paella(p_cfg), VQModel(vq_cfg)
    model.reset_parameters(gen)
    perturb_(model, gen)
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    t_cfg = TrainConfig(warmup_updates=100, adam_moment_dtype="bfloat16")
    state = create_train_state(model, t_cfg, torch.Generator(device="cuda").manual_seed(81))
    step = make_train_step(model, vq, t_cfg)
    synth, null_synth = make_synthetic_encode_fn(p_cfg.byt5_embd, p_cfg.clip_embd, seq_len=64, device="cuda")
    captions = tuple(f"{s} a {o}" for s in drv.CAPTION_STYLES for o in drv.CAPTION_OBJECTS)
    host = list(itertools.islice(iter(SyntheticDataset(PROD_BATCH, TRAIN_HW, seed=3, captions=captions)), 4))

    enc_ms = []
    for i in range(6):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        towers(*host[i % len(host)])
        torch.cuda.synchronize()
        enc_ms.append((time.perf_counter() - t1) * 1e3)
    enc_ms = enc_ms[1:]

    losses = []

    def arm(encode, null, prefetch: int, steps: int) -> tuple[list, list, list]:
        enc = []

        def encoded():  # run_training's _encoded_batches over the cycled host batches
            for images, caps in itertools.islice(itertools.cycle(host), steps):
                t1 = time.perf_counter()
                batch = encode(images, caps)
                enc.append((time.perf_counter() - t1) * 1e3)
                yield map_tensors(lambda t: t.to("cuda", non_blocking=True), batch)

        stream = background_iterator(encoded(), depth=prefetch) if prefetch else encoded()
        ends, waits = [], []
        while True:
            t1 = time.perf_counter()
            batch = next(stream, None)
            if batch is None:
                break
            waits.append((time.perf_counter() - t1) * 1e3)
            metrics = {k: float(v) for k, v in step(state, batch, null).items()}
            losses.append(metrics["loss"])
            ends.append(time.perf_counter())
        return [(b - a) * 1e3 for a, b in zip(ends, ends[1:])], waits[1:], enc[1:]

    arm(synth, null_synth, 0, 2)  # warm-up: the step's first calls
    arms = {("towers", 1): (towers, null_towers), ("towers", 0): (towers, null_towers),
            ("synthetic", 1): (synth, null_synth), ("synthetic", 0): (synth, null_synth)}
    order = list(arms)
    times, waits, encodes = ({k: [] for k in arms} for _ in range(3))
    for turn in range(PROD_TURNS):
        for k in order if turn % 2 == 0 else order[::-1]:
            t, w, e = arm(*arms[k], k[1], PROD_TURN_STEPS + 1)
            times[k] += t
            waits[k] += w
            encodes[k] += e
    peak = torch.cuda.max_memory_allocated() - base
    check(all(math.isfinite(v) for v in losses), f"production turns: losses {losses}")
    p50 = lambda v: sorted(v)[len(v) // 2]  # noqa: E731
    med = {k: p50(v) for k, v in times.items()}
    added = med[("towers", 0)] - med[("synthetic", 0)]
    hidden = (med[("towers", 0)] - med[("towers", 1)]) / added if added > 0 else None
    enc_p50 = p50(enc_ms)
    print(f"[production] the '1b' step (bf16 moments, batch {PROD_BATCH} at {TRAIN_HW}x{TRAIN_HW}) fed as run_training "
          f"feeds it, {PROD_TURNS * PROD_TURN_STEPS} timed steps an arm in turns: " + "; ".join(
              f"{k[0]} encoders at encode_prefetch {k[1]}: median {med[k]:.1f} ms ({PROD_BATCH * 1e3 / med[k]:.2f} "
              f"images/s; {', '.join(f'{t:.0f}' for t in times[k])}), waited {p50(waits[k]):.1f} ms for its batch, "
              f"encode call {p50(encodes[k]):.1f} ms on the host" for k in order) +
          f"; the towers (ByT5-XL + ViT-H-14 text and vision, bf16, bucket 64, built in {towers_s:.1f} s, "
          f"{towers_bytes / 2**30:.2f} GiB) encode a batch in {enc_p50:.1f} ms alone (p50 of 5; "
          f"{', '.join(f'{t:.1f}' for t in enc_ms)}); at prefetch 0 they add {added:.1f} ms a step, and prefetch 1 "
          f"hides {'n/a' if hidden is None else f'{hidden:.0%}'} of that; peak memory {peak / 2**30:.2f} GiB above the "
          f"{base / 2**30:.2f} GiB this process held before ({tag})",
          flush=True)
    del towers, null_towers, synth, null_synth, model, vq, state, step
    gc.collect()
    torch.cuda.empty_cache()
    return {"step_ms": {f"{k[0]}_prefetch{k[1]}": med[k] for k in order},
            "step_ms_all": {f"{k[0]}_prefetch{k[1]}": times[k] for k in order},
            "wait_ms": {f"{k[0]}_prefetch{k[1]}": p50(waits[k]) for k in order},
            "encode_call_ms": {f"{k[0]}_prefetch{k[1]}": p50(encodes[k]) for k in order},
            "images_per_s": {f"{k[0]}_prefetch{k[1]}": PROD_BATCH * 1e3 / med[k] for k in order},
            "towers_encode_ms": enc_p50, "towers_encode_ms_all": enc_ms, "towers_build_s": towers_s,
            "towers_bytes": towers_bytes, "towers_added_ms": added, "prefetch_hidden_share": hidden, "peak_bytes": peak,
            "base_bytes": base}


def driver_steps_ms(recs: list, first: int, last: int) -> list:
    """Host ms of each step first+1..last from metrics.jsonl's step records
    (the time between consecutive steps' records; a save or a grid between
    them counts in)."""
    t = {r["step"]: r["time"] for r in recs if "loss" in r}
    return [(t[s] - t[s - 1]) * 1e3 for s in range(first + 1, last + 1) if s in t and s - 1 in t]


def phase_production(tag: str) -> dict:
    """The port's production entry points (paella_tpu_torch/scripts/), each a
    process of its own on the card, in a temporary directory removed at the
    end: run_codec_pretrain (VQConfig() f32 + Discriminator(), batch 8 at
    256x256, 6 steps, the GAN term from step 3) whose codec_vars.npz is read
    back bit for bit; run_driver_e2e at "1b" (bf16 moments, batch 8, the
    frozen ByT5-XL + ViT-H-14 towers, against that codec) stopped by SIGTERM
    after its first checkpoint and eval grid, then resumed by a fresh
    process to the next even step, and again with --byt5 w8a8 for 2 steps;
    run_eval_e2e over the bf16 run's checkpoints with --n 32 --trend, in
    image space with --real-recon and in token space with the W8A8 twin.
    Before them, production_turns in this process."""
    import shutil
    import signal
    import tempfile

    import numpy as np
    import torch

    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import VQConfig
    from paella_tpu_torch.convert import load_params_npz, vqgan_state_dict_from_jax, vqgan_variables_to_jax
    from paella_tpu_torch.train import save_params_npz

    turns = production_turns(tag)
    root = tempfile.mkdtemp(prefix="paella_production_")
    launches = {}

    def add(counts: dict) -> None:
        for k in ("fused_resblock", "fused_resblock[float]", "fused_resblock[int8]", "fused_resblock[w8a8]",
                  "gumbel_categorical", "fused_codebook_lookup"):
            launches[k] = launches.get(k, 0) + counts[k]

    def show(what: str, summary: dict, secs: float) -> None:
        print(f"[production] {what} in {secs:.1f} s; its JSON line: {json.dumps(summary)} ({tag})", flush=True)

    try:
        codec_dir, run_dir, w8_dir = (os.path.join(root, d) for d in ("codec", "run", "run_w8a8"))
        npz = os.path.join(codec_dir, "codec_vars.npz")

        # 1. codec pretraining
        codec, codec_s, _ = run_script("run_codec_pretrain", [
            "--workdir", codec_dir, "--steps", str(PROD_CODEC_STEPS), "--batch", "8", "--disc-start",
            str(PROD_CODEC_DISC_START), "--log-every", "1", "--collage-every", str(PROD_CODEC_COLLAGE),
            "--shards", "1", "--per-shard", "16"], os.path.join(root, "codec.log"), 300)
        show("run_codec_pretrain", codec, codec_s)
        snapshots = 2 + PROD_CODEC_STEPS // PROD_CODEC_COLLAGE  # init, every collage step, final
        check_script_launches("run_codec_pretrain", codec["launches"], {
            "fused_codebook_lookup": PROD_CODEC_STEPS + snapshots, "fused_resblock": 0, "gumbel_categorical": 0})
        check(codec["steps"] == PROD_CODEC_STEPS and all(math.isfinite(codec[k]) for k in (
            "init_eval_recon_l1", "final_eval_recon_l1")), f"codec summary {codec}")
        tree = load_params_npz(npz)
        with torch.device("cuda"):
            vq = VQModel(VQConfig())
        vq.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                            for k, v in vqgan_state_dict_from_jax(tree, VQConfig()).items()}, strict=True)
        again = os.path.join(root, "codec_vars_again.npz")
        save_params_npz(again, vqgan_variables_to_jax(vq.state_dict(), VQConfig()))
        with np.load(npz) as f, np.load(again) as g:
            saved, flat = {k: f[k] for k in f.files}, {k: g[k] for k in g.files}
        bitwise = set(flat) == set(saved) and all(saved[k].dtype == np.float32 and np.array_equal(flat[k], saved[k])
                                                  for k in saved)
        tokens = torch.randint(0, VQConfig().codebook_size, (2, 64, 64), generator=torch.Generator(device="cuda")
                               .manual_seed(82), device="cuda")
        img = vq.decode_indices(tokens)
        print(f"[production] codec_vars.npz: {len(saved)} arrays, {sum(a.nbytes for a in saved.values()) / 1e6:.1f} MB, "
              f"loaded onto the card (the driver's --codec path) and written back "
              f"{'bit for bit' if bitwise else 'NOT bit for bit'}; a decode of seeded tokens "
              f"{tuple(img.shape)} finite: {bool(torch.isfinite(img).all())}; recon L1 of the fixed eval batch "
              f"{codec['init_eval_recon_l1']} at init -> {codec['final_eval_recon_l1']} after {codec['steps']} steps, "
              f"codebook usage {codec['init_codebook_usage']} -> {codec['final_codebook_usage']} ({tag})", flush=True)
        check(bitwise and bool(torch.isfinite(img).all()), "codec_vars.npz does not read back bit for bit")
        del vq, img
        add(codec["launches"])

        # 2. the driver at "1b" with the towers: SIGTERM after the first checkpoint and grid, a fresh resume
        common = ["--workdir", run_dir, "--geometry", "1b", "--adam-moments", "bf16", "--batch", str(PROD_BATCH),
                  "--log-every", "1", "--eval-every", str(PROD_EVAL_EVERY), "--shards", "1", "--per-shard", "32",
                  "--workers", "4", "--codec", npz]
        metrics_path = os.path.join(run_dir, "metrics.jsonl")
        t0 = time.perf_counter()
        with open(os.path.join(root, "driver_a.log"), "w+") as log:
            proc = subprocess.Popen([sys.executable, "-m", "paella_tpu_torch.scripts.run_driver_e2e", *common,
                                     "--steps", "40"], cwd=REPO, stdout=log, stderr=subprocess.STDOUT)
            try:
                deadline = time.time() + 400
                while time.time() < deadline and proc.poll() is None:
                    if os.path.exists(metrics_path) and any("eval_s" in r for r in jsonl(metrics_path)):
                        break
                    time.sleep(0.2)
                check(proc.poll() is None, f"run_driver_e2e ended before its first eval grid: {tail_of(log)}")
                proc.send_signal(signal.SIGTERM)
                rc = proc.wait(timeout=300)
            finally:
                if proc.poll() is None:
                    proc.kill()
                    proc.wait()
            log.seek(0)
            out_a = log.read()
        a_s = time.perf_counter() - t0
        check(rc == 0 and "preemption checkpoint saved" in out_a, f"phase A exited {rc}: {out_a[-3000:]}")
        summary_a = json.loads(out_a.strip().splitlines()[-1])
        show("run_driver_e2e phase A (SIGTERM after the first checkpoint)", summary_a, a_s)
        final_a = summary_a["final_step"]
        steps_b = final_a + 2 - final_a % 2  # the next even step: a grid and a forced save
        summary_b, b_s, out_b = run_script("run_driver_e2e", [*common, "--steps", str(steps_b)],
                                           os.path.join(root, "driver_b.log"), 400)
        show(f"run_driver_e2e phase B (a fresh process resuming to step {steps_b})", summary_b, b_s)
        check(f"resumed at step {final_a}" in out_b and "init skipped" in out_b and summary_b["final_step"] == steps_b,
              f"phase B did not resume from step {final_a}: {out_b[-3000:]}")
        recs = jsonl(metrics_path)
        grids = [r["step"] for r in recs if "eval_s" in r]
        ckpts = sorted(int(s) for s in os.listdir(os.path.join(run_dir, "checkpoints")) if s.isdigit())
        for what, summary, first, last in (("phase A", summary_a, 0, final_a), ("phase B", summary_b, final_a, steps_b)):
            n_grids = sum(first < s <= last for s in grids)
            check_script_launches(f"run_driver_e2e {what}", summary["launches"], {
                **driver_launches(last - first, n_grids), "fused_resblock[int8]": 0, "fused_resblock[w8a8]": 0})
            add(summary["launches"])
        check(all(math.isfinite(r["loss"]) and r["nonfinite_skips"] == 0 for r in recs if "loss" in r),
              "driver losses")
        ms_a, ms_b = driver_steps_ms(recs, 1, final_a), driver_steps_ms(recs, final_a + 1, steps_b)
        saves = [r["checkpoint_s"] for r in recs if "checkpoint_s" in r]
        eval_s = [r["eval_s"] for r in recs if "eval_s" in r]
        restore_s = [r["restore_s"] for r in recs if "restore_s" in r]
        ckpt_bytes = os.path.getsize(os.path.join(run_dir, "checkpoints", str(ckpts[-1]), "state.pt"))
        print(f"[production] driver, bf16 towers: phase A to step {final_a} ({len([s for s in grids if s <= final_a])} "
              f"grid), phase B {final_a} -> {steps_b}; host ms between step records (a save or grid in between counts "
              f"in) A {', '.join(f'{t:.0f}' for t in ms_a)}, B {', '.join(f'{t:.0f}' for t in ms_b)}; checkpoints "
              f"{ckpts} ({ckpt_bytes / 1e9:.2f} GB each) saved in {', '.join(f'{s:.1f}' for s in saves)} s, restored "
              f"in {', '.join(f'{s:.1f}' for s in restore_s)} s; grids at {grids} in "
              f"{', '.join(f'{s:.1f}' for s in eval_s)} s; peak memory A {summary_a['peak_bytes'] / 2**30:.2f} GiB, "
              f"B {summary_b['peak_bytes'] / 2**30:.2f} GiB; data: {summary_a['data']}; launches A "
              f"K1 {summary_a['launches']['fused_resblock[float]']} K3 {summary_a['launches']['gumbel_categorical']} "
              f"K4 {summary_a['launches']['fused_codebook_lookup']}, B K1 {summary_b['launches']['fused_resblock[float]']} "
              f"K3 {summary_b['launches']['gumbel_categorical']} K4 {summary_b['launches']['fused_codebook_lookup']} "
              f"({tag})", flush=True)

        # 3. again with the W8A8 ByT5-XL
        w8a8, w8_s, _ = run_script("run_driver_e2e", [*[w8_dir if a == run_dir else a for a in common], "--byt5", "w8a8",
                                                      "--steps", str(PROD_EVAL_EVERY)],
                                   os.path.join(root, "driver_w8a8.log"), 400)
        show("run_driver_e2e --byt5 w8a8", w8a8, w8_s)
        w_recs = jsonl(os.path.join(w8_dir, "metrics.jsonl"))
        check_script_launches("run_driver_e2e --byt5 w8a8", w8a8["launches"], {
            **driver_launches(PROD_EVAL_EVERY, 1), "fused_resblock[int8]": 0, "fused_resblock[w8a8]": 0})
        check(all(math.isfinite(r["loss"]) for r in w_recs if "loss" in r), "w8a8 driver losses")
        add(w8a8["launches"])
        ms_w = driver_steps_ms(w_recs, 1, PROD_EVAL_EVERY)
        print(f"[production] driver, W8A8 ByT5-XL: step 2 {', '.join(f'{t:.0f}' for t in ms_w)} ms after step 1; peak "
              f"memory {w8a8['peak_bytes'] / 2**30:.2f} GiB ({tag})", flush=True)
        shutil.rmtree(os.path.join(w8_dir, "checkpoints"))

        # 4-5. the eval over the bf16 run's checkpoints
        arms = 1 + len(ckpts)
        gens = arms * GRAPH_PASSES  # each arm's model captures its graph at its first batch, then replays
        ev_common = ["--workdir", run_dir, "--geometry", "1b", "--adam-moments", "bf16", "--byt5", "bf16", "--n",
                     str(PROD_EVAL_N), "--batch", str(PROD_EVAL_BATCH), "--trend", "--codec", npz]
        image, image_s, _ = run_script("run_eval_e2e", [*ev_common, "--real-recon"], os.path.join(root, "eval_image.log"), 400)
        show("run_eval_e2e --trend --real-recon", image, image_s)
        check_script_launches("run_eval_e2e image space", image["launches"], {
            "fused_resblock[float]": gens * STEPS * K1_PER_FORWARD, "fused_resblock[w8a8]": 0, "fused_resblock[int8]": 0,
            "gumbel_categorical": gens * STEPS, "fused_codebook_lookup": PROD_EVAL_N // PROD_EVAL_BATCH,
            "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0})
        check(len(image["arms"]) == arms and all(math.isfinite(a["fid_synthetic_featurizer"]) for a in image["arms"])
              and math.isfinite(image["fid_noise_floor_real_vs_real"]), f"image-space eval {image}")
        add(image["launches"])
        tokens, tokens_s, _ = run_script("run_eval_e2e", [*ev_common, "--space", "tokens", "--w8a8"],
                                         os.path.join(root, "eval_tokens.log"), 500)
        show("run_eval_e2e --trend --space tokens --w8a8", tokens, tokens_s)
        check_script_launches("run_eval_e2e token space with W8A8 twins", tokens["launches"], {
            "fused_resblock[float]": gens * STEPS * K1_PER_FORWARD, "fused_resblock[w8a8]": gens * STEPS * K1_PER_FORWARD,
            "fused_resblock[int8]": 0, "gumbel_categorical": 2 * gens * STEPS,
            "fused_codebook_lookup": PROD_EVAL_N // PROD_EVAL_BATCH, "fused_head_categorical": 0,
            "fused_attention": 0, "fused_attn_block": 0})
        check(len(tokens["arms"]) == 2 * arms and tokens["w8a8"]["levels"] == [0, 1, 2]
              and all(math.isfinite(a["token_frechet"]) and 0 <= a["token_js_to_real"] <= math.log(2) + 1e-6
                      for a in tokens["arms"]), f"token-space eval {tokens}")
        add(tokens["launches"])
        flips = {a["arm"]: a["token_flip_to_bf16_twin"] for a in tokens["arms"] if a["arm"].endswith("-w8a8")}
        print(f"[production] eval over checkpoints {ckpts} (+ init), n {PROD_EVAL_N}, 8 steps, CFG 8: image-space FID "
              f"(seeded featurizer, codec-recon real set; floor {image['fid_noise_floor_real_vs_real']}) "
              + ", ".join(f"{a['arm']} {a['fid_synthetic_featurizer']}" for a in image["arms"])
              + f"; token Fréchet (floor {tokens['token_frechet_floor_real_vs_real']}) / JS to real (floor "
              f"{tokens['token_js_floor_real_vs_real']}) " + ", ".join(
                  f"{a['arm']} {a['token_frechet']} / {a['token_js_to_real']}" for a in tokens["arms"])
              + f"; W8A8 twin token flip rates {flips}; sampling images/s " + ", ".join(
                  f"{a['arm']} {a['sampling_images_per_sec']}" for a in tokens["arms"])
              + f"; peak memory {image['peak_bytes'] / 2**30:.2f} / {tokens['peak_bytes'] / 2**30:.2f} GiB; "
              f"launches K1 {image['launches']['fused_resblock[float]']} + {tokens['launches']['fused_resblock[float]']}, "
              f"K1b (W8A8) {tokens['launches']['fused_resblock[w8a8]']}, K3 {image['launches']['gumbel_categorical']} + "
              f"{tokens['launches']['gumbel_categorical']}, K4 {image['launches']['fused_codebook_lookup']} + "
              f"{tokens['launches']['fused_codebook_lookup']} ({tag})", flush=True)
        return {
            "turns": turns, "codec": codec, "codec_s": codec_s, "codec_npz_bitwise": bitwise,
            "driver": {"phase_a": summary_a, "phase_b": summary_b, "w8a8": w8a8, "step_ms_a": ms_a, "step_ms_b": ms_b,
                       "step_ms_w8a8": ms_w, "checkpoint_s": saves, "restore_s": restore_s, "eval_s": eval_s,
                       "checkpoint_bytes": ckpt_bytes, "run_s": {"a": a_s, "b": b_s, "w8a8": w8_s}},
            "eval": {"image": image, "tokens": tokens, "run_s": {"image": image_s, "tokens": tokens_s}},
            "launches": launches,
        }
    finally:
        shutil.rmtree(root, ignore_errors=True)


EXAMPLE_STEPS = 8  # generate's --steps
EXAMPLE_TRAIN_STEPS, EXAMPLE_TRAIN_BATCH = 4, 8  # train_minimal's --steps and --batch
EXAMPLE_CALLS = ("text_to_image", "inpaint", "outpaint", "img2img", "text_to_image_b", "interpolate", "edited")
# the structures generate's main captures: text_to_image (its second prompt
# replays it), inpaint (a fixed mask), outpaint (another latent shape),
# img2img (init_x) and the edit (cond_reweight)
EXAMPLE_CAPTURES = 5
PROXY_T_VALUES = 5  # quant.w8a8_quality_proxy's noise levels, one float and one W8A8 forward each


def phase_examples(tag: str) -> dict:
    """The JAX repo's examples as the port's entry points
    (paella_tpu_torch/examples/), each main() called in this process as a
    user calls it: generate at full width from seeded full-width files
    (write_entry_checkpoints: the flagship denoiser, VQConfig(), ByT5-XL;
    no CLIP tower, as in the JAX example), 8 steps at 256x256, its six
    calls; train_minimal on the same codec and ByT5-XL files at the
    released v1_byt5_xl() (f32, dropout 0.1), batch 8 at 256x256, 4 steps
    with checkpoints at 2 and 4; eval_quality's W8A8 proxy on the denoiser
    file at a 64x64 latent (K1 against K1b W8A8), the ByT5 proxy with its
    stress arm at the byt5_small_like geometry, and the tiny CLIP demo.
    Every model is freed before the next; the files are removed at the end."""
    import shutil
    import tempfile

    import torch

    from paella_tpu_torch import PaellaPipeline
    from paella_tpu_torch.examples import eval_quality, generate, train_minimal
    from paella_tpu_torch.sampling import graph

    result = {"launches": {}}

    def add(counts: dict) -> None:
        for k, n in counts.items():
            result["launches"][k] = result["launches"].get(k, 0) + n

    d = tempfile.mkdtemp(prefix="paella_examples_")
    tapped = PaellaPipeline._decode_clipped
    try:
        t0 = time.perf_counter()
        paths = write_entry_checkpoints(d, torch.Generator("cuda").manual_seed(31))["paths"]
        print(f"[examples] seeded full-width files written in {time.perf_counter() - t0:.1f} s")

        # generate: the six calls, with the token grids on their way to the decoder
        taps = []
        PaellaPipeline._decode_clipped = lambda self, tokens: (taps.append(tokens), tapped(self, tokens))[1]
        captures = graph.captures
        t0 = time.perf_counter()
        out, launches = counted(lambda: generate.main([
            "--vqgan", paths["vqgan"], "--denoiser", paths["denoiser"], "--byt5", paths["byt5"],
            "--steps", str(EXAMPLE_STEPS), "--out", os.path.join(d, "gen")]))
        gen_s = time.perf_counter() - t0
        PaellaPipeline._decode_clipped = tapped
        captures = graph.captures - captures
        images, ms, pipe = out["images"], out["ms"], out["pipeline"]
        print(f"[examples] generate (build_pipeline from the files + six calls) in {gen_s:.1f} s: "
              + ", ".join(f"{k} {tuple(images[k].shape)} {ms[k]:.1f} ms" for k in EXAMPLE_CALLS)
              + f"; graphs captured {captures}; launches {json.dumps(launches)} ({tag})")
        shapes = {k: tuple(v.shape) for k, v in images.items()}
        want = {k: (1, 256, 256, 3) for k in EXAMPLE_CALLS}
        want.update(outpaint=(1, 256, 512, 3), interpolate=(5, 256, 256, 3))
        check(shapes == want, f"generate shapes {shapes}")
        for k, v in images.items():
            check(bool(torch.isfinite(v).all()) and 0.0 <= v.min().item() <= v.max().item() <= 1.0,
                  f"generate {k}: not finite or outside [0, 1]")
        check(captures == EXAMPLE_CAPTURES, f"generate captured {captures} graphs, want {EXAMPLE_CAPTURES}")
        forwards = GRAPH_PASSES * EXAMPLE_CAPTURES * EXAMPLE_STEPS
        check_launches("generate", launches, {
            "fused_resblock[float]": forwards * K1_PER_FORWARD, "fused_resblock[int8]": 0, "fused_resblock[w8a8]": 0,
            "gumbel_categorical": forwards,
            "fused_codebook_lookup": 6,  # the encodes of inpaint, outpaint and img2img; interpolate's two and its requantization
            "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0})
        # inpaint (the second decode) kept the left half of the latent: the source's tokens there
        keep = torch.zeros(1, 64, 64, dtype=torch.bool, device="cuda")
        keep[:, :, :32] = True
        source = pipe.encode_image_tokens(images["text_to_image"])
        check(torch.equal(taps[1][keep], source[keep]), "generate: inpaint's kept tokens differ from the encoded source")
        print(f"[examples] generate: inpaint's {int(keep.sum())} kept tokens equal the source image's encoded tokens")
        add(launches)
        result["generate"] = {"ms": ms, "s": gen_s, "captures": captures}
        del out, images, pipe, taps, source
        graph.clear()
        torch.cuda.empty_cache()

        # train_minimal: the released v1_byt5_xl() with the frozen ByT5-XL
        workdir = os.path.join(d, "train")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        state, launches = counted(lambda: train_minimal.main([
            "--vqgan", paths["vqgan"], "--byt5", paths["byt5"], "--steps", str(EXAMPLE_TRAIN_STEPS),
            "--batch", str(EXAMPLE_TRAIN_BATCH), "--workdir", workdir]))
        train_s = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2**30
        recs = jsonl(os.path.join(workdir, "metrics.jsonl"))
        losses = [r["loss"] for r in recs if "loss" in r]
        steps_ms = driver_steps_ms(recs, 1, EXAMPLE_TRAIN_STEPS)
        saves = sorted(int(s) for s in os.listdir(os.path.join(workdir, "checkpoints")))
        save_s = [r["checkpoint_s"] for r in recs if "checkpoint_s" in r]
        ckpt_bytes = os.path.getsize(os.path.join(workdir, "checkpoints", str(saves[-1]), "state.pt"))
        print(f"[examples] train_minimal (v1_byt5_xl() f32, frozen ByT5-XL, batch {EXAMPLE_TRAIN_BATCH} at 256x256, "
              f"{EXAMPLE_TRAIN_STEPS} steps) in {train_s:.1f} s: losses {[round(v, 4) for v in losses]}; step ms "
              f"{[round(v, 1) for v in steps_ms]} for steps 2-4 (median {sorted(steps_ms)[len(steps_ms) // 2]:.1f}; step "
              f"3's includes the step-2 save); checkpoints {saves}, {ckpt_bytes / 1e9:.2f} GB each, saved in "
              f"{[round(v, 2) for v in save_s]} s; peak {peak:.2f} GiB; launches {json.dumps(launches)} ({tag})")
        check(int(state.step) == EXAMPLE_TRAIN_STEPS, f"train_minimal ended at step {state.step}")
        check(len(losses) == EXAMPLE_TRAIN_STEPS and all(math.isfinite(v) for v in losses), f"train_minimal losses {losses}")
        check(saves == [2, 4], f"train_minimal checkpoints {saves}, want [2, 4]")
        check_launches("train_minimal", launches, {
            "fused_codebook_lookup": EXAMPLE_TRAIN_STEPS, "fused_resblock": 0, "gumbel_categorical": 0,
            "fused_head_categorical": 0, "fused_attention": 0, "fused_attn_block": 0})
        add(launches)
        result["train_minimal"] = {"s": train_s, "losses": losses, "step_ms": steps_ms, "peak_gib": peak,
                                   "checkpoint_bytes": ckpt_bytes, "checkpoint_s": save_s}
        del state
        torch.cuda.empty_cache()

        # eval_quality: the W8A8 proxy on the denoiser file (K1 vs K1b W8A8, 64x64 latent)
        t0 = time.perf_counter()
        (rows, ok), launches = counted(lambda: eval_quality.main(["--w8a8-proxy", "--ckpt", paths["denoiser"]]))
        proxy_s = time.perf_counter() - t0
        print(f"[examples] eval_quality --w8a8-proxy --ckpt (v1_byt5_xl() bf16 compute, 64x64 latent) in "
              f"{proxy_s:.1f} s: rows {json.dumps(rows)}; verdict {'PASS' if ok else 'FAIL'}; launches "
              f"{json.dumps(launches)} ({tag})")
        check(len(rows) == PROXY_T_VALUES and all(math.isfinite(v) for r in rows for v in r.values()),
              f"W8A8 proxy rows {rows}")
        check_launches("eval_quality --w8a8-proxy", launches, {
            "fused_resblock[float]": PROXY_T_VALUES * K1_PER_FORWARD, "fused_resblock[w8a8]": PROXY_T_VALUES * K1_PER_FORWARD,
            "fused_resblock[int8]": 0, "gumbel_categorical": 0, "fused_codebook_lookup": 0})
        add(launches)
        result["w8a8_proxy"] = {"s": proxy_s, "rows": rows, "pass": ok}
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        (arms, ok), launches = counted(lambda: eval_quality.main(["--byt5-w8a8-proxy", "--stress", "--geometry", "small"]))
        byt5_s = time.perf_counter() - t0
        print(f"[examples] eval_quality --byt5-w8a8-proxy --stress --geometry small in {byt5_s:.1f} s: "
              f"{json.dumps(arms)}; verdict {'PASS' if ok else 'FAIL'}; launches {json.dumps(launches)} ({tag})")
        check(list(arms) == ["synthetic", "synthetic_outliers"], f"ByT5 proxy arms {list(arms)}")
        check(all(math.isfinite(v) for rs in arms.values() for r in rs for v in r.values()), "ByT5 proxy rows not finite")
        check(launches["fused_resblock[float]"] > 0 and launches["fused_resblock[w8a8]"] == 0, "ByT5 proxy launches")
        add(launches)
        result["byt5_proxy"] = {"s": byt5_s, "arms": arms, "pass": ok}
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        demo, launches = counted(lambda: eval_quality.main([]))
        demo_s = time.perf_counter() - t0
        scores = demo["scores"].tolist()
        print(f"[examples] eval_quality tiny demo on the card in {demo_s:.1f} s: CLIP scores {scores}, CLIP-FID "
              f"{demo['fid']}; launches {json.dumps(launches)} ({tag})")
        check(all(math.isfinite(v) for v in scores) and math.isfinite(demo["fid"]), "tiny demo scores")
        check(launches["fused_resblock[float]"] > 0 and launches["gumbel_categorical"] == GRAPH_PASSES * 4,
              "tiny demo launches")
        add(launches)
        result["demo"] = {"s": demo_s, "scores": scores, "fid": demo["fid"]}
        del demo
        graph.clear()
        torch.cuda.empty_cache()
    finally:
        PaellaPipeline._decode_clipped = tapped
        shutil.rmtree(d, ignore_errors=True)
    return result


def free_port() -> int:
    """A free TCP port on 127.0.0.1 (bound, then released for the server)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def tail_of(log) -> str:
    log.flush()
    log.seek(0)
    return log.read()[-3000:]


def phase_k1b(tag: str) -> dict:
    """K1b, both int8 modes, at the flagship's ResBlock shapes: against its
    plain version, run twice, at batch 2 and 8, timed beside the float K1 on
    float weights of the same shape, and in bf16 its device time per
    sub-kernel, products' rate and host time (k1_split)."""
    import torch

    from paella_tpu_torch.kernels.resblock import fused_resblock, resblock_plain

    gen = torch.Generator(device="cuda").manual_seed(17)
    result = {"max_abs_err": 0.0, "modes": {}, "shapes": {}}
    for b, hh, ww, c, with_skip in RESBLOCK_SHAPES:
        cpg = 2 if with_skip else 1
        cases = [("int8", torch.bfloat16), ("w8a8", torch.bfloat16)]
        if (b, hh, ww, c, with_skip) == K1_SHAPE:
            cases.append(("int8", torch.float32))
        for mode, dtype in cases:
            w = random_resblock(c, cpg, dtype, gen, mode)
            w_float = random_resblock(c, cpg, dtype, gen)
            x8 = torch.randn(8, hh, ww, c, generator=gen, device="cuda").to(dtype)
            skip8 = torch.randn(8, hh, ww, c, generator=gen, device="cuda").to(dtype) if with_skip else None
            film8 = (torch.randn(8, 2 * c, generator=gen, device="cuda") * 0.2).to(dtype)
            x, skip, film = x8[:b], None if skip8 is None else skip8[:b], film8[:b]
            run = lambda: fused_resblock(x, w, film=film, skip=skip)  # noqa: E731
            plain = lambda: resblock_plain(x, w, film=film, skip=skip)  # noqa: E731
            got, want, again = run(), plain(), run()
            big = fused_resblock(x8, w, film=film8, skip=skip8)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(got).all()), "K1b output not finite")
            err = (got.float() - want.float()).abs().max().item()
            scale = want.float().abs().max().item()
            equal = (got == want).float().mean().item()
            same, invariant = torch.equal(got, again), torch.equal(big[:b], got)
            ms, plain_ms = alternate(run, plain)
            ms_again, float_ms = alternate(run, lambda: fused_resblock(x, w_float, film=film, skip=skip))
            bd = resblock_bound(x, w, film, skip)
            dname = "f32" if dtype == torch.float32 else "bf16"
            # f32: K1's f32 limit. bf16: K1's 2e-2 of the largest output; in W8A8
            # an s8 code at a rounding tie may round the other way when the f32
            # values before it differ in their last ulp, which moves its row by
            # one quantization step (1/127 of the row's scale)
            limit = 1e-3 if dtype == torch.float32 else 2e-2 * scale
            print(
                f"[K1b] fused_resblock {mode} ({b},{hh},{ww},{c}) skip={with_skip} {dname} + FiLM: max_abs_err "
                f"{err:.3e} (limit {limit:.3e}), elements equal to the plain version's {equal:.6f}; two runs bitwise "
                f"equal: {same}; batch 2 = batch 8[:2]: {invariant}; kernel {ms:.4f} ms (again {ms_again:.4f}), float "
                f"K1 {float_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}) ({tag})"
            )
            check(err <= limit, f"K1b {mode} {dname} ({b},{hh},{ww},{c}) max abs error {err} > {limit}")
            check(dtype == torch.float32 or equal >= 0.99,
                  f"K1b {mode} bf16: {equal} of elements equal to the plain version's < 0.99")
            check(same, f"K1b {mode} gave different outputs on two runs")
            check(invariant, f"K1b {mode}: an image's output depends on its batchmates")
            if dtype == torch.bfloat16:
                result["max_abs_err"] = max(result["max_abs_err"], err)
                split = k1_split(x, w, film, skip, tag)
                result["shapes"].setdefault(mode, {})[f"({b},{hh},{ww},{c}) skip={with_skip}"] = {
                    "ms": ms, "plain_ms": plain_ms, "float_k1_ms": float_ms, "equal_share": equal, **bd, **split}
                if (b, hh, ww, c, with_skip) == K1_SHAPE:
                    result["modes"][mode] = {"ms": ms, "plain_ms": plain_ms, "float_k1_ms": float_ms,
                                             "equal_share": equal, "device_ms": ms_of(split["device_us"]), **bd}
    result.update(result["modes"]["w8a8"])
    return result


@contextlib.contextmanager
def plain_resblocks():
    """Inside: every int8 ResBlock of a model on the card runs K1b's plain
    version (its wrapper would launch the kernel)."""
    from paella_tpu_torch.kernels.resblock import resblock_plain
    from paella_tpu_torch.nn import blocks

    kernel = blocks.fused_resblock
    blocks.fused_resblock = lambda x, w, film=None, skip=None: resblock_plain(x, w, film=film, skip=skip)
    try:
        yield
    finally:
        blocks.fused_resblock = kernel


def phase_int8_e2e(tag: str) -> dict:
    """The int8 inference path at the flagship: every ResBlock quantized
    (quantize_paella_int8 over fuse_eligible_levels with include_first),
    weight-only and W8A8: one CFG forward against the plain versions on the
    card, then PaellaPipeline.text_to_image with the ByT5-XL encoder in the
    same mode, in turns with the bf16 pipeline; the encode alone; the W8A8
    quality proxies."""
    import torch

    from paella_tpu_torch import PaellaPipeline
    from paella_tpu_torch.cond import T5Config, T5Encoder, byt5_batch_encode, pad_bucket
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.quant import (
        fuse_eligible_levels,
        quantize_paella_int8,
        quantize_t5_int8,
        t5_w8a8_quality_proxy,
        w8a8_proxy_verdict,
        w8a8_quality_proxy,
    )
    from paella_tpu_torch.sampling.sampler import merge_cfg_pair

    gen = torch.Generator(device="cuda").manual_seed(9)
    t0 = time.perf_counter()
    model, vq, p_cfg = build_flagship(gen)
    levels = fuse_eligible_levels(p_cfg)
    check(levels == (0, 1, 2), f"fuse_eligible_levels of the flagship: {levels}")
    denoisers = {"bf16": model}
    for mode in ("int8", "w8a8"):
        q = quantize_paella_int8(model, levels=levels, include_first=True)
        q.config = dataclasses.replace(p_cfg, act_quant=mode == "w8a8")
        denoisers[mode] = q
    torch.cuda.synchronize()
    print(f"[int8 e2e] flagship built and quantized at levels {levels} (all 56 ResBlocks) in "
          f"{time.perf_counter() - t0:.1f} s")
    result = {"launches": {}}

    def add_launches(counts):
        for k, n in counts.items():
            result["launches"][k] = result["launches"].get(k, 0) + n

    # one CFG forward per mode: launch counts, and features against the same
    # codes through the plain versions on the card. Both bf16 routes lie about
    # their rounding error from the f32 forward of the same codes (plain
    # versions, f32 activations): the kernels must come within 1.5x the plain
    # bf16 route's distance to it, as in the attention phase.
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
    rel = lambda a, b: ((a.float() - b.float()).norm() / b.float().norm()).item()  # noqa: E731
    for mode in ("int8", "w8a8"):
        qm = denoisers[mode]
        cache = qm.gen_cond_cache(*cache_args, **cache_kw)
        feats, launches = counted(lambda: qm(x, r, return_features=True, cond_cache=cache))
        add_launches(launches)
        check_launches(f"{mode} forward", launches, {
            "fused_resblock[float]": 0, "fused_resblock[int8]": K1_PER_FORWARD if mode == "int8" else 0,
            "fused_resblock[w8a8]": K1_PER_FORWARD if mode == "w8a8" else 0,
        })
        f32.config = dataclasses.replace(qm.config, dtype="float32")
        with plain_resblocks():
            want = qm(x, r, return_features=True, cond_cache=cache)
            ref = f32(x, r, return_features=True,
                      cond_cache=f32.gen_cond_cache(*(t.float() for t in cache_args), **cache_kw))
        err, floor, apart = rel(feats, ref), rel(want, ref), rel(feats, want)
        print(
            f"[int8 e2e] {mode} CFG forward: launches {json.dumps(launches)}; features (2,64,64,{p_cfg.c_out}) "
            f"relative L2 to the f32 forward of the same codes (plain versions): kernels bf16 {err:.3e} (limit 1.5 x "
            f"{floor:.3e}, the plain versions' bf16 route's), kernels to plain bf16 {apart:.3e} apart ({tag})"
        )
        check(bool(torch.isfinite(feats).all()), f"{mode} features not finite")
        check(err <= 1.5 * floor, f"{mode} features {err} from the f32 forward > 1.5 x {floor}")
        result[f"{mode}_feature_rel_l2"] = err
    del f32
    torch.cuda.empty_cache()

    # the ByT5-XL encoder (seeded, bf16) and its two int8 modes
    t1 = time.perf_counter()
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
    torch.cuda.synchronize()
    print(f"[int8 e2e] ByT5-XL encoder (36 layers, d_model 2560) built and quantized in {time.perf_counter() - t1:.1f} s")
    prompt = "a red car on a beach"
    ids, mask = byt5_batch_encode([prompt], max_length=768)
    width = pad_bucket(ids.shape[1])
    ids = torch.nn.functional.pad(torch.from_numpy(ids), (0, width - ids.shape[1])).cuda()
    mask = torch.nn.functional.pad(torch.from_numpy(mask), (0, width - mask.shape[1])).cuda()
    states = {m: enc(ids, mask) for m, enc in encoders.items()}
    # the f32 encoder of the same bf16 weights: how far bf16 rounding alone
    # moves the states (random T5 weights without 1/sqrt(d) scaling attend
    # almost one-hot, so 36 layers magnify any change)
    with torch.device("cuda"):
        t5_f32 = T5Encoder(dataclasses.replace(t5_cfg, dtype="float32"))
    t5_f32.load_state_dict(t5.state_dict())
    ref = t5_f32.eval()(ids, mask)
    del t5_f32
    torch.cuda.synchronize()
    for m, s in states.items():
        check(tuple(s.shape) == (1, width, t5_cfg.d_model) and bool(torch.isfinite(s).all()), f"ByT5 {m} states")
    enc_times = {m: [] for m in encoders}
    for i in range(TIMED_RUNS):
        for m in encoders if i % 2 == 0 else reversed(list(encoders)):
            t2 = time.perf_counter()
            encoders[m](ids, mask)
            torch.cuda.synchronize()
            enc_times[m].append(time.perf_counter() - t2)
    enc_p50 = {m: sorted(v)[TIMED_RUNS // 2] * 1e3 for m, v in enc_times.items()}
    print(
        f"[int8 e2e] ByT5-XL encode, 1 prompt at bucket {width}, in turns: p50 bf16 {enc_p50['bf16']:.2f} ms, int8 "
        f"weight-only {enc_p50['int8']:.2f} ms, W8A8 {enc_p50['w8a8']:.2f} ms over {TIMED_RUNS} runs; states "
        f"relative L2 to the f32 encoder of the same weights: bf16 {rel(states['bf16'], ref):.3e}, int8 "
        f"{rel(states['int8'], ref):.3e}, W8A8 {rel(states['w8a8'], ref):.3e} ({tag})"
    )
    result["byt5_encode_p50_ms"] = enc_p50

    # the pipeline, each mode's denoiser with its encoder
    _, clip_text_fn = flagship_towers(p_cfg, gen)
    pipes = {m: PaellaPipeline(denoisers[m], vq, encoders[m], clip_text_fn=clip_text_fn, text_cache_size=0)
             for m in denoisers}
    s_cfg = SampleConfig(steps=STEPS)

    def generate(m, i):
        return pipes[m].text_to_image([prompt], torch.tensor([[i, 0x1B8]], dtype=torch.int64), config=s_cfg)

    images = {}
    for m in pipes:
        images[m], launches = counted(lambda: generate(m, 42))
        add_launches(launches)
        per_gen = GRAPH_PASSES * K1_PER_FORWARD * STEPS
        check_launches(f"{m} text_to_image", launches, {
            "fused_resblock[float]": per_gen if m == "bf16" else 0, "fused_resblock[int8]": per_gen if m == "int8" else 0,
            "fused_resblock[w8a8]": per_gen if m == "w8a8" else 0,
            "gumbel_categorical": GRAPH_PASSES * STEPS, "fused_head_categorical": 0,
        })
        img = images[m]
        ok = tuple(img.shape) == (1, 256, 256, 3) and bool(torch.isfinite(img).all()) and 0.0 <= img.min().item() <= img.max().item() <= 1.0
        print(f"[int8 e2e] {m} text_to_image ({STEPS} steps, ByT5-XL {m}): launches {json.dumps(launches)}; image "
              f"{tuple(img.shape)} in [0, 1], finite: {ok} ({tag})")
        check(ok, f"{m} text_to_image image")
        generate(m, 1000)  # warm-up
    times = {m: [] for m in pipes}
    for i in range(TIMED_RUNS):  # in turns, the order reversed every other round
        for m in pipes if i % 2 == 0 else reversed(list(pipes)):
            t2 = time.perf_counter()
            generate(m, i).cpu()
            times[m].append(time.perf_counter() - t2)
    p50 = {m: sorted(v)[TIMED_RUNS // 2] * 1e3 for m, v in times.items()}
    print(
        f"[int8 e2e] 256x256 text_to_image, {STEPS} steps CFG, batch 1, ByT5 encode included, in turns: p50 bf16 "
        f"{p50['bf16']:.2f} ms (min {min(times['bf16']) * 1e3:.2f}), int8 weight-only {p50['int8']:.2f} ms (min "
        f"{min(times['int8']) * 1e3:.2f}), W8A8 {p50['w8a8']:.2f} ms (min {min(times['w8a8']) * 1e3:.2f}) over "
        f"{TIMED_RUNS} runs each ({tag})"
    )
    result["text_to_image_p50_ms"] = p50
    del pipes, encoders, states
    torch.cuda.empty_cache()

    # the W8A8 go/no-go proxies at the flagship (random weights: printed,
    # held to finiteness only)
    rows = w8a8_quality_proxy(model, torch.Generator(device="cuda").manual_seed(21))
    t5_rows = t5_w8a8_quality_proxy(t5, model, torch.Generator(device="cuda").manual_seed(22))
    for name, rs in (("denoiser", rows), ("ByT5", t5_rows)):
        check(all(math.isfinite(v) for row in rs for v in row.values()), f"{name} W8A8 proxy rows not finite")
        print(f"[int8 e2e] {name} W8A8 quality proxy rows {json.dumps(rs)}; {w8a8_proxy_verdict(rs)[1]} ({tag})")
    result["proxy_rows"] = {"denoiser": rows, "byt5": t5_rows}
    del model, vq, denoisers, t5
    torch.cuda.empty_cache()
    return result


def graph_conditioning(p_cfg, b: int, gen):
    """CFG conditioning of b images at the flagship's widths (ByT5 64, CLIP
    text and image; the unconditional side without CLIP image), and the
    editing inputs: init_x, a fixed left quarter and a (1, 72) reweight."""
    import torch

    from paella_tpu_torch.sampling import Conditioning

    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    cond = Conditioning(byt5=r(b, BYT5_LEN, p_cfg.byt5_embd), clip=r(b, p_cfg.clip_embd), clip_image=r(b, p_cfg.clip_embd))
    uncond = Conditioning(byt5=r(b, 2, p_cfg.byt5_embd), clip=r(b, p_cfg.clip_embd))
    init_x = torch.randint(0, p_cfg.num_labels, (b,) + LATENT[1:], generator=gen, device="cuda")
    keep = torch.zeros((b,) + LATENT[1:], dtype=torch.bool, device="cuda")
    keep[:, :, :16] = True
    rew = torch.ones(1, BYT5_LEN + 8, device="cuda")
    rew[0, 1:6] = 3.0
    return cond, uncond, dict(init_x=init_x, fixed_mask=keep, fixed_tokens=init_x.flip(0), cond_reweight=rew)


def phase_graph(tag: str) -> dict:
    """The sampler's CUDA graph (sampling/graph.py) at the flagship's full
    width, in the plain, attention and int8 (weight-only, W8A8)
    configurations on the same weights: on both routes at batch 1 and 3,
    with CFG, a conditional cutoff, init_x, a fixed mask and cond_reweight,
    a replay's tokens are the eager body's bit for bit; a second call with
    another cfg, temperature, t_start and renoise_steps captures nothing and
    equals the eager body at those values. Then per configuration, 8-step CFG
    generations at batch 1: graph and eager p50 in turns, a profile of each
    (kernel time by owner, the device's busy share), the kernels of one
    replay by name with their launches, and the graphs' pool bytes."""
    import torch

    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.models import Paella
    from paella_tpu_torch.quant import fuse_eligible_levels, quantize_paella_int8
    from paella_tpu_torch.sampling import graph, sample, sample_eager

    gen = torch.Generator(device="cuda").manual_seed(16)
    base, vq, p_cfg = build_flagship(gen)
    del vq
    with torch.device("cuda"):
        attn = Paella(dataclasses.replace(p_cfg, **ATTN_FLAGS))
    attn.load_state_dict(base.state_dict())
    configs = {"plain": base, "attention": attn.to(torch.bfloat16).eval()}
    for mode in ("int8", "w8a8"):
        q = quantize_paella_int8(base, levels=fuse_eligible_levels(p_cfg), include_first=True)
        q.config = dataclasses.replace(p_cfg, act_quant=mode == "w8a8")
        configs[mode] = q
    inputs = {b: graph_conditioning(p_cfg, b, gen) for b in (1, 3)}
    edit_cfg = dict(steps=4, sampling_conditional_steps=3, t_start=0.8, temperature=(1.0, 0.5), cfg=(8.0, 6.0))
    expect_replay = {"plain": {"K1": 448, "K3": 8, "K5": 0, "K6": 0}, "attention": {"K1": 448, "K3": 8, "K5": 32, "K6": 320},
                     "int8": {"K1": 448, "K3": 8}, "w8a8": {"K1": 448, "K3": 8}}
    result = {}
    for name, model in configs.items():
        t0 = time.perf_counter()
        graph.clear()
        for impl in ("xla", "pallas"):
            for b in (1, 3):
                cond, uncond, extra = inputs[b]
                s_cfg = SampleConfig(**edit_cfg, categorical_impl=impl)
                seeds = torch.tensor([[b, 0x6A]] * b) + torch.arange(b)[:, None]
                want = sample_eager(model, seeds, cond, (b,) + LATENT[1:], uncond, s_cfg, **extra)
                for call in ("first (warm-up, capture)", "second (replay)"):
                    got = sample(model, seeds, cond, (b,) + LATENT[1:], uncond, s_cfg, **extra)
                    check(torch.equal(got, want), f"graph {name} {impl} B {b}: the {call} call's tokens differ from "
                          "the eager body's")
        captured = graph.captures
        cond, uncond, extra = inputs[1]
        other = SampleConfig(steps=4, sampling_conditional_steps=3, t_start=0.6, temperature=(0.8, 0.3), cfg=(5.0, 3.0),
                             renoise_steps=2)
        seeds = torch.tensor([[5, 6]])
        again = sample(model, seeds, cond, LATENT, uncond, other, **extra)
        check(graph.captures == captured, f"graph {name}: new schedule values captured a graph")
        check(torch.equal(again, sample_eager(model, seeds, cond, LATENT, uncond, other, **extra)),
              f"graph {name}: new schedule values give other tokens than the eager body")
        print(f"[graph] {name} config: replays bit for bit the eager body on both routes at B 1 and 3 (CFG, cutoff 3 "
              f"of 4, init_x, fixed mask, cond_reweight); other cfg, temperature, t_start and renoise_steps captured "
              f"nothing ({graph.captures - captured} captures) and equal the eager body ({time.perf_counter() - t0:.1f} s) "
              f"({tag})")

        s_cfg = SampleConfig(steps=STEPS)
        cond, uncond, _ = inputs[1]
        run = {"graph": lambda i: sample(model, torch.tensor([[i, 0x6B]]), cond, LATENT, uncond, s_cfg),
               "eager": lambda i: sample_eager(model, torch.tensor([[i, 0x6B]]), cond, LATENT, uncond, s_cfg)}
        run["graph"](999), run["eager"](999)
        times = {"graph": [], "eager": []}
        for i in range(TIMED_RUNS):  # in turns, the order reversed every other round
            for way in ("graph", "eager") if i % 2 == 0 else ("eager", "graph"):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                run[way](i).cpu()
                times[way].append(time.perf_counter() - t1)
        p50 = {k: sorted(v)[TIMED_RUNS // 2] * 1e3 for k, v in times.items()}
        entry = {"p50_ms": p50, "pool_bytes": graph.pool_bytes()}
        for way in ("graph", "eager"):
            kernels, wall = profile_kernels(lambda: run[way](77))
            groups = group_kernels(kernels, GENERATION_GROUPS)
            busy = sum(us for us, _ in groups.values()) / 1e3
            entry[way] = {"groups_ms": {k: v[0] / 1e3 for k, v in groups.items()},
                          "launches": {k: v[1] for k, v in groups.items()}, "kernels_ms": busy, "wall_ms": wall}
            parts = ", ".join(f"{k} {us / 1e3:.2f} ms ({n:g})" for k, (us, n) in groups.items() if n)
            print(f"[graph] {name} config, profile of one {STEPS}-step CFG generation, {way}: {parts or 'not traced'}; "
                  f"all kernels {busy:.2f} ms of {wall:.2f} ms wall = {busy / wall:.0%} busy ({tag})")
            if way == "graph":
                check(bool(kernels), f"graph {name}: torch.profiler traced no kernel of a replay in 5 tries")
                by_name = {}
                for key, (_, n) in kernels.items():
                    by_name[kernel_name(key)[:48]] = by_name.get(kernel_name(key)[:48], 0) + n
                entry["replay_kernels"] = by_name
                print(f"[graph] {name} config, kernels of one replay by name (launches): {json.dumps(by_name)} ({tag})")
                check_replay("graph", replay_counts(kernels), expect_replay[name], tag)
        print(
            f"[graph] {name} config, 256x256 {STEPS}-step CFG generation, batch 1, tokens only, in turns: p50 graph "
            f"{p50['graph']:.2f} ms (min {min(times['graph']) * 1e3:.2f}), eager {p50['eager']:.2f} ms (min "
            f"{min(times['eager']) * 1e3:.2f}) over {TIMED_RUNS} runs each; graph pools (bytes) "
            f"{json.dumps(entry['pool_bytes'])} ({tag})"
        )
        result[name] = entry
        graph.clear()
    del base, attn, configs
    torch.cuda.empty_cache()
    return result


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
    phase_s = {}

    def timed(fn, *args):
        """fn(*args), its seconds kept under the phase's name."""
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[fn.__name__.removeprefix("phase_")] = round(time.perf_counter() - t0, 1)
        return out

    build = timed(phase_build, tag)
    k1 = timed(phase_k1, tag)
    k2 = timed(phase_k2, tag)
    k3 = timed(phase_k3, tag)
    k4 = timed(phase_k4, tag)
    e2e = timed(phase_e2e, tag)
    pipe = timed(phase_pipeline, tag)
    timed(phase_small_reference, tag)
    k5 = timed(phase_k5, tag)
    k6 = timed(phase_k6, tag)
    attn = timed(phase_attention_e2e, tag)
    served = timed(phase_serve, tag)
    c5 = timed(phase_c5, tag)
    entry_point = timed(phase_entry, tag)
    k1b = timed(phase_k1b, tag)
    int8 = timed(phase_int8_e2e, tag)
    graphs = timed(phase_graph, tag)
    train = timed(phase_train, tag)
    driver = timed(phase_driver, tag, train["step_ms"])
    codec_train = timed(phase_codec_train, tag)
    ddp = timed(phase_ddp, tag)
    fsdp = timed(phase_fsdp, tag)
    production = timed(phase_production, tag)
    examples = timed(phase_examples, tag)
    print(f"[time] seconds by phase: {json.dumps(phase_s)}; {sum(phase_s.values()):.1f} s in all ({tag})")
    launches = {}
    for counts in (e2e["launches"], pipe["launches"], attn["launches"], served["launches"], entry_point["launches"],
                   int8["launches"], train["launches"], driver["launches"], codec_train["launches"], fsdp["launches"],
                   production["launches"], examples["launches"]):
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    def entry(name: str, source: str, replaces: str, res: dict, shape: str, counts=None, **extra) -> dict:
        return {
            "name": name, "route": "cuda", "source": f"paella_tpu_torch/csrc/{source}", "replaces": replaces,
            "launches": sum(launches[k] for k in counts or [name]), "max_abs_err": res["max_abs_err"], "ms": res["ms"], "plain_ms": res["plain_ms"],
            "bound_ms": res["bound_ms"], "bound_by": res["bound_by"], "library_ms": res.get("library_ms"),
            "shape": shape, **extra,
        }

    kernels = [
        entry("fused_resblock", "resblock.cu", "paella_tpu/kernels/resblock.py:316", k1, "x (2,16,16,1280) bf16 + FiLM",
              counts=["fused_resblock[float]"], device_ms=k1["device_ms"]),
        entry("fused_resblock (int8 modes)", "resblock.cu", "paella_tpu/kernels/resblock.py:316 (int8 modes)", k1b,
              "x (2,16,16,1280) bf16 + FiLM, W8A8 (both modes under 'modes')",
              counts=["fused_resblock[int8]", "fused_resblock[w8a8]"], device_ms=k1b["device_ms"], modes=k1b["modes"]),
        entry("fused_head_categorical", "sampling.cu", "paella_tpu/kernels/sampling.py:151", k2,
              "feat (1,64,64,256) x2, W_out (8192,256) bf16; library_ms: the composed route (torch.matmul + K3)",
              device_ms=k2["device_ms"], library_device_ms=k2["library_device_ms"], matmul_ms=k2["matmul_ms"],
              issue_bound_ms=k2["issue_bound_ms"]),
        entry("gumbel_categorical", "sampling.cu", "paella_tpu/kernels/sampling.py:224", k3, "logits (1,64,64,8192) bf16",
              device_ms=k3["device_ms"], issue_bound_ms=k3["issue_bound_ms"]),
        entry("fused_codebook_lookup", "quantize.cu", "paella_tpu/kernels/quantize.py:53", k4,
              "z (1,64,64,4) f32, codebook (8192,4) f32", device_ms=k4["device_ms"], issue_bound_ms=k4["issue_bound_ms"]),
        entry("fused_attention", "attention.cu", "paella_tpu/kernels/attention.py:56", k5,
              "q (2,256,16,80), k/v (2,328,16,80) bf16, masked", device_ms=ms_of(k5["device_us"]["kernel"]),
              library_device_ms=ms_of(k5["device_us"]["sdpa"])),
        entry("fused_attn_block", "attn_block.cu", "paella_tpu/kernels/attn_block.py:178", k6,
              "x (2,16,16,1280), kv (2,72,1280) bf16, 16 heads, masked", device_ms=k6["device_ms"]),
    ]
    print(json.dumps({
        "kernels": kernels, "e2e_p50_ms": e2e["e2e_p50_ms"], "sample_p50_ms": e2e["sample_p50_ms"],
        "pipeline_p50_ms": {name: c["p50_ms"] for name, c in pipe["calls"].items()}, "build_s": build["build_s"],
        "attention_config_p50_ms": attn["p50_ms"], "k5_levels": k5["levels"], "k5_streamed": k5["streamed"], "k5_stage_c": k5["stage_c"], "k6_levels": k6["levels"],
        "serve_http_p50_ms": served["http_p50_ms"], "serve_batch_pixel_share": served["batch_pixel_share"],
        "serve_batch_pixel_share_256x384": served["batch_pixel_share_256x384"],
        "entry": {k: entry_point[k] for k in ("bytes", "write_s", "load_s", "clip_text_p50_ms", "clip_image_p50_ms",
                                        "text_to_image_p50_ms", "serve_up_s", "http_p50_ms", "served_pixel_share",
                                        "clip_cosine", "inception_ms", "inception_images_per_s")},
        "k2_batches": k2["batches"], "k1_shapes": k1["shapes"], "k1b_shapes": k1b["shapes"], "int8_text_to_image_p50_ms": int8["text_to_image_p50_ms"],
        "byt5_encode_p50_ms": int8["byt5_encode_p50_ms"], "k4_cases": k4["cases"],
        "graph": {name: {"p50_ms": g["p50_ms"], "pool_bytes": g["pool_bytes"],
                         "kernels_ms": {w: g[w]["kernels_ms"] for w in ("graph", "eager")},
                         "wall_ms": {w: g[w]["wall_ms"] for w in ("graph", "eager")}} for name, g in graphs.items()},
        "c5": c5, "train": {k: train[k] for k in ("step_ms", "step_ms_all", "images_per_s", "peak_bytes", "loss_first",
                                                  "loss_last", "tflop_per_step", "mfu", "accum_step_ms", "tiny",
                                                  "profile_ms", "busy")},
        "driver": {k: v for k, v in driver.items() if k != "launches"},
        "codec_train": {k: v for k, v in codec_train.items() if k != "launches"}, "ddp": ddp,
        "fsdp": {k: v for k, v in fsdp.items() if k != "launches"},
        "production": {"turns": production["turns"], "codec": production["codec"],
                       "driver": production["driver"], "eval": production["eval"]},
        "examples": {k: v for k, v in examples.items() if k != "launches"}, "phase_s": phase_s,
    }))
    print(tag)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
