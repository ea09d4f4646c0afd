#!/usr/bin/env python3
"""Time the port's CUDA kernels on one NVIDIA GPU, alone or in turns with
another checkout.

    python3 chip_smoke.py [--only GROUP] [--parent DIR]

The card tests hold every kernel to its plain version over many shapes and
every path to the CPU, the plain versions or the uninterrupted run,

    python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py tests/test_torch_cuda_paths.py

This tool holds what it times: each timed kernel's output against its plain
version's on the same inputs, at the card tests' limits (K1 and K1b within
1e-3 in f32 and 2e-2 of the largest output in bf16, K1b's bf16 output also
99% equal; K2's tokens agreeing on 99.9%; K3 and K4 exact; K5 within 1e-5 in
f32 and two bf16 ulps of the largest output in bf16; K6 within 1e-4 in f32
and 2e-2 of the largest output in bf16), and the launches of the flagship's
generation. A result off its limit stops it with a non-zero exit and no
result line.

It builds the five libraries of paella_tpu_torch/csrc in parallel (and
prints ptxas's register, spill and warning lines), then runs each group on
seeded inputs, every line beside the card's name and power limit:

  launches   one counted 8-step CFG generation at the flagship (seeded bf16
             weights, tests/_cuda_flagship.py) in the default config drawing
             through K2, with every ResBlock quantized weight-only and W8A8,
             and in the attention config drawing through K3, and a codec
             encode: each wrapper's launches held to 56 K1 or K1b, 4 K5 and
             40 K6 a forward and one K2 or K3 a step (and K4 once an encode)
  resblock   K1 in f32 and bf16, and K1b (weight-only and W8A8 in bf16,
             weight-only also in f32 at (2,16,16,1280)), at the flagship's
             four CFG batch-2 ResBlock shapes: event ms in turns with the
             plain version, and the bound; in bf16 the device µs per
             sub-kernel (torch.profiler), the two products' rate beside
             torch.matmul's (torch._int_mm's in W8A8), and the host's µs to
             enqueue a call
  sampling   K2 at the flagship step (M 4096) and at batch 8 (M 32768), bf16
             and f32: event ms in turns with the plain version and with the
             composed route (torch.matmul, then K3), device µs of both,
             torch.matmul of the head product alone, the bound and an
             instruction-issue bound from the SASS's draw loop; K3 over
             (1,64,64,8192) logits, bf16 and f32, likewise
  quantize   K4 at the codec's encode (M 4096) against N(0,1) and U(+-1/8192)
             codebooks, at M 8 x 4096 and at C 12: device µs and the kernels
             a call launches, event ms in turns with the plain version, the
             bound and the issue bound of the search loop
  attention  K5 at attention levels 1 and 2 (f32 and bf16) and at S 1036
             (bf16, the streamed ring): event ms in turns with the plain
             version and with F.scaled_dot_product_attention, device µs of
             both; at Stage C's shape (keys from two sources) the design the
             policy picks, the ring forced there and SDPA, device µs beside
             the bound, and both designs forced over K5's sweep (the
             measurement behind the policy); Stage B's levels 2 and 3 (and
             Stage C's shape) with keys from two sources: the policy's
             pick, every design forced in turn (the ring, the resident form
             where K and V fit, the streamed form where K does, each with
             one query tile a block, two, and all of a pair's), each held to
             the plain version, and SDPA; K6 at levels 1 and 2 and a
             ragged case, f32 and bf16, in turns with the plain version, and
             in bf16 the device µs per sub-kernel and its products' rate
             beside torch.matmul's
  tilings    every tiling of K6's two bf16 products at four level shapes:
             device µs a product beside attn_block_plan's pick

Then a JSON line {"kernels": [...]} of the kernels timed (each with its
event ms, its plain version's, its device ms, its bound, its max_abs_err to
the plain version (K2: its token agreement), its launches in one generation
(a replay's; none where the launches group did not run, or for Stage C's
shape, which the flagship does not run) and, where one PyTorch call computes
the same function, that call's ms: PERF.md's table of kernels), the card's
name and power limit, and {"ok": true, "device": ...}.

--only GROUP runs one group. --parent DIR compares this checkout with
another one (the parent commit unpacked by `git archive` into a gitignored
directory, such as build/): four turns in the order parent, change, change,
parent, each a process of its own with that tree's paella_tpu_torch first on
sys.path and this file's measurements, then each device-µs reading's range
per tree. Without a CUDA device the tool exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))
LIBRARIES = ("resblock", "sampling", "quantize", "attention", "attn_block")
GROUPS = ("launches", "resblock", "sampling", "quantize", "attention", "tilings")
MARK = "TURN "  # a turn's readings line in --parent mode
RESBLOCK_SHAPES = [  # (B, H, W, C, skip): the flagship's CFG batch-2 levels
    (2, 32, 32, 640, False),
    (2, 32, 32, 640, True),
    (2, 16, 16, 1280, False),
    (2, 8, 8, 1280, False),
]
K1_SHAPE = (2, 16, 16, 1280, False)  # 31 of the 56 calls per forward
HEAD_C, HEAD_K = 256, 8192  # the flagship's head: c_out 256 -> 8192 labels
# K4's cases: (M, C, codebook); M 4096 is the codec's encode of a 256x256
# image, M 8 x 4096 an 8-frame interpolation; 8192 codes
K4_CASES = [(4096, 4, "N(0,1)"), (4096, 4, "U(+-1/8192)"), (8 * 4096, 4, "N(0,1)"), (4096, 12, "N(0,1)")]
ATTN_LEVELS = [  # (B, N, S_cond, heads, head dim) of attention levels 1 and 2 at CFG batch 2
    (2, 256, 72, 16, 80),  # 16x16 pixels; S_cond = ByT5 64 + CLIP 4 + CLIP-image 4
    (2, 64, 72, 16, 80),  # 8x8
]
# Stage C's AttnBlock at 1024² and CFG batch 8 (B, N pixels, S_cond, heads, head dim): K5's wgmma variant
STAGE_C_ATTN = (8, 576, 85, 32, 64)
# Stage B's AttnBlocks at 1024² and batch 4 (B, N pixels, S_cond, heads): level 2 (K5's streamed form) and
# level 3 (its resident form); and Stage C's shape, where both forms fit
STAGE_B_ATTN = {"Stage B level 2": (4, 1024, 4, 20), "Stage B level 3": (4, 256, 4, 20), "Stage C": (8, 576, 85, 32)}
K5_SWEEP = [(16, 40), (64, 136), (200, 130), (576, 661)]  # (N, S) at D 64, bf16
K5_PAIRS = [(8, 32), (4, 32), (2, 16), (1, 2)]  # (B, H): Stage C at batch 4 and 2 (CFG), Paella's pair, one item
TILING_SHAPES = [  # (name, B, H, W, S_cond, heads, head dim): K6 at CFG batch 2
    ("level 1", 2, 16, 16, 72, 16, 80),
    ("level 2", 2, 8, 8, 72, 16, 80),
    ("256x384 level 2", 2, 8, 12, 72, 16, 80),
    ("384x384 level 2", 2, 12, 12, 72, 16, 80),
]
TILINGS = [(bn, splits) for bn in (128, 64) for splits in (1, 2, 4)]  # (tile width, K splits)


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


def in_turns(a, b, iters: int = 20) -> tuple[float, float]:
    """CUDA-event ms per call of a and of b, each the mean of two readings
    taken a, b, b, a."""
    t = [cuda_time_ms(f, iters) for f in (a, b, b, a)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def roofline_bound(nbytes: float, ops: float, kind: str) -> dict:
    """bound_ms and bound_by of a call that must move `nbytes` (each input
    read once, each output written once) and do `ops` operations of `kind`,
    at the peaks of bench_port/core/roofline.py."""
    from bench_port.core.roofline import HBM_BYTES_S, PEAK_OPS_S, bound_s

    return {"bound_ms": bound_s(nbytes, ops, kind) * 1e3,
            "bound_by": "bytes" if nbytes / HBM_BYTES_S >= ops / PEAK_OPS_S[kind] else "operations"}


def nbytes_of(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def held(what: str, got, want, limit: float) -> float:
    """The max_abs_err of got to want, which must be finite and within
    `limit`."""
    err = (got.float() - want.float()).abs().max().item()
    assert err <= limit, f"{what}: max_abs_err {err:.3e} to the plain version, limit {limit:.3e}"
    return err


def held_in_dtype(what: str, got, want) -> float:
    """K5's limits (tests/test_torch_cuda.py::close_in_dtype): f32 within
    1e-5 + 1e-5 |want| an element, bf16 within two bf16 ulps of the largest
    output."""
    import torch

    if want.dtype == torch.float32:
        err = (got - want).abs()
        assert bool((err <= 1e-5 + 1e-5 * want.abs()).all()), f"{what}: max_abs_err {err.max().item():.3e} over 1e-5"
        return err.max().item()
    return held(what, got, want, 2**-7 * want.float().abs().max().item())


def same_tokens(what: str, got, want) -> float:
    """K3's and K4's indices, which equal the plain version's: max_abs_err 0."""
    assert got.dtype == want.dtype and bool((got == want).all()), f"{what}: indices differ from the plain version's"
    return 0.0


def profile_kernels(fn, runs: int = 1) -> dict:
    """torch.profiler over `runs` calls of fn() after one warm-up: {kernel
    name: (device µs per run, launches per run)}, empty where the tracer
    caught nothing in five tries (said so)."""
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
            for _ in range(runs):
                fn()
            torch.cuda.synchronize()
        for e in prof.key_averages():
            # device events only (kernels, memcpys, memsets): a host op's self
            # device time repeats its kernels' (torch.profiler's own total skips it too)
            if e.device_type == DeviceType.CPU or getattr(e, "is_user_annotation", False):
                continue
            if e.self_device_time_total > 0:
                kernels[e.key] = (e.self_device_time_total / runs, e.count / runs)
        if kernels:
            return kernels
    print("[profile] torch.profiler traced no device activity in 5 tries", flush=True)
    return kernels


def device_us(fn, runs: int = 20) -> float | None:
    """Device time of one fn() call: the sum of its kernels' durations
    (torch.profiler), without the gaps between launches; None where the
    tracer caught nothing."""
    kernels = profile_kernels(fn, runs)
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


def kernel_name(key: str) -> str:
    """A profiler key's kernel name without namespace and template arguments."""
    hit = re.search(r"(\w+_kernel)\b", key)
    return hit.group(1) if hit else key


def entry(name: str, source: str, replaces: str, shape: str, ms: float, plain_ms: float, device_us_: float | None,
          bd: dict, max_abs_err: float | None, **extra) -> dict:
    """One kernel of the final JSON line; measure() adds its launches."""
    return {"name": name, "route": "cuda", "source": f"paella_tpu_torch/csrc/{source}", "replaces": replaces,
            "shape": shape, "ms": ms, "plain_ms": plain_ms, "device_ms": ms_of(device_us_), "max_abs_err": max_abs_err,
            **bd, **extra}


def build(tag: str) -> None:
    from paella_tpu_torch.kernels import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:  # one nvcc per source, all at once
        paths = dict(zip(LIBRARIES, pool.map(_build.build, LIBRARIES)))
    for name, path in paths.items():
        _build.load_library(name)
    print(f"[build] {' + '.join(n + '.cu' for n in LIBRARIES)} built and loaded in {time.perf_counter() - t0:.1f} s ({tag})")
    for name, path in paths.items():
        for ln in path.with_suffix(".log").read_text().splitlines():
            if "registers" in ln or "spill" in ln or "warning" in ln.lower():
                print(f"[build]   {name}: {ln.strip()}")


# ---- issue bounds from the SASS -------------------------------------------------------------

# the first murmur3 multiplier as cuobjdump prints it (a signed 32-bit
# immediate, or hex); a draw has two murmur3 rounds, so two of them
HASH_MULTIPLIER = ("-0x7a143595", "0x85ebca6b")


def sass_loops(name: str, elements, innermost: bool = False) -> dict:
    """Per kernel of the built library csrc/{name}.cu (mangled name): the loop
    (a branch back to an earlier address, cuobjdump -sass) that holds the
    most elements, summed over its instructions by elements(instruction), or
    with `innermost` the loop with the fewest instructions an element (an
    inner loop rather than the loop around it), as (SASS instructions in the
    loop, elements in it)."""
    from torch.utils.cpp_extension import CUDA_HOME

    from paella_tpu_torch.kernels import _build

    exe = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    text = subprocess.run([exe, "-sass", str(_build.library_path(name))], capture_output=True, text=True,
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
                n = int(sum(elements(x) for x in loop))
                if n and (best is None or (len(loop) / n < best[0] / best[1] if innermost else n > best[1])):
                    best = (len(loop), n)
        if best:
            out[chunk.split()[0]] = best
    return out


def sass_draw_loops(name: str) -> dict:
    """sass_loops counting draws: the loop's instructions over its draws is
    the issue cost of one (row, label) element, the loop's own overhead
    shared among them."""
    return sass_loops(name, lambda ins: sum(ins.count(c) for c in HASH_MULTIPLIER) / 2)


def k4_search_cost(ins: str) -> int:
    """Elements in a SASS instruction of K4's search loop: its n - 2 d, one
    FFMA by -2 an element."""
    return int(ins.startswith("FFMA") and ", -2," in ins)


def draw_cost(loops: dict, kernel: str) -> float | None:
    """SASS instructions per element of the first kernel whose mangled name
    holds `kernel` (None where no loop was found)."""
    for fname, (n, elements) in sorted(loops.items()):
        if kernel in fname:
            return n / elements
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


def issue_text(ms: float | None) -> str:
    return "not counted" if ms is None else f"{ms * 1e3:.2f} µs"


# ---- launches: the flagship's generation ------------------------------------------------------

def group_launches(tag: str) -> tuple[list, dict, dict]:
    """One counted 8-step CFG generation at the flagship (tests/_cuda_flagship.py
    holds each to its launches a forward and a step) in the default config
    drawing through K2, with every ResBlock quantized weight-only and W8A8,
    and in the attention config drawing through K3, and one codec encode:
    each kernel's launches in one generation (a replay's: the counts of the
    graph's warm-up and capture over GRAPH_PASSES) and in an encode, by the
    name of its entry in the kernels line."""
    import dataclasses

    import torch

    from paella_tpu_torch.quant import fuse_eligible_levels, quantize_paella_int8

    sys.path.append(os.path.join(REPO, "tests"))  # the path tests' helpers, by their own name as pytest imports them
    from _cuda_flagship import (
        ATTN_FLAGS,
        GRAPH_PASSES,
        build_flagship,
        counted,
        flagship_conditioning,
        flagship_generation,
    )

    seeds = torch.tensor([[42, 0x5EED]], dtype=torch.int64)
    gen = torch.Generator(device="cuda").manual_seed(0)
    model, vq, p_cfg = build_flagship(gen)
    cond, uncond = flagship_conditioning(p_cfg, gen)
    tokens, counts = flagship_generation(model, cond, uncond, seeds, "pallas")
    per_gen = {"fused_resblock": counts["fused_resblock[float]"], "fused_head_categorical": counts["fused_head_categorical"]}
    image = vq.decode_indices(tokens).float().clamp(0.0, 1.0)
    _, encode = counted(lambda: vq.encode(image)[2])
    assert encode["fused_codebook_lookup"] == 1, f"a codec encode launched K4 {encode['fused_codebook_lookup']} times, want 1"
    for mode in ("int8", "w8a8"):
        q = quantize_paella_int8(model, levels=fuse_eligible_levels(p_cfg), include_first=True)
        q.config = dataclasses.replace(p_cfg, act_quant=mode == "w8a8")
        _, counts = flagship_generation(q, cond, uncond, seeds, "pallas", mode=mode)
        per_gen[f"fused_resblock[{mode}]"] = counts[f"fused_resblock[{mode}]"]
        del q
    del model, vq
    torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(7)
    model, _, p_cfg = build_flagship(gen, **ATTN_FLAGS)
    cond, uncond = flagship_conditioning(p_cfg, gen)
    _, counts = flagship_generation(model, cond, uncond, seeds, "xla", attention=True)
    per_gen.update({k: counts[k] for k in ("gumbel_categorical", "fused_attention", "fused_attn_block")})
    per_gen = {k: n // GRAPH_PASSES for k, n in per_gen.items()}
    per_gen["fused_codebook_lookup"] = encode["fused_codebook_lookup"]
    del model
    torch.cuda.empty_cache()
    print(f"[launches] a flagship 8-step CFG generation (a replay's; K4: a codec encode's), each held to its count: "
          f"{json.dumps(per_gen)} ({tag})")
    return [], {}, {"launches_per_generation": per_gen}


# ---- resblock: K1 and K1b ---------------------------------------------------------------------

# K1's and K1b's sub-kernels by name (csrc/resblock.cu), in launch order
K1_PHASES = [("dw+LN", ("dw_ln_kernel",)), ("fc1", ("fc1_",)), ("GRN scale", ("grn_scale_kernel",)),
             ("GRN apply", ("grn_apply_kernel",)), ("requant", ("requant_kernel",)),
             ("fc2 reduce", ("fc2_reduce_kernel",)), ("fc2", ("fc2_",))]


def random_resblock(c: int, cpg: int, dtype, gen, mode: str = "float"):
    """Random ResBlock weights in the kernel's layout; mode "int8" or "w8a8"
    quantizes fc1 and fc2 as quant.quantize_paella_int8 does."""
    import torch

    from paella_tpu_torch.kernels.resblock import prepare_resblock_weights
    from paella_tpu_torch.quant import quantize_dense_int8

    r = lambda *s, std: torch.randn(*s, generator=gen, device="cuda") * std  # noqa: E731
    dw, dw_b, w1, b1 = r(c, cpg, 3, 3, std=0.2), r(c, std=0.1), r(4 * c, c, std=c**-0.5), r(4 * c, std=0.1)
    gamma, beta, w2, b2 = r(4 * c, std=0.2), r(4 * c, std=0.2), r(c, 4 * c, std=(4 * c) ** -0.5), r(c, std=0.1)
    scales = {}
    if mode != "float":
        (w1, s1), (w2, s2) = quantize_dense_int8(w1), quantize_dense_int8(w2)
        scales = dict(fc1_scale=s1, fc2_scale=s2, act_quant=mode == "w8a8")
    return prepare_resblock_weights(dw, dw_b, w1, b1, gamma, beta, w2, b2, dtype, **scales)


def k1_split(x, w, film, skip, tag: str) -> dict:
    """K1's (or, for int8 weights, K1b's) device time per sub-kernel
    (torch.profiler, 10 calls), its two products' rate, the host's time to
    enqueue a call, and one PyTorch call of each product as a yardstick (no
    one PyTorch call is a ResBlock): torch.matmul of the bf16 products
    (weight-only: of the codes widened to bf16 once, outside the timing),
    torch._int_mm of the s8 products (W8A8)."""
    import torch

    from paella_tpu_torch.kernels.resblock import fused_resblock

    b, hh, ww, c = x.shape
    m = b * hh * ww
    label = "K1" if w.mode == "float" else f"K1b {w.mode}"
    call = lambda: fused_resblock(x, w, film=film, skip=skip)  # noqa: E731
    split = group_kernels(profile_kernels(call, runs=10), K1_PHASES)
    parts = ", ".join(f"{k} {us:.2f} ({n:g})" for k, (us, n) in split.items() if n)
    traced = bool(parts)
    dev = sum(us for us, _ in split.values()) if traced else None
    host = host_us(call)
    ops = 8 * m * c * c  # each product: 2 M C 4C
    w1, w2 = w.w1[:, :c], w.w2[:, : 4 * c]
    if w.mode == "w8a8":
        xn = torch.randint(-127, 128, (m, c), device="cuda", dtype=torch.int8)
        h = torch.randint(-127, 128, (m, 4 * c), device="cuda", dtype=torch.int8)
        mm = [cuda_time_ms(lambda: torch._int_mm(xn, w1.t())), cuda_time_ms(lambda: torch._int_mm(h, w2.t()))]
        unit, yard = "TOP/s", "torch._int_mm"
    else:
        xn = torch.randn(m, c, device="cuda").to(torch.bfloat16)
        h = torch.randn(m, 4 * c, device="cuda").to(torch.bfloat16)
        w1, w2 = w1.to(torch.bfloat16), w2.to(torch.bfloat16)
        mm = [cuda_time_ms(lambda: xn @ w1.t()), cuda_time_ms(lambda: h @ w2.t())]
        unit, yard = "TFLOP/s", "torch.matmul"
    fc1_us, fc2_us = (split["fc1"][0], split["fc2"][0] + split["fc2 reduce"][0]) if traced else (None, None)
    rate = lambda us: None if us is None else ops / us / 1e6  # noqa: E731
    text = lambda us: "not traced" if us is None else f"{us:.2f} µs = {rate(us):.1f} {unit}"  # noqa: E731
    print(f"[{label}] ({b},{hh},{ww},{c}) skip={skip is not None} bf16 per sub-kernel, device µs per call (launches): "
          f"{parts or 'not traced'}; all {us_text(dev)} µs on the device, {host:.2f} µs on the host to enqueue a call; "
          f"products, {ops / 1e9:.2f} GOP each: fc1 {text(fc1_us)}, fc2 (+ reduce) {text(fc2_us)}; yardstick {yard} "
          f"{mm[0] * 1e3:.2f} µs = {ops / mm[0] / 1e9:.1f} and {mm[1] * 1e3:.2f} µs = {ops / mm[1] / 1e9:.1f} {unit} ({tag})")
    return {"sub_kernels_us": {k: v[0] for k, v in split.items() if v[1]}, "device_us": dev, "host_us": host,
            "fc1_rate": rate(fc1_us), "fc2_rate": rate(fc2_us), "yardstick_rate": [ops / t / 1e9 for t in mm],
            "rate_unit": unit}


def group_resblock(tag: str) -> tuple[list, dict, dict]:
    """K1 (f32, bf16) and K1b (both modes in bf16, weight-only in f32 at
    K1_SHAPE) at RESBLOCK_SHAPES."""
    import torch

    from paella_tpu_torch.kernels.resblock import fused_resblock, resblock_plain

    gen = torch.Generator(device="cuda").manual_seed(11)
    entries, readings, shapes = [], {}, {}
    for shape in RESBLOCK_SHAPES:
        b, hh, ww, c, with_skip = shape
        cases = [("float", torch.float32), ("float", torch.bfloat16), ("int8", torch.bfloat16), ("w8a8", torch.bfloat16)]
        if shape == K1_SHAPE:
            cases.append(("int8", torch.float32))
        for mode, dtype in cases:
            w = random_resblock(c, 2 if with_skip else 1, dtype, gen, mode)
            x = torch.randn(b, hh, ww, c, generator=gen, device="cuda").to(dtype)
            skip = torch.randn(b, hh, ww, c, generator=gen, device="cuda").to(dtype) if with_skip else None
            film = (torch.randn(b, 2 * c, generator=gen, device="cuda") * 0.2).to(dtype)
            label = "K1" if mode == "float" else f"K1b {mode}"
            dname = "f32" if dtype == torch.float32 else "bf16"
            name = f"{label} ({b},{hh},{ww},{c}) skip={with_skip}"
            got, want = fused_resblock(x, w, film=film, skip=skip), resblock_plain(x, w, film=film, skip=skip)
            err = held(f"{name} {dname}", got, want, 1e-3 if dtype == torch.float32 else 2e-2 * want.float().abs().max().item())
            if mode != "float" and dtype == torch.bfloat16:
                equal = (got == want).float().mean().item()
                assert equal >= 0.99, f"{name} {dname}: {equal:.4f} of the elements equal the plain version's, want 0.99"
            plain_ms, ms = in_turns(lambda: resblock_plain(x, w, film=film, skip=skip),
                                    lambda: fused_resblock(x, w, film=film, skip=skip))
            weights = [v for v in w if isinstance(v, torch.Tensor)]
            kind = "int8" if w.act_quant else ("bf16" if dtype == torch.bfloat16 else "f32")
            # the two products' 16 M C^2 operations (the depthwise conv, LN, GELU
            # and GRN add under 1%) at the rate of the type they run in
            bd = roofline_bound(nbytes_of(x, film, skip, *weights) + nbytes_of(x), 16 * b * hh * ww * c * c, kind)
            print(f"[{label}] fused_resblock ({b},{hh},{ww},{c}) skip={with_skip} {dname} + FiLM: max_abs_err {err:.3e}; "
                  f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (events, in turns), bound {bd['bound_ms']:.4f} ms "
                  f"({bd['bound_by']}) ({tag})")
            if dtype == torch.float32:
                shapes[f"{name} f32"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **bd}
                continue
            split = k1_split(x, w, film, skip, tag)
            shapes[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **bd, **split}
            readings[name] = split["device_us"]
            if shape == K1_SHAPE:
                entries.append(entry("fused_resblock" if mode == "float" else f"fused_resblock[{mode}]", "resblock.cu",
                                     "paella_tpu/kernels/resblock.py:316" + ("" if mode == "float" else " (int8 modes)"),
                                     f"x (2,16,16,1280) bf16 + FiLM{'' if mode == 'float' else ', ' + mode}", ms, plain_ms,
                                     split["device_us"], bd, err))
    return entries, readings, {"k1_shapes": shapes}


# ---- sampling: K2 and K3 ----------------------------------------------------------------------

def head_case(b: int, dtype, gen):
    """A flagship-shaped head call at batch b: seeds on the card (as the
    sampler holds them), features (b, 64, 64, 256) x2, W_out (8192, 256),
    CFG 8, T 0.7."""
    import torch

    seeds = torch.tensor([[0x9E3779B9 + 7 * i, 12345 + i] for i in range(b)], dtype=torch.int64, device="cuda")
    fc = torch.randn(b, 64, 64, HEAD_C, generator=gen, device="cuda").to(dtype)
    fu = torch.randn(b, 64, 64, HEAD_C, generator=gen, device="cuda").to(dtype)
    w_out = (torch.randn(HEAD_K, HEAD_C, generator=gen, device="cuda") * (1.0 / HEAD_K) ** 0.5).to(dtype)
    return (seeds, fc, fu, 8.0, w_out, 0.7)


def group_sampling(tag: str) -> tuple[list, dict, dict]:
    """K2 at batch 1 and 8 and K3 over the flagship's logits, bf16 and f32."""
    import torch

    from paella_tpu_torch.kernels.sampling import (
        fused_head_categorical,
        gumbel_categorical,
        gumbel_categorical_plain,
        head_categorical_plain,
        head_plan,
        step_scalar,
    )
    from paella_tpu_torch.sampling.sampler import draw_tokens

    loops = sass_draw_loops("sampling")
    per_el = {"bf16": draw_cost(loops, "head_wgmma_kernelILb0ELi4E"), "f32": draw_cost(loops, "head_simt_kernelIfLb1ELb0E")}
    print(f"[K2] SASS instructions per drawn element (draw loop / its draws): wgmma path "
          f"{per_el['bf16'] or 'not counted'}, SIMT f32 path {per_el['f32'] or 'not counted'}; "
          f"issue rate {issue_rate() / 1e12:.2f} T thread-instructions/s ({tag})")
    gen = torch.Generator(device="cuda").manual_seed(12)
    entries, readings, batches = [], {}, {}
    for b in (1, 8):
        for dtype in (torch.bfloat16, torch.float32):
            dname = "f32" if dtype == torch.float32 else "bf16"
            args = head_case(b, dtype, gen)
            _, fc, fu, cfg_w, w_out, _ = args
            m = fc.numel() // HEAD_C
            iters = 20 if b == 1 else 5
            kernel = lambda: fused_head_categorical(*args)  # noqa: E731
            composed = lambda: draw_tokens("xla", *args)  # noqa: E731
            got = kernel()
            agree = (got == head_categorical_plain(*args)).float().mean().item()
            assert bool(((got >= 0) & (got < HEAD_K)).all()), f"K2 batch {b} {dname}: tokens out of range"
            assert agree >= 0.999, f"K2 batch {b} {dname}: tokens agree with the plain version on {agree:.6f}, want 0.999"
            p_ms, k_ms = in_turns(lambda: head_categorical_plain(*args), kernel, iters)
            x_ms, k2_ms = in_turns(composed, kernel, iters)
            w = step_scalar(cfg_w, fc.device)
            mixed = (fc.float() * w + fu.float() * (1.0 - w)).to(dtype).reshape(m, HEAD_C)
            mm_ms = cuda_time_ms(lambda: torch.matmul(mixed, w_out.t()), iters)
            dev, x_dev = device_us(kernel), device_us(composed)
            bd = roofline_bound(nbytes_of(fc, fu, w_out) + m * 4, 2 * m * HEAD_C * HEAD_K, dname)
            ib = issue_bound_ms(m * HEAD_K, per_el[dname])
            plan = head_plan(m, HEAD_C, HEAD_K, dtype)
            ms = (k_ms + k2_ms) / 2
            print(f"[K2] fused_head_categorical ({b},64,64,{HEAD_C})x2 x ({HEAD_K},{HEAD_C}) cfg 8 T 0.7 {dname}, M {m}, "
                  f"plan {plan} (blocks sharing a row tile's labels; 0: SIMT): tokens agree {agree:.6f} with the plain "
                  f"version; kernel {ms:.4f} ms (events), device "
                  f"{us_text(dev)} µs; plain {p_ms:.4f} ms; composed route (torch.matmul + K3) {x_ms:.4f} ms, device "
                  f"{us_text(x_dev)} µs; torch.matmul of the head product alone {mm_ms:.4f} ms; bound "
                  f"{bd['bound_ms'] * 1e3:.1f} µs ({bd['bound_by']}), issue bound {issue_text(ib)} ({tag})")
            batches[f"{b}_{dname}"] = {"agree": agree, "ms": ms, "plain_ms": p_ms, "device_ms": ms_of(dev), "library_ms": x_ms,
                                       "library_device_ms": ms_of(x_dev), "matmul_ms": mm_ms, "issue_bound_ms": ib,
                                       "plan": plan, **bd}
            readings[f"K2 batch {b} {dname}"] = dev
            if (b, dtype) == (1, torch.bfloat16):
                entries.append(entry("fused_head_categorical", "sampling.cu", "paella_tpu/kernels/sampling.py:151",
                                     "feat (1,64,64,256) x2, W_out (8192,256) bf16; library_ms: the composed route "
                                     "(torch.matmul + K3)", ms, p_ms, dev, bd, None, agree=agree, library_ms=x_ms,
                                     library_device_ms=ms_of(x_dev), matmul_ms=mm_ms, issue_bound_ms=ib))
            del args, fc, fu, mixed, got
            torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(13)
    seeds = torch.tensor([[0x9E3779B9, 54321]], dtype=torch.int64, device="cuda")
    for dtype in (torch.bfloat16, torch.float32):
        dname = "f32" if dtype == torch.float32 else "bf16"
        per = draw_cost(loops, f"gumbel_kernelI{'13__nv_bfloat16' if dtype == torch.bfloat16 else 'f'}Lb1E")
        logits = (torch.randn(1, 64, 64, HEAD_K, generator=gen, device="cuda") * 2.0).to(dtype)
        kernel = lambda: gumbel_categorical(seeds, logits, 0.7)  # noqa: E731
        err = same_tokens(f"K3 {dname}", kernel(), gumbel_categorical_plain(seeds, logits, 0.7))
        plain_ms, ms = in_turns(lambda: gumbel_categorical_plain(seeds, logits, 0.7), kernel)
        dev = device_us(kernel)
        nbytes = logits.numel() * logits.element_size() + logits.numel() // HEAD_K * 4
        ib = issue_bound_ms(logits.numel(), per)
        # 3 f32 operations a logit (scale by 1/T, add the noise, compare); the
        # hash is integer work and the two logs go to the special-function units
        bd = roofline_bound(nbytes, 3 * logits.numel(), "f32")
        print(f"[K3] gumbel_categorical (1,64,64,{HEAD_K}) T 0.7 {dname}: tokens equal the plain version's; kernel "
              f"{ms:.4f} ms (events), device "
              f"{us_text(dev)} µs, plain {plain_ms:.4f} ms; {nbytes / 1e6:.1f} MB moved, {nbytes / ms / 1e6:.1f} GB/s; "
              f"SASS instructions per element {'not counted' if per is None else f'{per:.2f}'}, bound "
              f"{bd['bound_ms'] * 1e3:.1f} µs ({bd['bound_by']}), issue bound {issue_text(ib)} ({tag})")
        readings[f"K3 {dname}"] = dev
        if dtype == torch.bfloat16:
            entries.append(entry("gumbel_categorical", "sampling.cu", "paella_tpu/kernels/sampling.py:224",
                                 "logits (1,64,64,8192) bf16", ms, plain_ms, dev, bd, err, issue_bound_ms=ib,
                                 per_element=per))
    return entries, readings, {"k2_batches": batches}


# ---- quantize: K4 -----------------------------------------------------------------------------

def group_quantize(tag: str) -> tuple[list, dict, dict]:
    """K4 at K4_CASES."""
    import torch

    from paella_tpu_torch.kernels.quantize import codebook_lookup_plain, fused_codebook_lookup

    loops = sass_loops("quantize", k4_search_cost, innermost=True)
    per_el = {4: draw_cost(loops, "lookup_kernelILi4ELb0E"), 12: draw_cost(loops, "lookup_kernelILi0ELb1E")}
    print(f"[K4] SASS instructions per (token, code) element of the search loop: C 4 {per_el[4] or 'not counted'}, "
          f"C 12 (wide) {per_el[12] or 'not counted'}; issue rate {issue_rate() / 1e12:.2f} T thread-instructions/s ({tag})")
    gen = torch.Generator(device="cuda").manual_seed(14)
    entries, readings, cases = [], {}, {}
    for m, c, cb_name in K4_CASES:
        z = torch.randn(m, c, generator=gen, device="cuda")
        if cb_name == "N(0,1)":
            cb = torch.randn(8192, c, generator=gen, device="cuda")
        else:
            cb = (torch.rand(8192, c, generator=gen, device="cuda") * 2 - 1) / 8192
        kernel = lambda: fused_codebook_lookup(z, cb)  # noqa: E731
        err = same_tokens(f"K4 {m}x{c} {cb_name}", kernel(), codebook_lookup_plain(z, cb))
        kernels = profile_kernels(kernel, runs=20)
        dev = sum(us for us, _ in kernels.values()) if kernels else None
        calls = {kernel_name(k): round(n) for k, (_, n) in kernels.items()}  # rounded: the tracer now and then misses one
        plain_ms, ms = in_turns(lambda: codebook_lookup_plain(z, cb), kernel)
        ib = issue_bound_ms(m * 8192, per_el[c])
        bd = roofline_bound(nbytes_of(z, cb) + m * 4, m * 8192 * 2 * c, "f32")  # C products, C - 1 sums and n - 2 d
        print(f"[K4] fused_codebook_lookup z ({m},{c}) vs {cb_name} codebook (8192,{c}) f32: indices equal the plain "
              f"version's; device µs a call "
              f"{us_text(dev)}, kernels a call {json.dumps(calls)}; events {ms:.4f} ms, plain {plain_ms:.4f} ms; bound "
              f"{bd['bound_ms'] * 1e3:.2f} µs ({bd['bound_by']}), issue bound {issue_text(ib)} ({tag})")
        name = f"K4 {m}x{c} {cb_name}"
        cases[name] = {"device_us": dev, "ms": ms, "plain_ms": plain_ms, "issue_bound_ms": ib, **bd}
        readings[name] = dev
        if (m, c, cb_name) == K4_CASES[0]:
            entries.append(entry("fused_codebook_lookup", "quantize.cu", "paella_tpu/kernels/quantize.py:53",
                                 "z (1,64,64,4) f32, codebook (8192,4) f32", ms, plain_ms, dev, bd, err, issue_bound_ms=ib,
                                 per_element=per_el[c]))
        del z, cb
    return entries, readings, {"k4_cases": cases}


# ---- attention: K5 and K6 ---------------------------------------------------------------------

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


def sdpa_call(q, k, v, mask):
    """One PyTorch call of K5's function, the yardstick (timed only): scaled
    dot product attention with the mask as an additive -1e9."""
    import torch
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    add = None
    if mask is not None:
        add = torch.zeros(q.shape[0], 1, 1, k.shape[1], device="cuda", dtype=q.dtype).masked_fill(~mask[:, None, None, :], -1e9)
    return lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=add)


def k5_timings(gen, tag: str) -> tuple[list, dict, dict]:
    """K5 at the levels and the streamed S 1036, then at Stage C's shape and
    over the sweep."""
    import torch

    from paella_tpu_torch.kernels import attention as k5

    entries, readings, out = [], {}, {"levels": {}}
    cases = [(f"level {i}", shape, dt) for i, shape in enumerate(ATTN_LEVELS, start=1)
             for dt in (torch.float32, torch.bfloat16)]
    cases.append(("streamed", (2, 256, 780, 16, 80), torch.bfloat16))  # S 1036: more keys than stay resident
    for name, (b, n, s_c, h, d), dtype in cases:
        s = n + s_c
        if name == "streamed":
            mask = torch.ones(b, s, dtype=torch.bool, device="cuda")
            mask[1, n + 2 :] = False
        else:
            _, mask = attention_masks(b, n, s_c, gen)
        q, k, v = (torch.randn(b, ln, h, d, generator=gen, device="cuda").to(dtype) for ln in (n, s, s))
        call = lambda: k5.fused_attention(q, k, v, mask)  # noqa: E731
        dname = "f32" if dtype == torch.float32 else "bf16"
        err = held_in_dtype(f"K5 {name} {dname}", call(), k5.attention_plain(q, k, v, mask))
        plain_ms, ms = in_turns(lambda: k5.attention_plain(q, k, v, mask), call)
        flops = 4 * b * h * n * s * d
        text = (f"[K5] fused_attention {name} q ({b},{n},{h},{d}) k/v ({b},{s},{h},{d}) masked {dname}: max_abs_err "
                f"{err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (events, in turns); {flops / 1e9:.3f} GFLOP = "
                f"{flops / ms / 1e9:.2f} TFLOP/s")
        if dtype == torch.float32:
            print(f"{text} ({tag})")
            out["levels"][f"{name} f32"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
            continue
        sdpa = sdpa_call(q, k, v, mask)
        library_ms, _ = in_turns(sdpa, call)
        dev = {"kernel": device_us(call), "sdpa": device_us(sdpa)}
        bd = roofline_bound(nbytes_of(q, k, v, mask) + nbytes_of(q), flops, "bf16")  # QK^T and PV once each
        print(f"{text}; SDPA {library_ms:.4f} ms (in turns); device µs a call {us_text(dev['kernel'])} vs SDPA "
              f"{us_text(dev['sdpa'])}; bound {bd['bound_ms'] * 1e3:.1f} µs ({bd['bound_by']}) ({tag})")
        out["levels"][name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "library_ms": library_ms,
                               "device_us": dev, **bd}
        readings[f"K5 {name}"] = dev["kernel"]
        if name == "level 1":
            entries.append(entry("fused_attention", "attention.cu", "paella_tpu/kernels/attention.py:56",
                                 "q (2,256,16,80), k/v (2,328,16,80) bf16, masked", ms, plain_ms, dev["kernel"], bd, err,
                                 library_ms=library_ms, library_device_ms=ms_of(dev["sdpa"])))

    # Stage C: q, k, v as the three views of one (B, N, 3C) q|k|v product and k2, v2 as
    # the two of a (B, S_cond, 2C) cond cache entry, as StageC._attend hands them to K5
    bf16 = torch.bfloat16
    b, n, s_c, h, d = STAGE_C_ATTN
    s, c = n + s_c, h * d
    designs = {"stage_c": k5.attention_design(b, n, s, h, d, bf16), "level1": k5.attention_design(2, 256, 328, 16, 80, bf16),
               "level2": k5.attention_design(2, 64, 136, 16, 80, bf16),
               "streamed": k5.attention_design(2, 256, 1036, 16, 80, bf16)}
    print(f"[K5] design by shape (name, query tiles a block): {json.dumps(designs)} ({tag})")
    qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda").to(bf16)
    kv = torch.randn(b, s_c, 2 * c, generator=gen, device="cuda").to(bf16)
    q, k, v = (t.reshape(b, n, h, d) for t in qkv.split(c, dim=-1))
    k2, v2 = (t.reshape(b, s_c, h, d) for t in kv.split(c, dim=-1))
    call = lambda: k5.fused_attention(q, k, v, k2=k2, v2=v2)  # noqa: E731
    ring = lambda: k5._launch(q, k, v, None, k2, v2, 0)  # noqa: E731
    want = k5.attention_plain(q, k, v, None, k2, v2)
    err = held_in_dtype(f"K5 Stage C {designs['stage_c'][0]}", call(), want)
    ring_err = held_in_dtype("K5 Stage C, the ring forced", ring(), want)
    del want
    plain_ms, ms = in_turns(lambda: k5.attention_plain(q, k, v, None, k2, v2), call)
    sdpa = sdpa_call(q, torch.cat([k, k2], dim=1), torch.cat([v, v2], dim=1), None)
    library_ms, _ = in_turns(sdpa, call)
    dev = {"kernel": device_us(call), "ring": device_us(ring), "sdpa": device_us(sdpa)}
    flops = 4 * b * h * n * s * d
    bd = roofline_bound(nbytes_of(q, k, v, k2, v2) + nbytes_of(q), flops, "bf16")
    print(f"[K5] Stage C q ({b},{n},{h},{d}) k/v ({b},{n}+{s_c},{h},{d}) from two sources bf16: max_abs_err {err:.3e}, "
          f"the ring forced {ring_err:.3e}; device µs a call: "
          f"{designs['stage_c'][0]} {us_text(dev['kernel'])}, the ring forced {us_text(dev['ring'])}, SDPA "
          f"{us_text(dev['sdpa'])}; bound {bd['bound_ms'] * 1e3:.1f} µs ({bd['bound_by']}, {flops / 1e9:.2f} GFLOP); "
          f"event ms: kernel {ms:.4f}, plain {plain_ms:.4f}, SDPA {library_ms:.4f} ({tag})")
    readings["K5 Stage C"], readings["K5 Stage C ring"] = dev["kernel"], dev["ring"]
    entries.append(entry("fused_attention (Stage C)", "attention.cu", "paella_tpu/kernels/attention.py:56",
                         "q (8,576,32,64), k/v (8,576+85,32,64) from two sources bf16", ms, plain_ms, dev["kernel"], bd,
                         err, ring_max_abs_err=ring_err, library_ms=library_ms, library_device_ms=ms_of(dev["sdpa"]), ring_device_ms=ms_of(dev["ring"])))
    del qkv, kv, q, k, v, k2, v2
    sweep = {}
    for b_x, h_x in K5_PAIRS:
        for n_x, s_x in K5_SWEEP:
            qx, kx, vx = (torch.randn(b_x, ln, h_x, 64, generator=gen, device="cuda").to(bf16) for ln in (n_x, s_x, s_x))
            runs = {f"wgmma x{z}" if z else "ring": (lambda z=z: k5._launch(qx, kx, vx, None, None, None, z))
                    for z in sorted({0, 1, -(-n_x // 192)})}
            want = k5.attention_plain(qx, kx, vx)
            for name, fn in runs.items():
                held_in_dtype(f"K5 B{b_x}H{h_x} {n_x}x{s_x} {name}", fn(), want)
            times = {name: device_us(fn) for name, fn in runs.items()}
            sweep[f"B{b_x}H{h_x} {n_x}x{s_x}"] = {"policy": k5.attention_design(b_x, n_x, s_x, h_x, 64, bf16), **times}
            readings.update({f"K5 B{b_x}H{h_x} {n_x}x{s_x} {name}": us for name, us in times.items()})
    print(f"[K5] both designs forced, D 64 bf16, device µs a call by (B, H, N x S) and design (x: query tiles a block): "
          f"{json.dumps(sweep)} ({tag})")
    out["stage_c"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, "ring_max_abs_err": ring_err,
                      "library_ms": library_ms, "device_us": dev, "designs": designs,
                      "designs_us": sweep, **bd}
    r, out["stage_b"] = k5_stage_b(gen, tag)
    readings.update(r)
    return entries, readings, out


def k5_stage_b(gen, tag: str) -> tuple[dict, dict]:
    """K5 at STAGE_B_ATTN, q|k|v of one product and the cond's k|v of
    another as the model hands them over: the policy's pick and every design
    forced, device µs a call, each output held to the plain version; SDPA
    on the concatenated keys. A tree without the streamed form (a --parent
    turn) times the rest."""
    import torch

    from paella_tpu_torch.kernels import attention as k5

    bf16, readings, out = torch.bfloat16, {}, {}
    streamed = hasattr(k5, "design_code")
    for label, (b, n, s_c, h) in STAGE_B_ATTN.items():
        s, c = n + s_c, h * 64
        qkv = torch.randn(b, n, 3 * c, generator=gen, device="cuda").to(bf16)
        kv = torch.randn(b, s_c, 2 * c, generator=gen, device="cuda").to(bf16)
        q, k, v = (t.reshape(b, n, h, 64) for t in qkv.split(c, dim=-1))
        k2, v2 = (t.reshape(b, s_c, h, 64) for t in kv.split(c, dim=-1))
        want = k5.attention_plain(q, k, v, None, k2, v2)
        tiles = -(-n // 192)
        codes = {"policy": -1, "ring": 0}
        if s <= 768:
            codes.update({f"wgmma x{z}": z for z in sorted({1, 2, tiles})})
        if streamed and s <= 1536:
            codes.update({f"streamed x{z}": k5.design_code("streamed", z) for z in sorted({1, 2, tiles})})
        times = {}
        for name, code in codes.items():
            fn = lambda code=code: k5._launch(q, k, v, None, k2, v2, code)  # noqa: E731
            held_in_dtype(f"K5 {label} {name}", fn(), want)
            times[name] = device_us(fn)
        kt, vt = torch.cat([k, k2], dim=1), torch.cat([v, v2], dim=1)
        times["SDPA"] = device_us(sdpa_call(q, kt, vt, None))
        flops = 4 * b * h * n * s * 64
        bd = roofline_bound(nbytes_of(q, k, v, k2, v2) + nbytes_of(q), flops, "bf16")
        policy = k5.attention_design(b, n, s, h, 64, bf16)
        print(f"[K5] {label} q ({b},{n},{h},64) k/v ({b},{n}+{s_c},{h},64) from two sources bf16: the policy "
              f"takes {policy}; device µs a call {json.dumps({key: us for key, us in times.items()})}; bound "
              f"{bd['bound_ms'] * 1e3:.1f} µs ({bd['bound_by']}) ({tag})", flush=True)
        readings.update({f"K5 {label} {name}": us for name, us in times.items()})
        out[label] = {"policy": policy, "device_us": times, **bd}
        del qkv, kv, q, k, v, k2, v2, want, kt, vt
    return readings, out


def kernel_sequence(fn, runs: int = 10) -> list:
    """torch.profiler over `runs` calls of fn() after one warm-up: the
    kernels of one call in launch order, [(short name, device µs averaged
    over the runs)]. Two more calls open the traced window, whose first
    events the trace may drop; the last `runs` calls, which must launch the
    same kernels each, are read."""
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
        print(f"[profile] torch.profiler traced no repeating kernel sequence in 5 tries ({len(events)} events)", flush=True)
        return []
    last = events[-per * runs:]
    seq = []
    for i in range(per):
        name = names[-per + i].replace("(anonymous namespace)::", "").replace("void ", "")
        short = re.sub(r"^.*::", "", re.sub(r"\(.*$", "", name))
        seq.append((short, sum(last[r * per + i].time_range.elapsed_us() for r in range(runs)) / runs))
    return seq


def k6_roles(seq: list) -> list:
    """Each K6 kernel's role in launch order: LN, the q|k|v and o products
    (a split's reduce joins its product) and attention: [(role, µs)]."""
    roles, products = [], iter(["q|k|v", "o"])
    for name, us in seq:
        if "reduce" in name:
            roles[-1] = (roles[-1][0], roles[-1][1] + us)
        elif "linear" in name:
            roles.append((next(products), us))
        else:
            roles.append(("LN" if "ln_rows" in name else "attention", us))
    return roles


def k6_split(x, kv, w, nhead: int, cmask, tag: str, label: str) -> dict:
    """K6's device µs per sub-kernel (torch.profiler, 10 calls), each
    product's TFLOP/s (q|k|v: the (B*S, 3C) product it runs, the cond rows'
    q included), and torch.matmul of the same bf16 products as a yardstick."""
    import torch

    from paella_tpu_torch.kernels.attn_block import fused_attn_block

    roles = k6_roles(kernel_sequence(lambda: fused_attn_block(x, kv, w, nhead, cmask)))
    b, hh, ww, c = x.shape
    n, s = hh * ww, hh * ww + kv.shape[1]
    flops = {"q|k|v": 6 * b * s * c * c, "o": 2 * b * n * c * c}
    rows = torch.randn(b * s, c, device="cuda").to(x.dtype)
    mm = {"q|k|v": cuda_time_ms(lambda: rows @ w.wqkv.t()), "o": cuda_time_ms(lambda: rows[: b * n] @ w.wo.t())}
    dev = sum(us for _, us in roles) if roles else None
    rates = ", ".join(f"{r} {flops[r] / us / 1e6:.1f} (matmul {flops[r] / mm[r] / 1e9:.1f})" for r, us in roles if r in flops)
    print(f"[K6] {label} bf16 per sub-kernel, device µs per call in launch order: "
          f"{', '.join(f'{r} {us:.2f}' for r, us in roles) or 'not traced'}; all {us_text(dev)} µs on the device; "
          f"products TFLOP/s (torch.matmul of the same bf16 product): {rates} ({tag})")
    return {"sub_kernels_us": dict(roles), "device_us": dev,
            "product_tflops": {r: flops[r] / us / 1e6 for r, us in roles if r in flops},
            "matmul_tflops": {r: flops[r] / mm[r] / 1e9 for r, _ in roles if r in flops}}


def random_attn_block(c: int, h: int, dtype, gen):
    import torch

    from paella_tpu_torch.kernels.attn_block import prepare_attn_block_weights

    r = lambda *shape, std: torch.randn(*shape, generator=gen, device="cuda") * std  # noqa: E731
    return prepare_attn_block_weights(r(3 * c, c, std=c**-0.5), r(3 * c, std=0.05), r(c, c, std=c**-0.5), r(c, std=0.05),
                                      dtype, h)


def k6_timings(tag: str) -> tuple[list, dict, dict]:
    """K6 at the levels (the CFG pair's mask) and a ragged case (N 81, S_cond 7)."""
    import torch

    from paella_tpu_torch.kernels.attn_block import attn_block_plain, fused_attn_block

    gen = torch.Generator(device="cuda").manual_seed(16)
    entries, readings, levels = [], {}, {}
    cases = [(f"level {i}", shape) for i, shape in enumerate(ATTN_LEVELS, start=1)] + [("ragged", (2, 81, 7, 16, 80))]
    for name, (b, n, s_c, h, d) in cases:
        c, side = h * d, int(n**0.5)
        if name == "ragged":
            cmask = torch.rand(b, s_c, generator=gen, device="cuda") < 0.7
            cmask[:, 0] = True
        else:
            cmask, _ = attention_masks(b, n, s_c, gen)
        for dtype in (torch.float32, torch.bfloat16):
            w = random_attn_block(c, h, dtype, gen)
            x = torch.randn(b, side, side, c, generator=gen, device="cuda").to(dtype)
            kv = torch.randn(b, s_c, c, generator=gen, device="cuda").to(dtype)
            dname = "f32" if dtype == torch.float32 else "bf16"
            want = attn_block_plain(x, kv, w, h, cmask)
            err = held(f"K6 {name} {dname}", fused_attn_block(x, kv, w, h, cmask), want,
                       1e-4 if dtype == torch.float32 else 2e-2 * want.float().abs().max().item())
            plain_ms, ms = in_turns(lambda: attn_block_plain(x, kv, w, h, cmask), lambda: fused_attn_block(x, kv, w, h, cmask))
            flops = 2 * c * c * (2 * b * n + 2 * b * (n + s_c)) + 4 * b * h * n * (n + s_c) * d
            print(f"[K6] fused_attn_block {name} x ({b},{side},{side},{c}) kv ({b},{s_c},{c}) {h} heads masked {dname}: "
                  f"max_abs_err {err:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms (events, in turns); "
                  f"{flops / 1e9:.3f} GFLOP = {flops / ms / 1e9:.2f} TFLOP/s ({tag})")
            if dtype == torch.float32 or name == "ragged":
                levels[f"{name} {dname}"] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err}
                continue
            weights = [t for t in w if isinstance(t, torch.Tensor)]
            split = k6_split(x, kv, w, h, cmask, tag, name)
            bd = roofline_bound(nbytes_of(x, kv, cmask, *weights) + nbytes_of(x), flops, "bf16")
            levels[name] = {"ms": ms, "plain_ms": plain_ms, "max_abs_err": err, **split, **bd}
            readings[f"K6 {name}"] = split["device_us"]
            if name == "level 1":
                entries.append(entry("fused_attn_block", "attn_block.cu", "paella_tpu/kernels/attn_block.py:178",
                                     "x (2,16,16,1280), kv (2,72,1280) bf16, 16 heads, masked", ms, plain_ms,
                                     split["device_us"], bd, err))
    return entries, readings, {"k6_levels": levels}


def group_attention(tag: str) -> tuple[list, dict, dict]:
    import torch

    e5, r5, k5 = k5_timings(torch.Generator(device="cuda").manual_seed(15), tag)
    e6, r6, k6 = k6_timings(tag)
    return e5 + e6, {**r5, **r6}, {"k5": k5, **k6}


# ---- tilings: every K6 tiling -----------------------------------------------------------------

def group_tilings(tag: str) -> tuple[list, dict, dict]:
    """Each q|k|v tiling and each o tiling of K6's bf16 products at
    TILING_SHAPES (each q|k|v tiling paired with the next one for the
    o-projection, so each runs once a product) through the kernel's launcher,
    device µs a product (a split's reduce joined to it); then per product the
    plan's pick, the fastest tiling and the pick's time over the fastest."""
    import torch

    from paella_tpu_torch.kernels import attn_block as kblk

    gen = torch.Generator(device="cuda").manual_seed(62)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    readings, report = {}, {}
    for name, b, hh, ww, s_c, h, d in TILING_SHAPES:
        c, n = h * d, hh * ww
        w = random_attn_block(c, h, torch.bfloat16, gen)
        x = torch.randn(b, hh, ww, c, generator=gen, device="cuda").to(torch.bfloat16)
        kv = torch.randn(b, s_c, c, generator=gen, device="cuda").to(torch.bfloat16)
        cmask = torch.rand(b, s_c, generator=gen, device="cuda") < 0.7
        cmask[:, 0] = True
        times = {"q|k|v": {}, "o": {}}
        want = kblk.attn_block_plain(x, kv, w, h, cmask)
        for (bn, sp), (bn_o, sp_o) in zip(TILINGS, TILINGS[1:] + TILINGS[:1]):
            plan = kblk.AttnBlockPlan(bn, sp, bn_o, sp_o)
            held(f"K6 {name} tiling {plan}", kblk._launch(x, kv, w, h, cmask, plan), want,
                 2e-2 * want.float().abs().max().item())
            roles = dict(k6_roles(kernel_sequence(lambda: kblk._launch(x, kv, w, h, cmask, plan))))
            times["q|k|v"][(bn, sp)], times["o"][(bn_o, sp_o)] = roles.get("q|k|v"), roles.get("o")
        pick = kblk.attn_block_plan(n, s_c, c, h, torch.bfloat16, n_sm)
        picks = {"q|k|v": (pick.bn_qkv, pick.splits_qkv), "o": (pick.bn_o, pick.splits_o)}
        report[name] = {}
        for product, by_tiling in times.items():
            traced = {t: us for t, us in by_tiling.items() if us is not None}
            best = min(traced, key=traced.get) if traced else None
            ratio = traced[picks[product]] / traced[best] if best and picks[product] in traced else None
            print(f"[K6 tilings] {name} {product}, device µs by (tile width, splits): "
                  + ", ".join(f"{t} {us_text(us)}" for t, us in by_tiling.items())
                  + f"; attn_block_plan picks {picks[product]}, fastest {best}, pick / fastest "
                  f"{'n/a' if ratio is None else f'{ratio:.3f}'} ({tag})")
            report[name][product] = {"us": {f"{bn}x{sp}": us for (bn, sp), us in by_tiling.items()},
                                     "pick": list(picks[product]), "fastest": best and list(best),
                                     "pick_over_fastest": ratio}
            readings.update({f"K6 {name} {product} {bn}x{sp}": us for (bn, sp), us in by_tiling.items()})
    return [], readings, {"k6_tilings": report}


def measure(only: str | None, tag: str) -> tuple[list, dict, dict]:
    """Every group (or `only`): (kernel entries, device-µs readings, details)."""
    fns = {"launches": group_launches, "resblock": group_resblock, "sampling": group_sampling,
           "quantize": group_quantize, "attention": group_attention, "tilings": group_tilings}
    entries, readings, details = [], {}, {}
    for name in GROUPS if only is None else (only,):
        e, r, d = fns[name](tag)
        entries += e
        readings.update(r)
        details.update(d)
    per_gen = details.get("launches_per_generation", {})
    for e in entries:
        e["launches"] = per_gen.get(e["name"])
    return entries, readings, details


def setup(tree: str) -> str | None:
    """The card's tag, with `tree`'s paella_tpu_torch importable and its
    libraries built; None (said on stderr) where it cannot run."""
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on an NVIDIA GPU", file=sys.stderr)
        return None
    try:
        import bench_port.core.roofline  # noqa: F401  (this checkout's, before another tree goes on sys.path)
    except ImportError as e:
        print(f"chip_smoke: bench_port is not beside this script ({e})", file=sys.stderr)
        return None
    sys.path.insert(0, tree)
    try:
        import paella_tpu_torch
    except ImportError as e:
        print(f"chip_smoke: the port's package is not in {tree} ({e})", file=sys.stderr)
        return None
    if not os.path.abspath(paella_tpu_torch.__file__).startswith(os.path.join(tree, "")):
        print(f"chip_smoke: paella_tpu_torch comes from {paella_tpu_torch.__file__}, not {tree}", file=sys.stderr)
        return None
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    tag = card()
    build(tag)
    return tag


def compare(parent: str, only: str | None) -> int:
    """Four turns, parent, change, change, parent, each a process of its own;
    each turn's readings, then each reading's range per tree."""
    runs = []
    for tree in (parent, REPO, REPO, parent):
        cmd = [sys.executable, os.path.abspath(__file__), "--turn", tree, *(["--only", only] if only else [])]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        lines = [ln[len(MARK):] for ln in proc.stdout.splitlines() if ln.startswith(MARK)]
        if proc.returncode != 0 or not lines:
            print(proc.stdout[-4000:], proc.stderr[-4000:], file=sys.stderr)
            return 1
        runs.append(json.loads(lines[-1]))
        print(lines[-1], flush=True)
    tag = runs[0].pop("card")
    for r in runs[1:]:
        r.pop("card")
    for key in dict.fromkeys([*runs[1], *runs[0]]):
        p, ch = [runs[0].get(key), runs[3].get(key)], [runs[1].get(key), runs[2].get(key)]
        if None in p + ch:
            print(f"{key}: not traced in every turn (parent {p}, change {ch})")
            continue
        print(f"{key}: parent {min(p):.2f}-{max(p):.2f} µs, change {min(ch):.2f}-{max(ch):.2f} µs, "
              f"change / parent {max(ch) / min(p):.3f} at most ({tag})")
    print(tag)
    return 0


def main(argv: list) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Time the port's CUDA kernels (see the module's docstring).")
    ap.add_argument("--only", choices=GROUPS, help="time one group")
    ap.add_argument("--parent", type=os.path.abspath, help="another checkout to time in turns with this one")
    ap.add_argument("--turn", type=os.path.abspath, help=argparse.SUPPRESS)  # one turn of --parent, in its own process
    args = ap.parse_args(argv)
    only, parent, turn = args.only, args.parent, args.turn
    tag = setup(turn or REPO)
    if tag is None:
        return 1
    if parent is not None:
        return compare(parent, only)
    entries, readings, details = measure(only, tag)
    if turn is not None:
        print(MARK + json.dumps({"card": tag, **readings}), flush=True)
        return 0
    import torch

    print(json.dumps({"kernels": entries, **details}))
    print(tag)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
