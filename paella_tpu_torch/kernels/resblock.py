"""Fused ResBlock (+ optional FiLM) — the port of the Pallas kernel
`paella_tpu/kernels/resblock.py::fused_resblock_stacked`, in its float mode
(K1) and its two int8 modes (K1b).

    x_res = x
    x  = depthwise3x3([x | skip]) + dw_b   # skip: grouped conv, channel pairs (2c, 2c+1)
    x  = layer_norm(x)                      # affine-free, eps 1e-6, f32 stats
    h  = gelu(x @ W1^T + b1)                # exact erf
    h  = h * (gamma * nx + 1)               # GRN; beta enters as beta @ W2
    y  = h @ W2^T + beta @ W2 + b2 + x_res
    y  = y * (1 + film_a) + film_b          # TimestepBlock, optional

With the channelwise skip (Stable Cascade's ResBlock, `channelwise_skip`
weights: a depthwise conv over C channels and fc1 over 2C) the skip joins
after the LN instead, as the second half of fc1's input:

    x  = layer_norm(depthwise3x3(x) + dw_b)
    h  = gelu([x | skip] @ W1^T + b1)       # K = 2C; the rest as above

The int8 modes take W1, W2 as int8 codes with per-output-channel f32 scales
s1 (4C,), s2 (C,) (quant.py), at the TPU kernel's rounding points:
- weight-only ("int8", resblock.py:214-224, 287-302): the products run over
  the codes cast to the dtype (exact in bf16) with f32 sums; fc1 is
  (xn @ Wq1^T) * s1 + b1, and fc2 (h @ Wq2^T + beta_dtype @ Wq2^T) * s2 + b2:
  beta @ W2 enters BEFORE the scale.
- W8A8 ("w8a8", :162-167, 195-213, 227-266, 279-286): the LN output is
  quantized per row (`quantize_rows`: s = max(amax, 1e-6) / 127 as a product
  with f32(1/127), codes clip(round(v * (1/s)), +-127), half to even), fc1 is
  s8 x s8 -> s32, f32(acc) * (sx * s1) + b1, then GELU; the GRN sums come from
  that f32 h. h is quantized per (row, `tile_n1`-column group) as the TPU
  kernel's fc1 tiles store it, dequantized, multiplied by the GRN scale and
  requantized to one scale per row (sh2); fc2 is s8 x s8 -> s32,
  f32(acc) * (sh2 * s2) + beta_w2 + b2 with beta_w2 = (beta_f32 @ Wq2_f32^T) * s2
  precomputed per block (denoiser.py:706-717), added AFTER the scale.

`fused_resblock` runs every mode, picked by the weights (`ResBlockWeights.mode`):
it launches the CUDA kernel of csrc/resblock.cu on CUDA tensors (K1 for
float weights, K1b for int8 ones) and runs `resblock_plain`, the same
computation in torch ops with the same rounding points, on CPU tensors only. Weights come in the layout the kernels
read (`ResBlockWeights`), derived once from the module's parameters by
`prepare_resblock_weights`: float W1 and W2 take a padded pitch, C and 4C
rounded up to a multiple of 8 with zero columns, so the kernel runs its
products over 16-byte aligned rows at any C. The int8 modes keep the TPU
kernel's alignment, C % 64 == 0.

On the card the bf16 modes and W8A8 run their products on Hopper's wgmma
(csrc/gemm_sm90.cuh): bf16 float products, weight-only codes widened to bf16
inside the kernel (no bf16 copy of a weight is made), W8A8 as s8 x s8 -> s32;
f32 activations in the float and weight-only modes take FMA tiles.
`launch_plan` picks the tiling.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from ._build import check_operands, check_rc, load_library, stream_handle

MODES = {"float": 0, "int8": 1, "w8a8": 2}


class ResBlockWeights(NamedTuple):
    """One ResBlock's weights in the kernel's layout and compute dtype."""

    dw: torch.Tensor  # (3, 3, cpg, C) depthwise kernel
    dw_b: torch.Tensor  # (C,)
    w1: torch.Tensor  # (4C, round8(C)) fc1, torch Linear layout, zero pad columns; int8 codes (4C, C) with s1
    b1: torch.Tensor  # (4C,)
    gamma: torch.Tensor  # (4C,) float32
    w2: torch.Tensor  # (C, round8(4C)) fc2, torch Linear layout, zero pad columns; int8 codes (C, 4C) with s2
    bw2: torch.Tensor  # (C,) float32: beta @ W2 (see the module docstring per mode)
    b2: torch.Tensor  # (C,)
    s1: Optional[torch.Tensor] = None  # (4C,) float32 fc1 scales (int8 modes)
    s2: Optional[torch.Tensor] = None  # (C,) float32 fc2 scales (int8 modes)
    act_quant: bool = False  # W8A8 (int8 modes only)
    channelwise_skip: bool = False  # fc1 reads [LN(dw(x)) | skip], K = 2C (W1 (4C, round8(2C)))

    @property
    def mode(self) -> str:
        if self.s1 is None:
            return "float"
        return "w8a8" if self.act_quant else "int8"


def round8(n: int) -> int:
    """n rounded up to a multiple of 8: the kernel's row pitch for C and 4C."""
    return -(-n // 8) * 8


def _pad_columns(t: torch.Tensor, width: int) -> torch.Tensor:
    return t if t.shape[-1] == width else F.pad(t, (0, width - t.shape[-1])).contiguous()


@torch.no_grad()
def prepare_resblock_weights(
    dw_weight: torch.Tensor,  # (C, cpg, 3, 3) torch Conv2d(groups=C) weight
    dw_bias: torch.Tensor,
    fc1_weight: torch.Tensor,  # (4C, C), float or int8 codes; (4C, 2C): the channelwise skip
    fc1_bias: torch.Tensor,
    grn_gamma: torch.Tensor,  # (4C,) or the reference's (1, 1, 1, 4C)
    grn_beta: torch.Tensor,
    fc2_weight: torch.Tensor,  # (C, 4C), float or int8 codes
    fc2_bias: torch.Tensor,
    dtype: torch.dtype,
    fc1_scale: Optional[torch.Tensor] = None,  # (4C,) f32: fc1_weight is int8
    fc2_scale: Optional[torch.Tensor] = None,  # (C,) f32: fc2_weight is int8
    act_quant: bool = False,  # W8A8; needs the scales
) -> ResBlockWeights:
    def cast(t: torch.Tensor, dt: torch.dtype = dtype) -> torch.Tensor:
        return t.detach().to(dt).contiguous()

    quantized = fc1_scale is not None
    if quantized != (fc2_scale is not None) or quantized != (fc1_weight.dtype == torch.int8 == fc2_weight.dtype):
        raise ValueError("prepare_resblock_weights: int8 fc1 and fc2 codes go with both scales, float weights with none")
    if act_quant and not quantized:
        raise ValueError("prepare_resblock_weights: act_quant (W8A8) needs int8 weights with scales")
    beta = grn_beta.reshape(-1).detach()
    if quantized:
        w1, w2 = fc1_weight.detach().contiguous(), fc2_weight.detach().contiguous()
        s1, s2 = cast(fc1_scale, torch.float32), cast(fc2_scale, torch.float32)
    else:
        w1, w2 = cast(fc1_weight), cast(fc2_weight)
        s1 = s2 = None
    if act_quant:
        bw2 = (w2.float() @ beta.float()) * s2
    else:  # beta rounded to the dtype; int8 codes are exact in it
        bw2 = w2.float() @ beta.to(dtype).float()
    c, k = w2.shape[0], w1.shape[1]
    if not quantized:  # the padded pitch; the int8 modes' widths need none
        w1, w2 = _pad_columns(w1, round8(k)), _pad_columns(w2, round8(4 * c))
    return ResBlockWeights(
        dw=cast(dw_weight.permute(2, 3, 1, 0)),
        dw_b=cast(dw_bias),
        w1=w1,
        b1=cast(fc1_bias),
        gamma=cast(grn_gamma.reshape(-1), torch.float32),
        w2=w2,
        bw2=bw2.contiguous(),
        b2=cast(fc2_bias),
        s1=s1,
        s2=s2,
        act_quant=act_quant,
        channelwise_skip=k == 2 * c,
    )


def quantize_rows(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric s8 over the last axis, as the TPU kernel's
    quantize_rows: (codes as f32 values, f32 scales)."""
    s = v.abs().amax(dim=-1).clamp_min(1e-6) * (1.0 / 127.0)
    return torch.clamp(torch.round(v * (1.0 / s)[..., None]), -127.0, 127.0), s


def _s8_product(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """f32(a @ w^T) of s8 codes (a and w as f32 values), exact: the s32 sum
    is an integer below 2^53, so the f64 product gives it in any order, and
    rounding it to f32 is the TPU kernel's astype(float32)."""
    return (a.double() @ w.double().t()).float()


def resblock_plain(
    x: torch.Tensor,
    w: ResBlockWeights,
    film: Optional[torch.Tensor] = None,
    skip: Optional[torch.Tensor] = None,
    tile_n1: int = 512,
) -> torch.Tensor:
    """The kernels' computation in torch ops, every mode: x (B, H, W, C),
    film (B, 2C) [a | b], skip (B, H, W, C), joined where the weights say
    (`channelwise_skip`: beside the LN rows, as x's dtype, before the
    rounding or quantization of fc1's input). Depthwise, LN, GELU and GRN run
    in f32; xn and h are rounded to x's dtype where the kernel stores them
    (to s8 codes in W8A8, whose h codes are first taken per `tile_n1`-column
    group); float products take f32 operands (exact for bf16 values and int8
    codes) and accumulate in f32 — on a card, only with TF32 off."""
    resblock_plain.launches += 1
    dt = x.dtype
    b, hh, ww, c = x.shape
    m, hw = b * hh * ww, hh * ww
    cat = w.channelwise_skip
    if cat and skip is None:
        raise ValueError("resblock_plain: channelwise-skip weights need a skip")
    if skip is None or cat:
        planes = [x]
    else:
        cc = torch.cat([x, skip.to(dt)], dim=-1)
        planes = [cc[..., 0::2], cc[..., 1::2]]
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for j, plane in enumerate(planes):
        xp = F.pad(plane.float(), (0, 0, 1, 1, 1, 1))
        for ky in range(3):
            for kx in range(3):
                acc = acc + xp[:, ky : ky + hh, kx : kx + ww, :] * w.dw[ky, kx, j].float()
    acc = acc + w.dw_b.float()
    mean = acc.mean(dim=-1, keepdim=True)
    var = (acc - mean).square().mean(dim=-1, keepdim=True)
    xn = ((acc - mean) * torch.rsqrt(var + 1e-6)).reshape(m, c)
    k = 2 * c if cat else c

    w1, w2 = w.w1[:, :k].float().contiguous(), w.w2[:, : 4 * c].float().contiguous()  # the true widths
    if w.act_quant:
        if cat:
            xn = torch.cat([xn, skip.float().reshape(m, c)], dim=-1)
        xq, sx = quantize_rows(xn)
        ht = _s8_product(xq, w1) * (sx[:, None] * w.s1[None, :])
    else:
        xn = xn.to(dt)
        if cat:
            xn = torch.cat([xn, skip.to(dt).reshape(m, c)], dim=-1)
        ht = xn.float() @ w1.t()
        if w.s1 is not None:
            ht = ht * w.s1
    ht = F.gelu(ht + w.b1.float())  # (M, 4C) f32
    gx = ht.square().reshape(b, hw, 4 * c).sum(dim=1).sqrt()  # (B, 4C)
    scale = w.gamma * (gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)) + 1.0

    if w.act_quant:
        hq, sh = quantize_rows(ht.reshape(m, 4 * c // tile_n1, tile_n1))
        deq = (hq * sh[..., None]).reshape(b, hw, 4 * c) * scale[:, None, :]
        h8, sh2 = quantize_rows(deq.reshape(m, 4 * c))
        y = _s8_product(h8, w2) * (sh2[:, None] * w.s2[None, :])
        y = y + w.bw2
    else:
        h = (ht.to(dt).float().reshape(b, hw, 4 * c) * scale[:, None, :]).to(dt)
        y = h.reshape(m, 4 * c).float() @ w2.t()
        y = y + w.bw2
        if w.s2 is not None:
            y = y * w.s2
    y = y + w.b2.float()
    y = (y + x.float().reshape(m, c)).reshape(b, hw, c)
    if film is not None:
        f = film.to(dt).float()
        y = y * (1.0 + f[:, None, :c]) + f[:, None, c:]
    return y.to(dt).reshape(b, hh, ww, c)


resblock_plain.launches = 0


@functools.lru_cache(maxsize=None)
def fc2_splits(m: int, c: int, n_sm: int) -> int:
    """How many K splits the kernel's fc2 phase runs for M rows on its FMA
    tiles (f32 activations in the float and weight-only modes; the wgmma path
    takes `wgmma_tiles`): its (C/64) x (M/64) grid is doubled until it holds
    about two blocks per SM, while each split keeps a whole number, and at
    least 4, of the tile's 32-deep K steps over K = round8(4C) (none where K
    is not a whole number of them). The wrapper passes the M of one CFG pair
    (two images), whatever the batch, so an image's sums do not depend on its
    batchmates. At the flagship's shapes on 132 SMs: 1 at M 2048 x C 640, 2
    at 512 x 1280, 8 at 128 x 1280."""
    blocks = -(-c // 64) * -(-m // 64)
    k = round8(4 * c)
    k_tiles = k // 32 if k % 32 == 0 else 0
    s = 1
    while blocks * s < 2 * n_sm and k_tiles % (2 * s) == 0 and k_tiles // (2 * s) >= 4:
        s *= 2
    return s


@functools.lru_cache(maxsize=None)
def gemm_tiles(m: int, n: int, k: int, n_sm: int, bk: int = 64) -> tuple[int, int]:
    """(tile width, K splits) of one (M, N) product over depth K on the
    wgmma tile (csrc/gemm_sm90.cuh: 128-row tiles, K steps of one 128-byte
    row: bk 64 bf16 values, or 128 s8 codes in W8A8), for K1's, K1b's and
    K6's products alike. 128 wide where N is a multiple of 128
    and that gives at least n_sm / 2 tiles, else 64; then, while the grid
    still holds fewer than n_sm / 2 tiles, K is halved, each split keeping
    at least 4 whole K steps (none where K is not a multiple of bk: the
    narrow widths). A tile's ring fills its SM's shared memory, so one tile
    runs per SM: a 64-wide step costs ~0.7 of a 128-wide one, so 64 wins
    where its twice as many tiles still fit one wave, and 128 where they
    would not; a split pays only where the grid is short, because its
    partials make a round trip through memory to the reduce launch (K6's
    tiling sweep, scripts/k6_tilings.py). A product that cannot split (K1's
    fc1, whose epilogue needs whole sums) takes the width alone."""
    m_tiles = -(-m // 128)
    bn = 128 if n % 128 == 0 and m_tiles * (n // 128) >= n_sm // 2 else 64
    tiles = m_tiles * -(-n // bn)
    k_steps = k // bk if k % bk == 0 else 0
    s = 1
    while tiles * s < n_sm // 2 and k_steps % (2 * s) == 0 and k_steps // (2 * s) >= 4:
        s *= 2
    return bn, s


@functools.lru_cache(maxsize=None)
def wgmma_tiles(m: int, c: int, n_sm: int, bk: int = 64) -> tuple[int, int, int]:
    """(fc1 tile width, fc2 tile width, fc2 K splits) of the wgmma path's
    two products for M rows, from `gemm_tiles` (bk 64, or 128 in W8A8): fc1
    (N = 4C) takes its width only, fc2 (N = C, K = round8(4C)) its width and
    splits. The wrapper passes the M of one CFG pair, whatever the batch, as
    for `fc2_splits`, so an image's sums do not depend on its batchmates. At
    the flagship's shapes on 132 SMs, bf16 and W8A8 alike: (128, 128, 1) at
    M 2048 x C 640, (128, 64, 1) at 512 x 1280, (64, 64, 4) at 128 x 1280."""
    return gemm_tiles(m, 4 * c, round8(c), n_sm, bk)[0], *gemm_tiles(m, c, round8(4 * c), n_sm, bk)


@functools.lru_cache(maxsize=None)
def grn_slots(b: int, hw: int, bm: int = 64) -> int:
    """The most batch items one bm-row M-tile of the kernel's fc1 phase
    touches (bm 128 on the wgmma path, 64 on the FMA tiles): its GRN partials
    buffer holds that many slots per tile, so the per-(batch item, column)
    sums are written without atomics and added in tile order. At the
    flagship's shapes (hw 1024, 256, 64): 1, 1, 1 with 64-row tiles and 1,
    1, 2 with 128-row tiles."""
    m = b * hw
    return max(min(m0 + bm - 1, m - 1) // hw - m0 // hw + 1 for m0 in range(0, m, bm))


def tiles_per_image(hw: int, bm: int) -> int:
    """fc1's M-tiles per image: 0 where tiles at absolute multiples of bm
    rows cut every image at the same image-relative rows (hw a multiple of bm,
    or bm of hw: the flagship's hw 1024, 256 and 64), else ceil(hw / bm)
    tiles inside each image (hw 96 and 144 at 256x384 and 384x384 canvases),
    so an image's GRN sums never depend on where it sits in the batch."""
    return 0 if hw % bm == 0 or bm % hw == 0 else -(-hw // bm)


class LaunchPlan(NamedTuple):
    """How the kernel tiles one call (see `launch_plan`)."""

    bm: int  # fc1 M-tile rows: 128 on the wgmma path, 64 on the FMA tiles
    bn1: int  # wgmma path: fc1 tile width (0 on the FMA tiles)
    bn2: int  # wgmma path: fc2 tile width (0 on the FMA tiles)
    splits: int  # fc2 K splits
    slots: int  # GRN partial slots per fc1 M-tile
    tiles_per_image: int  # fc1 M-tiles per image, or 0: absolute tiles


@functools.lru_cache(maxsize=None)
def launch_plan(b: int, hw: int, c: int, mode: str, dtype: torch.dtype, n_sm: int) -> LaunchPlan:
    """The tiling of one call at batch b, hw pixels an image, width c. Every
    bf16 mode and W8A8 run the wgmma path (128-row tiles; W8A8's K steps are
    128 s8 codes), f32 activations in the float and weight-only modes the
    FMA tiles (64 rows). The tile widths and the split count come from one
    CFG pair's M = 2 hw and the fc1 row tiles from hw, never from b, so an
    image's bits do not depend on its batchmates; only the partials buffer's
    slot count follows b."""
    if dtype == torch.bfloat16 or mode == "w8a8":
        bm, (bn1, bn2, splits) = 128, wgmma_tiles(2 * hw, c, n_sm, 128 if mode == "w8a8" else 64)
    else:
        bm, bn1, bn2, splits = 64, 0, 0, fc2_splits(2 * hw, c, n_sm)
    tpi = tiles_per_image(hw, bm)
    return LaunchPlan(bm, bn1, bn2, splits, 1 if tpi else grn_slots(b, hw, bm), tpi)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_args(what: str, x, w: ResBlockWeights, film, skip) -> None:
    dt = x.dtype
    if x.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x.device}")
    if dt not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: dtype {dt} (kernel takes float32 or bfloat16)")
    b, hh, ww, c = x.shape
    if w.channelwise_skip and skip is None:
        raise ValueError(f"{what}: channelwise-skip weights need a skip")
    cpg = 1 if skip is None or w.channelwise_skip else 2
    if w.s1 is not None and c % 64:  # the int8 modes keep JAX's alignment
        raise ValueError(f"{what}: int8 weights need C % 64 == 0, got C={c}")
    width = 2 * c if w.channelwise_skip else c
    k1, k2 = (width, 4 * c) if w.s1 is not None else (round8(width), round8(4 * c))
    if w.dw.shape != (3, 3, cpg, c) or w.w1.shape != (4 * c, k1) or w.w2.shape != (c, k2):
        raise ValueError(
            f"{what}: weight shapes dw {tuple(w.dw.shape)}, w1 "
            f"{tuple(w.w1.shape)}, w2 {tuple(w.w2.shape)} do not fit x {tuple(x.shape)}"
        )
    if skip is not None and (skip.shape != x.shape or skip.dtype != dt):
        raise ValueError(f"{what}: skip must match x in shape and dtype")
    if film is not None and (film.shape != (b, 2 * c) or film.dtype != dt):
        raise ValueError(f"{what}: film must be ({b}, {2 * c}) {dt}")
    fc_dt = dt if w.s1 is None else torch.int8
    for name in ("dw", "dw_b", "w1", "b1", "w2", "b2"):
        want = fc_dt if name in ("w1", "w2") else dt
        if getattr(w, name).dtype != want:
            raise ValueError(f"{what}: weight {name} is not {want}")
    f32 = [w.gamma, w.bw2] + ([] if w.s1 is None else [w.s1, w.s2])
    if any(t.dtype != torch.float32 for t in f32) or (w.s1 is not None and (w.s1.shape != (4 * c,) or w.s2.shape != (c,))):
        raise ValueError(f"{what}: gamma, bw2 and the scales must be float32 of shapes (4C,), (C,)")
    tensors = {k: v for k, v in w._asdict().items() if isinstance(v, torch.Tensor)}
    check_operands(what, x.device, {"x": x, "skip": skip, "film": film, **tensors})


def _launch(x: torch.Tensor, w: ResBlockWeights, film, skip, tile_n1: int) -> torch.Tensor:
    dt = x.dtype
    b, hh, ww, c = x.shape
    mode = MODES[w.mode]
    q8 = mode == MODES["w8a8"]
    m = b * hh * ww
    dev = x.device
    bm, bn1, bn2, splits, slots, tpi = launch_plan(b, hh * ww, c, w.mode, dt, _sm_count(dev))
    # the padded pitches (C or 2C, and 4C, in the int8 modes)
    k1, k2 = round8(2 * c if w.channelwise_skip else c), round8(4 * c)
    out = torch.empty_like(x)
    xn = torch.empty((m, k1), dtype=torch.int8 if q8 else dt, device=dev)
    h = torch.empty((m, k2), dtype=torch.float32 if q8 else dt, device=dev)
    tiles = b * tpi if tpi else -(-m // bm)
    gx_part = torch.empty((tiles * slots, 4 * c), dtype=torch.float32, device=dev)
    scale = torch.empty((b, k2), dtype=torch.float32, device=dev)
    part = torch.empty((splits, m, c), dtype=torch.float32, device=dev) if splits > 1 else None
    sx = torch.empty(m, dtype=torch.float32, device=dev) if q8 else None
    hq = torch.empty((m, 4 * c), dtype=torch.int8, device=dev) if q8 else None
    sh2 = torch.empty(m, dtype=torch.float32, device=dev) if q8 else None

    lib = _library()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    rc = lib.paella_resblock(
        ptr(x), ptr(skip), ptr(w.dw), ptr(w.dw_b), ptr(w.w1), ptr(w.b1), ptr(w.gamma),
        ptr(w.w2), ptr(w.bw2), ptr(w.b2), ptr(film), ptr(w.s1), ptr(w.s2), ptr(out), ptr(xn), ptr(h),
        ptr(gx_part), ptr(scale), ptr(part), ptr(sx), ptr(hq), ptr(sh2),
        slots, splits, b, hh, ww, c, int(dt == torch.bfloat16), mode, tile_n1, bn1, bn2, tpi, int(w.channelwise_skip),
        stream_handle(x),
    )
    check_rc(rc, "fused_resblock")
    return out


def fused_resblock(
    x: torch.Tensor,
    w: ResBlockWeights,
    film: Optional[torch.Tensor] = None,
    skip: Optional[torch.Tensor] = None,
    tile_n1: int = 512,
) -> torch.Tensor:
    """ResBlock(+FiLM) in one call, in the mode of its weights (`w.mode`):
    the CUDA kernel for a CUDA tensor (K1 for float weights, K1b for int8
    ones), the plain version for a CPU tensor. tile_n1 is the W8A8 h-code
    group width (the TPU kernel's fc1 tile; the JAX model calls use its
    default 512). Counts its launches in `launches` and, per mode, in
    `launches_by_mode`. See the module docstring."""
    c4 = 4 * x.shape[-1]
    if w.act_quant and (c4 % tile_n1 or c4 // tile_n1 > 16):  # the TPU kernel's n_t1 <= 16
        raise ValueError(f"fused_resblock: W8A8 takes 4C={c4} in at most 16 groups of tile_n1={tile_n1}")
    if x.device.type == "cpu":
        return resblock_plain(x, w, film=film, skip=skip, tile_n1=tile_n1)
    _check_args("fused_resblock", x, w, film, skip)
    out = _launch(x, w, film, skip, tile_n1)
    fused_resblock.launches += 1
    fused_resblock.launches_by_mode[w.mode] += 1
    return out


fused_resblock.launches = 0
fused_resblock.launches_by_mode = dict.fromkeys(MODES, 0)


def _library() -> ctypes.CDLL:
    lib = load_library("resblock")
    fn = lib.paella_resblock
    if fn.restype is not ctypes.c_int or not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p] * 22 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib
