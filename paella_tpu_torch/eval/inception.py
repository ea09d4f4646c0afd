"""InceptionV3 pool3 feature extractor — the classic-FID featurizer, the
counterpart of `paella_tpu/eval/inception.py`.

Plain functions over a converted torch state dict (`convert_inception`
walks the same keys as the JAX converter; the weights stay in torch's
layout), run with F.conv2d on the tensors' device. The weights are
user-supplied: the standard `pt_inception-2015-12-05` checkpoint from
pytorch-fid, or any torchvision InceptionV3 state dict (they share key names).

Two variants, selectable because the canonical FID numbers depend on it:
- "fid" (default): pytorch-fid's TF-compatible graph — avg-pools inside
  InceptionA/C and Mixed_7b use count_include_pad=False, and Mixed_7c's
  branch_pool is a MAX pool (the TF-Inception quirk every published FID
  number bakes in).
- "torchvision": stock torchvision.models.inception_v3 semantics
  (count_include_pad=True everywhere, avg pool in Mixed_7c).

Images arrive NHWC, as in the JAX package, and run NCHW inside. BatchNorm
runs in eval mode on the checkpoint's running stats (eps=1e-3, torchvision
BasicConv2d), folded into a scale and shift in float32 as JAX folds it.
Preprocessing is the standard FID recipe: resize to 299x299 bilinear (as
`jax.image.resize`: nn/functional.py::resize), scale [0,1] -> [-1,1].
`inception_features` runs the resize, and a float32 network, as IEEE float32
on the card whatever the caller's TF32 flags (nn/functional.py::exact_f32).
"""
from __future__ import annotations

from typing import Callable, Mapping

import torch
import torch.nn.functional as F

from ..nn.functional import exact_f32, resize

_BN_EPS = 1e-3


def _basic_conv(p: Mapping, x: torch.Tensor, stride=1, padding=0) -> torch.Tensor:
    """torchvision BasicConv2d: bias-free conv -> BatchNorm(eval) -> relu."""
    x = F.conv2d(x, p["conv"]["weight"].to(x.dtype), stride=stride, padding=padding)
    bn = p["bn"]
    inv = torch.rsqrt(bn["var"].float() + _BN_EPS)
    scale = (bn["scale"].float() * inv).to(x.dtype)
    shift = (bn["bias"].float() - bn["mean"].float() * bn["scale"].float() * inv).to(x.dtype)
    return F.relu(x * scale[:, None, None] + shift[:, None, None])


def _avg_pool3(x: torch.Tensor, count_include_pad: bool) -> torch.Tensor:
    """3x3 stride-1 pad-1 average pool; count_include_pad=False divides each
    window by its count of non-pad elements (the TF/pytorch-fid behavior)."""
    return F.avg_pool2d(x, 3, stride=1, padding=1, count_include_pad=count_include_pad)


def _max_pool3(x: torch.Tensor, stride: int, pad: int = 0) -> torch.Tensor:
    return F.max_pool2d(x, 3, stride=stride, padding=pad)


def _cat(*xs) -> torch.Tensor:
    return torch.cat(xs, dim=1)


def _inception_a(p, x, fid: bool) -> torch.Tensor:
    b1 = _basic_conv(p["branch1x1"], x)
    b5 = _basic_conv(p["branch5x5_2"], _basic_conv(p["branch5x5_1"], x), padding=2)
    b3 = _basic_conv(p["branch3x3dbl_1"], x)
    b3 = _basic_conv(p["branch3x3dbl_2"], b3, padding=1)
    b3 = _basic_conv(p["branch3x3dbl_3"], b3, padding=1)
    bp = _basic_conv(p["branch_pool"], _avg_pool3(x, count_include_pad=not fid))
    return _cat(b1, b5, b3, bp)


def _inception_b(p, x) -> torch.Tensor:
    b3 = _basic_conv(p["branch3x3"], x, stride=2)
    bd = _basic_conv(p["branch3x3dbl_1"], x)
    bd = _basic_conv(p["branch3x3dbl_2"], bd, padding=1)
    bd = _basic_conv(p["branch3x3dbl_3"], bd, stride=2)
    return _cat(b3, bd, _max_pool3(x, 2))


def _inception_c(p, x, fid: bool) -> torch.Tensor:
    b1 = _basic_conv(p["branch1x1"], x)
    b7 = _basic_conv(p["branch7x7_1"], x)
    b7 = _basic_conv(p["branch7x7_2"], b7, padding=(0, 3))
    b7 = _basic_conv(p["branch7x7_3"], b7, padding=(3, 0))
    bd = _basic_conv(p["branch7x7dbl_1"], x)
    bd = _basic_conv(p["branch7x7dbl_2"], bd, padding=(3, 0))
    bd = _basic_conv(p["branch7x7dbl_3"], bd, padding=(0, 3))
    bd = _basic_conv(p["branch7x7dbl_4"], bd, padding=(3, 0))
    bd = _basic_conv(p["branch7x7dbl_5"], bd, padding=(0, 3))
    bp = _basic_conv(p["branch_pool"], _avg_pool3(x, count_include_pad=not fid))
    return _cat(b1, b7, bd, bp)


def _inception_d(p, x) -> torch.Tensor:
    b3 = _basic_conv(p["branch3x3_2"], _basic_conv(p["branch3x3_1"], x), stride=2)
    b7 = _basic_conv(p["branch7x7x3_1"], x)
    b7 = _basic_conv(p["branch7x7x3_2"], b7, padding=(0, 3))
    b7 = _basic_conv(p["branch7x7x3_3"], b7, padding=(3, 0))
    b7 = _basic_conv(p["branch7x7x3_4"], b7, stride=2)
    return _cat(b3, b7, _max_pool3(x, 2))


def _inception_e(p, x, pool: str) -> torch.Tensor:
    """pool: 'avg' (count_include_pad=True), 'avg_nopad' (FID Mixed_7b), or
    'max' (FID Mixed_7c — the TF-Inception quirk)."""
    b1 = _basic_conv(p["branch1x1"], x)
    b3 = _basic_conv(p["branch3x3_1"], x)
    b3 = _cat(_basic_conv(p["branch3x3_2a"], b3, padding=(0, 1)), _basic_conv(p["branch3x3_2b"], b3, padding=(1, 0)))
    bd = _basic_conv(p["branch3x3dbl_1"], x)
    bd = _basic_conv(p["branch3x3dbl_2"], bd, padding=1)
    bd = _cat(_basic_conv(p["branch3x3dbl_3a"], bd, padding=(0, 1)), _basic_conv(p["branch3x3dbl_3b"], bd, padding=(1, 0)))
    if pool == "max":
        pooled = _max_pool3(x, 1, pad=1)
    else:
        pooled = _avg_pool3(x, count_include_pad=pool == "avg")
    bp = _basic_conv(p["branch_pool"], pooled)
    return _cat(b1, b3, bd, bp)


@torch.no_grad()
def inception_pool3(params: Mapping, images: torch.Tensor, variant: str = "fid") -> torch.Tensor:
    """(B, 299, 299, 3) images in [-1, 1] -> (B, 2048) pool3 features; a
    float32 network rounds as IEEE float32 (exact_f32)."""
    if variant not in ("fid", "torchvision"):
        raise ValueError(f"unknown variant {variant!r}")
    with exact_f32(images.dtype):
        return _pool3(params, images, variant == "fid")


def _pool3(params: Mapping, images: torch.Tensor, fid: bool) -> torch.Tensor:
    x = images.permute(0, 3, 1, 2)
    x = _basic_conv(params["Conv2d_1a_3x3"], x, stride=2)
    x = _basic_conv(params["Conv2d_2a_3x3"], x)
    x = _basic_conv(params["Conv2d_2b_3x3"], x, padding=1)
    x = _max_pool3(x, 2)
    x = _basic_conv(params["Conv2d_3b_1x1"], x)
    x = _basic_conv(params["Conv2d_4a_3x3"], x)
    x = _max_pool3(x, 2)
    for name in ("Mixed_5b", "Mixed_5c", "Mixed_5d"):
        x = _inception_a(params[name], x, fid)
    x = _inception_b(params["Mixed_6a"], x)
    for name in ("Mixed_6b", "Mixed_6c", "Mixed_6d", "Mixed_6e"):
        x = _inception_c(params[name], x, fid)
    x = _inception_d(params["Mixed_7a"], x)
    x = _inception_e(params["Mixed_7b"], x, pool="avg_nopad" if fid else "avg")
    x = _inception_e(params["Mixed_7c"], x, pool="max" if fid else "avg")
    return x.mean(dim=(2, 3))  # global average pool -> (B, 2048)


def inception_preprocess(images: torch.Tensor, size: int = 299) -> torch.Tensor:
    """[0,1] (or uint8) NHWC images, any resolution -> (B, 299, 299, 3) in
    [-1, 1], bilinear — the standard FID preprocessing."""
    if images.dtype == torch.uint8:
        images = images.float() / 255.0
    if tuple(images.shape[1:3]) != (size, size):
        images = resize(images, (size, size), "bilinear")
    return images * 2.0 - 1.0


def inception_features(params: Mapping, variant: str = "fid", dtype=torch.float32) -> Callable:
    """Classic-FID featurizer for eval/metrics.py::features_over_batches:
    [0,1]-or-uint8 NHWC images (any resolution, moved to the weights'
    device) -> (B, 2048) float32 features."""
    params = _tree_map(lambda a: a.to(dtype), params)
    device = params["Conv2d_1a_3x3"]["conv"]["weight"].device

    def extract(images: torch.Tensor) -> torch.Tensor:
        with exact_f32(torch.float32):  # the resize's products
            x = inception_preprocess(torch.as_tensor(images, device=device)).to(dtype)
        return inception_pool3(params, x, variant).float()

    return extract


def _tree_map(fn, tree):
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


# ---------------------------------------------------------------------------
# converter (torchvision inception_v3 / pytorch-fid checkpoint — same keys)
# ---------------------------------------------------------------------------

def _a(cin: int, pool: int) -> dict:
    return {"branch1x1": (cin, 64, 1), "branch5x5_1": (cin, 48, 1), "branch5x5_2": (48, 64, 5),
            "branch3x3dbl_1": (cin, 64, 1), "branch3x3dbl_2": (64, 96, 3), "branch3x3dbl_3": (96, 96, 3),
            "branch_pool": (cin, pool, 1)}


def _c(c7: int) -> dict:
    return {"branch1x1": (768, 192, 1), "branch7x7_1": (768, c7, 1), "branch7x7_2": (c7, c7, (1, 7)),
            "branch7x7_3": (c7, 192, (7, 1)), "branch7x7dbl_1": (768, c7, 1), "branch7x7dbl_2": (c7, c7, (7, 1)),
            "branch7x7dbl_3": (c7, c7, (1, 7)), "branch7x7dbl_4": (c7, c7, (7, 1)), "branch7x7dbl_5": (c7, 192, (1, 7)),
            "branch_pool": (768, 192, 1)}


def _e(cin: int) -> dict:
    return {"branch1x1": (cin, 320, 1), "branch3x3_1": (cin, 384, 1), "branch3x3_2a": (384, 384, (1, 3)),
            "branch3x3_2b": (384, 384, (3, 1)), "branch3x3dbl_1": (cin, 448, 1), "branch3x3dbl_2": (448, 384, 3),
            "branch3x3dbl_3a": (384, 384, (1, 3)), "branch3x3dbl_3b": (384, 384, (3, 1)), "branch_pool": (cin, 192, 1)}


# every BasicConv2d unit, per block, with its (in, out, kernel) (names exactly
# as in the torch state dict; channel arithmetic per torchvision.models.inception)
INCEPTION_SHAPES = {
    "Conv2d_1a_3x3": {None: (3, 32, 3)},  # None = the block IS one BasicConv2d
    "Conv2d_2a_3x3": {None: (32, 32, 3)},
    "Conv2d_2b_3x3": {None: (32, 64, 3)},
    "Conv2d_3b_1x1": {None: (64, 80, 1)},
    "Conv2d_4a_3x3": {None: (80, 192, 3)},
    "Mixed_5b": _a(192, 32),
    "Mixed_5c": _a(256, 64),
    "Mixed_5d": _a(288, 64),
    "Mixed_6a": {"branch3x3": (288, 384, 3), "branch3x3dbl_1": (288, 64, 1), "branch3x3dbl_2": (64, 96, 3),
                 "branch3x3dbl_3": (96, 96, 3)},
    "Mixed_6b": _c(128),
    "Mixed_6c": _c(160),
    "Mixed_6d": _c(160),
    "Mixed_6e": _c(192),
    "Mixed_7a": {"branch3x3_1": (768, 192, 1), "branch3x3_2": (192, 320, 3), "branch7x7x3_1": (768, 192, 1),
                 "branch7x7x3_2": (192, 192, (1, 7)), "branch7x7x3_3": (192, 192, (7, 1)), "branch7x7x3_4": (192, 192, 3)},
    "Mixed_7b": _e(1280),
    "Mixed_7c": _e(2048),
}


def conv_weight_shape(cin: int, cout: int, k) -> tuple:
    """A unit's torch conv weight shape (out, in, kh, kw)."""
    kh, kw = (k, k) if isinstance(k, int) else k
    return (cout, cin, kh, kw)


def _convert_basic_conv(sd: Mapping, prefix: str, shape: tuple) -> dict:
    t = lambda k: torch.as_tensor(sd[f"{prefix}.{k}"])  # noqa: E731
    if tuple(t("conv.weight").shape) != conv_weight_shape(*shape):
        raise ValueError(f"{prefix}.conv.weight: {tuple(t('conv.weight').shape)}, an InceptionV3 has "
                         f"{conv_weight_shape(*shape)}")
    return {
        "conv": {"weight": t("conv.weight")},  # (out, in, kh, kw), as torch has it
        "bn": {"scale": t("bn.weight"), "bias": t("bn.bias"), "mean": t("bn.running_mean"), "var": t("bn.running_var")},
    }


def convert_inception(sd: Mapping) -> dict:
    """torch InceptionV3 state dict (tensors or numpy) -> params for
    inception_pool3. Ignores the classifier/aux keys (fc.*, AuxLogits.*) —
    only pool3 features are needed."""
    params = {}
    for block, units in INCEPTION_SHAPES.items():
        if None in units:
            params[block] = _convert_basic_conv(sd, block, units[None])
        else:
            params[block] = {u: _convert_basic_conv(sd, f"{block}.{u}", shape) for u, shape in units.items()}
    return params


def load_inception(path: str, variant: str = "fid", device="cuda") -> Callable:
    """One-call classic-FID featurizer from a torch checkpoint on disk, on
    `device` (a CUDA device unless the caller asks for the CPU)."""
    from ..cond.loader import load_state_dict, resolve_device

    device = resolve_device(device)
    params = _tree_map(lambda a: a.to(device), convert_inception(load_state_dict(path, key=None)))
    return inception_features(params, variant)
