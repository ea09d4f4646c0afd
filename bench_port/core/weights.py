"""Seeded weights, made on the device in one large draw per module and dtype.

The benchmark makes every weight itself and hands the same values to the
program and to the reference: `fill_module` draws one flat buffer per dtype
of a module from a `torch.Generator` on the device and makes each parameter
a view into it; `regenerate` draws the same buffers again, for the reference,
from the layout alone (names, shapes and dtypes, in the module's order).

Scales follow rules from the configuration file: a list of
[regex, mean, std] where std is a number or "fan_in" (1 / sqrt(fan_in)), the
first match wins; without a match a matrix gets N(0, 1 / fan_in) and a vector
(at most one axis longer than 1) N(0, 0.1), or 1 + N(0, 0.1) where its module
is a norm. fan_in is numel / shape[0].
"""
from __future__ import annotations

import math
import re
import zlib
from typing import Iterable

import torch


def _fan_in(shape) -> int:
    n = math.prod(shape)
    return max(1, n // shape[0]) if shape else 1


def _is_vector(shape) -> bool:
    return sum(s > 1 for s in shape) <= 1


def _is_norm_gain(name: str) -> bool:
    parts = name.split(".")
    owner = parts[-2] if len(parts) > 1 else ""
    return parts[-1] == "weight" and ("norm" in owner or owner.startswith("ln"))


def scale_of(name: str, shape, rules: Iterable) -> tuple[float, float]:
    """(mean, std) of parameter `name` under `rules` (see the module docstring)."""
    for pattern, mean, std in rules or ():
        if re.search(pattern, name):
            return float(mean), (_fan_in(shape) ** -0.5 if std == "fan_in" else float(std))
    if _is_vector(shape):
        return (1.0 if _is_norm_gain(name) else 0.0), 0.1
    return 0.0, _fan_in(shape) ** -0.5


def layout_of(module: torch.nn.Module) -> list:
    """[(name, shape, dtype)] of the module's parameters, in its order."""
    return [(n, tuple(p.shape), p.dtype) for n, p in module.named_parameters()]


def _generator(seed: int, tag: str, dtype: torch.dtype, device) -> torch.Generator:
    salt = zlib.crc32(f"{tag}/{dtype}".encode())
    return torch.Generator(device=device).manual_seed((int(seed) * 0x9E3779B1 + salt) % 2**63)


def _flat(layout: list, rules, seed: int, tag: str, dtype: torch.dtype, device) -> tuple[torch.Tensor, dict]:
    """One dtype's buffer: the draw, then each slice scaled in place."""
    entries = [(n, s) for n, s, dt in layout if dt == dtype]
    total = sum(math.prod(s) for _, s in entries)
    flat = torch.randn(total, dtype=dtype, device=device, generator=_generator(seed, tag, dtype, device))
    views, off = {}, 0
    for name, shape in entries:
        n = math.prod(shape)
        v = flat[off:off + n]
        mean, std = scale_of(name, shape, rules)
        v.mul_(std)
        if mean:
            v.add_(mean)
        views[name] = v.view(shape)
        off += n
    return flat, views


@torch.no_grad()
def fill_module(module: torch.nn.Module, rules, seed: int, tag: str) -> list:
    """Make every parameter of `module` (already on its device, in the dtypes
    it is served in) a view of a seeded buffer; returns its layout."""
    layout = layout_of(module)
    device = next(module.parameters()).device
    params = dict(module.named_parameters())
    for dtype in sorted({dt for _, _, dt in layout}, key=str):
        _, views = _flat(layout, rules, seed, tag, dtype, device)
        for name, v in views.items():
            params[name].data = v
    return layout


@torch.no_grad()
def regenerate(layout: list, rules, seed: int, tag: str, device) -> dict:
    """The values `fill_module` gave, as {name: tensor} in the served dtypes."""
    out = {}
    for dtype in sorted({dt for _, _, dt in layout}, key=str):
        out.update(_flat(layout, rules, seed, tag, dtype, device)[1])
    return {name: out[name] for name, _, _ in layout}
