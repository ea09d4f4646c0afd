"""What the configuration builders (`configs/<config>.py`) share."""
from __future__ import annotations

import dataclasses
import typing

import torch


def dataclass_from(cls, sizes: dict):
    """cls(**sizes), lists turned into the tuples the dataclass declares."""
    hints = typing.get_type_hints(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name in sizes:
            v = sizes[f.name]
            kw[f.name] = tuple(v) if isinstance(v, list) and "Tuple" in str(hints[f.name]) else v
    return cls(**kw)


def empty(make, device: torch.device):
    """The module make() builds, with storage on `device` left unfilled."""
    with torch.device("meta"):
        m = make()
    return m.to_empty(device=device)
