"""Checkpointing: save/restore the full train state as torch files, the
counterpart of `paella_tpu/train/checkpoints.py` (an orbax wrapper there).

Replaces the reference's single-`.pt` scheme (reference:
src_distributed/train.py:131-138 saves {iter, state_dict,
optimizer_state_dict, scheduler_last_step, grad_scaler_state_dict} every 2000
updates; resume at :60-67). A checkpoint is the directory
<directory>/<step>/ holding `state.pt` (whatever tree of tensors, numbers
and dicts the caller saves: the driver saves the model's state dict, the
AdamW state dict with its moments in their own dtype and the update count,
the step and the draw generator's state) and, optionally, `extra.json`. It
is written under a temporary name and renamed into place, so a crash never
leaves a partial step behind; the oldest steps past `max_to_keep` are removed.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

from ..convert import load_params_npz

_STATE, _EXTRA = "state.pt", "extra.json"


class CheckpointManager:
    """Keeps the last `max_to_keep` steps and saves every `save_interval`
    steps (reference cadence: 2000), as the JAX package's orbax manager."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_interval: int = 2000):
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self.save_interval = save_interval
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, state: Any, extra: Optional[dict] = None, force: bool = False) -> bool:
        """Write `state` (and the JSON `extra`) as step `step`, unless, when
        not forced, the step is not past the latest saved one, or it is off
        the save interval while some step is saved already (orbax's rules).
        Returns whether it wrote; a forced save of a saved step raises, as
        orbax does."""
        latest = self.latest_step()
        if not force:
            if latest is not None and (latest >= step or self.save_interval <= 0 or step % self.save_interval):
                return False
        elif step in self.all_steps():
            raise FileExistsError(f"checkpoint for step {step} already exists in {self.directory}")
        tmp = os.path.join(self.directory, f".{step}.{os.getpid()}.tmp")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        torch.save(state, os.path.join(tmp, _STATE))
        if extra:
            with open(os.path.join(tmp, _EXTRA), "w") as f:
                json.dump(extra, f)
        os.replace(tmp, self._path(step))
        for old in self.all_steps()[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(self._path(old))
        return True

    def restore(self, template: Any = None, step: Optional[int] = None):
        """(state, extra) of `step` (default: the latest), or (None, None)
        when there is none. The tensors are read onto the CPU. With a
        `template` (a dict), each of its entries is loaded in place from the
        saved entry of the same key: `load_state_dict` for a module or an
        optimizer, `set_state` for a generator; any other entry is replaced.
        The template is returned as the state."""
        step = self.latest_step() if step is None else step
        if step is None:
            return None, None
        saved = torch.load(os.path.join(self._path(step), _STATE), map_location="cpu", weights_only=True, mmap=True)
        extra = None
        if os.path.exists(os.path.join(self._path(step), _EXTRA)):
            with open(os.path.join(self._path(step), _EXTRA)) as f:
                extra = json.load(f)
        if template is None:
            return saved, extra
        for k, v in template.items():
            if hasattr(v, "load_state_dict"):
                v.load_state_dict(saved[k])
            elif isinstance(v, torch.Generator):
                v.set_state(saved[k])
            else:
                template[k] = saved[k]
        return template, extra

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> list:
        return sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())

    def wait(self):
        """Saves are synchronous: nothing to wait for (orbax's are not)."""

    def close(self):
        """Nothing is held open between calls."""


def save_params_npz(path: str, params: Any) -> None:
    """A nested dict of arrays -> a flat .npz with keys joined by '/' (the
    JAX package's save_params_npz layout, which `load_params_npz` reads)."""
    flat = {}

    def walk(prefix: str, node) -> None:
        for k, v in node.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(key, v)
            else:
                flat[key] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)

    walk("", params)
    np.savez(path, **flat)


__all__ = ["CheckpointManager", "load_params_npz", "save_params_npz"]
