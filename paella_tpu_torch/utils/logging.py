"""Observability: metric logging and profiling helpers, the counterpart of
`paella_tpu/utils/logging.py`.

The reference logs scalars to a tqdm bar and images/tables to wandb
(reference: src_distributed/train.py:126, 182-183) and has no profiler.
Here: a structured JSONL metric logger (machine-readable, resumable, no
external service), optional wandb passthrough when the package is present,
and a torch.profiler trace context for performance work on the card, which
turns the port's span recorder (utils/tracing.py) on while it runs.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Any, Dict, Optional


class MetricLogger:
    """Append metrics to <workdir>/metrics.jsonl and echo to stdout.

    If wandb is importable and `wandb_project` is set, mirrors metrics there
    (resuming by stored run id like the reference, src_distributed/train.py:45-46).
    """

    def __init__(
        self,
        workdir: str,
        print_every: int = 50,
        wandb_project: Optional[str] = None,
        wandb_run_name: Optional[str] = None,
    ):
        os.makedirs(workdir, exist_ok=True)
        self.path = os.path.join(workdir, "metrics.jsonl")
        self.print_every = print_every
        self._file = open(self.path, "a", buffering=1)
        self._t0 = time.time()
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                run_id_path = os.path.join(workdir, "wandb_run_id.txt")
                run_id = None
                if os.path.exists(run_id_path):
                    run_id = open(run_id_path).read().strip()
                self._wandb = wandb.init(
                    project=wandb_project, name=wandb_run_name, id=run_id, resume="allow"
                )
                with open(run_id_path, "w") as f:
                    f.write(self._wandb.id)
            except Exception as e:  # wandb absent or offline: JSONL still works
                print(f"[logging] wandb unavailable ({e}); JSONL only")

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for k, v in metrics.items():
            try:
                record[k] = float(v)
            except (TypeError, ValueError):
                record[k] = v
        self._file.write(json.dumps(record) + "\n")
        if self._wandb is not None:
            self._wandb.log(record, step=int(step))
        if self.print_every and step % self.print_every == 0:
            parts = " ".join(
                f"{k}={v:.4g}" if isinstance(v, float) else f"{k}={v}" for k, v in record.items() if k != "step"
            )
            print(f"[step {step}] {parts}", flush=True)

    def log_images(self, step: int, table: Dict[str, Any], captions=None) -> None:
        """Mirror eval images to wandb as a table (the reference logs
        Captions/Sampled/Sampled-NoImg/Orig, src_distributed/train.py:182-183).
        table: column name -> NHWC [0,1] batch. No-op without wandb."""
        if self._wandb is None:
            return
        import wandb

        cols = list(table.keys())
        n = len(next(iter(table.values())))
        data = [
            ([captions[i]] if captions is not None else [])
            + [wandb.Image(table[c][i]) for c in cols]
            for i in range(n)
        ]
        columns = (["Captions"] if captions is not None else []) + cols
        self._wandb.log({"Log": wandb.Table(data=data, columns=columns)}, step=int(step))

    def close(self):
        self._file.close()
        if self._wandb is not None:
            self._wandb.finish()


@contextlib.contextmanager
def trace(workdir: str, name: str = "trace"):
    """torch.profiler trace context (host and CUDA activity) with the port's
    span recorder on (utils/tracing.py), so the trace carries the program's
    spans as ranges of their names: the Chrome trace is written to
    <workdir>/<name>.json on exit, and the recorder's counters and gauges to
    <workdir>/<name>_counters.json beside it; the profiler itself is
    yielded, for its `key_averages()`.

    Usage: with trace("/tmp/profiles") as prof: run_steps(...)
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from . import tracing

    os.makedirs(workdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    was_on = tracing.enabled()
    tracing.enable()
    try:
        with profile(activities=activities) as prof:
            yield prof
    finally:
        if not was_on:
            tracing.disable()
    prof.export_chrome_trace(os.path.join(workdir, f"{name}.json"))
    snap = tracing.snapshot()
    with open(os.path.join(workdir, f"{name}_counters.json"), "w") as f:
        json.dump({k: snap[k] for k in ("counters", "gauges", "dropped")}, f, indent=1)


class StepTimer:
    """Rolling steps/sec and images/sec measurement."""

    def __init__(self, window: int = 50):
        self.window = window
        self._times: list[float] = []

    def tick(self) -> None:
        self._times.append(time.perf_counter())
        if len(self._times) > self.window + 1:
            self._times.pop(0)

    @property
    def steps_per_sec(self) -> float:
        if len(self._times) < 2:
            return 0.0
        dt = self._times[-1] - self._times[0]
        return (len(self._times) - 1) / dt if dt > 0 else 0.0


def save_image_grid(path: str, images, pad: int = 2) -> bool:
    """Save a [0,1] image batch as a jpg collage (the reference writes eval
    collages per checkpoint, src_distributed/train.py:174-180).

    images: NHWC (one horizontal strip) or a list/5D stack of NHWC rows — each
    row becomes one horizontal strip, rows stack vertically (the reference's
    orig/noised/reconstructed/sampled layout). Returns False if PIL is
    unavailable."""
    try:
        from PIL import Image
    except ImportError:
        return False
    import numpy as np

    rows = images if isinstance(images, (list, tuple)) else np.asarray(images)
    if not isinstance(rows, (list, tuple)) and rows.ndim == 4:
        rows = [rows]

    strips = []
    for row in rows:
        arr = np.clip(np.asarray(row, np.float32), 0.0, 1.0)
        b, h, w, c = arr.shape
        strip = np.ones((h, b * w + pad * (b - 1), c), np.float32)
        for i in range(b):
            strip[:, i * (w + pad) : i * (w + pad) + w] = arr[i]
        strips.append(strip)
    h_total = sum(s.shape[0] for s in strips) + pad * (len(strips) - 1)
    w_total = max(s.shape[1] for s in strips)
    grid = np.ones((h_total, w_total, strips[0].shape[2]), np.float32)
    y = 0
    for s in strips:
        grid[y : y + s.shape[0], : s.shape[1]] = s
        y += s.shape[0] + pad
    Image.fromarray((grid * 255).astype(np.uint8)).save(path)
    return True
