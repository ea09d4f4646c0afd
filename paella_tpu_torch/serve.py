"""Minimal HTTP serving layer around PaellaPipeline — the counterpart of
`paella_tpu/serve.py::PaellaServer`: a dependency-free (stdlib http) server
exposing text-to-image over JSON -> PNG, with per-request seeds, steps, CFG,
negative prompts and optional micro-batching.

    POST /generate  {"prompt": "...", "steps": 8, "seed": 1,
                     "negative_prompt": "...", "cfg": 8.0,
                     "width": 256, "height": 256}        -> image/png
    GET  /healthz                                        -> 200 ok

A dispatch lock serializes only the host-side dispatch (conditioning, sampler
and decode, queued on the device); the device->host copy and the PNG encode
run outside it, so under concurrent load the next request's kernels queue
behind this one's.

Seeds: request seed s becomes the seed pair (0, s) of its image — the words
the JAX sampler reads (key data 0 and -1, sampling/sampler.py) from
`jax.random.key(s, impl="rbg")`, whose data is [0, s, 0, s] — so a request
draws the bits it draws in the JAX package, and its image depends on its own
{prompt, seed} only, alone or inside any micro-batch.

Micro-batching (max_batch > 1): concurrent requests sharing (steps, cfg,
height, width) and the ByT5 buckets of their prompts are gathered for up to
batch_window_ms and run as one sampler call, padded to a power-of-two batch;
each image is decoded at batch 1, the single path's decode. Every kernel
gives an image the same bits whatever its batchmates, so on the card too a
request's PNG is the same alone or batched.

Loading checkpoints into a pipeline (the JAX package's `build_pipeline` and
`main`) waits for the port of the text towers and their loaders.
"""
from __future__ import annotations

import concurrent.futures
import dataclasses
import itertools
import json
import queue
import struct
import threading
import time
import zlib
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Sequence

import numpy as np
import torch

from .cond.tokenizers import byt5_batch_encode, pad_bucket
from .config import SampleConfig
from .pipeline import PaellaPipeline
from .sampling.sampler import sample

_seed_counter = itertools.count()


def _fresh_seed() -> int:
    """Seed for a request that supplies none: wall-clock milliseconds mixed
    with a process-wide counter (itertools.count's __next__ is atomic under
    the GIL), so two seedless requests in the same millisecond still differ."""
    return (int(time.time() * 1e3) * 65536 + next(_seed_counter)) % (2**31)


def request_seeds(seeds: Sequence[int]) -> torch.Tensor:
    """Per-request seeds -> (B, 2) int64 seed pairs (0, s mod 2^32), one per
    image, the key words the JAX package's sampler reads for seed s."""
    return torch.tensor([[0, int(s) & 0xFFFFFFFF] for s in seeds], dtype=torch.int64)


def _png_chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data))


def png_bytes(image: np.ndarray) -> bytes:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG (no filtering), with stdlib zlib."""
    if image.dtype != np.uint8 or image.ndim != 3 or image.shape[2] != 3:
        raise ValueError(f"png_bytes takes (H, W, 3) uint8, got {image.shape} {image.dtype}")
    h, w, _ = image.shape
    raw = np.concatenate([np.zeros((h, 1), np.uint8), image.reshape(h, w * 3)], axis=1)
    return (
        b"\x89PNG\r\n\x1a\n"
        + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
        + _png_chunk(b"IEND", b"")
    )


def png_pixels(png: bytes) -> np.ndarray:
    """The inverse of :func:`png_bytes`, for the PNGs it writes (8-bit RGB,
    filter 0): -> (H, W, 3) uint8."""
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError("not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(png):
        (n,) = struct.unpack(">I", png[pos : pos + 4])
        kind, data = png[pos + 4 : pos + 8], png[pos + 8 : pos + 8 + n]
        if kind == b"IHDR":
            size = struct.unpack(">II", data[:8])
            if data[8:] != bytes([8, 2, 0, 0, 0]):
                raise ValueError("png_pixels reads 8-bit RGB, unfiltered, non-interlaced PNGs only")
        elif kind == b"IDAT":
            idat += data
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + w * 3)
    if rows[:, 0].any():
        raise ValueError("png_pixels reads unfiltered rows only")
    return rows[:, 1:].reshape(h, w, 3).copy()


def to_uint8(images: torch.Tensor) -> torch.Tensor:
    """[0, 1] images -> uint8 by truncation, as the JAX server's
    `(x * 255).astype(uint8)`."""
    return (images * 255).to(torch.uint8)


@dataclasses.dataclass
class _Job:
    """One queued request in micro-batching mode."""

    req: dict
    done: threading.Event
    result: Optional[np.ndarray] = None
    error: Optional[BaseException] = None


def _text_bucket(text: str, max_length: int) -> int:
    """The ByT5 length a prompt is padded to on its own (pipeline.encode_text)."""
    return pad_bucket(byt5_batch_encode([text], max_length=max_length)[0].shape[1])


def _batch_key(req: dict, max_length: int = 768):
    """Requests batch together iff they share the sampler call's shapes and
    its per-batch cfg schedule. The shapes include the ByT5 buckets of the
    prompt and the negative prompt: a batch pads its prompts to its longest
    one, and on the card attention over another padded length sums the same
    keys in other groups, so only requests whose own buckets agree get their
    single-request bits inside a batch."""
    return (
        int(req.get("steps", 8)),
        float(req.get("cfg", 8.0)),
        int(req.get("height", 256)),
        int(req.get("width", 256)),
        _text_bucket(req.get("prompt", ""), max_length),
        _text_bucket(req.get("negative_prompt") or "", max_length),
    )


class PaellaServer:
    """Wraps a PaellaPipeline behind a threaded HTTP server.

    max_batch > 1 enables micro-batching (see the module docstring). Every
    request's seed becomes its own image's seed pair, so {prompt, seed} gives
    the same tokens in both modes. port=0 binds a free port; after start(),
    `port` holds the one the OS assigned.
    """

    def __init__(
        self,
        pipeline: PaellaPipeline,
        host: str = "0.0.0.0",
        port: int = 8000,
        max_batch: int = 1,
        batch_window_ms: float = 10.0,
    ):
        self.pipeline = pipeline
        self.host = host
        self.port = port
        self.max_batch = max(1, int(max_batch))
        self.batch_window_ms = batch_window_ms
        self._dispatch_lock = threading.Lock()
        self._server: Optional[ThreadingHTTPServer] = None
        self._queue: "queue.Queue[_Job]" = queue.Queue()
        self._stop_batcher = threading.Event()
        self._batcher: Optional[threading.Thread] = None
        self._completion = concurrent.futures.ThreadPoolExecutor(max_workers=2)

    # -- single-request path ------------------------------------------------

    def _generate_single(self, req: dict) -> np.ndarray:
        prompt = req.get("prompt", "")
        seed = int(req.get("seed", _fresh_seed()))
        negative = req.get("negative_prompt")
        cfg = SampleConfig(steps=int(req.get("steps", 8)), cfg=req.get("cfg", 8.0))
        hw = (int(req.get("height", 256)), int(req.get("width", 256)))
        with self._dispatch_lock:
            img = self.pipeline.text_to_image(
                [prompt], request_seeds([seed]), hw, cfg, negative_prompts=[negative] if negative else None
            )
            img = to_uint8(img[0])
        return img.cpu().numpy()  # the device->host copy outside the lock

    # -- micro-batching path ------------------------------------------------

    def _batch_loop(self):
        while not self._stop_batcher.is_set():
            try:
                first = self._queue.get(timeout=0.2)
            except queue.Empty:
                continue
            jobs = [first]
            max_length = self.pipeline.byt5_max_length
            key = _batch_key(first.req, max_length)
            deadline = time.perf_counter() + self.batch_window_ms / 1e3
            incompatible = []
            while len(jobs) < self.max_batch:
                wait = deadline - time.perf_counter()
                if wait <= 0:
                    break
                try:
                    j = self._queue.get(timeout=wait)
                except queue.Empty:
                    break
                (jobs if _batch_key(j.req, max_length) == key else incompatible).append(j)
            for j in incompatible:
                self._queue.put(j)  # the next round forms their batch
            self._run_batch(jobs, key)

    def _run_batch(self, jobs, key):
        steps, cfg_w, h, w = key[:4]
        try:
            n = len(jobs)
            b = 1
            while b < n:
                b *= 2  # power-of-two batches
            prompts = [j.req.get("prompt", "") for j in jobs] + [""] * (b - n)
            negatives = [j.req.get("negative_prompt") or "" for j in jobs] + [""] * (b - n)
            # one seed pair per image from its request's own seed (padding
            # slots take seed 0; their tokens are dropped)
            seeds = request_seeds([int(j.req.get("seed", _fresh_seed())) for j in jobs] + [0] * (b - n))
            pipe = self.pipeline
            with self._dispatch_lock:
                cond = pipe.conditioning(prompts)
                # a job without a negative prompt gets "", the single path's
                # null conditioning
                uncond = pipe.conditioning(negatives) if any(negatives) else pipe.null_conditioning(b)
                lh, lw = pipe._latent_hw((h, w))
                tokens = sample(pipe.model, seeds, cond, (b, lh, lw), uncond, SampleConfig(steps=steps, cfg=cfg_w))
                # each image through the single path's batch-1 decode: the
                # contract covers the PNG, and a convolution's sums may
                # differ between batch sizes
                imgs = [to_uint8(pipe._decode_clipped(tokens[i : i + 1])[0]) for i in range(n)]
            # the blocking device->host copy goes to a completion worker, so
            # the batcher dispatches the next batch right away
            self._completion.submit(self._finish_batch, jobs, imgs)
        except Exception as e:  # every waiting handler gets the error
            for j in jobs:
                j.error = e
                j.done.set()

    @staticmethod
    def _finish_batch(jobs, imgs):
        try:
            for j, img in zip(jobs, imgs):
                j.result = img.cpu().numpy()
            for j in jobs:
                j.done.set()
        except Exception as e:
            for j in jobs:
                j.error = e
                j.done.set()

    def generate(self, req: dict) -> bytes:
        if self.max_batch <= 1 or self._batcher is None:
            return png_bytes(self._generate_single(req))
        job = _Job(req, threading.Event())
        self._queue.put(job)
        if not job.done.wait(timeout=3600):
            raise TimeoutError("generation timed out")
        if job.error is not None:
            raise job.error
        return png_bytes(job.result)

    def warmup(self, image_hw=(256, 256), steps: int = 8):
        """Build the kernels and fill the caches before accepting traffic."""
        self.generate({"prompt": "warmup", "steps": steps, "seed": 0, "height": image_hw[0], "width": image_hw[1]})

    def _handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # quiet
                pass

            def _reply(self, code: int, ctype: str, body: bytes, extra: Optional[dict] = None):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in (extra or {}).items():
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, "text/plain", b"ok")
                else:
                    self.send_error(404)

            def do_POST(self):
                if self.path != "/generate":
                    self.send_error(404)
                    return
                try:
                    length = int(self.headers.get("Content-Length", 0))
                    req = json.loads(self.rfile.read(length) or b"{}")
                    t0 = time.perf_counter()
                    png = server.generate(req)
                    dt = time.perf_counter() - t0
                    self._reply(200, "image/png", png, {"X-Generation-Seconds": f"{dt:.3f}"})
                except (ValueError, KeyError, TypeError) as e:  # json.JSONDecodeError is a ValueError
                    self._reply(400, "application/json", json.dumps({"error": str(e)}).encode())
                except Exception as e:  # a device or batching fault
                    self._reply(500, "application/json", json.dumps({"error": f"{type(e).__name__}: {e}"}).encode())

        return Handler

    def start(self) -> ThreadingHTTPServer:
        if self.max_batch > 1 and self._batcher is None:
            self._stop_batcher.clear()
            self._batcher = threading.Thread(target=self._batch_loop, daemon=True)
            self._batcher.start()
        self._server = ThreadingHTTPServer((self.host, self.port), self._handler())
        self.port = self._server.server_address[1]
        threading.Thread(target=self._server.serve_forever, daemon=True).start()
        return self._server

    def stop(self):
        if self._batcher is not None:
            self._stop_batcher.set()
            self._batcher.join(timeout=5)
            self._batcher = None
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        # let pending completions finish; a fresh pool (no threads until its
        # first task) serves a later start()
        self._completion.shutdown(wait=True)
        self._completion = concurrent.futures.ThreadPoolExecutor(max_workers=2)

    def serve_forever(self):
        self.start()
        print(f"paella_tpu_torch serving on http://{self.host}:{self.port}")
        try:
            while True:
                time.sleep(3600)
        except KeyboardInterrupt:
            self.stop()
