"""Input pipeline: webdataset-compatible shard reader + filters + transforms,
a copy of `paella_tpu/data/loader.py` with two changes: a host's shard slice
comes from the torch.distributed rank and world size, and the shuffle buffer
keeps its size (the JAX copy's grows by one per sample and repeats samples).

Replaces the reference's torch DataLoader stack (reference:
src_distributed/utils.py:13-62): a WebDataset tar pipeline with metadata filters,
shuffle, JPEG decode and crop transforms, and `warn_and_continue`-style error
skipping. This implementation has no torch/webdataset dependency — it reads
WebDataset-layout tar shards natively, filters on the same json metadata fields,
and yields numpy NHWC float batches ready for `prefetch_to_device`.

A synthetic dataset is provided for tests/smoke training (the minimal reference
trainer ships a placeholder dataset the same way, src/utils.py:14-17).
"""
from __future__ import annotations

import dataclasses
import io
import json
import random
import tarfile
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class SampleFilter:
    """Metadata filter with the reference's thresholds and semantics
    (reference: src_distributed/utils.py:20-52): requires the json sidecar; treats
    missing/null fields as failing defaults; optional text conditions."""

    min_size: int = 256
    max_pwatermark: float = 0.5
    aesthetic_threshold: float = 5.0
    unsafe_threshold: float = 0.99
    text_conditions: Optional[dict] = None

    def __call__(self, sample: Dict[str, bytes]) -> bool:
        def get(meta, key, default):
            # None-aware default: the reference's `x or default` idiom
            # (src_distributed/utils.py:32-37) wrongly rejects punsafe == 0.0
            # (a falsy valid value); only absent/null fields take the default here.
            v = meta.get(key)
            return default if v is None else v

        try:
            if "json" not in sample:
                return False
            meta = json.loads(sample["json"])
            ok_size = (
                get(meta, "original_width", 0.0) >= self.min_size
                and get(meta, "original_height", 0.0) >= self.min_size
            )
            ok_watermark = get(meta, "pwatermark", 1.0) <= self.max_pwatermark
            ok_aesthetic = (
                get(meta, "aesthetic", 0.0) >= self.aesthetic_threshold
                or get(meta, "AESTHETIC_SCORE", 0.0) >= self.aesthetic_threshold
            )
            ok_unsafe = get(meta, "punsafe", 1.0) <= self.unsafe_threshold
            ok_text = True
            if self.text_conditions is not None:
                caption = sample["txt"].decode("utf-8")
                tc = self.text_conditions
                ok_text = (
                    len(caption.split(" ")) >= tc.get("min_words", 0)
                    and all(ord(ch) < 128 for ch in caption)
                    and all(w not in caption.lower() for w in tc.get("forbidden_words", ()))
                )
            return bool(ok_size and ok_watermark and ok_aesthetic and ok_unsafe and ok_text)
        except Exception:
            return False


def iter_tar_samples(path: str, handler: str = "warn") -> Iterator[Dict[str, bytes]]:
    """Group tar members by key prefix (WebDataset layout: key.jpg / key.txt /
    key.json). Decode/IO errors skip the sample (the reference wraps every stage
    in warn_and_continue, src_distributed/utils.py:56-61)."""
    try:
        tf = tarfile.open(path, "r|*")
    except Exception as e:
        if handler == "warn":
            print(f"[data] failed to open shard {path}: {e}")
            return
        raise
    current_key = None
    current: Dict[str, bytes] = {}
    with tf:
        for member in tf:
            if not member.isfile():
                continue
            name = member.name
            if "." not in name:
                continue
            key, ext = name.rsplit(".", 1)
            try:
                data = tf.extractfile(member).read()
            except Exception as e:
                if handler == "warn":
                    print(f"[data] bad member {name} in {path}: {e}")
                    continue
                raise
            if key != current_key:
                if current_key is not None and current:
                    yield current
                current_key, current = key, {}
            current[ext.lower()] = data
    if current_key is not None and current:
        yield current


def decode_image(data: bytes) -> Optional[np.ndarray]:
    """JPEG/PNG bytes -> float32 RGB HWC in [0,1].

    JPEGs go through the native C++ libjpeg decoder (paella_tpu_torch.data.native)
    when available; anything else (or a failed native build) uses PIL. Returns
    None on undecodable data (caller skips, webdataset-style)."""
    if data[:3] == b"\xff\xd8\xff":  # JPEG magic
        from .native import decode_jpeg

        img = decode_jpeg(data)
        if img is not None:
            return img
    try:
        from PIL import Image
    except ImportError:
        return None
    try:
        img = Image.open(io.BytesIO(data)).convert("RGB")
        return np.asarray(img, np.float32) / 255.0
    except Exception:
        return None


def resize_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize so the shorter side == size (torchvision Resize semantics,
    reference: src_distributed/utils.py:15). Host-side only — this runs per
    image in the input pipeline, so it must never dispatch to the accelerator.
    Native C++ kernel when available, PIL otherwise."""
    h, w = img.shape[:2]
    if h < w:
        nh, nw = size, max(size, int(round(w * size / h)))
    else:
        nh, nw = max(size, int(round(h * size / w))), size
    if (nh, nw) == (h, w):
        return img

    u8 = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    from .native import resize_bilinear

    out = resize_bilinear(u8, nh, nw)
    if out is None:
        from PIL import Image

        out = np.asarray(Image.fromarray(u8).resize((nw, nh), Image.BILINEAR))
    return out.astype(np.float32) / 255.0


def random_crop(img: np.ndarray, size: int, rng: random.Random) -> np.ndarray:
    h, w = img.shape[:2]
    top = rng.randint(0, max(h - size, 0))
    left = rng.randint(0, max(w - size, 0))
    return img[top : top + size, left : left + size]


@dataclasses.dataclass
class WebDatasetLoader:
    """Streaming loader over WebDataset tar shards.

    Yields (images (B, size, size, 3) float32 NHWC, captions list[str]) batches.
    Shards are resampled indefinitely (reference: wds.WebDataset(resampled=True))
    with a shuffle buffer (reference buffer: 690) and metadata filtering.

    Multi-process training: shard_offset/shard_stride default to the
    torch.distributed rank / world size when a process group is up, 0 / 1
    otherwise (resolved lazily at iteration time, after
    parallel.initialize_distributed), so every rank reads a DISJOINT shard
    subset out of the box — the reference got per-rank streams implicitly from
    one webdataset per DDP process (src_distributed/utils.py:55-62). Pass
    explicit values to override (e.g. 0/1 to force the full set).
    """

    shards: Sequence[str]
    batch_size: int
    image_size: int = 256
    shuffle_buffer: int = 690
    filter: Optional[Callable[[Dict[str, bytes]], bool]] = dataclasses.field(
        default_factory=SampleFilter
    )
    seed: int = 0
    shard_offset: Optional[int] = None  # default: the torch.distributed rank
    shard_stride: Optional[int] = None  # default: the torch.distributed world size
    resample: bool = True
    # Parallel JPEG decode + resize + crop across a thread pool (the
    # reference ran num_workers=8 DataLoader workers,
    # src_distributed/utils.py:62). The native C++ decode/resize kernels
    # release the GIL, so threads scale across host cores — a pod host
    # feeding several chips needs >1k decodes/s, ~10x one thread.
    # 0 = inline single-threaded decoding.
    num_workers: int = 0

    def _resolve_sharding(self) -> Tuple[int, int]:
        offset, stride = self.shard_offset, self.shard_stride
        if offset is None or stride is None:
            from ..parallel.distributed import process_count, process_index

            offset = process_index() if offset is None else offset
            stride = process_count() if stride is None else stride
        return offset, stride

    def _raw_stream(self) -> Iterator[Tuple[bytes, str]]:
        """Filtered (image bytes, caption) pairs — tar IO + metadata filtering
        only; the expensive decode/resize happens downstream."""
        rng = random.Random(self.seed)
        offset, stride = self._resolve_sharding()
        shards = list(self.shards)[offset::stride]
        if not shards:
            raise ValueError(
                f"host {offset} gets no shards: {len(list(self.shards))} shard(s) "
                f"across stride {stride} — provide at least one shard per host "
                "(or set shard_offset/shard_stride explicitly)"
            )
        while True:
            order = shards[:]
            rng.shuffle(order)
            for shard in order:
                for sample in iter_tar_samples(shard):
                    if "jpg" not in sample and "png" not in sample:
                        continue
                    if "txt" not in sample:
                        continue
                    if self.filter is not None and not self.filter(sample):
                        continue
                    yield (
                        sample.get("jpg", sample.get("png")),
                        sample["txt"].decode("utf-8", errors="ignore"),
                    )
            if not self.resample:
                return

    def _decode_one(self, data: bytes, idx: int) -> Optional[np.ndarray]:
        """decode -> resize -> crop, with the crop seeded per sample index so
        worker-thread completion order cannot change the stream."""
        img = decode_image(data)
        if img is None or min(img.shape[:2]) < 2:
            return None
        img = resize_shorter_side(img, self.image_size)
        rng = random.Random((self.seed << 32) ^ idx)
        img = random_crop(img, self.image_size, rng)
        if img.shape[:2] != (self.image_size, self.image_size):
            return None
        return img

    def _sample_stream(self) -> Iterator[Tuple[np.ndarray, str]]:
        if self.num_workers <= 0:
            rng = random.Random(self.seed + 17)
            for data, caption in self._raw_stream():
                img = decode_image(data)
                if img is None or min(img.shape[:2]) < 2:
                    continue
                img = resize_shorter_side(img, self.image_size)
                img = random_crop(img, self.image_size, rng)
                if img.shape[:2] != (self.image_size, self.image_size):
                    continue
                yield img, caption
            return

        # thread-pool decode: submit up to 2*num_workers raw samples, yield
        # results in submission order (deterministic stream regardless of
        # which worker finishes first)
        import collections
        import concurrent.futures

        with concurrent.futures.ThreadPoolExecutor(self.num_workers) as pool:
            pending = collections.deque()
            raw = self._raw_stream()
            idx = 0
            depth = 2 * self.num_workers

            def refill():
                nonlocal idx
                while len(pending) < depth:
                    try:
                        data, caption = next(raw)
                    except StopIteration:
                        return False
                    pending.append((pool.submit(self._decode_one, data, idx), caption))
                    idx += 1
                return True

            more = refill()
            while pending:
                fut, caption = pending.popleft()
                img = fut.result()
                if more:
                    more = refill()
                if img is not None:
                    yield img, caption

    def __iter__(self) -> Iterator[Tuple[np.ndarray, List[str]]]:
        rng = random.Random(self.seed + 1)
        buf: List[Tuple[np.ndarray, str]] = []
        images, captions = [], []
        for item in self._sample_stream():
            if self.shuffle_buffer > 1:
                # the JAX package's loader appends the item AND swaps it in, so
                # its buffer grows by one per sample and yields duplicates;
                # here the buffer holds shuffle_buffer items and each sample
                # is yielded once
                if len(buf) < self.shuffle_buffer:
                    buf.append(item)
                    continue
                idx = rng.randrange(len(buf))
                buf[idx], item = item, buf[idx]
            images.append(item[0])
            captions.append(item[1])
            if len(images) == self.batch_size:
                yield np.stack(images), captions
                images, captions = [], []
        # drain the buffer at end-of-data (non-resampled mode)
        for item in buf:
            images.append(item[0])
            captions.append(item[1])
            if len(images) == self.batch_size:
                yield np.stack(images), captions
                images, captions = [], []


@dataclasses.dataclass
class SyntheticDataset:
    """Deterministic random images + captions for tests and smoke training."""

    batch_size: int
    image_size: int = 256
    seed: int = 0
    captions: Sequence[str] = ("a photo of a corgi", "an oil painting of the sea")

    def __iter__(self) -> Iterator[Tuple[np.ndarray, List[str]]]:
        rng = np.random.default_rng(self.seed)
        while True:
            images = rng.uniform(
                0.0, 1.0, (self.batch_size, self.image_size, self.image_size, 3)
            ).astype(np.float32)
            caps = [self.captions[i % len(self.captions)] for i in range(self.batch_size)]
            yield images, caps


def write_tar_shard(path: str, samples: Iterable[Tuple[str, Dict[str, bytes]]]) -> None:
    """Write samples ({ext: bytes}) into a WebDataset-layout tar (test utility)."""
    with tarfile.open(path, "w") as tf:
        for key, parts in samples:
            for ext, data in parts.items():
                info = tarfile.TarInfo(f"{key}.{ext}")
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
