"""Host->device prefetching: overlap the input copy with the training step,
the counterpart of `paella_tpu/data/prefetch.py`.

`prefetch_to_device` keeps up to `size` batches in flight: each is placed in
pinned host memory and copied to the device with non_blocking copies on a
side stream, while the current step runs on the compute stream.
`background_iterator` is the JAX package's, copied.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Iterator, Optional

import numpy as np
import torch


def map_tensors(fn, item):
    """fn over the tensors and numpy arrays of nested tuples, lists, dicts
    and dataclasses; other leaves (strings, numbers) pass through."""
    if isinstance(item, (torch.Tensor, np.ndarray)):
        return fn(torch.as_tensor(item))
    if dataclasses.is_dataclass(item) and not isinstance(item, type):
        return dataclasses.replace(item, **{f.name: map_tensors(fn, getattr(item, f.name))
                                            for f in dataclasses.fields(item)})
    if isinstance(item, dict):
        return {k: map_tensors(fn, v) for k, v in item.items()}
    if isinstance(item, (tuple, list)):
        return type(item)(map_tensors(fn, v) for v in item)
    return item


def prefetch_to_device(
    iterator: Iterator,
    size: int = 2,
    device=None,
    transform: Optional[Callable] = None,
) -> Iterator:
    """Yield items from `iterator` with up to `size` batches resident on
    `device` (default: the current CUDA device), their tensors and numpy
    arrays copied there; on a CPU device the items are converted to tensors
    and yielded in order, with no copy stream.

    transform: host-side fn applied before the copy (e.g. encode_batch).

    On a CUDA device each tensor is pinned and copied non_blocking on a side
    stream; the copy's event is waited on by the consumer's current stream
    before the item is yielded, and every copied tensor is `record_stream`-ed
    on that stream, so a step never reads a half-copied batch and the
    allocator never hands its memory out while the copy still runs.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    queue = collections.deque()

    def put(item):
        if transform is not None:
            item = transform(item)
        if copy_stream is None:
            queue.append((map_tensors(lambda t: t.to(device), item), None, []))
            return
        copied = []

        def copy(t):
            if t.device == device:
                return t
            src = t.pin_memory() if t.device.type == "cpu" else t
            out = src.to(device, non_blocking=True)
            copied.append(out)
            return out

        with torch.cuda.stream(copy_stream):
            item = map_tensors(copy, item)
            done = torch.cuda.Event()
            done.record(copy_stream)
        queue.append((item, done, copied))

    def take():
        item, done, copied = queue.popleft()
        if done is not None:
            consumer = torch.cuda.current_stream(device)
            consumer.wait_event(done)
            for t in copied:
                t.record_stream(consumer)
        return item

    for item in iterator:
        put(item)
        if len(queue) >= size:
            yield take()
    while queue:
        yield take()


def background_iterator(iterator: Iterator, depth: int = 2) -> Iterator:
    """Run `iterator` in a daemon thread with a bounded queue of `depth` items.

    Host-side decode/encode work (tar IO, JPEG decode, tokenization) overlaps
    the device step this way: the producer thread fills the queue while the
    main thread waits on the device (torch releases the interpreter lock
    there, and the native decode kernels release it too). This is the role
    torch DataLoader workers play for the reference
    (src_distributed/utils.py:62) without fork-based worker processes.

    Exceptions in the producer re-raise in the consumer; the thread is a
    daemon, so an abandoned iterator cannot hang interpreter shutdown.
    """
    import queue as _queue
    import threading

    q: "_queue.Queue" = _queue.Queue(maxsize=max(1, depth))
    _END = object()

    def produce():
        try:
            for item in iterator:
                q.put(item)
        except BaseException as e:  # re-raised on the consumer side
            q.put((_END, e))
            return
        q.put((_END, None))

    threading.Thread(target=produce, daemon=True).start()
    while True:
        item = q.get()
        if isinstance(item, tuple) and len(item) == 2 and item[0] is _END:
            if item[1] is not None:
                raise item[1]
            return
        yield item
