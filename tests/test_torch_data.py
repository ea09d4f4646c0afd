"""The port's input pipeline (data/) against the JAX package's on the CPU:
tests/test_data.py's cases run through both packages on the same shards and
arrays (filter semantics, the tar round trip and loader, the shorter-side
resize, the synthetic dataset, threaded decode, no shards for a host, the
background iterator), the native decoder's source byte for byte the JAX
package's, its decode equal to JAX's on the same JPEG bytes, and
prefetch_to_device on the CPU."""
import filecmp
import io
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import paella_tpu.data as jdata
import paella_tpu_torch.data as tdata
from tests.test_data import GOOD_META, png_bytes

REPO = Path(__file__).resolve().parent.parent


def test_native_source_is_the_jax_packages():
    assert filecmp.cmp(REPO / "paella_tpu/data/native/paella_native.cpp",
                       REPO / "paella_tpu_torch/data/native/paella_native.cpp", shallow=False)


def test_native_builds_outside_the_source_tree():
    """The extension lands in the ignored build/paella_tpu_torch/, named by a
    hash of its source, never beside the source."""
    from paella_tpu_torch.data.native import get_native, library_path

    assert get_native() is not None, "native extension failed to build"
    path = Path(library_path())
    assert path.exists() and path.parent == REPO / "build" / "paella_tpu_torch"
    assert not list((REPO / "paella_tpu_torch/data/native").glob("*.so"))
    assert tdata.jpeg_decoder() == "native"


def test_sample_filter_matches_jax():
    """reference: src_distributed/utils.py:28-52 (tests/test_data.py::test_sample_filter_semantics)"""
    def meta(**kw):
        return json.dumps({"original_width": 512, "original_height": 512, "pwatermark": 0.1, "punsafe": 0.0, **kw}).encode()

    cases = [{"json": GOOD_META, "txt": b"hi"}, {"txt": b"no json"}, {"json": meta(original_width=100, aesthetic=6.0)},
             {"json": meta(AESTHETIC_SCORE=6.0)}, {"json": b"{bad"}, {"json": meta(aesthetic=6.0, punsafe=None)},
             {"json": meta(aesthetic=6.0, punsafe=0.0)}, {"json": GOOD_META, "txt": b"two words"},
             {"json": GOOD_META, "txt": b"one"}, {"json": GOOD_META, "txt": b"really bad words"}]
    for kw in ({"min_size": 256}, {"text_conditions": {"min_words": 2, "forbidden_words": ["bad"]}}):
        got = [tdata.SampleFilter(**kw)(c) for c in cases]
        assert got == [jdata.SampleFilter(**kw)(c) for c in cases]
        assert any(got) and not all(got)


@pytest.fixture(scope="module")
def shard(tmp_path_factory):
    pytest.importorskip("PIL")
    path = str(tmp_path_factory.mktemp("shards") / "shard-000.tar")
    tdata.write_tar_shard(path, [
        (f"{i:05d}", {"png": png_bytes(300, 400, i), "txt": f"caption {i}".encode(), "json": GOOD_META})
        for i in range(8)
    ])
    return path


def stream(pkg, shard: str, **kw):
    loader = pkg.WebDatasetLoader([shard], batch_size=2, image_size=64, resample=False, **kw)
    caps, imgs = [], []
    for images, captions in loader:
        caps += captions
        imgs.append(images)
    return caps, np.concatenate(imgs)


@pytest.mark.parametrize("kw", [dict(shuffle_buffer=1), dict(shuffle_buffer=1, num_workers=3, seed=3)])
def test_loader_stream_equals_jax(shard, kw):
    """The tar round trip and the loader (inline and on a thread pool),
    unshuffled: the same captions in the same order and the same images,
    bit for bit (tests/test_data.py::test_tar_roundtrip_and_loader,
    ::test_parallel_decode_workers)."""
    samples = list(tdata.iter_tar_samples(shard))
    assert len(samples) == 8 and set(samples[0]) == {"png", "txt", "json"}
    caps, imgs = stream(tdata, shard, **kw)
    want_caps, want_imgs = stream(jdata, shard, **kw)
    assert caps == want_caps and len(caps) == 8
    assert imgs.shape == (8, 64, 64, 3) and imgs.dtype == np.float32
    np.testing.assert_array_equal(imgs, want_imgs)


def test_shuffle_buffer_yields_each_sample_once(shard):
    """A fault of the JAX loader the port does not copy: its shuffle buffer
    appends each sample and also swaps it in, so the buffer grows by one a
    sample (without bound on a resampled stream) and samples repeat. The
    port's buffer holds shuffle_buffer samples: every sample once, shuffled,
    the images those of the unshuffled stream."""
    caps, imgs = stream(tdata, shard, shuffle_buffer=4)
    want_caps, want_imgs = stream(tdata, shard, shuffle_buffer=1)
    assert sorted(caps) == sorted(want_caps) and len(caps) == 8 and caps != want_caps
    for c, img in zip(caps, imgs):
        np.testing.assert_array_equal(img, want_imgs[want_caps.index(c)])
    jax_caps, _ = stream(jdata, shard, shuffle_buffer=4)
    assert len(jax_caps) > len(set(jax_caps)) == 8


def test_resize_and_jpeg_decode_equal_jax():
    """The shorter-side resize (native bilinear) on the same array, and the
    native JPEG decode on the same bytes, bit for bit; garbage decodes to None."""
    pytest.importorskip("PIL")
    from PIL import Image

    from paella_tpu.data.native import decode_jpeg as jax_decode
    from paella_tpu_torch.data.native import decode_jpeg

    img = np.random.default_rng(0).uniform(size=(100, 200, 3)).astype(np.float32)
    got = tdata.resize_shorter_side(img, 64)
    assert got.shape == (64, 128, 3)
    np.testing.assert_array_equal(got, jdata.resize_shorter_side(img, 64))
    assert tdata.resize_shorter_side(np.zeros((200, 100, 3), np.float32), 64).shape == (128, 64, 3)
    buf = io.BytesIO()
    Image.fromarray((img * 255).astype(np.uint8)).save(buf, format="JPEG", quality=90)
    data = buf.getvalue()
    got = tdata.decode_image(data)
    assert got is not None and got.shape == (100, 200, 3)
    np.testing.assert_array_equal(got, jdata.decode_image(data))
    np.testing.assert_array_equal(decode_jpeg(data), jax_decode(data))
    assert decode_jpeg(b"\xff\xd8\xffgarbage") is None


def test_synthetic_dataset_equals_jax():
    for pkg in (tdata, jdata):
        images, caps = next(iter(pkg.SyntheticDataset(batch_size=3, image_size=32, seed=4)))
        assert images.shape == (3, 32, 32, 3) and len(caps) == 3
    got, want = next(iter(tdata.SyntheticDataset(3, 32, 4))), next(iter(jdata.SyntheticDataset(3, 32, 4)))
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_no_shards_for_host_raises():
    loader = tdata.WebDatasetLoader([], batch_size=1, shard_offset=0, shard_stride=1, resample=False)
    with pytest.raises(ValueError, match="no shards"):
        next(iter(loader))


def test_default_sharding_is_rank_zero_of_one_without_a_process_group():
    loader = tdata.WebDatasetLoader(["a", "b", "c"], batch_size=1)
    assert loader._resolve_sharding() == (0, 1)
    assert tdata.WebDatasetLoader(["a"], batch_size=1, shard_offset=1, shard_stride=3)._resolve_sharding() == (1, 3)


def test_background_iterator():
    """In order, tuples untouched, producer exceptions re-raised in the
    consumer (tests/test_data.py::test_background_iterator)."""
    assert list(tdata.background_iterator(iter(range(20)), depth=3)) == list(range(20))
    items = [(np.ones((2, 2)), ["a", "b"]), (np.zeros((2, 2)), ["c"])]
    got = list(tdata.background_iterator(iter(items), depth=2))
    assert len(got) == 2 and got[0][1] == ["a", "b"]

    def boom():
        yield 1
        raise RuntimeError("producer died")

    it = tdata.background_iterator(boom(), depth=2)
    assert next(it) == 1
    with pytest.raises(RuntimeError, match="producer died"):
        list(it)


def test_prefetch_to_device_on_the_cpu():
    """Every item, in order, transformed, its arrays as tensors on the
    device; strings and dataclass fields pass through
    (tests/test_data.py::test_prefetch_to_device)."""
    from paella_tpu_torch.train import Batch

    items = [np.ones((2, 4), np.float32) * i for i in range(5)]
    out = list(tdata.prefetch_to_device(iter(items), size=2, device="cpu", transform=lambda x: x + 1))
    assert len(out) == 5 and all(isinstance(t, torch.Tensor) and t.device.type == "cpu" for t in out)
    np.testing.assert_array_equal(out[3].numpy(), items[3] + 1)
    b = Batch(*(torch.zeros(1) for _ in range(5)))
    got = list(tdata.prefetch_to_device(iter([(b, ["x"])]), device="cpu"))
    assert isinstance(got[0][0], Batch) and got[0][1] == ["x"]


@pytest.mark.cuda
def test_prefetch_to_device_on_the_card():
    """On a card: batches copied on the side stream, each read by a kernel on
    the compute stream as soon as it is yielded, equal the host arrays (the
    consumer waits on the copy; the allocator keeps the memory until the
    compute stream is done with it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the side-stream copy exists only there")
    rng = np.random.default_rng(0)
    items = [(rng.standard_normal((8, 256, 256, 3)).astype(np.float32), [f"c{i}"]) for i in range(6)]
    got = [t.clone() for t, _ in tdata.prefetch_to_device(iter(items), size=3)]
    for g, (a, _) in zip(got, items):
        assert torch.equal(g.cpu(), torch.from_numpy(a))
