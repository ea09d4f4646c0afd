"""The port's serving layer (paella_tpu_torch/serve.py), mirroring
tests/test_serve.py: the HTTP server on a tiny pipeline (the tiny denoiser and
codec with seeded random weights and a stand-in ByT5 tower) driven through a
real socket on the CPU, plus the seed contract against the JAX package.
"""
import concurrent.futures
import io
import json
import threading
import time
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch

from paella_tpu.sampling import fast_key
from paella_tpu_torch import PaellaPipeline, SampleConfig
from paella_tpu_torch import serve as serve_mod
from paella_tpu_torch.serve import PaellaServer, _batch_key, _Job, png_bytes, png_pixels, request_seeds, to_uint8
from tests.test_torch_codec import make_codec
from tests.test_torch_denoiser import make_paella

HW = 32  # image side: the tiny codec's f4 gives an 8x8 latent


def tiny_pipeline() -> PaellaPipeline:
    model, _, _ = make_paella(seed=60)
    vq, _, _ = make_codec(seed=61)
    table = torch.from_numpy(np.random.default_rng(62).standard_normal((260, model.config.byt5_embd)).astype(np.float32))
    return PaellaPipeline(model, vq, lambda ids, mask: table[ids.long()])


@pytest.fixture(scope="module")
def pipeline():
    return tiny_pipeline()


@pytest.fixture(scope="module")
def server(pipeline):
    srv = PaellaServer(pipeline, host="127.0.0.1", port=0)
    srv.start()
    yield srv
    srv.stop()


@pytest.fixture(scope="module")
def batched_server(pipeline):
    srv = PaellaServer(pipeline, host="127.0.0.1", port=0, max_batch=4, batch_window_ms=200)
    srv.start()
    yield srv
    srv.stop()


def post(srv: PaellaServer, body: bytes, timeout: float = 300):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}/generate", data=body, headers={"Content-Type": "application/json"}
    )
    return urllib.request.urlopen(req, timeout=timeout)


def generate(srv: PaellaServer, **req) -> bytes:
    with post(srv, json.dumps({"steps": 2, "height": HW, "width": HW, **req}).encode()) as r:
        assert r.status == 200
        return r.read()


def test_healthz(server):
    assert server.port != 0
    with urllib.request.urlopen(f"http://127.0.0.1:{server.port}/healthz", timeout=30) as r:
        assert r.status == 200
        assert r.read() == b"ok"


def test_generate_png_is_the_pipeline_image(server, pipeline):
    body = json.dumps({"prompt": "a corgi", "steps": 2, "seed": 7, "height": HW, "width": HW}).encode()
    with post(server, body) as r:
        assert r.headers["Content-Type"] == "image/png"
        assert float(r.headers["X-Generation-Seconds"]) > 0
        png = r.read()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    want = to_uint8(pipeline.text_to_image(["a corgi"], request_seeds([7]), (HW, HW), SampleConfig(steps=2)))[0].numpy()
    np.testing.assert_array_equal(png_pixels(png), want)
    try:
        from PIL import Image
    except ImportError:
        pass
    else:
        np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(png)).convert("RGB")), want)
    # the same seed: the same bytes; another seed: another image
    with post(server, body) as r:
        assert r.read() == png
    assert generate(server, prompt="a corgi", seed=8) != png


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31 - 1])
def test_request_seeds_are_the_jax_key_words(seed):
    """The JAX server keys a request by fast_key(seed) and its sampler reads
    key data words 0 and -1; the port's seed pair is those two words."""
    want = np.asarray(jax.random.key_data(fast_key(seed)))[[0, -1]]
    np.testing.assert_array_equal(request_seeds([seed]).numpy()[0], want.astype(np.int64))


def test_png_round_trip():
    img = np.random.default_rng(0).integers(0, 256, (5, 7, 3)).astype(np.uint8)
    np.testing.assert_array_equal(png_pixels(png_bytes(img)), img)
    with pytest.raises(ValueError):
        png_bytes(img.astype(np.float32))


def test_seedless_requests_unique(server, monkeypatch):
    """Two seedless requests in the same millisecond still get different
    seeds (the counter), and two seedless requests get different images."""
    with monkeypatch.context() as mp:
        frozen = time.time()
        mp.setattr(serve_mod.time, "time", lambda: frozen)
        seeds = [serve_mod._fresh_seed() for _ in range(256)]
    assert len(set(seeds)) == len(seeds)
    assert generate(server, prompt="a corgi") != generate(server, prompt="a corgi")


@pytest.mark.parametrize("body", [b"{not json", b'{"steps": "eight"}'])
def test_bad_request(server, body):
    with pytest.raises(urllib.error.HTTPError) as e:
        post(server, body, timeout=60)
    assert e.value.code == 400


def test_batched_generate(batched_server):
    """Concurrent compatible requests ride one batch; an incompatible one
    (other steps) completes in its own."""
    with concurrent.futures.ThreadPoolExecutor(max_workers=5) as ex:
        futs = [ex.submit(generate, batched_server, prompt=f"cat {s}", seed=s) for s in range(4)]
        futs.append(ex.submit(generate, batched_server, prompt="cat", seed=99, steps=3))
        pngs = [f.result() for f in futs]
    assert all(p[:8] == b"\x89PNG\r\n\x1a\n" for p in pngs)
    assert len(set(pngs[:4])) > 1


def test_batched_seed_determinism(pipeline):
    """{prompt, seed} gives the same image alone or in any micro-batch,
    padded (3 jobs -> 4) or not, in any position."""
    srv = PaellaServer(pipeline, max_batch=4)
    reqs = [
        {"prompt": "a corgi", "steps": 2, "seed": 7, "height": HW, "width": HW},
        {"prompt": "an oil painting of a lighthouse in a storm", "steps": 2, "seed": 11, "height": HW, "width": HW},
        {"prompt": "cat", "steps": 2, "seed": 7, "height": HW, "width": HW},
    ]

    def run_batch(batch_reqs):
        jobs = [_Job(r, threading.Event()) for r in batch_reqs]
        srv._run_batch(jobs, (2, 8.0, HW, HW))
        for j in jobs:
            assert j.done.wait(600)
            assert j.error is None, j.error
        return [j.result for j in jobs]

    batched = run_batch(reqs)
    singles = [srv._generate_single(r) for r in reqs]
    for got, want in zip(batched, singles):
        np.testing.assert_array_equal(got, want)
    re_batched = run_batch([reqs[2], reqs[0], reqs[1], reqs[1]])
    for got, want in zip(re_batched, [singles[2], singles[0], singles[1], singles[1]]):
        np.testing.assert_array_equal(got, want)
    srv.stop()


def test_batch_key_grouping():
    a = {"steps": 8, "cfg": 8.0, "height": 256, "width": 256}
    assert _batch_key(a) == _batch_key({**a, "prompt": "x", "seed": 5})
    assert _batch_key(a) != _batch_key({**a, "steps": 12})
    assert _batch_key(a) != _batch_key({**a, "cfg": 4.0})
    assert _batch_key(a) != _batch_key({**a, "width": 512})
    # prompts batch together only within one ByT5 bucket (64, 128, ...)
    assert _batch_key({**a, "prompt": "a corgi"}) == _batch_key({**a, "prompt": "x" * 63})
    assert _batch_key({**a, "prompt": "a corgi"}) != _batch_key({**a, "prompt": "x" * 64})
    assert _batch_key(a) != _batch_key({**a, "negative_prompt": "x" * 200})


def test_batched_error_isolation(batched_server):
    """A request that fails (a size the UNet cannot take) gets its own error
    response; the good requests around it still get their images."""

    def fire(seed, h=HW):
        try:
            with post(batched_server, json.dumps({"prompt": "ok", "steps": 2, "seed": seed, "height": h, "width": HW}).encode()) as r:
                return r.status, r.read()[:8]
        except urllib.error.HTTPError as e:
            return e.code, b""

    with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
        good = [ex.submit(fire, s) for s in range(3)]
        bad = ex.submit(fire, 50, HW - 1)
        results = [f.result() for f in good]
        bad_status, _ = bad.result()
    assert all(status == 200 and magic == b"\x89PNG\r\n\x1a\n" for status, magic in results)
    assert bad_status in (400, 500)
