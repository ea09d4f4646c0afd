"""The port's serving layer (paella_tpu_torch/serve.py), mirroring
tests/test_serve.py: the HTTP server on a tiny pipeline (the tiny denoiser and
codec with seeded random weights and a stand-in ByT5 tower) driven through a
real socket on the CPU, plus the seed contract against the JAX package;
and the entry point, build_pipeline and `python -m paella_tpu_torch.serve`,
on tiny checkpoint files, against the JAX package's build_pipeline.
"""
import concurrent.futures
import dataclasses
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from paella_tpu.config import VQConfig as JaxVQConfig
from paella_tpu.sampling import fast_key
from paella_tpu_torch import PaellaPipeline, SampleConfig
from paella_tpu_torch import serve as serve_mod
from paella_tpu_torch.cond.t5 import T5Config
from paella_tpu_torch.config import VQConfig
from paella_tpu_torch.serve import (
    PaellaServer,
    _batch_key,
    _Job,
    build_pipeline,
    png_bytes,
    png_pixels,
    request_seeds,
    to_uint8,
)
from tests.test_loader import checkpoints  # noqa: F401  (the codec, ByT5 and CLIP files, a module-scoped fixture)
from tests.test_torch_codec import make_codec
from tests.test_torch_denoiser import make_paella

HW = 32  # image side: the tiny codec's f4 gives an 8x8 latent
REPO = Path(__file__).resolve().parents[1]


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


# ---------------------------------------------------------------------------
# the entry point: build_pipeline and `python -m paella_tpu_torch.serve`
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def entry_files(checkpoints, tmp_path_factory):  # noqa: F811
    """tests/test_loader.py's codec, ByT5 and CLIP files, plus a tiny
    denoiser (tests/test_convert.py's synthetic reference state dict) as .pt
    and as the JAX package's .npz."""
    from paella_tpu.config import PaellaConfig as JaxPaellaConfig
    from paella_tpu.convert import convert_paella
    from paella_tpu.train.checkpoints import save_params_npz
    from tests.test_convert import synth_paella_state_dict

    d = tmp_path_factory.mktemp("entry")
    c = dict(checkpoints)
    p_cfg = dataclasses.replace(JaxPaellaConfig.tiny(), byt5_embd=c["byt5_cfg"].d_model, clip_embd=c["tcfg"].embed_dim)
    sd = synth_paella_state_dict(p_cfg)
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, str(d / "denoiser.pt"))
    save_params_npz(str(d / "denoiser.npz"), convert_paella(sd, p_cfg))
    c.update(pt=str(d / "denoiser.pt"), npz=str(d / "denoiser.npz"), p_cfg=p_cfg)
    return c


def tiny_clip_configs(mp, c):
    """Both packages' build_pipeline take ViT-H-14 towers (the released
    architecture): point the configs' vit_h_14 at the files' tiny ones."""
    from paella_tpu.cond import clip as jclip
    from paella_tpu_torch.cond import clip as pclip

    for mod, port in ((jclip, False), (pclip, True)):
        for cls, cfg in ((mod.CLIPTextConfig, c["tcfg"]), (mod.CLIPVisionConfig, c["vcfg"])):
            cfg = cls(**dataclasses.asdict(cfg)) if port else cfg
            mp.setattr(cls, "vit_h_14", classmethod(lambda cls, dtype="bfloat16", cfg=cfg: cfg))


def port_build_pipeline(c, path, **kw):
    """The port's build_pipeline on the files at their tiny architectures (the
    CLIP towers' through tiny_clip_configs), on the CPU."""
    from paella_tpu_torch.config import PaellaConfig

    return build_pipeline(path, c["vqgan"], c["byt5"], p_cfg=PaellaConfig(**dataclasses.asdict(c["p_cfg"])),
                          byt5_cfg=T5Config(**dataclasses.asdict(c["byt5_cfg"])), vq_cfg=VQConfig.tiny(), device="cpu",
                          **kw)


def entry_pipelines(c, kind: str, monkeypatch):
    """The port's and the JAX package's build_pipeline on the same files, f32."""
    from paella_tpu.serve import build_pipeline as jax_build_pipeline

    kw = dict(clip_path=c["clip"], clip_bpe_path=c["bpe"], bf16=False)
    with monkeypatch.context() as mp:
        tiny_clip_configs(mp, c)
        port = port_build_pipeline(c, c[kind], **kw)
        ref = jax_build_pipeline(c[kind], c["vqgan"], c["byt5"], p_cfg=c["p_cfg"], byt5_cfg=c["byt5_cfg"],
                                 vq_cfg=JaxVQConfig.tiny(), **kw)
    return port, ref


ENTRY_PROMPTS = ["a red cat", "the catcat sat on a photo"]
ENTRY_KW = dict(steps=2, temperature=(1.0, 0.6), cfg=(3.0, 3.0))


@pytest.mark.parametrize("kind", ["pt", "npz"])
def test_build_pipeline_matches_jax(entry_files, kind, monkeypatch):
    """text_to_image with the real (tiny) CLIP and ByT5 towers as
    conditioning, 2 steps with CFG: the port's tokens against JAX's at an
    agreement share of 0.95 (as tests/test_torch_pipeline.py holds a
    multi-step run), and the decoded image in [0, 1]."""
    from paella_tpu.config import SampleConfig as JaxSampleConfig
    from tests.test_torch_sampling import seed_pairs

    port, ref = entry_pipelines(entry_files, kind, monkeypatch)
    assert port.clip_text_fn is not None and port.clip_image_fn is not None
    s = seed_pairs(2, seed=70)
    image = port.text_to_image(ENTRY_PROMPTS, torch.from_numpy(s.astype(np.int64)), (HW, HW), SampleConfig(**ENTRY_KW))
    assert image.shape == (2, HW, HW, 3) and 0.0 <= float(image.min()) <= float(image.max()) <= 1.0
    port._decode_clipped = lambda t: t
    ref._decode_clipped = lambda t: t
    got = port.text_to_image(ENTRY_PROMPTS, torch.from_numpy(s.astype(np.int64)), (HW, HW), SampleConfig(**ENTRY_KW))
    want = np.asarray(ref.text_to_image(ENTRY_PROMPTS, jax.numpy.asarray(s), (HW, HW), JaxSampleConfig(**ENTRY_KW)))
    share = float((got.numpy() == want).mean())
    print(f"build_pipeline ({kind}), 2-step CFG text_to_image with CLIP: tokens agree with JAX on {share:.4f}")
    assert got.shape == (2, HW // 4, HW // 4) and share >= 0.95


def test_build_pipeline_best_of_n_matches_jax(entry_files, monkeypatch):
    """Best-of-2 reranked by the real (tiny) CLIP towers: the port's CLIP
    scores of its candidates against JAX's (rtol 1e-3: the candidates' pixels
    agree to 1e-4), and the same pick."""
    from paella_tpu.config import SampleConfig as JaxSampleConfig
    from tests.test_torch_sampling import seed_pairs

    port, ref = entry_pipelines(entry_files, "pt", monkeypatch)
    s = seed_pairs(4, seed=71)
    images, scores = port.text_to_image_best_of(
        ENTRY_PROMPTS, torch.from_numpy(s.astype(np.int64)), 2, (HW, HW), SampleConfig(**ENTRY_KW), return_scores=True
    )
    _, want = ref.text_to_image_best_of(ENTRY_PROMPTS, jax.numpy.asarray(s), 2, (HW, HW), JaxSampleConfig(**ENTRY_KW),
                                        return_scores=True)
    assert images.shape == (2, HW, HW, 3) and scores.shape == (2, 2)
    np.testing.assert_allclose(scores.numpy(), np.asarray(want), rtol=1e-3, atol=1e-3)
    np.testing.assert_array_equal(scores.numpy().argmax(1), np.asarray(want).argmax(1))


def test_build_pipeline_pt_and_npz_agree(entry_files):
    """The .pt and the .npz of the same weights give the same model."""
    sds = [port_build_pipeline(entry_files, entry_files[k], bf16=False).model.state_dict() for k in ("pt", "npz")]
    assert sorted(sds[0]) == sorted(sds[1])
    for k, v in sds[0].items():
        torch.testing.assert_close(v, sds[1][k], rtol=0, atol=0, msg=k)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_args(c, *extra) -> list:
    return ["--denoiser", c["pt"], "--vqgan", c["vqgan"], "--byt5", c["byt5"], "--clip", c["clip"], "--clip-bpe", c["bpe"],
            *extra]


# `python -m paella_tpu_torch.serve` at the tiny architectures: the command
# line fixes the released ones, so the factories that build_pipeline and the
# loader read are pointed at the JSON of the files' configs (argv[1]) first.
SERVE_TINY = """
import dataclasses, functools, json, sys
from paella_tpu_torch import serve
from paella_tpu_torch.cond.clip import CLIPTextConfig, CLIPVisionConfig
from paella_tpu_torch.cond.t5 import T5Config
from paella_tpu_torch.config import PaellaConfig, VQConfig

archs = json.loads(sys.argv[1])
tiny = {k: cls(**{f: tuple(v) if isinstance(v, list) else v for f, v in archs[k].items()}) for k, cls in (
    ("denoiser", PaellaConfig), ("byt5", T5Config), ("vqgan", VQConfig), ("clip_text", CLIPTextConfig),
    ("clip_vision", CLIPVisionConfig))}
CLIPTextConfig.vit_h_14 = classmethod(lambda cls, dtype="bfloat16": tiny["clip_text"])
CLIPVisionConfig.vit_h_14 = classmethod(lambda cls, dtype="bfloat16": tiny["clip_vision"])
serve.build_pipeline = functools.partial(serve.build_pipeline, p_cfg=tiny["denoiser"], byt5_cfg=tiny["byt5"],
                                         vq_cfg=tiny["vqgan"])
serve.main(sys.argv[2:])
"""


def test_serve_main_on_cpu(entry_files, monkeypatch):
    """`paella_tpu_torch.serve.main` with `--device cpu`, in a process of its
    own, on the tiny files answers /healthz, then a POST with the PNG of
    build_pipeline's image for that prompt and seed (bf16 weights, as the
    command line loads them)."""
    c = entry_files
    archs = {"denoiser": c["p_cfg"], "byt5": c["byt5_cfg"], "vqgan": VQConfig.tiny(), "clip_text": c["tcfg"],
             "clip_vision": c["vcfg"]}
    archs = json.dumps({k: dataclasses.asdict(v) for k, v in archs.items()})
    port = free_port()
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    proc = subprocess.Popen([sys.executable, "-c", SERVE_TINY, archs, *serve_args(
        c, "--device", "cpu", "--host", "127.0.0.1", "--port", str(port), "--no-warmup")], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        deadline = time.monotonic() + 120
        while True:
            assert proc.poll() is None, proc.stdout.read()
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=5) as r:
                    assert r.status == 200 and r.read() == b"ok"
                break
            except (urllib.error.URLError, ConnectionError):
                assert time.monotonic() < deadline, "the server did not answer /healthz in 120 s"
                time.sleep(0.2)
        req = {"prompt": "a red cat", "seed": 5, "steps": 2, "height": HW, "width": HW}
        body = urllib.request.Request(f"http://127.0.0.1:{port}/generate", data=json.dumps(req).encode(),
                                      headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(body, timeout=300) as r:
            assert r.status == 200 and r.headers["Content-Type"] == "image/png"
            png = r.read()
    finally:
        proc.terminate()
        proc.wait(timeout=30)
    with monkeypatch.context() as mp:
        tiny_clip_configs(mp, c)
        pipe = port_build_pipeline(c, c["pt"], clip_path=c["clip"], clip_bpe_path=c["bpe"])
    want = to_uint8(pipe.text_to_image(["a red cat"], request_seeds([5]), (HW, HW), SampleConfig(steps=2, cfg=8.0)))[0]
    np.testing.assert_array_equal(png_pixels(png), want.numpy())


def test_serve_main_needs_a_card_unless_told_cpu(entry_files):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    cmd = [sys.executable, "-m", "paella_tpu_torch.serve", *serve_args(entry_files, "--port", str(free_port()))]
    out = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
