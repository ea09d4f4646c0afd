"""The port's production entry points (paella_tpu_torch/scripts/) against the
JAX repo's scripts (scripts/run_driver_e2e.py, run_codec_pretrain.py,
run_eval_e2e.py, loaded with importlib and left as they are), on the CPU at
the tiny configs.

- make_encode_fns against the JAX script's own encode_batch: one set of
  seeded numpy weights in the torch layouts (HF T5, open_clip) goes into the
  port's towers directly and into the JAX script's towers through the JAX
  converters (convert_t5_encoder, convert_open_clip_text/vision), cast to
  bf16 as the script casts them; the JAX script's closures are pointed at
  those trees (its towers are seeded by PRNGKey otherwise). Tolerance: the
  ByT5 states and the CLIP embeddings within 2% of the largest value (each
  framework rounds its bf16 weights' products on its own), masks and the
  stand-in CLIP ids exact.
- make_geometry equals the JAX script's for every name, field for field.
- token_stats / js_div / the projection: the JAX script's own statements
  (taken from its source with ast) on the same token arrays; exact.
- the codec bridge: a JAX VQConfig.tiny() state saved by the JAX package
  loads through the port's --codec path and decodes as JAX does (1e-4); the
  port's codec_vars.npz loads in JAX with identical keys, shapes and dtypes.
- the three CLIs under --smoke to their JSON lines: codec pretraining, the
  driver with a SIGTERM and a fresh-process resume to the last step, and
  the eval in image space, with --real-recon, and in token space with
  --w8a8, each with --trend over the driver's checkpoints.
"""
import ast
import dataclasses
import importlib.util
import json
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paella_tpu import quant as jquant
from paella_tpu.codec import VQModel as JaxVQModel
from paella_tpu.cond import clip as jclip
from paella_tpu.cond import t5 as jt5
from paella_tpu.config import VQConfig as JaxVQConfig
from paella_tpu.train.checkpoints import load_params_npz as jax_load_params_npz
from paella_tpu.train.checkpoints import save_params_npz as jax_save_params_npz
from paella_tpu_torch.codec import VQModel
from paella_tpu_torch.cond import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder, T5Config, T5Encoder
from paella_tpu_torch.cond.clip import split_open_clip
from paella_tpu_torch.config import VQConfig
from paella_tpu_torch.quant import quantize_t5_int8
from paella_tpu_torch.scripts import run_driver_e2e as drv
from paella_tpu_torch.scripts import run_eval_e2e as ev
from paella_tpu_torch.train.driver import eval_seeds
from tests.test_torch_clip import open_clip_state_dict

REPO = Path(__file__).resolve().parents[1]
BUCKET = 16  # the smoke runs' byte bucket
CAPTIONS = ["a photo of a corgi", "", "an oil painting of a lighthouse in a storm at dusk", "café au lait ☕"]


def jax_script(name: str):
    """The JAX repo's scripts/<name>.py as a module (its main() is not run)."""
    spec = importlib.util.spec_from_file_location(f"_jax_{name}", REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cells(fn) -> dict:
    """A closure's free variables, name -> cell."""
    return dict(zip(fn.__code__.co_freevars, fn.__closure__))


def t5_state_dict(cfg: T5Config, seed: int = 0) -> dict:
    """Seeded numpy weights in the HF T5EncoderModel layout the port loads:
    N(0, 1) embedding and bias table, N(0, 1/fan_in) linears, norms 1 + 0.1 N."""
    rng = np.random.default_rng(seed)
    sd = {}
    for k, v in T5Encoder(cfg).state_dict().items():
        shape = tuple(v.shape)
        if k.endswith("layer_norm.weight"):
            a = 1 + 0.1 * rng.standard_normal(shape)
        elif "shared" in k or "relative_attention_bias" in k:
            a = rng.standard_normal(shape)
        else:
            a = rng.standard_normal(shape) * shape[1] ** -0.5
        sd[k] = a.astype(np.float32)
    return sd


def to_bf16(tree):
    """The JAX script's cast of a tower's tree: every float leaf to bf16."""
    return jax.tree_util.tree_map(lambda x: jnp.asarray(x).astype(jnp.bfloat16), tree)


def port_towers(t5_sd: dict, clip_sd: dict, mode: str):
    """The port's towers holding the numpy weights, cast to bf16 and, in
    mode w8a8, the ByT5 block linears quantized (build_encoders' recipe)."""
    t5 = T5Encoder(dataclasses.replace(T5Config.tiny(), act_quant=mode == "w8a8"))
    t5.load_state_dict({k: torch.from_numpy(v) for k, v in t5_sd.items()}, strict=True)
    t5 = t5.to(torch.bfloat16).eval()
    if mode == "w8a8":
        t5 = quantize_t5_int8(t5)
    text_sd, vision_sd = split_open_clip(clip_sd)
    text, vision = CLIPTextEncoder(CLIPTextConfig.tiny()), CLIPVisionEncoder(CLIPVisionConfig.tiny())
    text.load_state_dict({k: torch.from_numpy(v) for k, v in text_sd.items()}, strict=True)
    vision.load_state_dict({k: torch.from_numpy(v) for k, v in vision_sd.items()}, strict=True)
    return t5, text.to(torch.bfloat16).eval(), vision.to(torch.bfloat16).eval()


@pytest.fixture(scope="module")
def encoders():
    """JAX's smoke encode_batch with its towers pointed at the converted
    numpy weights, and the port's make_encode_fns over the same weights,
    for both ByT5 modes."""
    jdrv = jax_script("run_driver_e2e")
    t5_sd, clip_sd = t5_state_dict(T5Config.tiny()), open_clip_state_dict()
    jax_trees = {
        "t5_params": to_bf16(jt5.convert_t5_encoder(t5_sd, jt5.T5Config.tiny())),
        "txt_params": to_bf16(jclip.convert_open_clip_text(clip_sd, jclip.CLIPTextConfig.tiny())),
        "vis_params": to_bf16(jclip.convert_open_clip_vision(clip_sd, jclip.CLIPVisionConfig.tiny())),
    }
    out = {}
    for mode in ("bf16", "w8a8"):
        encode_batch, _null, _, _ = jdrv.build_encoders(
            types.SimpleNamespace(smoke=True, byt5=mode, byt5_bucket=BUCKET), jax, jnp)
        fns = cells(encode_batch)
        trees = dict(jax_trees)
        if mode == "w8a8":
            trees["t5_params"] = jquant.quantize_t5_int8(trees["t5_params"])
        for fn, name in (("byt5_encode", "t5_params"), ("clip_text_encode", "txt_params"),
                         ("clip_image_encode", "vis_params")):
            cells(fns[fn].cell_contents)[name].cell_contents = trees[name]
        port = drv.make_encode_fns(*port_towers(t5_sd, clip_sd, mode), BUCKET, "cpu")
        out[mode] = (encode_batch, port)
    return out


def close(got: torch.Tensor, want, share: float = 0.02) -> None:
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= share * np.abs(want).max(), np.abs(got - want).max()


@pytest.mark.parametrize("mode", ["bf16", "w8a8"])
def test_encode_batch_matches_the_jax_script(encoders, mode):
    jax_encode, (encode_batch, null) = encoders[mode]
    images = np.random.default_rng(4).uniform(size=(len(CAPTIONS), 64, 64, 3)).astype(np.float32)
    want, got = jax_encode(images, CAPTIONS), encode_batch(images, CAPTIONS)
    np.testing.assert_array_equal(got.images.numpy(), images)
    np.testing.assert_array_equal(got.byt5_mask.numpy(), np.asarray(want.byt5_mask))
    assert got.byt5.shape == (len(CAPTIONS), BUCKET, 32) and got.clip.shape == got.clip_image.shape == (len(CAPTIONS), 24)
    for name in ("byt5", "clip", "clip_image"):
        close(getattr(got, name), getattr(want, name))
    # the null conditioning: the towers' outputs for "" (JAX: encode_text's composition)
    nb, nm, nc = jax_encode.encode_text([""])
    np.testing.assert_array_equal(null.byt5_mask.numpy(), np.asarray(nm))
    close(null.byt5, nb)
    close(null.clip, nc)
    assert null.byt5.shape == (1, BUCKET, 32) and null.clip.shape == (1, 24)


@pytest.mark.parametrize("vocab_size,context_length", [(64, 16), (49408, 77)])
def test_stand_in_clip_ids_equal_the_jax_script(encoders, vocab_size, context_length):
    jax_encode, _ = encoders["bf16"]
    tokenize = cells(jax_encode)["clip_tokenize"].cell_contents
    free = cells(tokenize)
    free["sot"].cell_contents, free["eot"].cell_contents = vocab_size - 2, vocab_size - 1
    free["ctx"].cell_contents = context_length
    prompts = CAPTIONS + ["x" * 200]
    np.testing.assert_array_equal(drv.clip_tokenize(prompts, vocab_size, context_length), tokenize(prompts))


@pytest.mark.parametrize("name", ["small", "mid", "1b"])
def test_make_geometry_equals_the_jax_script(name):
    want = jax_script("run_driver_e2e").make_geometry(name)
    got = drv.make_geometry(name)
    for g, w in zip(got, want):
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def jax_token_arithmetic(k: int, codebook: np.ndarray) -> dict:
    """The JAX eval script's token-space statements (R and its scaling,
    token_stats, js_div), taken from its source and run as they are."""
    tree = ast.parse((REPO / "scripts" / "run_eval_e2e.py").read_text())
    keep = [n for n in ast.walk(tree)
            if (isinstance(n, ast.FunctionDef) and n.name in ("token_stats", "js_div"))
            or (isinstance(n, (ast.Assign, ast.AugAssign)) and "R" in {getattr(t, "id", None) for t in
                                                                     (n.targets if isinstance(n, ast.Assign) else [n.target])})]
    ns = {"np": np, "K": k, "codebook": codebook}
    exec(compile(ast.Module(body=keep, type_ignores=[]), "run_eval_e2e.py", "exec"), ns)
    return ns


def test_token_statistics_match_the_jax_script():
    rng = np.random.default_rng(0)
    k, c = 128, 4
    codebook = rng.standard_normal((k, c)).astype(np.float32)
    ns = jax_token_arithmetic(k, codebook)
    proj = ev.token_projection(k)
    np.testing.assert_array_equal(proj, ns["R"])
    assert proj.dtype == ns["R"].dtype == np.float32
    a = [rng.integers(0, k, (4, 16, 16)) for _ in range(2)]
    b = [rng.integers(0, k // 2, (4, 16, 16)) for _ in range(2)]
    for toks in (a, b, a[:1]):
        got, want = ev.token_stats(toks, codebook, proj), ns["token_stats"](toks)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
            assert g.dtype == w.dtype
    ha, hb = ev.token_stats(a, codebook, proj)[1], ev.token_stats(b, codebook, proj)[1]
    assert ev.js_div(ha, hb) == ns["js_div"](ha, hb) > 0
    assert ev.js_div(ha, ha) == ns["js_div"](ha, ha) == 0.0


def test_eval_batch_seeds_are_a_tag_of_their_own():
    """Each eval batch samples from (B, 2) seed pairs derived from (0, 1000
    + i) under SAMPLE_SEED_TAG (the JAX script's key is fast_key(1000 + i):
    tokens match JAX's in distribution only): distinct over images and
    batches, repeatable, and not the eval grid's."""
    s = [ev.batch_seeds(i, 4) for i in range(3)]
    assert all(t.shape == (4, 2) for t in s)
    rows = {tuple(r.tolist()) for t in s for r in t}
    assert len(rows) == 12
    assert torch.equal(ev.batch_seeds(1, 4), s[1])
    assert not rows & {tuple(r.tolist()) for i in range(3) for r in eval_seeds(1000 + i, 4)}


def test_inception_state_dict_equals_the_jax_tests_state_dict():
    from tests.test_inception import synth_inception_state_dict

    got, want = ev.synth_inception_state_dict(seed=0), synth_inception_state_dict(seed=0)
    assert list(got) == list(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


@pytest.fixture(scope="module")
def jax_vq_tree():
    """The JAX VQConfig.tiny() variables' structure (shapes and dtypes, by
    jax.eval_shape: no init is computed)."""
    return jax.eval_shape(lambda: JaxVQModel(JaxVQConfig.tiny()).init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3))))


def shapes(tree) -> dict:
    return {jax.tree_util.keystr(p): (tuple(x.shape), np.dtype(x.dtype)) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]}


def decode_both(vq: VQModel, variables, seed: int):
    idx = np.random.default_rng(seed).integers(0, 128, (2, 16, 16)).astype(np.int32)
    want = np.asarray(JaxVQModel(JaxVQConfig.tiny()).apply(variables, jnp.asarray(idx), method=JaxVQModel.decode_indices))
    return vq.decode_indices(torch.from_numpy(idx)).numpy(), want


def test_jax_codec_vars_load_through_the_codec_path(tmp_path, jax_vq_tree):
    """A JAX VQConfig.tiny() state (seeded numpy values in the JAX tree),
    saved by the JAX package, loads through the port's --codec path
    (run_driver_e2e.load_codec) and decodes the same tokens to the same
    image (1e-4)."""
    rng = np.random.default_rng(3)
    fill = lambda p, s: ((1 + 0.1 * rng.uniform(size=s.shape)) if jax.tree_util.keystr(p).endswith("['var']")  # noqa: E731
                         else 0.05 * rng.standard_normal(s.shape)).astype(s.dtype)
    variables = jax.tree_util.tree_map_with_path(fill, jax_vq_tree)
    path = str(tmp_path / "codec_vars.npz")
    jax_save_params_npz(path, variables)
    vq = VQModel(VQConfig.tiny())
    drv.load_codec(vq, path)
    got, want = decode_both(vq, variables, 5)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_port_codec_vars_load_in_jax(tmp_path, jax_vq_tree):
    """The port's codec_vars.npz (run_codec_pretrain's save) loads in the
    JAX package's load_params_npz with the JAX tree's keys, shapes and
    dtypes, and decodes as the port does (1e-4)."""
    from paella_tpu_torch.convert import vqgan_variables_to_jax
    from paella_tpu_torch.train import save_params_npz

    vq = VQModel(VQConfig.tiny())
    vq.reset_parameters(torch.Generator().manual_seed(6))
    with torch.no_grad():
        for p in vq.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(7)))
    path = str(tmp_path / "codec_vars.npz")
    save_params_npz(path, vqgan_variables_to_jax(vq.state_dict(), vq.config))
    loaded = jax_load_params_npz(path)
    assert shapes(loaded) == shapes(jax_vq_tree)
    got, want = decode_both(vq, loaded, 8)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# the three command lines under --smoke
# ---------------------------------------------------------------------------

ENV = {**{k: v for k, v in os.environ.items() if k != "PYTHONPATH"}, "OMP_NUM_THREADS": "2", "CUDA_VISIBLE_DEVICES": ""}


def cli(name: str, *args: str) -> list:
    return [sys.executable, "-m", f"paella_tpu_torch.scripts.{name}", *args]


def run(cmd: list) -> dict:
    """Run a CLI to its end; its last line of standard output as JSON."""
    out = subprocess.run(cmd, cwd=REPO, env=ENV, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def driver_cmd(workdir: Path, steps: int, codec: Path) -> list:
    return cli("run_driver_e2e", "--smoke", "--workdir", str(workdir), "--steps", str(steps), "--log-every", "1",
               "--eval-every", "4", "--shards", "1", "--workers", "1", "--codec", str(codec))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The codec pretraining smoke, then the driver smoke against its codec:
    phase A is stopped by SIGTERM after its step-4 checkpoint and eval
    grid, phase B (a fresh process) resumes to step 8."""
    root = tmp_path_factory.mktemp("scripts")
    codec = run(cli("run_codec_pretrain", "--smoke", "--workdir", str(root / "codec"), "--shards", "1"))
    workdir = root / "run"
    proc = subprocess.Popen(driver_cmd(workdir, 200, root / "codec" / "codec_vars.npz"), cwd=REPO, env=ENV,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    metrics, deadline = workdir / "metrics.jsonl", time.time() + 240
    while time.time() < deadline and proc.poll() is None:
        rows = [json.loads(line) for line in open(metrics)] if metrics.exists() else []
        if any("eval_s" in r for r in rows):
            break
        time.sleep(0.2)
    proc.send_signal(signal.SIGTERM)
    phase_a, _ = proc.communicate(timeout=240)
    phase_b = subprocess.run(driver_cmd(workdir, 8, root / "codec" / "codec_vars.npz"), cwd=REPO, env=ENV,
                             capture_output=True, text=True, timeout=300)
    return {"root": root, "codec": codec, "phase_a": (proc.returncode, phase_a), "phase_b": phase_b, "workdir": workdir}


def test_codec_pretrain_smoke(runs):
    out = runs["codec"]
    assert out["steps"] == 30 and np.isfinite(out["final_eval_recon_l1"])
    assert out["final_eval_recon_l1"] < out["init_eval_recon_l1"]
    assert 0.0 < out["final_codebook_usage"] <= 1.0
    assert out["launches"]["codebook_lookup_plain"] > 0 and out["launches"]["fused_codebook_lookup"] == 0
    d = runs["root"] / "codec"
    assert (d / "metrics.jsonl").exists() and json.loads((d / "summary.json").read_text()) == out
    jax_vars = jax_load_params_npz(str(d / "codec_vars.npz"))
    assert set(jax_vars) == {"params", "batch_stats"}


def test_driver_smoke_preempts_and_resumes(runs):
    rc, out_a = runs["phase_a"]
    assert rc == 0, out_a[-3000:]
    assert "preemption checkpoint saved" in out_a, out_a[-3000:]
    b = runs["phase_b"]
    assert b.returncode == 0, b.stdout[-3000:] + b.stderr[-3000:]
    assert "resumed at step" in b.stdout and "init skipped" in b.stdout
    summary = json.loads(b.stdout.strip().splitlines()[-1])
    workdir = runs["workdir"]
    assert summary == json.loads((workdir / "summary.json").read_text())
    assert summary["final_step"] == 8 and summary["byt5"] == "bf16"
    rows = [json.loads(line) for line in open(workdir / "metrics.jsonl")]
    assert any(r.get("images_per_sec") for r in rows)
    assert [r["step"] for r in rows if "restore_s" in r] and max(r["step"] for r in rows if "loss" in r) == 8
    assert "eval_0000004.npz" in os.listdir(workdir) and "eval_0000008.npz" in os.listdir(workdir)
    steps = sorted(int(s) for s in os.listdir(workdir / "checkpoints") if s.isdigit())
    assert steps[0] == 4 and steps[-1] == 8 and len(steps) == 3
    assert summary["launches"]["resblock_plain"] > 0 and summary["launches"]["fused_resblock"] == 0


@pytest.mark.parametrize("flags,file,key", [
    ((), "eval_fid.json", "fid_synthetic_featurizer"),
    (("--trend", "--trend-steps", "8", "--real-recon", "--byt5", "bf16"), "eval_fid_trend.json", "fid_synthetic_featurizer"),
    (("--trend", "--space", "tokens", "--w8a8"), "eval_token_trend_w8a8.json", "token_frechet"),
])
def test_eval_smoke_over_the_driver_run(runs, flags, file, key):
    workdir = runs["workdir"]
    out = run(cli("run_eval_e2e", "--smoke", "--workdir", str(workdir), *flags))
    assert out == json.loads((workdir / file).read_text())
    assert out["n_per_set"] == 8
    if "--trend" not in flags:
        assert out["denoiser_step"] == 8 and np.isfinite(out[key]) and out["sampling_images_per_sec"] > 0
        return
    steps = sorted(int(s) for s in os.listdir(workdir / "checkpoints") if s.isdigit())
    if "--trend-steps" in flags:
        steps = [int(flags[flags.index("--trend-steps") + 1])]
    labels = ["init"] + [f"step-{s}" for s in steps]
    if "--w8a8" in flags:
        labels = [x for label in labels for x in (label, label + "-w8a8")]
        assert out["w8a8"]["levels"] == []  # tiny(): no level is fuse-eligible, so the twin is the same program
        for a in out["arms"]:
            if a["arm"].endswith("-w8a8"):
                assert a["token_js_to_bf16_twin"] == 0.0 and a["token_flip_to_bf16_twin"] == 0.0
        for a in out["arms"]:
            assert 0 <= a["token_js_to_real"] <= 0.6932
            assert a["token_js_to_real"] > out["token_js_floor_real_vs_real"]
    else:
        assert out["real_set"] == "codec-recon"
    assert [a["arm"] for a in out["arms"]] == labels
    assert all(np.isfinite(a[key]) and a[key] >= 0 for a in out["arms"])
    assert isinstance(out["monotone_improving"], bool)


@pytest.mark.parametrize("name", ["run_driver_e2e", "run_codec_pretrain", "run_eval_e2e"])
def test_entry_point_without_a_card_raises(tmp_path, name):
    """Without --smoke or --device cpu an entry point runs on the card, and
    raises where there is none; it writes nothing first."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(cli(name, "--workdir", str(tmp_path / "w")), cwd=REPO, env=ENV, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert not (tmp_path / "w").exists()
