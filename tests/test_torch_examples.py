"""The port's examples (paella_tpu_torch/examples/) against the JAX repo's
(examples/generate.py, train_minimal.py, eval_quality.py, loaded with
importlib and left as they are), on the CPU at the tiny configs.

- Flags: each port module's argparse options and defaults are the JAX
  example's (read from its source with ast), plus --device.
- generate: the JAX example's own tiny build_pipeline (PRNGKey 0/1/2 init),
  its denoiser perturbed by 0.02 N(0, 1) (the zero-init clf and FiLM give
  all-zero logits at init), carried into the port example's pipeline
  through the converters; inpaint, outpaint and the (2, S) phrase reweight
  of step 6 (no CLIP tokens) run through both pipelines with the same seed
  pairs, on token grids (identity decode), at a token agreement >= 0.95.
  The JAX outpaint splits its key for the canvas and the sampler, which a
  batch of seed pairs cannot do: the test hands the JAX pipeline the
  port's canvas and the seed pairs for both halves. Then the port's main on
  the CPU returns the six results at the JAX run's shapes.
- train_minimal: both mains on the same flags with run_training patched
  pass equal TrainConfig / DriverConfig fields, model configs, first batches
  and sample_eval=False; the --byt5 encode closure against JAX's over one
  tiny T5 file (ids and masks exact, states within 1e-4 in f32); a real
  2-step port run writes metrics.jsonl with finite losses.
- eval_quality: the synthetic proxy geometry equals JAX's field for field;
  the --w8a8-proxy rows equal quant.w8a8_quality_proxy on that model
  exactly and print a verdict; --byt5-w8a8-proxy --stress prints two arms;
  the tiny demo gives finite scores; --ckpt alone exits with a message.
- Without --device cpu every main raises here (no CUDA device).
"""
import argparse
import ast
import dataclasses
import importlib.util
import json
import math
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paella_tpu.cond.loader as jax_loader
import paella_tpu.pipeline as jax_pipeline_module
import paella_tpu.train.driver as jax_driver
from paella_tpu.cond import T5Config as JaxT5Config
from paella_tpu.config import PaellaConfig as JaxPaellaConfig
from paella_tpu.config import SampleConfig as JaxSampleConfig
from paella_tpu_torch import quant
import paella_tpu_torch.cond.loader as port_loader
import paella_tpu_torch.train.driver as port_driver
from paella_tpu_torch.cond import T5Config, pad_bucket
from paella_tpu_torch.config import SampleConfig
from paella_tpu_torch.convert import paella_state_dict_from_jax, t5_state_dict_from_jax, vqgan_state_dict_from_jax
from paella_tpu_torch.examples import eval_quality, generate, train_minimal
from paella_tpu_torch.sampling.editing import reweight_for_phrase
from paella_tpu_torch.sampling.sampler import outpaint_canvas
from paella_tpu_torch.serve import request_seeds
from tests.test_torch_scripts import cells, t5_state_dict

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = ("generate", "train_minimal", "eval_quality")
PROMPT = "a painting of a corgi wearing a top hat"  # the example's default
STEPS = 4


def jax_example(name: str):
    """The JAX repo's examples/<name>.py as a module (its main() is not run)."""
    spec = importlib.util.spec_from_file_location(f"_jax_example_{name}", REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flags(path: Path) -> dict:
    """Every `ap.add_argument(...)` of a source file: option -> its
    keywords (default, type, action, choices; help left out)."""
    out = {}
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "add_argument":
            kw = {k.arg: ast.unparse(k.value) for k in node.keywords if k.arg != "help"}
            out[node.args[0].value] = kw
    return out


@pytest.mark.parametrize("name", EXAMPLES)
def test_flags_and_defaults_are_the_jax_examples(name):
    want = flags(REPO / "examples" / f"{name}.py")
    got = flags(REPO / "paella_tpu_torch" / "examples" / f"{name}.py")
    assert got.pop("--device") == {"default": "'cuda'"}
    assert got == want and want


@pytest.mark.parametrize("name", EXAMPLES)
def test_runs_as_a_module(name):
    out = subprocess.run([sys.executable, "-m", f"paella_tpu_torch.examples.{name}", "--help"], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and "--device" in out.stdout, out.stderr[-2000:]


@pytest.mark.parametrize("name,argv", [("generate", ["--steps", "1"]), ("train_minimal", ["--steps", "1"]),
                                       ("eval_quality", [])])
def test_main_without_a_card_raises(tmp_path, monkeypatch, name, argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        {"generate": generate, "train_minimal": train_minimal, "eval_quality": eval_quality}[name].main(argv)
    assert not list(tmp_path.iterdir())


# --- generate ---------------------------------------------------------------


@pytest.fixture(scope="module")
def pipes():
    """(port pipeline, JAX pipeline) of the JAX example's tiny demo weights,
    both decoding to token grids."""
    ref = jax_example("generate").build_pipeline(types.SimpleNamespace(denoiser=None))
    rng = np.random.default_rng(0)
    params = jax.tree_util.tree_map(lambda a: a + 0.02 * rng.standard_normal(a.shape).astype(a.dtype), ref.params)
    ref = dataclasses.replace(ref, params=params)
    t5_params = cells(ref.byt5_encode_fn.__wrapped__)["t5_params"].cell_contents
    port = generate.build_pipeline(argparse.Namespace(denoiser=None, device="cpu"))
    for module, sd in ((port.model, paella_state_dict_from_jax(params, port.model.config)),
                       (port.vq, vqgan_state_dict_from_jax(ref.vq_vars, port.vq.config)),
                       (port.byt5_encode_fn, t5_state_dict_from_jax(t5_params, T5Config.tiny()))):
        module.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in sd.items()}, strict=True)
    port.model.drop_derived()
    port._decode_clipped = lambda t: t
    ref._decode_clipped = lambda t: t
    return port, ref


def source_image() -> np.ndarray:
    return np.random.default_rng(1).uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)


def agree(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype == np.int32
    return float((got == want).mean())


def test_inpaint_tokens_match_jax(pipes):
    port, ref = pipes
    x = source_image()
    keep = np.zeros((1, 16, 16), bool)
    keep[:, :, :8] = True  # the example keeps the left half of the latent
    seeds = request_seeds([1])
    got = port.inpaint([PROMPT + ", sunset"], torch.from_numpy(x), torch.from_numpy(keep), seeds, SampleConfig(steps=STEPS))
    want = ref.inpaint([PROMPT + ", sunset"], jnp.asarray(x), jnp.asarray(keep), jnp.asarray(seeds.numpy().astype(np.uint32)),
                       JaxSampleConfig(steps=STEPS))
    tokens0 = port.encode_image_tokens(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got.numpy()[keep], tokens0[keep])
    assert agree(got, want) >= 0.95


def test_outpaint_tokens_match_jax(pipes, monkeypatch):
    """The example's double-width canvas at offset (0, size // 2): latent
    16x32, the encoded 16x16 pinned at columns 8..24."""
    port, ref = pipes
    x = source_image()
    seeds = request_seeds([2])

    def the_ports_canvas(tokens, canvas_hw, offset, num_labels, key):
        init_x, mask = outpaint_canvas(torch.from_numpy(np.array(tokens)), canvas_hw, offset, num_labels, seeds)
        return jnp.asarray(init_x.numpy()), jnp.asarray(mask.numpy())

    jax_view = types.ModuleType("jax")
    jax_view.__getattr__ = lambda name: getattr(jax, name)
    jax_view.random = types.SimpleNamespace(split=lambda key: (key, key))
    monkeypatch.setattr(jax_pipeline_module, "outpaint_canvas", the_ports_canvas)
    monkeypatch.setattr(jax_pipeline_module, "jax", jax_view)
    got = port.outpaint([PROMPT], torch.from_numpy(x), (64, 128), (0, 32), seeds, SampleConfig(steps=STEPS))
    want = ref.outpaint([PROMPT], jnp.asarray(x), (64, 128), (0, 32), jnp.asarray(seeds.numpy().astype(np.uint32)),
                        JaxSampleConfig(steps=STEPS))
    assert got.shape == (1, 16, 32)
    np.testing.assert_array_equal(got.numpy()[:, :, 8:24], port.encode_image_tokens(torch.from_numpy(x)).numpy())
    assert agree(got, want) >= 0.95


def test_two_row_phrase_reweight_matches_jax(pipes):
    """Step 6: one prompt's (1, S) reweight stacked to (2, S), S the prompt's
    ByT5 bucket and no CLIP tokens, broadcast over the CFG batch."""
    port, ref = pipes
    w = reweight_for_phrase(PROMPT, "hat", 3.0, pad_bucket(len(PROMPT.encode()) + 1), has_clip=False)
    w2 = np.concatenate([w, w], 0)
    assert w2.shape == (2, 64)
    seeds = request_seeds([5])
    got = port.text_to_image([PROMPT], seeds, (64, 64), SampleConfig(steps=STEPS), cond_reweight=torch.from_numpy(w2))
    want = ref.text_to_image([PROMPT], jnp.asarray(seeds.numpy().astype(np.uint32)), (64, 64), JaxSampleConfig(steps=STEPS),
                             cond_reweight=jnp.asarray(w2))
    assert agree(got, want) >= 0.95
    plain = port.text_to_image([PROMPT], seeds, (64, 64), SampleConfig(steps=STEPS))
    assert agree(got, plain) < 1.0  # the reweight changed the tokens


def test_generate_main_on_cpu(tmp_path):
    """The six calls at the JAX run's shapes, finite and in [0, 1]."""
    out = generate.main(["--device", "cpu", "--steps", "2", "--out", str(tmp_path / "g")])
    shapes = {name: tuple(img.shape) for name, img in out["images"].items()}
    assert shapes == {"text_to_image": (1, 64, 64, 3), "inpaint": (1, 64, 64, 3), "outpaint": (1, 64, 128, 3),
                      "img2img": (1, 64, 64, 3), "text_to_image_b": (1, 64, 64, 3), "interpolate": (5, 64, 64, 3),
                      "edited": (1, 64, 64, 3)}
    for img in out["images"].values():
        assert bool(torch.isfinite(img).all()) and 0.0 <= float(img.min()) <= float(img.max()) <= 1.0
    assert set(out["ms"]) == set(shapes)


# --- train_minimal ----------------------------------------------------------


def captured_run_training(monkeypatch, module) -> list:
    """Replace `module.run_training` with one that records its arguments."""
    calls = []
    monkeypatch.setattr(module, "run_training", lambda *a, **k: calls.append((a, k)))
    return calls


def test_train_minimal_passes_the_jax_examples_arguments(monkeypatch):
    argv = ["--steps", "3", "--batch", "2"]
    jax_calls = captured_run_training(monkeypatch, jax_driver)
    monkeypatch.setattr(sys, "argv", ["train_minimal.py"] + argv)
    jax_example("train_minimal").main()
    port_calls = captured_run_training(monkeypatch, port_driver)
    train_minimal.main(argv + ["--device", "cpu"])
    (ja, jk), (pa, pk) = jax_calls[0], port_calls[0]
    j_model, _, _, j_data, _, _, j_train, j_driver = ja
    p_model, _, p_data, _, _, p_train, p_driver = pa
    assert dataclasses.asdict(p_train) == dataclasses.asdict(j_train)
    assert dataclasses.asdict(p_driver) == dataclasses.asdict(j_driver)
    assert p_driver.eval_every == 1 and p_train.warmup_updates == 3
    assert dataclasses.asdict(p_model.config) == dataclasses.asdict(j_model.config)
    assert jk == pk == {"sample_eval": False}
    (j_images, j_caps), (p_images, p_caps) = next(j_data), next(p_data)
    np.testing.assert_array_equal(p_images, j_images)
    assert p_caps == j_caps


def test_byt5_encode_closure_matches_jax(tmp_path, monkeypatch):
    """--byt5 on one tiny T5 file through both mains (the loaders pointed at
    T5Config.tiny()): the ids and masks the closures make are equal, the
    states within 1e-4 in f32, the CLIP rows zero, and so for the null."""
    path = tmp_path / "t5.pt"
    torch.save({k: torch.from_numpy(v) for k, v in t5_state_dict(T5Config.tiny(), seed=3).items()}, path)
    seen = {"jax": [], "port": []}

    jax_load = jax_loader.load_byt5

    def jax_tiny(p, cfg, **kw):
        enc = jax_load(p, JaxT5Config.tiny(), **kw)
        return lambda ids, mask: (seen["jax"].append(np.asarray(ids)), enc(ids, mask))[1]

    port_load = port_loader.load_byt5

    def port_tiny(p, cfg, **kw):
        enc = port_load(p, T5Config.tiny(), **kw)
        return lambda ids, mask: (seen["port"].append(ids.numpy()), enc(ids, mask))[1]

    monkeypatch.setattr(jax_loader, "load_byt5", jax_tiny)
    monkeypatch.setattr(port_loader, "load_byt5", port_tiny)
    argv = ["--byt5", str(path), "--steps", "1", "--batch", "2"]
    jax_calls = captured_run_training(monkeypatch, jax_driver)
    monkeypatch.setattr(sys, "argv", ["train_minimal.py"] + argv)
    jax_example("train_minimal").main()
    port_calls = captured_run_training(monkeypatch, port_driver)
    train_minimal.main(argv + ["--device", "cpu"])
    j_encode, j_null = jax_calls[0][0][4:6]
    p_encode, p_null = port_calls[0][0][3:5]

    images = np.random.default_rng(4).uniform(0, 1, (3, 64, 64, 3)).astype(np.float32)
    captions = ["a photo of a corgi", "", "café au lait ☕ " * 6]  # the last one past the 64-byte bucket
    want, got = j_encode(images, captions), p_encode(images, captions)
    for j_ids, p_ids in zip(seen["jax"], seen["port"], strict=True):
        np.testing.assert_array_equal(p_ids, j_ids)
    assert seen["port"][0].shape == (1, 1) and seen["port"][1].shape == (3, 64)  # the null, then the batch
    np.testing.assert_array_equal(got.byt5_mask.numpy(), np.asarray(want.byt5_mask))
    np.testing.assert_allclose(got.byt5.numpy(), np.asarray(want.byt5), rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.images.numpy(), images)
    for p_rows, j_rows in ((got.clip, want.clip), (got.clip_image, want.clip_image), (p_null.clip, j_null.clip)):
        assert p_rows.dtype == torch.float32 and not p_rows.any()
        assert tuple(p_rows.shape) == np.asarray(j_rows).shape
    np.testing.assert_array_equal(p_null.byt5_mask.numpy(), np.asarray(j_null.byt5_mask))
    np.testing.assert_allclose(p_null.byt5.numpy(), np.asarray(j_null.byt5), rtol=1e-4, atol=1e-4)


def test_train_minimal_runs_on_cpu(tmp_path):
    state = train_minimal.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--workdir", str(tmp_path)])
    assert int(state.step) == 2
    rows = [json.loads(line) for line in (tmp_path / "metrics.jsonl").read_text().splitlines()]
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 2 and all(math.isfinite(v) for v in losses)
    assert sorted(p.name for p in (tmp_path / "checkpoints").iterdir()) == ["1", "2"]


# --- eval_quality -----------------------------------------------------------


def test_synthetic_proxy_geometry_equals_jax():
    """The JAX example's `cfg = dataclasses.replace(PaellaConfig.tiny(), ...)`
    of w8a8_proxy_demo, taken from its source and evaluated."""
    tree = ast.parse((REPO / "examples" / "eval_quality.py").read_text())
    demo = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "w8a8_proxy_demo")
    exprs = [n.value for n in ast.walk(demo) if isinstance(n, ast.Assign) and getattr(n.targets[0], "id", None) == "cfg"
             and "PaellaConfig.tiny()" in ast.unparse(n.value)]
    assert len(exprs) == 1
    want = eval(compile(ast.Expression(exprs[0]), "eval_quality.py", "eval"),
                {"dataclasses": dataclasses, "PaellaConfig": JaxPaellaConfig})
    assert dataclasses.asdict(eval_quality.synthetic_proxy_config()) == dataclasses.asdict(want)


def test_w8a8_proxy_rows_and_verdict(capsys):
    rows, ok = eval_quality.main(["--w8a8-proxy", "--device", "cpu"])
    model, latent_hw = eval_quality.proxy_model(None, torch.device("cpu"))
    assert latent_hw == (16, 16)
    assert rows == quant.w8a8_quality_proxy(model, torch.Generator().manual_seed(2), latent_hw=latent_hw)
    assert len(rows) == 5 and all(math.isfinite(r[k]) for r in rows for k in ("kl", "flip", "rel"))
    out = capsys.readouterr().out
    assert "KL nats/tok" in out and ("PASS" in out) == ok and ("FAIL" in out) != ok


def test_byt5_proxy_stress_prints_two_arms(capsys):
    arms, _ = eval_quality.main(["--byt5-w8a8-proxy", "--stress", "--device", "cpu"])
    assert list(arms) == ["synthetic", "synthetic_outliers"] and arms["synthetic"] != arms["synthetic_outliers"]
    out = capsys.readouterr().out
    assert "== synthetic (tiny) ==" in out and "== synthetic_outliers (tiny) ==" in out
    assert out.count("byt5 act_quant:") == 2


def test_tiny_demo_gives_finite_scores():
    out = eval_quality.main(["--device", "cpu"])
    assert tuple(out["images"].shape) == (2, 64, 64, 3)
    assert tuple(out["scores"].shape) == (2,) and bool(torch.isfinite(out["scores"]).all())
    assert math.isfinite(out["fid"])


def test_ckpt_alone_exits_with_a_message():
    with pytest.raises(SystemExit) as e:
        eval_quality.main(["--ckpt", "paella_v3.pt"])
    assert isinstance(e.value.code, str) and "paella_tpu_torch" in e.value.code
