"""The Stage C configuration's cell at test size on the CPU: the prior
cell's run is correct and each fault its check exists for comes out not
correct (the CFG mix skipped, the text tower's output altered); its FLOP
count and K1 bound follow the shapes; its controls read above the program,
and on the card (`cuda` marker), at the cell's own size, fail the cell's
limits while the program passes them."""
from __future__ import annotations

import copy
import sys
import time
import types
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_port.core import cell, runner  # noqa: E402
from bench_port.core import stage_c_roofline  # noqa: E402

PRIOR = cell.load_module(cell.BENCH / "entries" / "prior_t2l.py")


def tiny_prior(c: int = 32) -> dict:
    spec = cell.cell_spec("cascade-c-b4-fresh")
    conf = copy.deepcopy(spec["config"])
    conf["parts"]["prior"]["sizes"].update(c_in=4, c_out=4, c_r=16, c_cond=32, c_hidden=[c, c], nhead=[4, 4],
                                           blocks=[[1, 2], [2, 1]] if c < 128 else [[1, 1], [1, 1]], c_clip_text=32,
                                           c_clip_text_pooled=24, c_clip_img=16, dtype="float32")
    conf["parts"]["clip_g"]["sizes"].update(vocab_size=6000, width=32, heads=4, layers=2, embed_dim=24, dtype="float32")
    for p in conf["parts"].values():
        p["dtype"] = "float32"
    conf["sample"].update(steps=3, image_hw=[128, 128])
    spec["config"] = conf
    spec["traffic"] = dict(spec["traffic"], batch=2)
    return spec


def _run(spec: dict, seed: int = 2**35 + 11):
    return runner.run_cell(spec, seed, 0.5, False, torch.device("cpu"), time.perf_counter())


def test_prior_run_is_correct_and_checks_two_outputs_of_the_tower():
    out, numbers = _run(tiny_prior())
    assert out["correct"] and out["failed"] == 0, numbers
    assert numbers["step_gap"] == 0.0 and numbers["images_checked"] >= 2  # every image of a kept call
    assert 0 < numbers["clip_hidden_gap"] < 1e-5 and 0 < numbers["clip_pooled_gap"] < 1e-5


def test_cfg_mix_skipped(monkeypatch):
    import torch as real
    from paella_tpu_torch.sampling import prior

    class NoMix(types.ModuleType):
        def __getattr__(self, name):
            return (lambda start, end, weight: end) if name == "lerp" else getattr(real, name)

    monkeypatch.setattr(prior, "torch", NoMix("torch"))
    out, numbers = _run(tiny_prior())
    assert not out["correct"] and numbers["step_gap"] > 0.01, numbers


def test_noise_of_one_image_altered(monkeypatch):
    from paella_tpu_torch.sampling import prior

    real = prior.gaussian

    def last_row_halved(seeds, shape):
        z = real(seeds, shape)
        return torch.cat([z[:-1], z[-1:] * 0.5]) if z.shape[0] > 1 else z

    monkeypatch.setattr(prior, "gaussian", last_row_halved)
    spec = tiny_prior()
    out, numbers = _run(spec)
    assert not out["correct"] and numbers["step_gap"] > spec["check"]["limits"]["step_gap"], numbers


def test_tower_output_altered(monkeypatch):
    from paella_tpu_torch.cond.clip import CLIPTextEncoder

    real = CLIPTextEncoder._forward_hidden

    def altered(self, input_ids, attention_mask):
        hidden, pooled = real(self, input_ids, attention_mask)
        return hidden * 1.1, pooled

    monkeypatch.setattr(CLIPTextEncoder, "_forward_hidden", altered)
    out, numbers = _run(tiny_prior())
    assert not out["correct"] and numbers["clip_hidden_gap"] > 0.05, numbers


def test_flops_of_a_call():
    spec = tiny_prior()
    run = runner.Run(spec, 3, torch.device("cpu"))
    built = run.builder.build(spec["config"], 3, torch.device("cpu"), runner.CACHE)
    fl = PRIOR.PriorFlops(spec["config"], built["layouts"], (3, 3), 2)
    c = 32
    products = 2 * 4 * 9 * (3 * c * 4 * c * 2 + c * 4 * c * 2)  # the ResBlocks' fc1 / fc2 alone, CFG rows 4
    assert fl.forward > products and fl.tower > 0
    assert fl.call() == fl.tower + 3 * fl.forward


def test_k1_bound_counts_the_skip_in_fc1():
    plain = stage_c_roofline.resblock_bound_s(8, 24, 24, 2048, False, True)
    cat = stage_c_roofline.resblock_bound_s(8, 24, 24, 2048, True, True)
    assert cat == pytest.approx(plain * 1.5, rel=1e-3)  # compute-bound: 24 M C^2 against 16 M C^2
    assert plain == pytest.approx(16 * 4608 * 2048**2 / 989e12, rel=1e-6)


def test_controls_read_above_the_program():
    ctl = cell.load_module(cell.BENCH / "controls.py")
    (line,) = list(ctl.prior_readings(tiny_prior(128), [2**36 + 5], 0.3, torch.device("cpu")))
    prog, control = line["program"], line["control"]
    for k in ("eps_gap", "cfg_eps_gap", "clip_hidden_gap", "clip_pooled_gap"):
        assert control[k] > 2 * prog[k], (k, prog, control)
    assert control["step_gap"] > prog["step_gap"] == 0.0


@pytest.mark.cuda
def test_controls_fail_the_cells_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the controls run at the cell's own size")
    ctl = cell.load_module(cell.BENCH / "controls.py")
    spec = cell.cell_spec("cascade-c-b4-fresh")
    limits = spec["check"]["limits"]
    (line,) = list(ctl.prior_readings(spec, [2**40 + 77], 6.0, torch.device("cuda:0")))
    print(line)
    assert line["correct"] and all(line["program"][k] <= v for k, v in limits.items()), line
    assert any(line["control"][k] > v for k, v in limits.items()), line
