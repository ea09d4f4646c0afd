"""The Stage B configuration's cell at test size on the CPU: the cell's files
parse and name what exists; the decoder cell's run is correct; each fault
its check exists for comes out not correct (the skip on the first repeat
only, FiLM advanced per execution, align_corners=False, Stage A without its
scale, the up-conv's kernel read transposed); its FLOP count and bounds
follow the shapes; its controls read above the program, and on the card
(`cuda` marker), at the cell's own size, fail the cell's limits while the
program passes them."""
from __future__ import annotations

import copy
import sys
import time
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_port.core import cell, runner  # noqa: E402
from bench_port.core import stage_b_roofline  # noqa: E402

CELL = "cascade-b-b4-fresh"
DECODER = cell.load_module(cell.BENCH / "entries" / "decoder_t2i.py")


def tiny_decoder(c: tuple = (16, 24, 32)) -> dict:
    spec = cell.cell_spec(CELL)
    conf = copy.deepcopy(spec["config"])
    conf["parts"]["decoder"]["sizes"].update(
        c_r=16, c_cond=32, c_hidden=list(c), nhead=[-1, 4, 4], blocks=[[1, 1, 1], [1, 2, 1]],
        block_repeat=[[1, 2, 1], [3, 2, 2]], level_config=["CT", "CTA", "CTA"], c_clip=24,
        dropout=[0.0, 0.0, 0.0], dtype="float32")
    conf["parts"]["codec"]["sizes"].update(bottleneck_blocks=2, c_hidden=32, codebook_size=128)
    conf["parts"]["clip_g"]["sizes"].update(vocab_size=6000, width=32, heads=4, layers=2, embed_dim=24, dtype="float32")
    for p in conf["parts"].values():
        p["dtype"] = "float32"
    conf["sample"].update(steps=2, image_hw=[64, 64], effnet_hw=[3, 3])
    spec["config"] = conf
    spec["traffic"] = dict(spec["traffic"], batch=2)
    return spec


def _run(spec: dict, seed: int = 2**35 + 13):
    return runner.run_cell(spec, seed, 0.3, False, torch.device("cpu"), time.perf_counter())


def test_cell_files_parse_and_name_what_exists():
    bench = cell.benchmark()
    spec = cell.cell_spec(CELL, bench)
    assert spec["chips"] == 1 and spec["entry"] == "decoder_t2i" and spec["builder"].exists()
    conf = next(c for c in bench["configs"] if c["name"] == spec["config_name"])
    assert conf["reduced"] == [] and (cell.ROOT / conf["file"]).exists()
    assert spec["config"]["parts"]["decoder"]["sizes"]["c_hidden"] == [320, 640, 1280, 1280]
    assert [m["name"] for m in spec["end_to_end"]] == ["images_per_s", "setup_s"]
    names = [m["name"] for m in spec["per_layer"]]
    assert names == ["decoder_device_ms.d4", "stage_a_device_ms.d4", "k1_roofline.d4", "k5_roofline.d4", "mfu.d4",
                     "device_idle_share.d4"]
    for m in spec["per_layer"]:
        assert m["moves"] == "images_per_s" and callable(cell.metric_reader(m["name"]))
    assert set(spec["check"]["limits"]) == {"eps_gap", "step_gap", "image_gap", "clip_pooled_gap"}


def test_decoder_run_is_correct():
    out, numbers = _run(tiny_decoder())
    assert out["correct"] and out["failed"] == 0, numbers
    assert numbers["step_gap"] == 0.0 and numbers["images_checked"] >= 2  # every image of a kept call
    assert 0 < numbers["eps_gap"] < 1e-5 and 0 < numbers["clip_pooled_gap"] < 1e-5, numbers
    assert numbers["image_gap"] < 1e-5, numbers


def _not_correct(spec=None, key=None, above=None):
    spec = spec or tiny_decoder()
    out, numbers = _run(spec)
    assert not out["correct"], numbers
    if key is not None:
        assert numbers[key] > (above if above is not None else spec["check"]["limits"][key]), numbers
    return numbers


def test_skip_on_the_first_repeat_only(monkeypatch):
    from paella_tpu_torch.models.stage_b import StageB

    def first_run_only(self, prefix, blocks, mappers, h, skip, films, cache):
        """Later runs see zeros where the skip joins fc1 (the block's weights
        take 2C inputs, so the skip cannot simply be left out)."""
        for rep in range(len(mappers) + 1):
            s = skip if rep == 0 or skip is None else torch.zeros_like(skip)
            h = self._run_level(prefix, blocks, h, s, films, cache)
            if rep < len(mappers):
                w, b = self._linear(f"{prefix}.repeat{rep}", mappers[rep])
                h = F.linear(h, w, b)
        return h

    monkeypatch.setattr(StageB, "_level", first_run_only)
    _not_correct(key="eps_gap")


def test_film_advanced_per_execution(monkeypatch):
    """StageC's runner before the blocks repeated: each TimestepBlock
    execution took the next rows (of its width) instead of its own."""
    from paella_tpu_torch.models.cascade import CascadeUNet

    real = CascadeUNet.films

    def films(self, r):
        self._executed = {}
        return real(self, r)

    def film(self, blk, rows):
        width = rows[blk.film_row].shape[-1]
        same = [i for i, f in enumerate(rows) if f.shape[-1] == width]
        n = self._executed.get(width, 0)
        self._executed[width] = n + 1
        return rows[same[n % len(same)]]

    monkeypatch.setattr(CascadeUNet, "films", films)
    monkeypatch.setattr(CascadeUNet, "_film", film)
    _not_correct(key="eps_gap")


def test_interpolation_without_align_corners(monkeypatch):
    from paella_tpu_torch.models import stage_b

    def resize(x, hw):
        return F.interpolate(x.float().permute(0, 3, 1, 2), size=tuple(hw), mode="bilinear",
                             align_corners=False).permute(0, 2, 3, 1)

    monkeypatch.setattr(stage_b, "resize", resize)
    _not_correct(key="eps_gap")


def test_stage_a_without_its_scale(monkeypatch):
    from paella_tpu_torch.codec import VQModel

    monkeypatch.setattr(VQModel, "decode", lambda self, z: self.decoder(z))
    _not_correct(key="image_gap")


def test_up_conv_kernel_read_transposed(monkeypatch):
    from paella_tpu_torch.nn.blocks import Upsample

    def transposed(self):
        w = self.conv.weight.transpose(2, 3)
        return w.permute(2, 3, 1, 0).reshape(4 * self.conv.out_channels, -1).to(self.dtype)

    monkeypatch.setattr(Upsample, "_mat", transposed)
    _not_correct(key="eps_gap")


def test_flops_of_a_call():
    spec = tiny_decoder()
    run = runner.Run(spec, 3, torch.device("cpu"))
    built = run.builder.build(spec["config"], 3, torch.device("cpu"), runner.CACHE)
    fl = DECODER.DecoderFlops(spec["config"], built["layouts"], (16, 16), (3, 3), 2)
    resblocks = 2 * 64 * 2 * 2 * (16 * 64)  # the level-0 down ResBlock's fc1 and fc2 alone: 64 positions x 2 images
    assert fl.forward > resblocks and fl.tower > 0 and fl.decode > 0
    assert fl.call() == fl.tower + 2 * fl.forward + fl.decode
    twice = DECODER.DecoderFlops(spec["config"], built["layouts"], (16, 16), (3, 3), 4)
    assert (twice.forward, twice.tower, twice.decode) == (2 * fl.forward, 2 * fl.tower, 2 * fl.decode)


def test_bounds_follow_the_shapes():
    att = stage_b_roofline.attention_bound_s(4, 1024, 1028, 20, 64)
    assert att == pytest.approx(4 * 4 * 20 * 1024 * 1028 * 64 / 989e12, rel=1e-9)  # compute-bound
    small = stage_b_roofline.attention_bound_s(4, 256, 260, 20, 64)
    assert small == pytest.approx(max((2 * 4 * 256 + 2 * 4 * 260) * 1280 * 2 / 3.35e12,
                                      4 * 4 * 20 * 256 * 260 * 64 / 989e12))
    spec = tiny_decoder()
    built = runner.Run(spec, 5, torch.device("cpu")).builder.build(spec["config"], 5, torch.device("cpu"), runner.CACHE)
    model = built["pipeline"].model
    runs = {}
    for blk, _, hw, n in stage_b_roofline.executions(model, (16, 16)):
        runs.setdefault(type(blk).__name__, []).append((hw, n))
    # ResBlocks: down 1 + 1 x 2 runs + 1, up 1 x 2 runs (level 2 deepest first: 3 runs) ...
    assert sum(n for _, n in runs["ResBlock"]) == 1 + 2 + 1 + 3 + 2 * 2 + 2
    assert sum(n for _, n in runs["AttnBlock"]) == 2 + 1 + 3 + 2 * 2


def test_controls_read_above_the_program():
    ctl = cell.load_module(cell.BENCH / "controls_stage_b.py")
    (line,) = list(ctl.decoder_readings(tiny_decoder((128, 128, 128)), [2**36 + 7], 0.2, torch.device("cpu")))
    prog, control = line["program"], line["control"]
    for k in ("eps_gap", "clip_pooled_gap"):
        assert control[k] > 2 * prog[k], (k, prog, control)
    assert control["step_gap"] > prog["step_gap"] == 0.0


@pytest.mark.cuda
def test_controls_fail_the_cells_limits_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the controls run at the cell's own size")
    ctl = cell.load_module(cell.BENCH / "controls_stage_b.py")
    spec = cell.cell_spec(CELL)
    limits = spec["check"]["limits"]
    (line,) = list(ctl.decoder_readings(spec, [2**40 + 79], 6.0, torch.device("cuda:0")))
    print(line)
    assert line["correct"] and all(line["program"][k] <= v for k, v in limits.items()), line
    assert all(line["control"][k] > v for k, v in limits.items()), line
