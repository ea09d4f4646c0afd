"""The control of each cell's check: the precision below the
configuration's must come out as not correct. At test size on the CPU the
control machinery runs and reads well above the program; on the card
(`cuda` marker) at the cell's own size it fails the cell's limits while the
program passes them."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import _tiny  # noqa: E402
from bench_port.core import cell  # noqa: E402

CTL = cell.load_module(cell.BENCH / "control.py")
CELLS = [w["name"] for w in cell.benchmark()["workloads"]]


def _lines(spec, seeds, seconds, device):
    fn = CTL.train_readings if spec["entry"] == "train_step" else CTL.readings
    return list(fn(spec, seeds, seconds, device))


@pytest.mark.parametrize("name", ["t2i-b1-fresh", "train-1b-b16"])
def test_control_reads_above_the_program_at_test_size(name):
    spec = _tiny.spec(name)
    if spec["entry"] != "train_step":
        # widths the int8 kernel path takes (c % 128 == 0)
        spec["config"]["parts"]["denoiser"]["sizes"].update(c_hidden=[128, 128, 128], blocks=[1, 1, 1])
    (line,) = _lines(spec, [2**36 + 3], 0.5, torch.device("cpu"))
    prog = line["program"]
    if spec["entry"] == "train_step":
        assert line["control_fp8"]["loss_gap"] > 2 * prog["loss_gap"]
        assert line["fault_half_batch"]["loss_gap"] > 2 * prog["loss_gap"]
    else:
        assert line["control"]["logit_gap"] > 2 * prog["logit_gap"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_cells_limits_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the control runs at the cell's own size")
    spec = cell.cell_spec(name)
    limits = spec["check"]["limits"]
    (line,) = _lines(spec, [2**40 + 77], 6.0, torch.device("cuda:0"))
    assert line["correct"] and all(line["program"][k] <= v for k, v in limits.items())
    controls = [line[k] for k in ("control", "control_fp8") if k in line]
    assert any(c[k] > v for c in controls for k, v in limits.items() if k in c)


def test_control_refuses_to_read_without_a_card(monkeypatch, capsys):
    # limits come from the port's path on the card, never from the plain
    # versions its wrappers run on the CPU
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert CTL.main(["--workload", CELLS[0], "--seeds", "1"]) == 2
    assert capsys.readouterr().out == ""
