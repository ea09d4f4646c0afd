"""The traffic generator: the same seed gives the same traffic, another seed
the same sizes in another order."""
from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from bench_port.core import cell, traffic  # noqa: E402

MIXES = sorted(p.stem for p in (cell.BENCH / "traffic").glob("*.json"))


def _calls(mix: dict, seed: int, n: int) -> list:
    g = traffic.generator(mix, seed)
    return [g.next() for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    mix = cell.read_json(cell.BENCH / "traffic" / f"{name}.json")
    assert _calls(mix, 2**40 + 3, 20) == _calls(mix, 2**40 + 3, 20)
    assert _calls(mix, 2**40 + 3, 20) != _calls(mix, 2**40 + 4, 20)


def test_fresh_prompts_sizes_by_block():
    mix = cell.read_json(cell.BENCH / "traffic" / "fresh-prompts-b1.json")
    block = mix["block"]
    a, b = _calls(mix, 11, 3 * block), _calls(mix, 2**33 + 5, 3 * block)
    prompts = [c["prompts"][0] for c in a]
    assert len(set(prompts)) == len(prompts)  # the text cache never hits
    lens = lambda calls: sorted(len(c["prompts"][0].encode()) for c in calls)  # noqa: E731
    assert lens(a) == lens(b)  # each block holds the same lengths, whatever the seed
    assert [len(c["prompts"][0].encode()) for c in a] != [len(c["prompts"][0].encode()) for c in b]
    assert min(lens(a)) >= mix["prompt_bytes"]["min"] and max(lens(a)) <= mix["prompt_bytes"]["max"]
    assert all(len(c["seeds"]) == 1 and 0 <= c["seeds"][0] < 2**32 for c in a)


def test_cached_prompts_repeat():
    mix = cell.read_json(cell.BENCH / "traffic" / "cached-prompts-b8.json")
    calls = _calls(mix, 7, 5)
    assert all(c["prompts"] == calls[0]["prompts"] for c in calls)
    assert len(set(calls[0]["prompts"])) == mix["batch"]
    assert len({s for c in calls for s in c["seeds"]}) == 5 * mix["batch"]
    from paella_tpu_torch.cond.tokenizers import pad_bucket

    assert {pad_bucket(len(p.encode()) + 1) for p in calls[0]["prompts"]} == {128}


def test_train_batch_from_seed():
    mix = dict(cell.read_json(cell.BENCH / "traffic" / "train-batches-b16.json"), images=2, image_hw=32, byt5_len=8,
               byt5_embd=12, clip_embd=6)
    train = cell.read_json(cell.BENCH / "configs" / "paella-v1-train-1b.json")["train"]
    a = traffic.train_batch(mix, train, 64, (8, 8), 2**45 + 1, "cpu")
    b = traffic.train_batch(mix, train, 64, (8, 8), 2**45 + 1, "cpu")
    c = traffic.train_batch(mix, train, 64, (8, 8), 2**45 + 2, "cpu")
    for k in a:
        assert (a[k] == b[k]) if not torch.is_tensor(a[k]) else torch.equal(a[k], b[k])
    assert not torch.equal(a["images"], c["images"])
    assert a["images"].shape == (2, 32, 32, 3) and float(a["images"].min()) >= 0 and float(a["images"].max()) <= 1
    assert a["byt5_mask"][:, 0].all() and int(a["random_x"].max()) < 64
