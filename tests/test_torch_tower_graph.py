"""The text towers' CUDA graphs (sampling/graph.py::tower, called from the
forwards of cond/t5.py::T5Encoder and cond/clip.py::CLIPTextEncoder).

On the CPU: what a tower graph's key holds (batch, bucket, dtypes, device,
config, the weights' storage) and what it does not (input values, the
derived-weight generation); that CPU inputs take the eager forward, for
ByT5 in float, weight-only and W8A8 and for the CLIP text tower; that the
sampler's key and budget are as they were; and that the two families' LRU
budgets never touch each other's graphs.

On a card (the `cuda` marker; the module imports neither jax nor the JAX
package):

    python -m pytest -q --noconftest -m cuda tests/test_torch_tower_graph.py

replays equal the eager forward bit for bit (ByT5-XL at buckets 64/128/256,
batch 1 and 8; the ViT-H-14 text tower at 77 tokens; ByT5's int8 modes), a
second call of a shape is a hit and new ids give new states, a returned
tensor outlives the next replay, a weight swapped with `.data =`
recaptures, and a tower called inside another capture runs eagerly.
"""
import dataclasses
import weakref

import pytest
import torch

from paella_tpu_torch import quant
from paella_tpu_torch.cond.clip import CLIPTextConfig, CLIPTextEncoder
from paella_tpu_torch.cond.t5 import T5Config, T5Encoder
from paella_tpu_torch.nn.blocks import DerivedWeights
from paella_tpu_torch.sampling import graph
from paella_tpu_torch.sampling.sampler import SampleStructure
from paella_tpu_torch.utils import tracing


def tiny_t5(mode: str = "float", seed: int = 0) -> T5Encoder:
    """T5Config.tiny() with seeded weights: float, or quantize_t5_int8's
    weight-only ("int8") or W8A8 ("w8a8") mode."""
    enc = T5Encoder(T5Config.tiny())
    enc.reset_parameters(torch.Generator().manual_seed(seed))
    if mode != "float":
        enc = quant.quantize_t5_int8(enc)
        enc.config = dataclasses.replace(enc.config, act_quant=mode == "w8a8")
    return enc.eval()


def tiny_clip(seed: int = 1) -> CLIPTextEncoder:
    enc = CLIPTextEncoder(CLIPTextConfig.tiny())
    enc.reset_parameters(torch.Generator().manual_seed(seed))
    return enc.eval()


def t5_inputs(batch: int = 2, bucket: int = 64, seed: int = 2, device="cpu") -> dict:
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, 259, (batch, bucket), generator=g, dtype=torch.int32)
    mask = torch.arange(bucket)[None, :] < torch.randint(1, bucket + 1, (batch, 1), generator=g)
    return {"input_ids": (ids * mask).to(device), "attention_mask": mask.to(device)}


def clip_inputs(batch: int = 2, seed: int = 3, device="cpu", length: int = 16, vocab: int = 64) -> dict:
    ids = torch.randint(0, vocab - 1, (batch, length), generator=torch.Generator().manual_seed(seed))
    ids[:, 0], ids[:, -1] = vocab - 2, vocab - 1  # start and end of text: the highest id, at the end
    return {"input_ids": ids.to(device)}


@pytest.fixture
def families():
    """Both families' graphs emptied for the test and put back after it."""
    kept = {id(f): dict(f.graphs) for f in (graph._SAMPLER, graph._TOWERS)}
    for f in (graph._SAMPLER, graph._TOWERS):
        f.graphs.clear()
    tracing.reset()
    yield
    for f in (graph._SAMPLER, graph._TOWERS):
        f.graphs.clear()
        f.graphs.update(kept[id(f)])
    tracing.reset()


# -- the tower key ------------------------------------------------------------


def test_tower_key_holds_module_config_device_signature_and_storage():
    enc, inputs = tiny_t5(), t5_inputs()
    key = graph.tower_key(enc, inputs)
    assert key[:4] == (id(enc), enc.config, "cpu", (("input_ids", ((2, 64), torch.int32)),
                                                    ("attention_mask", ((2, 64), torch.bool))))
    assert key[4] == tuple(t.data_ptr() for t in [*enc.parameters(), *enc.buffers()])


@pytest.mark.parametrize("change", ["batch", "bucket", "ids_dtype", "no_mask", "device"])
def test_a_new_input_signature_changes_the_tower_key(change):
    enc, inputs = tiny_t5(), t5_inputs()
    other = {
        "batch": lambda: t5_inputs(batch=8),
        "bucket": lambda: t5_inputs(bucket=128),
        "ids_dtype": lambda: {**inputs, "input_ids": inputs["input_ids"].long()},
        "no_mask": lambda: {**inputs, "attention_mask": None},
        "device": lambda: t5_inputs(device="meta"),
    }[change]()
    assert graph.tower_key(enc, other) != graph.tower_key(enc, inputs)


@pytest.mark.parametrize("change", ["act_quant", "data_swap", "dtype", "submodule", "new_module"])
def test_a_new_config_or_weight_storage_changes_the_tower_key(change):
    enc, inputs = tiny_t5("int8" if change == "act_quant" else "float"), t5_inputs()
    before = graph.tower_key(enc, inputs)
    if change == "act_quant":
        enc.config = dataclasses.replace(enc.config, act_quant=True)
    elif change == "data_swap":
        q = enc.encoder.block[1].layer[0].SelfAttention.q
        q.weight.data = q.weight.data.clone()
    elif change == "dtype":
        enc.to(torch.bfloat16)
    elif change == "submodule":  # what quantize_t5_int8 does to each block linear
        holder = enc.encoder.block[0].layer[1].DenseReluDense
        holder.wo = quant._to_int8(holder.wo)
    else:
        enc = tiny_t5()
    assert graph.tower_key(enc, inputs) != before


def test_input_values_weights_written_in_place_and_the_generation_leave_the_key():
    """New ids and mask values, weights overwritten in place (the graph reads
    them where they are) and a moved derived-weight generation (every
    training update moves it; the towers are frozen) keep the graph."""
    enc = tiny_t5()
    key = graph.tower_key(enc, t5_inputs(seed=2))
    assert graph.tower_key(enc, t5_inputs(seed=9)) == key
    enc.load_state_dict(tiny_t5(seed=5).state_dict())
    with torch.no_grad():
        enc.shared.weight.mul_(2.0)
    DerivedWeights.generation += 1
    assert graph.tower_key(enc, t5_inputs(seed=2)) == key


def test_reads_keeps_its_list_until_the_tower_itself_registers():
    """The tensors `reads` lists are kept across calls and across
    registrations into other modules (an nn.Sequential sliced in a forward,
    as the codec's decoder does, builds a new one), and listed again after a
    registration into one of the tower's own modules."""
    enc = tiny_t5()
    graph.reads(enc)
    kept = graph._READS[enc]
    torch.nn.Sequential(torch.nn.Linear(2, 2), torch.nn.ReLU())[1:]
    graph.reads(enc)
    assert graph._READS[enc] is kept
    enc.encoder.block[0].layer[0].SelfAttention.q = torch.nn.Linear(32, 32, bias=False)
    assert enc not in graph._READS
    graph.reads(enc)
    assert graph._READS[enc] is not kept


def test_clip_text_key_follows_batch_and_context_length():
    enc = tiny_clip()
    key = graph.tower_key(enc, clip_inputs())
    assert graph.tower_key(enc, clip_inputs(seed=8)) == key
    assert graph.tower_key(enc, clip_inputs(batch=1)) != key
    assert graph.tower_key(enc, clip_inputs(length=12)) != key
    assert graph.tower_key(tiny_clip(), clip_inputs()) != key


# -- the eager route ------------------------------------------------------------


@pytest.mark.parametrize("tower", ["byt5", "byt5_int8", "byt5_w8a8", "clip_text"])
def test_cpu_inputs_take_the_eager_forward(tower, families, monkeypatch):
    """On the CPU the forward is the op-by-op forward, bit for bit, and no
    graph code runs: nothing is kept, nothing counted."""
    def no_graph(*args, **kwargs):
        raise AssertionError("a CPU forward reached the graph route")

    monkeypatch.setattr(graph, "_call", no_graph)
    if tower == "clip_text":
        enc, inputs = tiny_clip(), clip_inputs()
    else:
        enc, inputs = tiny_t5({"byt5": "float", "byt5_int8": "int8", "byt5_w8a8": "w8a8"}[tower]), t5_inputs()
    got = enc(**inputs)
    assert torch.equal(got, enc._forward(**inputs))
    assert not graph._TOWER_GRAPHS and not tracing.snapshot()["counters"]


def test_w8a8_changes_the_cpu_forward():
    """The W8A8 mode the eager route runs is the W8A8 product, not the
    weight-only one (act_quant is read on the CPU route too)."""
    inputs = t5_inputs()
    assert not torch.equal(tiny_t5("w8a8")(**inputs), tiny_t5("int8")(**inputs))


# -- the sampler's key and the two budgets ----------------------------------------


def test_sampler_key_and_budget_are_unchanged():
    class Model:
        config = "config"

    model, structure = Model(), SampleStructure((1, 16, 16), 8, 8, "xla")
    inputs = {"seeds": torch.zeros(1, 2, dtype=torch.int64), "schedule": torch.zeros(4, 9), "cond.clip": None}
    shapes = (("seeds", ((1, 2), torch.int64)), ("schedule", ((4, 9), torch.float32)), ("cond.clip", None))
    assert graph.graph_key(model, structure, inputs) == (id(model), "config", DerivedWeights.generation, "cpu",
                                                         structure, shapes)
    assert graph.MAX_GRAPHS == 16 and graph.MAX_TOWER_GRAPHS == 24
    assert graph._SAMPLER.graphs is graph._GRAPHS and graph._TOWERS.graphs is graph._TOWER_GRAPHS


class Owner:
    """Stands for a model or tower a kept graph was captured from."""


def fake(owner, pool: int = 1) -> "graph._Graph":
    return graph._Graph(weakref.ref(owner), None, {}, None, pool, {})


def sampler_key(owner, i: int, generation=None) -> tuple:
    gen = DerivedWeights.generation if generation is None else generation
    return id(owner), "config", gen, "cuda:0", i, ()


def tower_key(owner, i: int, storage=(1,)) -> tuple:
    return id(owner), "config", "cuda:0", i, storage


def test_a_tower_graph_never_evicts_a_sampler_graph(families):
    """Towers past their budget drop their own least recently used graph;
    the sampler's graphs, at their own budget, stay."""
    model, towers = Owner(), [Owner() for _ in range(graph.MAX_TOWER_GRAPHS + 1)]
    for i in range(graph.MAX_GRAPHS):
        graph._GRAPHS[sampler_key(model, i)] = fake(model)
    for i, t in enumerate(towers[:-1]):
        graph._TOWER_GRAPHS[tower_key(t, i)] = fake(t)
    sampler = dict(graph._GRAPHS)
    graph._drop_stale(graph._TOWERS, tower_key(towers[-1], 99))
    assert graph._GRAPHS == sampler
    assert len(graph._TOWER_GRAPHS) == graph.MAX_TOWER_GRAPHS - 1
    assert tower_key(towers[0], 0) not in graph._TOWER_GRAPHS and tower_key(towers[1], 1) in graph._TOWER_GRAPHS
    assert tracing.snapshot()["counters"] == {"tower_graph.evicted": 1}


def test_a_sampler_graph_never_evicts_a_tower_graph(families):
    """The sampler's budget and its derived-weight staleness drop sampler
    graphs only: a tower graph outlives a training update."""
    model, tower = Owner(), Owner()
    graph._GRAPHS[sampler_key(model, 0, generation=DerivedWeights.generation - 1)] = fake(model)
    for i in range(graph.MAX_GRAPHS):
        graph._GRAPHS[sampler_key(model, i + 1)] = fake(model)
    graph._TOWER_GRAPHS[tower_key(tower, 0)] = fake(tower)
    towers = dict(graph._TOWER_GRAPHS)
    graph._drop_stale(graph._SAMPLER, sampler_key(model, 99))
    assert graph._TOWER_GRAPHS == towers
    assert len(graph._GRAPHS) == graph.MAX_GRAPHS - 1 and sampler_key(model, 1) not in graph._GRAPHS
    assert tracing.snapshot()["counters"] == {"graph.evicted": 2}


def test_a_tower_captured_with_other_weights_is_dropped(families):
    """Capturing a tower whose weights moved drops its graphs of the old
    storage (and of modules gone), and keeps other towers' graphs."""
    tower, other = Owner(), Owner()
    graph._TOWER_GRAPHS[tower_key(tower, 0, storage=(1,))] = fake(tower)
    graph._TOWER_GRAPHS[tower_key(tower, 1, storage=(2,))] = fake(tower)
    graph._TOWER_GRAPHS[tower_key(other, 0, storage=(1,))] = fake(other)
    gone = Owner()
    graph._TOWER_GRAPHS[tower_key(gone, 0)] = fake(gone)
    del gone
    graph._drop_stale(graph._TOWERS, tower_key(tower, 0, storage=(2,)))
    assert list(graph._TOWER_GRAPHS) == [tower_key(tower, 1, storage=(2,)), tower_key(other, 0, storage=(1,))]


def test_pool_bytes_and_clear_cover_each_family(families):
    model, tower = Owner(), Owner()
    graph._GRAPHS[sampler_key(model, 0)] = fake(model, pool=5)
    graph._TOWER_GRAPHS[tower_key(tower, 0)] = fake(tower, pool=7)
    graph._TOWER_GRAPHS[tower_key(tower, 1)] = fake(tower, pool=11)
    assert graph.pool_bytes() == [5] and graph.tower_pool_bytes() == [7, 11]
    graph.clear()
    assert not graph._GRAPHS and not graph._TOWER_GRAPHS
    gauges = tracing.snapshot()["gauges"]
    assert gauges["graph.pool_bytes"] == 0 and gauges["tower_graph.pool_bytes"] == 0


# -- on the card --------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def counted() -> dict:
    return {k: v for k, v in tracing.snapshot()["counters"].items() if k.startswith("tower_graph.")}


@pytest.fixture(scope="module")
def byt5_xl():
    """ByT5-XL as the server holds it (block linears in bf16), seeded, on
    the card; None without one."""
    if not torch.cuda.is_available():
        return None
    cfg = T5Config.byt5_xl()
    with torch.device("cuda"):
        enc = T5Encoder(cfg)
    enc.reset_parameters(torch.Generator(device="cuda").manual_seed(20))
    for m in enc.modules():
        if isinstance(m, torch.nn.Linear):
            m.weight.data = m.weight.data.to(cfg.compute_dtype)
    return enc.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("bucket", [64, 128, 256])
def test_byt5_xl_replay_equals_eager(cuda, byt5_xl, families, batch, bucket):
    """The capture's answer and a replay of new ids give the eager
    forward's states bit for bit; the second call is a hit."""
    first, second = (t5_inputs(batch, bucket, seed=s, device=cuda) for s in (30 + bucket, 31 + bucket))
    got = byt5_xl(**first)
    assert torch.equal(got, byt5_xl._forward(**first))
    assert counted() == {"tower_graph.miss.byt5": 1}
    again = byt5_xl(**second)
    assert counted() == {"tower_graph.miss.byt5": 1, "tower_graph.hit.byt5": 1}
    assert torch.equal(again, byt5_xl._forward(**second)) and not torch.equal(again, got)
    assert graph.tower_pool_bytes()[-1] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
def test_clip_text_vit_h_replay_equals_eager(cuda, families, batch):
    cfg = CLIPTextConfig.vit_h_14()
    with torch.device(cuda):
        enc = CLIPTextEncoder(cfg)
    enc.reset_parameters(torch.Generator(device=cuda).manual_seed(21))
    enc = enc.cast_products().eval()
    first, second = (clip_inputs(batch, seed=s, device=cuda, length=77, vocab=cfg.vocab_size) for s in (40, 41))
    assert torch.equal(enc(**first), enc._forward(**first))
    got = enc(**second)
    assert torch.equal(got, enc._forward(**second))
    assert counted() == {"tower_graph.miss.clip_text": 1, "tower_graph.hit.clip_text": 1}


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["int8", "w8a8"])
def test_byt5_int8_modes_replay_equal_eager(cuda, byt5_xl, families, mode):
    """quantize_t5_int8's weight-only and W8A8 (quant.w8a8_dot: cuBLASLt's
    s8 x s8 -> s32 product) modes take the graph route and replay the eager
    forward bit for bit."""
    enc = quant.quantize_t5_int8(byt5_xl)
    enc.config = dataclasses.replace(enc.config, act_quant=mode == "w8a8")
    for batch, bucket in ((1, 64), (2, 128)):
        for seed in (50, 51):
            inputs = t5_inputs(batch, bucket, seed=seed, device=cuda)
            assert torch.equal(enc(**inputs), enc._forward(**inputs))
    assert counted() == {"tower_graph.miss.byt5": 2, "tower_graph.hit.byt5": 2}
    del enc
    graph.clear()


@pytest.mark.cuda
def test_a_kept_output_outlives_the_next_replay(cuda, families):
    """States returned from one call (the pipeline's text LRU keeps them)
    keep their values after another prompt of the same bucket replays the
    graph."""
    enc = tiny_t5().to(cuda)
    a, b = t5_inputs(seed=60, device=cuda), t5_inputs(seed=61, device=cuda)
    kept = [enc(**a), enc(**a)]
    want = kept[0].clone()
    enc(**b)
    enc(**b)
    assert torch.equal(kept[0], want) and torch.equal(kept[1], want)


@pytest.mark.cuda
def test_a_weight_swapped_with_data_recaptures(cuda, families):
    enc = tiny_t5().to(cuda)
    inputs = t5_inputs(seed=62, device=cuda)
    old = enc(**inputs)
    enc(**inputs)
    wo = enc.encoder.block[0].layer[1].DenseReluDense.wo
    wo.weight.data = wo.weight.data * 3.0
    got = enc(**inputs)
    # the graph of the old storage went
    assert counted() == {"tower_graph.miss.byt5": 2, "tower_graph.hit.byt5": 1, "tower_graph.evicted": 1}
    assert len(graph._TOWER_GRAPHS) == 1
    assert torch.equal(got, enc._forward(**inputs)) and not torch.equal(got, old)
    assert torch.equal(enc(**inputs), got)


@pytest.mark.cuda
def test_a_tower_inside_an_outer_capture_runs_eagerly(cuda, families):
    """Called while the current stream captures, the forward's ops go into
    the outer graph; no tower graph is taken or counted."""
    enc = tiny_clip().to(cuda)
    inputs = clip_inputs(device=cuda)
    want = enc._forward(**inputs)  # the kernels' first use outside the capture
    torch.cuda.synchronize()
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        out = enc(**inputs)
    assert not counted() and not graph._TOWER_GRAPHS
    outer.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)
