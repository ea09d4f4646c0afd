"""The port's span and counter recorder (paella_tpu_torch/utils/tracing.py)
and the layers that report into it, on the CPU: spans nest under their
parents and carry their request's id, also across the server's
micro-batching threads; off, nothing is kept and no profiler range opens;
on, every span is a profiler range of its name; a tiny PaellaServer request
and a tiny training step record their layers; the bounded buffer counts what
it drops; utils/logging.py::trace writes the spans and the counters; GET
/stats answers the counters over a real socket. The graph counters and the
rule that no span opens inside a capture need a card (`cuda` marker). The
module imports neither jax nor the JAX package.
"""
import json
import threading
import urllib.request

import pytest
import torch

from paella_tpu_torch import PaellaConfig, PaellaPipeline, SampleConfig, TrainConfig, VQConfig
from paella_tpu_torch.codec import VQModel
from paella_tpu_torch.models import Paella
from paella_tpu_torch.serve import PaellaServer
from paella_tpu_torch.train import Batch, Draws, NullCond, create_train_state, make_train_step
from paella_tpu_torch.utils import tracing
from paella_tpu_torch.utils.logging import trace

HW = 32  # the tiny codec's f4: an 8x8 latent
REQ = {"steps": 2, "height": HW, "width": HW}


@pytest.fixture(autouse=True)
def recorder():
    """The recorder on and empty for the test, off and empty after it."""
    tracing.reset()
    tracing.enable()
    yield
    tracing.disable()
    tracing.reset()


def tiny_models(seed: int = 0):
    model, vq = Paella(PaellaConfig.tiny()), VQModel(VQConfig.tiny())
    model.reset_parameters(torch.Generator().manual_seed(seed))
    vq.reset_parameters(torch.Generator().manual_seed(seed + 1))
    return model, vq


@pytest.fixture(scope="module")
def pipeline():
    model, vq = tiny_models()
    table = torch.randn(260, model.config.byt5_embd, generator=torch.Generator().manual_seed(2))
    clip = torch.randn(1, model.config.clip_embd, generator=torch.Generator().manual_seed(3))
    return PaellaPipeline(model, vq, lambda ids, mask: table[ids.long()],
                          clip_text_fn=lambda prompts: clip.expand(len(prompts), -1))


def spans():
    return tracing.snapshot()["spans"]


def named(name):
    return [s for s in spans() if s.name == name]


def counters():
    return tracing.snapshot()["counters"]


def profiled_names(fn) -> list:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [e.name for e in prof.events()]


def test_spans_nest_with_parents_and_request_ids():
    with tracing.span("outer", new_request=True, size=3):
        with tracing.span("inner"):
            at = tracing.here()
            tracing.record("earlier", 5, 7)
        with tracing.span("second", new_request=True):
            pass

    def elsewhere():
        with tracing.span("other_thread", at=at):
            with tracing.span("under_it"):
                pass
        tracing.record("queued", 1, 2, at=at)
        with tracing.span("loose"):
            pass

    t = threading.Thread(target=elsewhere)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive()
    s = spans()
    by = {x.name: (i, x) for i, x in enumerate(s)}
    (i_out, outer), (i_in, inner) = by["outer"], by["inner"]
    assert outer.parent == -1 and outer.request > 0 and outer.attrs == {"size": 3}
    assert inner.parent == i_out and inner.request == outer.request
    assert by["earlier"][1].parent == i_in and (by["earlier"][1].start_ns, by["earlier"][1].end_ns) == (5, 7)
    second = by["second"][1]
    assert second.parent == i_out and second.request not in (0, outer.request)
    other = by["other_thread"][1]
    assert other.parent == i_in and other.request == outer.request and other.thread != outer.thread
    assert by["under_it"][1].parent == by["other_thread"][0] and by["under_it"][1].request == outer.request
    assert by["queued"][1].parent == i_in and by["queued"][1].request == outer.request
    assert by["loose"][1].parent == -1 and by["loose"][1].request == 0
    assert all(x.end_ns >= x.start_ns > 0 for x in s if x.name not in ("earlier", "queued"))


def test_off_keeps_nothing_and_opens_no_profiler_range():
    tracing.disable()

    def work():
        with tracing.span("off.span", new_request=True):
            tracing.record("off.record", 1, 2)
            torch.ones(4).add_(1)

    assert tracing.span("off.span") is tracing.span("other", new_request=True)  # one shared no-op, nothing made
    assert tracing.here() is None
    names = profiled_names(work)
    assert "aten::add_" in names and not {"off.span", "off.record"} & set(names)
    assert spans() == []
    tracing.count("off.counted", 2)  # counters count either way
    tracing.gauge("off.gauge", 7)
    assert counters()["off.counted"] == 2 and tracing.snapshot()["gauges"]["off.gauge"] == 7


def test_on_each_span_is_a_profiler_range():
    def work():
        with tracing.span("on.outer"):
            with tracing.span("on.inner"):
                torch.ones(4).add_(1)

    names = profiled_names(work)
    assert "on.outer" in names and "on.inner" in names


def test_bounded_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "MAX_SPANS", 3)
    for i in range(4):
        with tracing.span(f"s{i}"):
            pass
    tracing.record("late", 1, 2)
    snap = tracing.snapshot()
    assert [s.name for s in snap["spans"]] == ["s0", "s1", "s2"] and snap["dropped"] == 2
    tracing.reset()
    assert tracing.snapshot()["dropped"] == 0 and spans() == []


def test_server_request_records_its_layers_and_the_text_cache(pipeline):
    srv = PaellaServer(pipeline, host="127.0.0.1", port=0)
    srv.generate(dict(REQ, prompt="a tiny corgi", seed=3))
    s = spans()
    roots = [i for i, x in enumerate(s) if x.name == "serve.request"]
    assert len(roots) == 1 and s[roots[0]].parent == -1 and s[roots[0]].request > 0
    kids = [x.name for x in s if x.parent == roots[0]]
    for name in ("serve.lock_wait", "pipeline.tokenize", "cond.byt5", "cond.clip_text", "sample", "pipeline.decode",
                 "serve.to_host", "serve.png"):
        assert name in kids, (name, kids)
    assert kids.index("sample") < kids.index("pipeline.decode") < kids.index("serve.to_host") < kids.index("serve.png")
    assert {x.request for x in s} == {s[roots[0]].request}
    c = counters()
    assert c["serve.requests"] == 1 and c["text_cache.miss"] >= 2 and "text_cache.hit" not in c
    tracing.reset()
    srv.generate(dict(REQ, prompt="a tiny corgi", seed=4))  # the same prompt: the LRU answers
    c = counters()
    assert c["text_cache.hit"] == 1 and "text_cache.miss" not in c
    assert not named("cond.byt5") and not named("pipeline.tokenize") and len(named("serve.png")) == 1


def test_micro_batched_requests_keep_their_ids_across_threads(pipeline):
    srv = PaellaServer(pipeline, host="127.0.0.1", port=0, max_batch=2, batch_window_ms=5000)
    srv.start()
    try:
        go = threading.Barrier(2)
        errors = []

        def client(seed):
            go.wait(timeout=30)
            try:
                srv.generate(dict(REQ, prompt="a tiny corgi", seed=seed))
            except Exception as e:  # reported by the assert below
                errors.append(e)

        threads = [threading.Thread(target=client, args=(s,)) for s in (5, 6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads) and not errors
    finally:
        srv.stop()
    s = spans()
    requests = {i: x for i, x in enumerate(s) if x.name == "serve.request"}
    assert len(requests) == 2 and len({x.request for x in requests.values()}) == 2
    (i_batch, batch), = [(i, x) for i, x in enumerate(s) if x.name == "serve.batch"]
    assert batch.attrs["size"] == 2 and sorted(batch.attrs["requests"]) == sorted(x.request for x in requests.values())
    assert batch.thread not in {x.thread for x in requests.values()}
    for name in ("serve.queue_wait", "serve.to_host"):
        got = named(name)
        assert len(got) == 2, name
        for x in got:
            assert x.parent in requests and x.request == requests[x.parent].request, name
            assert x.thread != requests[x.parent].thread, name
    assert {x.name for x in s if x.parent == i_batch} >= {"serve.lock_wait", "sample", "pipeline.decode"}
    assert len(named("serve.png")) == 2 and all(x.parent in requests for x in named("serve.png"))
    c = counters()
    assert (c["serve.requests"], c["serve.batches"], c["serve.batch_images"]) == (2, 1, 2)


def test_stats_answers_the_counters_over_a_socket(pipeline):
    tracing.disable()  # counters count with the recorder off too
    srv = PaellaServer(pipeline, host="127.0.0.1", port=0)
    srv.start()
    try:
        def stats():
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/stats", timeout=60) as r:
                assert r.headers["Content-Type"] == "application/json"
                return json.loads(r.read())

        before = stats()["counters"]
        body = json.dumps(dict(REQ, prompt="stats please", seed=9)).encode()
        req = urllib.request.Request(f"http://127.0.0.1:{srv.port}/generate", data=body,
                                     headers={"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=300) as r:
            assert r.status == 200
        got = stats()
    finally:
        srv.stop()
    after = got["counters"]
    assert after["serve.requests"] == before.get("serve.requests", 0) + 1
    assert after["text_cache.miss"] > before.get("text_cache.miss", 0)
    assert isinstance(got["gauges"], dict)


@pytest.mark.parametrize("pinned", [False, True])
def test_train_step_records_its_phases(pinned):
    model, vq = tiny_models(4)
    g = torch.Generator().manual_seed(5)
    cfg = model.config
    batch = Batch(torch.rand(2, 64, 64, 3, generator=g), torch.randn(2, 6, cfg.byt5_embd, generator=g),
                  torch.ones(2, 6, dtype=torch.bool), torch.randn(2, cfg.clip_embd, generator=g),
                  torch.randn(2, cfg.clip_embd, generator=g))
    null = NullCond(torch.zeros(1, 2, cfg.byt5_embd), torch.ones(1, 2, dtype=torch.bool), torch.zeros(1, cfg.clip_embd))
    t_cfg = TrainConfig(warmup_updates=1)
    step = make_train_step(model, vq, t_cfg)
    step(create_train_state(model, t_cfg), batch, null, [Draws(dropout_seed=1 if pinned else None)])
    s = spans()
    (i_step, _), = [(i, x) for i, x in enumerate(s) if x.name == "train.step"]
    phases = [x.name for x in s if x.parent == i_step]
    syncs = 0 if pinned else 1  # the dropout seed's read, where the step draws it
    assert phases == ["train.encode", "train.noise"] + ["train.sync"] * syncs + [
        "train.forward", "train.loss", "train.backward", "train.optimizer"]
    (i_opt, _), = [(i, x) for i, x in enumerate(s) if x.name == "train.optimizer"]
    assert [x.name for x in s if x.parent == i_opt] == ["train.sync", "train.sync"]  # non-finite test, clipping test
    assert s[i_step].parent == -1 and not named("train.allreduce")


def test_trace_writes_the_program_spans_and_the_counters(tmp_path):
    tracing.disable()  # trace() turns the recorder on for its duration
    with trace(str(tmp_path), name="t"):
        with tracing.span("traced.layer"):
            torch.ones(4).add_(1)
        tracing.count("traced.counter", 3)
    assert not tracing.enabled()
    events = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    assert any(e.get("name") == "traced.layer" and e.get("cat") == "user_annotation" for e in events)
    side = json.loads((tmp_path / "t_counters.json").read_text())
    assert side["counters"]["traced.counter"] == 3 and side["dropped"] == 0 and "gauges" in side


# -- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the sampler's CUDA graphs and their kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
def test_graph_counts_hits_misses_evictions_and_replayed_launches(cuda, monkeypatch):
    from paella_tpu_torch.kernels import launch_counts
    from paella_tpu_torch.sampling import Conditioning, graph, sample

    model = tiny_models(6)[0].to(cuda).eval()
    g = torch.Generator().manual_seed(7)
    n = lambda *shape: torch.randn(*shape, generator=g).to(cuda)  # noqa: E731
    cfg = model.config
    cond = Conditioning(n(3, 6, cfg.byt5_embd), n(3, cfg.clip_embd), n(3, cfg.clip_embd))
    uncond = Conditioning(n(3, 2, cfg.byt5_embd), n(3, cfg.clip_embd))
    seeds = torch.tensor([[11, 12], [13, 14], [15, 16]])
    s_cfg = SampleConfig(steps=3, cfg=(3.0, 3.0))
    graph.clear()
    sample(model, seeds, cond, (3, 16, 16), uncond, s_cfg)  # a miss: the warm-up and the capture
    c = counters()
    assert c["graph.miss"] == 1 and "graph.hit" not in c and not any(k.startswith("launches.") for k in c)
    assert tracing.snapshot()["gauges"]["graph.pool_bytes"] == sum(graph.pool_bytes())
    wrappers = launch_counts()
    sample(model, seeds, cond, (3, 16, 16), uncond, s_cfg)  # a replay: no wrapper is called
    c = counters()
    assert c["graph.hit"] == 1 and launch_counts() == wrappers
    (entry,) = graph._GRAPHS.values()
    assert entry.launches and {k: c[k] for k in entry.launches} == entry.launches
    assert entry.launches["launches.fused_resblock"] > 0 and entry.launches["launches.gumbel_categorical"] == 3
    names = [x.name for x in spans()]
    assert names == ["sample", "graph.capture", "sample", "graph.replay"]
    monkeypatch.setattr(graph, "MAX_GRAPHS", 1)
    sample(model, seeds, cond, (3, 16, 16), uncond, SampleConfig(steps=2, cfg=(3.0, 3.0)))  # another structure
    assert counters()["graph.evicted"] == 1 and counters()["graph.miss"] == 2
    graph.clear()
    assert tracing.snapshot()["gauges"]["graph.pool_bytes"] == 0


@pytest.mark.cuda
def test_no_span_opens_inside_a_capture(cuda):
    x = torch.zeros(8, device=cuda)
    x.add_(1)  # the kernel's first use outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        assert tracing.span("captured") is tracing.span("also")  # the shared no-op
        with tracing.span("captured"):
            x.add_(1)
    with tracing.span("outside"):
        g.replay()
    torch.cuda.synchronize()
    assert [s.name for s in spans()] == ["outside"] and float(x[0]) == 2.0
