"""Stable Cascade's Stage C prior in the port (models/stage_c.py, K1's
channelwise-skip mode, the CLIP-bigG route, sampling/prior.py and
CascadePriorPipeline) against the plain reference `tests/stage_c_reference.py`
(float32 torch, importing nothing of the port), on seeded random weights.

On the CPU at StageCConfig.tiny() and a tiny text tower. On a card (the
`cuda` marker; the module imports neither jax nor the JAX package), at the
published widths:

    python -m pytest -q --noconftest -m cuda tests/test_torch_stage_c.py
"""
import dataclasses
import filecmp
import math
import os
import tempfile
from pathlib import Path

import pytest
import torch

import stage_c_reference as ref
from paella_tpu_torch import CascadePriorPipeline, PriorSampleConfig, StageCConfig
from paella_tpu_torch.cond.clip import CLIPTextConfig, CLIPTextEncoder
from paella_tpu_torch.cond.tokenizers import CLIPTokenizer, write_merges_file
from paella_tpu_torch.kernels.resblock import fused_resblock, resblock_plain
from paella_tpu_torch.models import StageC
from paella_tpu_torch.nn.blocks import ResBlock
from paella_tpu_torch.sampling import prior
from paella_tpu_torch.sampling.sampler import derive_seeds

ROOT = Path(__file__).resolve().parents[1]
TEXT = CLIPTextConfig(vocab_size=700, width=24, heads=4, layers=2, context_length=77, embed_dim=24)


def sizes(cfg: StageCConfig) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def state(module: torch.nn.Module, device=None) -> dict:
    return {k: v.detach().float().to(device or v.device) for k, v in module.state_dict().items()}


def tiny_model(seed: int = 0, **kw) -> StageC:
    m = StageC(dataclasses.replace(StageCConfig.tiny(), **kw))
    m.reset_parameters(torch.Generator().manual_seed(seed))
    return m.eval()


def tiny_tower(seed: int = 1) -> CLIPTextEncoder:
    t = CLIPTextEncoder(TEXT, graph_tag="clip_g")
    t.reset_parameters(torch.Generator().manual_seed(seed), std=0.1)
    return t.eval()


def conditioning(b: int, cfg: StageCConfig, seed: int = 2, s: int = 9) -> tuple:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, s, cfg.c_clip_text, generator=g), torch.randn(b, 1, cfg.c_clip_text_pooled, generator=g),
            torch.randn(b, 1, cfg.c_clip_img, generator=g))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().float() - b.detach().float()).norm() / b.detach().float().norm())


def test_stage_c_forward_matches_reference():
    m = tiny_model()
    cfg = m.config
    g = torch.Generator().manual_seed(3)
    x, r = torch.randn(3, 6, 5, cfg.c_in, generator=g), torch.rand(3, generator=g)
    cond = conditioning(3, cfg)
    got = m(x, r, *cond)
    want = ref.stage_c(state(m), sizes(cfg), x, r, *cond)
    assert got.shape == (3, 6, 5, cfg.c_out)
    assert rel(got, want) < 1e-5, rel(got, want)
    cache = m.gen_cond_cache(*cond)
    assert torch.equal(m(x, r, cond_cache=cache), got)


def test_stage_c_forward_in_bf16_stays_near_reference():
    m = tiny_model(dtype="bfloat16").to(torch.bfloat16)
    cfg = m.config
    g = torch.Generator().manual_seed(4)
    x, r = torch.randn(2, 4, 4, cfg.c_in, generator=g), torch.rand(2, generator=g)
    cond = conditioning(2, cfg)
    got = m(x, r, *cond)
    assert got.dtype == torch.bfloat16
    assert rel(got, ref.stage_c(state(m), sizes(cfg), x, r, *cond)) < 0.05


def test_stage_c_state_dict_names_and_published_size():
    with torch.device("meta"):
        m = StageC(StageCConfig.published())
    sd = m.state_dict()
    assert "down_downscalers.1.1.blocks.0.weight" in sd and "up_upscalers.0.1.blocks.1.weight" in sd
    assert sd["up_blocks.1.0.channelwise.0.weight"].shape == (8192, 4096)  # Linear(c + c_skip, 4c)
    assert sd["up_blocks.1.0.depthwise.weight"].shape == (2048, 1, 3, 3)
    assert "down_blocks.0.1.mapper_sca.weight" in sd and "down_blocks.0.1.mapper_crp.weight" in sd
    assert sum(isinstance(b, ResBlock) for b in m.modules()) == 64
    assert 3.55e9 < sum(p.numel() for p in m.parameters()) < 3.65e9


@pytest.mark.parametrize("c", [12, 32])
def test_channelwise_resblock_plain_matches_reference(c):
    g = torch.Generator().manual_seed(c)
    blk = ResBlock(c, c, skip_at="channelwise")
    for p in blk.parameters():
        p.data = torch.randn(p.shape, generator=g) * 0.2
    x, skip = torch.randn(2, 5, 4, c, generator=g), torch.randn(2, 5, 4, c, generator=g)
    film = torch.randn(2, 2 * c, generator=g) * 0.1
    w = blk.kernel_weights()
    assert w.channelwise_skip and w.dw.shape == (3, 3, 1, c)
    got = resblock_plain(x, w, film=film, skip=skip)
    assert torch.equal(got, fused_resblock(x, w, film=film, skip=skip))  # the CPU route is the plain version
    sd = {f"b.{k}": v for k, v in blk.state_dict().items()}
    y = ref.res_block(sd, "b", x.permute(0, 3, 1, 2), skip.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    want = y * (1 + film[:, None, None, :c]) + film[:, None, None, c:]
    assert rel(got, want) < 1e-5
    assert rel(blk.forward_train(x, skip), y) < 1e-5
    with pytest.raises(ValueError, match="need a skip"):
        resblock_plain(x, w, film=film)


def test_bigg_route_matches_reference_with_the_padding_mask():
    tower = tiny_tower()
    ids = torch.randint(1, 698, (3, 77), generator=torch.Generator().manual_seed(5))
    lengths = torch.tensor([4, 20, 77])
    ids[torch.arange(3), lengths - 1] = 699  # the EOT id, the vocabulary's highest
    ids, mask = ref.pad_with_eot(torch.where(torch.arange(77)[None] < lengths[:, None], ids, 0), 699)
    hidden, pooled = tower.hidden_states(ids, mask)
    want_h, want_p = ref.clip_text(state(tower), {"heads": TEXT.heads}, ids, mask)
    assert hidden.shape == (3, 77, 24) and pooled.shape == (3, 24)
    assert rel(hidden, want_h) < 1e-5 and rel(pooled, want_p) < 1e-5
    unmasked, _ = ref.clip_text(state(tower), {"heads": TEXT.heads}, ids, torch.ones_like(mask))
    assert rel(unmasked[0, 4:], want_h[0, 4:]) > 1e-3  # the padded positions see the mask
    assert torch.equal(pooled, tower(ids))  # the projected EOT feature is forward's


def test_tokenizer_pads_with_eot_as_the_reference_does():
    d = tempfile.mkdtemp()
    letters = "abcdefghijklmnopqrstuvwxyz"
    write_merges_file([(a, b) for a in letters for b in letters][:300], os.path.join(d, "m.txt"))
    tok = CLIPTokenizer(os.path.join(d, "m.txt"))
    ids, mask = tok.with_mask(["a corgi", "", "mountains at dawn"])
    want_ids, want_mask = ref.pad_with_eot(torch.from_numpy(tok(["a corgi", "", "mountains at dawn"])).long(),
                                           tok.eot_token_id)
    assert torch.equal(torch.from_numpy(ids).long(), want_ids) and torch.equal(torch.from_numpy(mask), want_mask)
    assert mask[1].sum() == 2  # SOT, EOT


def test_scheduler_step_and_draws_match_reference():
    seeds = torch.tensor([[7, 2**31 + 5], [0, 1]])
    t = prior.schedule(20)
    assert torch.equal(t, ref.schedule(20))
    for i in (0, 7):
        z = prior.gaussian(derive_seeds(seeds, prior.STEP_TAG, torch.tensor([i]))[0], (3, 4, 2))
        assert torch.equal(z, ref.noise(seeds, (3, 4, 2), ref.STEP_TAG, i))
    x0 = prior.gaussian(derive_seeds(seeds, prior.INIT_TAG, torch.zeros(1, dtype=torch.int64))[0], (3, 4, 2))
    assert torch.equal(x0, ref.noise(seeds, (3, 4, 2), ref.INIT_TAG, 0))
    g = torch.Generator().manual_seed(6)
    x, e, z = (torch.randn(2, 3, 4, 2, generator=g) for _ in range(3))
    for i in (0, 10, 19):
        got = prior.ddpm_step(x, e, t[i], t[i + 1], z)
        assert torch.equal(got, ref.ddpm_step(x, e, t[i], t[i + 1], z))
    assert torch.equal(prior.ddpm_step(x, e, t[19], t[20], z), prior.ddpm_step(x, e, t[19], t[20], 0 * z))
    ac = prior.alpha_cumprod(t)
    assert float(ac[0]) == pytest.approx(1e-4, rel=1e-6) and float(ac[-1]) == pytest.approx(0.9999, rel=1e-6)


def test_three_step_cfg_sample_matches_reference():
    m = tiny_model()
    cfg = m.config
    seeds = torch.tensor([[1, 2], [3, 4]])
    cond, uncond = conditioning(2, cfg, seed=7), conditioning(2, cfg, seed=8)
    got = prior.sample_prior(m, seeds, prior.PriorConditioning(*cond), (2, 5, 4, cfg.c_in),
                             prior.PriorConditioning(*uncond), PriorSampleConfig(steps=3, cfg=4.0))
    want = ref.sample(state(m), sizes(cfg), seeds, cond, uncond, (5, 4), 3, 4.0)
    assert rel(got, want) < 1e-4, rel(got, want)


def test_prior_pipeline_text_to_latents_on_the_cpu():
    d = tempfile.mkdtemp()
    letters = "abcdefghijklmnopqrstuvwxyz"
    write_merges_file([(a, b) for a in letters for b in letters][:150], os.path.join(d, "m.txt"))
    tok = CLIPTokenizer(os.path.join(d, "m.txt"))
    m = tiny_model(c_clip_text=24, c_clip_text_pooled=24)
    tower = CLIPTextEncoder(dataclasses.replace(TEXT, vocab_size=tok.vocab_size), graph_tag="clip_g")
    tower.reset_parameters(torch.Generator().manual_seed(9), std=0.1)
    pipe = CascadePriorPipeline(m, tower.eval(), tok.with_mask)
    seeds = torch.tensor([[0, 11], [0, 12]])
    cfg = PriorSampleConfig(steps=2)
    lat = pipe.text_to_latents(["a corgi", "a red cat"], seeds, image_hw=(128, 170), config=cfg)
    assert lat.shape == (2, 3, 4, m.config.c_in) and torch.isfinite(lat.float()).all()
    assert len(pipe._text_cache) == 2 and 2 in pipe._null_cache  # the prompts and the empty prompt
    again = pipe.text_to_latents(["a corgi", "a red cat"], seeds, image_hw=(128, 170), config=cfg)
    assert torch.equal(lat, again)
    c, u = pipe.conditioning(["a corgi", "a red cat"]), pipe.null_conditioning(2)
    want = ref.sample(state(m), sizes(m.config), seeds, (c.clip_text, c.clip_text_pooled, c.clip_img),
                      (u.clip_text, u.clip_text_pooled, u.clip_img), (3, 4), 2, 4.0)
    assert rel(lat, want) < 1e-4
    assert not c.clip_img.any() and c.clip_img.shape == (2, 1, m.config.c_clip_img)


def test_build_pipeline_takes_a_stage_c_config(tmp_path, monkeypatch):
    """serve.build_pipeline with a StageCConfig builds the prior from files:
    Stage C's state dict, an open_clip checkpoint (its text tower taken) and
    the merges."""
    from paella_tpu_torch.serve import build_pipeline

    letters = "abcdefghijklmnopqrstuvwxyz"
    write_merges_file([(a, b) for a in letters for b in letters][:100], str(tmp_path / "m.txt"))
    vocab = CLIPTokenizer(str(tmp_path / "m.txt")).vocab_size
    m = tiny_model(c_clip_text=24, c_clip_text_pooled=24)
    text = dataclasses.replace(TEXT, vocab_size=vocab)
    tower = CLIPTextEncoder(text)
    tower.reset_parameters(torch.Generator().manual_seed(9), std=0.1)
    torch.save(m.state_dict(), tmp_path / "prior.pt")
    torch.save({**tower.state_dict(), "logit_scale": torch.tensor(1.0), "visual.proj": torch.zeros(2, 2)},
               tmp_path / "clip.pt")
    monkeypatch.setattr(CLIPTextConfig, "vit_bigg_14", classmethod(lambda cls, dtype="bfloat16": text))
    pipe = build_pipeline(str(tmp_path / "prior.pt"), "", "", clip_path=str(tmp_path / "clip.pt"),
                          clip_bpe_path=str(tmp_path / "m.txt"), p_cfg=m.config, bf16=False, device="cpu")
    assert isinstance(pipe, CascadePriorPipeline) and pipe.text_encoder.graph_tag == "clip_g"
    assert torch.equal(next(iter(pipe.model.state_dict().values())), next(iter(m.state_dict().values())))
    lat = pipe.text_to_latents(["a corgi"], torch.tensor([[0, 3]]), image_hw=(128, 128),
                               config=PriorSampleConfig(steps=1))
    assert lat.shape == (1, 3, 3, m.config.c_in) and torch.isfinite(lat).all()


def test_reference_copy_is_the_benchmarks():
    assert filecmp.cmp(ROOT / "tests" / "stage_c_reference.py", ROOT / "bench_port" / "reference" / "stage_c.py",
                       shallow=False)


# -- on the card, at the published widths --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1's channelwise-skip mode and the graphs run only on a card")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.fixture(scope="module")
def published():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with torch.device("meta"):
        m = StageC(StageCConfig.published())
    m = m.to_empty(device="cuda")
    m.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    return m.eval()


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["float", "w8a8"])
def test_channelwise_resblock_kernel_matches_plain_at_c2048(cuda, mode):
    from paella_tpu_torch.kernels.resblock import prepare_resblock_weights
    from paella_tpu_torch.quant import quantize_dense_int8

    g = torch.Generator(device=cuda).manual_seed(1)
    c = 2048
    blk = ResBlock(c, c, skip_at="channelwise", dtype=torch.bfloat16).to(cuda)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=cuda) * (0.05 if p.dim() > 1 else 0.1))
    x, skip = (torch.randn(8, 24, 24, c, generator=g, device=cuda).bfloat16() for _ in range(2))
    film = (torch.randn(8, 2 * c, generator=g, device=cuda) * 0.1).bfloat16()
    w = blk.to(torch.bfloat16).kernel_weights()
    if mode == "w8a8":
        fc1, fc2, grn = blk.channelwise[0], blk.channelwise[4], blk.channelwise[2]
        (q1, s1), (q2, s2) = quantize_dense_int8(fc1.weight.float()), quantize_dense_int8(fc2.weight.float())
        w = prepare_resblock_weights(blk.depthwise.weight, blk.depthwise.bias, q1, fc1.bias, grn.gamma, grn.beta, q2,
                                     fc2.bias, torch.bfloat16, fc1_scale=s1, fc2_scale=s2, act_quant=True)
    got = fused_resblock(x, w, film=film, skip=skip)
    want = resblock_plain(x, w, film=film, skip=skip)
    assert torch.equal(got, fused_resblock(x, w, film=film, skip=skip))
    assert rel(got, want) < 2e-3
    first = fused_resblock(x[:2].contiguous(), w, film=film[:2].contiguous(), skip=skip[:2].contiguous())
    assert torch.equal(got[:2], first)  # batch invariance


@pytest.mark.cuda
def test_published_forward_matches_reference(cuda, published):
    m = published.to(torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(2)
    x, r = torch.randn(2, 24, 24, 16, generator=g, device=cuda), torch.rand(2, generator=g, device=cuda)
    cond = (torch.randn(2, 77, 1280, generator=g, device=cuda), torch.randn(2, 1, 1280, generator=g, device=cuda),
            torch.zeros(2, 1, 768, device=cuda))
    got = m(x.bfloat16(), r, *cond)
    sd = state(m)
    want = ref.stage_c(sd, sizes(m.config), x.bfloat16().float(), r, *cond)
    assert rel(got, want) < 0.05, rel(got, want)


@pytest.mark.cuda
def test_bigg_tower_replays_both_outputs(cuda):
    from paella_tpu_torch.sampling import graph
    from paella_tpu_torch.utils import tracing

    with torch.device("meta"):
        tower = CLIPTextEncoder(CLIPTextConfig.vit_bigg_14(), graph_tag="clip_g")
    tower = tower.to_empty(device=cuda)
    tower.reset_parameters(torch.Generator(device=cuda).manual_seed(3))
    tower = tower.cast_products().eval()
    ids = torch.randint(1, 49407, (2, 77), generator=torch.Generator(device=cuda).manual_seed(4), device=cuda)
    ids[:, 0] = 49406
    lengths = torch.tensor([[9], [40]], device=cuda)
    ids, mask = ref.pad_with_eot(torch.where(torch.arange(77, device=cuda)[None] < lengths, ids, 49407), 49407)
    before = tracing.snapshot()["counters"].get("tower_graph.hit.clip_g", 0)
    first = tower.hidden_states(ids, mask)
    second = tower.hidden_states(ids, mask)
    assert tracing.snapshot()["counters"].get("tower_graph.hit.clip_g", 0) == before + 1
    eager = tower._forward_hidden(ids, mask)
    for a, b in zip(second, eager):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    want_h, want_p = ref.clip_text(state(tower), {"heads": 20}, ids, mask)
    assert rel(second[0], want_h) < 0.03 and rel(second[1], want_p) < 0.03
    graph.clear()


@pytest.mark.cuda
def test_prior_graph_replay_equals_eager(cuda, published):
    from paella_tpu_torch.sampling import graph

    m = published.to(torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(5)
    cond = prior.PriorConditioning(torch.randn(2, 77, 1280, generator=g, device=cuda).bfloat16(),
                                   torch.randn(2, 1, 1280, generator=g, device=cuda).bfloat16(),
                                   torch.zeros(2, 1, 768, device=cuda).bfloat16())
    uncond = prior.PriorConditioning(*(t.flip(0) for t in cond.tensors().values()))
    seeds = torch.tensor([[0, 1], [0, 2]])
    cfg = PriorSampleConfig(steps=3)
    eager = prior.prior_body(m, prior.PriorStructure((2, 24, 24, 16), 3),
                             {"seeds": seeds.to(cuda), "t": prior.schedule(3).to(cuda),
                              "cfg": torch.tensor(4.0, device=cuda), **cond.pair(uncond).tensors()})
    first = prior.sample_prior(m, seeds, cond, (2, 24, 24, 16), uncond, cfg)
    replay = prior.sample_prior(m, seeds, cond, (2, 24, 24, 16), uncond, cfg)
    assert torch.equal(first, eager) and torch.equal(replay, eager)
    assert math.isfinite(float(replay.float().abs().max()))
    graph.clear()


@pytest.mark.cuda
def test_prior_replay_runs_every_attention_on_k5(cuda, published):
    """One replay of the 20-step prior graph adds 64 AttnBlocks x 20 steps =
    1,280 to `launches.fused_attention` (what GET /stats shows), none of
    them to `launches.fused_attention_streamed` (Stage C's keys stay
    resident), and K5's plain version never runs on the card."""
    from paella_tpu_torch.kernels.attention import attention_plain
    from paella_tpu_torch.sampling import graph
    from paella_tpu_torch.utils import tracing

    m = published.to(torch.bfloat16)
    g = torch.Generator(device=cuda).manual_seed(6)
    cond = prior.PriorConditioning(torch.randn(1, 77, 1280, generator=g, device=cuda).bfloat16(),
                                   torch.randn(1, 1, 1280, generator=g, device=cuda).bfloat16(),
                                   torch.zeros(1, 1, 768, device=cuda).bfloat16())
    uncond = prior.PriorConditioning(*(torch.zeros_like(t) for t in cond.tensors().values()))
    seeds, cfg = torch.tensor([[0, 7]]), PriorSampleConfig(steps=20)
    plain = attention_plain.launches
    prior.sample_prior(m, seeds, cond, (1, 24, 24, 16), uncond, cfg)  # captures
    counters = ("launches.fused_attention", "launches.fused_attention_streamed")
    before = [tracing.snapshot()["counters"].get(name, 0) for name in counters]
    prior.sample_prior(m, seeds, cond, (1, 24, 24, 16), uncond, cfg)  # one replay
    after = [tracing.snapshot()["counters"].get(name, 0) for name in counters]
    assert [a - b for a, b in zip(after, before)] == [64 * 20, 0]
    assert attention_plain.launches == plain
    graph.clear()


@pytest.mark.parametrize("self_attn", [True, False])
def test_stage_c_attention_goes_through_k5(self_attn):
    """Every AttnBlock of a forward calls K5's wrapper (kernels/attention.py::
    fused_attention: on the CPU its plain version, one call a block), with
    the pixel and conditioning keys as two sources where it attends to both;
    the forward still matches the reference."""
    from paella_tpu_torch.kernels.attention import attention_plain
    from paella_tpu_torch.nn.blocks import AttnBlock

    m = tiny_model(self_attn=self_attn)
    cfg = m.config
    g = torch.Generator().manual_seed(7)
    x, r = torch.randn(2, 4, 3, cfg.c_in, generator=g), torch.rand(2, generator=g)
    cond = conditioning(2, cfg)
    blocks = sum(isinstance(mod, AttnBlock) for mod in m.modules())
    assert blocks == 6  # blocks ((1, 2), (2, 1)): one AttnBlock a C-T-A triplet
    before = attention_plain.launches
    got = m(x, r, *cond)
    assert attention_plain.launches - before == blocks
    assert rel(got, ref.stage_c(state(m), sizes(cfg), x, r, *cond)) < 1e-5
