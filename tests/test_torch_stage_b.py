"""Stable Cascade's Stage B decoder and Stage A's decode in the port
(models/stage_b.py, sampling/decoder.py, CascadeDecoderPipeline,
CascadePipeline, serve.build_decoder_pipeline) against the plain reference
`tests/stage_b_reference.py` (float32 torch, importing nothing of the port),
on seeded random weights.

On the CPU at StageBConfig.tiny(), VQConfig.tiny() and a tiny text tower. On
a card (the `cuda` marker; the module imports neither jax nor the JAX
package), at the published widths:

    python -m pytest -q --noconftest -m cuda tests/test_torch_stage_b.py
"""
import dataclasses
import filecmp
import math
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

import stage_b_reference as ref
from paella_tpu_torch import (CascadeDecoderPipeline, CascadePipeline, DecoderSampleConfig, PriorSampleConfig,
                              StageBConfig, StageCConfig, VQConfig)
from paella_tpu_torch.codec import VQModel
from paella_tpu_torch.cond.clip import CLIPTextConfig, CLIPTextEncoder
from paella_tpu_torch.cond.tokenizers import CLIPTokenizer, write_merges_file
from paella_tpu_torch.models import StageB, StageC
from paella_tpu_torch.models import stage_b
from paella_tpu_torch.nn.blocks import AttnBlock, ResBlock, TimestepBlock
from paella_tpu_torch.nn.functional import layer_norm
from paella_tpu_torch.sampling import decoder

ROOT = Path(__file__).resolve().parents[1]
TEXT = CLIPTextConfig(vocab_size=700, width=24, heads=4, layers=2, context_length=77, embed_dim=24)


def sizes(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def state(module: torch.nn.Module, device=None) -> dict:
    return {k: v.detach().float().to(device or v.device) for k, v in module.state_dict().items()}


def tiny_model(seed: int = 0, **kw) -> StageB:
    m = StageB(dataclasses.replace(StageBConfig.tiny(), **kw))
    m.reset_parameters(torch.Generator().manual_seed(seed), std=0.1)
    return m.eval()


def tiny_codec(seed: int = 1) -> VQModel:
    vq = VQModel(VQConfig.tiny())
    vq.reset_parameters(torch.Generator().manual_seed(seed))
    with torch.no_grad():  # gates open, so every block of the decode counts
        for name, p in vq.named_parameters():
            if name.endswith("gammas"):
                p.copy_(torch.randn(6, generator=torch.Generator().manual_seed(len(name))) * 0.5)
    return vq.eval()


def inputs(b: int, cfg: StageBConfig, hw=(16, 24), effnet_hw=(3, 4), seed: int = 2) -> tuple:
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, *hw, cfg.c_in, generator=g), torch.rand(b, generator=g),
            torch.randn(b, 1, cfg.c_clip, generator=g), torch.randn(b, *effnet_hw, cfg.c_effnet, generator=g))


def rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach().float() - b.detach().float()).norm() / b.detach().float().norm())


def published_layout(cfg: StageBConfig) -> dict:
    """StableCascade `modules/stage_b.py::StageB`'s parameters (name ->
    shape), enumerated from its constructor as published."""
    out = {}

    def conv(name, c_in, c_out, k=1):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c_out, c_in, k, k), (c_out,)

    def linear(name, c_in, c_out):
        out[f"{name}.weight"], out[f"{name}.bias"] = (c_out, c_in), (c_out,)

    def block(name, bt, c, c_skip):
        if bt == "C":
            out[f"{name}.depthwise.weight"], out[f"{name}.depthwise.bias"] = (c, 1, 3, 3), (c,)
            linear(f"{name}.channelwise.0", c + c_skip, 4 * c)
            out[f"{name}.channelwise.2.gamma"] = out[f"{name}.channelwise.2.beta"] = (1, 1, 1, 4 * c)
            linear(f"{name}.channelwise.4", 4 * c, c)
        elif bt == "T":
            for m in ["mapper"] + [f"mapper_{t}" for t in cfg.t_conds]:
                linear(f"{name}.{m}", cfg.c_r, 2 * c)
        else:
            linear(f"{name}.kv_mapper.1", cfg.c_cond, c)
            out[f"{name}.attention.attn.in_proj_weight"], out[f"{name}.attention.attn.in_proj_bias"] = (3 * c, c), (3 * c,)
            linear(f"{name}.attention.attn.out_proj", c, c)

    ch, n, c0, p = cfg.c_hidden, len(cfg.c_hidden), cfg.c_hidden[0], cfg.patch_size
    for name, c_in in (("effnet_mapper", cfg.c_effnet), ("pixels_mapper", cfg.c_pixels)):
        conv(f"{name}.0", c_in, 4 * c0)
        conv(f"{name}.2", 4 * c0, c0)
    linear("clip_mapper", cfg.c_clip, cfg.c_cond * cfg.c_clip_seq)
    conv("embedding.1", cfg.c_in * p * p, c0)
    for i in range(n):
        if i > 0:
            conv(f"down_downscalers.{i}.1", ch[i - 1], ch[i], 2)
        k = 0
        for _ in range(cfg.blocks[0][i]):
            for bt in cfg.level_config[i]:
                block(f"down_blocks.{i}.{k}", bt, ch[i], 0)
                k += 1
        for r in range(cfg.block_repeat[0][i] - 1):
            conv(f"down_repeat_mappers.{i}.{r}", ch[i], ch[i])
    for iu, i in enumerate(reversed(range(n))):
        if i > 0:
            out[f"up_upscalers.{iu}.1.weight"], out[f"up_upscalers.{iu}.1.bias"] = (ch[i], ch[i - 1], 2, 2), (ch[i - 1],)
        k = 0
        for j in range(cfg.blocks[1][::-1][i]):
            for kk, bt in enumerate(cfg.level_config[i]):
                block(f"up_blocks.{iu}.{k}", bt, ch[i], ch[i] if i < n - 1 and j == kk == 0 else 0)
                k += 1
        for r in range(cfg.block_repeat[1][::-1][i] - 1):
            conv(f"up_repeat_mappers.{iu}.{r}", ch[i], ch[i])
    conv("clf.1", c0, cfg.c_out * p * p)
    return out


def test_stage_b_forward_matches_reference():
    m = tiny_model()
    x, r, clip, eff = inputs(3, m.config)
    got = m(x, r, clip, eff)
    want = ref.stage_b(state(m), sizes(m.config), x, r, clip, eff)
    assert got.shape == x.shape[:3] + (m.config.c_out,)
    assert rel(got, want) < 1e-5, rel(got, want)
    cache = m.gen_cond_cache(clip, eff, (8, 12))
    assert torch.equal(m(x, r, cond_cache=cache), got)


def test_stage_b_forward_in_bf16_stays_near_reference():
    m = tiny_model(dtype="bfloat16").to(torch.bfloat16)
    x, r, clip, eff = inputs(2, m.config, seed=3)
    got = m(x.bfloat16(), r, clip, eff)
    assert got.dtype == torch.bfloat16
    assert rel(got, ref.stage_b(state(m), sizes(m.config), x.bfloat16().float(), r, clip, eff)) < 0.05


@pytest.mark.parametrize("which", ["tiny", "published"])
def test_state_dict_is_stable_cascades_and_loads_strictly(which):
    cfg = StageBConfig.tiny() if which == "tiny" else StageBConfig.published()
    want = published_layout(cfg)
    with torch.device("meta"):
        m = StageB(cfg)
    got = {k: tuple(v.shape) for k, v in m.state_dict().items()}
    assert got == want
    with torch.device("meta"):
        sd = {k: torch.empty(s) for k, s in want.items()}
    m.load_state_dict(sd, strict=True, assign=True)
    if which == "published":
        assert sum(math.prod(s) for s in want.values()) == 1_562_941_136
        assert sum(isinstance(b, ResBlock) for b in m.modules()) == 2 + 6 + 28 + 6 + 6 + 28 + 6 + 2
        assert sum(isinstance(b, AttnBlock) for b in m.modules()) == 68


def test_repeats_take_the_skip_every_run_and_keep_each_blocks_film():
    """Each run of a repeated level calls its first ResBlock with the skip,
    and a repeated TimestepBlock reads the same FiLM rows every run."""
    m = tiny_model()
    cfg = m.config
    x, r, clip, eff = inputs(2, cfg, seed=4)
    calls = []

    def hook(blk, args):
        calls.append((blk, args[2] is not None, None if args[1] is None else args[1].data_ptr()))

    handles = [b.register_forward_pre_hook(hook) for b in m.modules() if isinstance(b, ResBlock)]
    films = []
    real = m._film
    m._film = lambda blk, f: films.append((blk, real(blk, f).data_ptr())) or real(blk, f)
    m(x, r, clip, eff)
    for h in handles:
        h.remove()
    n = len(cfg.c_hidden)
    for iu, i in enumerate(reversed(range(n))):
        first = m.up_blocks[iu][0]
        runs = [c for c in calls if c[0] is first]
        assert len(runs) == cfg.block_repeat[1][::-1][i]
        assert all(with_skip == (i < n - 1) for _, with_skip, _ in runs)
    by_block = {}
    for blk, ptr in films:
        by_block.setdefault(blk, set()).add(ptr)
    assert all(len(p) == 1 for p in by_block.values())  # one row a block, however often it runs
    assert len({next(iter(p)) for p in by_block.values()}) == len(by_block)
    assert len(films) > len(by_block)  # some blocks ran more than once
    assert len(m.films(r)) == sum(isinstance(b, TimestepBlock) for b in m.modules())


def test_stride_two_convs_follow_conv2d_and_conv_transpose2d():
    m = tiny_model()
    g = torch.Generator().manual_seed(5)
    x = torch.randn(2, 6, 8, 16, generator=g)
    down = m.down_downscalers[1]
    want = F.conv2d(layer_norm(x).permute(0, 3, 1, 2), down.conv.weight, down.conv.bias, stride=2)
    assert rel(down(x), want.permute(0, 2, 3, 1)) < 1e-6
    up = m.up_upscalers[1]  # level 1 -> 0
    y = torch.randn(2, 3, 4, 24, generator=g)
    want = F.conv_transpose2d(layer_norm(y).permute(0, 3, 1, 2), up.conv.weight, up.conv.bias, stride=2)
    assert up.conv.weight.shape == (24, 16, 2, 2)
    assert rel(up(y), want.permute(0, 2, 3, 1)) < 1e-6


def test_effnet_and_pixels_are_interpolated_with_align_corners():
    m = tiny_model()
    cfg = m.config
    _, _, clip, eff = inputs(2, cfg, seed=6)
    inject = m.gen_cond_cache(clip, eff, (8, 12))["inject"]
    sd = state(m)

    def term(align):
        e = F.interpolate(eff.permute(0, 3, 1, 2), size=(8, 12), mode="bilinear", align_corners=align)
        pix = ref._mapper(sd, "pixels_mapper", torch.zeros(2, cfg.c_pixels, 8, 8))
        return (ref._mapper(sd, "effnet_mapper", e)
                + F.interpolate(pix, size=(8, 12), mode="bilinear", align_corners=align)).permute(0, 2, 3, 1)

    assert inject.shape == (2, 8, 12, cfg.c_hidden[0]) and inject.dtype == torch.float32
    assert rel(inject, term(True)) < 1e-5
    assert rel(inject, term(False)) > 1e-2
    assert torch.equal(stage_b.resize(eff, (3, 4)), eff)  # the same size is the identity


def test_latents_must_halve_evenly():
    m = tiny_model()
    x, r, clip, eff = inputs(1, m.config, hw=(12, 16))
    with pytest.raises(ValueError, match="multiples of 8"):
        m(x, r, clip, eff)


def test_scheduler_tags_are_the_decoders():
    seeds = torch.tensor([[7, 2**31 + 5], [0, 1]])
    from paella_tpu_torch.sampling.prior import gaussian
    from paella_tpu_torch.sampling.sampler import derive_seeds

    for tag, step in ((decoder.INIT_TAG, 0), (decoder.STEP_TAG, 3)):
        z = gaussian(derive_seeds(seeds, tag, torch.tensor([step]))[0], (3, 4, 2))
        assert torch.equal(z, ref.noise(seeds, (3, 4, 2), tag, step))
    assert {decoder.INIT_TAG, decoder.STEP_TAG}.isdisjoint({3, 4})  # the prior's


def test_two_step_decoder_sample_matches_reference():
    m = tiny_model()
    cfg = m.config
    _, _, clip, eff = inputs(2, cfg, seed=7)
    seeds = torch.tensor([[1, 2], [3, 4]])
    got = decoder.sample_decoder(m, seeds, decoder.DecoderConditioning(clip, eff), (2, 16, 8, cfg.c_in),
                                 DecoderSampleConfig(steps=2))
    want = ref.sample(state(m), sizes(cfg), seeds, clip, eff, (16, 8), 2)
    assert got.shape == (2, 16, 8, cfg.c_in)
    assert rel(got, want) < 1e-4, rel(got, want)


def _tokenizer(tmp_path) -> CLIPTokenizer:
    letters = "abcdefghijklmnopqrstuvwxyz"
    write_merges_file([(a, b) for a in letters for b in letters][:150], str(tmp_path / "m.txt"))
    return CLIPTokenizer(str(tmp_path / "m.txt"))


def _tower(vocab: int, seed: int = 9) -> CLIPTextEncoder:
    t = CLIPTextEncoder(dataclasses.replace(TEXT, vocab_size=vocab), graph_tag="clip_g")
    t.reset_parameters(torch.Generator().manual_seed(seed), std=0.1)
    return t.eval()


def test_latents_to_images_and_text_to_image_on_the_cpu(tmp_path):
    tok = _tokenizer(tmp_path)
    tower = _tower(tok.vocab_size)
    m, vq = tiny_model(), tiny_codec()
    pipe = CascadeDecoderPipeline(m, vq, tower, tok.with_mask)
    prompts, seeds = ["a corgi", "a red cat"], torch.tensor([[0, 11], [0, 12]])
    eff = torch.randn(2, 2, 2, m.config.c_effnet, generator=torch.Generator().manual_seed(10))
    cfg = DecoderSampleConfig(steps=2)
    img = pipe.latents_to_images(prompts, eff, seeds, image_hw=(64, 32), config=cfg)
    assert img.shape == (2, 64, 32, 3) and img.dtype == torch.float32
    assert 0.0 <= float(img.min()) and float(img.max()) <= 1.0 and 0.0 < float(img.mean()) < 1.0
    assert len(pipe._text_cache) == 1
    pooled = pipe.conditioning(prompts)
    want_pooled = ref.clip_text(state(tower), {"heads": TEXT.heads}, *ref.pad_with_eot(
        torch.from_numpy(tok(prompts)).long(), tok.eot_token_id))[1]
    assert pooled.shape == (2, 1, 24) and rel(pooled[:, 0], want_pooled) < 1e-5
    x = ref.sample(state(m), sizes(m.config), seeds, pooled, eff, (16, 8), 2)
    want = ref.images(state(vq), sizes(vq.config), x)
    assert rel(img, want) < 1e-4, rel(img, want)

    prior = StageC(dataclasses.replace(StageCConfig.tiny(), c_in=m.config.c_effnet, c_out=m.config.c_effnet,
                                       c_clip_text=24, c_clip_text_pooled=24))
    prior.reset_parameters(torch.Generator().manual_seed(11))
    both = CascadePipeline.build(prior.eval(), m, vq, tower, tok.with_mask)
    assert both.prior.text_encoder is both.decoder.text_encoder
    out = both.text_to_image(prompts, seeds, image_hw=(64, 64), prior_config=PriorSampleConfig(steps=2),
                             decoder_config=cfg)
    lat = both.prior.text_to_latents(prompts, seeds, (64, 64), PriorSampleConfig(steps=2))
    assert lat.shape == (2, 2, 2, m.config.c_effnet)
    assert torch.equal(out, both.decoder.latents_to_images(prompts, lat, seeds, (64, 64), cfg))


def test_build_decoder_pipeline_from_files(tmp_path, monkeypatch):
    from paella_tpu_torch.serve import build_decoder_pipeline

    tok = _tokenizer(tmp_path)
    tower = _tower(tok.vocab_size)
    m, vq = tiny_model(), tiny_codec()
    torch.save(m.state_dict(), tmp_path / "stage_b.pt")
    torch.save(vq.state_dict(), tmp_path / "stage_a.pt")
    torch.save({**tower.state_dict(), "logit_scale": torch.tensor(1.0), "visual.proj": torch.zeros(2, 2)},
               tmp_path / "clip.pt")
    monkeypatch.setattr(CLIPTextConfig, "vit_bigg_14", classmethod(lambda cls, dtype="bfloat16": tower.config))
    pipe = build_decoder_pipeline(str(tmp_path / "stage_b.pt"), str(tmp_path / "stage_a.pt"), str(tmp_path / "clip.pt"),
                                  str(tmp_path / "m.txt"), cfg=m.config, vq_cfg=vq.config, bf16=False, device="cpu")
    assert isinstance(pipe, CascadeDecoderPipeline) and pipe.text_encoder.graph_tag == "clip_g"
    for a, b in ((pipe.model, m), (pipe.vq, vq)):
        assert all(torch.equal(x, y) for x, y in zip(a.state_dict().values(), b.state_dict().values()))
    eff = torch.randn(1, 2, 2, m.config.c_effnet, generator=torch.Generator().manual_seed(12))
    seeds, cfg = torch.tensor([[0, 3]]), DecoderSampleConfig(steps=1)
    img = pipe.latents_to_images(["a corgi"], eff, seeds, image_hw=(32, 32), config=cfg)
    want = CascadeDecoderPipeline(m, vq, tower, tok.with_mask).latents_to_images(["a corgi"], eff, seeds, (32, 32), cfg)
    assert img.shape == (1, 32, 32, 3) and torch.equal(img, want)


def test_reference_copy_is_the_benchmarks():
    assert filecmp.cmp(ROOT / "tests" / "stage_b_reference.py", ROOT / "bench_port" / "reference" / "stage_b.py",
                       shallow=False)


# -- on the card, at the published widths --------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: K1 at Stage B's widths, K5 and the graphs run only on a card")
    prev = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


@pytest.fixture(scope="module")
def published():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    with torch.device("meta"):
        m = StageB(StageBConfig.published())
    m = m.to_empty(device="cuda")
    m.reset_parameters(torch.Generator(device="cuda").manual_seed(0))
    return m.to(torch.bfloat16).eval()


def _card_inputs(b: int, device, seed: int) -> tuple:
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(b, 256, 256, 4, generator=g, device=device).bfloat16(),
            torch.rand(b, generator=g, device=device), torch.randn(b, 1, 1280, generator=g, device=device),
            torch.randn(b, 24, 24, 16, generator=g, device=device).bfloat16())


@pytest.mark.cuda
@pytest.mark.parametrize("c,hw,skip", [(320, 128, False), (320, 128, True), (640, 64, True), (1280, 32, True),
                                       (1280, 16, False)])
def test_k1_matches_plain_at_stage_b_shapes(cuda, c, hw, skip):
    from paella_tpu_torch.kernels.resblock import fused_resblock, resblock_plain

    g = torch.Generator(device=cuda).manual_seed(c + hw)
    blk = ResBlock(c, c if skip else 0, skip_at="channelwise", dtype=torch.bfloat16).to(cuda)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=g, device=cuda) * (0.05 if p.dim() > 1 else 0.1))
    w = blk.to(torch.bfloat16).kernel_weights()
    x, s = (torch.randn(4, hw, hw, c, generator=g, device=cuda).bfloat16() for _ in range(2))
    film = (torch.randn(4, 2 * c, generator=g, device=cuda) * 0.1).bfloat16()
    s = s if skip else None
    got = fused_resblock(x, w, film=film, skip=s)
    assert rel(got, resblock_plain(x, w, film=film, skip=s)) < 2e-3
    first = fused_resblock(x[:1].contiguous(), w, film=film[:1].contiguous(), skip=None if s is None else s[:1].contiguous())
    assert torch.equal(got[:1], first)  # batch invariance


@pytest.mark.cuda
def test_published_forward_matches_reference(cuda, published):
    m = published
    x, r, clip, eff = _card_inputs(1, cuda, 1)
    got = m(x, r, clip, eff)
    want = ref.stage_b(state(m), sizes(m.config), x.float(), r, clip, eff.float())
    assert got.shape == (1, 256, 256, 4) and torch.isfinite(got.float()).all()
    assert rel(got, want) < 0.05, rel(got, want)


@pytest.mark.cuda
def test_decoder_graph_replay_equals_eager(cuda, published):
    from paella_tpu_torch.sampling import graph

    m = published
    _, _, clip, eff = _card_inputs(2, cuda, 2)
    seeds, cfg = torch.tensor([[0, 1], [0, 2]]), DecoderSampleConfig(steps=2)
    eager = decoder.decoder_body(m, decoder.DecoderStructure((2, 256, 256, 4), 2),
                                 {"seeds": seeds.to(cuda), "t": ref.schedule(2).to(cuda), "clip": clip, "effnet": eff})
    cond = decoder.DecoderConditioning(clip, eff)
    first = decoder.sample_decoder(m, seeds, cond, (2, 256, 256, 4), cfg)
    replay = decoder.sample_decoder(m, seeds, cond, (2, 256, 256, 4), cfg)
    assert torch.equal(first, eager) and torch.equal(replay, eager)
    assert math.isfinite(float(replay.float().abs().max()))
    graph.clear()


@pytest.mark.cuda
def test_every_attention_goes_through_k5_and_the_designs_per_level(cuda, published):
    """One replay of a 2-step decoder graph adds (28 + 28 x 3 + 6 + 6 x 3)
    AttnBlocks x 2 steps to `launches.fused_attention`, of which level 2's
    (28 + 28 x 3) x 2 to `launches.fused_attention_streamed`, K5's plain
    version never runs on the card, and the policy gives level 2 (1024
    queries over 1028 keys) the wgmma variant's streamed form and level 3
    (256 over 260) its resident form."""
    from paella_tpu_torch.kernels.attention import attention_design, attention_plain
    from paella_tpu_torch.sampling import graph
    from paella_tpu_torch.utils import tracing

    m = published
    _, _, clip, eff = _card_inputs(1, cuda, 3)
    cond, seeds, cfg = decoder.DecoderConditioning(clip, eff), torch.tensor([[0, 7]]), DecoderSampleConfig(steps=2)
    plain = attention_plain.launches
    decoder.sample_decoder(m, seeds, cond, (1, 256, 256, 4), cfg)  # captures
    counters = ("launches.fused_attention", "launches.fused_attention_streamed")
    before = [tracing.snapshot()["counters"].get(name, 0) for name in counters]
    decoder.sample_decoder(m, seeds, cond, (1, 256, 256, 4), cfg)  # one replay
    after = [tracing.snapshot()["counters"].get(name, 0) for name in counters]
    assert [a - b for a, b in zip(after, before)] == [136 * 2, 112 * 2]
    assert attention_plain.launches == plain
    designs = {n: attention_design(4, n, n + 4, 20, 64, torch.bfloat16)[0] for n in (1024, 256)}
    print("K5 designs at batch 4:", designs)
    assert designs == {1024: "streamed", 256: "wgmma"}
    graph.clear()


@pytest.mark.cuda
def test_stage_a_decode_at_a_256_latent_matches_reference(cuda):
    with torch.device("meta"):
        vq = VQModel(VQConfig())
    vq = vq.to_empty(device=cuda)
    vq.reset_parameters(torch.Generator(device=cuda).manual_seed(4))
    with torch.no_grad():
        for name, p in vq.named_parameters():
            if name.endswith("gammas"):
                p.copy_(torch.randn(6, generator=torch.Generator(device=cuda).manual_seed(len(name)), device=cuda) * 0.5)
    vq.eval()
    x = torch.randn(1, 256, 256, 4, generator=torch.Generator(device=cuda).manual_seed(5), device=cuda)
    got = vq.decode(x)
    want = ref.stage_a_decode(state(vq), sizes(vq.config), x)
    assert got.shape == (1, 1024, 1024, 3)
    assert rel(got, want) < 1e-4, rel(got, want)
