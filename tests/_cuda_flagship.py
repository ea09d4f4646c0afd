"""The flagship on an NVIDIA GPU: its denoiser and codec with seeded weights,
its CFG conditioning, its 8-step generation and the kernel wrappers' launch
counts around a call. tests/test_torch_cuda_paths.py checks the paths with
them, and chip_smoke.py counts the launches its kernel table reports. Imports
neither jax nor the JAX package."""
import dataclasses

import torch

STEPS = 8
LATENT = (1, 64, 64)
BYT5_LEN = 64
ATTN_FLAGS = dict(attention_impl="pallas", attn_block_kernel=True)
# launches per flagship CFG forward: K1 at each of the 56 ResBlocks; in the
# attention config K5 at repetition 0 of levels 1 and 2 each way, K6 at the
# other 15 + 5 repetitions each way
K1_PER_FORWARD, K5_PER_FORWARD, K6_PER_FORWARD = 56, 4, 40
GRAPH_PASSES = 2  # wrapper calls a generation makes when its graph is captured: the warm-up and the capture


def counted(fn, keep_graphs: bool = False):
    """fn() with every launch count set to 0 just before, and the counts read
    just after (synchronized); fused_resblock's also per mode, as
    `fused_resblock[float]` (K1), `fused_resblock[int8]` and
    `fused_resblock[w8a8]` (K1b). The kept CUDA graphs (the sampler's, the
    towers' and the training step's) are dropped first unless keep_graphs,
    so a generation or a training step inside fn captures its graph: its
    warm-up and its capture each go through every wrapper once
    (GRAPH_PASSES), a replay through none. No plain version may run on the
    card."""
    from paella_tpu_torch import kernels
    from paella_tpu_torch.sampling import graph

    if not keep_graphs:
        graph.clear()
    for f in kernels.WRAPPERS:
        f.launches = 0
    by_mode = kernels.fused_resblock.launches_by_mode
    by_mode.update(dict.fromkeys(by_mode, 0))
    out = fn()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    launches.update({f"fused_resblock[{m}]": n for m, n in by_mode.items()})
    ran = {k: n for k, n in launches.items() if k.endswith("_plain") and n}
    assert not ran, f"plain versions ran on the card: {ran}"
    return out, launches


def check_launches(what: str, launches: dict, expect: dict) -> None:
    got = {k: launches[k] for k in expect}
    assert got == expect, f"{what}: launches {got}, want {expect}"


def perturb_(module, gen, scale: float = 0.02) -> None:
    """Add scale * N(0, 1) to every parameter: the zero-initialized clf and
    FiLM mappers (and codec gammas) would otherwise make outputs trivial."""
    with torch.no_grad():
        for p in module.parameters():
            p.add_(torch.randn(p.shape, generator=gen, device=p.device, dtype=p.dtype) * scale)
    if hasattr(module, "drop_derived"):
        module.drop_derived()


def build_flagship(gen, **flags):
    """The flagship denoiser (v1_byt5_xl_inference with `flags`) and the
    VQConfig() codec, seeded and perturbed on the card. Inference weights in
    bf16, as the JAX package's bench.py runs them; the encoder's BatchNorm
    and the codebook stay f32, as the JAX codec keeps its statistics and its
    lookup in f32."""
    from paella_tpu_torch.codec import VQModel
    from paella_tpu_torch.config import PaellaConfig, VQConfig
    from paella_tpu_torch.models import Paella

    p_cfg = dataclasses.replace(PaellaConfig.v1_byt5_xl_inference(), **flags)
    with torch.device("cuda"):
        model = Paella(p_cfg)
        vq = VQModel(dataclasses.replace(VQConfig(), dtype="bfloat16"))
    model.reset_parameters(gen)
    perturb_(model, gen)
    vq.reset_parameters(gen)
    perturb_(vq, gen)
    vq = vq.to(torch.bfloat16)
    vq.down_blocks[-1][1].float()
    vq.vquantizer.float()
    return model.to(torch.bfloat16).eval(), vq.eval(), p_cfg


def flagship_conditioning(p_cfg, gen, b: int = 1):
    """CFG conditioning of b images at the flagship's widths: ByT5 64 tokens,
    CLIP text and image; the unconditional side 2 ByT5 tokens, no CLIP image."""
    from paella_tpu_torch.sampling import Conditioning

    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)  # noqa: E731
    cond = Conditioning(byt5=r(b, BYT5_LEN, p_cfg.byt5_embd), clip=r(b, p_cfg.clip_embd), clip_image=r(b, p_cfg.clip_embd))
    uncond = Conditioning(byt5=r(b, 2, p_cfg.byt5_embd), clip=r(b, p_cfg.clip_embd), clip_image=None)
    return cond, uncond


def generation_launches(draw: str, attention: bool, mode: str = "float") -> dict:
    """The wrapper calls of one STEPS-step CFG generation at the flagship
    whose graph is captured (its warm-up and its capture: GRAPH_PASSES x a
    replay's), drawing through K2 ("pallas") or the head product and K3
    ("xla"), in the attention config (K5, K6) or not, with ResBlocks of
    `mode` ("float": K1; "int8" or "w8a8": K1b)."""
    per_gen = GRAPH_PASSES * STEPS
    k5, k6 = (K5_PER_FORWARD, K6_PER_FORWARD) if attention else (0, 0)
    return {"fused_resblock": per_gen * K1_PER_FORWARD,
            **{f"fused_resblock[{m}]": per_gen * K1_PER_FORWARD * (m == mode) for m in ("float", "int8", "w8a8")},
            "fused_head_categorical": per_gen * (draw == "pallas"), "gumbel_categorical": per_gen * (draw == "xla"),
            "fused_attention": per_gen * k5, "fused_attn_block": per_gen * k6, "fused_codebook_lookup": 0}


def flagship_generation(model, cond, uncond, seeds, draw: str, attention: bool = False, mode: str = "float"):
    """One STEPS-step CFG generation of LATENT at the flagship from `seeds`
    (1, 2), counted: its tokens and launches, the launches held to
    generation_launches."""
    from paella_tpu_torch.config import SampleConfig
    from paella_tpu_torch.sampling import sample

    s_cfg = SampleConfig(steps=STEPS, categorical_impl=draw)
    tokens, launches = counted(lambda: sample(model, seeds, cond, LATENT, uncond, s_cfg))
    check_launches(f"{STEPS}-step generation ({draw} draw{', attention config' if attention else ''}, {mode})", launches,
                   generation_launches(draw, attention, mode))
    return tokens, launches
