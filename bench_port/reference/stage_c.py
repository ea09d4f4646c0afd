"""Stable Cascade's Stage C prior, its CLIP-bigG text conditioning and its
sampler, in plain float32 torch over state dicts: the reference the port
(`paella_tpu_torch`) is held to. It imports torch alone.

It follows the published description:
- Stage C: Würstchen v3 (arXiv:2306.00637), StableCascade
  `modules/stage_c.py::StageC` and `modules/common.py` (ResBlock with the skip
  joined after the LayerNorm into `Linear(c + c_skip, 4c)`, GlobalResponseNorm,
  TimestepBlock with the t_conds mappers, AttnBlock over [LN(x) | kv_mapper(clip)]
  with `nn.MultiheadAttention`), diffusers' `StableCascadeUNet`. NCHW inside.
- The text conditioning: HF `CLIPTextModelWithProjection` as diffusers'
  `StableCascadePriorPipeline.encode_prompt` calls it: causal self-attention
  with the tokenizer's padding mask on keys, quick pre-LayerNorm blocks with
  exact GELU; `hidden_states[-1]` (the last block's output, before
  final_layer_norm) and `text_embeds` (final_layer_norm at the first EOT
  position, then text_projection).
- The sampler: diffusers' `DDPMWuerstchenScheduler.step` (s 0.008, scaler
  1) over t = linspace(1, 0, steps + 1), the CFG mix `torch.lerp(uncond,
  text, cfg)` from one batch of both sides.

Departures, each on purpose:
- Latents cross the interface channels-last, (B, H, W, C), as the port keeps
  them; the model runs NCHW inside.
- Noise: x_init and each step's z are drawn from the image's (2,) seed pair by
  a counter hash (murmur3's finalizer) and Box-Muller, a frozen copy of the
  port's draw (`kernels/sampling.py::hash_bits`, `uniform_from_bits`,
  `sampling/sampler.py::derive_seeds`, `sampling/prior.py::gaussian`), so
  that both draw the same numbers; diffusers draws torch's Philox stream.
- Everything is float32 (set TF32 off on a card); diffusers runs the prior
  and its scheduler step in the model's dtype.
- Inference only: no dropout; sca and crp are 0; switch_level False and
  block_repeat 1 (the published prior's) are the only layout taken.

`cfg` is a dict of StageCConfig's fields (c_in, c_r, c_cond, c_hidden,
nhead, blocks, level_config, c_clip_seq, t_conds, ...); `tcfg` of
CLIPTextConfig's (heads, layer_norm_eps).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

M32 = 0xFFFFFFFF
S = 0.008
INIT_ALPHA = math.cos(S / (1 + S) * math.pi * 0.5) ** 2
INIT_TAG, STEP_TAG = 3, 4


# -- Stage C --------------------------------------------------------------


def _ln2d(x: torch.Tensor) -> torch.Tensor:
    """LayerNorm2d, no affine, eps 1e-6, over channels of NCHW."""
    return F.layer_norm(x.permute(0, 2, 3, 1), x.shape[1:2], eps=1e-6).permute(0, 3, 1, 2)


def _conv1x1(x: torch.Tensor, sd: dict, name: str) -> torch.Tensor:
    return F.conv2d(x, sd[f"{name}.weight"], sd[f"{name}.bias"])


def _lin(x: torch.Tensor, sd: dict, name: str) -> torch.Tensor:
    return F.linear(x, sd[f"{name}.weight"], sd[f"{name}.bias"])


def res_block(sd: dict, p: str, x: torch.Tensor, skip=None) -> torch.Tensor:
    """modules/common.py::ResBlock: x + channelwise([LN(dw(x)) | skip])."""
    w = sd[f"{p}.depthwise.weight"]
    h = _ln2d(F.conv2d(x, w, sd[f"{p}.depthwise.bias"], padding=1, groups=w.shape[0]))
    if skip is not None:
        h = torch.cat([h, skip], dim=1)
    h = F.gelu(_lin(h.permute(0, 2, 3, 1), sd, f"{p}.channelwise.0"))
    gx = torch.norm(h, p=2, dim=(1, 2), keepdim=True)
    nx = gx / (gx.mean(dim=-1, keepdim=True) + 1e-6)
    h = sd[f"{p}.channelwise.2.gamma"] * (h * nx) + sd[f"{p}.channelwise.2.beta"] + h
    h = _lin(h, sd, f"{p}.channelwise.4")
    return h.permute(0, 3, 1, 2) + x


def timestep_block(sd: dict, p: str, x: torch.Tensor, r_embed: torch.Tensor, conds) -> torch.Tensor:
    """modules/common.py::TimestepBlock: a = sum a_i, b = sum b_i."""
    t = r_embed.chunk(len(conds) + 1, dim=1)
    a, b = _lin(t[0], sd, f"{p}.mapper")[:, :, None, None].chunk(2, dim=1)
    for i, c in enumerate(conds):
        ac, bc = _lin(t[i + 1], sd, f"{p}.mapper_{c}")[:, :, None, None].chunk(2, dim=1)
        a, b = a + ac, b + bc
    return x * (1 + a) + b


def mha(sd: dict, p: str, q: torch.Tensor, kv: torch.Tensor, nhead: int) -> torch.Tensor:
    """nn.MultiheadAttention(batch_first=True, bias=True), need_weights=False."""
    c = q.shape[-1]
    w, b = sd[f"{p}.in_proj_weight"], sd[f"{p}.in_proj_bias"]
    qh = F.linear(q, w[:c], b[:c])
    kh = F.linear(kv, w[c:2 * c], b[c:2 * c])
    vh = F.linear(kv, w[2 * c:], b[2 * c:])
    bq, n, _ = qh.shape
    s, d = kh.shape[1], c // nhead
    qh, kh, vh = (t.reshape(bq, -1, nhead, d).transpose(1, 2) for t in (qh, kh, vh))
    probs = torch.softmax(qh @ kh.transpose(-1, -2) / math.sqrt(d), dim=-1)
    out = (probs @ vh).transpose(1, 2).reshape(bq, n, c)
    return _lin(out, sd, f"{p}.out_proj")


def attn_block(sd: dict, p: str, x: torch.Tensor, clip: torch.Tensor, nhead: int, self_attn: bool) -> torch.Tensor:
    """modules/common.py::AttnBlock with Attention2D."""
    kv = _lin(F.silu(clip), sd, f"{p}.kv_mapper.1")
    b, c, h, w = x.shape
    tokens = _ln2d(x).reshape(b, c, h * w).permute(0, 2, 1)
    if self_attn:
        kv = torch.cat([tokens, kv], dim=1)
    out = mha(sd, f"{p}.attention.attn", tokens, kv, nhead)
    return x + out.permute(0, 2, 1).reshape(b, c, h, w)


def r_embedding(r: torch.Tensor, c_r: int, max_positions: int = 10000) -> torch.Tensor:
    """StageC.gen_r_embedding."""
    r = r * max_positions
    half = c_r // 2
    emb = math.log(max_positions) / (half - 1)
    emb = torch.arange(half, device=r.device).float().mul(-emb).exp()
    emb = r[:, None] * emb[None, :]
    emb = torch.cat([emb.sin(), emb.cos()], dim=1)
    return F.pad(emb, (0, 1)) if c_r % 2 == 1 else emb


def c_embeddings(sd: dict, cfg: dict, clip_text, clip_text_pooled, clip_img) -> torch.Tensor:
    """StageC.gen_c_embeddings: (B, S + 2 c_clip_seq, c_cond), clip_norm'd."""
    b, seq = clip_text_pooled.shape[0], cfg["c_clip_seq"]
    txt = _lin(clip_text, sd, "clip_txt_mapper")
    pooled = _lin(clip_text_pooled, sd, "clip_txt_pooled_mapper").view(b, clip_text_pooled.shape[1] * seq, -1)
    img = _lin(clip_img, sd, "clip_img_mapper").view(b, clip_img.shape[1] * seq, -1)
    clip = torch.cat([txt, pooled, img], dim=1)
    return F.layer_norm(clip, clip.shape[-1:], eps=1e-6)


def _level_blocks(cfg: dict, i: int, count: int) -> list:
    return [bt for _ in range(count) for bt in cfg["level_config"][i]]


def stage_c(sd: dict, cfg: dict, x: torch.Tensor, r: torch.Tensor, clip_text, clip_text_pooled,
            clip_img) -> torch.Tensor:
    """StageC.forward: latents (B, H, W, c_in), r (B,) -> eps (B, H, W, c_out)."""
    n = len(cfg["c_hidden"])
    conds = list(cfg["t_conds"])
    r_embed = torch.cat([r_embedding(r, cfg["c_r"])] + [r_embedding(torch.zeros_like(r), cfg["c_r"]) for _ in conds],
                        dim=1)
    clip = c_embeddings(sd, cfg, clip_text, clip_text_pooled, clip_img)
    p = cfg.get("patch_size", 1)
    h = _ln2d(_conv1x1(F.pixel_unshuffle(x.permute(0, 3, 1, 2), p), sd, "embedding.1"))

    def run(prefix, kinds, i, h, skip):
        for j, bt in enumerate(kinds):
            name = f"{prefix}.{j}"
            if bt == "C":
                h = res_block(sd, name, h, skip if j == 0 else None)
            elif bt == "T":
                h = timestep_block(sd, name, h, r_embed, conds)
            else:
                h = attn_block(sd, name, h, clip, cfg["nhead"][i], cfg.get("self_attn", True))
        return h

    levels = []
    for i in range(n):
        if i > 0:
            h = _conv1x1(_ln2d(h), sd, f"down_downscalers.{i}.1.blocks.0")
        h = run(f"down_blocks.{i}", _level_blocks(cfg, i, cfg["blocks"][0][i]), i, h, None)
        levels.insert(0, h)
    h = levels[0]
    for iu, i in enumerate(reversed(range(n))):
        skip = levels[iu] if iu > 0 else None
        h = run(f"up_blocks.{iu}", _level_blocks(cfg, i, cfg["blocks"][1][::-1][i]), i, h, skip)
        if i > 0:
            h = _conv1x1(_ln2d(h), sd, f"up_upscalers.{iu}.1.blocks.1")
    h = F.pixel_shuffle(_conv1x1(_ln2d(h), sd, "clf.1"), p)
    return h.permute(0, 2, 3, 1)


# -- the CLIP-bigG text conditioning --------------------------------------


def clip_text(sd: dict, tcfg: dict, ids: torch.Tensor, mask: torch.Tensor) -> tuple:
    """(hidden_states[-1] (B, S, W), text_embeds (B, E)) over open_clip's
    parameter names, under the causal mask and the padding mask on keys."""
    ids = ids.long()
    b, s = ids.shape
    x = sd["token_embedding.weight"][ids] + sd["positional_embedding"][:s]
    heads, eps = tcfg["heads"], tcfg.get("layer_norm_eps", 1e-5)
    keep = torch.ones(s, s, dtype=torch.bool, device=ids.device).tril()[None, None] & mask.bool()[:, None, None, :]
    bias = torch.zeros(keep.shape, device=ids.device).masked_fill(~keep, float("-inf"))

    def ln(v, name):
        return F.layer_norm(v, v.shape[-1:], sd[f"{name}.weight"], sd[f"{name}.bias"], eps)

    i = 0
    while f"transformer.resblocks.{i}.ln_1.weight" in sd:
        p = f"transformer.resblocks.{i}"
        h = ln(x, f"{p}.ln_1")
        w, bb = sd[f"{p}.attn.in_proj_weight"], sd[f"{p}.attn.in_proj_bias"]
        q, k, v = F.linear(h, w, bb).chunk(3, dim=-1)
        d = q.shape[-1] // heads
        q, k, v = (t.reshape(b, s, heads, d).transpose(1, 2) for t in (q, k, v))
        probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(d) + bias, dim=-1)
        x = x + _lin((probs @ v).transpose(1, 2).reshape(b, s, -1), sd, f"{p}.attn.out_proj")
        h = F.gelu(_lin(ln(x, f"{p}.ln_2"), sd, f"{p}.mlp.c_fc"))
        x = x + _lin(h, sd, f"{p}.mlp.c_proj")
        i += 1
    eot = (ids == ids.max(dim=-1, keepdim=True).values).int().argmax(dim=-1)
    pooled = ln(x, "ln_final")[torch.arange(b, device=ids.device), eot] @ sd["text_projection"]
    return x, pooled


def pad_with_eot(ids: torch.Tensor, eot: int) -> tuple:
    """(ids, mask) as HF's CLIP-bigG tokenizer gives them: open_clip's
    zero-padded ids with the padding set to the EOT id, the mask True
    through the first EOT."""
    first = (ids == eot).int().argmax(dim=1)
    mask = torch.arange(ids.shape[1], device=ids.device)[None, :] <= first[:, None]
    return torch.where(mask, ids, torch.full_like(ids, eot)), mask


# -- the sampler ----------------------------------------------------------


def alpha_cumprod(t: torch.Tensor) -> torch.Tensor:
    """DDPMWuerstchenScheduler._alpha_cumprod at scaler 1, in float32 with s
    and the normalizer cos(s / (1 + s) pi / 2)^2 as Python scalars (no host
    tensor, so a CUDA graph can capture it)."""
    return (torch.cos((t.float() + S) / (1 + S) * (math.pi * 0.5)) ** 2 / INIT_ALPHA).clamp(0.0001, 0.9999)


def ddpm_step(x, eps, t, t_prev, z) -> torch.Tensor:
    """DDPMWuerstchenScheduler.step, float32."""
    ac, ap = alpha_cumprod(t), alpha_cumprod(t_prev)
    alpha = ac / ap
    mu = (1.0 / alpha).sqrt() * (x.float() - (1 - alpha) * eps.float() / (1 - ac).sqrt())
    std = ((1 - alpha) * (1.0 - ap) / (1.0 - ac)).sqrt()
    return mu + std * z * (t_prev != 0).float()


def cfg_mix(eps_text: torch.Tensor, eps_uncond: torch.Tensor, cfg: float) -> torch.Tensor:
    return torch.lerp(eps_uncond.float(), eps_text.float(), cfg)


def schedule(steps: int) -> torch.Tensor:
    """linspace(1, 0, steps + 1): 1 + i * (-1 / steps) in float64, the last
    point 0, correctly rounded to float32."""
    t = 1.0 + torch.arange(steps + 1, dtype=torch.float64) * (-1.0 / steps)
    t[-1] = 0.0
    return t.float()


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    return ((h * (c & 0xFFFF)) + (((h * (c >> 16)) & 0xFFFF) << 16)) & M32


def _mix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def derive_seeds(seeds: torch.Tensor, tag: int, step: int) -> torch.Tensor:
    """(B, 2) seed pairs of draw `tag` at step `step`."""
    s = seeds.to(torch.int64) & M32
    salt = _mix32(torch.tensor((step * 0x9E3779B9 + ((tag * 0x85EBCA6B) & M32) + 1) & M32, device=seeds.device))
    return torch.stack([_mix32(s[:, 0] ^ salt), _mix32((s[:, 1] + salt) & M32)], dim=-1)


def gaussian(seeds: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) N(0, 1): element i from the uniforms of counters i and n + i."""
    s = seeds.to(torch.int64) & M32
    idx = torch.arange(2 * n, dtype=torch.int64, device=seeds.device)[None, :]
    bits = _mix32((_mix32(idx ^ s[:, :1]) + s[:, 1:]) & M32)
    u = (bits >> 8).to(torch.float32) * (2.0**-24) + (2.0**-25)
    return torch.sqrt(-2.0 * torch.log(u[:, :n])) * torch.cos((2.0 * math.pi) * u[:, n:])


def noise(seeds: torch.Tensor, shape: tuple, tag: int, step: int) -> torch.Tensor:
    """x_init (tag INIT_TAG, step 0) or step `step`'s z (tag STEP_TAG), (B, *shape)."""
    return gaussian(derive_seeds(seeds, tag, step), math.prod(shape)).reshape(seeds.shape[0], *shape)


def sample(sd: dict, cfg: dict, seeds: torch.Tensor, cond: tuple, uncond: tuple, latent_hw: tuple, steps: int,
           guidance: float, round_to=None) -> torch.Tensor:
    """The text-to-latents loop: cond / uncond are (clip_text, pooled (B, 1,
    E), clip_img (B, 1, I)); `round_to` a dtype x is rounded to after each
    step (the port's model dtype), or None."""
    b = seeds.shape[0]
    shape = (*latent_hw, cfg["c_in"])
    t = schedule(steps).to(seeds.device)
    x = noise(seeds, shape, INIT_TAG, 0)
    if round_to is not None:
        x = x.to(round_to).float()
    both = [torch.cat([c, u]) for c, u in zip(cond, uncond)]
    for i in range(steps):
        r = t[i].expand(2 * b)
        e = stage_c(sd, cfg, torch.cat([x, x]), r, *both)
        x = ddpm_step(x, cfg_mix(e[:b], e[b:], guidance), t[i], t[i + 1], noise(seeds, shape, STEP_TAG, i))
        if round_to is not None:
            x = x.to(round_to).float()
    return x
