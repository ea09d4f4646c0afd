"""The CLIP text and vision towers (ViT-H-14 by default), the counterparts of
`paella_tpu/cond/clip.py`: the frozen image/text-embedding encoders.

The reference loads open_clip ViT-H-14 (laion2b_s32b_b79k) and calls
encode_text / encode_image (reference: src_distributed/utils.py:73-75,
src_distributed/train.py:91-97). Parameters here keep open_clip's state-dict
keys (`token_embedding.weight`, `positional_embedding`,
`transformer.resblocks.{i}.attn.in_proj_weight`, `ln_1`, `mlp.c_fc`,
`mlp.c_proj`, `ln_final`, `text_projection`; the vision tower's are the
checkpoint's `visual.*` keys without the prefix), so an open_clip
checkpoint loads with `strict=True` after :func:`split_open_clip`, and the HF
converters are key renames into that layout.

Held to the JAX towers' rounding points: LayerNorm in float32, cast back
(eps 1e-5); q, k and v from the packed in_proj; scores in float32 scaled by
d^-0.5 with -1e9 at masked keys; the softmax cast to v's dtype; exact-erf
GELU; the text tower adds the float32 position embedding before the cast to
the compute dtype; the projection runs in the features' dtype. Attention is
plain torch (the JAX towers run it in XLA, not in a Pallas kernel).

encode_text returns the UN-normalized projected feature at the EOT token and
encode_image the un-normalized projected class-token feature, matching what
the reference feeds the denoiser (it never L2-normalizes).
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..nn.functional import resize

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    """Field for field the JAX package's CLIPTextConfig."""

    vocab_size: int = 49408
    width: int = 1024  # ViT-H text tower
    heads: int = 16
    layers: int = 24
    context_length: int = 77
    embed_dim: int = 1024  # projected output dim (clip_embd in the denoiser)
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def vit_h_14(cls, dtype: str = "bfloat16") -> "CLIPTextConfig":
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls) -> "CLIPTextConfig":
        return cls(vocab_size=64, width=32, heads=4, layers=2, context_length=16, embed_dim=24)


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    """Field for field the JAX package's CLIPVisionConfig."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1280  # ViT-H vision tower
    heads: int = 16
    layers: int = 32
    embed_dim: int = 1024
    layer_norm_eps: float = 1e-5
    dtype: str = "float32"

    @property
    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    @classmethod
    def vit_h_14(cls, dtype: str = "bfloat16") -> "CLIPVisionConfig":
        return cls(dtype=dtype)

    @classmethod
    def tiny(cls) -> "CLIPVisionConfig":
        return cls(image_size=32, patch_size=8, width=32, heads=4, layers=2, embed_dim=24)


class _LayerNorm(nn.LayerNorm):
    """open_clip's LayerNorm (weight, bias): statistics in float32, the
    result cast back to x's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight.float(), self.bias.float(), self.eps).to(x.dtype)


class _Attention(nn.Module):
    """nn.MultiheadAttention's parameters (packed in_proj, out_proj) with
    the JAX tower's arithmetic."""

    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * width, width))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * width))
        self.out_proj = nn.Linear(width, width)

    def forward(self, x: torch.Tensor, causal: bool, mask: Optional[torch.Tensor]) -> torch.Tensor:
        b, s, width = x.shape
        d = width // self.heads
        qkv = F.linear(x, self.in_proj_weight.to(x.dtype), self.in_proj_bias.to(x.dtype))
        q, k, v = (t.reshape(b, s, self.heads, d) for t in qkv.chunk(3, dim=-1))
        scores = torch.einsum("bnhd,bshd->bhns", q.float(), k.float()) * d**-0.5
        if causal:
            keep = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
            scores = scores.masked_fill(~keep, -1e9)
        if mask is not None:
            scores = scores.masked_fill(~mask[:, None, None, :], -1e9)
        probs = torch.softmax(scores, dim=-1).to(v.dtype)
        out = torch.einsum("bhns,bshd->bnhd", probs, v).reshape(b, s, width)
        return F.linear(out, self.out_proj.weight.to(x.dtype), self.out_proj.bias.to(x.dtype))


class _MLP(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.c_fc = nn.Linear(width, 4 * width)
        self.c_proj = nn.Linear(4 * width, width)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = x.dtype
        h = F.gelu(F.linear(x, self.c_fc.weight.to(dt), self.c_fc.bias.to(dt)))  # exact erf, as ViT-H-14 laion2b
        return F.linear(h, self.c_proj.weight.to(dt), self.c_proj.bias.to(dt))


class _ResidualBlock(nn.Module):
    def __init__(self, width: int, heads: int, eps: float):
        super().__init__()
        self.ln_1 = _LayerNorm(width, eps=eps)
        self.attn = _Attention(width, heads)
        self.ln_2 = _LayerNorm(width, eps=eps)
        self.mlp = _MLP(width)

    def forward(self, x: torch.Tensor, causal: bool, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), causal, mask)
        return x + self.mlp(self.ln_2(x))


class _Transformer(nn.Module):
    def __init__(self, width: int, heads: int, layers: int, eps: float):
        super().__init__()
        self.resblocks = nn.ModuleList([_ResidualBlock(width, heads, eps) for _ in range(layers)])

    def forward(self, x: torch.Tensor, causal: bool) -> torch.Tensor:
        for blk in self.resblocks:
            x = blk(x, causal)
        return x


class _Tower(nn.Module):
    @torch.no_grad()
    def cast_products(self) -> "_Tower":
        """Hold the product weights in the compute dtype, once: the values
        the JAX tower's per-product casts give. Norms and embeddings stay in
        the dtype they were loaded in, as JAX keeps its float32 parameters."""
        dt = self.config.compute_dtype
        for m in self.modules():
            if isinstance(m, (_Attention, nn.Linear, nn.Conv2d)):
                for p in m.parameters(recurse=False):
                    p.data = p.data.to(dt)
        for name in ("text_projection", "proj"):  # the projection, a bare parameter
            if hasattr(self, name):
                getattr(self, name).data = getattr(self, name).data.to(dt)
        return self

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, std: float = 0.02) -> None:
        """Seeded N(0, std) weights, zero biases and unit LayerNorms, for a
        tower with no checkpoint at hand (not open_clip's init)."""
        for name, p in self.named_parameters():
            if name.endswith("bias"):
                p.zero_()
            elif ".ln_" in f".{name}" and name.endswith("weight"):
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=gen.device, dtype=torch.float32).to(p.device, p.dtype) * std)


class CLIPTextEncoder(_Tower):
    """encode_text: a causal transformer over BPE tokens (B, S) -> (B,
    embed_dim), the projected hidden state at the EOT position (the highest
    token id of a sequence, its first occurrence, as open_clip takes it)."""

    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.config = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.width)
        self.positional_embedding = nn.Parameter(torch.zeros(cfg.context_length, cfg.width))
        self.transformer = _Transformer(cfg.width, cfg.heads, cfg.layers, cfg.layer_norm_eps)
        self.ln_final = _LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.text_projection = nn.Parameter(torch.zeros(cfg.width, cfg.embed_dim))

    @torch.no_grad()
    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        ids = input_ids.long()
        s = ids.shape[1]
        x = (self.token_embedding.weight[ids] + self.positional_embedding[:s].float()).to(self.config.compute_dtype)
        x = self.ln_final(self.transformer(x, causal=True))
        feats = x[torch.arange(x.shape[0], device=x.device), ids.argmax(dim=-1)]
        return feats @ self.text_projection.to(feats.dtype)


class CLIPVisionEncoder(_Tower):
    """encode_image: a ViT over (B, H, W, 3) preprocessed images (see
    :func:`clip_preprocess`) -> (B, embed_dim), the projected class token
    after ln_post."""

    def __init__(self, cfg: CLIPVisionConfig):
        super().__init__()
        self.config = cfg
        p = cfg.patch_size
        self.conv1 = nn.Conv2d(3, cfg.width, p, stride=p, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(cfg.width))
        self.positional_embedding = nn.Parameter(torch.zeros((cfg.image_size // p) ** 2 + 1, cfg.width))
        self.ln_pre = _LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.transformer = _Transformer(cfg.width, cfg.heads, cfg.layers, cfg.layer_norm_eps)
        self.ln_post = _LayerNorm(cfg.width, eps=cfg.layer_norm_eps)
        self.proj = nn.Parameter(torch.zeros(cfg.width, cfg.embed_dim))

    @torch.no_grad()
    def forward(self, images: torch.Tensor) -> torch.Tensor:
        dt = self.config.compute_dtype
        x = F.conv2d(images.to(dt).permute(0, 3, 1, 2), self.conv1.weight.to(dt), stride=self.config.patch_size)
        b, w = x.shape[:2]
        x = x.flatten(2).transpose(1, 2)  # (B, gh * gw, width), row-major patches
        cls = self.class_embedding.to(dt).expand(b, 1, w)
        x = torch.cat([cls, x], dim=1)
        x = self.ln_pre(x + self.positional_embedding[: x.shape[1]].to(dt))
        x = self.ln_post(self.transformer(x, causal=False)[:, 0])
        return x @ self.proj.to(x.dtype)


def clip_preprocess(images: torch.Tensor, size: int = 224) -> torch.Tensor:
    """Resize (bicubic, as `jax.image.resize`: see nn/functional.py::resize)
    and CLIP-normalize, (B, H, W, 3) in [0, 1] -> float32
    (reference: src_distributed/utils.py:77-80)."""
    x = images.float()
    if tuple(x.shape[1:3]) != (size, size):
        x = resize(x, (size, size), "bicubic")
    mean = torch.tensor(CLIP_MEAN, device=x.device)
    std = torch.tensor(CLIP_STD, device=x.device)
    return (x - mean) / std


# ---------------------------------------------------------------------------
# checkpoint layouts
# ---------------------------------------------------------------------------

# the open_clip entry that neither tower holds: the contrastive temperature
_OPEN_CLIP_EXTRA = ("logit_scale",)


def split_open_clip(sd: Mapping) -> tuple[dict, dict]:
    """An open_clip CLIP state dict -> (text tower state dict, vision tower
    state dict without the `visual.` prefix), each for `strict=True`."""
    text, vision = {}, {}
    for k, v in sd.items():
        if k.startswith("visual."):
            vision[k[len("visual."):]] = v
        elif k not in _OPEN_CLIP_EXTRA:
            text[k] = v
    return text, vision


def _t(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x).T)


def _hf_blocks(sd: Mapping, prefix: str, layers: int, out_prefix: str) -> dict:
    out = {}
    for i in range(layers):
        p, o = f"{prefix}encoder.layers.{i}", f"{out_prefix}transformer.resblocks.{i}"
        out[f"{o}.attn.in_proj_weight"] = np.concatenate([np.asarray(sd[f"{p}.self_attn.{n}_proj.weight"]) for n in "qkv"])
        out[f"{o}.attn.in_proj_bias"] = np.concatenate([np.asarray(sd[f"{p}.self_attn.{n}_proj.bias"]) for n in "qkv"])
        for src, dst in (("self_attn.out_proj", "attn.out_proj"), ("layer_norm1", "ln_1"), ("layer_norm2", "ln_2"),
                         ("mlp.fc1", "mlp.c_fc"), ("mlp.fc2", "mlp.c_proj")):
            out[f"{o}.{dst}.weight"] = np.asarray(sd[f"{p}.{src}.weight"])
            out[f"{o}.{dst}.bias"] = np.asarray(sd[f"{p}.{src}.bias"])
    return out


def convert_hf_clip_text(sd: Mapping, cfg: CLIPTextConfig) -> dict:
    """HF transformers CLIPTextModelWithProjection state dict (numpy) -> the
    open_clip text layout CLIPTextEncoder loads."""
    p = "text_model."
    return {
        "token_embedding.weight": np.asarray(sd[f"{p}embeddings.token_embedding.weight"]),
        "positional_embedding": np.asarray(sd[f"{p}embeddings.position_embedding.weight"]),
        "text_projection": _t(sd["text_projection.weight"]),
        "ln_final.weight": np.asarray(sd[f"{p}final_layer_norm.weight"]),
        "ln_final.bias": np.asarray(sd[f"{p}final_layer_norm.bias"]),
        **_hf_blocks(sd, p, cfg.layers, ""),
    }


def convert_hf_clip_vision(sd: Mapping, cfg: CLIPVisionConfig) -> dict:
    """HF transformers CLIPVisionModelWithProjection state dict (numpy) ->
    the open_clip visual layout (without `visual.`) CLIPVisionEncoder loads."""
    p = "vision_model."
    return {
        "conv1.weight": np.asarray(sd[f"{p}embeddings.patch_embedding.weight"]),
        "class_embedding": np.asarray(sd[f"{p}embeddings.class_embedding"]),
        "positional_embedding": np.asarray(sd[f"{p}embeddings.position_embedding.weight"]),
        "proj": _t(sd["visual_projection.weight"]),
        "ln_pre.weight": np.asarray(sd[f"{p}pre_layrnorm.weight"]),
        "ln_pre.bias": np.asarray(sd[f"{p}pre_layrnorm.bias"]),
        "ln_post.weight": np.asarray(sd[f"{p}post_layernorm.weight"]),
        "ln_post.bias": np.asarray(sd[f"{p}post_layernorm.bias"]),
        **_hf_blocks(sd, p, cfg.layers, ""),
    }
