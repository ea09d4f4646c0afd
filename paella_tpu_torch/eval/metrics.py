"""Image-text metrics, the counterpart of `paella_tpu/eval/metrics.py`: the
per-pair CLIP score, which best-of-N reranking reads."""
from __future__ import annotations

import torch


def clip_score(text_features: torch.Tensor, image_features: torch.Tensor) -> torch.Tensor:
    """Per-pair CLIP score: 100 * max(0, cosine(text_i, image_i)). (B,) float32."""
    t = text_features.float()
    v = image_features.float()
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return 100.0 * torch.clamp((t * v).sum(dim=-1), min=0.0)
