"""Generation-quality metrics: FID and CLIP score, the counterpart of
`paella_tpu/eval/metrics.py`.

- FID statistics (mean/covariance) and the Fréchet distance run host-side in
  float64 numpy, a copy of the JAX package's (tests/test_torch_eval.py pins
  it): the convention every published FID number uses.
- Feature extraction is pluggable: eval/inception.py gives the classic
  InceptionV3-pool3 featurizer, `clip_image_features` the CLIP-FID one over
  the port's vision tower (cond/clip.py).
- CLIP score runs on the tensors' device: 100 * max(0, cosine(text, image)),
  the torchmetrics/openai convention; best-of-N reranking reads it.
"""
from __future__ import annotations

from typing import Callable, Iterable, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# FID (host-side, float64)
# ---------------------------------------------------------------------------


def feature_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D)) in float64."""
    f = np.asarray(features, np.float64)
    if f.ndim != 2:
        raise ValueError(f"features must be (N, D), got {f.shape}")
    if f.shape[0] < 2:
        raise ValueError("need at least 2 samples for a covariance")
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _trace_sqrtm_product(s1: np.ndarray, s2: np.ndarray) -> float:
    """tr((Σ1 Σ2)^1/2) via the symmetric form Σ1^1/2 Σ2 Σ1^1/2 (PSD, so an
    eigh of it is stable — no scipy.linalg.sqrtm needed)."""
    w1, v1 = np.linalg.eigh(s1)
    sq1 = (v1 * np.sqrt(np.clip(w1, 0.0, None))) @ v1.T
    m = sq1 @ s2 @ sq1
    w = np.linalg.eigvalsh((m + m.T) / 2.0)
    return float(np.sqrt(np.clip(w, 0.0, None)).sum())


def frechet_distance(
    mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray, sigma2: np.ndarray
) -> float:
    """Fréchet distance between two Gaussians:
    |μ1−μ2|² + tr(Σ1 + Σ2 − 2(Σ1Σ2)^1/2)."""
    mu1, mu2 = np.asarray(mu1, np.float64), np.asarray(mu2, np.float64)
    s1, s2 = np.asarray(sigma1, np.float64), np.asarray(sigma2, np.float64)
    diff = float(((mu1 - mu2) ** 2).sum())
    cov_term = float(np.trace(s1) + np.trace(s2)) - 2.0 * _trace_sqrtm_product(s1, s2)
    return max(diff + cov_term, 0.0)


def fid_from_features(real: np.ndarray, generated: np.ndarray) -> float:
    """FID between two (N, D) feature sets (extractor-agnostic)."""
    return frechet_distance(*feature_stats(real), *feature_stats(generated))


def features_over_batches(
    extract: Callable[[torch.Tensor], torch.Tensor], images: Iterable[np.ndarray]
) -> np.ndarray:
    """Run a feature extractor over an iterable of image batches (numpy,
    host-side; the extractor moves each to its device) and stack the results
    host-side as float32; one device round trip per batch."""
    out = [extract(torch.as_tensor(np.asarray(batch))).float().cpu().numpy() for batch in images]
    if not out:
        raise ValueError("no image batches")
    return np.concatenate(out, axis=0)


# ---------------------------------------------------------------------------
# CLIP-based extractors / CLIP score (on the device)
# ---------------------------------------------------------------------------


def clip_image_features(vision_model) -> Callable[[torch.Tensor], torch.Tensor]:
    """CLIP-FID / CLIP-score image featurizer over the port's vision tower
    (cond/clip.py::CLIPVisionEncoder, on its device): NHWC [0,1] float or
    uint8 images -> (B, embed_dim)."""
    from ..cond.clip import clip_preprocess

    device = next(vision_model.parameters()).device

    def extract(images: torch.Tensor) -> torch.Tensor:
        images = torch.as_tensor(images, device=device)
        if images.dtype == torch.uint8:
            images = images.float() / 255.0
        return vision_model(clip_preprocess(images, vision_model.config.image_size))

    return extract


def clip_score(text_features: torch.Tensor, image_features: torch.Tensor) -> torch.Tensor:
    """Per-pair CLIP score: 100 * max(0, cosine(text_i, image_i)). (B,) float32."""
    t = text_features.float()
    v = image_features.float()
    t = t / torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return 100.0 * torch.clamp((t * v).sum(dim=-1), min=0.0)


def clip_score_images(text_model, vision_model, token_ids, images) -> torch.Tensor:
    """End-to-end CLIP score for (tokenized prompts, generated images) on the
    towers' device.

    token_ids: (B, 77) from cond/tokenizers.py::CLIPTokenizer.__call__.
    images: (B, H, W, 3) NHWC in [0,1] (or uint8).
    """
    device = next(text_model.parameters()).device
    text = text_model(torch.as_tensor(np.asarray(token_ids), device=device))
    return clip_score(text, clip_image_features(vision_model)(images))
