"""Evaluation metrics (the CLIP score; the Frechet metrics are not ported yet)."""
from .metrics import clip_score

__all__ = ["clip_score"]
