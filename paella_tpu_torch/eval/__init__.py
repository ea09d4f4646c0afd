"""Evaluation: the classic-FID InceptionV3 featurizer, the Fréchet
distance, and the CLIP-based featurizer and score."""
from .inception import (
    convert_inception,
    inception_features,
    inception_pool3,
    inception_preprocess,
    load_inception,
)
from .metrics import (
    clip_image_features,
    clip_score,
    clip_score_images,
    feature_stats,
    features_over_batches,
    fid_from_features,
    frechet_distance,
)

__all__ = [
    "clip_image_features",
    "clip_score",
    "clip_score_images",
    "convert_inception",
    "feature_stats",
    "features_over_batches",
    "fid_from_features",
    "frechet_distance",
    "inception_features",
    "inception_pool3",
    "inception_preprocess",
    "load_inception",
]
