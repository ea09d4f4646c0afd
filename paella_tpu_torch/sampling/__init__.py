from .sampler import (
    Conditioning,
    derive_seeds,
    interpolate_latents,
    merge_cfg_pair,
    outpaint_canvas,
    sample,
    sample_eager,
)

__all__ = ["Conditioning", "derive_seeds", "interpolate_latents", "merge_cfg_pair", "outpaint_canvas", "sample",
           "sample_eager"]
