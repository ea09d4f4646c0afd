from .sampler import Conditioning, derive_seeds, interpolate_latents, merge_cfg_pair, outpaint_canvas, sample

__all__ = ["Conditioning", "derive_seeds", "interpolate_latents", "merge_cfg_pair", "outpaint_canvas", "sample"]
