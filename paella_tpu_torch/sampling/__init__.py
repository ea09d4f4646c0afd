from .sampler import Conditioning, derive_seeds, merge_cfg_pair, sample

__all__ = ["Conditioning", "derive_seeds", "merge_cfg_pair", "sample"]
