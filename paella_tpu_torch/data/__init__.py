from .loader import (
    SampleFilter,
    SyntheticDataset,
    WebDatasetLoader,
    decode_image,
    iter_tar_samples,
    random_crop,
    resize_shorter_side,
    write_tar_shard,
)
from .native import jpeg_decoder
from .prefetch import background_iterator, prefetch_to_device

__all__ = [
    "SampleFilter",
    "SyntheticDataset",
    "WebDatasetLoader",
    "background_iterator",
    "decode_image",
    "iter_tar_samples",
    "jpeg_decoder",
    "prefetch_to_device",
    "random_crop",
    "resize_shorter_side",
    "write_tar_shard",
]
