"""Conditioning: the ByT5 and CLIP BPE tokenizers, the ByT5 encoder, the
CLIP text and vision towers, and the checkpoint loader."""
from .clip import (
    CLIPTextConfig,
    CLIPTextEncoder,
    CLIPVisionConfig,
    CLIPVisionEncoder,
    clip_preprocess,
    convert_hf_clip_text,
    convert_hf_clip_vision,
    split_open_clip,
)
from .loader import ConditionalModels, load_byt5, load_conditional_models, load_open_clip, load_vqgan
from .t5 import T5Config, T5Encoder
from .tokenizers import CLIPTokenizer, byt5_batch_encode, byt5_decode, byt5_encode, pad_bucket

__all__ = [
    "CLIPTextConfig",
    "CLIPTextEncoder",
    "CLIPTokenizer",
    "CLIPVisionConfig",
    "CLIPVisionEncoder",
    "ConditionalModels",
    "T5Config",
    "T5Encoder",
    "byt5_batch_encode",
    "byt5_decode",
    "byt5_encode",
    "clip_preprocess",
    "convert_hf_clip_text",
    "convert_hf_clip_vision",
    "load_byt5",
    "load_conditional_models",
    "load_open_clip",
    "load_vqgan",
    "pad_bucket",
    "split_open_clip",
]
