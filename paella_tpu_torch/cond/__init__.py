"""Conditioning: the ByT5 tokenizer and encoder (the CLIP towers are not
ported yet)."""
from .t5 import T5Config, T5Encoder
from .tokenizers import byt5_batch_encode, byt5_decode, byt5_encode, pad_bucket

__all__ = ["T5Config", "T5Encoder", "byt5_batch_encode", "byt5_decode", "byt5_encode", "pad_bucket"]
