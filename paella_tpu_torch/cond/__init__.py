"""Conditioning: the ByT5 tokenizer (the encoder towers are not ported yet)."""
from .tokenizers import byt5_batch_encode, byt5_decode, byt5_encode, pad_bucket

__all__ = ["byt5_batch_encode", "byt5_decode", "byt5_encode", "pad_bucket"]
