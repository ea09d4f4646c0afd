"""Frozen conditioning-model loader — the reference's load_conditional_models
(reference: src_distributed/utils.py:65-82), the counterpart of
`paella_tpu/cond/loader.py`.

Loads the VQGAN, the ByT5 encoder and the CLIP towers from local torch
checkpoints (`torch.load(map_location="cpu")`, then onto `device`) and
returns modules and encode callables ready for PaellaPipeline; nothing is
downloaded. Every loader runs on a CUDA device unless the caller asks for
`device="cpu"`; without a card it raises rather than carry on on the CPU.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..codec.vqgan import VQModel
from ..config import VQConfig
from .clip import CLIPTextConfig, CLIPTextEncoder, CLIPVisionConfig, CLIPVisionEncoder, clip_preprocess, split_open_clip
from .t5 import T5Config, T5Encoder
from .tokenizers import CLIPTokenizer


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device with no card raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} asked for, but no CUDA device is present; pass device='cpu' to run on the CPU")
    return device


def load_state_dict(path: str, key: Optional[str] = "state_dict") -> dict:
    """A torch checkpoint's tensors, on the CPU. The reference saves a dict
    with the model under 'state_dict' (src_distributed/train.py:134); a
    bare state dict (key=None, or no such entry) is taken as it is."""
    obj = torch.load(path, map_location="cpu", mmap=True, weights_only=True)
    if key is not None and isinstance(obj, dict) and key in obj:
        obj = obj[key]
    return dict(obj)


def _load(module: nn.Module, sd: dict) -> nn.Module:
    module.load_state_dict(sd, strict=True)
    return module.eval()


@dataclasses.dataclass
class ConditionalModels:
    """Bundle returned by load_conditional_models: the codec plus the frozen
    encoder callables (mirrors the reference's (vqgan, clip triple, byt5 pair))."""

    vq: VQModel
    byt5_encode: Optional[Callable[[torch.Tensor, torch.Tensor], torch.Tensor]] = None  # (ids, mask) -> states
    clip_text_encode: Optional[Callable[[Sequence[str]], torch.Tensor]] = None
    clip_image_encode: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


def load_vqgan(path: str, cfg: VQConfig = VQConfig(), device="cuda") -> VQModel:
    """Reference VQGAN checkpoint -> the codec on `device`. BatchNorm's
    `num_batches_tracked`, which eval mode never reads, may be absent."""
    device = resolve_device(device)
    sd = load_state_dict(path)
    with torch.device(device):
        vq = VQModel(cfg)
    for k, v in vq.state_dict().items():
        if k.endswith("num_batches_tracked"):
            sd.setdefault(k, v)
    return _load(vq, sd)


def load_byt5(path: str, cfg: T5Config, int8_weights: bool = False, device="cuda") -> T5Encoder:
    """HF ByT5 (T5EncoderModel) torch checkpoint -> the encoder on `device`,
    a callable (ids, mask) -> states.

    int8_weights=True stores the block linears as per-channel int8
    (quant.quantize_t5_int8), halving the encoder's device memory; with
    cfg.act_quant=True the products run W8A8 (quant.w8a8_dot). Float block
    linears are held in the compute dtype, the values the JAX encoder's
    per-product casts give."""
    from ..quant import quantize_t5_int8

    if cfg.act_quant and not int8_weights:
        raise ValueError("cfg.act_quant=True requires int8_weights=True")
    device = resolve_device(device)
    sd = load_state_dict(path, key=None)
    with torch.device(device):
        enc = _load(T5Encoder(cfg), sd)
    if int8_weights:
        enc = quantize_t5_int8(enc)
    with torch.no_grad():
        for m in enc.modules():
            if isinstance(m, nn.Linear):
                m.weight.data = m.weight.data.to(cfg.compute_dtype)
    return enc


def load_open_clip(
    path: str,
    text_cfg: CLIPTextConfig = CLIPTextConfig.vit_h_14(),
    vision_cfg: CLIPVisionConfig = CLIPVisionConfig.vit_h_14(),
    tokenizer: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
    bpe_path: Optional[str] = None,
    device="cuda",
) -> Tuple[Callable, Callable]:
    """open_clip checkpoint -> (text_encode(prompts), image_encode(images)),
    the towers on `device`.

    Tokenization is native (cond/tokenizers.py::CLIPTokenizer): pass
    `bpe_path` pointing at the standard `bpe_simple_vocab_16e6.txt.gz` merge
    table (data, shipped with every CLIP distribution; not in this repo).
    Alternatively pass `tokenizer` (prompts -> (B,77) ids) to override, e.g.
    open_clip's own tokenizer for A/B checks. image_encode takes (B, H, W, 3)
    images in [0, 1] at any size (clip_preprocess resizes them)."""
    if tokenizer is None:
        if bpe_path is None:
            raise ValueError(
                "no CLIP tokenizer: pass bpe_path= (the bpe_simple_vocab_16e6"
                ".txt.gz merge table) for the native BPE, or tokenizer= "
                "(prompts -> (B,77) ids)"
            )
        tokenizer = CLIPTokenizer(bpe_path)
    device = resolve_device(device)
    text_sd, vision_sd = split_open_clip(load_state_dict(path, key=None))
    with torch.device(device):
        text_model = _load(CLIPTextEncoder(text_cfg), text_sd).cast_products()
        vision_model = _load(CLIPVisionEncoder(vision_cfg), vision_sd).cast_products()

    def text_encode(prompts: Sequence[str]) -> torch.Tensor:
        return text_model(torch.as_tensor(np.asarray(tokenizer(prompts)), device=device))

    def image_encode(images: torch.Tensor) -> torch.Tensor:
        return vision_model(clip_preprocess(torch.as_tensor(images, device=device), vision_cfg.image_size))

    return text_encode, image_encode


def load_conditional_models(
    vqgan_path: str,
    byt5_path: Optional[str] = None,
    byt5_cfg: Optional[T5Config] = None,
    clip_path: Optional[str] = None,
    clip_bpe_path: Optional[str] = None,
    clip_tokenizer: Optional[Callable[[Sequence[str]], np.ndarray]] = None,
    clip_text_cfg: Optional[CLIPTextConfig] = None,
    clip_vision_cfg: Optional[CLIPVisionConfig] = None,
    vq_cfg: VQConfig = VQConfig(),
    byt5_int8: bool = False,
    device="cuda",
) -> ConditionalModels:
    """One-call loader mirroring reference load_conditional_models
    (src_distributed/utils.py:65-82): frozen VQGAN (+ optionally ByT5 + CLIP),
    all on `device`.

    CLIP needs a tokenizer: pass `clip_bpe_path` (the standard
    bpe_simple_vocab_16e6.txt.gz merge table) for the native BPE, or
    `clip_tokenizer` (prompts -> (B,77) ids) to override.
    """
    device = resolve_device(device)
    vq = load_vqgan(vqgan_path, vq_cfg, device)
    byt5_encode = None
    if byt5_path is not None:
        byt5_encode = load_byt5(byt5_path, byt5_cfg or T5Config.byt5_xl(), int8_weights=byt5_int8, device=device)
    clip_text = clip_image = None
    if clip_path is not None:
        clip_text, clip_image = load_open_clip(
            clip_path,
            text_cfg=clip_text_cfg or CLIPTextConfig.vit_h_14(),
            vision_cfg=clip_vision_cfg or CLIPVisionConfig.vit_h_14(),
            tokenizer=clip_tokenizer,
            bpe_path=clip_bpe_path,
            device=device,
        )
    return ConditionalModels(vq=vq, byt5_encode=byt5_encode, clip_text_encode=clip_text, clip_image_encode=clip_image)
