"""High-level generation pipeline: prompts in, images out — the counterpart of
`paella_tpu/pipeline.py::PaellaPipeline`.

The reference has no such API — users assemble sampling from the notebook
(readme.md:39-41: text-to-image, inpainting, outpainting, latent
interpolation, structural editing, multi-modal conditioning). PaellaPipeline
packages those capabilities over the port's sampler and codec.

Where the JAX package takes a PRNG key, the port takes `seeds`: (B, 2) uint32
values (any integer dtype), one seed pair per image, the key data of a
batched JAX key, so the same seed pairs give the same draws in both packages
(outpaint's random canvas aside, see sampling/sampler.py::outpaint_canvas).
Weights live in the modules (`model`, `vq`); the pipeline runs on the
model's device. Conditioning encoders are callables, as in the JAX package;
text is padded to bucket sizes, and text conditioning is kept in an LRU.

`CascadePriorPipeline` runs Stable Cascade's Stage C prior
(models/stage_c.py) from prompts to latents over the CLIP-bigG text tower,
with the same text LRU (`TextConditioned`, which the pipelines share);
`CascadeDecoderPipeline` its Stage B decoder (models/stage_b.py) and Stage
A's decode (the f4 codec) from those latents to pixels; `CascadePipeline`
chains the two over one bigG tower.

Spans (utils/tracing.py): pipeline.tokenize (ByT5 or CLIP tokenization,
padding and the host->device copy), cond.byt5 / cond.clip_text /
cond.clip_image (the encoders), pipeline.decode (the clipped decode);
counters text_cache.hit and text_cache.miss, one per LRU lookup,
prior.calls and prior.images per `text_to_latents`; decoder.stage_a (Stage
A's decode) and decoder.calls and decoder.images per `latents_to_images`.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from typing import Any, Callable, Hashable, Optional, Sequence

import numpy as np
import torch

from .codec.vqgan import VQModel
from .cond.tokenizers import byt5_batch_encode, pad_bucket
from .config import DecoderSampleConfig, PriorSampleConfig, SampleConfig
from .models.denoiser import Paella
from .sampling.decoder import DecoderConditioning, sample_decoder
from .sampling.prior import PriorConditioning, sample_prior
from .sampling.sampler import Conditioning, interpolate_latents, linspace_f32, outpaint_canvas, sample
from .utils import tracing


@dataclasses.dataclass
class TextConditioned:
    """The text-conditioning LRU a pipeline keeps: serving re-generates the
    SAME prompt with other seeds or cfg, and the frozen encoders make the
    states deterministic, so a hit skips the text towers. Entries stay on the
    device; text_cache_size 0 disables it. The empty prompt's conditioning
    is kept per batch size apart. A subclass gives `conditioning(prompts)`."""

    text_cache_size: int = dataclasses.field(default=128, kw_only=True)
    _text_cache: OrderedDict = dataclasses.field(default_factory=OrderedDict, init=False, repr=False)
    _null_cache: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    def _remember(self, key: Hashable, value: Any) -> None:
        if self.text_cache_size > 0:
            self._text_cache[key] = value
            while len(self._text_cache) > self.text_cache_size:
                self._text_cache.popitem(last=False)

    def _recall(self, key: Hashable) -> Any:
        hit = self._text_cache.get(key)
        if hit is not None:
            self._text_cache.move_to_end(key)
            tracing.count("text_cache.hit")
        else:
            tracing.count("text_cache.miss")
        return hit

    def null_conditioning(self, batch: int):
        """The empty prompt's conditioning, kept per batch size."""
        if batch not in self._null_cache:
            self._null_cache[batch] = self.conditioning([""] * batch)
        return self._null_cache[batch]


@dataclasses.dataclass
class PaellaPipeline(TextConditioned):
    """Bundles denoiser + codec + frozen conditioning encoders.

    byt5_encode_fn: (ids (B,S) int32, mask (B,S) bool, on the model's device)
                    -> (B, S, byt5_embd) states
    clip_text_fn:   (prompts list[str]) -> (B, clip_embd) or None
    clip_image_fn:  (images (B,H,W,3) in [0,1]) -> (B, clip_embd) or None
    """

    model: Paella
    vq: VQModel
    byt5_encode_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    clip_text_fn: Optional[Callable[[Sequence[str]], torch.Tensor]] = None
    clip_image_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
    byt5_max_length: int = 768

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    # -- conditioning ------------------------------------------------------

    def encode_text(self, prompts: Sequence[str]) -> tuple[torch.Tensor, torch.Tensor]:
        """ByT5 states and mask, padded to a bucket length (pad_bucket)."""
        key = (tuple(prompts), self.byt5_max_length)
        hit = self._recall(key)
        if hit is not None:
            return hit
        with tracing.span("pipeline.tokenize"):
            ids, mask = byt5_batch_encode(prompts, max_length=self.byt5_max_length)
            pad = pad_bucket(ids.shape[1]) - ids.shape[1]
            if pad > 0:
                ids = np.pad(ids, ((0, 0), (0, pad)))
                mask = np.pad(mask, ((0, 0), (0, pad)))
            ids_t = torch.from_numpy(ids).to(self.device)
            mask_t = torch.from_numpy(mask).to(self.device)
        with tracing.span("cond.byt5"):
            out = (self.byt5_encode_fn(ids_t, mask_t), mask_t)
        self._remember(key, out)
        return out

    def conditioning(self, prompts: Sequence[str], images: Optional[torch.Tensor] = None) -> Conditioning:
        # text-only conditioning is deterministic in the prompts: the whole
        # bundle (ByT5 and CLIP-text) is kept; image conditioning cannot be
        # keyed, but its ByT5 part still hits the encode_text cache
        key = ("cond", tuple(prompts))
        if images is None:
            hit = self._recall(key)
            if hit is not None:
                return hit
        byt5, byt5_mask = self.encode_text(prompts)
        clip = clip_image = None
        if self.clip_text_fn is not None:
            with tracing.span("cond.clip_text"):
                clip = self.clip_text_fn(prompts)
        if self.clip_image_fn is not None and images is not None:
            with tracing.span("cond.clip_image"):
                clip_image = self.clip_image_fn(images)
        out = Conditioning(byt5=byt5, byt5_mask=byt5_mask, clip=clip, clip_image=clip_image)
        if images is None:
            self._remember(key, out)
        return out

    # -- codec -------------------------------------------------------------

    def _latent_hw(self, image_hw: tuple[int, int]) -> tuple[int, int]:
        f = self.vq.config.downscale
        return image_hw[0] // f, image_hw[1] // f

    def _images(self, images) -> torch.Tensor:
        return torch.as_tensor(images, device=next(self.vq.parameters()).device).float()

    def decode(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.vq.decode_indices(tokens)

    def _decode_clipped(self, tokens: torch.Tensor) -> torch.Tensor:
        """decode, clipped to [0, 1]: the generation paths' deliverable."""
        with tracing.span("pipeline.decode"):
            return self.decode(tokens).float().clamp(0.0, 1.0)

    def encode_image_tokens(self, images) -> torch.Tensor:
        """Image (B, H, W, 3) -> token grid (B, H/4, W/4) via the frozen codec
        encoder (its nearest-code search is kernel K4)."""
        return self.vq.encode(self._images(images))[2]

    # -- generation --------------------------------------------------------

    def text_to_image(
        self,
        prompts: Sequence[str],
        seeds: torch.Tensor,
        image_hw: tuple[int, int] = (256, 256),
        config: SampleConfig = SampleConfig(),
        images_for_clip: Optional[torch.Tensor] = None,
        cond_reweight: Optional[torch.Tensor] = None,
        negative_prompts: Optional[Sequence[str]] = None,
    ) -> torch.Tensor:
        """Full text-to-image: returns (B, H, W, 3) in [0, 1] (clipped).

        negative_prompts: CFG steers away from these instead of the empty
        prompt (the unconditional branch IS the negative direction in the
        reference's guidance mix, src_distributed/utils.py:117)."""
        b = len(prompts)
        cond = self.conditioning(prompts, images_for_clip)
        uncond = (
            self.conditioning(list(negative_prompts)) if negative_prompts is not None else self.null_conditioning(b)
        )
        h, w = self._latent_hw(image_hw)
        tokens = sample(self.model, seeds, cond, (b, h, w), uncond, config, cond_reweight=cond_reweight)
        return self._decode_clipped(tokens)

    def text_to_image_best_of(
        self,
        prompts: Sequence[str],
        seeds: torch.Tensor,
        n: int,
        image_hw: tuple[int, int] = (256, 256),
        config: SampleConfig = SampleConfig(),
        return_scores: bool = False,
        **kwargs,
    ):
        """Best-of-N generation with CLIP rerank: n candidates per prompt in
        ONE batched call (seeds (len(prompts) * n, 2), prompt-major), each
        scored with eval.clip_score by the pipeline's CLIP towers; returns the
        best image per prompt. Requires clip_text_fn and clip_image_fn."""
        if self.clip_text_fn is None or self.clip_image_fn is None:
            raise ValueError("best-of-N rerank needs clip_text_fn and clip_image_fn")
        from .eval.metrics import clip_score

        b = len(prompts)
        rep = [p for p in prompts for _ in range(n)]
        images = self.text_to_image(rep, seeds, image_hw, config, **kwargs)
        scores = clip_score(self.clip_text_fn(rep), self.clip_image_fn(images)).reshape(b, n)
        best = torch.argmax(scores, dim=1)
        images = images.reshape(b, n, *images.shape[1:])[torch.arange(b, device=best.device), best]
        return (images, scores) if return_scores else images

    def inpaint(
        self,
        prompts: Sequence[str],
        images: torch.Tensor,
        keep_mask: torch.Tensor,
        seeds: torch.Tensor,
        config: SampleConfig = SampleConfig(),
    ) -> torch.Tensor:
        """Regenerate the masked-out region of `images` under new prompts.

        keep_mask: (B, h, w) bool over the LATENT grid; True = keep original.
        """
        b = len(prompts)
        cond = self.conditioning(prompts)
        uncond = self.null_conditioning(b)
        tokens0 = self.encode_image_tokens(images)
        out = sample(
            self.model, seeds, cond, tuple(tokens0.shape), uncond, config,
            fixed_mask=keep_mask, fixed_tokens=tokens0,
        )
        return self._decode_clipped(out)

    def outpaint(
        self,
        prompts: Sequence[str],
        images: torch.Tensor,
        canvas_hw: tuple[int, int],
        offset: tuple[int, int],
        seeds: torch.Tensor,
        config: SampleConfig = SampleConfig(),
    ) -> torch.Tensor:
        """Extend `images` onto a larger canvas; the original content is pinned."""
        b = len(prompts)
        cond = self.conditioning(prompts)
        uncond = self.null_conditioning(b)
        tokens0 = self.encode_image_tokens(images)
        ch, cw = self._latent_hw(canvas_hw)
        oy, ox = self._latent_hw(offset)
        init_x, fixed_mask = outpaint_canvas(tokens0, (ch, cw), (oy, ox), self.model.config.num_labels, seeds)
        out = sample(
            self.model, seeds, cond, (b, ch, cw), uncond, config,
            init_x=init_x, fixed_mask=fixed_mask, fixed_tokens=init_x,
        )
        return self._decode_clipped(out)

    def img2img(
        self,
        prompts: Sequence[str],
        images: torch.Tensor,
        seeds: torch.Tensor,
        strength: float = 0.8,
        config: SampleConfig = SampleConfig(),
    ) -> torch.Tensor:
        """Start sampling from the tokens of `images` at t_start=strength
        (the reference sampler's init_x path, src_distributed/utils.py:105-107)."""
        b = len(prompts)
        cond = self.conditioning(prompts)
        uncond = self.null_conditioning(b)
        tokens0 = self.encode_image_tokens(images)
        cfg = dataclasses.replace(config, t_start=strength)
        out = sample(self.model, seeds, cond, tuple(tokens0.shape), uncond, cfg, init_x=tokens0)
        return self._decode_clipped(out)

    def interpolate(self, image_a: torch.Tensor, image_b: torch.Tensor, n: int, decode: bool = True) -> torch.Tensor:
        """Latent interpolation between two images (n frames incl. endpoints)."""
        ta = self.encode_image_tokens(self._images(image_a)[None])[0]
        tb = self.encode_image_tokens(self._images(image_b)[None])[0]
        codebook = self.vq.vquantizer.codebook.weight
        alphas = torch.from_numpy(linspace_f32(0.0, 1.0, n))
        frames = interpolate_latents(ta, tb, codebook, alphas)
        return self._decode_clipped(frames) if decode else frames


# diffusers' StableCascadePriorPipeline: the latent side is ceil(H / 42.67),
# 24 at 1024 pixels
RESOLUTION_MULTIPLE = 42.67


@dataclasses.dataclass
class CascadePriorPipeline(TextConditioned):
    """Stable Cascade's text-to-latents: prompts -> Stage C latents (B, h, w,
    c_in), the input of Stage B (CascadeDecoderPipeline).

    text_encoder: the CLIP-bigG text tower (cond/clip.py::CLIPTextEncoder,
                  `hidden_states` route)
    tokenizer:    prompts -> (ids (B, 77), mask (B, 77)) numpy, as
                  cond/tokenizers.py::CLIPTokenizer.with_mask gives them

    The conditioning is diffusers' text-only path: the prompt's hidden states
    and pooled feature, image embeddings of zeros; the unconditional side is
    the empty prompt through the same tower, with zeros too."""

    model: Any  # models/stage_c.py::StageC
    text_encoder: Callable
    tokenizer: Callable[[Sequence[str]], tuple]

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def conditioning(self, prompts: Sequence[str]) -> PriorConditioning:
        key = ("prior", tuple(prompts))
        hit = self._recall(key)
        if hit is not None:
            return hit
        with tracing.span("pipeline.tokenize"):
            ids, mask = self.tokenizer(prompts)
            ids_t = torch.from_numpy(np.asarray(ids)).to(self.device)
            mask_t = torch.from_numpy(np.asarray(mask)).to(self.device)
        with tracing.span("cond.clip_text"):
            hidden, pooled = self.text_encoder.hidden_states(ids_t, mask_t)
        img = torch.zeros(len(prompts), 1, self.model.config.c_clip_img, dtype=hidden.dtype, device=self.device)
        out = PriorConditioning(hidden, pooled[:, None], img)
        self._remember(key, out)
        return out

    def latent_hw(self, image_hw: tuple[int, int]) -> tuple[int, int]:
        return tuple(math.ceil(s / RESOLUTION_MULTIPLE) for s in image_hw)

    def text_to_latents(
        self,
        prompts: Sequence[str],
        seeds: torch.Tensor,
        image_hw: tuple[int, int] = (1024, 1024),
        config: PriorSampleConfig = PriorSampleConfig(),
    ) -> torch.Tensor:
        """Stage C latents (B, h, w, c_in) in the model's dtype for images of
        image_hw; seeds (B, 2) uint32 values, one pair an image."""
        b = len(prompts)
        tracing.count("prior.calls")
        tracing.count("prior.images", b)
        h, w = self.latent_hw(image_hw)
        return sample_prior(self.model, seeds, self.conditioning(prompts), (b, h, w, self.model.config.c_in),
                            self.null_conditioning(b), config)


@dataclasses.dataclass
class CascadeDecoderPipeline(TextConditioned):
    """Stable Cascade's latents-to-images: Stage C latents -> Stage B's
    latents -> Stage A's decode, images (B, H, W, 3) in [0, 1], float32.

    model:        models/stage_b.py::StageB
    vq:           the f4 codec (codec/vqgan.py::VQModel at VQConfig()'s
                  widths, Stage A), float32
    text_encoder: the CLIP-bigG text tower (`hidden_states` route), whose
                  pooled feature conditions Stage B
    tokenizer:    prompts -> (ids (B, 77), mask (B, 77)) numpy

    As diffusers' StableCascadeDecoderPipeline at its defaults: the
    prompts' pooled feature encoded here (kept in the text LRU), guidance 0,
    images = clamp(vq.decode(x), 0, 1), the decode scaling x by Stage A's
    scale_factor."""

    model: Any  # models/stage_b.py::StageB
    vq: VQModel
    text_encoder: Callable
    tokenizer: Callable[[Sequence[str]], tuple]

    @property
    def device(self) -> torch.device:
        return next(self.model.parameters()).device

    def conditioning(self, prompts: Sequence[str]) -> torch.Tensor:
        """The prompts' pooled CLIP-bigG feature (B, 1, c_clip)."""
        key = ("decoder", tuple(prompts))
        hit = self._recall(key)
        if hit is not None:
            return hit
        with tracing.span("pipeline.tokenize"):
            ids, mask = self.tokenizer(prompts)
            ids_t = torch.from_numpy(np.asarray(ids)).to(self.device)
            mask_t = torch.from_numpy(np.asarray(mask)).to(self.device)
        with tracing.span("cond.clip_text"):
            _, pooled = self.text_encoder.hidden_states(ids_t, mask_t)
        out = pooled[:, None]
        self._remember(key, out)
        return out

    def latent_hw(self, image_hw: tuple[int, int]) -> tuple[int, int]:
        f = self.vq.config.downscale
        return image_hw[0] // f, image_hw[1] // f

    def latents_to_images(
        self,
        prompts: Sequence[str],
        latents_c: torch.Tensor,
        seeds: torch.Tensor,
        image_hw: tuple[int, int] = (1024, 1024),
        config: DecoderSampleConfig = DecoderSampleConfig(),
    ) -> torch.Tensor:
        """Images (B, H, W, 3) in [0, 1] on the model's device from Stage C
        latents (B, h, w, c_effnet); seeds (B, 2) uint32 values, one pair an
        image (the prior's seeds may be given again: the decoder draws under
        tags of its own)."""
        b = len(prompts)
        tracing.count("decoder.calls")
        tracing.count("decoder.images", b)
        h, w = self.latent_hw(image_hw)
        cond = DecoderConditioning(self.conditioning(prompts), latents_c)
        x = sample_decoder(self.model, seeds, cond, (b, h, w, self.model.config.c_in), config)
        with tracing.span("decoder.stage_a"):
            return self.vq.decode(x.float()).clamp(0.0, 1.0)


@dataclasses.dataclass
class CascadePipeline:
    """Stable Cascade's text-to-image: the prior's latents, then the
    decoder's images, both conditioned through one CLIP-bigG tower."""

    prior: CascadePriorPipeline
    decoder: CascadeDecoderPipeline

    @classmethod
    def build(cls, stage_c: Any, stage_b: Any, vq: VQModel, text_encoder: Callable,
              tokenizer: Callable[[Sequence[str]], tuple]) -> "CascadePipeline":
        return cls(CascadePriorPipeline(stage_c, text_encoder, tokenizer),
                   CascadeDecoderPipeline(stage_b, vq, text_encoder, tokenizer))

    def text_to_image(
        self,
        prompts: Sequence[str],
        seeds: torch.Tensor,
        image_hw: tuple[int, int] = (1024, 1024),
        prior_config: PriorSampleConfig = PriorSampleConfig(),
        decoder_config: DecoderSampleConfig = DecoderSampleConfig(),
    ) -> torch.Tensor:
        """Images (B, H, W, 3) in [0, 1]; seeds (B, 2), one pair an image."""
        latents = self.prior.text_to_latents(prompts, seeds, image_hw, prior_config)
        return self.decoder.latents_to_images(prompts, latents, seeds, image_hw, decoder_config)
