"""The Paella denoiser: a 3-level UNet over a discrete token grid, the
counterpart of `paella_tpu/models/denoiser.py::Paella`.

Module and parameter names are the reference torch model's
(src/modules.py:109-283), so `paella_state_dict_from_jax` (convert.py) and a
reference checkpoint load with `strict=True`: `down_blocks[i]` and
`up_blocks[i]` are ModuleLists holding every repetition's blocks in order
(a Downsample first at levels i > 0, an Upsample last on the way up).

Activations are NHWC; logits come out channels-last (B, H, W, num_labels).

  tokens (B,H,W) -> Embed+LN -> space_to_depth(patch) -> 1x1 conv -> LN
  -> down levels [CT]x6 @ c640, [CTA]x16 @ c1280 (stride-2), [CTA]x6 @ c1280 (stride-2)
  -> mirrored up levels with skip-concat into the first ResBlock of shallower levels
  -> LN -> 1x1 conv (zero-init) -> depth_to_space(patch) -> LN -> 1x1 (tied) -> logits

Every ResBlock with a TimestepBlock after it runs as one fused kernel call
with the FiLM (a, b) from that TimestepBlock's mapper (kernels/resblock.py).
The AttnBlocks follow the JAX forward at fused_blocks=True: repetition 0 of a
level takes kernel K5 as its attention core under attention_impl="pallas",
repetitions 1 and up run whole as kernel K6 under attn_block_kernel=True, and
every other case (and any call with cond_reweight) takes plain torch attention.

A model quantized by quant.quantize_paella_int8 runs its int8 ResBlocks
through kernel K1b as the JAX forward does: W8A8 under `config.act_quant`,
weight-only otherwise, and weight-only at repetitions >= 1 of a level where
JAX takes its attention-block kernel (`_jax_attn_block_route`).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..config import PaellaConfig
from ..nn import init
from ..nn.blocks import AttnBlock, DerivedWeights, Downsample, FeedForwardBlock, ResBlock, TimestepBlock, Upsample
from ..nn.functional import depth_to_space, layer_norm, sinusoidal_embedding, space_to_depth


class Paella(DerivedWeights):
    """Token-space denoiser. forward(x, r, byt5, clip, clip_image, ...):

      x          (B, H, W) integer token grid
      r          (B,) float noise level in (0, 1]
      byt5       (B, S, byt5_embd) ByT5 encoder states
      clip       (B, clip_embd) CLIP text embedding or None
      clip_image (B, clip_embd) or (B, K, clip_embd) CLIP image embedding(s) or None
      x_cat      optional extra token rows concatenated along H
      byt5_mask / clip_mask / clip_image_mask: optional boolean masks; a False
        entry drops those tokens from attention, which lets a cond/uncond CFG
        pair with different modality sets run as one batch.
      cond_reweight (B, S_cond) multiplicative post-softmax attention weights
        over the conditioning tokens.
      cond_cache: gen_cond_cache's output for these conditioning inputs; the
        conditioning arguments are then not read.
    """

    def __init__(self, config: PaellaConfig):
        super().__init__()
        cfg = self.config = config
        dt = cfg.compute_dtype
        n = len(cfg.c_hidden)
        self.byt5_mapper = nn.Linear(cfg.byt5_embd, cfg.c_cond)
        self.clip_mapper = nn.Linear(cfg.clip_embd, cfg.c_cond * cfg.clip_seq_len)
        self.clip_image_mapper = nn.Linear(cfg.clip_embd, cfg.c_cond * cfg.clip_seq_len)
        self.in_mapper = nn.Sequential(nn.Embedding(cfg.num_labels, cfg.c_in))
        self.embedding = nn.Sequential(
            nn.Identity(),  # PixelUnshuffle
            nn.Conv2d(cfg.c_in * cfg.patch_size**2, cfg.c_hidden[0], kernel_size=1),
        )

        if cfg.attention_impl not in ("xla", "pallas"):
            raise ValueError(f"attention_impl {cfg.attention_impl!r}: 'xla' or 'pallas'")

        def attn_route(rep: int) -> Optional[str]:
            # the JAX forward at fused_blocks=True: repetition 0 runs the AttnBlock
            # module, whose core is K5 under attention_impl="pallas"; the others
            # run in rest_reps_fused, as K6 under attn_block_kernel and otherwise
            # with plain attention whatever attention_impl says
            # (paella_tpu/models/denoiser.py:487-498, 603-704)
            if rep > 0:
                return "attn_block" if cfg.attn_block_kernel else None
            return "attention" if cfg.attention_impl == "pallas" else None

        def level(i: int, with_skip: bool) -> list:
            blocks = []
            for rep in range(cfg.blocks[i]):
                for k, bt in enumerate(cfg.level_config[i]):
                    c = cfg.c_hidden[i]
                    if bt == "C":
                        c_skip = c if (with_skip and rep == 0 and k == 0) else 0
                        blocks.append(ResBlock(c, c_skip, cfg.kernel_size, dtype=dt, level=i, rep=rep))
                    elif bt == "T":
                        blocks.append(TimestepBlock(c, cfg.c_r, dtype=dt))
                    elif bt == "A":
                        blocks.append(
                            AttnBlock(c, cfg.c_cond, cfg.nhead[i], cfg.self_attn, dtype=dt, kernel=attn_route(rep))
                        )
                    elif bt == "F":
                        blocks.append(FeedForwardBlock(c, dtype=dt))
                    else:
                        raise ValueError(f"block type {bt!r}: 'C', 'T', 'A' or 'F'")
            return blocks

        self.down_blocks = nn.ModuleList()
        for i in range(n):
            pre = [Downsample(cfg.c_hidden[i - 1], cfg.c_hidden[i], dtype=dt)] if i > 0 else []
            self.down_blocks.append(nn.ModuleList(pre + level(i, False)))
        self.up_blocks = nn.ModuleList()
        for iu, i in enumerate(reversed(range(n))):
            post = [Upsample(cfg.c_hidden[i], cfg.c_hidden[i - 1], dtype=dt)] if i > 0 else []
            self.up_blocks.append(nn.ModuleList(level(i, iu > 0) + post))
        self.clf = nn.Sequential(
            nn.Identity(),  # LayerNorm2d
            nn.Conv2d(cfg.c_hidden[0], cfg.c_out * cfg.patch_size**2, kernel_size=1),
        )
        self.out_mapper = nn.Sequential(
            nn.Identity(),  # LayerNorm2d
            nn.Conv2d(cfg.c_out, cfg.num_labels, kernel_size=1, bias=False),
        )

    # -- initialization (reference: src/modules.py:189-210) --

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator) -> None:
        """The reference's init scheme, drawn from `gen`; the output head is
        tied to the input embedding at init (src/modules.py:197)."""
        cfg = self.config
        out_scale = (1.0 / sum(cfg.blocks)) ** 0.5
        for m in (self.byt5_mapper, self.clip_mapper, self.clip_image_mapper):
            init.normal_(m.weight, 0.02, gen)
            init.zeros_(m.bias)
        init.normal_(self.in_mapper[0].weight, (1.0 / cfg.num_labels) ** 0.5, gen)
        init.xavier_uniform_(self.embedding[1].weight, gen, gain=0.02)
        init.zeros_(self.embedding[1].bias)
        for levels in (self.down_blocks, self.up_blocks):
            for blocks in levels:
                for blk in blocks:
                    if isinstance(blk, (ResBlock, FeedForwardBlock)):
                        blk.reset_parameters(gen, out_scale)
                    else:
                        blk.reset_parameters(gen)
        init.zeros_(self.clf[1].weight)
        init.zeros_(self.clf[1].bias)
        self.out_mapper[1].weight.copy_(self.in_mapper[0].weight[:, :, None, None])
        self.drop_derived()

    # -- conditioning --

    def gen_r_embedding(self, r: torch.Tensor) -> torch.Tensor:
        """Sinusoidal noise-level embedding (reference: src/modules.py:212-221)."""
        return sinusoidal_embedding(r, self.config.c_r).to(self.config.compute_dtype)

    def _gen_c_embeddings(self, byt5, clip, clip_image, byt5_mask, clip_mask, clip_image_mask):
        """The conditioning sequence (reference: src/modules.py:223-232):
        (seq (B, S, c_cond), mask (B, S) or None)."""
        cfg = self.config
        dt = cfg.compute_dtype
        dev = byt5.device

        def lin(m: nn.Linear, v):
            return F.linear(v.to(dt), m.weight.to(dt), m.bias.to(dt))

        b = byt5.shape[0]
        parts = [lin(self.byt5_mapper, byt5)]
        mask_parts = [byt5_mask if byt5_mask is not None else torch.ones(byt5.shape[:2], dtype=torch.bool, device=dev)]
        any_mask = byt5_mask is not None
        if clip is not None:
            parts.append(lin(self.clip_mapper, clip).reshape(b, cfg.clip_seq_len, cfg.c_cond))
            cm = clip_mask[:, None] if clip_mask is not None else torch.ones((b, 1), dtype=torch.bool, device=dev)
            mask_parts.append(cm.expand(b, cfg.clip_seq_len))
            any_mask |= clip_mask is not None
        if clip_image is not None:
            imgs = clip_image if clip_image.dim() == 3 else clip_image[:, None, :]
            k_imgs = imgs.shape[1]
            parts.append(
                lin(self.clip_image_mapper, imgs).reshape(b, k_imgs * cfg.clip_seq_len, cfg.c_cond)
            )
            if clip_image_mask is not None:
                im = clip_image_mask if clip_image_mask.dim() == 2 else clip_image_mask[:, None]
                im = im.expand(b, k_imgs)
                mask_parts.append(im.repeat_interleave(cfg.clip_seq_len, dim=1))
            else:
                mask_parts.append(torch.ones((b, k_imgs * cfg.clip_seq_len), dtype=torch.bool, device=dev))
            any_mask |= clip_image_mask is not None
        seq = layer_norm(torch.cat(parts, dim=1))
        mask = torch.cat(mask_parts, dim=1) if any_mask else None
        return seq, mask

    @torch.no_grad()
    def gen_cond_cache(
        self,
        byt5: torch.Tensor,
        clip: Optional[torch.Tensor] = None,
        clip_image: Optional[torch.Tensor] = None,
        byt5_mask: Optional[torch.Tensor] = None,
        clip_mask: Optional[torch.Tensor] = None,
        clip_image_mask: Optional[torch.Tensor] = None,
    ) -> dict:
        """Every activation that does not change between sampling steps,
        computed once: the conditioning sequence and its mask, the
        layer-normed embedding table, and each AttnBlock's kv_mapper output
        (keyed by the block's module name)."""
        dt = self.config.compute_dtype
        c_embed, cond_mask = self._gen_c_embeddings(
            byt5, clip, clip_image, byt5_mask, clip_mask, clip_image_mask
        )
        kv = {
            name: m.map_cond(c_embed)
            for name, m in self.named_modules()
            if isinstance(m, AttnBlock)
        }
        return {
            "c_embed": c_embed,
            "cond_mask": cond_mask,
            "norm_embedding": layer_norm(self.in_mapper[0].weight).to(dt),
            "kv": kv,
        }

    # -- forward --

    def head_weight(self) -> torch.Tensor:
        """The output head (num_labels, c_out) in the compute dtype, the layout
        kernels/sampling.py reads."""
        dt = self.config.compute_dtype
        return self.derived("head", lambda: self.out_mapper[1].weight[:, :, 0, 0].to(dt).contiguous())

    def _jax_attn_block_route(self, i: int, h: torch.Tensor, s_cond: int, cond_reweight) -> bool:
        """Whether the JAX forward runs repetitions >= 1 of level i with its
        attention-block kernel (paella_tpu/models/denoiser.py:600-609): its
        scan then calls the ResBlock kernel without act_quant (:632-657).
        Decided by JAX's own condition, its VMEM gate included, whatever route
        the port's AttnBlocks take (the port's K6 has no such gate)."""
        cfg = self.config
        c, nhead = cfg.c_hidden[i], cfg.nhead[i]
        b, hh, ww = h.shape[:3]
        qkv_scratch = b * (hh * ww + s_cond) * 3 * nhead * 128 * cfg.compute_dtype.itemsize
        return (
            cfg.level_config[i].endswith("A")
            and cfg.attn_block_kernel
            and cond_reweight is None
            and c % 128 == 0
            and nhead % 2 == 0
            and qkv_scratch <= 4_500_000
        )

    def _run_level(self, prefix, i, blocks, start, stop, h, skip, r_embed, c_embed, cond_mask, cond_reweight, kv):
        # int8 ResBlocks run W8A8 under act_quant, except repetitions >= 1 at a
        # level where JAX takes its attention-block route (a quirk kept on
        # purpose, ROADMAP.md section C)
        act = self.config.act_quant
        act_rest = act and not self._jax_attn_block_route(i, h, c_embed.shape[1], cond_reweight)
        j = start
        while j < stop:
            blk = blocks[j]
            if isinstance(blk, ResBlock):
                film = None
                if j + 1 < stop and isinstance(blocks[j + 1], TimestepBlock):
                    film = blocks[j + 1].film(r_embed)
                h = blk(h, film, skip if j == start else None, act_quant=act if blk.rep == 0 else act_rest)
                j += 1 if film is None else 2
                continue
            if isinstance(blk, TimestepBlock):
                h = blk(h, r_embed)
            elif isinstance(blk, AttnBlock):
                h = blk(h, c_embed, cond_mask, cond_reweight, kv=kv.get(f"{prefix}.{j}"))
            elif isinstance(blk, FeedForwardBlock):
                h = blk(h)
            j += 1
        return h

    @torch.no_grad()
    def forward(
        self,
        x: torch.Tensor,
        r: torch.Tensor,
        byt5: Optional[torch.Tensor] = None,
        clip: Optional[torch.Tensor] = None,
        clip_image: Optional[torch.Tensor] = None,
        x_cat: Optional[torch.Tensor] = None,
        byt5_mask: Optional[torch.Tensor] = None,
        clip_mask: Optional[torch.Tensor] = None,
        clip_image_mask: Optional[torch.Tensor] = None,
        cond_reweight: Optional[torch.Tensor] = None,
        return_features: bool = False,
        cond_cache: Optional[dict] = None,
    ) -> torch.Tensor:
        cfg = self.config
        dt = cfg.compute_dtype
        n = len(cfg.c_hidden)
        p = cfg.patch_size
        if x_cat is not None:
            x = torch.cat([x, x_cat], dim=1)
        x = x.long()
        r_embed = self.gen_r_embedding(r)
        if cond_cache is not None:
            c_embed, cond_mask, kv = cond_cache["c_embed"], cond_cache["cond_mask"], cond_cache["kv"]
            h = cond_cache["norm_embedding"][x]
        else:
            c_embed, cond_mask = self._gen_c_embeddings(
                byt5, clip, clip_image, byt5_mask, clip_mask, clip_image_mask
            )
            kv = {}
            h = layer_norm(self.in_mapper[0].weight[x]).to(dt)

        emb_w, emb_b = self.derived(
            "embedding",
            lambda: (self.embedding[1].weight[:, :, 0, 0].to(dt), self.embedding[1].bias.to(dt)),
        )
        h = layer_norm(F.linear(space_to_depth(h, p), emb_w, emb_b))

        ctx = (r_embed, c_embed, cond_mask, cond_reweight, kv)
        level_outputs = []
        for i in range(n):
            blocks = self.down_blocks[i]
            start = 0
            if i > 0:
                h = blocks[0](h)
                start = 1
            h = self._run_level(f"down_blocks.{i}", i, blocks, start, len(blocks), h, None, *ctx)
            level_outputs.insert(0, h)

        h = level_outputs[0]
        for iu, i in enumerate(reversed(range(n))):
            blocks = self.up_blocks[iu]
            stop = len(blocks) - 1 if i > 0 else len(blocks)
            skip = level_outputs[iu] if iu > 0 else None
            h = self._run_level(f"up_blocks.{iu}", i, blocks, 0, stop, h, skip, *ctx)
            if i > 0:
                h = blocks[stop](h)

        clf_w, clf_b = self.derived(
            "clf", lambda: (self.clf[1].weight[:, :, 0, 0].to(dt), self.clf[1].bias.to(dt))
        )
        h = F.linear(layer_norm(h).to(dt), clf_w, clf_b)
        h = layer_norm(depth_to_space(h, p))
        if return_features:
            # pre-head features (B, H, W, c_out). The head is linear with no
            # bias, so the sampler's CFG mix commutes through it.
            return h
        return F.linear(h, self.head_weight())
