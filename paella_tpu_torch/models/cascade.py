"""What Stable Cascade's two UNets share (models/stage_c.py::StageC, the
prior, and models/stage_b.py::StageB, the decoder): StableCascade builds
both from the same `modules/common.py` blocks, and the port runs them the
same way.

- The noise level's embedding [emb(r) | emb(0) per t_cond].
- Every TimestepBlock's FiLM from one product a forward (their mappers
  stacked as a derived weight), cut into each block's contiguous (B, 2C)
  rows. A block reads its own rows however often it runs (`film_row`, set
  when the model is built), so a repeated block keeps its FiLM.
- Each ResBlock and the TimestepBlock after it as one K1 call
  (kernels/resblock.py::fused_resblock, the FiLM in its epilogue), the
  level's skip joined into fc1 of the first ResBlock of a pass.
- Each AttnBlock's pixel queries over [LN(x) tokens | kv_mapper(clip)] on
  K5 (kernels/attention.py::fused_attention), which reads the pixel keys
  and values out of the q|k|v product and the conditioning's out of the
  cond cache (`cond_kv`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..kernels.attention import fused_attention
from ..nn.blocks import AttnBlock, DerivedWeights, ResBlock, TimestepBlock
from ..nn.functional import layer_norm, sinusoidal_embedding


class CascadeUNet(DerivedWeights):
    """The forward pieces of a Stable Cascade UNet; a subclass builds the
    modules, sets `config` (c_r, t_conds, compute_dtype, act_quant) and calls
    :meth:`number_films` once they exist."""

    def number_films(self) -> None:
        """Give each TimestepBlock its row in the stacked FiLM product, in
        module order, and note the runs of consecutive blocks of one width."""
        groups = []
        for k, blk in enumerate(m for m in self.modules() if isinstance(m, TimestepBlock)):
            blk.film_row = k
            width = blk.mapper.out_features
            if groups and groups[-1][0] == width:
                groups[-1][1] += 1
            else:
                groups.append([width, 1])
        self._film_groups = [tuple(g) for g in groups]

    @torch.no_grad()
    def reset_parameters(self, gen: torch.Generator, std: float = 0.02) -> None:
        """Seeded N(0, std) matrices and small random vectors for tests: no
        layer is the identity (StableCascade zero-initializes the FiLM
        mappers and GRN, which would hide them)."""
        for name, p in self.named_parameters():
            scale = 0.1 if p.dim() == 1 or "gamma" in name or "beta" in name else std
            p.copy_(torch.randn(p.shape, generator=gen, device=gen.device).to(p.device, p.dtype) * scale)
        self.drop_derived()

    # -- conditioning --

    def gen_r_embedding(self, r: torch.Tensor) -> torch.Tensor:
        """[emb(r) | emb(0) per t_cond] (B, c_r * (1 + len(t_conds))), f32."""
        c_r = self.config.c_r
        emb = sinusoidal_embedding(r, c_r)
        zero = sinusoidal_embedding(torch.zeros_like(r, dtype=torch.float32), c_r)
        return torch.cat([emb] + [zero] * len(self.config.t_conds), dim=1)

    def _attn_blocks(self) -> list:
        return [(name, m) for name, m in self.named_modules() if isinstance(m, AttnBlock)]

    def cond_kv(self, clip: torch.Tensor) -> dict:
        """Each AttnBlock's conditioning keys and values (B, S_cond, C) from
        the clip tokens, keyed by the block's module name."""
        kv = {}
        for name, blk in self._attn_blocks():
            w, b = self._qkv(blk)
            c = w.shape[1]
            kv[name] = F.linear(blk.map_cond(clip), w[c:], b[c:]).split(c, dim=-1)
        return kv

    # -- forward --

    def _qkv(self, blk: AttnBlock) -> tuple:
        a = blk.attention.attn
        dt = self.config.compute_dtype
        return blk.derived("qkv", lambda: (a.in_proj_weight.to(dt), a.in_proj_bias.to(dt)))

    def _film_weights(self) -> tuple:
        """Every TimestepBlock's mappers stacked: W (sum of 2C, c_r * (1 +
        len(t_conds))) over the whole r-embedding, b the mappers' biases
        summed, so one product gives each block's sum of the mappers."""
        dt = self.config.compute_dtype

        def make():
            ws, bs = [], []
            for blk in self.modules():
                if isinstance(blk, TimestepBlock):
                    maps = blk.mappers()
                    ws.append(torch.cat([m.weight for m in maps], dim=1))
                    bs.append(sum(m.bias.float() for m in maps))
            return torch.cat(ws).to(dt), torch.cat(bs).to(dt)

        return self.derived("film", make)

    def films(self, r: torch.Tensor) -> list:
        """Each TimestepBlock's FiLM rows (B, 2C), by `film_row`: one product,
        then one copy a run of blocks of one width, so each block's rows
        are contiguous."""
        w, bias = self._film_weights()
        flat = F.linear(self.gen_r_embedding(r).to(self.config.compute_dtype), w, bias)
        b, out, off = flat.shape[0], [], 0
        for width, n in self._film_groups:
            out.extend(flat[:, off:off + n * width].reshape(b, n, width).transpose(0, 1).contiguous().unbind(0))
            off += n * width
        return out

    def _film(self, blk: TimestepBlock, films: list) -> torch.Tensor:
        return films[blk.film_row]

    def _linear(self, key: str, conv: nn.Conv2d) -> tuple:
        dt = self.config.compute_dtype
        return self.derived(key, lambda: (conv.weight[:, :, 0, 0].to(dt), conv.bias.to(dt)))

    def _attend(self, blk: AttnBlock, h: torch.Tensor, kv: tuple) -> torch.Tensor:
        b, hh, ww, c = h.shape
        nh = blk.nhead
        w, bias = self._qkv(blk)
        tokens = layer_norm(h).reshape(b, hh * ww, c)

        def heads(t: torch.Tensor) -> torch.Tensor:
            return t.reshape(b, t.shape[1], nh, c // nh)

        if blk.self_attn:  # keys [pixels | conditioning], read where each lies
            q, k, v = F.linear(tokens, w, bias).split(c, dim=-1)
            out = fused_attention(heads(q), heads(k), heads(v), k2=heads(kv[0]), v2=heads(kv[1]))
        else:
            q = F.linear(tokens, w[:c], bias[:c])
            out = fused_attention(heads(q), heads(kv[0]), heads(kv[1]))
        o = blk.attention.attn.out_proj
        out = F.linear(out.reshape(b, hh * ww, c), o.weight.to(h.dtype), o.bias.to(h.dtype))
        return h + out.reshape(b, hh, ww, c)

    def _run_level(self, prefix: str, blocks, h, skip, films: list, cache: dict) -> torch.Tensor:
        """One pass over a level's blocks; the skip goes to its first block."""
        j = 0
        while j < len(blocks):
            blk = blocks[j]
            if isinstance(blk, ResBlock):
                nxt = blocks[j + 1] if j + 1 < len(blocks) else None
                film = self._film(nxt, films) if isinstance(nxt, TimestepBlock) else None
                h = blk(h, film, skip if j == 0 else None, act_quant=self.config.act_quant)
                j += 1 if film is None else 2
                continue
            if isinstance(blk, TimestepBlock):
                a, b = self._film(blk, films)[:, None, None, :].chunk(2, dim=-1)
                h = h * (1 + a) + b
            else:
                h = self._attend(blk, h, cache["kv"][f"{prefix}.{j}"])
            j += 1
        return h
