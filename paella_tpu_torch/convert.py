"""JAX parameter trees -> the reference's torch state-dict layout, numpy only.

The JAX package's exporters (`paella_tpu/convert/torch_export.py`) import
jax; these re-implement them on plain nested dicts of numpy arrays, so the
port can take weights trained or initialized by the JAX package without it.
The result loads into the port's modules with `load_state_dict(strict=True)`
(after `torch.from_numpy`), and is the same layout a reference checkpoint has.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np

from .config import PaellaConfig, VQConfig
from .cond.clip import CLIPTextConfig, CLIPVisionConfig
from .cond.t5 import T5Config

StateDict = Dict[str, np.ndarray]


def _np(x) -> np.ndarray:
    return np.asarray(x)


def _lin(out: StateDict, prefix: str, p: Mapping, bias: bool = True) -> None:
    """A Dense kernel (in, out) -> weight (out, in); a quantized one (int8
    kernel with a `kernel_scale` sibling, quant.quantize_*_int8) keeps its
    codes int8 and carries the scales as `weight_scale` (quant.Int8Linear)."""
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["kernel"]).T)
    if bias:
        out[f"{prefix}.bias"] = _np(p["bias"])
    if "kernel_scale" in p:
        out[f"{prefix}.weight_scale"] = _np(p["kernel_scale"])


def _conv1x1(out: StateDict, prefix: str, p: Mapping, bias: bool = True) -> None:
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["kernel"]).T)[:, :, None, None]
    if bias:
        out[f"{prefix}.bias"] = _np(p["bias"])


def _conv(out: StateDict, prefix: str, p: Mapping, bias: bool = True) -> None:
    # (kh, kw, in/groups, out) -> (out, in/groups, kh, kw)
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["kernel"]).transpose(3, 2, 0, 1))
    if bias:
        out[f"{prefix}.bias"] = _np(p["bias"])


def _conv_transpose(out: StateDict, prefix: str, p: Mapping) -> None:
    # (kh, kw, in, out) -> (in, out, kh, kw)
    out[f"{prefix}.weight"] = np.ascontiguousarray(_np(p["kernel"]).transpose(2, 3, 0, 1))
    out[f"{prefix}.bias"] = _np(p["bias"])


def _mha(out: StateDict, prefix: str, p: Mapping) -> None:
    wq, wk, wv = (_np(p[n]["kernel"]).T for n in ("q", "k", "v"))
    out[f"{prefix}.in_proj_weight"] = np.ascontiguousarray(np.concatenate([wq, wk, wv], axis=0))
    out[f"{prefix}.in_proj_bias"] = np.concatenate([_np(p[n]["bias"]) for n in ("q", "k", "v")])
    _lin(out, f"{prefix}.out_proj", p["o"])


def _block(out: StateDict, prefix: str, bt: str, p: Mapping) -> None:
    if bt in ("C", "F"):
        if bt == "C":
            _conv(out, f"{prefix}.depthwise", p["depthwise"])
        cw = p["channelwise"]
        _lin(out, f"{prefix}.channelwise.0", cw["fc1"])
        out[f"{prefix}.channelwise.2.gamma"] = _np(cw["grn"]["gamma"]).reshape(1, 1, 1, -1)
        out[f"{prefix}.channelwise.2.beta"] = _np(cw["grn"]["beta"]).reshape(1, 1, 1, -1)
        _lin(out, f"{prefix}.channelwise.4", cw["fc2"])
    elif bt == "A":
        _lin(out, f"{prefix}.kv_mapper.1", p["kv_mapper"])
        _mha(out, f"{prefix}.attention.attn", p["attention"])
    elif bt == "T":
        _lin(out, f"{prefix}.mapper", p["mapper"])


def _unstack(tree, idx: int):
    """Repetition `idx` of a tree of arrays stacked on their leading axis."""
    if isinstance(tree, Mapping):
        return {k: _unstack(v, idx) for k, v in tree.items()}
    return _np(tree)[idx]


def paella_state_dict_from_jax(params: Mapping, cfg: PaellaConfig = PaellaConfig()) -> StateDict:
    """The JAX Paella param tree (numpy leaves) -> reference-layout state dict,
    equal key for key and value for value to paella_tpu's export_paella. A
    tree quantized by the JAX quantize_paella_int8 gives int8 fc weights with
    their `weight_scale`s, repetitions unstacked alike: the state dict of the
    port's quant.quantize_paella_int8 model."""
    sd: StateDict = {}
    _lin(sd, "byt5_mapper", params["byt5_mapper"])
    _lin(sd, "clip_mapper", params["clip_mapper"])
    _lin(sd, "clip_image_mapper", params["clip_image_mapper"])
    sd["in_mapper.0.weight"] = _np(params["in_embedding"]["embedding"])
    _conv1x1(sd, "embedding.1", params["embedding_conv"])
    _conv1x1(sd, "clf.1", params["clf_conv"])
    sd["out_mapper.1.weight"] = np.ascontiguousarray(_np(params["out_proj"]["kernel"]).T)[:, :, None, None]

    def export_level(prefix: str, i: int, torch_prefix: str, j: int) -> int:
        rest = params.get(f"{prefix}_{i}_rest")
        for rep in range(cfg.blocks[i]):
            for k, bt in enumerate(cfg.level_config[i]):
                if rep == 0:
                    tree = params[f"{prefix}_{i}_0_{k}_{bt}"]
                else:  # nn.scan stacks repetitions 1.. on a leading axis
                    tree = _unstack(rest[f"{k}_{bt}"], rep - 1)
                _block(sd, f"{torch_prefix}.{j}", bt, tree)
                j += 1
        return j

    n = len(cfg.c_hidden)
    for i in range(n):
        j = 0
        if i > 0:
            _conv(sd, f"down_blocks.{i}.0.1", params[f"down_{i}_downsample"]["conv"])
            j = 1
        export_level("down", i, f"down_blocks.{i}", j)
    for iu, i in enumerate(reversed(range(n))):
        j = export_level("up", i, f"up_blocks.{iu}", 0)
        if i > 0:
            _conv_transpose(sd, f"up_blocks.{iu}.{j}.1", params[f"up_{i}_upsample"]["conv"])
    return sd


def vqgan_state_dict_from_jax(variables: Mapping, cfg: VQConfig = VQConfig()) -> StateDict:
    """The JAX VQModel {params, batch_stats} (numpy leaves) -> reference-layout
    state dict (paella_tpu's export_vqgan, plus BatchNorm's
    num_batches_tracked, which torch's BatchNorm2d state dict carries)."""
    params = variables["params"]
    stats = variables["batch_stats"]
    sd: StateDict = {}

    def vq_res(prefix: str, p: Mapping) -> None:
        sd[f"{prefix}.gammas"] = _np(p["gammas"])
        _conv(sd, f"{prefix}.depthwise.1", p["depthwise"])
        _lin(sd, f"{prefix}.channelwise.0", p["fc1"])
        _lin(sd, f"{prefix}.channelwise.2", p["fc2"])

    _conv1x1(sd, "in_block.1", params["in_conv"])
    j = 0
    for i in range(cfg.levels):
        if i > 0:
            _conv(sd, f"down_blocks.{j}", params[f"down_conv_{i}"])
            j += 1
        vq_res(f"down_blocks.{j}", params[f"down_res_{i}"])
        j += 1
    _conv1x1(sd, f"down_blocks.{j}.0", params["to_latent"], bias=False)
    sd[f"down_blocks.{j}.1.weight"] = _np(params["latent_norm"]["scale"])
    sd[f"down_blocks.{j}.1.bias"] = _np(params["latent_norm"]["bias"])
    sd[f"down_blocks.{j}.1.running_mean"] = _np(stats["latent_norm"]["mean"])
    sd[f"down_blocks.{j}.1.running_var"] = _np(stats["latent_norm"]["var"])
    sd[f"down_blocks.{j}.1.num_batches_tracked"] = np.array(0, dtype=np.int64)

    sd["vquantizer.codebook.weight"] = _np(params["vquantizer"]["codebook"])

    _conv1x1(sd, "up_blocks.0.0", params["from_latent"])
    j = 1
    for i in range(cfg.levels):
        for b in range(cfg.bottleneck_blocks if i == 0 else 1):
            vq_res(f"up_blocks.{j}", params[f"up_res_{i}_{b}"])
            j += 1
        if i < cfg.levels - 1:
            _conv_transpose(sd, f"up_blocks.{j}", params[f"up_conv_{i}"])
            j += 1
    _conv1x1(sd, "out_block.0", params["out_conv"])
    return sd


def discriminator_state_dict_from_jax(variables: Mapping) -> StateDict:
    """The JAX codec Discriminator {params, batch_stats} (numpy leaves) -> the
    port's Discriminator state dict: each conv's kernel and bias, and its
    spectral-norm u and sigma from batch_stats (torch's spectral_norm would
    draw its own u)."""
    params, stats = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    i = 0
    while f"Conv_{i}" in params:
        _conv(sd, f"convs.{i}", params[f"Conv_{i}"])
        sn = stats[f"SpectralNorm_{i}"]
        sd[f"convs.{i}.u"] = _np(sn[f"Conv_{i}/kernel/u"])
        sd[f"convs.{i}.sigma"] = _np(sn[f"Conv_{i}/kernel/sigma"])
        i += 1
    _lin(sd, "shuffle", params["shuffle"])
    return sd


def t5_state_dict_from_jax(params: Mapping, cfg: T5Config) -> StateDict:
    """The JAX T5Encoder param tree (numpy leaves), float or quantized by the
    JAX quantize_t5_int8, -> the HF T5EncoderModel state dict layout that
    cond/t5.py::T5Encoder loads: the inverse of the JAX package's
    convert_t5_encoder (paella_tpu/cond/t5.py:201-229)."""
    sd: StateDict = {"shared.weight": _np(params["token_embedding"])}
    for i in range(cfg.num_layers):
        p, b = params[f"block_{i}"], f"encoder.block.{i}"
        for n in ("q", "k", "v", "o"):
            _lin(sd, f"{b}.layer.0.SelfAttention.{n}", p["attention"][n], bias=False)
        if i == 0:
            sd[f"{b}.layer.0.SelfAttention.relative_attention_bias.weight"] = _np(params["relative_attention_bias"])
        sd[f"{b}.layer.0.layer_norm.weight"] = _np(p["attn_norm"])
        for n in ("wi_0", "wi_1", "wo"):
            _lin(sd, f"{b}.layer.1.DenseReluDense.{n}", p[n], bias=False)
        sd[f"{b}.layer.1.layer_norm.weight"] = _np(p["ff_norm"])
    sd["encoder.final_layer_norm.weight"] = _np(params["final_norm"])
    return sd


def _clip_blocks(out: StateDict, params: Mapping, layers: int) -> None:
    """JAX _CLIPBlock trees -> open_clip resblocks, q, k and v re-packed
    into in_proj (the inverse of the JAX `_split_packed_qkv`)."""
    for i in range(layers):
        p, o = params[f"block_{i}"], f"transformer.resblocks.{i}"
        _mha(out, f"{o}.attn", p["attn"])
        for src, dst in (("ln1", "ln_1"), ("ln2", "ln_2")):
            out[f"{o}.{dst}.weight"] = _np(p[src]["scale"])
            out[f"{o}.{dst}.bias"] = _np(p[src]["bias"])
        _lin(out, f"{o}.mlp.c_fc", p["fc1"])
        _lin(out, f"{o}.mlp.c_proj", p["fc2"])


def clip_text_state_dict_from_jax(params: Mapping, cfg: CLIPTextConfig) -> StateDict:
    """The JAX CLIPTextEncoder tree (numpy leaves) -> the open_clip text
    layout of cond/clip.py::CLIPTextEncoder: the inverse of the JAX
    package's convert_open_clip_text (paella_tpu/cond/clip.py:227-266)."""
    sd: StateDict = {
        "token_embedding.weight": _np(params["token_embedding"]),
        "positional_embedding": _np(params["position_embedding"]),
        "text_projection": _np(params["text_projection"]),
        "ln_final.weight": _np(params["ln_final"]["scale"]),
        "ln_final.bias": _np(params["ln_final"]["bias"]),
    }
    _clip_blocks(sd, params, cfg.layers)
    return sd


def clip_vision_state_dict_from_jax(params: Mapping, cfg: CLIPVisionConfig) -> StateDict:
    """The JAX CLIPVisionEncoder tree (numpy leaves) -> the open_clip visual
    layout (keys without `visual.`) of cond/clip.py::CLIPVisionEncoder: the
    inverse of convert_open_clip_vision (paella_tpu/cond/clip.py:269-306)."""
    sd: StateDict = {
        "conv1.weight": np.ascontiguousarray(_np(params["patch_embed"]["kernel"]).transpose(3, 2, 0, 1)),
        "class_embedding": _np(params["class_embedding"]),
        "positional_embedding": _np(params["position_embedding"]),
        "proj": _np(params["visual_projection"]),
    }
    for name in ("ln_pre", "ln_post"):
        sd[f"{name}.weight"] = _np(params[name]["scale"])
        sd[f"{name}.bias"] = _np(params[name]["bias"])
    _clip_blocks(sd, params, cfg.layers)
    return sd


def load_params_npz(path: str) -> dict:
    """A flat .npz of a JAX param tree (paella_tpu/train/checkpoints.py
    save_params_npz: keys joined by '/') -> the nested dict of numpy
    arrays, as the JAX package's load_params_npz unflattens it."""
    tree: dict = {}
    with np.load(path) as data:
        for key in data.files:
            *parents, leaf = key.split("/")
            node = tree
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[key]
    return tree
