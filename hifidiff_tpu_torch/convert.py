"""JAX variable trees -> the port's state dicts.

The exact inverse of the numpy-only importers
(hifidiff_tpu/utils/torch_import.py and hifidiff_tpu/vae/import_torch.py):
conv kernels HWIO -> OIHW, linear kernels (in, out) -> (out, in), per-channel
(C,) beta/gamma -> (1, C, 1, 1), the FusedDenoiser's Dense `idc_proj` -> the
1x1 conv `idc_conv`, and BatchNorm params + batch_stats -> weight, bias,
running_mean, running_var and num_batches_tracked. Inputs are nested dicts
of numpy arrays (`jax.device_get` of a flax tree); no jax is imported. The
block counts are read from the trees, so no model config is needed.

The tiny modules (`vae/tiny.py`, `models/tiny_cr.py`) have no reference
checkpoint; their names are the port's own, and the JAX trees (flax
`nn.Conv` leaves {"kernel", "bias"}) map onto them as the converters below
say.

Each result loads into the matching port model with
`load_state_dict(sd, strict=True)`. The maps are linear and keyed by name,
so a tree of gradients (the same structure as the params) converts to
gradients under the port's parameter names, and a `batch_stats` tree to the
`running_mean` / `running_var` buffers.

A quantized tree (`quantize_variables` of the JAX package: `kernel_q` int8
and `kernel_scale` in place of `kernel`) gives `weight_q` / `weight_scale`
in place of `weight`, the same int8 bytes, and loads into a model whose
layers `quantize_module_` has replaced. The way back goes through the JAX
package's float importers twice: `split_quantized_state_dict` gives two
float-named state dicts (the int8 values, and the scales broadcast over
each weight), and `merge_quantized_trees` joins the two imported trees
into the quantized one.
"""

from __future__ import annotations

import re
from typing import Dict, Mapping

import numpy as np
import torch

Tree = Mapping[str, object]
StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))  # a writable copy


def _count(tree: Tree, prefix: str, suffix: str = "") -> int:
    pat = re.compile(rf"{re.escape(prefix)}(\d+){re.escape(suffix)}$")
    return sum(1 for k in tree if pat.match(k))


def _weight(sd: StateDict, p: str, leaf: Tree, to_torch) -> None:
    """`to_torch` maps the JAX kernel layout to the port's; a quantized leaf
    ({"kernel_q", "kernel_scale"}) keeps its int8 values."""
    if "kernel_q" in leaf:
        sd[f"{p}.weight_q"] = torch.from_numpy(np.array(  # a writable copy
            to_torch(np.asarray(leaf["kernel_q"])), dtype=np.int8, order="C"))
        sd[f"{p}.weight_scale"] = _t(leaf["kernel_scale"])
    else:
        sd[f"{p}.weight"] = _t(to_torch(np.asarray(leaf["kernel"])))
    if "bias" in leaf:
        sd[f"{p}.bias"] = _t(leaf["bias"])


def _conv(sd: StateDict, p: str, leaf: Tree) -> None:
    """A conv leaf {"kernel" (HWIO), ["bias"]} -> p.weight (OIHW), p.bias."""
    _weight(sd, p, leaf, lambda k: np.transpose(k, (3, 2, 0, 1)))


def _dense(sd: StateDict, p: str, leaf: Tree) -> None:
    _weight(sd, p, leaf, lambda k: k.T)


def _ln(sd: StateDict, p: str, leaf: Tree) -> None:
    sd[f"{p}.weight"] = _t(leaf["weight"])
    sd[f"{p}.bias"] = _t(leaf["bias"])


def _gn(sd: StateDict, p: str, leaf: Tree) -> None:
    sd[f"{p}.weight"] = _t(leaf["scale"])
    sd[f"{p}.bias"] = _t(leaf["bias"])


def _bn(sd: StateDict, p: str, params: Tree, stats: Tree) -> None:
    _gn(sd, p, params)
    sd[f"{p}.running_mean"] = _t(stats["mean"])
    sd[f"{p}.running_var"] = _t(stats["var"])
    sd[f"{p}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _prefixed(p: str, sd: StateDict) -> StateDict:
    return {f"{p}.{k}" if p else k: v for k, v in sd.items()}


def naf_block_state_dict(tree: Tree) -> StateDict:
    """NAFBlock, or ConditionalNAFBlock when the tree holds `time_proj`."""
    sd: StateDict = {}
    _ln(sd, "norm1", tree["norm1"])
    _ln(sd, "norm2", tree["norm2"])
    for i in range(1, 6):
        _conv(sd, f"conv{i}", tree[f"conv{i}"]["conv"])
    _conv(sd, "sca.1", tree["sca"]["conv"]["conv"])
    sd["beta"] = _t(np.asarray(tree["beta"]).reshape(1, -1, 1, 1))
    sd["gamma"] = _t(np.asarray(tree["gamma"]).reshape(1, -1, 1, 1))
    if "time_proj" in tree:
        _dense(sd, "mlp.1", tree["time_proj"]["dense"])
    return sd


def stn_state_dict(tree: Tree) -> StateDict:
    sd: StateDict = {}
    _conv(sd, "localization.0", tree["loc_conv1"]["conv"])
    _conv(sd, "localization.3", tree["loc_conv2"]["conv"])
    _dense(sd, "fc_loc.0", tree["fc1"]["dense"])
    _dense(sd, "fc_loc.2", tree["fc2"]["dense"])
    return sd


def hca_state_dict(params: Tree, stats: Tree) -> StateDict:
    sd: StateDict = {}
    _dense(sd, "channel_mlp.0", params["ch_fc1"]["dense"])
    _dense(sd, "channel_mlp.2", params["ch_fc2"]["dense"])
    _conv(sd, "spatial_mlp.0", params["sp_conv1"]["conv"])
    _bn(sd, "spatial_mlp.1", params["sp_bn1"], stats["sp_bn1"])
    _conv(sd, "spatial_mlp.3", params["sp_conv2"]["conv"])
    _bn(sd, "spatial_mlp.4", params["sp_bn2"], stats["sp_bn2"])
    _conv(sd, "fused_mlp.0", params["fused_conv"]["conv"])
    _bn(sd, "fused_mlp.1", params["fused_bn"], stats["fused_bn"])
    return sd


def _naf_stn_stage(tree: Tree) -> StateDict:
    sd: StateDict = {}
    for j in range(_count(tree, "naf")):
        sd.update(_prefixed(f"nfbs.{j}", naf_block_state_dict(tree[f"naf{j}"])))
    sd.update(_prefixed("stn", stn_state_dict(tree["stn"])))
    if "down" in tree:
        _conv(sd, "sampling", tree["down"]["conv"])
    if "up" in tree:
        _conv(sd, "sampling.0", tree["up"]["conv"])
    return sd


def cr_state_dict(params: Tree) -> StateDict:
    """CoarseRestoration."""
    sd: StateDict = {}
    _conv(sd, "intro", params["intro"]["conv"])
    _conv(sd, "outro", params["outro"]["conv"])
    sd.update(_prefixed("middle_blocks", _naf_stn_stage(params["mid"])))
    for i in range(_count(params, "enc")):
        sd.update(_prefixed(f"encoders.{i}", _naf_stn_stage(params[f"enc{i}"])))
    for i in range(_count(params, "dec")):
        sd.update(_prefixed(f"decoders.{i}", _naf_stn_stage(params[f"dec{i}"])))
    return sd


def resnet50_state_dict(params: Tree, stats: Tree) -> StateDict:
    """The IDC ResNet-50."""
    sd: StateDict = {}
    _conv(sd, "conv1", params["stem_conv"]["conv"])
    _bn(sd, "batch_norm1", params["stem_bn"], stats["stem_bn"])
    for name, blk in params.items():
        m = re.fullmatch(r"layer(\d+)_block(\d+)", name)
        if m is None:
            continue
        p, st = f"layer{m[1]}.{m[2]}", stats[name]
        for ci in (1, 2, 3):
            _conv(sd, f"{p}.conv{ci}", blk[f"conv{ci}"]["conv"])
            _bn(sd, f"{p}.batch_norm{ci}", blk[f"bn{ci}"], st[f"bn{ci}"])
        if "proj_conv" in blk:
            _conv(sd, f"{p}.i_downsample.0", blk["proj_conv"]["conv"])
            _bn(sd, f"{p}.i_downsample.1", blk["proj_bn"], st["proj_bn"])
    return sd


def fpg_state_dict(params: Tree) -> StateDict:
    """FacialPriorGuidance."""
    sd: StateDict = {}
    _conv(sd, "intro", params["intro"]["conv"])
    _conv(sd, "convs.0.0", params["prior_conv0"]["conv"])
    for i in range(_count(params, "down")):
        for b in range(_count(params, f"enc{i}_blk")):
            sd.update(_prefixed(f"encoders.{i}.{b}",
                                naf_block_state_dict(params[f"enc{i}_blk{b}"])))
        _conv(sd, f"downs.{i}", params[f"down{i}"]["conv"])
        _conv(sd, f"convs.{i + 1}.0", params[f"up{i}"]["conv"])
    return sd


def denoiser_state_dict(params: Tree) -> StateDict:
    """The unconditional Denoiser, and the FusedDenoiser's backbone."""
    sd: StateDict = {}
    _dense(sd, "time_mlp.1", params["time_mlp"]["fc1"]["dense"])
    _dense(sd, "time_mlp.3", params["time_mlp"]["fc2"]["dense"])
    _conv(sd, "intro", params["intro"]["conv"])
    _conv(sd, "ending", params["ending"]["conv"])

    def blocks(prefix: str, name: str) -> None:
        for b in range(_count(params, f"{name}_blk")):
            sd.update(_prefixed(f"{prefix}.{b}",
                                naf_block_state_dict(params[f"{name}_blk{b}"])))

    for i in range(_count(params, "down")):
        blocks(f"encoders.{i}", f"enc{i}")
        _conv(sd, f"downs.{i}", params[f"down{i}"]["conv"])
    blocks("middle_blks", "mid")
    for i in range(_count(params, "up")):
        _conv(sd, f"ups.{i}.0", params[f"up{i}"]["conv"])
        blocks(f"decoders.{i}", f"dec{i}")
    return sd


def fused_denoiser_state_dict(params: Tree, stats: Tree) -> StateDict:
    """FusedDenoiser; `stats` holds the HCA BatchNorm statistics."""
    sd = denoiser_state_dict(params)
    _weight(sd, "idc_conv", params["idc_proj"]["dense"],
            lambda k: k.T[:, :, None, None])
    for i in range(_count(params, "hca")):
        sd.update(_prefixed(f"hcas.{i}", hca_state_dict(params[f"hca{i}"],
                                                        stats[f"hca{i}"])))
    return sd


def refiner_state_dict(variables: Tree) -> StateDict:
    """FacialRefiner from {"params", "batch_stats"}."""
    p, s = variables["params"], variables["batch_stats"]
    sd: StateDict = {}
    sd.update(_prefixed("idc", resnet50_state_dict(p["idc"], s["idc"])))
    sd.update(_prefixed("denoiser", fused_denoiser_state_dict(
        p["denoiser"], s["denoiser"])))
    sd.update(_prefixed("fpg", fpg_state_dict(p["fpg"])))
    return sd


def _vae_resnet(sd: StateDict, p: str, tree: Tree) -> None:
    _gn(sd, f"{p}.norm1", tree["norm1"])
    _conv(sd, f"{p}.conv1", tree["conv1"])
    _gn(sd, f"{p}.norm2", tree["norm2"])
    _conv(sd, f"{p}.conv2", tree["conv2"])
    if "shortcut" in tree:
        _conv(sd, f"{p}.conv_shortcut", tree["shortcut"])


def _vae_mid(sd: StateDict, p: str, tree: Tree) -> None:
    _vae_resnet(sd, f"{p}.resnets.0", tree["res0"])
    _vae_resnet(sd, f"{p}.resnets.1", tree["res1"])
    a, attn = f"{p}.attentions.0", tree["attn"]
    _gn(sd, f"{a}.group_norm", attn["norm"])
    for name in ("to_q", "to_k", "to_v"):
        _dense(sd, f"{a}.{name}", attn[name])
    _dense(sd, f"{a}.to_out.0", attn["to_out"])


def vae_state_dict(params: Tree) -> StateDict:
    """AutoencoderKL, diffusers naming."""
    sd: StateDict = {}
    for part, block, res, sampler, conv in (
            ("encoder", "down_blocks", "down", "downsamplers", "downconv"),
            ("decoder", "up_blocks", "up", "upsamplers", "upconv")):
        tree = params[part]
        _conv(sd, f"{part}.conv_in", tree["conv_in"])
        _vae_mid(sd, f"{part}.mid_block", tree["mid"])
        _gn(sd, f"{part}.conv_norm_out", tree["norm_out"])
        _conv(sd, f"{part}.conv_out", tree["conv_out"])
        for i in range(_count(tree, res, "_res0")):
            for j in range(_count(tree, f"{res}{i}_res")):
                _vae_resnet(sd, f"{part}.{block}.{i}.resnets.{j}",
                            tree[f"{res}{i}_res{j}"])
            if f"{res}{i}_{conv}" in tree:
                _conv(sd, f"{part}.{block}.{i}.{sampler}.0.conv",
                      tree[f"{res}{i}_{conv}"])
    _conv(sd, "quant_conv", params["quant_conv"])
    _conv(sd, "post_quant_conv", params["post_quant_conv"])
    return sd


def _tiny_res(sd: StateDict, p: str, tree: Tree) -> None:
    _conv(sd, f"{p}.conv1", tree["conv1"])
    _conv(sd, f"{p}.conv2", tree["conv2"])


def _tiny_autoencoder(params: Tree, res: str, resample: str,
                      torch_resample: str) -> StateDict:
    """conv_in, `{res}{i}_res{j}` -> stages.i.j, `{res}{i}_{resample}` ->
    `{torch_resample}.i`, conv_out."""
    sd: StateDict = {}
    _conv(sd, "conv_in", params["conv_in"])
    _conv(sd, "conv_out", params["conv_out"])
    for i in range(_count(params, res, "_res0")):
        for j in range(_count(params, f"{res}{i}_res")):
            _tiny_res(sd, f"stages.{i}.{j}", params[f"{res}{i}_res{j}"])
        if f"{res}{i}_{resample}" in params:
            _conv(sd, f"{torch_resample}.{i}",
                  params[f"{res}{i}_{resample}"])
    return sd


def tiny_decoder_state_dict(params: Tree) -> StateDict:
    """TinyDecoder: `up{i}_res{j}` -> stages.i.j, `up{i}_proj` -> ups.i."""
    return _tiny_autoencoder(params, "up", "proj", "ups")


def tiny_encoder_state_dict(params: Tree) -> StateDict:
    """TinyEncoder: `down{i}_res{j}` -> stages.i.j, `down{i}_downconv` ->
    downs.i."""
    return _tiny_autoencoder(params, "down", "downconv", "downs")


def tiny_cr_state_dict(params: Tree) -> StateDict:
    """TinyCR: down, `res{j}` -> res.j, up_proj, conv_out."""
    sd: StateDict = {}
    for name in ("down", "up_proj", "conv_out"):
        _conv(sd, name, params[name])
    for j in range(_count(params, "res")):
        _tiny_res(sd, f"res.{j}", params[f"res{j}"])
    return sd


def split_quantized_state_dict(sd: Mapping[str, torch.Tensor]
                               ) -> tuple[StateDict, StateDict]:
    """A port state dict with int8 layers -> (values, scales), two state
    dicts under the float names that the JAX package's importers read:
    `values` holds each int8 weight as float32 (float layers unchanged),
    `scales` each layer's scale broadcast over its weight's shape, and zeros
    for a float layer's weight."""
    values: StateDict = {}
    scales: StateDict = {}
    for k, v in sd.items():
        if k.endswith(".weight_scale"):
            continue
        if k.endswith(".weight_q"):
            name = k[:-len("_q")]
            scale = sd[f"{name}_scale"].float()
            values[name] = v.float()
            scales[name] = scale.reshape(-1, *([1] * (v.dim() - 1))) \
                .expand(v.shape).clone()
        else:
            values[k] = v
            scales[k] = torch.zeros_like(v) if k.endswith(".weight") else v
    return values, scales


def merge_quantized_trees(values: Tree, scales: Tree) -> Dict:
    """The JAX trees imported from `split_quantized_state_dict`'s two state
    dicts -> one tree with {"kernel_q", "kernel_scale"} wherever the scales
    tree holds a non-zero kernel (a scale is at least 1e-8 / 127)."""
    out = {}
    for k, v in values.items():
        if isinstance(v, Mapping):
            out[k] = merge_quantized_trees(v, scales[k])
        elif k == "kernel" and np.any(np.asarray(scales[k])):
            s = np.asarray(scales[k], np.float32)
            out["kernel_q"] = np.asarray(v).astype(np.int8)
            out["kernel_scale"] = s.reshape(-1, s.shape[-1])[0].copy()
        else:
            out[k] = v
    return out
