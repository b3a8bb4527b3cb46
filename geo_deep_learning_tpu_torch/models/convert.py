"""JAX-package parameters -> the port's ``state_dict``.

The inverses of ``convert_dofa_model`` (:func:`from_jax_params`), of
``convert_segformer_model`` + ``convert_mit``
(:func:`from_jax_segformer_params`) in
``geo_deep_learning_tpu/models/convert.py``, and of the UNet++ mapping of
``convert_resnet`` + ``scripts/parity_unetpp_goldens.py::torch_to_flax``
(:func:`from_jax_unetpp_params`): they take the JAX package's
variables as nested dicts of numpy arrays and return the port's
``state_dict`` under the reference's torch names. Layouts: HWIO conv
kernels -> OIHW (a depthwise ``[3, 3, 1, C]`` -> ``[C, 1, 3, 3]``),
``[in, out]`` dense kernels -> ``[out, in]``, per-head ``[D, H, hd]``
q/k/v kernels -> one packed ``[3D, D]`` weight.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np
import torch

Tree = Mapping[str, object]


class _Writer:
    """Collects a ``state_dict`` from flax parameter subtrees."""

    def __init__(self) -> None:
        self.sd: dict[str, torch.Tensor] = {}

    def put(self, name: str, value) -> None:
        self.sd[name] = torch.from_numpy(np.array(value, dtype=np.float32, copy=True))

    def dense(self, tree: Tree, dst: str) -> None:
        self.put(f"{dst}.weight", np.asarray(tree["kernel"]).T)
        self.put(f"{dst}.bias", tree["bias"])

    def conv(self, tree: Tree, dst: str) -> None:
        self.put(f"{dst}.weight", np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1)))
        if "bias" in tree:
            self.put(f"{dst}.bias", tree["bias"])

    def norm(self, tree: Tree, dst: str) -> None:
        self.put(f"{dst}.weight", tree["scale"])
        self.put(f"{dst}.bias", tree["bias"])

    def batch_norm(self, ptree: Tree, stree: Tree, dst: str) -> None:
        self.norm(ptree, dst)
        self.put(f"{dst}.running_mean", stree["mean"])
        self.put(f"{dst}.running_var", stree["var"])
        self.sd[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def from_jax_params(
    params: Tree,
    batch_stats: Tree | None = None,
    pos_embed: np.ndarray | None = None,
    pool_scales: tuple[int, ...] = (1, 2, 3, 6),
) -> dict[str, torch.Tensor]:
    """``DOFASegmentation`` variables -> port ``state_dict``.

    ``pos_embed`` ([1, 1 + g^2, D]) fills ``encoder.pos_embed``; the JAX
    model recomputes that table and carries no parameter for it.
    """
    stats = batch_stats or {}
    writer = _Writer()
    sd, put, dense, conv, norm = writer.sd, writer.put, writer.dense, writer.conv, writer.norm

    def conv_module(ptree: Tree, stree: Tree, dst: str) -> None:
        conv(ptree["conv"], f"{dst}.conv")
        writer.batch_norm(ptree["bn"], stree["bn"], f"{dst}.norm")

    def packed_proj(tree: Tree) -> tuple[np.ndarray, np.ndarray]:
        """q/k/v DenseGeneral params -> packed torch ``[3D, D]`` weight, bias."""
        ws, bs = [], []
        for name in ("query", "key", "value"):
            k = np.asarray(tree[name]["kernel"])
            ws.append(k.reshape(k.shape[0], -1).T)
            bs.append(np.asarray(tree[name]["bias"]).reshape(-1))
        return np.concatenate(ws), np.concatenate(bs)

    def out_proj(tree: Tree, dst: str) -> None:
        k = np.asarray(tree["out"]["kernel"])
        put(f"{dst}.weight", k.reshape(-1, k.shape[-1]).T)
        put(f"{dst}.bias", tree["out"]["bias"])

    enc = params["encoder"]
    pe, wg = enc["patch_embed"], enc["patch_embed"]["weight_generator"]
    dense(pe["fclayer"]["w1"], "encoder.patch_embed.fclayer.w1")
    dense(pe["fclayer"]["w2"], "encoder.patch_embed.fclayer.w2")
    g = "encoder.patch_embed.weight_generator"
    put(f"{g}.weight_tokens", wg["weight_tokens"])
    put(f"{g}.bias_token", wg["bias_token"])
    dense(wg["fc_weight"], f"{g}.fc_weight")
    dense(wg["fc_bias"], f"{g}.fc_bias")
    el, tl = wg["encoder_layer"], f"{g}.transformer_encoder.layers.0"
    w, b = packed_proj(el["self_attn"])
    put(f"{tl}.self_attn.in_proj_weight", w)
    put(f"{tl}.self_attn.in_proj_bias", b)
    out_proj(el["self_attn"], f"{tl}.self_attn.out_proj")
    for name in ("linear1", "linear2"):
        dense(el[name], f"{tl}.{name}")
    for name in ("norm1", "norm2"):
        norm(el[name], f"{tl}.{name}")

    put("encoder.cls_token", enc["cls_token"])
    i = 0
    while f"block{i}" in enc:
        src, dst = enc[f"block{i}"], f"encoder.blocks.{i}"
        norm(src["norm1"], f"{dst}.norm1")
        norm(src["norm2"], f"{dst}.norm2")
        put(f"{dst}.ls1.gamma", src["ls1_gamma"])
        put(f"{dst}.ls2.gamma", src["ls2_gamma"])
        w, b = packed_proj(src["attn"])
        put(f"{dst}.attn.qkv.weight", w)
        put(f"{dst}.attn.qkv.bias", b)
        out_proj(src["attn"], f"{dst}.attn.proj")
        dense(src["mlp_fc1"], f"{dst}.mlp.fc1")
        dense(src["mlp_fc2"], f"{dst}.mlp.fc2")
        i += 1
    norm(enc["norm"], "encoder.norm")
    if pos_embed is not None:
        put("encoder.pos_embed", pos_embed)

    neck, neck_s = params["neck"], stats.get("neck", {})
    for i in range(4):
        conv_module(neck[f"lateral{i}"], neck_s[f"lateral{i}"], f"neck.lateral_convs.{i}")
        conv_module(neck[f"conv{i}"], neck_s[f"conv{i}"], f"neck.convs.{i}")

    dec, dec_s = params["decoder"], stats.get("decoder", {})
    for j, scale in enumerate(pool_scales):
        conv_module(
            dec["ppm"][f"pool{scale}"], dec_s["ppm"][f"pool{scale}"],
            f"decoder.psp_modules.{j}.1",
        )
    conv_module(dec["bottleneck"], dec_s["bottleneck"], "decoder.bottleneck")
    i = 0
    while f"lateral{i}" in dec:
        conv_module(dec[f"lateral{i}"], dec_s[f"lateral{i}"], f"decoder.lateral_convs.{i}")
        conv_module(dec[f"fpn_conv{i}"], dec_s[f"fpn_conv{i}"], f"decoder.fpn_convs.{i}")
        i += 1
    conv_module(dec["fpn_bottleneck"], dec_s["fpn_bottleneck"], "decoder.fpn_bottleneck")

    aux, aux_s = params["aux_head"], stats.get("aux_head", {})
    i = 0
    while f"conv{i}" in aux:
        conv_module(aux[f"conv{i}"], aux_s[f"conv{i}"], f"aux_head.convs.{i}")
        i += 1
    conv(aux["cls_seg"], "aux_head.cls_seg")
    conv(params["head"]["conv"], "head.conv")
    return sd


_MIT_BLOCK = re.compile(r"^block(\d)_(\d+)$")


def _mit(w: _Writer, enc: Tree, prefix: str) -> None:
    for key, tree in enc.items():
        block = _MIT_BLOCK.match(key)
        if block:
            dst = f"{prefix}block{block.group(1)}.{block.group(2)}"
            w.norm(tree["norm1"], f"{dst}.norm1")
            w.norm(tree["norm2"], f"{dst}.norm2")
            attn = tree["attn"]
            for name in ("q", "kv", "proj"):
                w.dense(attn[name], f"{dst}.attn.{name}")
            if "sr" in attn:
                w.conv(attn["sr"], f"{dst}.attn.sr")
                w.norm(attn["sr_norm"], f"{dst}.attn.norm")
            w.dense(tree["mlp"]["fc1"], f"{dst}.mlp.fc1")
            w.conv(tree["mlp"]["dwconv"], f"{dst}.mlp.dwconv.dwconv")
            w.dense(tree["mlp"]["fc2"], f"{dst}.mlp.fc2")
        elif key.startswith("patch_embed"):
            w.conv(tree["proj"], f"{prefix}{key}.proj")
            w.norm(tree["norm"], f"{prefix}{key}.norm")
        elif key.startswith("norm"):
            w.norm(tree, f"{prefix}{key}")
        elif key == "dynamic_patch_embed1":
            dst = f"{prefix}{key}"
            for name in ("weight_gen1", "weight_gen2", "channel_attn1", "channel_attn2", "proj"):
                w.dense(tree[name], f"{dst}.{name}")
            w.conv(tree["spatial_conv"], f"{dst}.spatial_conv")
            w.norm(tree["norm"], f"{dst}.norm")
        else:
            msg = f"unexpected MiT parameter group {key!r}"
            raise KeyError(msg)


def from_jax_mit_params(params: Tree) -> dict[str, torch.Tensor]:
    """``MixVisionTransformer`` / ``DynamicMixTransformer`` parameters ->
    the port encoder's ``state_dict`` (the inverse of ``convert_mit``)."""
    w = _Writer()
    _mit(w, params, "")
    return w.sd


def from_jax_segformer_params(params: Tree, batch_stats: Tree) -> dict[str, torch.Tensor]:
    """``SegFormer`` variables (MiT or Dynamic encoder) -> port ``state_dict``
    (the inverse of ``convert_segformer_model``)."""
    w = _Writer()
    _mit(w, params["encoder"], "encoder.")
    dec = params["decoder"]
    for i in range(1, 5):
        w.dense(dec[f"linear_c{i}"], f"decoder.linear_c{i}.proj")
    w.conv(dec["linear_fuse"], "decoder.linear_fuse.0")
    w.batch_norm(dec["bn"], batch_stats["decoder"]["bn"], "decoder.linear_fuse.1")
    w.conv(dec["linear_pred"], "decoder.linear_pred")
    return w.sd


_RESNET_BLOCK = re.compile(r"^layer(\d)_(\d+)$")


def _resnet(w: _Writer, enc: Tree, stats: Tree, prefix: str) -> None:
    w.conv(enc["conv1"], f"{prefix}conv1")
    w.batch_norm(enc["bn1"], stats["bn1"], f"{prefix}bn1")
    for key, tree in enc.items():
        block = _RESNET_BLOCK.match(key)
        if block is None:
            if key not in ("conv1", "bn1"):
                msg = f"unexpected ResNet parameter group {key!r}"
                raise KeyError(msg)
            continue
        dst = f"{prefix}layer{block.group(1)}.{block.group(2)}"
        for name, sub in tree.items():
            if name.startswith("conv"):
                w.conv(sub, f"{dst}.{name}")
            elif name.startswith("bn"):
                w.batch_norm(sub, stats[key][name], f"{dst}.{name}")
            elif name == "downsample_conv":
                w.conv(sub, f"{dst}.downsample.0")
            elif name == "downsample_bn":
                w.batch_norm(sub, stats[key][name], f"{dst}.downsample.1")
            else:
                msg = f"unexpected ResNet block parameter group {key}/{name}"
                raise KeyError(msg)


def from_jax_unetpp_params(params: Tree, batch_stats: Tree) -> dict[str, torch.Tensor]:
    """``UnetPlusPlus`` variables (any of its execution forms: they share one
    parameter tree) -> port ``state_dict`` under smp's names (the encoder's
    are torchvision's, which ``convert_resnet`` reads). Converts the groups
    present (``encoder``, ``decoder``, ``head``), so an encoder's or a
    decoder's variables alone convert too."""
    w = _Writer()
    if "encoder" in params:
        _resnet(w, params["encoder"], batch_stats["encoder"], "encoder.")
    for node, tree in params.get("decoder", {}).items():
        for conv in ("conv1", "conv2"):
            dst = f"decoder.blocks.{node}.{conv}"
            w.conv(tree[conv]["conv"], f"{dst}.0")
            w.batch_norm(tree[conv]["bn"], batch_stats["decoder"][node][conv]["bn"], f"{dst}.1")
    if "head" in params:
        w.conv(params["head"], "segmentation_head.0")
    return w.sd
