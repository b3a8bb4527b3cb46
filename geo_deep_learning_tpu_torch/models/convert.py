"""JAX-package parameters -> the port's ``state_dict``.

The inverse of ``convert_dofa_model`` in
``geo_deep_learning_tpu/models/convert.py``: it takes the JAX package's
``DOFASegmentation`` variables as nested dicts of numpy arrays and returns
the port's ``state_dict`` under the reference's torch names. Layouts:
HWIO conv kernels -> OIHW, ``[in, out]`` dense kernels -> ``[out, in]``,
per-head ``[D, H, hd]`` q/k/v kernels -> one packed ``[3D, D]`` weight.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

Tree = Mapping[str, object]


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
    sd: dict[str, torch.Tensor] = {}

    def put(name: str, value) -> None:
        sd[name] = torch.from_numpy(np.array(value, dtype=np.float32, copy=True))

    def dense(tree: Tree, dst: str) -> None:
        put(f"{dst}.weight", np.asarray(tree["kernel"]).T)
        put(f"{dst}.bias", tree["bias"])

    def conv(tree: Tree, dst: str) -> None:
        put(f"{dst}.weight", np.transpose(np.asarray(tree["kernel"]), (3, 2, 0, 1)))
        if "bias" in tree:
            put(f"{dst}.bias", tree["bias"])

    def norm(tree: Tree, dst: str) -> None:
        put(f"{dst}.weight", tree["scale"])
        put(f"{dst}.bias", tree["bias"])

    def conv_module(ptree: Tree, stree: Tree, dst: str) -> None:
        conv(ptree["conv"], f"{dst}.conv")
        norm(ptree["bn"], f"{dst}.norm")
        put(f"{dst}.norm.running_mean", stree["bn"]["mean"])
        put(f"{dst}.norm.running_var", stree["bn"]["var"])
        sd[f"{dst}.norm.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

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
