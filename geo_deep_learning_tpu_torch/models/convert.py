"""JAX-package parameters -> the port's ``state_dict``, and pretrained torch weights.

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

The pretrained-weight loaders are the counterparts of ``load_torch_state_dict``,
``load_pretrained_tree``, ``patch_first_conv``, ``remap_hf_dofa``,
``resize_pos_embed`` and ``merge_pretrained`` in the same JAX module. The
port's encoders use the reference's torch names, so a converted encoder is
the file's own tensors, selected as the JAX converters select them, with
the first conv re-plumbed for other band counts, the HF DOFA layout
remapped, and DOFA's pretrained position table carried as a side entry
(``"pos_embed"``) that :func:`merge_pretrained` resizes (bicubic) into the
encoder's ``pos_embed`` buffer.
"""

from __future__ import annotations

import re
from pathlib import Path
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


# --------------------------------------------------------------------------
# Pretrained torch weights -> an encoder's state (JAX convert.py:36-565)
# --------------------------------------------------------------------------

_BN = ("weight", "bias", "running_mean", "running_var")


def load_torch_state_dict(path: str | Path) -> dict[str, torch.Tensor]:
    """The tensors of a ``.pth`` / ``.pt`` / ``.ckpt`` / ``.safetensors`` file
    (a Lightning ``state_dict`` entry or an HF ``model`` entry unwrapped).
    A ``.msgpack`` file is a Flax tree, which the port does not read."""
    path = str(path)
    if path.endswith(".msgpack"):
        msg = (f"{path} is a converted Flax tree; the port reads the torch file it was "
               "converted from (.pth, .pt, .ckpt or .safetensors)")
        raise ValueError(msg)
    if path.endswith(".safetensors"):
        from safetensors.torch import load_file

        return dict(load_file(path))
    obj = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    if isinstance(obj, dict) and isinstance(obj.get("model"), dict):
        obj = obj["model"]
    return {k: v for k, v in obj.items() if isinstance(v, torch.Tensor)}


def patch_first_conv(weight: torch.Tensor, in_channels: int, rescale: bool = True) -> torch.Tensor:
    """An OIHW first-conv weight for ``in_channels`` inputs (reference
    ``models/utils.py:140-181``): one channel sums the RGB kernels; N
    channels cycle them, scaled by 3 / N so activations keep their size."""
    c_in = weight.shape[1]
    if in_channels == c_in:
        return weight
    if in_channels == 1:
        return weight.sum(dim=1, keepdim=True)
    reps = -(-in_channels // c_in)
    tiled = weight.repeat(1, reps, 1, 1)[:, :in_channels]
    return tiled * (c_in / in_channels) if rescale else tiled


def convert_resnet(state: Mapping[str, torch.Tensor], in_channels: int = 3) -> dict[str, torch.Tensor]:
    """torchvision / smp ResNet -> the port ``ResNetEncoder``'s tensors: the
    stem, every block's convs, BatchNorms and downsample (the ``fc`` head and
    ``num_batches_tracked`` are left out)."""
    out = {"conv1.weight": patch_first_conv(state["conv1.weight"], in_channels)}
    out.update({f"bn1.{k}": state[f"bn1.{k}"] for k in _BN})
    block = re.compile(r"^layer\d\.\d+\.(.+)$")
    for key, value in state.items():
        m = block.match(key)
        if m is None:
            continue
        rest = m.group(1)
        if (rest.startswith("conv") and rest.endswith("weight")) or rest == "downsample.0.weight":
            out[key] = value
        elif (rest.startswith("bn") and rest.endswith("weight")) or rest == "downsample.1.weight":
            prefix = key[: -len("weight")]
            out.update({prefix + k: state[prefix + k] for k in _BN})
    return out


_MIT_INNER = ("norm1", "norm2", "attn.q", "attn.kv", "attn.proj", "attn.sr", "attn.norm",
              "mlp.fc1", "mlp.fc2", "mlp.dwconv.dwconv")


def convert_mit(state: Mapping[str, torch.Tensor], in_channels: int = 3) -> dict[str, torch.Tensor]:
    """Official / smp SegFormer MiT -> the port ``MixVisionTransformer``'s
    tensors (the first patch embedding re-plumbed for ``in_channels``)."""
    out = {}
    for s in range(1, 5):
        proj = state[f"patch_embed{s}.proj.weight"]
        out[f"patch_embed{s}.proj.weight"] = patch_first_conv(proj, in_channels) if s == 1 else proj
        for key in (f"patch_embed{s}.proj.bias", f"patch_embed{s}.norm.weight",
                    f"patch_embed{s}.norm.bias", f"norm{s}.weight", f"norm{s}.bias"):
            out[key] = state[key]
    block = re.compile(r"^block(\d)\.(\d+)\.(.+)\.(weight|bias)$")
    for key, value in state.items():
        m = block.match(key)
        if m is not None and m.group(3) in _MIT_INNER:
            out[key] = value
    return out


def remap_hf_dofa(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """A raw HuggingFace DOFA artifact -> the reference's post-remap layout
    (``dofa_v2.py:306-323``): ``model.``-prefixed keys are kept, unprefixed,
    only for ``blocks.*``, ``norm.*``, ``cls_token`` and ``pos_embed`` (the
    artifact's pretraining heads go); unprefixed keys pass through."""
    out = {}
    for key, value in state.items():
        if key.startswith("model."):
            key = key[6:]
            if not (key.startswith(("blocks.", "norm.")) or key in ("cls_token", "pos_embed")):
                continue
        out[key] = value
    return out


_DOFA_BLOCK = ("norm1.weight", "norm1.bias", "norm2.weight", "norm2.bias", "ls1.gamma",
               "ls2.gamma", "mlp.fc1.weight", "mlp.fc1.bias", "mlp.fc2.weight", "mlp.fc2.bias",
               "attn.qkv.weight", "attn.qkv.bias", "attn.proj.weight", "attn.proj.bias")


def convert_dofa(state: Mapping[str, torch.Tensor]) -> dict[str, torch.Tensor]:
    """DOFA v2 (raw HF artifact or the reference's layout) -> the port
    ``DOFAv2``'s tensors, plus the artifact's ``pos_embed`` table as a side
    entry. Linear layers need their weight; a bias is taken when present."""
    state = remap_hf_dofa(state)
    out = {}

    def take(*keys: str) -> None:
        out.update({k: state[k] for k in keys})

    def dense(src: str) -> None:
        take(f"{src}.weight")
        if f"{src}.bias" in state:
            take(f"{src}.bias")

    wg = "patch_embed.weight_generator"
    tl = f"{wg}.transformer_encoder.layers.0"
    take(f"{wg}.weight_tokens", f"{wg}.bias_token", f"{tl}.self_attn.in_proj_weight",
         f"{tl}.self_attn.in_proj_bias", f"{tl}.self_attn.out_proj.weight",
         f"{tl}.self_attn.out_proj.bias", f"{tl}.norm1.weight", f"{tl}.norm1.bias",
         f"{tl}.norm2.weight", f"{tl}.norm2.bias", "cls_token")
    for src in (f"{wg}.fc_weight", f"{wg}.fc_bias", "patch_embed.fclayer.w1",
                "patch_embed.fclayer.w2", f"{tl}.linear1", f"{tl}.linear2"):
        dense(src)
    block = re.compile(r"^blocks\.\d+\.(.+)$")
    for key in state:
        m = block.match(key)
        if m is not None and m.group(1) in _DOFA_BLOCK:
            take(key)
    if "norm.weight" in state:
        take("norm.weight", "norm.bias")
    if "pos_embed" in state:
        take("pos_embed")
    return out


def load_pretrained_tree(path: str | Path, fmt: str = "resnet",
                         in_channels: int = 3) -> dict[str, torch.Tensor]:
    """A pretrained encoder file converted for ``fmt`` (resnet, mit, dofa)."""
    converters = {
        "resnet": lambda sd: convert_resnet(sd, in_channels),
        "mit": lambda sd: convert_mit(sd, in_channels),
        "dofa": convert_dofa,
    }
    if fmt not in converters:
        msg = f"unknown torch_weights format {fmt!r}; one of {sorted(converters)}"
        raise ValueError(msg)
    return converters[fmt](load_torch_state_dict(path))


def bicubic_matrix(out_size: int, in_size: int) -> np.ndarray:
    """``[out, in]`` row matrix of torch's ``interpolate(mode="bicubic",
    align_corners=False)``: cubic convolution with a = -0.75, half-pixel
    source coordinates, indices clamped at the borders."""
    a = -0.75

    def w(x: float) -> float:
        x = abs(x)
        if x <= 1.0:
            return (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0
        if x < 2.0:
            return a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a
        return 0.0

    m = np.zeros((out_size, in_size), np.float64)
    for o in range(out_size):
        src = (o + 0.5) * in_size / out_size - 0.5
        i = int(np.floor(src))
        t = src - i
        for k in range(-1, 3):
            m[o, min(max(i + k, 0), in_size - 1)] += w(k - t)
    return m


def resize_pos_embed(pos_embed: np.ndarray, num_patches: int) -> np.ndarray:
    """A ``[1, 1 + g^2, D]`` ViT position table resized to ``num_patches``
    grid rows (square grids): the cls row is kept, the grid resized bicubic
    (reference ``dofa_v2.py:349-392``)."""
    pos_embed = np.asarray(pos_embed)
    if pos_embed.shape[1] == num_patches + 1:
        return pos_embed
    grid = pos_embed[:, 1:, :]
    old_g, new_g = int(round(grid.shape[1] ** 0.5)), int(round(num_patches**0.5))
    if old_g != new_g:
        d = grid.shape[-1]
        m = bicubic_matrix(new_g, old_g)
        g2 = np.einsum("oi,ijd->ojd", m, grid.reshape(old_g, old_g, d).astype(np.float64))
        g2 = np.einsum("pj,ojd->opd", m, g2)
        grid = g2.reshape(1, new_g * new_g, d).astype(pos_embed.dtype)
    return np.concatenate([pos_embed[:, :1, :], grid], axis=1)


def merge_pretrained(model: torch.nn.Module, converted: Mapping[str, torch.Tensor],
                     subtree: str = "encoder") -> list[str]:
    """Copy converted encoder tensors into ``model`` under ``subtree``.

    Every tensor must name one of the model's (``KeyError`` otherwise) with
    the same shape (``ValueError``). A ``pos_embed`` side entry is resized to
    the ``{subtree}.pos_embed`` buffer's grid where the model has that
    buffer. Returns the names written."""
    own = model.state_dict()
    prefix = f"{subtree}." if subtree else ""
    written = []
    with torch.no_grad():
        for key, value in converted.items():
            name = prefix + key
            if key == "pos_embed":
                if name in own:
                    table = resize_pos_embed(value.float().numpy(), own[name].shape[1] - 1)
                    own[name].copy_(torch.from_numpy(table))
                    written.append(name)
                continue
            if name not in own:
                msg = f"pretrained tensor {name} missing in model"
                raise KeyError(msg)
            if tuple(own[name].shape) != tuple(value.shape):
                msg = (f"shape mismatch at {name}: model {tuple(own[name].shape)} vs "
                       f"checkpoint {tuple(value.shape)}")
                raise ValueError(msg)
            own[name].copy_(value)
            written.append(name)
    return written
