"""Plain DOFA v2 ViT + MultiLevelNeck + UperNet + FCN aux head (f32, NCHW).

From the DOFA paper (Xiong et al. 2024, arXiv:2403.15356) and its v2
code's description: the patch-embedding kernel is generated from the
bands' wavelengths (sin/cos embedding of lambda x 1000, a residual MLP, a
one-layer post-norm transformer over [128 weight tokens | wave tokens |
bias token], linear maps to a ``[C, k, k, D]`` kernel and a ``[D]`` bias,
both times 0.01, a stride-k conv with padding 1); then pre-norm ViT blocks
with LayerScale over [cls | tokens + fixed 2-D sin/cos positions]; the
tapped blocks' token maps feed a neck (per level a 1x1 ConvModule, a
bilinear rescale by 4, 2, 1, 0.5 and a 3x3 ConvModule), UperNet (pooling
pyramid 1, 2, 3, 6 on the last level, 3x3 bottleneck, 1x1 laterals,
top-down sums, 3x3 FPN convs, everything resized to the finest level,
concatenated and fused by a 3x3 ConvModule), a 1x1 classifier, and an FCN
aux head (3x3 ConvModule, 1x1 classifier) on the last level; both logits
resized to the input. The resize-then-conv of the neck is computed as
written, not in the program's factored form. Parameters are a dict under
the port's parameter names; nothing of the program is imported.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from gdl_bench.reference.common import (
    conv_module,
    gelu,
    layer_norm,
    resize,
)

E = "encoder"
PE = "encoder.patch_embed"
WG = "encoder.patch_embed.weight_generator"
TL = "encoder.patch_embed.weight_generator.transformer_encoder.layers.0"


def sincos_1d(dim: int, pos: torch.Tensor) -> torch.Tensor:
    omega = torch.arange(dim // 2, dtype=torch.float64, device=pos.device) / (dim / 2.0)
    omega = 1.0 / 10000.0 ** omega
    out = pos.reshape(-1, 1).double() * omega[None]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1).to(pos.dtype)


def sincos_2d(dim: int, grid: int) -> np.ndarray:
    """``[grid * grid, dim]``: the row coordinate's 1-D table, then the
    column's, each over half the width."""
    def emb(d, pos):
        omega = 1.0 / 10000.0 ** (np.arange(d // 2, dtype=np.float64) / (d / 2.0))
        out = pos.reshape(-1)[:, None] * omega[None]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    rows, cols = np.meshgrid(np.arange(grid, dtype=np.float64), np.arange(grid, dtype=np.float64),
                             indexing="ij")
    return np.concatenate([emb(dim // 2, rows), emb(dim // 2, cols)], axis=1).astype(np.float32)


def token_grid(image_size: int, patch: int) -> int:
    return (image_size + 2 - patch) // patch + 1


def _self_attention(M, P, x, heads: int) -> torch.Tensor:
    n, l, d = x.shape
    hd = d // heads
    qkv = M.linear(x, P[f"{TL}.self_attn.in_proj_weight"], P[f"{TL}.self_attn.in_proj_bias"])
    q, k, v = (t.reshape(n, l, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    w = torch.softmax(M.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    o = M.matmul(w, v).transpose(1, 2).reshape(n, l, d)
    return M.linear(o, P[f"{TL}.self_attn.out_proj.weight"], P[f"{TL}.self_attn.out_proj.bias"])


def patch_kernel(M, P: dict, cfg: dict, wavelengths: torch.Tensor):
    """The generated patch-embedding conv: ``([D, C, k, k], [D])``."""
    k, d, dd = cfg["patch_size"], cfg["embed_dim"], cfg["dynamic_embed_dim"]
    waves = sincos_1d(dd, wavelengths * 1000.0)
    h = torch.relu(M.linear(waves, P[f"{PE}.fclayer.w1.weight"], P[f"{PE}.fclayer.w1.bias"]))
    waves = waves + torch.relu(M.linear(h, P[f"{PE}.fclayer.w2.weight"],
                                        P[f"{PE}.fclayer.w2.bias"]))
    x = torch.cat([P[f"{WG}.weight_tokens"], waves, P[f"{WG}.bias_token"]])[None]
    ln = cfg["ln_eps"]
    x = layer_norm(x + _self_attention(M, P, x, cfg["generator_heads"]),
                   P[f"{TL}.norm1.weight"], P[f"{TL}.norm1.bias"], ln)
    ff = M.linear(gelu(M.linear(x, P[f"{TL}.linear1.weight"], P[f"{TL}.linear1.bias"])),
                  P[f"{TL}.linear2.weight"], P[f"{TL}.linear2.bias"])
    x = layer_norm(x + ff, P[f"{TL}.norm2.weight"], P[f"{TL}.norm2.bias"], ln)[0]
    nt = P[f"{WG}.weight_tokens"].shape[0]
    wave_out = x[nt: nt + waves.shape[0]]
    weight = M.linear(wave_out + waves, P[f"{WG}.fc_weight.weight"], P[f"{WG}.fc_weight.bias"])
    bias = M.linear(x[-1], P[f"{WG}.fc_bias.weight"], P[f"{WG}.fc_bias.bias"])
    weight = weight.reshape(-1, k, k, d).permute(3, 0, 1, 2) * cfg["embed_scaler"]
    return weight, bias * cfg["embed_scaler"]


def _block(M, P: dict, cfg: dict, i: int, x: torch.Tensor) -> torch.Tensor:
    b = f"{E}.blocks.{i}"
    n, l, d = x.shape
    heads = cfg["num_heads"]
    hd = d // heads
    ln = cfg["ln_eps"]
    y = layer_norm(x, P[f"{b}.norm1.weight"], P[f"{b}.norm1.bias"], ln)
    qkv = M.linear(y, P[f"{b}.attn.qkv.weight"], P[f"{b}.attn.qkv.bias"])
    q, k, v = (t.reshape(n, l, heads, hd).transpose(1, 2) for t in qkv.chunk(3, dim=-1))
    p = torch.softmax(M.matmul(q, k.transpose(-1, -2)) / math.sqrt(hd), dim=-1)
    o = M.matmul(p, v).transpose(1, 2).reshape(n, l, d)
    x = x + P[f"{b}.ls1.gamma"] * M.linear(o, P[f"{b}.attn.proj.weight"], P[f"{b}.attn.proj.bias"])
    y = layer_norm(x, P[f"{b}.norm2.weight"], P[f"{b}.norm2.bias"], ln)
    y = M.linear(gelu(M.linear(y, P[f"{b}.mlp.fc1.weight"], P[f"{b}.mlp.fc1.bias"])),
                 P[f"{b}.mlp.fc2.weight"], P[f"{b}.mlp.fc2.bias"])
    return x + P[f"{b}.ls2.gamma"] * y


def encoder(M, P: dict, cfg: dict, x: torch.Tensor, wavelengths: torch.Tensor,
            ckpt: bool) -> list[torch.Tensor]:
    weight, bias = patch_kernel(M, P, cfg, wavelengths)
    tokens = M.conv2d(x, weight, bias, stride=cfg["patch_size"], padding=1)
    n, d, g, _ = tokens.shape
    seq = tokens.flatten(2).transpose(1, 2) + P[f"{E}.pos_embed"][:, 1:]
    seq = torch.cat([P[f"{E}.cls_token"].expand(n, -1, -1), seq], dim=1)
    feats = []
    for i in range(cfg["depth"]):
        if ckpt:
            seq = checkpoint(_block, M, P, cfg, i, seq, use_reentrant=False)
        else:
            seq = _block(M, P, cfg, i, seq)
        if i in cfg["out_indices"]:
            feats.append(seq[:, 1:].transpose(1, 2).reshape(n, d, g, g))
    return feats


def neck(M, P: dict, cfg: dict, feats: list, train: bool) -> list[torch.Tensor]:
    outs = []
    for i, (x, s) in enumerate(zip(feats, cfg["neck_scales"])):
        x = conv_module(M, P, f"neck.lateral_convs.{i}", x, 1, train)
        if s != 1:
            x = resize(x, (int(x.shape[-2] * s), int(x.shape[-1] * s)))
        outs.append(conv_module(M, P, f"neck.convs.{i}", x, 3, train))
    return outs


def upernet(M, P: dict, cfg: dict, feats: list, train: bool) -> torch.Tensor:
    top = feats[-1]
    ppm = []
    for j, s in enumerate(cfg["pool_scales"]):
        y = torch.nn.functional.adaptive_avg_pool2d(top, s)
        y = conv_module(M, P, f"decoder.psp_modules.{j}.1", y, 1, train)
        ppm.append(resize(y, top.shape[-2:]))
    lat = [conv_module(M, P, f"decoder.lateral_convs.{i}", x, 1, train)
           for i, x in enumerate(feats[:-1])]
    lat.append(conv_module(M, P, "decoder.bottleneck", torch.cat([top, *ppm], dim=1), 3, train))
    for i in range(len(lat) - 1, 0, -1):
        lat[i - 1] = lat[i - 1] + resize(lat[i], lat[i - 1].shape[-2:])
    outs = [conv_module(M, P, f"decoder.fpn_convs.{i}", lat[i], 3, train)
            for i in range(len(lat) - 1)] + [lat[-1]]
    outs = [resize(o, outs[0].shape[-2:]) for o in outs]
    return conv_module(M, P, "decoder.fpn_bottleneck", torch.cat(outs, dim=1), 3, train)


def forward(M, P: dict, cfg: dict, x: torch.Tensor, train: bool, ckpt: bool = False):
    """NCHW f32 image -> (logits, aux logits), both ``[B, K, H, W]``."""
    wavelengths = torch.as_tensor(cfg["wavelengths"], dtype=x.dtype, device=x.device)
    feats = neck(M, P, cfg, encoder(M, P, cfg, x, wavelengths, ckpt), train)
    dec = upernet(M, P, cfg, feats, train)
    out = M.conv2d(dec, P["head.conv.weight"], P["head.conv.bias"])
    a = conv_module(M, P, "aux_head.convs.0", feats[-1], 3, train)
    aux = M.conv2d(a, P["aux_head.cls_seg.weight"], P["aux_head.cls_seg.bias"])
    size = x.shape[-2:]
    return resize(out, size), resize(aux, size)


def buffers(cfg: dict) -> dict[str, np.ndarray]:
    """Fixed tables the model holds as state: the position table (its cls
    row zero)."""
    g = token_grid(cfg["image_size"], cfg["patch_size"])
    pe = np.zeros((1, 1 + g * g, cfg["embed_dim"]), np.float32)
    pe[0, 1:] = sincos_2d(cfg["embed_dim"], g)
    return {f"{E}.pos_embed": pe}

