"""Plain SegFormer: MiT encoder + all-MLP decoder (f32, NCHW).

From the SegFormer paper (Xie et al. 2021, arXiv:2105.15203): four stages,
each an overlapping patch embedding (a strided conv, 7x7 stride 4 then 3x3
stride 2, and a LayerNorm) and pre-norm blocks of efficient self-attention
(keys and values from the tokens reduced by a stride-R conv and a
LayerNorm) and a Mix-FFN (Linear, depthwise 3x3 conv, GELU, Linear),
closed by a LayerNorm; the decoder projects each stage to one width,
resizes to the finest stage, concatenates in [c4, c3, c2, c1] order and
fuses with a 1x1 conv, BatchNorm and ReLU before the 1x1 classifier; the
logits are resized to the input. Dropout is off in the configurations.
Parameters are a dict under the port's parameter names; nothing of the
program is imported.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from gdl_bench.reference.common import batch_norm, gelu, layer_norm, resize

E = "encoder"


def _map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    return x.transpose(1, 2).reshape(x.shape[0], x.shape[2], h, w)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    return x.flatten(2).transpose(1, 2)


def _ln(P, name, x, eps):
    return layer_norm(x, P[f"{name}.weight"], P[f"{name}.bias"], eps)


def _block(M, P: dict, cfg: dict, s: int, i: int, x: torch.Tensor, h: int, w: int):
    b = f"{E}.block{s + 1}.{i}"
    eps = cfg["ln_eps"]
    heads, sr = cfg["num_heads"][s], cfg["sr_ratios"][s]
    n, l, c = x.shape
    hd = c // heads
    y = _ln(P, f"{b}.norm1", x, eps)
    q = M.linear(y, P[f"{b}.attn.q.weight"], P[f"{b}.attn.q.bias"])
    src = y
    if sr > 1:
        r = M.conv2d(_map(y, h, w), P[f"{b}.attn.sr.weight"], P[f"{b}.attn.sr.bias"], stride=sr)
        src = _ln(P, f"{b}.attn.norm", _tokens(r), eps)
    kv = M.linear(src, P[f"{b}.attn.kv.weight"], P[f"{b}.attn.kv.bias"])
    k, v = kv.reshape(n, -1, 2, heads, hd).unbind(2)
    q = q.reshape(n, l, heads, hd).transpose(1, 2)
    k, v = k.transpose(1, 2), v.transpose(1, 2)
    p = torch.softmax(M.matmul(q, k.transpose(-1, -2)) * hd ** -0.5, dim=-1)
    o = M.matmul(p, v).transpose(1, 2).reshape(n, l, c)
    x = x + M.linear(o, P[f"{b}.attn.proj.weight"], P[f"{b}.attn.proj.bias"])
    y = M.linear(_ln(P, f"{b}.norm2", x, eps), P[f"{b}.mlp.fc1.weight"], P[f"{b}.mlp.fc1.bias"])
    dw = P[f"{b}.mlp.dwconv.dwconv.weight"]
    y = _tokens(M.conv2d(_map(y, h, w), dw, P[f"{b}.mlp.dwconv.dwconv.bias"], padding=1,
                         groups=dw.shape[0]))
    y = M.linear(gelu(y), P[f"{b}.mlp.fc2.weight"], P[f"{b}.mlp.fc2.bias"])
    return x + y


def encoder(M, P: dict, cfg: dict, x: torch.Tensor, ckpt: bool) -> list[torch.Tensor]:
    outs = []
    for s in range(4):
        pe = f"{E}.patch_embed{s + 1}"
        k = 7 if s == 0 else 3
        x = M.conv2d(x, P[f"{pe}.proj.weight"], P[f"{pe}.proj.bias"], stride=4 if s == 0 else 2,
                     padding=k // 2)
        h, w = x.shape[-2:]
        t = _ln(P, f"{pe}.norm", _tokens(x), cfg["ln_eps"])
        for i in range(cfg["depths"][s]):
            if ckpt:
                t = checkpoint(_block, M, P, cfg, s, i, t, h, w, use_reentrant=False)
            else:
                t = _block(M, P, cfg, s, i, t, h, w)
        x = _map(_ln(P, f"{E}.norm{s + 1}", t, cfg["ln_eps"]), h, w)
        outs.append(x)
    return outs


def decoder(M, P: dict, feats: list, train: bool) -> torch.Tensor:
    size = feats[0].shape[-2:]
    proj = []
    for i in (4, 3, 2, 1):
        f = feats[i - 1]
        y = M.linear(_tokens(f), P[f"decoder.linear_c{i}.proj.weight"],
                     P[f"decoder.linear_c{i}.proj.bias"])
        proj.append(resize(_map(y, *f.shape[-2:]), size))
    x = M.conv2d(torch.cat(proj, dim=1), P["decoder.linear_fuse.0.weight"])
    x = torch.relu(batch_norm(x, P, "decoder.linear_fuse.1", train))
    return M.conv2d(x, P["decoder.linear_pred.weight"], P["decoder.linear_pred.bias"])


def forward(M, P: dict, cfg: dict, x: torch.Tensor, train: bool, ckpt: bool = False):
    """NCHW f32 image -> (logits ``[B, K, H, W]``, None)."""
    return resize(decoder(M, P, encoder(M, P, cfg, x, ckpt), train), x.shape[-2:]), None


def buffers(cfg: dict) -> dict:
    return {}
