"""Operations of SegFormer (MiT encoder + all-MLP decoder), by shape.

Counted as ``dofa_upernet`` counts: matrix products and convolutions
once, 2 operations a multiply-add, the backward twice the forward except
the image's patch conv (weight gradient only).
"""

from __future__ import annotations

from gdl_bench.counts import kernels


def _conv(hw: int, cin: int, cout: int, k: int, groups: int = 1) -> float:
    return 2.0 * hw * cin * cout * k * k / groups


def _stages(cfg: dict):
    """``(tokens, width, key/value tokens, heads, sr, depth)`` per stage."""
    side = cfg["image_size"] // 4
    for s in range(4):
        sr = cfg["sr_ratios"][s]
        yield side * side, cfg["embed_dims"][s], (side // sr) ** 2, cfg["num_heads"][s], sr, \
            cfg["depths"][s], side
        side //= 2


def parts(cfg: dict) -> list[tuple[str, float, float]]:
    """``(part, forward operations a patch, backward / forward)``."""
    out = []
    cin = cfg["in_channels"]
    for s, (n, c, lk, _, sr, depth, _) in enumerate(_stages(cfg)):
        k = 7 if s == 0 else 3
        out.append((f"stage{s + 1}.patch_embed", _conv(n, cin, c, k), 1.0 if s == 0 else 2.0))
        hid = int(c * cfg["mlp_ratio"])
        lin = 2.0 * n * c * c * 2 + 2.0 * lk * c * 2 * c + 2 * 2.0 * n * c * hid
        if sr > 1:
            lin += _conv(lk, c, c, sr)
        lin += _conv(n, hid, hid, 3, groups=hid)
        out.append((f"stage{s + 1}.blocks.linear", depth * lin, 2.0))
        out.append((f"stage{s + 1}.blocks.attention", depth * 2 * 2.0 * n * lk * c, 2.0))
        cin = c
    e = cfg["decoder_dim"]
    fine = (cfg["image_size"] // 4) ** 2
    proj = sum(2.0 * n * c * e for n, c, *_ in _stages(cfg))
    out.append(("decoder.linear_c", proj, 2.0))
    out.append(("decoder.linear_fuse", _conv(fine, 4 * e, e, 1), 2.0))
    out.append(("decoder.linear_pred", _conv(fine, e, cfg["num_classes"], 1), 2.0))
    return out


def train_flops(cfg: dict, batch: int) -> float:
    return batch * sum(f * (1.0 + r) for _, f, r in parts(cfg))


def forward_flops(cfg: dict, batch: int) -> float:
    return batch * sum(f for _, f, _ in parts(cfg))


def sr_attention_calls(cfg: dict, batch: int):
    """``(b, h, lq, lk, d)`` of each block whose attention takes K10: the
    program's rule (the JAX package's), Lq a multiple of 512, Lk of 8, and
    the f32 K/V plus one 512-row score tile within 8 MiB."""
    for n, c, lk, heads, _, depth, _ in _stages(cfg):
        d = c // heads
        if n % 512 == 0 and lk % 8 == 0 and 4 * (2 * lk * d + 512 * lk + 2 * 512 * d) <= 2 ** 23:
            yield from [(batch, heads, n, lk, d)] * depth


def attention(cfg: dict, batch: int, train: bool) -> list[dict]:
    """Kernel records of the SR attention calls that run K10 (and, in
    training, their backward) for one call of ``batch`` patches."""
    recs = []
    for shape in sr_attention_calls(cfg, batch):
        recs.append(kernels.sr_attention_fwd(*shape))
        if train:
            recs.append(kernels.sr_attention_bwd(*shape))
    return recs
