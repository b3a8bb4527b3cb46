"""Operations of DOFA v2 + MultiLevelNeck + UperNet + FCN aux, by shape.

What the configuration's math needs, counted once (2 operations a
multiply-add, matrix products and convolutions only): no recomputation,
no padding. The neck's x2 / x4 resize + 3x3 conv and UperNet's resized
parts of its last conv are counted in the factored form the program runs
(``ops/fused_upconv.py``), which is exact and smaller than the resized
map's conv: a channel GEMM at the source size and two thin products with
the tap matrices. The backward of a product is twice its forward (input
and weight gradients) except where one side needs no gradient: the
image's patch conv (weight gradient only) and the thin products, whose
tap matrices are constants (input gradient only).
"""

from __future__ import annotations

from gdl_bench.counts import kernels


def _grid(cfg: dict) -> int:
    return (cfg["image_size"] + 2 - cfg["patch_size"]) // cfg["patch_size"] + 1


def _conv(hw: int, cin: int, cout: int, k: int) -> float:
    return 2.0 * hw * cin * cout * k * k


def _factored(h: int, oh: int, cin: int, cout: int) -> tuple[float, float]:
    """(channel GEMM, thin products) of the factored resize + 3x3 conv of a
    square ``h`` map to ``oh``."""
    gemm = 2.0 * h * h * cin * 9 * cout
    thin = 18.0 * h * oh * h * cout + 6.0 * oh * h * oh * cout
    return gemm, thin


def parts(cfg: dict) -> list[tuple[str, float, float]]:
    """``(part, forward operations a patch, backward / forward)``."""
    d, k, c = cfg["embed_dim"], cfg["patch_size"], cfg["in_channels"]
    g = _grid(cfg)
    n, l = g * g, g * g + 1
    hid = int(d * cfg["mlp_ratio"])
    ch, ncls = cfg["decoder_channels"], cfg["num_classes"]
    out = [("patch_embed", _conv(n, c, d, k), 1.0)]
    block = 2.0 * l * d * 3 * d + 2.0 * l * d * d + 2 * 2.0 * l * d * hid
    out.append(("blocks.linear", cfg["depth"] * block, 2.0))
    out.append(("blocks.attention", cfg["depth"] * 2 * 2.0 * l * l * d, 2.0))
    sizes = [int(g * s) for s in cfg["neck_scales"]]
    out.append(("neck.lateral", len(sizes) * _conv(n, d, d, 1), 2.0))
    for s, oh in zip(cfg["neck_scales"], sizes):
        if s in (2, 4):
            gemm, thin = _factored(g, oh, d, d)
            out += [(f"neck.x{s}.gemm", gemm, 2.0), (f"neck.x{s}.thin", thin, 1.0)]
        else:
            out.append((f"neck.x{s}", _conv(oh * oh, d, d, 3), 2.0))
    top = sizes[-1]
    pools = sum(p * p for p in cfg["pool_scales"])
    out.append(("upernet.ppm", _conv(pools, d, ch, 1), 2.0))
    out.append(("upernet.bottleneck",
                _conv(top * top, d + len(cfg["pool_scales"]) * ch, ch, 3), 2.0))
    out.append(("upernet.lateral", sum(_conv(s * s, d, ch, 1) for s in sizes[:-1]), 2.0))
    out.append(("upernet.fpn", sum(_conv(s * s, ch, ch, 3) for s in sizes[:-1]), 2.0))
    fine = sizes[0]
    out.append(("upernet.fuse.part0", _conv(fine * fine, ch, ch, 3), 2.0))
    for s in sizes[1:]:
        gemm, thin = _factored(s, fine, ch, ch)
        out += [(f"upernet.fuse.{s}.gemm", gemm, 2.0), (f"upernet.fuse.{s}.thin", thin, 1.0)]
    out.append(("head", _conv(fine * fine, ch, ncls, 1), 2.0))
    out.append(("aux", _conv(top * top, d, cfg["aux_channels"], 3)
                + _conv(top * top, cfg["aux_channels"], ncls, 1), 2.0))
    return out


def generator_flops(cfg: dict) -> float:
    """The patch-kernel generator's forward, once a call (batch-constant)."""
    dd, c = cfg["dynamic_embed_dim"], cfg["in_channels"]
    t = cfg["generator_tokens"] + c + 1
    ffn = cfg["generator_ffn"]
    return (2 * 2.0 * c * dd * dd + 2.0 * t * dd * 3 * dd + 2 * 2.0 * t * t * dd
            + 2.0 * t * dd * dd + 2 * 2.0 * t * dd * ffn
            + 2.0 * c * dd * cfg["patch_size"] ** 2 * cfg["embed_dim"]
            + 2.0 * dd * cfg["embed_dim"])


def train_flops(cfg: dict, batch: int) -> float:
    """Operations of one train step of ``batch`` patches (forward + backward)."""
    return batch * sum(f * (1.0 + r) for _, f, r in parts(cfg)) + 3.0 * generator_flops(cfg)


def forward_flops(cfg: dict, batch: int) -> float:
    """Operations of one forward of ``batch`` patches."""
    return batch * sum(f for _, f, _ in parts(cfg)) + generator_flops(cfg)


def attention(cfg: dict, batch: int, train: bool) -> list[dict]:
    """The kernel records of the blocks' attention for one call of
    ``batch`` patches: K4 per block, and K7 per block in training."""
    l = _grid(cfg) ** 2 + 1
    h = cfg["num_heads"]
    hd = cfg["embed_dim"] // h
    recs = [kernels.attention_fwd_packed(batch, l, h, hd)] * cfg["depth"]
    if train:
        recs += [kernels.attention_bwd_packed(batch, l, h, hd)] * cfg["depth"]
    return recs
