"""MixTransformer (MiT) encoder, the SegFormer backbone.

Port of ``geo_deep_learning_tpu/models/encoders/mix_transformer.py``
(reference ``models/encoders/mix_transformer.py``): four stages of
``OverlapPatchEmbed`` (7/4 then 3/2 convs, symmetric ``k // 2`` padding)
and transformer blocks with spatial-reduction attention (a VALID
``sr_ratio``-strided conv + LayerNorm shrinks K/V) and Mix-FFN (depthwise
3x3 between the two Linears), a LayerNorm per stage, variants b0-b5, and
the channel-count-agnostic ``DynamicChannelEmbed``.

Layouts: convolutions take NCHW, tokens between them are ``[B, L, C]``.
On the card the model is channels-last, so a token tensor viewed as
``[B, H, W, C]`` and permuted to NCHW is already the conv's layout and
the round trips are views, not copies. Attention goes through
:func:`ops.cuda.sr_attention.sr_attention` (kernel K10 where the JAX
package's shape rule admits it, the einsum elsewhere); q, k and v are
views of their projections' outputs.

Tensor parallelism (``parallel.placement.place_state``): a block whose
heads (attention) or hidden width (Mix-FFN) the model axis divides takes
this rank's share of ``q``, ``kv``, ``fc1`` and the depthwise conv
(column-parallel, after :func:`parallel.collectives.copy_to_model`) and
of ``proj`` and ``fc2`` (row-parallel,
:func:`parallel.collectives.row_parallel_linear`); K10 sees the local
heads. Other blocks stay replicated.

As in the JAX package: GELU is the tanh approximation (flax's default),
every LayerNorm is a plain one with ``eps = 1e-6`` (MiT widths never reach
the LayerNorm kernels), DropPath rates follow
``linspace(0, drop_path_rate, sum(depths))``, and attention-probability
dropout (never set by a config) is plain PyTorch math. Parameter names are
the reference's torch names, the ones ``convert_mit`` consumes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geo_deep_learning_tpu_torch.models.layers import (
    DropPath,
    Dropout,
    checkpointed,
    init_torch_default,
)
from geo_deep_learning_tpu_torch.ops.cuda.sr_attention import sr_attention
from geo_deep_learning_tpu_torch.parallel.collectives import copy_to_model, row_parallel_linear

LN_EPS = 1e-6
# flax's truncated_normal(stddev) draws N(0, 1) cut at +-2 and scales it by
# stddev / (the std of that cut distribution)
_TRUNC_STD = 0.87962566103423978


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # flax's nn.gelu default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def _to_map(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Tokens ``[B, H*W, C]`` -> NCHW map (a channels-last view)."""
    return x.unflatten(1, (h, w)).permute(0, 3, 1, 2)


def _to_tokens(x: torch.Tensor) -> torch.Tensor:
    """NCHW map -> tokens ``[B, H*W, C]`` (a view of a channels-last map)."""
    return x.permute(0, 2, 3, 1).flatten(1, 2)


class DWConv(nn.Module):
    """Depthwise 3x3 conv with 'SAME' padding (reference ``DWConv``)."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.dwconv = nn.Conv2d(dim, dim, 3, padding=1, groups=dim)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        return _to_tokens(self.dwconv(_to_map(x, h, w)))


class MixFFN(nn.Module):
    """Linear -> depthwise 3x3 -> GELU -> Linear (reference Mlp + DWConv).
    Sharded (``tp``), ``fc1`` and the depthwise conv hold this rank's hidden
    channels and ``fc2`` their input columns."""

    def __init__(self, dim: int, hidden: int, drop: float = 0.0) -> None:
        super().__init__()
        self.tp_divisor = hidden
        self.fc1 = nn.Linear(dim, hidden)
        self.dwconv = DWConv(hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = Dropout(drop)
        self.tp = None

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        if self.tp is None:
            x = self.drop(_gelu(self.dwconv(self.fc1(x), h, w)))
            return self.drop(self.fc2(x))
        group = self.tp.model_group
        x = self.drop(_gelu(self.dwconv(self.fc1(copy_to_model(x, group)), h, w)))
        return self.drop(row_parallel_linear(x, self.fc2.weight, self.fc2.bias, group))


class SRAttention(nn.Module):
    """Multi-head attention over K/V downsampled by a ``sr_ratio``-strided
    conv + LayerNorm (reference ``Attention``). Sharded (``tp``), ``q`` and
    ``kv`` hold this rank's heads (``kv`` head-aligned within k and v) and
    ``proj`` their input columns; ``sr`` and its norm, which act before
    ``kv``, stay replicated."""

    def __init__(
        self, dim: int, num_heads: int, sr_ratio: int = 1, qkv_bias: bool = True,
        attn_drop: float = 0.0, proj_drop: float = 0.0,
    ) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.tp_divisor = num_heads
        self.tp = None
        self.sr_ratio = sr_ratio
        self.scale = (dim // num_heads) ** -0.5
        self.q = nn.Linear(dim, dim, bias=qkv_bias)
        self.kv = nn.Linear(dim, 2 * dim, bias=qkv_bias)
        self.proj = nn.Linear(dim, dim)
        if sr_ratio > 1:
            self.sr = nn.Conv2d(dim, dim, sr_ratio, stride=sr_ratio)
            self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn_drop = Dropout(attn_drop)
        self.proj_drop = Dropout(proj_drop)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        b, l, c = x.shape
        hd = c // self.num_heads
        group = None if self.tp is None else self.tp.model_group
        heads = self.num_heads if group is None else self.num_heads // self.tp.model_size
        xq = x if group is None else copy_to_model(x, group)
        q = self.q(xq).unflatten(-1, (heads, hd))  # [B, L, H, hd]
        kv_src = xq
        if self.sr_ratio > 1:
            kv_src = self.norm(_to_tokens(self.sr(_to_map(x, h, w))))
            kv_src = kv_src if group is None else copy_to_model(kv_src, group)
        kv = self.kv(kv_src).unflatten(-1, (2, heads, hd))  # [B, Lk, 2, H, hd]
        k, v = kv[:, :, 0], kv[:, :, 1]
        if self.attn_drop.rate > 0 and self.training:
            # dropout on the probabilities needs the whole matrix
            attn = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k) * self.scale, dim=-1)
            out = torch.einsum("bhqk,bkhd->bqhd", self.attn_drop(attn), v)
        else:
            o = sr_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2), self.scale)
            out = o.transpose(1, 2)
        out = out.reshape(b, l, heads * hd)
        if group is None:
            return self.proj_drop(self.proj(out))
        return self.proj_drop(row_parallel_linear(out, self.proj.weight, self.proj.bias, group))


class MiTBlock(nn.Module):
    def __init__(
        self, dim: int, num_heads: int, mlp_ratio: float = 4.0, sr_ratio: int = 1,
        qkv_bias: bool = True, drop: float = 0.0, attn_drop: float = 0.0, drop_path: float = 0.0,
    ) -> None:
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.attn = SRAttention(dim, num_heads, sr_ratio, qkv_bias, attn_drop, drop)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp = MixFFN(dim, int(dim * mlp_ratio), drop)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, h: int, w: int) -> torch.Tensor:
        x = x + self.drop_path1(self.attn(self.norm1(x), h, w))
        return x + self.drop_path2(self.mlp(self.norm2(x), h, w))


class OverlapPatchEmbed(nn.Module):
    """Strided overlapping conv + LayerNorm -> ``(tokens, h, w)``."""

    def __init__(self, in_channels: int, embed_dim: int, patch_size: int = 7, stride: int = 4) -> None:
        super().__init__()
        self.proj = nn.Conv2d(in_channels, embed_dim, patch_size, stride=stride,
                              padding=patch_size // 2)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        x = self.proj(x)
        h, w = x.shape[-2:]
        return self.norm(_to_tokens(x)), h, w


@dataclass(frozen=True)
class MiTConfig:
    embed_dims: tuple[int, ...] = (64, 128, 320, 512)
    num_heads: tuple[int, ...] = (1, 2, 5, 8)
    mlp_ratios: tuple[float, ...] = (4, 4, 4, 4)
    depths: tuple[int, ...] = (2, 2, 2, 2)
    sr_ratios: tuple[int, ...] = (8, 4, 2, 1)
    qkv_bias: bool = True
    drop_rate: float = 0.0
    drop_path_rate: float = 0.1


mit_configs: dict[str, MiTConfig] = {
    "mit_b0": MiTConfig(embed_dims=(32, 64, 160, 256)),
    "mit_b1": MiTConfig(),
    "mit_b2": MiTConfig(depths=(3, 4, 6, 3)),
    "mit_b3": MiTConfig(depths=(3, 4, 18, 3)),
    "mit_b4": MiTConfig(depths=(3, 8, 27, 3)),
    "mit_b5": MiTConfig(depths=(3, 6, 40, 3)),
}


def _stage_blocks(cfg: MiTConfig, stage: int, dpr: np.ndarray) -> nn.ModuleList:
    cur = sum(cfg.depths[:stage])
    return nn.ModuleList(
        MiTBlock(cfg.embed_dims[stage], cfg.num_heads[stage], cfg.mlp_ratios[stage],
                 cfg.sr_ratios[stage], cfg.qkv_bias, cfg.drop_rate,
                 drop_path=float(dpr[cur + i]))
        for i in range(cfg.depths[stage])
    )


def _trunc_normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    s = std / _TRUNC_STD
    nn.init.trunc_normal_(t, 0.0, s, -2.0 * s, 2.0 * s, generator=generator)


def init_mit(module: nn.Module, generator: torch.Generator) -> None:
    """The reference MiT ``_init_weights``, as the JAX package's
    initialisers draw it: Linear weights truncated normal (std 0.02) with
    zero bias, convs N(0, sqrt(2 / fan_out)) with fan_out = k*k*out/groups
    and zero bias, LayerNorms to identity."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            _trunc_normal_(m.weight, 0.02, generator)
            if m.bias is not None:
                nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            fan_out = m.kernel_size[0] * m.kernel_size[1] * m.out_channels // m.groups
            with torch.no_grad():
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=generator)
                if m.bias is not None:
                    m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()


class MixVisionTransformer(nn.Module):
    """4-stage MiT returning NCHW features at strides 4, 8, 16, 32."""

    def __init__(
        self, variant: str = "mit_b0", in_channels: int = 3, drop_path_rate: float | None = None,
        remat: bool = False,
    ) -> None:
        super().__init__()
        cfg = mit_configs[variant]
        self.cfg = cfg
        self.remat = remat  # recompute each MiTBlock in the backward (JAX nn.remat)
        rate = cfg.drop_path_rate if drop_path_rate is None else drop_path_rate
        dpr = np.linspace(0.0, rate, sum(cfg.depths))
        chans = (in_channels, *cfg.embed_dims[:-1])
        for s in range(4):
            setattr(self, f"patch_embed{s + 1}", OverlapPatchEmbed(
                chans[s], cfg.embed_dims[s], 7 if s == 0 else 3, 4 if s == 0 else 2))
            setattr(self, f"block{s + 1}", _stage_blocks(cfg, s, dpr))
            setattr(self, f"norm{s + 1}", nn.LayerNorm(cfg.embed_dims[s], eps=LN_EPS))

    @property
    def out_channels(self) -> tuple[int, ...]:
        return self.cfg.embed_dims

    def init_weights(self, generator: torch.Generator) -> None:
        init_mit(self, generator)

    def embed(self, stage: int, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        return getattr(self, f"patch_embed{stage + 1}")(x)

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        outs = []
        for s in range(4):
            x, h, w = self.embed(s, x)
            remat = self.remat and torch.is_grad_enabled()
            for blk in getattr(self, f"block{s + 1}"):
                x = checkpointed(blk, blk, x, h, w) if remat else blk(x, h, w)
            x = _to_map(getattr(self, f"norm{s + 1}")(x), h, w)
            outs.append(x)
        return outs


class DynamicChannelEmbed(nn.Module):
    """Channel-count-agnostic stage-1 patch embedding (reference
    ``DynamicChannelEmbed``): each band is embedded by one shared 1 -> D
    strided conv, weighted by an MLP of its sinusoidal position, and the
    bands are pooled with a softmax attention over them."""

    def __init__(
        self, embed_dim: int = 64, hidden_dim: int = 128, patch_size: int = 7, stride: int = 4
    ) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.hidden_dim = hidden_dim
        self.weight_gen1 = nn.Linear(hidden_dim, hidden_dim)
        self.weight_gen2 = nn.Linear(hidden_dim, embed_dim)
        self.spatial_conv = nn.Conv2d(1, embed_dim, patch_size, stride=stride,
                                      padding=patch_size // 2)
        self.channel_attn1 = nn.Linear(embed_dim + hidden_dim, embed_dim // 2)
        self.channel_attn2 = nn.Linear(embed_dim // 2, 1)
        self.proj = nn.Linear(embed_dim, embed_dim)
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def _positions(self, channels: int, device: torch.device) -> torch.Tensor:
        """Sinusoidal band encoding ``[C, hidden]`` (sin at even, cos at odd)."""
        pos = torch.arange(channels, dtype=torch.float32, device=device)
        dim_t = torch.arange(0, self.hidden_dim, 2, dtype=torch.float32, device=device)
        ang = pos[:, None] * (1.0 / (10000.0 ** (dim_t / self.hidden_dim)))[None]
        return torch.stack([torch.sin(ang), torch.cos(ang)], dim=-1).flatten(1)

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        b, c = x.shape[:2]
        pos = self._positions(c, x.device)
        cw = torch.tanh(self.weight_gen2(F.relu(self.weight_gen1(pos))))  # [C, D]
        xc = self.spatial_conv(x.reshape(b * c, 1, *x.shape[-2:]))
        ho, wo = xc.shape[-2:]
        xw = xc.unflatten(0, (b, c)).permute(0, 1, 3, 4, 2) * cw[None, :, None, None, :]
        pos_b = pos.to(xw.dtype)[None, :, None, None, :].expand(b, c, ho, wo, self.hidden_dim)
        a = self.channel_attn2(F.relu(self.channel_attn1(torch.cat([xw, pos_b], dim=-1))))
        agg = (xw * torch.softmax(a, dim=1)).sum(dim=1)  # [B, ho, wo, D]
        return self.norm(self.proj(agg)).flatten(1, 2), ho, wo


class DynamicMixTransformer(MixVisionTransformer):
    """MiT with the dynamic channel embedding at stage 1 (reference
    ``DynamicMixTransformer``); stages 2-4 are standard MiT. The drop-path
    rate is the variant's, as in the JAX package."""

    def __init__(self, variant: str = "mit_b0") -> None:
        super().__init__(variant)
        del self.patch_embed1
        self.dynamic_patch_embed1 = DynamicChannelEmbed(self.cfg.embed_dims[0])

    def init_weights(self, generator: torch.Generator) -> None:
        init_mit(self, generator)
        # raw torch layers in the reference: torch defaults
        init_torch_default(self.dynamic_patch_embed1, generator)

    def embed(self, stage: int, x: torch.Tensor) -> tuple[torch.Tensor, int, int]:
        if stage == 0:
            return self.dynamic_patch_embed1(x)
        return super().embed(stage, x)
