"""DOFA v2 encoder: wavelength-conditioned dynamic patch embedding + ViT.

Port of ``geo_deep_learning_tpu/models/encoders/dofa.py`` (reference
``models/encoders/dofa_v2.py``). The patch-embedding conv kernel is
generated from the input bands' wavelengths: sincos embedding of
lambda x 1000 -> ``FCResLayer`` -> a one-layer post-norm transformer over
[128 weight tokens | wave tokens | bias token] -> projections to a
``[C, k, k, D]`` kernel and a ``[D]`` bias, both scaled by 0.01 -> strided
conv (stride 14, padding 1). Then ViT blocks (timm semantics with
LayerScale) over [cls | tokens + sincos pos_embed], returning the raw
token stream of the tap blocks as NCHW feature maps. The embedding may be
resized to 16 x 16 (``convert_patch_to_16``) or given pre-baked
(``baked_embed``, see ``inference/export.py``), and the taps chosen
(``out_indices``), as the JAX encoder's fields allow.

The blocks run the port's kernels: LayerNorm (K2, backward K5), residual
LayerNorm (K3, backward K6) and packed attention (K4, backward K7). As in
the JAX package:

- residual-lazy threading: a block returns ``(stream, branch)`` with the
  residual add deferred into the next block's LayerNorm (K3); the sum is
  made only at tap blocks, so the block after a tap starts with K2;
- LayerScale gammas are folded into the out-projection and fc2 weights,
  ``(x @ W + b) * g == x @ (W * g) + b * g``;
- in train mode, DropPath with rates ``linspace(0, drop_path_rate, depth)``
  scales each branch before it enters the next residual LayerNorm; the
  token dropout rate is 0, so it is not applied;
- ``remat`` recomputes in the backward what it does not keep (JAX
  ``remat``/``remat_mode``, through ``torch.utils.checkpoint``): ``"mlp"``
  only each block's MLP branch, so the attention operator keeps its saved
  ``(qkv, o, lse)`` and K4/K8 run once a block a step; ``"block"`` the
  whole block, so K2/K3 and K4 (K8) run again in the backward;
- tensor parallelism (``parallel.placement.place_state``): each block's
  ``qkv`` and ``fc1`` are column-parallel (this rank's heads, head-aligned
  within each of q, k and v, and its hidden columns), ``proj`` and ``fc2``
  row-parallel; :func:`parallel.collectives.copy_to_model` in front of
  the first and :func:`parallel.collectives.row_parallel_linear` for the
  second, and the attention takes K8/K9 (``route``'s mesh clause);
- wavelengths are batch-constant (a ``[B, C]`` input uses row 0);
- ``norm`` exists for checkpoint parity only and is not applied.

Parameter names are the reference's torch names.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from geo_deep_learning_tpu_torch.models.convert import bicubic_matrix
from geo_deep_learning_tpu_torch.models.layers import (
    DropPath,
    LayerNorm,
    checkpointed,
    init_torch_default,
    normal_,
    xavier_uniform_,
)
from geo_deep_learning_tpu_torch.ops.cuda.mha import attention
from geo_deep_learning_tpu_torch.parallel.collectives import copy_to_model, row_parallel_linear


def sincos_1d(embed_dim: int, pos: torch.Tensor) -> torch.Tensor:
    """1-D sin/cos embedding, reference ``position_embedding`` (:9-35)."""
    if embed_dim % 2 != 0:
        msg = "embed_dim must be even"
        raise ValueError(msg)
    omega = torch.arange(embed_dim // 2, dtype=torch.float32, device=pos.device)
    omega = 1.0 / 10000.0 ** (omega / (embed_dim / 2.0))
    out = pos.reshape(-1, 1).float() * omega[None, :]
    return torch.cat([torch.sin(out), torch.cos(out)], dim=1)


def sincos_2d(embed_dim: int, grid_h: int, grid_w: int) -> np.ndarray:
    """Fixed 2-D sin/cos positional embedding ``[H*W, D]``, reference :394-433."""

    def emb_1d(dim, pos):
        omega = np.arange(dim // 2, dtype=np.float32) / (dim / 2.0)
        omega = 1.0 / 10000.0**omega
        out = pos.reshape(-1)[:, None] * omega[None, :]
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    grid = np.meshgrid(
        np.arange(grid_h, dtype=np.float32), np.arange(grid_w, dtype=np.float32),
        indexing="ij",
    )
    return np.concatenate(
        [emb_1d(embed_dim // 2, grid[0]), emb_1d(embed_dim // 2, grid[1])], axis=1
    )


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # flax's nn.gelu default is the tanh approximation
    return F.gelu(x, approximate="tanh")


class _FastVarLayerNorm(nn.LayerNorm):
    """Plain LayerNorm with flax's fast variance (``E[x^2] - E[x]^2``), for
    the small weight-generator transformer (not a kernel of the main path)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        mu = xf.mean(dim=-1, keepdim=True)
        var = torch.clamp((xf * xf).mean(dim=-1, keepdim=True) - mu * mu, min=0.0)
        y = (xf - mu) * torch.rsqrt(var + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class FCResLayer(nn.Module):
    """``x + relu(w2(relu(w1(x))))`` (reference :38-56)."""

    def __init__(self, size: int = 128) -> None:
        super().__init__()
        self.w1 = nn.Linear(size, size)
        self.w2 = nn.Linear(size, size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + F.relu(self.w2(F.relu(self.w1(x))))


class _SelfAttention(nn.Module):
    """torch ``nn.MultiheadAttention`` parameter layout, computed plainly."""

    def __init__(self, d: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.in_proj_weight = nn.Parameter(torch.empty(3 * d, d))
        self.in_proj_bias = nn.Parameter(torch.empty(3 * d))
        self.out_proj = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, l, d = x.shape
        hd = d // self.num_heads
        q, k, v = (
            t.reshape(n, l, self.num_heads, hd).transpose(1, 2)
            for t in F.linear(x, self.in_proj_weight, self.in_proj_bias).chunk(3, dim=-1)
        )
        w = torch.softmax((q / math.sqrt(hd)) @ k.transpose(-1, -2), dim=-1)
        o = (w.to(v.dtype) @ v).transpose(1, 2).reshape(n, l, d)
        return self.out_proj(o)


class _PostNormEncoderLayer(nn.Module):
    """torch ``TransformerEncoderLayer(norm_first=False)``: x = norm1(x +
    attn(x)); x = norm2(x + ffn(x)); d_ff 2048, GELU, 4 heads."""

    def __init__(self, d: int, num_heads: int = 4, d_ff: int = 2048) -> None:
        super().__init__()
        self.self_attn = _SelfAttention(d, num_heads)
        self.linear1 = nn.Linear(d, d_ff)
        self.linear2 = nn.Linear(d_ff, d)
        self.norm1 = _FastVarLayerNorm(d, eps=1e-6)
        self.norm2 = _FastVarLayerNorm(d, eps=1e-6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.norm1(x + self.self_attn(x))
        return self.norm2(x + self.linear2(_gelu(self.linear1(x))))


class _TransformerEncoder(nn.Module):
    def __init__(self, d: int) -> None:
        super().__init__()
        self.layers = nn.ModuleList([_PostNormEncoderLayer(d)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers:
            x = layer(x)
        return x


class TransformerWeightGenerator(nn.Module):
    """Dynamic conv-kernel generator (reference :59-106)."""

    def __init__(
        self, output_dim: int, embed_dim: int, input_dim: int = 128, num_tokens: int = 128
    ) -> None:
        super().__init__()
        self.num_tokens = num_tokens
        self.weight_tokens = nn.Parameter(torch.empty(num_tokens, input_dim))
        self.bias_token = nn.Parameter(torch.empty(1, input_dim))
        self.transformer_encoder = _TransformerEncoder(input_dim)
        self.fc_weight = nn.Linear(input_dim, output_dim)
        self.fc_bias = nn.Linear(input_dim, embed_dim)

    def forward(self, waves: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat(
            [self.weight_tokens.to(waves.dtype), waves, self.bias_token.to(waves.dtype)]
        )
        x = self.transformer_encoder(x[None])[0]
        wave_out = x[self.num_tokens : self.num_tokens + waves.shape[0]]
        return self.fc_weight(wave_out + waves), self.fc_bias(x[-1])


class DOFAv2Embedding(nn.Module):
    """Wavelength-conditioned patch embedding -> ``[B, D, H', W']``.

    ``convert_to_16`` resizes the generated ``k x k`` kernel to 16 x 16 by
    torch's bicubic rule (a = -0.75, as the JAX package applies it) and
    strides 16 (reference :167-177). ``forward`` takes a pre-baked
    ``(weight, bias)`` pair in place of the wavelengths, and then does not
    run the weight generator.
    """

    def __init__(
        self, embed_dim: int = 768, kernel_size: int = 14, dynamic_embed_dim: int = 128,
        scaler: float = 0.01, convert_to_16: bool = False,
    ) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.kernel_size = kernel_size
        self.dynamic_embed_dim = dynamic_embed_dim
        self.scaler = scaler
        self.convert_to_16 = convert_to_16
        self.stride = 16 if convert_to_16 else kernel_size
        self.fclayer = FCResLayer(dynamic_embed_dim)
        self.weight_generator = TransformerWeightGenerator(
            kernel_size * kernel_size * embed_dim, embed_dim, dynamic_embed_dim
        )
        if convert_to_16:  # [16, k], moved with the module, not in the state dict
            self.register_buffer("resize_16", torch.from_numpy(
                bicubic_matrix(16, kernel_size).astype(np.float32)), persistent=False)

    def generate(self, wavelengths: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """lambda -> (OIHW conv weight ``[D, C, k, k]`` or ``[D, C, 16, 16]``,
        bias ``[D]``)."""
        k = self.kernel_size
        waves = self.fclayer(sincos_1d(self.dynamic_embed_dim, wavelengths * 1000.0))
        weight, bias = self.weight_generator(waves)
        weight = weight.reshape(-1, k, k, self.embed_dim).permute(3, 0, 1, 2) * self.scaler
        if self.convert_to_16:
            m = self.resize_16.to(weight.dtype)
            weight = torch.einsum("ph,dchw,qw->dcpq", m, weight, m)
        return weight, bias * self.scaler

    def forward(
        self, x: torch.Tensor, wavelengths: torch.Tensor | None = None,
        baked: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> torch.Tensor:
        weight, bias = self.generate(wavelengths) if baked is None else baked
        return F.conv2d(x, weight, bias, stride=self.stride, padding=1)


class Attention(nn.Module):
    """timm attention with a packed QKV projection and kernels K4/K7 (K8/K9
    under a model axis). Sharded (``tp``, the mesh, set by
    ``parallel.placement.place_state``), ``qkv`` holds this rank's
    ``num_heads / M`` heads of each of q, k and v and ``proj`` their input
    columns."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.tp_divisor = num_heads  # a model axis must divide the heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.tp = None
        self.model_axis = 1  # the mesh's model axis, which routes the attention

    def forward(self, x: torch.Tensor, out_scale: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            o = attention(self.qkv(x), self.num_heads, model_axis=self.model_axis)
            return F.linear(o, self.proj.weight * out_scale[:, None], self.proj.bias * out_scale)
        group = self.tp.model_group
        o = attention(self.qkv(copy_to_model(x, group)), self.num_heads // self.tp.model_size,
                      model_axis=self.model_axis)
        return row_parallel_linear(o, self.proj.weight, self.proj.bias, group, out_scale)


class Mlp(nn.Module):
    """fc1 -> GELU -> fc2; sharded (``tp``), this rank's hidden columns."""

    def __init__(self, dim: int, hidden: int) -> None:
        super().__init__()
        self.tp_divisor = hidden
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.tp = None

    def forward(self, x: torch.Tensor, out_scale: torch.Tensor) -> torch.Tensor:
        if self.tp is None:
            return F.linear(_gelu(self.fc1(x)), self.fc2.weight * out_scale[:, None],
                            self.fc2.bias * out_scale)
        group = self.tp.model_group
        return row_parallel_linear(_gelu(self.fc1(copy_to_model(x, group))), self.fc2.weight,
                                   self.fc2.bias, group, out_scale)


class LayerScale(nn.Module):
    def __init__(self, dim: int) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.empty(dim))


class ViTBlock(nn.Module):
    """Residual-lazy timm block: ``(x, pending) -> (s, branch)`` where the
    true post-block stream is ``s + branch``."""

    def __init__(
        self, dim: int, num_heads: int, mlp_ratio: float = 4.0, drop_path: float = 0.0
    ) -> None:
        super().__init__()
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, num_heads)
        self.ls1 = LayerScale(dim)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = Mlp(dim, int(dim * mlp_ratio))
        self.ls2 = LayerScale(dim)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)
        self.remat_mlp = False  # recompute the MLP branch in the backward

    def forward(
        self, x: torch.Tensor, pending: torch.Tensor | None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        if pending is None:
            s1, y = x, self.norm1(x)
        else:
            s1, y = self.norm1.residual(x, pending)
        s2, y = self.norm2.residual(s1, self.drop_path1(self.attn(y, self.ls1.gamma)))
        if self.remat_mlp and torch.is_grad_enabled():
            y = checkpointed(self.mlp, self.mlp, y, self.ls2.gamma)
        else:
            y = self.mlp(y, self.ls2.gamma)
        return s2, self.drop_path2(y)


@dataclass(frozen=True)
class DOFAConfig:
    embed_dim: int = 768
    depth: int = 12
    num_heads: int = 12
    out_indices: tuple[int, ...] = (4, 6, 10, 11)
    patch_size: int = 14
    mlp_ratio: float = 4.0
    init_values: float = 1e-5


dofa_configs: dict[str, DOFAConfig] = {
    "dofa_base": DOFAConfig(),
    "dofa_large": DOFAConfig(
        embed_dim=1024, depth=24, num_heads=16, out_indices=(5, 9, 15, 21)
    ),
}


REMAT_MODES = ("mlp", "block")


def token_grid(img_size: int, patch_size: int) -> int:
    """Tokens per side of the stride-``patch_size``, padding-1 patch conv."""
    return (img_size + 2 - patch_size) // patch_size + 1


class DOFAv2(nn.Module):
    """DOFA v2 ViT returning the tap blocks' streams as NCHW maps.

    ``out_indices`` overrides the variant's tap blocks; ``convert_patch_to_16``
    embeds with the kernel resized to 16 x 16 at stride 16 (a 32 x 32 grid
    at 512^2)."""

    def __init__(
        self, variant: str = "dofa_base", img_size: int = 512, drop_path_rate: float = 0.1,
        remat: bool = False, remat_mode: str = "mlp", out_indices: tuple[int, ...] | None = None,
        convert_patch_to_16: bool = False,
    ) -> None:
        super().__init__()
        if remat_mode not in REMAT_MODES:
            msg = f"remat_mode {remat_mode!r} is not one of {REMAT_MODES}"
            raise ValueError(msg)
        cfg = dofa_configs[variant]
        self.cfg = cfg
        self.out_indices = tuple(out_indices) if out_indices else cfg.out_indices
        self.embed_dim = cfg.embed_dim
        self.patch_embed = DOFAv2Embedding(cfg.embed_dim, cfg.patch_size,
                                           convert_to_16=convert_patch_to_16)
        self.grid = token_grid(img_size, self.patch_embed.stride)
        self.cls_token = nn.Parameter(torch.empty(1, 1, cfg.embed_dim))
        # fixed sincos table [1, 1 + g^2, D] (cls row unused), kept in the
        # state dict as the reference keeps it
        self.register_buffer(
            "pos_embed", torch.empty(1, 1 + self.grid * self.grid, cfg.embed_dim)
        )
        dpr = np.linspace(0.0, drop_path_rate, cfg.depth)
        self.blocks = nn.ModuleList(
            ViTBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio, float(dpr[i]))
            for i in range(cfg.depth)
        )
        self.norm = LayerNorm(cfg.embed_dim, eps=1e-6)
        self.remat_block = remat and remat_mode == "block"
        for blk in self.blocks:
            blk.remat_mlp = remat and remat_mode == "mlp"

    def init_weights(self, generator: torch.Generator) -> None:
        """Seeded init with the reference's distributions."""
        init_torch_default(self, generator)
        pe = self.patch_embed
        for m in pe.modules():
            if isinstance(m, nn.Linear):  # reference DOFAv2Embedding._init_weights
                xavier_uniform_(m.weight, generator)
                with torch.no_grad():
                    m.bias.fill_(0.01)
        for layer in pe.weight_generator.transformer_encoder.layers:
            xavier_uniform_(layer.self_attn.in_proj_weight, generator)
            with torch.no_grad():
                layer.self_attn.in_proj_bias.zero_()
        normal_(pe.weight_generator.weight_tokens, 0.02, generator)
        normal_(pe.weight_generator.bias_token, 0.02, generator)
        normal_(self.cls_token, 0.02, generator)
        with torch.no_grad():
            for blk in self.blocks:
                blk.ls1.gamma.fill_(self.cfg.init_values)
                blk.ls2.gamma.fill_(self.cfg.init_values)
            self.pos_embed.zero_()
            self.pos_embed[0, 1:] = torch.from_numpy(
                sincos_2d(self.embed_dim, self.grid, self.grid)
            ).to(self.pos_embed.device)

    def forward(
        self, x: torch.Tensor, wavelengths: torch.Tensor | None = None,
        baked_embed: tuple[torch.Tensor, torch.Tensor] | None = None,
    ) -> list[torch.Tensor]:
        """``baked_embed``: the patch embedding's ``(weight, bias)`` from
        :meth:`DOFAv2Embedding.generate`, in place of ``wavelengths``."""
        if wavelengths is not None and wavelengths.ndim == 2:
            wavelengths = wavelengths[0]  # batch-constant (reference :437-442)
        tokens = self.patch_embed(x, wavelengths, baked=baked_embed)
        b, d, gh, gw = tokens.shape
        if gh * gw + 1 != self.pos_embed.shape[1]:
            msg = (
                f"input {tuple(x.shape[-2:])} gives a {gh}x{gw} token grid; the "
                f"model was built for {self.grid}x{self.grid}"
            )
            raise ValueError(msg)
        seq = tokens.flatten(2).transpose(1, 2) + self.pos_embed[:, 1:].to(tokens.dtype)
        seq = torch.cat([self.cls_token.to(seq.dtype).expand(b, -1, -1), seq], dim=1)
        features = []
        pending = None
        remat_block = self.remat_block and torch.is_grad_enabled()
        for i, blk in enumerate(self.blocks):
            if remat_block:
                seq, pending = checkpointed(blk, blk, seq, pending)
            else:
                seq, pending = blk(seq, pending)
            if i in self.out_indices:
                seq = seq + pending
                pending = None
                features.append(seq[:, 1:].reshape(b, gh, gw, d).permute(0, 3, 1, 2))
        return features
