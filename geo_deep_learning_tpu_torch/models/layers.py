"""Shared model primitives (NCHW).

Port of ``geo_deep_learning_tpu/models/layers.py``: ``ConvModule`` (conv +
BatchNorm + ReLU, reference ``models/utils.py:10-52``), ``PPM`` pooling
branches, ``DropPath`` and element-wise ``Dropout``, the kernel-backed
``LayerNorm``, and the torch-default initialisation the JAX package
mirrors, drawn from an explicit ``torch.Generator``. Module and parameter
names are the reference's torch names (what ``models/convert.py``
consumes).

Randomness: ``DropPath`` and ``Dropout`` draw their masks from the
``torch.Generator`` that :func:`set_generator` hands them (the train state
does so); in train mode without one they raise rather than use the global
RNG.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from geo_deep_learning_tpu_torch.ops.cuda.layernorm import LayerNormFn, LayerNormResidualFn
from geo_deep_learning_tpu_torch.ops.resize import resize


def uniform_(t: torch.Tensor, bound: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.uniform_(-bound, bound, generator=generator)


def normal_(t: torch.Tensor, std: float, generator: torch.Generator) -> None:
    with torch.no_grad():
        t.normal_(0.0, std, generator=generator)


def xavier_uniform_(t: torch.Tensor, generator: torch.Generator) -> None:
    fan_out, fan_in = t.shape[0], t[0].numel()
    uniform_(t, math.sqrt(6.0 / (fan_in + fan_out)), generator)


def init_torch_default(module: nn.Module, generator: torch.Generator) -> None:
    """torch's default init for every conv / linear / norm under ``module``:
    weight and bias U(+-1/sqrt(fan_in)) (``kaiming_uniform_(a=sqrt(5))``),
    norms to identity, BatchNorm running stats to (0, 1)."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            bound = 1.0 / math.sqrt(m.weight[0].numel())
            uniform_(m.weight, bound, generator)
            if m.bias is not None:
                uniform_(m.bias, bound, generator)
        elif isinstance(m, nn.BatchNorm2d):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()
                m.running_mean.zero_()
                m.running_var.fill_(1.0)
                m.num_batches_tracked.zero_()
        elif isinstance(m, (LayerNorm, nn.LayerNorm)):
            with torch.no_grad():
                m.weight.fill_(1.0)
                m.bias.zero_()


class LayerNorm(nn.Module):
    """LayerNorm over the last dim of ``[B, L, D]`` token streams through
    kernels K2/K5, and residual-fused through K3/K6 (:meth:`residual`)."""

    def __init__(self, dim: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return LayerNormFn.apply(x, self.weight, self.bias, self.eps)

    def residual(
        self, x: torch.Tensor, branch: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``s = x + branch; y = LayerNorm(s)`` -> ``(s, y)``."""
        return LayerNormResidualFn.apply(x, branch, self.weight, self.bias, self.eps)


class _Random(nn.Module):
    """A module whose train-mode forward draws from ``self.generator``."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = float(rate)
        self.generator: torch.Generator | None = None

    def active(self) -> bool:
        if not self.training or self.rate == 0.0:
            return False
        if self.generator is None:
            msg = f"{type(self).__name__} in train mode needs a generator (set_generator)"
            raise RuntimeError(msg)
        return True

    def keep(self, mask: torch.Tensor) -> torch.Tensor:
        """Fill ``mask`` with Bernoulli(1 - rate) draws, in place."""
        return mask.bernoulli_(1.0 - self.rate, generator=self.generator)

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


class DropPath(_Random):
    """Stochastic depth, timm semantics: ``x / keep * bernoulli(keep)`` with
    one draw per sample (JAX package ``layers.py:231-246``)."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.active():
            return x
        mask = self.keep(x.new_empty((x.shape[0],) + (1,) * (x.ndim - 1)))
        return x / (1.0 - self.rate) * mask


class Dropout(_Random):
    """Element-wise dropout, flax ``nn.Dropout`` semantics: every element is
    dropped on its own and the kept ones are scaled by ``1 / keep``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.active():
            return x
        return x / (1.0 - self.rate) * self.keep(torch.empty_like(x))


def set_generator(module: nn.Module, generator: torch.Generator) -> None:
    """Hand ``generator`` to every ``DropPath`` / ``Dropout`` under ``module``."""
    for m in module.modules():
        if isinstance(m, _Random):
            m.generator = generator


def checkpointed(fn, module: nn.Module, *args):
    """``fn(*args)`` under ``torch.utils.checkpoint`` (``use_reentrant=False``):
    the backward recomputes it instead of keeping its activations. The
    generators of ``module``'s ``DropPath`` / ``Dropout`` layers (explicit
    ``torch.Generator`` objects, which the checkpoint's own RNG stash does
    not cover) replay the forward's draws in the recomputation and are then
    put back where the forward left them, so the masks match and the next
    step's draws are unchanged."""
    from torch.utils.checkpoint import checkpoint

    gens = list({id(m.generator): m.generator for m in module.modules()
                 if isinstance(m, _Random) and m.generator is not None}.values())
    start = [g.get_state() for g in gens]
    calls = []

    def run(*a):
        calls.append(None)
        if len(calls) == 1:
            return fn(*a)
        now = [g.get_state() for g in gens]
        for g, state in zip(gens, start):
            g.set_state(state)
        try:
            return fn(*a)
        finally:
            for g, state in zip(gens, now):
                g.set_state(state)

    return checkpoint(run, *args, use_reentrant=False)


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm with flax ``nn.BatchNorm(momentum=0.9)`` statistics.

    Train mode normalizes with the batch statistics (as torch does) and
    updates the running mean and variance with the f32 batch mean and the
    BIASED batch variance, recovered from the inverse deviation that the
    normalization computes anyway; ``nn.BatchNorm2d`` would use the
    unbiased one. ``momentum`` is torch's (0.1 = flax's 0.9).
    """

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return super().forward(x)
        y, mean, invstd = torch.ops.aten.native_batch_norm(
            x, self.weight, self.bias, None, None, True, 0.0, self.eps
        )
        with torch.no_grad():
            self.running_mean.lerp_(mean, self.momentum)
            self.running_var.lerp_(invstd.pow(-2) - self.eps, self.momentum)
            self.num_batches_tracked.add_(1)
        return y


class ConvModule(nn.Module):
    """Conv2d + BatchNorm2d (eps 1e-5) + ReLU; bias only when asked (the
    reference neck keeps it, ``models/utils.py``'s modules do not)."""

    def __init__(
        self, in_channels: int, out_channels: int, kernel_size: int, bias: bool = False
    ) -> None:
        super().__init__()
        self.conv = nn.Conv2d(
            in_channels, out_channels, kernel_size, padding=kernel_size // 2, bias=bias
        )
        self.norm = BatchNorm2d(out_channels, eps=1e-5, momentum=0.1)
        self.act = nn.ReLU(inplace=True)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.norm(self.conv(x)))


class PPM(nn.ModuleList):
    """Pyramid pooling branches: adaptive average pool to each scale, 1x1
    ConvModule, bilinear upsample back (reference ``models/utils.py:55-93``)."""

    def __init__(
        self, pool_scales, in_channels: int, channels: int, align_corners: bool = False
    ) -> None:
        super().__init__(
            nn.Sequential(nn.AdaptiveAvgPool2d(s), ConvModule(in_channels, channels, 1))
            for s in pool_scales
        )
        self.align_corners = align_corners

    def forward(self, x: torch.Tensor) -> list[torch.Tensor]:
        return [
            resize(branch(x), size=x.shape[-2:], align_corners=self.align_corners)
            for branch in self
        ]
