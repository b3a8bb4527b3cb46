"""The products of the plain references, in f32 or in the control's precision.

Every matrix product and convolution of a reference model goes through one
of these objects, so the same model code gives the f32 reference
(:class:`Plain`, TF32 off for cuBLAS and cuDNN: :func:`f32_scope`) and the
control (:class:`FP8`): each operand of each product rounded to float8
with a per-tensor scale (its largest magnitude at the format's largest
finite value), the precision one step below the bf16 that the
configurations state, as fp8 training runs it: the forward's operands in
e4m3 (the backward's products read the rounded operands the forward
saved; the rounding passes the gradient through unchanged) and the
gradient of each product's output in e5m2 before the backward's
products read it. :class:`BF16` rounds the operands to bf16, the
configurations' own precision, to give a scene's logit gaps their scale.
"""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F

FORMATS = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


@contextlib.contextmanager
def f32_scope():
    """TF32 off for cuBLAS and cuDNN inside the block, the earlier flags
    restored after it."""
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = False
        yield
    finally:
        for f, value in zip(flags, saved):
            f.allow_tf32 = value


class Plain:
    """f32 products."""

    name = "f32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        """A product's operand as the product reads it."""
        return x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        """A product's output, whose gradient the backward's products read."""
        return y

    def linear(self, x, w, b=None):
        y = self.out(F.linear(self.q(x), self.q(w)))
        return y if b is None else y + b

    def conv2d(self, x, w, b=None, stride=1, padding=0, groups=1):
        y = self.out(F.conv2d(self.q(x), self.q(w), stride=stride, padding=padding, groups=groups))
        return y if b is None else y + b[:, None, None]

    def matmul(self, a, b):
        return self.out(torch.matmul(self.q(a), self.q(b)))


def round_scaled(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``fmt`` under a per-tensor scale that maps its
    largest magnitude to the format's largest finite value."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / FORMATS[fmt]
    return (x / scale).to(fmt).to(x.dtype) * scale


class BF16(Plain):
    """Every product's operands rounded to bf16, the precision the
    configurations state: the scale a bf16 program's gaps are read in."""

    name = "bf16"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(torch.bfloat16).to(x.dtype)


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return round_scaled(x, torch.float8_e4m3fn)

    @staticmethod
    def backward(ctx, g):
        return g


class _OutputGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y

    @staticmethod
    def backward(ctx, g):
        return round_scaled(g, torch.float8_e5m2)


class FP8(Plain):
    """The control: operands in scaled e4m3, output gradients in e5m2."""

    name = "fp8"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        return _Operand.apply(x)

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return _OutputGrad.apply(y)
