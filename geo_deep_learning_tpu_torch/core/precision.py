"""Precision policy: bf16 compute under autocast, f32 parameters.

Port of ``geo_deep_learning_tpu/core/precision.py``. ``bf16-mixed`` runs
the forward under ``torch.autocast(dtype=torch.bfloat16)`` with the
parameters kept in f32 (bf16 shares f32's exponent range, so no loss
scaling); ``32-true`` runs everything in f32, on the card too:
:meth:`PrecisionPolicy.scope` turns TF32 off for cuBLAS and cuDNN (PyTorch
leaves cuDNN's on by default, which would run the f32 convolutions at
about 1e-3) for the length of a run and restores the flags afterwards.
"""

from __future__ import annotations

import contextlib
import enum
from dataclasses import dataclass

import torch


class Precision(str, enum.Enum):
    """User-facing precision names (config surface)."""

    BF16_MIXED = "bf16-mixed"
    F32 = "32-true"


@dataclass(frozen=True)
class PrecisionPolicy:
    compute_dtype: torch.dtype  # parameters and logits stay f32 either way

    @classmethod
    def create(cls, precision: Precision | str = Precision.BF16_MIXED) -> "PrecisionPolicy":
        bf16 = Precision(precision) == Precision.BF16_MIXED
        return cls(torch.bfloat16 if bf16 else torch.float32)

    def cast_input(self, x: torch.Tensor) -> torch.Tensor:
        """Cast a floating-point input batch to the compute dtype."""
        return x.to(self.compute_dtype) if x.is_floating_point() else x

    def autocast(self, device: torch.device):
        """Context for the forward: bf16 autocast, or nothing for f32."""
        if self.compute_dtype == torch.float32:
            return contextlib.nullcontext()
        return torch.autocast(device_type=device.type, dtype=self.compute_dtype)

    @contextlib.contextmanager
    def scope(self):
        """Context for a whole run: under f32, TF32 off for cuBLAS and cuDNN,
        the earlier flags restored on leaving; nothing for bf16."""
        if self.compute_dtype != torch.float32:
            yield
            return
        flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
        saved = [f.allow_tf32 for f in flags]
        try:
            for f in flags:
                f.allow_tf32 = False
            yield
        finally:
            for f, value in zip(flags, saved):
                f.allow_tf32 = value
