"""LR schedulers at the reference's import path.

Port of ``geo_deep_learning_tpu/tools/schedulers/__init__.py`` (reference
``tools/schedulers/lr_scheduler.py:13-198``), under the JAX package's
export names. The implementations live in
:mod:`geo_deep_learning_tpu_torch.training.optim`.
"""

from geo_deep_learning_tpu_torch.training.optim import (
    linear_warmup_cosine_annealing as LinearWarmupCosineAnnealingLR,
    linear_warmup_decay,
    one_cycle,
)

__all__ = ["LinearWarmupCosineAnnealingLR", "linear_warmup_decay", "one_cycle"]
