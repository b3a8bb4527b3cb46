"""Checkpoint weight loading at the reference's import path.

Port of ``geo_deep_learning_tpu/utils/models.py`` (reference
``utils/models.py:10-66``). The implementation lives in
:mod:`geo_deep_learning_tpu_torch.training.checkpoint`.
"""

from geo_deep_learning_tpu_torch.training.checkpoint import load_weights_from_checkpoint

__all__ = ["load_weights_from_checkpoint"]
