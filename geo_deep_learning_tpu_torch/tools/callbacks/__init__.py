"""Callbacks at the reference's import path."""

from geo_deep_learning_tpu_torch.tools.callbacks.segmentation_visualization import (
    VisualizationCallback,
)

__all__ = ["VisualizationCallback"]
