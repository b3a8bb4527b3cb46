"""Visualization on a new best checkpoint: the callback's config surface.

Port of ``geo_deep_learning_tpu/tools/callbacks/segmentation_visualization.py``
(reference ``tools/callbacks/segmentation_visualization.py:12-76``: keep
the first val batch, render figures when a new best checkpoint is saved).
That behaviour is built into ``Trainer.fit`` (``training/loop.py``
``_log_visualizations``); the CLI maps this class's ``max_samples`` onto
``TrainerConfig.visualize_max_samples``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass
class VisualizationCallback:
    max_samples: int = 3
    mean: list[float] | None = None
    std: list[float] | None = None
