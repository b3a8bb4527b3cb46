"""Prediction visualization: a 3-panel matplotlib figure.

Port of ``geo_deep_learning_tpu/tools/visualization.py`` (reference
``tools/visualization.py:9-110``): input RGB | ground truth | prediction,
the maps drawn with a ``ListedColormap`` of the per-class colours or
``tab10``. An input of more than three bands shows its first three; a
uint8 input is shown as it is, a standardized one denormalized. matplotlib
is imported when a figure is made (the Agg backend), never with this
module.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from geo_deep_learning_tpu_torch.utils.tensors import denormalization


def visualize_prediction(
    image: np.ndarray,
    mask: np.ndarray,
    prediction: np.ndarray,
    mean: np.ndarray | None = None,
    std: np.ndarray | None = None,
    class_colors: Sequence[str] | None = None,
    num_classes: int = 2,
    sample_name: str = "",
    save_path: str | None = None,
):
    """Render one sample. ``image`` is HWC (uint8, or standardized floats),
    ``mask`` and ``prediction`` are HW integer maps. Returns the figure."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.colors import ListedColormap

    img = np.asarray(image)
    if img.dtype != np.uint8:  # raw pixels of a device-preprocess pipeline are shown as they are
        img = denormalization(torch.as_tensor(img), mean, std).numpy()
    if img.shape[-1] > 3:
        img = img[..., :3]
    elif img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)

    if class_colors:
        cmap = ListedColormap(list(class_colors))
    else:
        cmap = plt.get_cmap("tab10", num_classes)

    fig, axes = plt.subplots(1, 3, figsize=(15, 5))
    axes[0].imshow(img)
    axes[0].set_title(f"Image {sample_name}")
    axes[1].imshow(np.asarray(mask), cmap=cmap, vmin=0, vmax=num_classes - 1)
    axes[1].set_title("Ground truth")
    axes[2].imshow(np.asarray(prediction), cmap=cmap, vmin=0, vmax=num_classes - 1)
    axes[2].set_title("Prediction")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, bbox_inches="tight", dpi=100)
    return fig
