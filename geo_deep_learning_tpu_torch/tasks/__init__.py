from geo_deep_learning_tpu_torch.tasks.segmentation import (
    SegmentationDOFA,
    SegmentationSegformer,
    SegmentationUnetPlus,
)

__all__ = ["SegmentationDOFA", "SegmentationSegformer", "SegmentationUnetPlus"]
