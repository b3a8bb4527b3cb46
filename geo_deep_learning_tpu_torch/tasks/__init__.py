from geo_deep_learning_tpu_torch.tasks.segmentation import (
    SegmentationDOFA,
    SegmentationSegformer,
)

__all__ = ["SegmentationDOFA", "SegmentationSegformer"]
