from geo_deep_learning_tpu_torch.tasks.segmentation import SegmentationDOFA

__all__ = ["SegmentationDOFA"]
