"""Model primitives at the reference's import path.

Port of ``geo_deep_learning_tpu/models/utils.py`` (reference
``models/utils.py``: ConvModule :10-52, PPM :55-93, resize :96-137,
patch_first_conv :140-181). The implementations live in their own modules.
"""

from geo_deep_learning_tpu_torch.models.convert import patch_first_conv
from geo_deep_learning_tpu_torch.models.layers import PPM, ConvModule, adaptive_avg_pool
from geo_deep_learning_tpu_torch.ops.resize import resize

__all__ = ["PPM", "ConvModule", "adaptive_avg_pool", "patch_first_conv", "resize"]
