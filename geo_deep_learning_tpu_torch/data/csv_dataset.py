"""CSV-indexed GeoTIFF patch dataset.

Port of ``geo_deep_learning_tpu/data/csv_dataset.py``: semicolon-separated
``{split}.csv`` files (``image;mask``) under a patches root. Each sample is
the batch-dict contract ``{"image", "mask", "image_name", "mask_name",
"mean", "std"}`` with HWC images and HW int64 masks. With
``device_preprocess`` a uint8 image stays raw; normalization then runs on
the device (kernel K1).
"""

from __future__ import annotations

import csv
import logging
from pathlib import Path

import numpy as np

from geo_deep_learning_tpu_torch.data.geotiff import read_geotiff

logger = logging.getLogger(__name__)


class CSVDataset:
    def __init__(
        self,
        csv_root_folder: str,
        patches_root_folder: str,
        split: str = "trn",
        norm_stats: dict[str, list[float]] | None = None,
        band_indices: list[int] | None = None,
        device_preprocess: bool = False,
        data_type_max: float = 255.0,
    ) -> None:
        self.csv_root_folder = Path(csv_root_folder)
        self.patches_root_folder = Path(patches_root_folder)
        self.split = split
        self.norm_stats = norm_stats or {"mean": [0.0], "std": [1.0]}
        self.band_indices = band_indices
        self.device_preprocess = device_preprocess
        self.data_type_max = float(data_type_max)
        self.files = self._load_files()
        logger.info("Created dataset for %s split with %s patches", split, len(self.files))

    def _load_files(self) -> list[dict[str, Path]]:
        csv_path = self.csv_root_folder / f"{self.split}.csv"
        if not csv_path.exists():
            msg = f"CSV file {csv_path} not found."
            raise FileNotFoundError(msg)
        out = []
        with csv_path.open() as f:
            for row in csv.reader(f, delimiter=";"):
                if not row:
                    continue
                if len(row) < 2:
                    msg = "CSV file must contain at least two columns: image_path;mask_path"
                    raise ValueError(msg)
                out.append({
                    "image": self.patches_root_folder / row[0],
                    "mask": self.patches_root_folder / row[1],
                })
        return out

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, index: int) -> dict:
        entry = self.files[index]
        image, _ = read_geotiff(entry["image"])
        if self.band_indices is not None:
            image = image[..., self.band_indices]
        mean = np.asarray(self.norm_stats["mean"], dtype=np.float32)
        std = np.asarray(self.norm_stats["std"], dtype=np.float32)
        if not (self.device_preprocess and image.dtype == np.uint8):
            image = image.astype(np.float32) / self.data_type_max
            image = (image - mean) / std
        mask, _ = read_geotiff(entry["mask"])
        return {
            "image": image,
            "mask": mask[..., 0].astype(np.int64),
            "image_name": entry["image"].name,
            "mask_name": entry["mask"].name,
            "mean": mean,
            "std": std,
        }
