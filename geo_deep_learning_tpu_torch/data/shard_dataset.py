"""Sharded-tar streaming dataset with multi-sensor support.

The port's own copy of ``geo_deep_learning_tpu/data/shard_dataset.py``
(reference ``datasets/wds_dataset.py``). The on-disk format is tar shards
whose members group by key prefix::

    <key>.image_patch.npy   (C, H, W) array
    <key>.label_patch.npy   (H, W) or (1, H, W) array
    <key>.metadata.json     {"metadata": {...}}

with a JSON manifest listing shards and patch counts per split
(:func:`create_shard_split_paths`), a sensor registry
(:func:`load_sensor_configs`: YAML, or JSON where PyYAML is absent) and
per-sensor normalization statistics whose mean/std are divided by 255.

Read with the stdlib ``tarfile`` alone. Distribution: a process takes every
``world``-th shard of ``trn`` and ``val`` at its rank when a
``torch.distributed`` process group is initialised (``test`` keeps all),
then worker ``w`` of ``n`` every ``n``-th of those. The shard shuffle of
epoch ``e`` draws from ``default_rng(seed + e)``, the sample shuffle
buffer from ``default_rng(seed + 7919 * (e + 1) + worker)``, as in the JAX
package, so both yield the same samples in the same order. Batch formats:
``clay`` (cyclical time + lat/lon encodings), ``dofa`` (per-band
wavelengths, cached per sensor) and ``unified`` (the raw metadata).
Images come out HWC float32, normalized; bad samples and unreadable
shards are skipped with a warning.
"""

from __future__ import annotations

import io
import json
import logging
import math
import tarfile
from datetime import datetime
from pathlib import Path
from typing import Any, Iterator

import numpy as np

logger = logging.getLogger(__name__)

DEFAULT_WAVELENGTH_KEYS = ("red_wavelength", "green_wavelength", "blue_wavelength",
                           "nir_wavelength")


def load_sensor_configs(config_path: str) -> dict[str, dict[str, Any]]:
    """The sensor registry: sensor name -> ``manifest_path``, ``stats_path``
    and optional ``parent_dir`` / ``wavelength_keys``. Read as YAML where
    PyYAML imports; without it, as JSON (which is YAML), so a registry for a
    machine without PyYAML must be JSON."""
    text = Path(config_path).read_text()
    try:
        import yaml
    except ImportError:
        return json.loads(text)
    return yaml.safe_load(text)


def create_shard_split_paths(
    manifest_path: str,
    split: str,
    parent_dir: str | None = None,
) -> tuple[list[str], int]:
    """Manifest JSON -> (shard paths, patch count) of a split."""
    shard_parent = (
        Path(manifest_path).parent / split if parent_dir is None else Path(parent_dir) / split
    )
    with Path(manifest_path).open() as f:
        data = json.load(f)
    shard_data = data["shards"][split]
    patch_count = data["statistics"]["patch_counts"][split]
    return [(shard_parent / item["path"]).as_posix() for item in shard_data], patch_count


def encode_temporal(datetime_str: str) -> np.ndarray:
    """``[week_sin, week_cos, hour_sin, hour_cos]`` (CLAY format); zeros
    with a warning where the string does not parse."""
    try:
        if datetime_str.endswith("Z"):
            datetime_str = datetime_str[:-1] + "+00:00"
        dt = datetime.fromisoformat(datetime_str)
        week_rad = (dt.isocalendar().week / 52.0) * 2 * math.pi
        hour_rad = (dt.hour / 24.0) * 2 * math.pi
        return np.array(
            [math.sin(week_rad), math.cos(week_rad), math.sin(hour_rad), math.cos(hour_rad)],
            dtype=np.float32,
        )
    except (ValueError, AttributeError) as e:
        logger.warning("Error parsing datetime: %s %s", datetime_str, e)
        return np.zeros(4, dtype=np.float32)


def encode_spatial(lat: float, lon: float) -> np.ndarray:
    """``[lat_sin, lat_cos, lon_sin, lon_cos]``; zeros with a warning on bad
    coordinates."""
    try:
        lat_r, lon_r = math.radians(lat), math.radians(lon)
        return np.array(
            [math.sin(lat_r), math.cos(lat_r), math.sin(lon_r), math.cos(lon_r)],
            dtype=np.float32,
        )
    except (TypeError, ValueError) as e:
        logger.warning("Error parsing coordinates: %s %s %s", lat, lon, e)
        return np.zeros(4, dtype=np.float32)


def iter_tar_samples(shard_path: str) -> Iterator[dict[str, Any]]:
    """Stream grouped samples out of one tar shard.

    Members sharing a key prefix (the text before the first '.') form one
    sample; ``.npy`` members decode to arrays, ``.json`` to dicts, others
    stay bytes. A group is emitted when the key changes (webdataset's
    sequential grouping)."""
    current_key: str | None = None
    sample: dict[str, Any] = {}
    with tarfile.open(shard_path, "r|*") as tar:  # streaming mode
        for member in tar:
            if not member.isfile():
                continue
            data = tar.extractfile(member).read()
            key, _, field = Path(member.name).name.partition(".")
            if current_key is not None and key != current_key and sample:
                sample["__key__"] = current_key
                yield sample
                sample = {}
            current_key = key
            if field.endswith("npy"):
                sample[field] = np.load(io.BytesIO(data), allow_pickle=False)
            elif field.endswith("json"):
                sample[field] = json.loads(data)
            else:
                sample[field] = data
    if sample and current_key is not None:
        sample["__key__"] = current_key
        yield sample


def process_rank() -> tuple[int, int]:
    """``(rank, world size)`` of an initialised ``torch.distributed`` group,
    else ``(0, 1)``."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class ShardedDataset:
    """One sensor's split as a stream of processed samples."""

    def __init__(
        self,
        sensor_name: str,
        shard_paths: list[str],
        patch_count: int,
        normalization_stats_path: str,
        model_type: str = "clay",
        split: str = "trn",
        batch_size: int = 16,
        shuffle_buffer: int = 1000,
        shardshuffle: int | None = None,
        seed: int = 42,
        epoch_size: int | None = None,
        wavelength_keys: list[str] | None = None,
    ) -> None:
        self.sensor_name = sensor_name
        self.shard_paths = shard_paths
        self.patch_count = patch_count
        self.model_type = model_type
        self.split = split
        self.batch_size = batch_size
        self.shuffle_buffer = shuffle_buffer
        self.shardshuffle = shardshuffle
        self.seed = seed
        self.epoch_size = epoch_size
        self.wavelength_keys = wavelength_keys
        self.norm_stats = self._load_normalization_stats(normalization_stats_path)
        self._wavelengths_cache: dict[str, np.ndarray] = {}

    def _load_normalization_stats(self, stats_path: str) -> dict[str, Any]:
        with Path(stats_path).open() as f:
            data = json.load(f)
        stats = data["statistics"][self.sensor_name]
        return {
            "mean": np.asarray(stats["mean"], dtype=np.float32) / 255.0,
            "std": np.asarray(stats["std"], dtype=np.float32) / 255.0,
            "band_count": stats["band_count"],
            "patch_count": stats.get("patch_count"),
            "dtype": stats.get("dtype"),
        }

    def process_sample(self, sample: dict[str, Any]) -> dict[str, Any]:
        image = sample["image_patch.npy"].astype(np.float32)
        if image.ndim == 3:  # stored CHW -> channel-last
            image = np.transpose(image, (1, 2, 0))
        label = sample["label_patch.npy"]
        if label.ndim == 3:
            label = label[0] if label.shape[0] < label.shape[-1] else label[..., 0]
        label = label.astype(np.int32)
        metadata = sample.get("metadata.json", {})

        mean, std = self.norm_stats["mean"], self.norm_stats["std"]
        image = image / 255.0
        image = (image - mean) / std

        out = {
            "image": image,
            "mask": label,
            "platform": self.sensor_name,
            "image_name": sample.get("__key__", ""),
            "mean": mean,
            "std": std,
        }
        if self.model_type == "clay":
            meta = metadata.get("metadata", {})
            out["time"] = encode_temporal(meta.get("datetime", "0.0"))
            out["latlon"] = encode_spatial(
                meta.get("coordinates_lat", 0.0), meta.get("coordinates_lon", 0.0)
            )
        elif self.model_type == "dofa":
            out["wavelengths"] = self._extract_wavelengths(metadata)
        else:  # unified
            out["metadata"] = metadata
        return out

    def _extract_wavelengths(self, metadata: dict[str, Any]) -> np.ndarray:
        keys = self.wavelength_keys or list(DEFAULT_WAVELENGTH_KEYS)
        cache_key = f"{self.sensor_name}_{'_'.join(keys)}"
        try:
            meta = metadata["metadata"]
            values = [float(meta[k]) for k in keys if k in meta]
            if not values:
                msg = "no wavelength keys present"
                raise KeyError(msg)
            if cache_key not in self._wavelengths_cache:
                self._wavelengths_cache[cache_key] = np.asarray(values, np.float32)
            return self._wavelengths_cache[cache_key]
        except (KeyError, TypeError, ValueError) as e:
            logger.warning("Error extracting wavelengths: %s", e)
            return np.zeros(len(keys), dtype=np.float32)

    def _assigned_shards(self, epoch: int) -> list[str]:
        """This process's shards: rank striding for ``trn`` and ``val``
        (``tst`` keeps all), then the seeded shuffle of ``trn``."""
        shards = sorted(self.shard_paths)
        if self.split in ("trn", "val"):
            rank, world = process_rank()
            if world > 1:
                shards = shards[rank::world]
        if self.split == "trn" and self.shardshuffle:
            rng = np.random.default_rng(self.seed + epoch)
            shards = list(rng.permutation(shards))
        return shards

    def iter_samples(
        self,
        epoch: int = 0,
        worker_index: int = 0,
        worker_count: int = 1,
    ) -> Iterator[dict[str, Any]]:
        """Decoded, processed sample stream of one worker."""
        shards = self._assigned_shards(epoch)[worker_index::worker_count]
        rng = np.random.default_rng(self.seed + 7919 * (epoch + 1) + worker_index)
        buffer: list[dict[str, Any]] = []
        use_shuffle = self.split == "trn" and self.shuffle_buffer > 1
        for shard in shards:
            try:
                for raw in iter_tar_samples(shard):
                    try:
                        sample = self.process_sample(raw)
                    except Exception as e:  # noqa: BLE001 (the reference's warn_and_continue)
                        logger.warning("skipping bad sample in %s: %s", shard, e)
                        continue
                    if use_shuffle:
                        buffer.append(sample)
                        if len(buffer) >= self.shuffle_buffer:
                            idx = rng.integers(len(buffer))
                            buffer[idx], buffer[-1] = buffer[-1], buffer[idx]
                            yield buffer.pop()
                    else:
                        yield sample
            except (OSError, tarfile.TarError) as e:
                logger.warning("skipping unreadable shard %s: %s", shard, e)
        if use_shuffle:
            for i in rng.permutation(len(buffer)):
                yield buffer[i]
