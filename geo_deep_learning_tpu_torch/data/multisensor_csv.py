"""Map-style multi-sensor data module driven by the round-robin sampler.

The port's own copy of ``geo_deep_learning_tpu/data/multisensor_csv.py``:
one CSV patch dataset per sensor (its own ``band_indices``, ``mean``,
``std`` and optional ``wavelengths``), training batches cycling sensors
with equal / proportional / custom weights (``data/samplers.py``), each
batch single-sensor, so its per-sample statistics and wavelengths are
batch-constant, as DOFA requires. With ``device_preprocess`` a uint8 batch
stays raw and is normalized on the card (kernel K1) with its collated
``[B, C]`` statistics. Evaluation runs the sensors one after another with
padded tail batches. The batch sequence equals the JAX package's.

Reading: each epoch's batches are read by ``num_workers`` daemon threads of
``data/loader.py`` (waits with time limits, a reader's exception raised in
the consumer, threads joined with a time limit when the consumer leaves)
where the JAX package uses a ``ThreadPoolExecutor``.
"""

from __future__ import annotations

import logging
from typing import Any, Iterator

import numpy as np

from geo_deep_learning_tpu_torch.core.mesh import Mesh, data_rank, local_batch_to_global
from geo_deep_learning_tpu_torch.data.csv_dataset import CSVDataset
from geo_deep_learning_tpu_torch.data.loader import DataLoader, _Prefetch, rank_batches
from geo_deep_learning_tpu_torch.data.samplers import create_round_robin_sampler

logger = logging.getLogger(__name__)


class _BySensor:
    """``(sensor, index)`` -> that sensor's sample, for the reader threads."""

    def __init__(self, datasets: dict[str, CSVDataset]) -> None:
        self.datasets = datasets

    def __getitem__(self, key: tuple[str, int]) -> dict:
        sensor, index = key
        return self.datasets[sensor][index]


def _tag(batch: dict, sensor: str, wavelengths: list[float] | None) -> dict:
    n = len(batch["image"])
    batch["platform"] = [sensor] * n
    if wavelengths is not None:
        batch["wavelengths"] = np.tile(np.asarray(wavelengths, np.float32), (n, 1))
    return batch


class RoundRobinLoader:
    """The sampler's ``(sensor, indices)`` batches, read and collated."""

    def __init__(
        self,
        datasets: dict[str, CSVDataset],
        sampler,
        wavelengths: dict[str, list[float]] | None = None,
        num_workers: int = 8,
        prefetch: int = 2,
    ) -> None:
        self.datasets = datasets
        self.sampler = sampler
        self.wavelengths = wavelengths or {}
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.sampler)

    def __iter__(self) -> Iterator[dict[str, Any]]:
        self.sampler.set_epoch(self.epoch)
        self.epoch += 1
        order = list(self.sampler)
        if not order:
            return
        batches = [([(sensor, i) for i in idx], len(idx)) for sensor, idx in order]
        # the distributed sampler's batches are this rank's own (the
        # reference's per-rank batches); other batches are global ones
        own = getattr(self.sampler, "num_replicas", 1) > 1
        if own:
            batches = [(chunk, {"valid_count": valid}) for chunk, valid in batches]
        else:
            batches = rank_batches(batches)
        reader = _Prefetch(_BySensor(self.datasets), batches, self.num_workers, self.prefetch)
        try:
            for (sensor, _), batch in zip(order, reader):
                batch["valid_count"] = np.int32(batch["valid_count"])
                if own:
                    batch = local_batch_to_global(batch, Mesh(*data_rank()))
                yield _tag(batch, sensor, self.wavelengths.get(sensor))
        finally:
            reader.close()


class _SensorChain:
    """Evaluation: each sensor's padded batches in turn."""

    def __init__(self, loaders: list[tuple[str, DataLoader]], wavelengths: dict) -> None:
        self.loaders = loaders
        self.wavelengths = wavelengths

    def __iter__(self) -> Iterator[dict[str, Any]]:
        for sensor, loader in self.loaders:
            for batch in loader:
                yield _tag(batch, sensor, self.wavelengths.get(sensor))


class MultiSensorCSVDataModule:
    """Per-sensor CSV datasets and weighted round-robin training batches.

    ``sensors`` maps a sensor name to a dict with ``csv_root_folder``,
    ``patches_root_folder``, ``mean``, ``std`` and optional ``wavelengths``
    (um, for DOFA) and ``band_indices``."""

    def __init__(
        self,
        sensors: dict[str, dict],
        batch_size: int = 8,
        num_workers: int = 8,
        weights: str | dict[str, int] = "equal",
        balance: bool = True,
        distributed: bool = False,
        device_preprocess: bool = False,
        seed: int = 42,
    ) -> None:
        self.sensors = sensors
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.weights = weights
        self.balance = balance
        self.distributed = distributed
        self.device_preprocess = device_preprocess
        self.seed = seed
        self.datasets: dict[str, dict[str, CSVDataset]] = {}

    def _make(self, sensor: str, split: str) -> CSVDataset:
        cfg = self.sensors[sensor]
        return CSVDataset(
            cfg["csv_root_folder"],
            cfg.get("patches_root_folder", cfg["csv_root_folder"]),
            split=split,
            norm_stats={"mean": cfg.get("mean", [0.0]), "std": cfg.get("std", [1.0])},
            band_indices=cfg.get("band_indices"),
            device_preprocess=self.device_preprocess,
        )

    def setup(self, stage: str = "fit") -> None:
        splits = {"fit": ("trn", "val"), "validate": ("val",), "test": ("tst",),
                  "predict": ("tst",)}[stage]
        for sensor in self.sensors:
            per = self.datasets.setdefault(sensor, {})
            for split in splits:
                if split not in per:
                    try:
                        per[split] = self._make(sensor, split)
                    except FileNotFoundError as e:
                        logger.warning("%s/%s: %s", sensor, split, e)
        if stage == "fit":
            for sensor in self.sensors:
                try:
                    self.datasets[sensor].setdefault("tst", self._make(sensor, "tst"))
                except FileNotFoundError:
                    pass

    def _wavelengths(self) -> dict[str, list[float]]:
        return {s: cfg["wavelengths"] for s, cfg in self.sensors.items() if "wavelengths" in cfg}

    def train_dataloader(self) -> RoundRobinLoader:
        sizes = {s: len(d["trn"]) for s, d in self.datasets.items() if "trn" in d}
        sampler = create_round_robin_sampler(
            sizes,
            distributed=self.distributed,
            batch_size=self.batch_size,
            weights=self.weights,
            balance=self.balance,
            seed=self.seed,
        )
        return RoundRobinLoader(
            {s: d["trn"] for s, d in self.datasets.items() if "trn" in d},
            sampler,
            wavelengths=self._wavelengths(),
            num_workers=self.num_workers,
        )

    def _eval_loader(self, split: str) -> _SensorChain:
        loaders = [
            (s, DataLoader(d[split], batch_size=self.batch_size, pad_partial=True,
                           num_workers=self.num_workers))
            for s, d in self.datasets.items()
            if split in d
        ]
        return _SensorChain(loaders, self._wavelengths())

    def val_dataloader(self) -> _SensorChain:
        return self._eval_loader("val")

    def test_dataloader(self) -> _SensorChain:
        return self._eval_loader("tst")
