"""Multi-sensor streaming data module: batch-level mixing over tar shards.

The port's own copy of ``geo_deep_learning_tpu/data/multisensor.py``
(reference ``datamodules/wds_datamodule.py``): one ``ShardedDataset`` per
sensor and split from a sensor registry; each sensor's stream is batched
on its own and whole batches are mixed across sensors with equal (or
``mix_probs``) probability until all are exhausted, so every batch is
single-sensor and 3- and 4-band sensors share an epoch. A training epoch
is bounded to ``epoch_size`` samples and, where the data is smaller,
restarts the sensor's stream with a new shuffle (webdataset's
``with_epoch``). Train drops the partial tail batch; val and test pad it
by wraparound and carry ``valid_count``. The batch sequence equals the
JAX package's for the same seed: the mixing seed of an epoch is
``mix_seed + epoch`` read after the epoch counter moved on, and a cycled
stream restarts at ``start_epoch + 7919 * pass``.

Threads, unlike the JAX producer (which blocks forever on a full queue
once the consumer stops, and ends an epoch silently on a reader error):
one daemon producer thread named ``gdl-loader-stream`` a loader; every
wait has a time limit and rechecks a stop event; a producer's exception is
raised in the consumer; a generator that is closed or dropped sets the
stop event and joins the thread for at most 5 s (``data/loader.py``).
"""

from __future__ import annotations

import itertools
import logging
import queue
import threading
from typing import Any, Iterator

import numpy as np

from geo_deep_learning_tpu_torch.data.loader import JOIN_S, POLL_S, THREAD_PREFIX, collate
from geo_deep_learning_tpu_torch.data.shard_dataset import (
    ShardedDataset,
    create_shard_split_paths,
    load_sensor_configs,
)

logger = logging.getLogger(__name__)

_BATCH, _END, _ERROR = range(3)


def random_mix(
    streams: list[Iterator], seed: int = 0, probs: list[float] | None = None
) -> Iterator:
    """Item-wise random mixing, equal probability (or ``probs``), until all
    streams are exhausted (``wds.RandomMix(longest=True)``)."""
    rng = np.random.default_rng(seed)
    alive = list(streams)
    weights = list(probs) if probs else [1.0] * len(alive)
    while alive:
        i = rng.choice(len(alive), p=np.asarray(weights) / np.sum(weights))
        try:
            yield next(alive[i])
        except StopIteration:
            del alive[i]
            del weights[i]


class _Produced:
    """The items of ``items`` made by one daemon thread, at most ``depth``
    ahead of the consumer."""

    def __init__(self, items: Iterator, depth: int) -> None:
        self.queue: queue.Queue = queue.Queue(maxsize=max(1, depth))
        self.stop = threading.Event()
        self.thread = threading.Thread(target=self._run, args=(items,), daemon=True,
                                       name=f"{THREAD_PREFIX}-stream")
        self.thread.start()

    def _put(self, entry: tuple) -> bool:
        while not self.stop.is_set():
            try:
                self.queue.put(entry, timeout=POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _run(self, items: Iterator) -> None:
        try:
            for item in items:
                if not self._put((_BATCH, item)):
                    return
        except BaseException as err:  # re-raised in the consumer
            self._put((_ERROR, err))
            return
        self._put((_END, None))

    def __iter__(self) -> Iterator:
        try:
            while True:
                try:
                    kind, item = self.queue.get(timeout=POLL_S)
                except queue.Empty:
                    if not self.thread.is_alive() and self.queue.empty():
                        msg = "stream producer thread ended without finishing its epoch"
                        raise RuntimeError(msg) from None
                    continue
                if kind == _END:
                    return
                if kind == _ERROR:
                    raise item
                yield item
        finally:
            self.stop.set()
            self.thread.join(JOIN_S)


class StreamBatcher:
    """Batch a sample stream (or per-sensor streams) into collated numpy
    batches with static shapes. ``make_stream(epoch)`` returns one stream or
    a list of per-sensor streams; ``epoch_size`` (in samples) bounds one
    epoch of an otherwise endless stream and gives ``len``."""

    def __init__(
        self,
        make_stream,
        batch_size: int,
        drop_partial: bool,
        epoch_size: int | None = None,
        prefetch: int = 2,
        mix_seed: int = 0,
        mix_probs: list[float] | None = None,
        cycle: bool = False,
    ) -> None:
        self.make_stream = make_stream
        self.batch_size = batch_size
        self.drop_partial = drop_partial
        self.epoch_size = epoch_size
        self.prefetch = prefetch
        self.mix_seed = mix_seed
        self.mix_probs = mix_probs
        self.cycle = cycle
        self.epoch = 0

    def __len__(self) -> int:
        if self.epoch_size is None:
            msg = "stream length unknown without epoch_size"
            raise TypeError(msg)
        if self.drop_partial:
            return self.epoch_size // self.batch_size
        return -(-self.epoch_size // self.batch_size)

    def _cycled(self, idx: int, first, start_epoch: int) -> Iterator[dict]:
        """``with_epoch`` semantics: when a stream runs out before
        ``epoch_size``, restart it as a fresh pass with a new shuffle order
        (epoch ``start_epoch + 7919 * pass``); lazy, so a stream that covers
        the epoch never restarts."""
        yield from first
        pass_idx = 1
        while True:
            streams = self.make_stream(start_epoch + 7919 * pass_idx)
            yield from streams[idx] if isinstance(streams, (list, tuple)) else streams
            pass_idx += 1

    def _batches(self, stream, cap_samples: bool = True) -> Iterator[dict]:
        buf: list[dict] = []
        count = 0
        for sample in stream:
            buf.append(sample)
            count += 1
            if len(buf) == self.batch_size:
                batch = collate(buf)
                batch["valid_count"] = np.int32(self.batch_size)
                yield batch
                buf = []
            if cap_samples and self.epoch_size is not None and count >= self.epoch_size:
                break
        if buf and not self.drop_partial:
            valid = len(buf)
            while len(buf) < self.batch_size:  # pad with wraparound
                buf.append(buf[len(buf) % valid])
            batch = collate(buf)
            batch["valid_count"] = np.int32(valid)
            yield batch

    def _mixed_batches(self, streams: list) -> Iterator[dict]:
        """Batch each sensor's stream on its own, then mix whole batches (the
        reference batches each sensor before ``RandomMix``): every batch is
        single-sensor."""
        gens = [self._batches(s, cap_samples=False) for s in streams]
        mixed = random_mix(gens, seed=self.mix_seed + self.epoch, probs=self.mix_probs)
        if self.epoch_size is not None and (self.drop_partial or self.cycle):
            # cycled per-sensor streams are endless: the islice is the cap
            mixed = itertools.islice(mixed, len(self))
        return mixed

    def __iter__(self) -> Iterator[dict]:
        stream = self.make_stream(self.epoch)
        epoch0 = self.epoch
        self.epoch += 1
        streams = list(stream) if isinstance(stream, (list, tuple)) else [stream]
        if self.cycle and self.epoch_size is not None:
            streams = [self._cycled(i, s, epoch0) for i, s in enumerate(streams)]
        batches = self._mixed_batches(streams) if len(streams) > 1 else self._batches(streams[0])
        yield from _Produced(batches, self.prefetch)


class MultiSensorDataModule:
    """Per-sensor sharded datasets from a sensor registry, mixed into
    single-sensor batches. ``num_workers`` is accepted for the recipes'
    sake; as in the JAX package, each loader streams in one producer thread
    (one worker's shard stride), which fixes the batch sequence."""

    def __init__(
        self,
        sensor_configs_path: str,
        model_type: str = "clay",
        batch_size: int = 16,
        num_workers: int = 4,
        epoch_size: int | None = None,
        shuffle_buffer: int = 1000,
        shardshuffle: int | None = 100,
        seed: int = 42,
        mix_probs: list[float] | None = None,
    ) -> None:
        self.sensor_configs_path = sensor_configs_path
        self.model_type = model_type
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.epoch_size = epoch_size
        self.shuffle_buffer = shuffle_buffer
        self.shardshuffle = shardshuffle
        self.seed = seed
        self.mix_probs = mix_probs
        self.datasets: dict[str, dict[str, ShardedDataset]] = {}

    def setup(self, stage: str | None = None) -> None:
        sensor_configs = load_sensor_configs(self.sensor_configs_path)
        self.datasets = {}
        for sensor_name, config in sensor_configs.items():
            self.datasets[sensor_name] = {}
            for split in ("trn", "val", "tst"):
                try:
                    shard_paths, patch_count = create_shard_split_paths(
                        manifest_path=config["manifest_path"],
                        split=split,
                        parent_dir=config.get("parent_dir"),
                    )
                except (FileNotFoundError, KeyError) as e:
                    logger.warning("manifest issue for %s/%s: %s", sensor_name, split, e)
                    continue
                if not shard_paths:
                    logger.warning("No shards found for %s %s split", sensor_name, split)
                    continue
                self.datasets[sensor_name][split] = ShardedDataset(
                    sensor_name=sensor_name,
                    shard_paths=shard_paths,
                    patch_count=patch_count,
                    normalization_stats_path=config["stats_path"],
                    model_type=self.model_type,
                    split=split,
                    batch_size=self.batch_size,
                    shuffle_buffer=self.shuffle_buffer,
                    shardshuffle=self.shardshuffle,
                    seed=self.seed,
                    epoch_size=self.epoch_size,
                    wavelength_keys=config.get("wavelength_keys"),
                )
                logger.info("Created dataset for %s %s split (%s shards) with %s patches",
                            sensor_name, split, len(shard_paths), patch_count)

    def _loader(self, split: str, drop_partial: bool) -> StreamBatcher | None:
        sensors = [splits[split] for splits in self.datasets.values() if split in splits]
        if not sensors:
            logger.warning("No %s datasets found!", split)
            return None

        def make_stream(epoch: int) -> list[Iterator[dict[str, Any]]]:
            return [ds.iter_samples(epoch=epoch) for ds in sensors]

        total = sum(ds.patch_count for ds in sensors)
        return StreamBatcher(
            make_stream,
            batch_size=self.batch_size,
            drop_partial=drop_partial,
            epoch_size=self.epoch_size if split == "trn" else total,
            mix_seed=self.seed,
            mix_probs=self.mix_probs,
            # a configured train epoch_size is a guarantee: the stream cycles
            # where the dataset is smaller
            cycle=split == "trn" and self.epoch_size is not None,
        )

    def train_dataloader(self) -> StreamBatcher | None:
        return self._loader("trn", drop_partial=True)

    def val_dataloader(self) -> StreamBatcher | None:
        return self._loader("val", drop_partial=False)

    def test_dataloader(self) -> StreamBatcher | None:
        return self._loader("tst", drop_partial=False)
