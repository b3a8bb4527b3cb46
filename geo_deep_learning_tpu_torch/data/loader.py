"""Batched loader with threaded prefetch.

Port of ``geo_deep_learning_tpu/data/loader.py``: ``num_workers`` reader
threads decode samples (GeoTIFF inflate releases the interpreter lock) and
collate them into numpy batches, at most ``prefetch`` batches ahead of the
consumer. Batch order and shapes follow the JAX package's loader exactly:

- ``shuffle``: the order of epoch ``e`` (counted per ``__iter__``) is
  ``np.random.default_rng(seed + e)``'s permutation, so it equals the JAX
  package's;
- ``drop_last`` drops the final partial batch (training);
- ``pad_partial`` pads it with wrap-around samples (evaluation).

Every batch carries ``valid_count``, the number of real samples in it.

Hang guards: the readers are daemon threads, so a read that never returns
cannot hold up the interpreter's exit; every wait has a time limit and
rechecks the stop flag; a reader's exception is raised in the consumer;
when the consumer leaves early (the generator is closed or dropped, or an
exception passes through it), the stop flag is set and each thread is
joined with a time limit.
"""

from __future__ import annotations

import threading
from typing import Any, Iterator

import numpy as np

THREAD_PREFIX = "gdl-loader"
POLL_S = 0.1  # longest wait before a thread rechecks the stop flag
JOIN_S = 5.0  # per-thread join limit when the consumer leaves


def collate(samples: list[dict]) -> dict:
    """Stack array fields; keep string/scalar fields as lists."""
    out: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class _Prefetch:
    """One epoch's batches, read by daemon threads sample by sample (in
    batch order) into a window of ``depth`` batches ahead of the consumer."""

    def __init__(self, dataset, batches: list[tuple[list[int], int]], workers: int,
                 depth: int) -> None:
        self.dataset = dataset
        self.batches = batches
        self.depth = depth
        self.tasks = [(b, s, i) for b, (chunk, _) in enumerate(batches) for s, i in enumerate(chunk)]
        self.samples: list[list | None] = [[None] * len(chunk) for chunk, _ in batches]
        self.left = [len(chunk) for chunk, _ in batches]
        self.ready: dict[int, dict] = {}
        self.next_task = 0
        self.taken = 0  # batches handed to the consumer
        self.error: BaseException | None = None
        self.stop = threading.Event()
        self.cond = threading.Condition()
        self.threads = [
            threading.Thread(target=self._work, name=f"{THREAD_PREFIX}-{k}", daemon=True)
            for k in range(workers)
        ]
        for t in self.threads:
            t.start()

    def _claim(self) -> tuple[int, int, int] | None:
        with self.cond:
            while not self.stop.is_set() and self.next_task < len(self.tasks):
                task = self.tasks[self.next_task]
                if task[0] < self.taken + self.depth:
                    self.next_task += 1
                    return task
                self.cond.wait(POLL_S)
        return None

    def _fail(self, err: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = err
            self.stop.set()
            self.cond.notify_all()

    def _work(self) -> None:
        while (task := self._claim()) is not None:
            b, s, index = task
            try:
                sample = self.dataset[index]
            except BaseException as err:  # re-raised in the consumer
                self._fail(err)
                return
            with self.cond:
                self.samples[b][s] = sample
                self.left[b] -= 1
                complete = self.left[b] == 0
            if not complete:
                continue
            try:
                batch = collate(self.samples[b])
            except BaseException as err:
                self._fail(err)
                return
            batch["valid_count"] = self.batches[b][1]
            with self.cond:
                self.samples[b] = None
                self.ready[b] = batch
                self.cond.notify_all()

    def __iter__(self) -> Iterator[dict]:
        try:
            for b in range(len(self.batches)):
                with self.cond:
                    while b not in self.ready:
                        if self.error is not None:
                            raise self.error
                        if not any(t.is_alive() for t in self.threads):
                            msg = f"loader threads ended before batch {b}"
                            raise RuntimeError(msg)
                        self.cond.wait(POLL_S)
                    batch = self.ready.pop(b)
                    self.taken = b + 1
                    self.cond.notify_all()
                yield batch
        finally:
            self.close()

    def close(self) -> None:
        with self.cond:
            self.stop.set()
            self.cond.notify_all()
        for t in self.threads:
            t.join(JOIN_S)


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 4,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_partial: bool = False,
        num_workers: int = 8,
        prefetch: int = 2,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_partial = pad_partial
        self.num_workers = max(1, num_workers)
        self.prefetch = max(1, prefetch)
        self.seed = seed
        self.epoch = 0

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return -(-n // self.batch_size)

    def _index_batches(self) -> list[tuple[list[int], int]]:
        """``(sample indices, valid count)`` of every batch of this epoch."""
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        batches = []
        for i in range(0, n, self.batch_size):
            chunk = idx[i : i + self.batch_size].tolist()
            valid = len(chunk)
            if valid < self.batch_size:
                if self.drop_last:
                    continue
                if self.pad_partial:
                    chunk += idx[: self.batch_size - valid].tolist()
            batches.append((chunk, valid))
        return batches

    def __iter__(self) -> Iterator[dict]:
        batches = self._index_batches()
        self.epoch += 1
        if batches:
            yield from _Prefetch(self.dataset, batches, self.num_workers, self.prefetch)
