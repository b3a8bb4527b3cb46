"""Single-process batched loader.

Port of ``geo_deep_learning_tpu/data/loader.py`` without its thread pool:
samples are read in the calling thread and collated into numpy batches, so
the loader starts no thread and no process. Batch order and shapes follow
the JAX package's loader exactly:

- ``shuffle``: the order of epoch ``e`` (counted per ``__iter__``) is
  ``np.random.default_rng(seed + e)``'s permutation, so it equals the JAX
  package's;
- ``drop_last`` drops the final partial batch (training);
- ``pad_partial`` pads it with wrap-around samples (evaluation).

Every batch carries ``valid_count``, the number of real samples in it.
"""

from __future__ import annotations

from typing import Any, Iterator

import numpy as np


def collate(samples: list[dict]) -> dict:
    """Stack array fields; keep string/scalar fields as lists."""
    out: dict[str, Any] = {}
    for key in samples[0]:
        vals = [s[key] for s in samples]
        out[key] = np.stack(vals) if isinstance(vals[0], np.ndarray) else vals
    return out


class DataLoader:
    def __init__(
        self,
        dataset,
        batch_size: int = 4,
        shuffle: bool = False,
        drop_last: bool = False,
        pad_partial: bool = False,
        seed: int = 0,
    ) -> None:
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.pad_partial = pad_partial
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
        for chunk, valid in batches:
            batch = collate([self.dataset[i] for i in chunk])
            batch["valid_count"] = valid
            yield batch
