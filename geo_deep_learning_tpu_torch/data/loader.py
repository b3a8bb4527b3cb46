"""Single-process batched loader.

Port of the evaluation path of ``geo_deep_learning_tpu/data/loader.py``
without its thread pool: samples are read in the calling thread and
collated into numpy batches, so the loader starts no thread and no
process. Batch shapes stay static: the final partial batch is padded with
wrap-around samples, and every batch carries ``valid_count``, the number
of real samples in it. (Shuffling and ``drop_last`` come with training.)
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
    """Batches of ``batch_size`` in dataset order; the last batch is padded
    with wrap-around samples and ``valid_count`` holds its real size."""

    def __init__(self, dataset, batch_size: int = 4) -> None:
        self.dataset = dataset
        self.batch_size = batch_size

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.batch_size)

    def __iter__(self) -> Iterator[dict]:
        n = len(self.dataset)
        for start in range(0, n, self.batch_size):
            chunk = list(range(start, min(start + self.batch_size, n)))
            valid = len(chunk)
            chunk += list(range(self.batch_size - valid))
            batch = collate([self.dataset[i] for i in chunk])
            batch["valid_count"] = valid
            yield batch
