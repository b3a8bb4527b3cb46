"""CSV data read by spawned worker processes.

The port of ``geo_deep_learning_tpu/data/grain_pipeline.py``
(``GrainCSVDataModule``). That module's docstring promises multiprocess
workers, true parallel decode outside the interpreter lock; its code passes
``grain.ReadOptions(num_threads=...)``, which are threads. This one gives
what the docstring states, on ``torch.utils.data.DataLoader`` (the card's
machine has no ``grain``), as a drop-in for ``CSVDataModule``:

- one ``DataLoader`` a module, whose ``num_workers`` processes are started
  with ``spawn`` (never ``fork``: the parent holds a CUDA context) at the
  first batch and persist across epochs; the splits share them, one split
  at a time;
- the workers' items are whole batches: the main process plans each
  batch's sample indices, one worker reads and collates the batch
  (``default_collate``, which stacks into shared memory in a worker) and
  adds ``valid_count``, about :data:`IN_FLIGHT` batches ahead (at least one
  a worker);
- batches come pinned when the run's device is CUDA (:meth:`set_device`);
- every batch wait has a time limit (:data:`BATCH_TIMEOUT_S`); a worker's exception
  is raised in the consumer with its message, and a worker that dies
  raises rather than hangs; either closes the workers;
- :meth:`close` stops the workers and the pin thread (``cli.main.run``
  calls it in a ``finally``).

Order. Grain's own shuffle cannot be reproduced without ``grain``. The
train order of epoch ``e`` is the threaded loader's
(``np.random.default_rng(seed + e)``'s permutation, the last partial batch
dropped), so train batches equal ``CSVDataModule``'s bit for bit. Val and
test batches follow the JAX ``_EpochIterable``: in order, the last batch
short and unpadded with ``valid_count`` its length, and ``__len__`` the
JAX one. Under a ``torch.distributed`` group every rank plans the same
global batches and its workers read only its rows of each
(``data.loader.rank_batches``). Nothing imported here touches CUDA: each
spawned worker imports this module.
"""

from __future__ import annotations

import logging
import time
from typing import Iterator, Sequence

import torch
from torch.utils.data import DataLoader, default_collate

from geo_deep_learning_tpu_torch.data.datamodule import CSVDataModule
from geo_deep_learning_tpu_torch.data.loader import index_batches, rank_batches

logger = logging.getLogger(__name__)

BATCH_TIMEOUT_S = 120.0  # the longest wait for one batch, worker start-up included
IN_FLIGHT = 4  # batches read ahead, as grain.ReadOptions(prefetch_buffer_size=4)


def _worker_init(worker_id: int) -> None:
    """Each worker decodes on one thread and touches no CUDA."""
    del worker_id
    torch.set_num_threads(1)


class _Batches:
    """The workers' dataset: item ``(split, indices, keys)`` is one whole
    batch, the keys (``valid_count``, a rank's row keys) added to it."""

    def __init__(self, datasets: dict) -> None:
        self.datasets = datasets

    def __getitem__(self, item: tuple[str, list[int], dict]) -> dict:
        split, indices, keys = item
        batch = default_collate([self.datasets[split][i] for i in indices])
        batch.update(keys)
        return batch


class _SplitLoader:
    """One split's batches as an epoch iterable over the module's workers:
    train shuffled by epoch with the last partial batch dropped, val and
    test in order with a short last batch."""

    def __init__(self, dm: GrainCSVDataModule, split: str, train: bool) -> None:
        self.dm = dm
        self.split = split
        self.train = train
        self.epoch = 0

    def __len__(self) -> int:
        n, bs = len(self.dm.datasets[self.split]), self.dm.batch_size
        return n // bs if self.train else -(-n // bs)

    def __iter__(self) -> Iterator[dict]:
        plan = index_batches(len(self.dm.datasets[self.split]), self.dm.batch_size,
                             self.train, self.dm.seed + self.epoch, self.train, False)
        if self.train:
            self.epoch += 1
        return self.dm._read(self.split, rank_batches(plan))


class GrainCSVDataModule(CSVDataModule):
    """``CSVDataModule``'s surface (the JAX ``grain_pipeline.py:42-56``
    signature; ``patch_size`` ignored) on spawned worker processes."""

    def __init__(
        self,
        csv_root_folder: str,
        patches_root_folder: str,
        batch_size: int = 4,
        num_workers: int = 8,
        mean: Sequence[float] | None = None,
        std: Sequence[float] | None = None,
        patch_size: Sequence[int] = (512, 512),
        band_indices: Sequence[int] | None = None,
        device_preprocess: bool = False,
        data_type_max: float = 255.0,
        seed: int = 42,
    ) -> None:
        super().__init__(csv_root_folder, patches_root_folder, batch_size, num_workers, mean,
                         std, patch_size, band_indices, device_preprocess, data_type_max, seed)
        self.pin_memory = False
        self.startup_s: float | None = None  # the last start's wait for its first batch
        # the loader's sampler: the items of the pass being read, replaced in
        # place before each pass (each pass iterates it anew)
        self._plan: list[tuple[str, list[int], dict]] = []
        self._loader: DataLoader | None = None
        self._loader_key: tuple | None = None
        self._reading = False

    def set_device(self, device: torch.device | str) -> None:
        """Pin batches when the run's device is CUDA."""
        self.pin_memory = torch.device(device).type == "cuda"

    def train_dataloader(self) -> _SplitLoader:
        return _SplitLoader(self, "trn", train=True)

    def val_dataloader(self) -> _SplitLoader:
        return _SplitLoader(self, "val", train=False)

    def test_dataloader(self) -> _SplitLoader:
        if "tst" not in self.datasets:
            self.setup("test")
        return _SplitLoader(self, "tst", train=False)

    def _workers(self) -> DataLoader:
        """The module's loader; rebuilt (new workers) when the datasets the
        workers were spawned with, or the pinning, changed."""
        key = (tuple(sorted(self.datasets)), self.pin_memory)
        if self._loader is not None and key != self._loader_key:
            self.close()
        if self._loader is None:
            workers = max(1, self.num_workers)
            self._loader = DataLoader(
                _Batches(dict(self.datasets)), batch_size=None, sampler=self._plan,
                num_workers=workers, pin_memory=self.pin_memory,
                timeout=BATCH_TIMEOUT_S, worker_init_fn=_worker_init,
                multiprocessing_context="spawn", persistent_workers=True,
                prefetch_factor=max(1, -(-IN_FLIGHT // workers)),
            )
            self._loader_key = key
        return self._loader

    def _read(self, split: str, chunks: list[tuple[list[int], dict]]) -> Iterator[dict]:
        if self._reading:
            msg = "GrainCSVDataModule reads one split at a time; finish or close the other pass"
            raise RuntimeError(msg)
        self._reading = True
        try:
            if not chunks:
                return
            loader = self._workers()
            starting = getattr(loader, "_iterator", None) is None
            self._plan[:] = [(split, chunk, keys) for chunk, keys in chunks]
            t0 = time.perf_counter()
            for batch in loader:
                if starting:
                    starting = False
                    self.startup_s = time.perf_counter() - t0
                    logger.info("%d spawned worker processes: first batch after %.2f s",
                                loader.num_workers, self.startup_s,
                                extra={"startup_s": self.startup_s})
                yield batch
        except GeneratorExit:
            raise
        except BaseException:
            self.close()
            raise
        finally:
            self._reading = False

    def close(self) -> None:
        """Stop the worker processes and the pin thread, if started."""
        loader, self._loader, self._loader_key = self._loader, None, None
        it = getattr(loader, "_iterator", None)
        if it is not None:  # DataLoader has no public stop for persistent workers
            it._shutdown_workers()
            loader._iterator = None
