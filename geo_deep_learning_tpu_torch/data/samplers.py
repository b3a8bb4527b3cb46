"""Round-robin multi-sensor batch samplers (a map-style alternative to mixing).

The port's own copy of ``geo_deep_learning_tpu/data/samplers.py``
(reference ``samplers/round_robin_sampler.py``): cycle sensors batch by
batch with equal / proportional / custom integer weights, optionally
balancing dataset lengths by index replication; plus a distributed
variant that slices each sensor's shuffled indices contiguously per
process, seeded per epoch by ``set_epoch``. The index sequences equal the
JAX package's for the same arguments. The distributed variant takes its
rank and world size from an initialised ``torch.distributed`` group where
they are not given.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np


class RoundRobinSampler:
    """Yields (sensor_name, batch_indices) cycling sensors per batch."""

    def __init__(
        self,
        dataset_sizes: dict[str, int],
        batch_size: int = 8,
        weights: str | dict[str, int] = "equal",
        balance: bool = True,
        shuffle: bool = True,
        seed: int = 42,
        drop_last: bool = True,
    ) -> None:
        self.dataset_sizes = dict(dataset_sizes)
        self.batch_size = batch_size
        self.balance = balance
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.weights = self._resolve_weights(weights)

    def _resolve_weights(self, weights) -> dict[str, int]:
        names = list(self.dataset_sizes)
        if weights == "equal":
            return {n: 1 for n in names}
        if weights == "proportional":
            smallest = min(self.dataset_sizes.values())
            return {
                n: max(1, round(self.dataset_sizes[n] / smallest)) for n in names
            }
        if isinstance(weights, dict):
            bad = [n for n, w in weights.items() if not isinstance(w, int) or w < 1]
            if bad:
                msg = f"weights must be positive integers, got {weights}"
                raise ValueError(msg)
            return {n: weights.get(n, 1) for n in names}
        msg = f"unknown weights spec {weights!r}"
        raise ValueError(msg)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices_for(self, name: str) -> np.ndarray:
        n = self.dataset_sizes[name]
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            idx = rng.permutation(idx)
        if self.balance:
            target = max(self.dataset_sizes.values())
            if n < target:  # replicate to balance lengths (ref :90-115)
                reps = -(-target // n)
                idx = np.tile(idx, reps)[:target]
        return idx

    def __iter__(self) -> Iterator[tuple[str, list[int]]]:
        names = list(self.dataset_sizes)
        per_sensor = {n: self._indices_for(n) for n in names}
        cursors = {n: 0 for n in names}
        # weighted round-robin order: sensor appears `weight` times per cycle
        cycle = [n for n in names for _ in range(self.weights[n])]
        exhausted: set[str] = set()
        while len(exhausted) < len(names):
            for name in cycle:
                if name in exhausted:
                    continue
                start = cursors[name]
                end = start + self.batch_size
                idx = per_sensor[name]
                if end > len(idx):
                    if self.drop_last or start >= len(idx):
                        exhausted.add(name)
                        continue
                    end = len(idx)
                cursors[name] = end
                yield name, idx[start:end].tolist()

    def __len__(self) -> int:
        total = 0
        for name in self.dataset_sizes:
            n = (
                max(self.dataset_sizes.values())
                if self.balance
                else self.dataset_sizes[name]
            )
            total += n // self.batch_size if self.drop_last else -(-n // self.batch_size)
        return total


class RoundRobinDistributedSampler(RoundRobinSampler):
    """Contiguous per-process slices of each sensor's shuffled indices
    (reference :263-324); ``num_replicas`` / ``rank`` default to the
    mesh's data-axis size and rank (``core.mesh.data_rank``; 1 and 0
    without a group)."""

    def __init__(
        self,
        dataset_sizes: dict[str, int],
        num_replicas: int | None = None,
        rank: int | None = None,
        **kwargs,
    ) -> None:
        from geo_deep_learning_tpu_torch.core.mesh import data_rank

        this_rank, world = data_rank()
        self.num_replicas = num_replicas or world
        self.rank = rank if rank is not None else this_rank
        if self.rank >= self.num_replicas:
            msg = f"rank {self.rank} >= num_replicas {self.num_replicas}"
            raise ValueError(msg)
        super().__init__(dataset_sizes, **kwargs)

    def _indices_for(self, name: str) -> np.ndarray:
        idx = super()._indices_for(name)
        per_rank = len(idx) // self.num_replicas
        start = self.rank * per_rank
        return idx[start : start + per_rank]


def create_round_robin_sampler(
    dataset_sizes: dict[str, int],
    distributed: bool = False,
    **kwargs,
) -> RoundRobinSampler:
    """Factory (reference :327-351)."""
    cls = RoundRobinDistributedSampler if distributed else RoundRobinSampler
    return cls(dataset_sizes, **kwargs)
