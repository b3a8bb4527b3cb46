"""Checkpointing: best-by-monitor retention, ``last``, resume.

Port of ``CheckpointManager`` in ``geo_deep_learning_tpu/training/checkpoint.py``
(reference Lightning ``ModelCheckpoint`` with ``save_top_k=1``). A
checkpoint is one ``torch.save`` file of :meth:`TrainState.state_dict`
(model, optimizer, step, generators, plateau state), written to a
temporary name and renamed, so a file on disk is always whole. The best
score and path persist in ``index.json``, so a resumed run knows its best.
:func:`load_weights_from_checkpoint` warm-starts a model from such a file,
whole or by parts. Orbax compatibility with the JAX package's checkpoints
is not kept.

Data parallelism: with a ``mesh`` of several ranks, rank 0 alone writes
the files (the ranks' states are equal), then every rank waits for it; the
choice of the best is made on every rank from the same global metrics.
The state dict is the model's own (never a ``DistributedDataParallel``
wrapper's, so no ``module.`` prefix): a checkpoint of W ranks restores
into one rank and back, each rank with its own ``map_location``.

Tensor parallelism: the model ranks of data index 0 gather their shards
(``parallel.placement.gather_train_state``) and global rank 0 writes a
whole checkpoint of the same format; :meth:`CheckpointManager.restore` and
:meth:`CheckpointManager.load_model` read whole tensors and cut this rank's
shards (``local_train_state``), so a checkpoint of any layout restores
into any other, a one-process run included.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

import torch

from geo_deep_learning_tpu_torch.core.mesh import Mesh
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.parallel.collectives import barrier
from geo_deep_learning_tpu_torch.parallel.placement import (
    gather_train_state,
    local_state_dict,
    local_train_state,
)

logger = logging.getLogger(__name__)


class CheckpointManager:
    """Save / restore train states; keep the best one by a monitor."""

    def __init__(self, directory: str | Path, monitor: str = "val_loss", mode: str = "min",
                 mesh: Mesh | None = None) -> None:
        self.mesh = mesh or Mesh()
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best_score: float | None = None
        self.best_path: Path | None = None
        self._load_index()
        barrier(self.mesh)  # every rank has read the index before rank 0 may rewrite it

    def _index_file(self) -> Path:
        return self.directory / "index.json"

    def _load_index(self) -> None:
        if self._index_file().exists():
            idx = json.loads(self._index_file().read_text())
            self.best_score = idx.get("best_score")
            best = idx.get("best_path")
            self.best_path = Path(best) if best else None

    def _save_index(self) -> None:
        """Write ``index.json`` (global rank 0) by a temporary name and a
        rename, so that a rank reading it never sees half a file; then
        every rank waits for it."""
        if self.mesh.global_rank == 0:
            tmp = self._index_file().with_suffix(".json.tmp")
            tmp.write_text(json.dumps({
                "best_score": self.best_score,
                "best_path": str(self.best_path) if self.best_path else None,
                "monitor": self.monitor,
            }))
            os.replace(tmp, self._index_file())
        barrier(self.mesh)

    def reset_best(self) -> None:
        """Forget an earlier run's best (a fresh fit into a reused directory)."""
        self.best_score = None
        self.best_path = None
        self._save_index()

    def _is_better(self, score: float) -> bool:
        if self.best_score is None:
            return True
        return score < self.best_score if self.mode == "min" else score > self.best_score

    def _write(self, state: TrainState, path: Path) -> None:
        """Global rank 0 writes ``state`` whole (gathered over its model
        group); every rank waits for it."""
        if self.mesh.rank == 0:
            whole = gather_train_state(state)
            if self.mesh.model_rank == 0:
                tmp = path.with_name(path.name + ".tmp")
                torch.save(whole, tmp)
                os.replace(tmp, path)
        barrier(self.mesh)

    def save(self, state: TrainState, epoch: int, metrics: dict[str, float]) -> tuple[bool, Path | None]:
        """Save if the monitored metric improved; returns ``(improved, path)``."""
        score = float(metrics[self.monitor])
        if not self._is_better(score):
            return False, None
        prev = self.best_path
        path = self.directory / f"model-epoch={epoch:02d}-{self.monitor}={score:.3f}.pt"
        self._write(state, path)
        self.best_score = score
        self.best_path = path
        if prev is not None and prev != path and self.mesh.global_rank == 0:
            prev.unlink(missing_ok=True)
        self._save_index()
        logger.info("saved checkpoint %s", path)
        return True, path

    def save_last(self, state: TrainState) -> Path:
        """Unconditional ``last.pt`` for resume."""
        path = self.directory / "last.pt"
        self._write(state, path)
        return path

    @staticmethod
    def load_model(path: str | Path, model: torch.nn.Module) -> torch.nn.Module:
        """Load only a checkpoint's model weights into ``model``, cut to its
        tensor-parallel layout (evaluation needs no optimizer; the file is
        memory-mapped, so the optimizer's part of it is never read)."""
        saved = torch.load(Path(path), map_location="cpu", weights_only=True, mmap=True)
        model.load_state_dict(local_state_dict(saved["model"], model))
        return model

    @staticmethod
    def restore(path: str | Path, state: TrainState) -> TrainState:
        """Load a whole checkpoint into ``state`` (on the state's device),
        cut to its tensor-parallel layout."""
        device = next(state.model.parameters()).device
        saved = torch.load(Path(path), map_location=device, weights_only=True)
        state.load_state_dict(local_train_state(saved, state))
        return state


def load_weights_from_checkpoint(
    checkpoint_path: str | Path,
    model: torch.nn.Module,
    load_parts: list[str] | str | None = None,
) -> list[str]:
    """Warm-start ``model`` from the ``"model"`` entry of a port checkpoint
    (JAX package ``checkpoint.py:131-177``, reference ``utils/models.py:10-66``).

    Without ``load_parts`` every tensor of the model's ``state_dict`` is
    loaded and the file must hold each of them. With ``load_parts`` a tensor
    (parameter or buffer, as the JAX package treats ``batch_stats``) is taken
    when its dotted name starts with an entry or contains it; the others, and
    selected ones the file lacks, keep their values. Extra tensors in the
    file are ignored; a shape mismatch raises. Returns the loaded names.
    """
    if isinstance(load_parts, str):
        load_parts = [load_parts]
    path = Path(checkpoint_path).absolute()
    if not path.exists():
        msg = f"checkpoint not found: {path}"
        raise FileNotFoundError(msg)
    saved = torch.load(path, map_location="cpu", weights_only=True, mmap=True)["model"]
    loaded = []
    with torch.no_grad():
        for name, tensor in model.state_dict().items():
            if load_parts and not any(name.startswith(p) or p in name for p in load_parts):
                continue
            if name not in saved:
                if load_parts:
                    continue
                msg = f"{name} is missing from checkpoint {path}"
                raise KeyError(msg)
            if saved[name].shape != tensor.shape:
                msg = (f"shape mismatch at {name}: model {tuple(tensor.shape)} vs "
                       f"checkpoint {tuple(saved[name].shape)}")
                raise ValueError(msg)
            tensor.copy_(saved[name])
            loaded.append(name)
    logger.info("warm-started %d tensors (parts %s) from %s", len(loaded), load_parts or "all", path)
    return loaded
