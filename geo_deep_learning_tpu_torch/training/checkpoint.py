"""Checkpointing: best-by-monitor retention, ``last``, resume.

Port of ``CheckpointManager`` in ``geo_deep_learning_tpu/training/checkpoint.py``
(reference Lightning ``ModelCheckpoint`` with ``save_top_k=1``). A
checkpoint is one ``torch.save`` file of :meth:`TrainState.state_dict`
(model, optimizer, step, generators, plateau state), written to a
temporary name and renamed, so a file on disk is always whole. The best
score and path persist in ``index.json``, so a resumed run knows its best.
Orbax compatibility with the JAX package's checkpoints is not kept.
"""

from __future__ import annotations

import json
import logging
import os
from pathlib import Path

import torch

from geo_deep_learning_tpu_torch.core.train_state import TrainState

logger = logging.getLogger(__name__)


class CheckpointManager:
    """Save / restore train states; keep the best one by a monitor."""

    def __init__(self, directory: str | Path, monitor: str = "val_loss", mode: str = "min") -> None:
        self.directory = Path(directory).absolute()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.monitor = monitor
        self.mode = mode
        self.best_score: float | None = None
        self.best_path: Path | None = None
        self._load_index()

    def _index_file(self) -> Path:
        return self.directory / "index.json"

    def _load_index(self) -> None:
        if self._index_file().exists():
            idx = json.loads(self._index_file().read_text())
            self.best_score = idx.get("best_score")
            best = idx.get("best_path")
            self.best_path = Path(best) if best else None

    def _save_index(self) -> None:
        self._index_file().write_text(json.dumps({
            "best_score": self.best_score,
            "best_path": str(self.best_path) if self.best_path else None,
            "monitor": self.monitor,
        }))

    def reset_best(self) -> None:
        """Forget an earlier run's best (a fresh fit into a reused directory)."""
        self.best_score = None
        self.best_path = None
        self._save_index()

    def _is_better(self, score: float) -> bool:
        if self.best_score is None:
            return True
        return score < self.best_score if self.mode == "min" else score > self.best_score

    @staticmethod
    def _write(state: TrainState, path: Path) -> None:
        tmp = path.with_name(path.name + ".tmp")
        torch.save(state.state_dict(), tmp)
        os.replace(tmp, path)

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
        if prev is not None and prev != path:
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
        """Load only a checkpoint's model weights into ``model`` (evaluation
        needs no optimizer; the file is memory-mapped, so the optimizer's
        part of it is never read)."""
        saved = torch.load(Path(path), map_location="cpu", weights_only=True, mmap=True)
        model.load_state_dict(saved["model"])
        return model

    @staticmethod
    def restore(path: str | Path, state: TrainState) -> TrainState:
        """Load a checkpoint into ``state`` (on the state's device)."""
        device = next(state.model.parameters()).device
        saved = torch.load(Path(path), map_location=device, weights_only=True)
        state.load_state_dict(saved)
        return state
