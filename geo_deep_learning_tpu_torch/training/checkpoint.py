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
