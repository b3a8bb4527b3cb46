"""Experiment tracking to files.

Port of ``FileTracker`` in ``geo_deep_learning_tpu/tools/tracking.py``: metrics
append to ``metrics.jsonl`` (one JSON object per call), params go to
``params.json`` and text artifacts under ``artifacts/``, in a run directory
``<directory>/<run_name>-<unix time>``. MLflow and figures are not ported.
:func:`create_tracker` gives rank 0 of a data-parallel run the file
tracker and every other rank a :class:`NullTracker` (JAX
``tracking.py:144-145``), so a run logs, and archives its config, once.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any

from geo_deep_learning_tpu_torch.core.mesh import is_host0


class FileTracker:
    def __init__(self, directory: str | Path, run_name: str = "run") -> None:
        self.directory = Path(directory) / f"{run_name}-{int(time.time())}"
        self.directory.mkdir(parents=True, exist_ok=True)
        self._metrics_file = (self.directory / "metrics.jsonl").open("a")

    def log_params(self, params: dict[str, Any]) -> None:
        (self.directory / "params.json").write_text(json.dumps(params, indent=2, default=str))

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        rec = {"step": step, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        self._metrics_file.write(json.dumps(rec) + "\n")
        self._metrics_file.flush()

    def log_text(self, text: str, name: str) -> None:
        dest = self.directory / "artifacts" / name
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(text)

    def finish(self) -> None:
        self._metrics_file.close()


class NullTracker:
    """The tracker of a rank other than 0: accepts every call, writes nothing."""

    def log_params(self, params: dict[str, Any]) -> None:
        del params

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        del metrics, step

    def log_text(self, text: str, name: str) -> None:
        del text, name

    def finish(self) -> None:
        pass


def create_tracker(directory: str | Path, run_name: str = "run") -> FileTracker | NullTracker:
    """A :class:`FileTracker` on rank 0 (or without a group), else a
    :class:`NullTracker`."""
    return FileTracker(directory, run_name) if is_host0() else NullTracker()
