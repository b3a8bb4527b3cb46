"""Experiment tracking to files.

Port of ``FileTracker`` in ``geo_deep_learning_tpu/tools/tracking.py``: metrics
append to ``metrics.jsonl`` (one JSON object per call), params go to
``params.json`` and text artifacts under ``artifacts/``, in a run directory
``<directory>/<run_name>-<unix time>``. MLflow and figures are not ported.
"""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


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
