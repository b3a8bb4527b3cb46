"""Experiment tracking.

Port of ``geo_deep_learning_tpu/tools/tracking.py`` (reference MLflow
logging: scalars, the merged run config as an artifact,
``tools/mlflow_logger.py:8-24``, and prediction figures). A tracker is the
:class:`Tracker` interface with two backends:

- :class:`MLflowTracker`, when ``mlflow`` imports (it is imported when the
  tracker is made, never with this module);
- :class:`FileTracker`, dependency-free: metrics append to
  ``metrics.jsonl`` (one JSON object a call), params go to ``params.json``,
  figures under ``figures/`` and artifacts under ``artifacts/``, in a run
  directory ``<directory>/<run_name>-<unix time>``.

:func:`create_tracker` picks the backend (``auto`` / ``mlflow`` / ``file`` /
``none``) and gives every rank but 0 of a data-parallel run a
:class:`NullTracker`, so a run logs, and archives its config, once
(reference ``rank_zero_only``).
"""

from __future__ import annotations

import json
import logging
import shutil
import time
from pathlib import Path
from typing import Any

from geo_deep_learning_tpu_torch.core.mesh import is_host0

logger = logging.getLogger(__name__)


class Tracker:
    """No-op base: accepts every call, writes nothing."""

    def log_params(self, params: dict[str, Any]) -> None:
        pass

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        pass

    def log_figure(self, figure, name: str) -> None:
        pass

    def log_artifact(self, path: str | Path, artifact_dir: str = "") -> None:
        pass

    def log_text(self, text: str, name: str) -> None:
        pass

    def finish(self) -> None:
        pass


class NullTracker(Tracker):
    """The tracker of a rank other than 0, and of ``backend="none"``."""


class FileTracker(Tracker):
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

    def log_figure(self, figure, name: str) -> None:
        """Save a matplotlib figure as ``figures/<name>``."""
        figdir = self.directory / "figures"
        figdir.mkdir(exist_ok=True)
        figure.savefig(figdir / name, bbox_inches="tight", dpi=100)

    def log_artifact(self, path: str | Path, artifact_dir: str = "") -> None:
        """Copy the file ``path`` into ``artifacts/<artifact_dir>/``."""
        dest = self.directory / "artifacts" / artifact_dir
        dest.mkdir(parents=True, exist_ok=True)
        shutil.copy2(path, dest)

    def log_text(self, text: str, name: str) -> None:
        dest = self.directory / "artifacts" / name
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.write_text(text)

    def finish(self) -> None:
        self._metrics_file.close()


class MLflowTracker(Tracker):
    """Thin MLflow client wrapper (reference ``MLFlowLogger`` semantics):
    nested params flattened to dotted keys, values cut to 500 characters."""

    def __init__(
        self,
        experiment_name: str = "geo-deep-learning-tpu",
        run_name: str | None = None,
        tracking_uri: str | None = None,
    ) -> None:
        import mlflow

        self._mlflow = mlflow
        if tracking_uri:
            mlflow.set_tracking_uri(tracking_uri)
        mlflow.set_experiment(experiment_name)
        self._run = mlflow.start_run(run_name=run_name)

    def log_params(self, params: dict[str, Any]) -> None:
        self._mlflow.log_params({k: str(v)[:500] for k, v in _flatten(params).items()})

    def log_metrics(self, metrics: dict[str, float], step: int) -> None:
        self._mlflow.log_metrics({k: float(v) for k, v in metrics.items()}, step=step)

    def log_figure(self, figure, name: str) -> None:
        self._mlflow.log_figure(figure, f"figures/{name}")

    def log_artifact(self, path: str | Path, artifact_dir: str = "") -> None:
        self._mlflow.log_artifact(str(path), artifact_path=artifact_dir or None)

    def log_text(self, text: str, name: str) -> None:
        self._mlflow.log_text(text, name)

    def finish(self) -> None:
        self._mlflow.end_run()


def _flatten(d: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def create_tracker(
    backend: str = "auto",
    directory: str | Path = "runs",
    run_name: str = "run",
    **kwargs: Any,
) -> Tracker:
    """The tracker of this process. ``auto`` is MLflow where it can be made
    (``kwargs`` are :class:`MLflowTracker`'s) and a :class:`FileTracker` at
    ``directory`` otherwise; ``mlflow`` raises where MLflow cannot be made;
    ``file`` is the file tracker and ``none`` the no-op one. Every rank but
    0 gets a :class:`NullTracker`."""
    if not is_host0():
        return NullTracker()
    if backend in ("auto", "mlflow"):
        try:
            return MLflowTracker(run_name=run_name, **kwargs)
        except Exception as e:  # mlflow missing or its server unreachable
            if backend == "mlflow":
                raise
            logger.debug("mlflow unavailable (%s); using FileTracker", e)
    if backend == "none":
        return NullTracker()
    return FileTracker(directory, run_name)
