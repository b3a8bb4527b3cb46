"""YAML config system: ``class_path``/``init_args`` + ``${...}`` interpolation.

The port's own copy of ``geo_deep_learning_tpu/cli/config.py``. Reference
and JAX-package class paths are aliased to the port's classes, so the same
config vocabulary drives both packages. ``yaml`` is imported only inside
:func:`load_config`; building from an already-parsed dict needs no YAML.
"""

from __future__ import annotations

import importlib
import re
from pathlib import Path
from typing import Any

_TASK = "geo_deep_learning_tpu_torch.tasks.SegmentationDOFA"
_SEGFORMER = "geo_deep_learning_tpu_torch.tasks.SegmentationSegformer"
_UNETPLUS = "geo_deep_learning_tpu_torch.tasks.SegmentationUnetPlus"
_LOSSES = "geo_deep_learning_tpu_torch.ops.losses"
_CSV = "geo_deep_learning_tpu_torch.data.datamodule.CSVDataModule"
_MULTI = "geo_deep_learning_tpu_torch.data.multisensor.MultiSensorDataModule"
_MULTI_CSV = "geo_deep_learning_tpu_torch.data.multisensor_csv.MultiSensorCSVDataModule"

CLASS_PATH_ALIASES: dict[str, str] = {
    "tasks_with_models.segmentation_dofa.SegmentationDOFA": _TASK,
    "geo_deep_learning_tpu.tasks.SegmentationDOFA": _TASK,
    "geo_deep_learning_tpu.tasks.segmentation.SegmentationDOFA": _TASK,
    "tasks_with_models.segmentation_segformer.SegmentationSegformer": _SEGFORMER,
    "geo_deep_learning_tpu.tasks.SegmentationSegformer": _SEGFORMER,
    "geo_deep_learning_tpu.tasks.segmentation.SegmentationSegformer": _SEGFORMER,
    "tasks_with_models.segmentation_unetplus.SegmentationUnetPlus": _UNETPLUS,
    "geo_deep_learning_tpu.tasks.SegmentationUnetPlus": _UNETPLUS,
    "geo_deep_learning_tpu.tasks.segmentation.SegmentationUnetPlus": _UNETPLUS,
    # losses: smp's and torch's class paths (JAX package cli/config.py:35-47),
    # and the JAX package's own
    "segmentation_models_pytorch.losses.DiceLoss": f"{_LOSSES}.DiceLoss",
    "segmentation_models_pytorch.losses.JaccardLoss": f"{_LOSSES}.JaccardLoss",
    "segmentation_models_pytorch.losses.SoftCrossEntropyLoss": f"{_LOSSES}.SoftCrossEntropyLoss",
    "segmentation_models_pytorch.losses.FocalLoss": f"{_LOSSES}.FocalLoss",
    "torch.nn.CrossEntropyLoss": f"{_LOSSES}.CrossEntropyLoss",
    "torch.nn.BCEWithLogitsLoss": f"{_LOSSES}.BinaryCrossEntropyLoss",
    **{f"geo_deep_learning_tpu.ops.losses.{name}": f"{_LOSSES}.{name}" for name in (
        "DiceLoss", "JaccardLoss", "SoftCrossEntropyLoss", "CrossEntropyLoss",
        "BinaryCrossEntropyLoss", "FocalLoss")},
    "datamodules.csv_datamodule.CSVDataModule": _CSV,
    "geo_deep_learning_tpu.data.datamodule.CSVDataModule": _CSV,
    # the reference's stale class path (JAX cli/config.py:48-56)
    "datamodules.imagery_NonGeoDataModule.BlueSkyNonGeoDataModule": _CSV,
    "datamodules.wds_datamodule.MultiSensorDataModule": _MULTI,
    "geo_deep_learning_tpu.data.multisensor.MultiSensorDataModule": _MULTI,
    "geo_deep_learning_tpu.data.multisensor_csv.MultiSensorCSVDataModule": _MULTI_CSV,
}

# init_args consumed by the trainer (optimizer / scheduler factories),
# passed through as plain data
RAW_KEYS = frozenset({"optimizer", "scheduler", "scheduler_config"})

_INTERP = re.compile(r"\$\{([a-zA-Z0-9_.]+)\}")


def _lookup(root: Any, dotted: str) -> Any:
    node = root
    for part in dotted.split("."):
        node = node[int(part)] if isinstance(node, list) else node[part]
    return node


def resolve_interpolations(config: Any) -> Any:
    """Resolve ``${a.b.c}`` references against the document root."""

    def resolve(node: Any) -> Any:
        if isinstance(node, dict):
            return {k: resolve(v) for k, v in node.items()}
        if isinstance(node, list):
            return [resolve(v) for v in node]
        if isinstance(node, str):
            full = _INTERP.fullmatch(node)
            if full:  # a whole-value reference keeps the referent's type
                return resolve(_lookup(config, full.group(1)))
            return _INTERP.sub(lambda m: str(resolve(_lookup(config, m.group(1)))), node)
        return node

    return resolve(config)


def import_class(class_path: str) -> type:
    class_path = CLASS_PATH_ALIASES.get(class_path, class_path)
    if not class_path.startswith("geo_deep_learning_tpu_torch."):
        msg = f"class_path {class_path!r} has no counterpart in the port"
        raise ValueError(msg)
    module_name, _, attr = class_path.rpartition(".")
    return getattr(importlib.import_module(module_name), attr)


def instantiate(node: Any) -> Any:
    """Recursively build objects from ``class_path``/``init_args`` nodes."""
    if isinstance(node, dict):
        if "class_path" in node:
            cls = import_class(node["class_path"])
            raw = node.get("init_args", {}) or {}
            return cls(**{k: (v if k in RAW_KEYS else instantiate(v)) for k, v in raw.items()})
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def load_config(path: str | Path, overrides: list[str] | None = None) -> dict:
    """Load YAML, apply ``a.b.c=value`` overrides, resolve ``${...}``."""
    import yaml

    with Path(path).open() as f:
        config = yaml.safe_load(f)
    for ov in overrides or []:
        key, _, raw = ov.partition("=")
        node = config
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(raw)
    return resolve_interpolations(config)
