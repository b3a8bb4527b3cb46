"""CLI entry point: ``fit`` / ``validate`` / ``test`` / ``predict`` on the port.

Port of ``geo_deep_learning_tpu/cli/main.py``::

    python -m geo_deep_learning_tpu_torch.cli.main fit --config <port config.yaml> \
        [--device cpu] [--ckpt-path <file>] [section.key=value ...]

:func:`main` parses the YAML and calls :func:`run`, which takes the parsed
config dict and needs no YAML. The trainer section understands the
reference's Lightning vocabulary (``max_epochs``, ``precision``,
``gradient_clip_val``, EarlyStopping / ModelCheckpoint callbacks) through
:func:`build_trainer_config`. Everything runs on ``device`` (CUDA unless
the caller asks for the CPU) from seeded random weights, or from
``ckpt_path``: ``fit`` resumes from it, the others evaluate it. ``test``
and ``validate`` return dataset-level metrics; ``predict`` writes one uint8
class raster per patch under ``<trainer.default_root_dir>/predictions/``.
Checkpoints and the file tracker's run directory go under
``<trainer.default_root_dir>/checkpoints/``.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Any

import numpy as np
import torch

from geo_deep_learning_tpu_torch.cli.config import instantiate, load_config
from geo_deep_learning_tpu_torch.core.device import resolve_device
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
from geo_deep_learning_tpu_torch.tools.tracking import FileTracker
from geo_deep_learning_tpu_torch.training.checkpoint import CheckpointManager
from geo_deep_learning_tpu_torch.training.loop import Trainer, TrainerConfig

logger = logging.getLogger(__name__)

SUBCOMMANDS = ("fit", "validate", "test", "predict")

_PRECISION_MAP = {
    "16-mixed": "bf16-mixed",
    "bf16-mixed": "bf16-mixed",
    "32-true": "32-true",
    "32": "32-true",
    32: "32-true",
    16: "bf16-mixed",
}


def build_trainer_config(trainer_node: dict, seed: int) -> TrainerConfig:
    """The ``trainer`` section -> :class:`TrainerConfig` (JAX package
    ``cli/main.py:41-80``, without the mesh)."""
    cfg = TrainerConfig(seed=seed)
    cfg.max_epochs = int(trainer_node.get("max_epochs", cfg.max_epochs))
    cfg.precision = _PRECISION_MAP.get(trainer_node.get("precision", "bf16-mixed"), "bf16-mixed")
    if "gradient_clip_val" in trainer_node:
        cfg.grad_clip = trainer_node["gradient_clip_val"]
    cfg.checkpoint_dir = str(Path(trainer_node.get("default_root_dir", ".")) / "checkpoints")
    for cb in trainer_node.get("callbacks", []) or []:
        path = cb.get("class_path", "") if isinstance(cb, dict) else ""
        args = (cb.get("init_args", {}) or {}) if isinstance(cb, dict) else {}
        if path.endswith("EarlyStopping"):
            cfg.early_stopping_patience = int(args.get("patience", 20))
            cfg.monitor = args.get("monitor", cfg.monitor)
            cfg.monitor_mode = args.get("mode", cfg.monitor_mode)
        elif path.endswith("ModelCheckpoint"):
            cfg.monitor = args.get("monitor", cfg.monitor)
            cfg.monitor_mode = args.get("mode", cfg.monitor_mode)
    return cfg


def run_eval_from_ckpt(trainer: Trainer, spec, datamodule, ckpt_path, mode: str,
                       out_dir: Path) -> dict[str, Any]:
    """Seeded model, its weights from ``ckpt_path`` when given, then evaluate."""
    datamodule.setup("validate" if mode == "validate" else "test")
    loader = datamodule.val_dataloader() if mode == "validate" else datamodule.test_dataloader()
    model = spec.task.materialize(trainer.device, trainer.config.seed)
    if ckpt_path:
        CheckpointManager.load_model(ckpt_path, model)
        logger.info("loaded the model of %s", ckpt_path)
    if mode != "predict":
        return trainer.evaluate(spec.task, loader, "val" if mode == "validate" else "test")
    out_dir.mkdir(parents=True, exist_ok=True)
    n_batches = n_written = 0
    for out in trainer.predict(spec.task, loader):
        n_batches += 1
        preds, batch = out["preds"], out["batch"]
        names = batch.get("image_name", [f"batch{n_batches}_{i}" for i in range(len(preds))])
        for i in range(int(batch.get("valid_count", len(preds)))):
            stem = Path(str(names[i])).stem or f"batch{n_batches}_{i}"
            write_geotiff(out_dir / f"{stem}_pred.tif", preds[i].astype(np.uint8))
            n_written += 1
    logger.info("wrote %d prediction rasters to %s", n_written, out_dir)
    return {"num_batches": n_batches, "num_predictions": n_written, "output_dir": str(out_dir)}


def run(
    config: dict,
    subcommand: str,
    device: str | torch.device = "cuda",
    ckpt_path: str | None = None,
) -> dict[str, Any]:
    """Run a subcommand from a parsed config on ``device``."""
    if subcommand not in SUBCOMMANDS:
        msg = f"subcommand {subcommand!r} is not ported yet; the port runs {SUBCOMMANDS}"
        raise ValueError(msg)
    device = resolve_device(device)
    seed = config.get("seed_everything", 42)
    seed = 42 if seed is True else int(seed)
    trainer_node = config.get("trainer", {}) or {}
    spec = instantiate(config["model"])
    datamodule = instantiate(config["data"])
    trainer_cfg = build_trainer_config(trainer_node, seed)
    tracker = FileTracker(trainer_cfg.checkpoint_dir)
    tracker.log_params(config)
    trainer = Trainer(trainer_cfg, tracker, device)
    ckpt_path = ckpt_path or config.get("ckpt_path")
    try:
        if subcommand == "fit":
            result = trainer.fit(spec.task, datamodule, ckpt_path=ckpt_path, **spec.fit_kwargs())
        else:
            out_dir = Path(trainer_node.get("default_root_dir", ".")) / "predictions"
            result = run_eval_from_ckpt(trainer, spec, datamodule, ckpt_path, subcommand, out_dir)
    finally:
        tracker.finish()
    logger.info("%s result: %s", subcommand, result)
    return result


def main(argv: list[str] | None = None) -> dict[str, Any]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(prog="gdl-torch")
    parser.add_argument("subcommand", choices=SUBCOMMANDS)
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ckpt-path", default=None)
    parser.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    args = parser.parse_args(argv)
    return run(load_config(args.config, args.overrides), args.subcommand, args.device,
               args.ckpt_path)


if __name__ == "__main__":
    main(sys.argv[1:])
