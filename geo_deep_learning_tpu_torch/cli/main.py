"""CLI entry point: ``test`` / ``predict`` on the port.

Port of the evaluation half of ``geo_deep_learning_tpu/cli/main.py``
(``run_eval_from_ckpt``)::

    python -m geo_deep_learning_tpu_torch.cli.main test --config <port config.yaml>

:func:`main` parses the YAML and calls :func:`run`, which takes the parsed
config dict and needs no YAML. The model runs on ``device`` (CUDA unless
the caller asks for the CPU) with seeded random weights: checkpoint
restore (``ckpt_path``) comes with the training slice. ``test`` returns
dataset-level metrics; ``predict`` writes one uint8 class raster per
patch under ``<trainer.default_root_dir>/predictions/``.
"""

from __future__ import annotations

import argparse
import logging
import sys
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

from geo_deep_learning_tpu_torch.cli.config import instantiate, load_config
from geo_deep_learning_tpu_torch.core.device import resolve_device
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
from geo_deep_learning_tpu_torch.ops import metrics as M
from geo_deep_learning_tpu_torch.training.steps import make_eval_step, make_predict_step
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

logger = logging.getLogger(__name__)

SUBCOMMANDS = ("test", "predict")

_PRECISION_MAP = {
    "16-mixed": "bf16-mixed",
    "bf16-mixed": "bf16-mixed",
    "32-true": "32-true",
    "32": "32-true",
    32: "32-true",
    16: "bf16-mixed",
}

# batch keys that go to the device; names and counts stay on the host
_DEVICE_KEYS = ("image", "mask", "mean", "std", "wavelengths")


def to_device(batch: dict, device: torch.device) -> dict:
    out = dict(batch)
    for key in _DEVICE_KEYS:
        if key in batch:
            out[key] = torch.from_numpy(np.ascontiguousarray(batch[key])).to(device)
    return out


def run_test(
    task: SegmentationTask, precision: PrecisionPolicy, loader: Iterable, device
) -> dict[str, float]:
    """Dataset-level loss, IoU, accuracy and F1 over ``loader``
    (the JAX trainer's ``_run_eval`` with prefix ``test``)."""
    eval_step = make_eval_step(task, precision)
    losses, counts = [], []
    cm = torch.zeros((task.eval_classes, task.eval_classes), device=device)
    for batch in loader:
        out = eval_step(to_device(batch, device))
        losses.append(out["loss"])
        counts.append(int(batch.get("valid_count", batch["mask"].shape[0])))
        cm += out["confusion"]
    if not losses:
        return {}
    loss = torch.stack(losses).cpu().numpy()
    cm = cm.cpu()
    iou, f1 = M.iou_from_confusion(cm), M.f1_from_confusion(cm)
    result = {
        "test_loss": float(np.average(loss, weights=counts)),
        "test_miou": float(torch.nanmean(iou)),
        "test_accuracy": float(M.accuracy_from_confusion(cm)),
        "test_mf1": float(torch.nanmean(f1)),
    }
    if task.class_labels:
        result.update(M.classwise(iou, task.class_labels, "test_iou"))
        result.update(M.classwise(f1, task.class_labels, "test_f1"))
    return result


def run_predict(
    task: SegmentationTask, precision: PrecisionPolicy, loader: Iterable, device,
    out_dir: Path,
) -> dict[str, Any]:
    """Write ``<stem>_pred.tif`` (uint8 class map) per real sample."""
    predict_step = make_predict_step(task, precision)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_batches = n_written = 0
    for batch in loader:
        n_batches += 1
        preds = predict_step(to_device(batch, device))["preds"].cpu().numpy()
        names = batch.get("image_name", [f"batch{n_batches}_{i}" for i in range(len(preds))])
        for i in range(int(batch.get("valid_count", len(preds)))):
            stem = Path(str(names[i])).stem or f"batch{n_batches}_{i}"
            write_geotiff(out_dir / f"{stem}_pred.tif", preds[i].astype(np.uint8))
            n_written += 1
    logger.info("wrote %d prediction rasters to %s", n_written, out_dir)
    return {"num_batches": n_batches, "num_predictions": n_written, "output_dir": str(out_dir)}


def run(config: dict, subcommand: str, device: str | torch.device = "cuda") -> dict[str, Any]:
    """Run ``test`` or ``predict`` from a parsed config on ``device``."""
    if subcommand not in SUBCOMMANDS:
        msg = f"subcommand {subcommand!r} is not ported yet; the port runs {SUBCOMMANDS}"
        raise ValueError(msg)
    device = resolve_device(device)
    if config.get("ckpt_path"):
        msg = "checkpoint restore is not ported yet; set ckpt_path: null"
        raise NotImplementedError(msg)
    seed = config.get("seed_everything", 42)
    seed = 42 if seed is True else int(seed)
    trainer_node = config.get("trainer", {}) or {}
    precision = PrecisionPolicy.create(
        _PRECISION_MAP.get(trainer_node.get("precision", "bf16-mixed"), "bf16-mixed")
    )
    spec = instantiate(config["model"])
    datamodule = instantiate(config["data"])
    spec.materialize(device, seed)
    loader = datamodule.test_dataloader()
    if subcommand == "test":
        result = run_test(spec.task, precision, loader, device)
    else:
        out_dir = Path(trainer_node.get("default_root_dir", ".")) / "predictions"
        result = run_predict(spec.task, precision, loader, device, out_dir)
    logger.info("%s result: %s", subcommand, result)
    return result


def main(argv: list[str] | None = None) -> dict[str, Any]:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s: %(message)s")
    parser = argparse.ArgumentParser(prog="gdl-torch")
    parser.add_argument("subcommand", choices=SUBCOMMANDS)
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    args = parser.parse_args(argv)
    return run(load_config(args.config, args.overrides), args.subcommand, args.device)


if __name__ == "__main__":
    main(sys.argv[1:])
