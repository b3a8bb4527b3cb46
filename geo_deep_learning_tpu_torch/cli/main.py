"""CLI entry point: ``fit`` / ``validate`` / ``test`` / ``predict`` /
``predict-scene`` on the port.

Port of ``geo_deep_learning_tpu/cli/main.py``::

    python -m geo_deep_learning_tpu_torch.cli.main fit --config <port config.yaml> \
        [--device cpu] [--ckpt-path <file>] [section.key=value ...]
    python -m geo_deep_learning_tpu_torch.cli.main predict-scene --config <config.yaml> \
        --scene <scene.tif> [--output <map.tif>] [--tile-size 512] [--tile-overlap 128] \
        [--tile-batch 8] [--blend hann|uniform|crop] [--streamed] [--ckpt-path <file>]

:func:`main` parses the YAML (or JSON) config and calls :func:`run`, which
takes the parsed config dict and needs no YAML. The trainer section understands the
reference's Lightning vocabulary (``max_epochs``, ``precision``,
``gradient_clip_val``, EarlyStopping / ModelCheckpoint callbacks) through
:func:`build_trainer_config`. Everything runs on ``device`` (CUDA unless
the caller asks for the CPU) from seeded random weights, then the task's
initial weights (``torch_weights``, then ``weights_from_checkpoint_path``
with ``load_parts``), then ``ckpt_path``: ``fit`` resumes from it, the
others evaluate it. ``test`` and ``validate`` return dataset-level
metrics; ``predict`` writes one uint8
class raster per patch under ``<trainer.default_root_dir>/predictions/``;
``predict-scene`` writes the uint8 class map of a whole georeferenced scene
(sliding-window tiles, blended logits) with the scene's transform and EPSG
code, band-streamed when asked or when the scene decodes to more than
512 MB.
Checkpoints go under ``<trainer.default_root_dir>/checkpoints/``. The
tracker comes from ``trainer.logger`` as the JAX CLI builds it
(:func:`build_tracker`): without the node, a file tracker whose run
directory is ``<default_root_dir>/checkpoints/run-<unix time>``; with it,
MLflow where it imports, else a file tracker at
``<save_dir>/<run_name>-<unix time>``. The run directory archives the
merged config as ``artifacts/config/run_config.yaml``, and ``fit`` adds a
figure of each of the first ``max_samples`` val samples
(``VisualizationCallback``, 3 by default) on every new best.

Data parallelism (JAX ``cli/main.py:52-66``): ``trainer.mesh: {data, model}``.
One visible device and no group is the single-process path. ``data: N > 1``
(or ``-1`` with several CUDA devices) spawns N processes, one a rank, in an
NCCL group on CUDA or a gloo group on the CPU (:func:`core.mesh.launch`),
and returns rank 0's result; a process started by ``torchrun`` joins its
group instead. ``data.batch_size`` is the global batch. Rank 0 alone
writes checkpoints, logs, the archived config and prediction rasters.
``predict-scene`` serves a scene on one process (rank 0 of a group), as
the JAX CLI does. ``model: M > 1`` turns on tensor parallelism: the run
takes ``data x model`` ranks (``data: -1``: every visible CUDA device over
``M``), and the DOFA and MiT blocks are sharded over the model axis
(``parallel.placement``); a checkpoint is whole, so any layout restores it.
"""

from __future__ import annotations

import argparse
import json
import logging
import math
import sys
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from geo_deep_learning_tpu_torch.cli.config import instantiate, load_config
from geo_deep_learning_tpu_torch.config.logging_config import setup_logging
from geo_deep_learning_tpu_torch.core.device import resolve_device
from geo_deep_learning_tpu_torch.core.mesh import (
    MeshConfig,
    initialize_distributed,
    is_host0,
    launch,
    world_size,
)
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
from geo_deep_learning_tpu_torch.data.geotiff_stream import GeoTiffWindowReader
from geo_deep_learning_tpu_torch.inference.sliding_window import SlidingWindowConfig, predict_scene
from geo_deep_learning_tpu_torch.inference.streaming import predict_scene_streamed
from geo_deep_learning_tpu_torch.tools.tracking import Tracker, create_tracker
from geo_deep_learning_tpu_torch.training.checkpoint import CheckpointManager
from geo_deep_learning_tpu_torch.training.loop import Trainer, TrainerConfig

logger = logging.getLogger(__name__)

SUBCOMMANDS = ("fit", "validate", "test", "predict", "predict-scene")
# wavelengths (um) of a DOFA model whose task sets none: RGB (JAX cli/main.py:220-226)
DEFAULT_WAVELENGTHS = (0.665, 0.549, 0.481)
# scenes that decode to more than this are band-streamed (JAX cli/main.py:262-270)
STREAM_ABOVE_BYTES = 512 * 1024 * 1024

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
    ``cli/main.py:41-80``)."""
    cfg = TrainerConfig(seed=seed)
    mesh_node = trainer_node.get("mesh")
    if mesh_node:
        cfg.mesh = MeshConfig(data=int(mesh_node.get("data", -1)),
                              model=int(mesh_node.get("model", 1)))
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
        elif path.endswith("VisualizationCallback"):
            cfg.visualize_max_samples = int(args.get("max_samples", 3))
    return cfg


def build_tracker(trainer_node: dict, run_dir: str) -> Tracker:
    """The run's tracker from the ``trainer.logger`` node (JAX
    ``cli/main.py:83-96``): its ``init_args`` alone are read, and its
    ``class_path`` is never imported. No node: a file tracker at
    ``run_dir``. Rank 0 only; the other ranks get a no-op tracker."""
    logger_node = trainer_node.get("logger")
    if not logger_node:
        return create_tracker("file", directory=run_dir)
    args = (logger_node.get("init_args", {}) or {}) if isinstance(logger_node, dict) else {}
    return create_tracker(
        "auto",
        directory=args.get("save_dir", run_dir),
        run_name=args.get("run_name", "run"),
        experiment_name=args.get("experiment_name", "geo-deep-learning-tpu"),
    )


def eval_weight_kwargs(spec) -> dict[str, Any]:
    """The task's initial weights for evaluation (JAX ``cli/main.py:164-186``):
    a ``torch_weights`` file absent on this host is skipped with a warning.
    Unlike the JAX package, whose DOFA then falls back to sincos positions,
    a port checkpoint restored afterwards carries the encoder's
    ``pos_embed`` table itself."""
    kwargs = spec.weight_kwargs()
    tw = kwargs["torch_weights"]
    if tw and not Path(tw.get("path", "")).exists():
        logger.warning("torch_weights artifact %s not found on this host; evaluating without it",
                       tw.get("path"))
        kwargs["torch_weights"] = None
    return kwargs


def run_eval_from_ckpt(trainer: Trainer, spec, datamodule, ckpt_path, mode: str,
                       out_dir: Path) -> dict[str, Any]:
    """The model with its initial weights, its weights from ``ckpt_path``
    when given, then evaluate."""
    datamodule.setup("validate" if mode == "validate" else "test")
    loader = datamodule.val_dataloader() if mode == "validate" else datamodule.test_dataloader()
    model = trainer.init_model(spec.task, **eval_weight_kwargs(spec))
    if ckpt_path:
        CheckpointManager.load_model(ckpt_path, model)
        logger.info("loaded the model of %s", ckpt_path)
    if mode != "predict":
        return trainer.evaluate(spec.task, loader, "val" if mode == "validate" else "test")
    writes = is_host0()  # every rank predicts its rows; rank 0 writes them all
    if writes:
        out_dir.mkdir(parents=True, exist_ok=True)
    n_batches = n_written = 0
    for out in trainer.predict(spec.task, loader):
        n_batches += 1
        preds, batch = out["preds"], out["batch"]
        if not writes:
            continue
        names = batch.get("image_name", [f"batch{n_batches}_{i}" for i in range(len(preds))])
        for i in range(int(batch.get("valid_count", len(preds)))):
            stem = Path(str(names[i])).stem or f"batch{n_batches}_{i}"
            write_geotiff(out_dir / f"{stem}_pred.tif", preds[i].astype(np.uint8))
            n_written += 1
    logger.info("wrote %d prediction rasters to %s", n_written, out_dir)
    return {"num_batches": n_batches, "num_predictions": n_written, "output_dir": str(out_dir)}


@dataclass(frozen=True)
class SceneOptions:
    """``predict-scene``'s options (the JAX CLI's, ``main.py:108-125``)."""

    scene: str
    output: str | None = None
    tile_size: int = 512
    tile_overlap: int = 128
    tile_batch: int = 8
    blend: str = "hann"
    streamed: bool = False


def tile_forward(task, precision: PrecisionPolicy):
    """The model as ``sliding_window`` takes it: normalized NHWC f32 tiles
    -> f32 logits ``[B, t, t, K]``, in eval mode, cast and autocast as the
    eval step casts a float image; a DOFA task without wavelengths of its
    own gets :data:`DEFAULT_WAVELENGTHS`."""
    batch = {}
    if task.uses_wavelengths and task.default_wavelengths is None:
        batch["wavelengths"] = list(DEFAULT_WAVELENGTHS)

    @torch.inference_mode()
    def forward(tiles: torch.Tensor) -> torch.Tensor:
        task.model.eval()
        image = precision.cast_input(tiles).permute(0, 3, 1, 2)
        with precision.autocast(image.device):
            out = task.forward(batch, image)
        return out.out.float().permute(0, 2, 3, 1)

    return forward


def run_predict_scene(trainer: Trainer, spec, datamodule, ckpt_path,
                      opts: SceneOptions) -> dict[str, Any]:
    """The model with its initial weights, its weights from ``ckpt_path``
    when given, then the scene's class map, whole or band-streamed."""
    scene = Path(opts.scene)
    out = Path(opts.output) if opts.output else scene.with_name(scene.stem + "_pred.tif")
    model = trainer.init_model(spec.task, **eval_weight_kwargs(spec))
    if ckpt_path:
        CheckpointManager.load_model(ckpt_path, model)
        logger.info("loaded the model of %s", ckpt_path)
    with GeoTiffWindowReader(scene) as reader:
        decoded = reader.height * reader.width * reader.channels * reader.dtype.itemsize
    streamed = opts.streamed or decoded > STREAM_ABOVE_BYTES
    # a data module without statistics (the multi-sensor stream keeps them
    # per sensor) serves with /255 alone, as the JAX CLI's getattr does
    norm_stats = getattr(datamodule, "norm_stats", None)
    runner = predict_scene_streamed if streamed else predict_scene
    runner(
        tile_forward(spec.task, trainer.precision), str(scene), str(out),
        spec.task.num_classes,
        SlidingWindowConfig(opts.tile_size, opts.tile_overlap, opts.tile_batch, opts.blend),
        mean=norm_stats["mean"] if norm_stats else None,
        std=norm_stats["std"] if norm_stats else None,
        threshold=spec.task.threshold, device=trainer.device,
    )
    logger.info("wrote the class map of %s to %s (streamed=%s)", scene, out, streamed)
    return {"output": str(out), "streamed": streamed}


def _yaml_json(node, pad: str = "") -> str:
    """``node`` as indented JSON that a YAML 1.1 loader reads back equal:
    a float keeps a point before its exponent (PyYAML reads ``6e-05`` as a
    string) and a non-finite one takes YAML's spelling."""
    inner = pad + "  "
    if isinstance(node, dict) and node:
        items = (f"{inner}{json.dumps(str(k))}: {_yaml_json(v, inner)}" for k, v in node.items())
        return "{\n" + ",\n".join(items) + f"\n{pad}}}"
    if isinstance(node, (list, tuple)) and node:
        return "[\n" + ",\n".join(inner + _yaml_json(v, inner) for v in node) + f"\n{pad}]"
    if isinstance(node, float):
        text = repr(node)
        if not math.isfinite(node):
            return {"inf": ".inf", "-inf": "-.inf", "nan": ".nan"}[text]
        return text.replace("e", ".0e") if "e" in text and "." not in text else text
    return json.dumps(node)


def dump_config(config: dict) -> str:
    """The merged run config as YAML, as the JAX CLI archives it; where
    PyYAML is absent, as JSON that YAML loaders read as the same mapping."""
    try:
        import yaml
    except ImportError:
        return _yaml_json(config) + "\n"
    return yaml.safe_dump(config)


def run(
    config: dict,
    subcommand: str,
    device: str | torch.device = "cuda",
    ckpt_path: str | None = None,
    scene: SceneOptions | None = None,
) -> dict[str, Any]:
    """Run a subcommand from a parsed config on ``device``; ``predict-scene``
    takes its options in ``scene``."""
    if subcommand not in SUBCOMMANDS:
        msg = f"subcommand {subcommand!r} is not ported yet; the port runs {SUBCOMMANDS}"
        raise ValueError(msg)
    if subcommand == "predict-scene" and scene is None:
        msg = "predict-scene requires --scene <input.tif>"
        raise ValueError(msg)
    device = resolve_device(device)
    seed = config.get("seed_everything", 42)
    seed = 42 if seed is True else int(seed)
    trainer_node = config.get("trainer", {}) or {}
    trainer_cfg = build_trainer_config(trainer_node, seed)
    if subcommand == "predict-scene":
        if not is_host0():
            return {}
        # a scene is served on one process, unsharded, from the whole checkpoint
        trainer_cfg.mesh = MeshConfig(data=1, model=1)
    elif not initialize_distributed(device):
        world = world_size(trainer_cfg.mesh, device)
        if world > 1:
            return launch_ranks(config, subcommand, device, ckpt_path, world)
    spec = instantiate(config["model"])
    datamodule = instantiate(config["data"])
    tracker = build_tracker(trainer_node, trainer_cfg.checkpoint_dir)
    tracker.log_params(config)
    tracker.log_text(dump_config(config), "config/run_config.yaml")
    trainer = Trainer(trainer_cfg, tracker, device)
    ckpt_path = ckpt_path or config.get("ckpt_path")
    if hasattr(datamodule, "set_device"):  # worker processes pin batches for CUDA
        datamodule.set_device(device)
    try:
        with trainer.precision.scope():
            result = _dispatch(trainer, spec, datamodule, subcommand, ckpt_path, scene,
                               trainer_node)
    finally:
        tracker.finish()
        if hasattr(datamodule, "close"):  # worker processes end with the run
            datamodule.close()
    logger.info("%s result: %s", subcommand, result)
    return result


def launch_ranks(config: dict, subcommand: str, device: torch.device, ckpt_path: str | None,
                 world: int) -> dict[str, Any]:
    """:func:`run` on ``world`` spawned processes, one a rank (NCCL on
    CUDA, one device a rank; gloo on the CPU); rank 0's result."""
    if device.type == "cuda" and world > torch.cuda.device_count():
        msg = (f"trainer.mesh asks for {world} ranks but {torch.cuda.device_count()} CUDA "
               "devices are visible (NCCL takes one device a rank)")
        raise ValueError(msg)
    backend = "nccl" if device.type == "cuda" else "gloo"
    logger.info("%s on %d ranks (%s)", subcommand, world, backend)
    return launch(run, (config, subcommand, device.type, ckpt_path), size=world, backend=backend)


def _dispatch(trainer: Trainer, spec, datamodule, subcommand: str, ckpt_path, scene,
              trainer_node: dict) -> dict[str, Any]:
    if subcommand == "fit":
        return trainer.fit(spec.task, datamodule, ckpt_path=ckpt_path, **spec.fit_kwargs())
    if subcommand == "predict-scene":
        return run_predict_scene(trainer, spec, datamodule, ckpt_path, scene)
    out_dir = Path(trainer_node.get("default_root_dir", ".")) / "predictions"
    return run_eval_from_ckpt(trainer, spec, datamodule, ckpt_path, subcommand, out_dir)


def main(argv: list[str] | None = None) -> dict[str, Any]:
    setup_logging()
    parser = argparse.ArgumentParser(prog="gdl-torch")
    parser.add_argument("subcommand", choices=SUBCOMMANDS)
    parser.add_argument("--config", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--ckpt-path", default=None)
    parser.add_argument("--scene", default=None, help="predict-scene: input GeoTIFF scene")
    parser.add_argument("--output", default=None,
                        help="predict-scene: output class map (default <scene>_pred.tif)")
    parser.add_argument("--tile-size", type=int, default=512)
    parser.add_argument("--tile-overlap", type=int, default=128)
    parser.add_argument("--tile-batch", type=int, default=8)
    parser.add_argument("--blend", default="hann", choices=("hann", "uniform", "crop"),
                        help="overlap blending: hann taper, uniform average, or core cropping")
    parser.add_argument("--streamed", action="store_true",
                        help="band-streamed I/O (on by itself above 512 MB decoded)")
    parser.add_argument("overrides", nargs="*", help="a.b.c=value overrides")
    args = parser.parse_args(argv)
    scene = None
    if args.scene:
        scene = SceneOptions(args.scene, args.output, args.tile_size, args.tile_overlap,
                             args.tile_batch, args.blend, args.streamed)
    return run(load_config(args.config, args.overrides), args.subcommand, args.device,
               args.ckpt_path, scene)


if __name__ == "__main__":
    main(sys.argv[1:])
