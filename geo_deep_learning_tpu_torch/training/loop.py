"""Trainer: fit / validate / test / predict loops.

Port of ``geo_deep_learning_tpu/training/loop.py`` (the reference's
Lightning Trainer + callbacks as an explicit loop):

- per-epoch validation; ``val_loss`` drives early stopping, the plateau LR
  and best-checkpoint retention;
- ``last.pt`` after the epochs, then the auto-test on the restored best
  checkpoint (reference ``train.py`` ``after_fit``);
- a fresh fit into a directory holding an earlier run's best resets the
  best tracking; ``ckpt_path`` resumes (step count, optimizer, generators);
- the model starts from seeded weights, then a pretrained encoder
  (``torch_weights``), then a warm start (``weights_from_checkpoint_path``,
  ``load_parts``), in the JAX package's order (``loop.py:240-282``).

Visualization of predictions on a new best is not ported (it needs
matplotlib). Everything runs on ``device`` (CUDA unless the caller asks
for the CPU).
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass
from typing import Any, Iterable, Iterator

import numpy as np
import torch

from geo_deep_learning_tpu_torch.core.device import resolve_device
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.models import convert
from geo_deep_learning_tpu_torch.ops import metrics as M
from geo_deep_learning_tpu_torch.ops.augment import AugmentConfig
from geo_deep_learning_tpu_torch.tools.tracking import FileTracker
from geo_deep_learning_tpu_torch.training import optim as optim_lib
from geo_deep_learning_tpu_torch.training.checkpoint import (
    CheckpointManager,
    load_weights_from_checkpoint,
)
from geo_deep_learning_tpu_torch.training.steps import (
    make_eval_step,
    make_predict_step,
    make_train_step,
    to_device,
)
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

logger = logging.getLogger(__name__)


@dataclass
class EarlyStopping:
    """val-metric early stopping (reference Lightning EarlyStopping)."""

    monitor: str = "val_loss"
    mode: str = "min"
    patience: int = 20
    best: float | None = None
    bad_epochs: int = 0

    def update(self, value: float) -> bool:
        """Returns True when training should stop."""
        better = (
            self.best is None
            or (self.mode == "min" and value < self.best)
            or (self.mode == "max" and value > self.best)
        )
        if better:
            self.best = value
            self.bad_epochs = 0
            return False
        self.bad_epochs += 1
        return self.bad_epochs > self.patience


def build_schedule(
    sched_cfg: dict,
    lr: float,
    total_steps: int | None,
    steps_per_epoch: int | None,
    onecycle_ctx: dict | None = None,
) -> tuple[optim_lib.Schedule | None, optim_lib.PlateauController | None]:
    """A (normalized) reference scheduler config -> a step schedule or a
    plateau controller (JAX package ``loop.py:83``). Epoch-unit schedules
    are converted to optimizer steps with ``steps_per_epoch``."""
    sched_cfg = dict(sched_cfg)
    name = sched_cfg.pop("name", sched_cfg.pop("class_path", None))
    if name in ("ReduceLROnPlateau", "torch.optim.lr_scheduler.ReduceLROnPlateau"):
        return None, optim_lib.PlateauController(
            mode=sched_cfg.get("mode", "min"),
            factor=float(sched_cfg.get("factor", 0.1)),
            patience=int(sched_cfg.get("patience", 10)),
            cooldown=int(sched_cfg.get("cooldown", 0)),
            min_lr=float(sched_cfg.get("min_lr", 0.0)),
            threshold=float(sched_cfg.get("threshold", 1e-4)),
            threshold_mode=sched_cfg.get("threshold_mode", "rel"),
            eps=float(sched_cfg.get("eps", 1e-8)),
            base_lr=lr,
        )
    if name in ("OneCycleLR", "torch.optim.lr_scheduler.OneCycleLR"):
        # the reference's total-steps fallbacks in its order: the trainer's
        # sized loader, a streaming epoch size, the config's total_steps
        ctx = onecycle_ctx or {}
        accum = max(int(ctx.get("accumulate", 1)), 1)
        if total_steps:
            steps = -(-int(total_steps) // accum)
        elif ctx.get("epoch_size") and ctx.get("batch_size"):
            spe = -(-int(ctx["epoch_size"]) // (int(ctx["batch_size"]) * accum))
            steps = (spe + spe * accum) * int(ctx.get("max_epochs", 1))
        else:
            steps = int(sched_cfg.get("total_steps") or 1000)
        kw = {k: float(sched_cfg[k]) for k in ("pct_start", "div_factor", "final_div_factor")
              if k in sched_cfg}
        if sched_cfg.get("anneal_strategy", "cos") != "cos":
            logger.warning("OneCycleLR anneal_strategy=%r not supported; using cos",
                           sched_cfg["anneal_strategy"])
        return optim_lib.one_cycle(float(sched_cfg.get("max_lr", lr)), steps, **kw), None
    if name in ("LinearWarmupCosineAnnealingLR",
                "tools.schedulers.lr_scheduler.LinearWarmupCosineAnnealingLR"):
        spe = steps_per_epoch or 1
        return optim_lib.linear_warmup_cosine_annealing(
            warmup_epochs=int(sched_cfg.get("warmup_epochs", 0)) * spe,
            max_epochs=int(sched_cfg.get("max_epochs", total_steps or 1000)) * spe,
            warmup_start_lr=float(sched_cfg.get("warmup_start_lr", 0.0)),
            eta_min=float(sched_cfg.get("eta_min", 0.0)),
            base_lr=lr,
        ), None
    return None, None


def _normalize(cfg: dict | None, default: dict) -> dict:
    """Accept flat ``{'name', ...}`` and ``{'class_path', 'init_args'}`` shapes."""
    cfg = dict(cfg or default)
    if "init_args" in cfg:
        cfg.update(cfg.pop("init_args") or {})
    return cfg


@dataclass
class TrainerConfig:
    max_epochs: int = 10
    precision: str = "bf16-mixed"
    grad_clip: float | None = 1.0
    monitor: str = "val_loss"
    monitor_mode: str = "min"
    early_stopping_patience: int | None = 20
    checkpoint_dir: str = "checkpoints"
    log_every_n_steps: int = 10
    seed: int = 42
    augment: bool = True
    accumulate_grad_batches: int = 1
    auto_test_after_fit: bool = True


class Trainer:
    def __init__(
        self,
        config: TrainerConfig | None = None,
        tracker: FileTracker | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.config = config or TrainerConfig()
        self.tracker = tracker
        self.device = resolve_device(device)
        self.precision = PrecisionPolicy.create(self.config.precision)
        self.ckpt: CheckpointManager | None = None
        self.state: TrainState | None = None
        self._schedule: optim_lib.Schedule | None = None
        self._base_lr = float("nan")

    def _log(self, metrics: dict[str, float], step: int) -> None:
        if self.tracker is not None:
            self.tracker.log_metrics(metrics, step)

    def _current_lr(self) -> float:
        if self.state is not None and self.state.plateau is not None:
            return self.state.plateau.lr
        if self._schedule is not None:
            return self._schedule(self.state.step // self.config.accumulate_grad_batches)
        return self._base_lr

    def init_model(
        self,
        task: SegmentationTask,
        torch_weights: dict | None = None,
        weights_from_checkpoint_path: str | None = None,
        load_parts: list[str] | None = None,
    ) -> torch.nn.Module:
        """The task's model on the device with seeded weights, then the
        pretrained encoder of ``torch_weights`` (``{"path", "format":
        resnet|mit|dofa, "in_channels", "subtree"}``), then the warm start."""
        model = task.materialize(self.device, self.config.seed)
        if torch_weights:
            converted = convert.load_pretrained_tree(
                torch_weights["path"], fmt=torch_weights.get("format", "resnet"),
                in_channels=int(torch_weights.get("in_channels", 3)),
            )
            names = convert.merge_pretrained(model, converted, torch_weights.get("subtree", "encoder"))
            logger.info("loaded %d pretrained tensors from %s", len(names), torch_weights["path"])
        if weights_from_checkpoint_path:
            load_weights_from_checkpoint(weights_from_checkpoint_path, model, load_parts)
        return model

    def init_state(
        self,
        task: SegmentationTask,
        optimizer: dict | None = None,
        scheduler: dict | None = None,
        total_steps: int | None = None,
        steps_per_epoch: int | None = None,
        freeze_layers: list[str] | None = None,
        onecycle_ctx: dict | None = None,
        **weights: Any,
    ) -> TrainState:
        """The model of :meth:`init_model` (``weights`` are its keywords),
        frozen layers, optimizer, schedule."""
        cfg = self.config
        model = self.init_model(task, **weights)
        frozen = optim_lib.freeze(model, freeze_layers)
        if frozen:
            logger.info("frozen: %d parameter tensors matching %s", len(frozen), freeze_layers)
        opt_cfg = _normalize(optimizer, {"name": "adam", "lr": 1e-4})
        name = opt_cfg.pop("name", opt_cfg.pop("class_path", "adam"))
        lr = float(opt_cfg.pop("lr", 1e-4))
        self._schedule, plateau = build_schedule(
            _normalize(scheduler, {}), lr, total_steps, steps_per_epoch, onecycle_ctx
        )
        self._base_lr = lr
        trainable = [p for p in model.parameters() if p.requires_grad]
        opt = optim_lib.build_optimizer(trainable, name, lr, **opt_cfg)
        self.state = TrainState.create(model, opt, cfg.seed, plateau)
        return self.state

    # ------------------------------------------------------------------
    def fit(
        self,
        task: SegmentationTask,
        datamodule,
        optimizer: dict | None = None,
        scheduler: dict | None = None,
        ckpt_path: str | None = None,
        freeze_layers: list[str] | None = None,
        **weights: Any,
    ) -> dict:
        """Train, validate each epoch, keep the best and ``last.pt``, then
        test the best; ``weights`` are :meth:`init_model`'s keywords."""
        cfg = self.config
        datamodule.setup("fit")
        train_loader = datamodule.train_dataloader()
        # The JAX fit peeks at one batch (``next(iter(train_loader))``) to
        # build its state, which uses up the loader's epoch 0, resumed or
        # not; starting at epoch 1 gives every epoch the same shuffle order
        # without decoding a batch.
        train_loader.epoch += 1
        steps_per_epoch = len(train_loader)
        self.init_state(
            task, optimizer, scheduler, steps_per_epoch * cfg.max_epochs, steps_per_epoch,
            freeze_layers,
            {"epoch_size": getattr(datamodule, "epoch_size", None),
             "batch_size": getattr(datamodule, "batch_size", None),
             "accumulate": cfg.accumulate_grad_batches, "max_epochs": cfg.max_epochs},
            **weights,
        )
        self.ckpt = CheckpointManager(cfg.checkpoint_dir, monitor=cfg.monitor, mode=cfg.monitor_mode)
        if ckpt_path:
            self.ckpt.restore(ckpt_path, self.state)
            logger.info("resumed from %s at step %d", ckpt_path, self.state.step)
        elif self.ckpt.best_path is not None:
            logger.warning("checkpoint dir %s holds an earlier run's best (%s); "
                           "starting fresh best tracking", cfg.checkpoint_dir, self.ckpt.best_path)
            self.ckpt.reset_best()

        train_step = make_train_step(
            task, self.precision, AugmentConfig() if cfg.augment else None,
            grad_clip=cfg.grad_clip, schedule=self._schedule,
            accumulate=cfg.accumulate_grad_batches,
        )
        eval_step = make_eval_step(task, self.precision)
        stopper = (
            EarlyStopping(cfg.monitor, cfg.monitor_mode, cfg.early_stopping_patience)
            if cfg.early_stopping_patience is not None else None
        )
        history: dict[str, float] = {}
        for epoch in range(cfg.max_epochs):
            t0 = time.perf_counter()
            losses = []
            n_samples = 0
            for batch in train_loader:
                out = train_step(self.state, to_device(batch, self.device))
                losses.append(out["loss"])
                n_samples += int(batch["mask"].shape[0])
                if self.state.step % cfg.log_every_n_steps == 0:
                    self._log({"train_loss_step": float(out["loss"])}, self.state.step)
            train_loss = float(torch.stack(losses).mean()) if losses else float("nan")
            epoch_time = time.perf_counter() - t0

            val_metrics = self._run_eval(task, eval_step, datamodule.val_dataloader(), "val")
            epoch_metrics = {
                "train_loss": train_loss,
                "epoch_time_s": epoch_time,
                "patches_per_sec": n_samples / epoch_time if epoch_time > 0 else 0.0,
                "lr": self._current_lr(),
                **val_metrics,
            }
            self._log(epoch_metrics, epoch)
            logger.info("epoch %d: train_loss=%.4f val_loss=%.4f (%.1f patches/s)", epoch,
                        train_loss, val_metrics.get("val_loss", float("nan")),
                        epoch_metrics["patches_per_sec"])
            history = epoch_metrics

            plateau = self.state.plateau
            if plateau is not None and cfg.monitor in val_metrics:
                old = plateau.scale
                plateau.update(val_metrics[cfg.monitor])
                if plateau.scale != old:
                    optim_lib.set_learning_rate(self.state.optimizer, plateau.lr)

            self.ckpt.save(self.state, epoch, epoch_metrics)
            if stopper and cfg.monitor in epoch_metrics and stopper.update(epoch_metrics[cfg.monitor]):
                logger.info("early stopping at epoch %d", epoch)
                break

        self.ckpt.save_last(self.state)

        if cfg.auto_test_after_fit:
            try:
                test_loader = datamodule.test_dataloader()
            except FileNotFoundError:
                test_loader = None
            if test_loader is not None:
                if self.ckpt.best_path is not None:
                    self.ckpt.restore(self.ckpt.best_path, self.state)
                test_metrics = self._run_eval(task, eval_step, test_loader, "test", task)
                self._log(test_metrics, cfg.max_epochs)
                history.update(test_metrics)
        return history

    # ------------------------------------------------------------------
    def _run_eval(
        self,
        task: SegmentationTask,
        eval_step,
        loader: Iterable,
        prefix: str,
        task_labels: SegmentationTask | None = None,
    ) -> dict[str, float]:
        """Dataset-level loss (weighted by real samples), IoU and, for
        ``test``, accuracy and F1, from one confusion matrix."""
        losses, counts = [], []
        cm = torch.zeros((task.eval_classes, task.eval_classes), device=self.device)
        for batch in loader:
            out = eval_step(to_device(batch, self.device))
            losses.append(out["loss"])
            counts.append(int(batch.get("valid_count", batch["mask"].shape[0])))
            cm += out["confusion"]
        if not losses:
            return {}
        loss = torch.stack(losses).cpu().numpy()
        cm = cm.cpu()
        iou = M.iou_from_confusion(cm)
        result = {
            f"{prefix}_loss": float(np.average(loss, weights=counts)) if sum(counts) else float("nan"),
            f"{prefix}_miou": float(torch.nanmean(iou)),
        }
        labels = task_labels.class_labels if task_labels is not None else None
        if labels:
            result.update(M.classwise(iou, labels, f"{prefix}_iou"))
        if prefix == "test":
            f1 = M.f1_from_confusion(cm)
            result[f"{prefix}_accuracy"] = float(M.accuracy_from_confusion(cm))
            result[f"{prefix}_mf1"] = float(torch.nanmean(f1))
            if labels:
                result.update(M.classwise(f1, labels, f"{prefix}_f1"))
        return result

    def evaluate(self, task: SegmentationTask, loader: Iterable, prefix: str) -> dict[str, float]:
        """Metrics of the current state over ``loader`` (``val`` or ``test``)."""
        return self._run_eval(task, make_eval_step(task, self.precision), loader, prefix, task)

    def predict(self, task: SegmentationTask, loader: Iterable) -> Iterator[dict[str, Any]]:
        predict_step = make_predict_step(task, self.precision)
        for batch in loader:
            out = predict_step(to_device(batch, self.device))
            yield {"preds": out["preds"].cpu().numpy(), "probs": out["probs"], "batch": batch}
