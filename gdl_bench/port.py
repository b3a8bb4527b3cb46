"""What the benchmark takes from the program: the model, the train step,
the scene forward, and the names of its kernels' operators.

Everything here reaches ``geo_deep_learning_tpu_torch`` through its own
entry points, as ``Trainer.fit`` and ``predict-scene`` use them:
``SegmentationTask.materialize`` and ``load_state_dict`` for the model,
``build_optimizer`` + ``TrainState.create`` + ``make_train_step`` and
``to_device`` for training, ``cli.main.tile_forward`` with
``sliding_window_logits``, ``normalize`` and ``logits_to_classes`` for
scenes. A configuration's ``port`` node names the task class and its
arguments; its drop rates are applied to the model's DropPath and Dropout
layers.
"""

from __future__ import annotations

import importlib

import torch


def _task_spec(cfg: dict):
    node = cfg["port"]
    module, name = node["class_path"].rsplit(".", 1)
    return getattr(importlib.import_module(module), name)(**node.get("init_args", {}))


def state_layout(cfg: dict) -> dict[str, tuple[tuple, torch.dtype]]:
    """The port model's state names, shapes and dtypes (built on ``meta``)."""
    model = _task_spec(cfg).task.model
    return {k: (tuple(v.shape), v.dtype) for k, v in model.state_dict().items()}


def build_task(cfg: dict, state: dict, device: torch.device, seed: int):
    """The configuration's task with its model on ``device`` holding
    ``state``, drop rates as configured."""
    from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout

    task = _task_spec(cfg).task
    model = task.materialize(device, seed)
    for m in model.modules():
        if isinstance(m, DropPath):
            m.rate = float(cfg["drop_path_rate"])
        elif isinstance(m, Dropout):
            m.rate = float(cfg["dropout_ratio"])
    model.load_state_dict(state, strict=True)
    return task


def precision(cfg: dict):
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy

    return PrecisionPolicy.create(cfg["precision"])


def train_step(cfg: dict, task, seed: int):
    """``(state, step)``: the train state (model, Adam, generators) and the
    step ``make_train_step`` builds, as ``Trainer.fit`` wires them with
    augmentation off and no schedule inside the first epoch."""
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.steps import make_train_step

    opt = cfg["optimizer"]
    optimizer = optim.build_optimizer(task.model.parameters(), opt["name"], opt["lr"],
                                      betas=opt["betas"], eps=opt["eps"])
    state = TrainState.create(task.model, optimizer, seed)
    step = make_train_step(task, precision(cfg), augment=None, grad_clip=cfg["grad_clip"])
    return state, step


def to_device(batch: dict, device: torch.device) -> dict:
    from geo_deep_learning_tpu_torch.training.steps import to_device as port_to_device

    return port_to_device(batch, device)


def scene_fns(cfg: dict, task):
    """``(forward, sliding_window_logits, normalize, logits_to_classes,
    SlidingWindowConfig)`` of the program's scene path."""
    from geo_deep_learning_tpu_torch.cli.main import tile_forward
    from geo_deep_learning_tpu_torch.inference import sliding_window as sw

    return (tile_forward(task, precision(cfg)), sw.sliding_window_logits, sw.normalize,
            sw.logits_to_classes, sw.SlidingWindowConfig)
