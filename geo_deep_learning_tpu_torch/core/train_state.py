"""Train state: what a training run mutates and a checkpoint holds.

Port of ``geo_deep_learning_tpu/core/train_state.py``. The JAX package's
state is one immutable PyTree (params, optimizer state, BN statistics,
RNG key, step); here the model owns its parameters and BN buffers, the
optimizer its moments, and the random streams are explicit generators:

- ``aug_generator`` (CPU): augmentation choices and parameters, drawn on
  the host a few numbers per batch;
- ``dropout_generator`` (on the model's device): DropPath and dropout
  masks, handed to those modules by :func:`models.layers.set_generator`.

``plateau`` is the ReduceLROnPlateau controller when the run has one; its
state is part of a checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from geo_deep_learning_tpu_torch.models.layers import set_generator
from geo_deep_learning_tpu_torch.training.optim import PlateauController


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    aug_generator: torch.Generator
    dropout_generator: torch.Generator
    plateau: PlateauController | None = None
    step: int = 0

    @classmethod
    def create(
        cls,
        model: nn.Module,
        optimizer: torch.optim.Optimizer,
        seed: int,
        plateau: PlateauController | None = None,
    ) -> "TrainState":
        device = next(model.parameters()).device
        dropout = torch.Generator(device=device).manual_seed(seed + 1)
        set_generator(model, dropout)
        return cls(
            model=model,
            optimizer=optimizer,
            aug_generator=torch.Generator().manual_seed(seed + 2),
            dropout_generator=dropout,
            plateau=plateau,
        )

    def state_dict(self) -> dict:
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "aug_rng": self.aug_generator.get_state(),
            "dropout_rng": self.dropout_generator.get_state(),
            "plateau": None if self.plateau is None else self.plateau.state_dict(),
        }

    def load_state_dict(self, state: dict) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        # generator states are CPU byte tensors whatever the map_location
        self.aug_generator.set_state(state["aug_rng"].cpu())
        self.dropout_generator.set_state(state["dropout_rng"].cpu())
        if self.plateau is not None and state["plateau"] is not None:
            self.plateau.load_state_dict(state["plateau"])
