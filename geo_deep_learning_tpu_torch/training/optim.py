"""Optimizers, gradient clipping, layer freezing and LR schedules.

Port of ``geo_deep_learning_tpu/training/optim.py``:

- ``torch.optim.Adam`` / ``AdamW`` / ``SGD`` by config name or torch
  class path. The JAX package builds torch-exact optax chains for these;
  here they are torch's own classes (Adam's ``weight_decay`` is L2, AdamW's
  decoupled, SGD's ``dampening`` is refused as the JAX package refuses it).
- Global-norm clipping with optax's ``clip_by_global_norm`` formula:
  gradients are left alone when their norm is below ``max_norm`` and
  otherwise become ``g / norm * max_norm`` (no ``+1e-6`` in the
  denominator, unlike ``torch.nn.utils.clip_grad_norm_``).
- :func:`freeze`: parameters whose dotted name contains a pattern get
  ``requires_grad_(False)`` and no optimizer slot (optax's ``set_to_zero``
  mask; autograd then skips their backward, as ``stop_gradient`` lets XLA).
- Closed-form schedules ``step -> lr`` equal to the JAX package's optax
  schedules: :func:`linear_warmup_cosine_annealing`,
  :func:`linear_warmup_decay`, :func:`one_cycle`; and the host-side
  :class:`PlateauController` (torch ``ReduceLROnPlateau`` semantics) with
  :func:`set_learning_rate`.
"""

from __future__ import annotations

import logging
import math
from dataclasses import dataclass, field
from typing import Callable, Iterable

import torch
from torch import nn

logger = logging.getLogger(__name__)

Schedule = Callable[[int], float]

# torch class_path aliases so reference configs translate verbatim
_ALIASES = {
    "torch.optim.Adam": "adam",
    "torch.optim.AdamW": "adamw",
    "torch.optim.SGD": "sgd",
}

# every kwarg each optimizer understands; anything else is warned about
_KNOWN_KW = {
    "adam": {"betas", "b1", "b2", "eps", "weight_decay", "amsgrad"},
    "adamw": {"betas", "b1", "b2", "eps", "weight_decay", "amsgrad"},
    "sgd": {"momentum", "nesterov", "weight_decay", "dampening"},
}


def _betas(kw: dict) -> tuple[float, float]:
    """torch configs say ``betas: [b1, b2]``; accept b1/b2 too."""
    if "betas" in kw:
        b1, b2 = kw["betas"]
        return float(b1), float(b2)
    return float(kw.get("b1", 0.9)), float(kw.get("b2", 0.999))


def build_optimizer(
    params: Iterable[torch.Tensor], name: str = "adam", lr: float = 1e-4, **kwargs
) -> torch.optim.Optimizer:
    """``torch.optim`` optimizer by config name over ``params``."""
    key = _ALIASES.get(name, name).lower()
    if key not in _KNOWN_KW:
        msg = f"unknown optimizer {name!r}; known: {sorted(_KNOWN_KW)}"
        raise ValueError(msg)
    unknown = set(kwargs) - _KNOWN_KW[key]
    if unknown:
        logger.warning("optimizer %r: ignoring unrecognized init_args %s", key, sorted(unknown))
    params = list(params)
    if key in ("adam", "adamw"):
        cls = torch.optim.Adam if key == "adam" else torch.optim.AdamW
        return cls(
            params, lr=lr, betas=_betas(kwargs), eps=float(kwargs.get("eps", 1e-8)),
            weight_decay=float(kwargs.get("weight_decay", 0.0 if key == "adam" else 0.01)),
            amsgrad=bool(kwargs.get("amsgrad", False)),
        )
    if float(kwargs.get("dampening", 0.0)) != 0.0:
        msg = "SGD dampening != 0 is not supported (the JAX package has no analog)"
        raise NotImplementedError(msg)
    return torch.optim.SGD(
        params, lr=lr, momentum=float(kwargs.get("momentum", 0.0)),
        nesterov=bool(kwargs.get("nesterov", False)),
        weight_decay=float(kwargs.get("weight_decay", 0.0)),
    )


def freeze(model: nn.Module, patterns: list[str] | None) -> list[str]:
    """Stop gradients of every parameter whose name contains a pattern;
    return the frozen names."""
    frozen = []
    for name, p in model.named_parameters():
        if patterns and any(s in name for s in patterns):
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


@torch.no_grad()
def clip_by_global_norm_(params: Iterable[torch.Tensor], max_norm: float,
                         model_group=None) -> torch.Tensor:
    """Scale the gradients in place by optax's global-norm rule; returns the
    norm. No host synchronization: the choice is made on the device.

    Under tensor parallelism (``model_group``, the mesh's model group) the
    norm is the whole model's: the squared norms of the sharded gradients
    (parameters tagged ``model_split`` by ``parallel.placement``) are summed
    over the group, the replicated ones count once."""
    params = list(params)
    grads = [p.grad for p in params if p.grad is not None]
    if not grads:
        return torch.zeros(())
    if model_group is None:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    else:
        norm = _model_global_norm(params, model_group)
    keep = norm < max_norm
    one = torch.ones_like(norm)
    torch._foreach_div_(grads, torch.where(keep, one, norm))
    torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(norm, max_norm)))
    return norm


def _model_global_norm(params: list[torch.Tensor], group) -> torch.Tensor:
    import torch.distributed as dist

    parts = {True: [], False: []}
    for p in params:
        if p.grad is not None:
            parts[getattr(p, "model_split", None) is not None].append(p.grad)
    device = (parts[True] or parts[False])[0].device
    squares = torch.zeros(2, dtype=torch.float32, device=device)
    for i, grads in enumerate((parts[True], parts[False])):
        if grads:
            squares[i] = torch.stack(torch._foreach_norm(grads)).float().square().sum()
    sharded = squares[:1].clone()
    dist.all_reduce(sharded, group=group)
    return torch.sqrt(sharded[0] + squares[1])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax ``linear_schedule``: ``init -> end`` over ``steps``, then held."""

    def schedule(step: int) -> float:
        if steps <= 0:
            return init
        frac = 1.0 - min(max(step, 0), steps) / steps
        return (init - end) * frac + end

    return schedule


def _cosine(init: float, steps: int, alpha: float = 0.0) -> Schedule:
    """optax ``cosine_decay_schedule``."""

    def schedule(step: int) -> float:
        cos = 0.5 * (1.0 + math.cos(math.pi * min(step, steps) / steps))
        return init * ((1.0 - alpha) * cos + alpha)

    return schedule


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """optax ``join_schedules``: ``then`` counts from ``boundary``."""
    return lambda step: first(step) if step < boundary else then(step - boundary)


def linear_warmup_cosine_annealing(
    warmup_epochs: int,
    max_epochs: int,
    warmup_start_lr: float = 0.0,
    eta_min: float = 0.0,
    base_lr: float = 1e-3,
) -> Schedule:
    """Reference ``LinearWarmupCosineAnnealingLR`` in steps of its unit:
    the ramp reaches ``base_lr`` at ``warmup_epochs - 1``, then a cosine over
    ``max_epochs - warmup_epochs`` down to ``eta_min``."""
    ramp = _linear(warmup_start_lr, base_lr, max(warmup_epochs - 1, 1))
    span = max(max_epochs - warmup_epochs, 1)
    cosine = (lambda _: 0.0) if base_lr == 0.0 else _cosine(base_lr, span, eta_min / base_lr)
    return _join(ramp, cosine, warmup_epochs)


def linear_warmup_decay(
    warmup_steps: int, total_steps: int, base_lr: float, cosine: bool = True, linear: bool = False
) -> Schedule:
    """Reference ``linear_warmup_decay`` lambda factory."""
    if cosine and linear:
        msg = "cosine and linear decay are mutually exclusive"
        raise ValueError(msg)
    rest = max(total_steps - warmup_steps, 1)
    if cosine:
        decay = _cosine(base_lr, rest)
    elif linear:
        decay = _linear(base_lr, 0.0, rest)
    else:
        decay = lambda _: base_lr  # noqa: E731
    return _join(_linear(0.0, base_lr, warmup_steps), decay, warmup_steps)


def one_cycle(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    """torch ``OneCycleLR`` (cos) in the JAX package's closed form; past the
    cycle's end the final LR is held."""
    initial_lr = max_lr / div_factor
    min_lr = initial_lr / final_div_factor
    s1 = float(pct_start * total_steps) - 1.0
    s2 = float(total_steps) - 1.0

    def schedule(step: int) -> float:
        if step <= s1:
            pct = min(max(step / max(s1, 1e-8), 0.0), 1.0)
            return max_lr + (initial_lr - max_lr) / 2.0 * (1.0 + math.cos(math.pi * pct))
        pct = min(max((step - s1) / max(s2 - s1, 1e-8), 0.0), 1.0)
        return min_lr + (max_lr - min_lr) / 2.0 * (1.0 + math.cos(math.pi * pct))

    return schedule


@dataclass
class PlateauController:
    """Host-side ReduceLROnPlateau (torch semantics).

    :meth:`update` takes the monitored metric once per epoch and returns
    the LR scale in ``[min_lr / base_lr, 1]``; the trainer writes
    ``base_lr * scale`` into the optimizer.
    """

    mode: str = "min"
    factor: float = 0.1
    patience: int = 10
    cooldown: int = 0
    min_lr: float = 0.0
    threshold: float = 1e-4
    threshold_mode: str = "rel"  # torch: 'rel' | 'abs'
    base_lr: float = 1e-3
    eps: float = 1e-8  # torch: skip reductions smaller than this
    scale: float = field(default=1.0, init=False)
    _best: float | None = field(default=None, init=False)
    _bad_epochs: int = field(default=0, init=False)
    _cooldown_left: int = field(default=0, init=False)

    _STATE = ("scale", "_best", "_bad_epochs", "_cooldown_left")

    def _is_better(self, value: float) -> bool:
        if self._best is None:
            return True
        if self.mode == "min":
            if self.threshold_mode == "rel":
                return value < self._best * (1.0 - self.threshold)
            return value < self._best - self.threshold
        if self.threshold_mode == "rel":
            return value > self._best * (1.0 + self.threshold)
        return value > self._best + self.threshold

    def update(self, value: float) -> float:
        # torch ReduceLROnPlateau.step(): cooldown counts down every epoch,
        # and reductions below eps are skipped
        if self._is_better(value):
            self._best = value
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
        if self._cooldown_left > 0:
            self._cooldown_left -= 1
            self._bad_epochs = 0
        if self._bad_epochs > self.patience:
            old_lr = self.base_lr * self.scale
            new_lr = max(old_lr * self.factor, self.min_lr)
            if old_lr - new_lr > self.eps:
                self.scale = new_lr / self.base_lr
                logger.info("ReduceLROnPlateau: lr -> %g", new_lr)
            self._cooldown_left = self.cooldown
            self._bad_epochs = 0
        return self.scale

    @property
    def lr(self) -> float:
        return self.base_lr * self.scale

    def state_dict(self) -> dict:
        return {k: getattr(self, k) for k in self._STATE}

    def load_state_dict(self, state: dict) -> None:
        for k in self._STATE:
            setattr(self, k, state[k])
