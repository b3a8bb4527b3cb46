"""Seeded model state, made on the device in one draw.

The benchmark makes every parameter and buffer itself and hands the same
dict to the program (``load_state_dict`` by the port's names) and to the
plain reference. The names and shapes are the port's state layout; the
values come from one ``torch.rand`` call of a generator seeded from
``--seed`` on the run's device, cut into leaves and mapped by a rule on
each name:

- weights of two or more dimensions (convs, linears, in-projections):
  U(-sqrt(6/fan_in), sqrt(6/fan_in)), He's uniform range, which keeps
  the activations' scale through conv + ReLU chains; with torch's default
  range (a third of the variance) the eval-mode outputs shrink to the
  classifier's biases and every pixel takes one class;
- biases: U(-0.05, 0.05);
- LayerScale gammas: U(0.1, 0.5), so that every block's branches weigh in
  the result (the published init of 1e-5 would hide them);
- norm weights: U(0.8, 1.2);
- learned tokens (cls, the weight generator's): U(-0.035, 0.035) (std 0.02);
- BatchNorm running statistics: mean U(-0.1, 0.1), variance U(0.5, 1.5),
  ``num_batches_tracked`` 0;
- fixed tables the reference names (``buffers``): the reference's values.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# (lower, upper) by kind of leaf
RANGES = {
    "bias": (-0.05, 0.05),
    "gamma": (0.1, 0.5),
    "norm_weight": (0.8, 1.2),
    "token": (-0.035, 0.035),
    "running_mean": (-0.1, 0.1),
    "running_var": (0.5, 1.5),
}


def derive(seed: int, tag: int) -> int:
    """A generator seed for one stream of a run (weights, data, sample)."""
    return (int(seed) * 1_000_003 + tag) % (2 ** 63)


def kind(name: str, shape: tuple) -> str:
    last = name.rsplit(".", 1)[-1]
    if last == "num_batches_tracked":
        return "zero"
    if last in ("running_mean", "running_var", "gamma"):
        return last
    if "token" in last:
        return "token"
    if "bias" in last:
        return "bias"
    if len(shape) >= 2:
        return "fan_in"
    return "norm_weight"


def make_state(layout: dict[str, tuple[tuple, torch.dtype]], seed: int,
               device: torch.device, tables: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``{name: tensor}`` for a layout ``{name: (shape, dtype)}``; names in
    ``tables`` take the table's values."""
    drawn = [(n, s) for n, (s, dt) in layout.items()
             if n not in tables and kind(n, s) != "zero"]
    total = sum(math.prod(s) for _, s in drawn)
    gen = torch.Generator(device=device).manual_seed(derive(seed, 1))
    flat = torch.rand(total, generator=gen, device=device)
    out, off = {}, 0
    for name, shape in drawn:
        n = math.prod(shape)
        u = flat[off: off + n].view(shape)
        off += n
        k = kind(name, shape)
        if k == "fan_in":
            b = math.sqrt(6.0 / math.prod(shape[1:]))
            lo, hi = -b, b
        else:
            lo, hi = RANGES[k]
        out[name] = u * (hi - lo) + lo
    for name, (shape, dtype) in layout.items():
        if name in tables:
            out[name] = torch.from_numpy(tables[name]).to(device)
        elif name not in out:
            out[name] = torch.zeros(shape, dtype=dtype, device=device)
    return out
