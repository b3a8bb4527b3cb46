"""The numbers that decide ``correct``, each held to a limit of its cell.

Training (three first steps of the program against the plain reference's
three on the same batches and weights):

- ``loss_gap``: the largest relative gap of a step's loss;
- ``grad_gap``: over the leaves, the largest gap between the program's
  and the reference's norm of the first gradient (as Adam holds it after
  step 1), over the reference's norm of that leaf or of the median leaf,
  whichever is larger;
- ``change_gap``: the same of each leaf's change over the three steps,
  taken over the elements whose first reference gradient is at least a
  thousandth of the median leaf's root-mean-square element: the others,
  such as the key third of a packed ``qkv`` bias under softmax, have a
  gradient that is nought to rounding and move under Adam by round-off
  alone (a leaf left with no element is left out);
- ``grad_gap_median`` and ``change_gap_median``: the median leaf's gap of
  the same two, steady from seed to seed where one small leaf's noise
  sets the worst (a cell's ``limits`` name the numbers it compares).

Scenes (the program's class maps and blended logits of a sample of the
window's scenes against the reference's blended logits of the same
scenes, each in units of the reference logits' standard deviation over
the scene):

- ``map_gap``: the widest gap by which the reference's logit of the class
  the program chose lies below the reference's best, over every pixel;
- ``flip_share``: the share of pixels whose class differs from the
  reference's;
- ``logit_gap``: the largest gap of a blended logit;
- ``logit_gap_bf16``: ``logit_gap`` over the largest gap that rounding
  every product's operands to bf16 gives the reference itself: how far
  the weights of a seed let rounding move the logits varies from seed to
  seed (``logit_gap`` 0.025-0.115 on sound runs), and this ratio does not.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE = 1e-3  # of the median leaf's reference gradient


def _leaf_gaps(prog: dict, ref: dict) -> list[float]:
    """Each leaf's gap of norms over the reference's norm of that leaf or of
    the median leaf, whichever is larger."""
    if not ref:
        return [0.0]
    median = statistics.median(ref.values())
    return [abs(prog.get(n, 0.0) - r) / max(r, median, 1e-30) for n, r in ref.items()]


def change_norms(delta: dict, grad1: dict) -> dict[str, float]:
    """Each leaf's change norm over the elements whose first reference
    gradient is not negligible; leaves with none are left out."""
    rms = [float(g.float().square().mean().sqrt()) for g in grad1.values() if g.numel()]
    floor = NEGLIGIBLE * statistics.median(rms)
    out = {}
    for n, g in grad1.items():
        keep = g.abs() >= floor
        if bool(keep.any()):
            d = delta[n].to(g.device) if n in delta else torch.zeros_like(g)
            out[n] = float(torch.linalg.vector_norm(d.float() * keep))
    return out


def train_numbers(program: dict, reference: dict) -> dict[str, float]:
    """``program`` and ``reference``: ``loss`` (a step's), ``grad`` (leaf
    norms of the first gradient), ``delta`` (each leaf's change); the
    reference's ``grad1``, its first gradient."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(program["loss"], reference["loss"], strict=True))
    grad = _leaf_gaps(program["grad"], reference["grad"])
    change = _leaf_gaps(change_norms(program["delta"], reference["grad1"]),
                        change_norms(reference["delta"], reference["grad1"]))
    return {
        "loss_gap": loss,
        "grad_gap": max(grad),
        "change_gap": max(change),
        "grad_gap_median": statistics.median(grad),
        "change_gap_median": statistics.median(change),
    }


def scene_numbers(maps: list[torch.Tensor], logits: list[torch.Tensor],
                  reference: list[torch.Tensor], rounded: list[torch.Tensor]) -> dict[str, float]:
    """``maps``: the program's ``[H, W]`` class maps; ``logits``: its
    ``[H, W, K]`` blended logits; ``reference`` and ``rounded``: the
    reference's ``[K, H, W]`` blended logits of the same scenes, in f32 and
    with bf16 operands."""
    out = {"map_gap": 0.0, "flip_share": 0.0, "logit_gap": 0.0}
    flips = pixels = 0
    scale = 0.0
    for cls, lg, ref, bf in zip(maps, logits, reference, rounded, strict=True):
        cls = cls.to(ref.device).long()
        std = ref.std()
        best = ref.amax(dim=0)
        chosen = torch.gather(ref, 0, cls[None].clamp(0, ref.shape[0] - 1))[0]
        chosen = torch.where(cls < ref.shape[0], chosen, torch.full_like(chosen, -float("inf")))
        out["map_gap"] = max(out["map_gap"], float((best - chosen).amax() / std))
        flips += int((cls != ref.argmax(dim=0)).sum())
        pixels += cls.numel()
        err = lg.to(ref.device).permute(2, 0, 1).float() - ref
        out["logit_gap"] = max(out["logit_gap"], float(err.abs().amax() / std))
        scale = max(scale, float((bf - ref).abs().amax() / std))
    out["flip_share"] = flips / pixels
    out["logit_gap_bf16"] = out["logit_gap"] / max(scale, 1e-30)
    return out


def verdict(numbers: dict[str, float], limits: dict[str, float]) -> bool:
    """Every number at or under its limit (a number that is not finite
    fails)."""
    return all(numbers[k] == numbers[k] and numbers[k] <= limits[k] for k in limits)
