"""Each plain reference agrees with the port's CPU path at tiny widths, on
one CPU twin of each family (``tiny.py``).

The test may import the program; the references never do."""

from __future__ import annotations

import importlib

import pytest
import torch

from gdl_bench import port, weights
from gdl_bench.reference.common import loss_of, normalize_nhwc
from gdl_bench.reference.numerics import FP8, Plain
from gdl_bench.tests import tiny


def _one_per_family() -> dict[str, dict]:
    """Tiny configuration -> itself: the twins' first by name of each family."""
    first = {}
    for cfg in sorted((c for _, c in tiny.tiny_cells().values()), key=lambda c: c["name"]):
        first.setdefault(cfg["family"], cfg)
    return {c["name"]: c for c in first.values()}


FAMILIES = _one_per_family()
# rows a batch: UperNet's 1 x 1 pooling branch normalizes each channel over
# the batch alone, and over two rows its BatchNorm's gradient is eps / d^3,
# a function of the rounding; eight rows keep it well conditioned
BATCH = 8


@pytest.fixture(scope="module", autouse=True)
def registered():
    tiny.register()


def _setup(name: str, seed: int = 7):
    cfg = FAMILIES[name]
    ref = importlib.import_module(f"gdl_bench.reference.{cfg['family']}")
    layout = port.state_layout(cfg)
    state = weights.make_state(layout, seed, torch.device("cpu"), ref.buffers(cfg))
    task = port.build_task(cfg, state, torch.device("cpu"), seed)
    s = cfg["image_size"]
    img = torch.randint(0, 256, (BATCH, s, s, 3), dtype=torch.uint8,
                        generator=torch.Generator().manual_seed(seed))
    return cfg, ref, state, task, normalize_nhwc(img, cfg["mean"], cfg["std"])


@pytest.mark.parametrize("name", sorted(FAMILIES))
@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_port_f32(name, train):
    cfg, ref, state, task, x = _setup(name)
    task.model.train(train)
    with torch.no_grad():
        got = task.forward({}, x)
        want, aux = ref.forward(Plain(), {k: v.float() for k, v in state.items()}, cfg, x, train)
    scale = float(want.abs().max())
    assert float((got.out - want).abs().max()) <= 1e-4 * scale
    if aux is not None:
        assert float((got.aux - aux).abs().max()) <= 1e-4 * float(aux.abs().max())


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_gradients_match_port_f32(name):
    """The loss and every parameter's gradient of one f32 train-mode pass."""
    cfg, ref, state, task, x = _setup(name)
    s = cfg["image_size"]
    y = torch.randint(0, max(cfg["num_classes"], 2), (BATCH, s, s),
                      generator=torch.Generator().manual_seed(1))
    task.model.train()
    out = task.forward({}, x)
    loss = task.compute_loss(out, y)
    loss.backward()
    P = {k: v.float().clone().requires_grad_(v.is_floating_point()) for k, v in state.items()}
    o, aux = ref.forward(Plain(), P, cfg, x, True, ckpt=True)
    loss_fn = loss_of(cfg)
    rl = loss_fn(o, y, cfg["num_classes"])
    if aux is not None:
        rl = rl + cfg["aux_loss_weight"] * loss_fn(aux, y, cfg["num_classes"])
    rl.backward()
    assert float(loss.detach()) == pytest.approx(float(rl.detach()), rel=1e-5)
    grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p),
                 P[n].grad if P[n].grad is not None else torch.zeros_like(p))
             for n, p in task.model.named_parameters()}
    # the tiny network's gradients are ill conditioned (small BatchNorm
    # groups, leaves reached through cancelling sums): the f32 reference is
    # itself 2e-4 off an f64 one over all leaves, so the whole gradient is
    # held to 1e-2 and each leaf's direction to a cosine of 0.99
    diff = sum(float((g - r).double().square().sum()) for g, r in grads.values())
    norm = sum(float(r.double().square().sum()) for _, r in grads.values())
    assert (diff / norm) ** 0.5 <= 1e-2
    median = float(torch.tensor([float(r.norm()) for _, r in grads.values()]).median())
    for n, (g, r) in grads.items():
        if float(r.norm()) >= 1e-3 * median:
            cos = float((g.double() * r.double()).sum() / (g.double().norm() * r.double().norm()))
            assert cos >= 0.99, (n, cos)


def test_control_rounds_to_fp8():
    x = torch.linspace(-3, 3, 101)
    q = FP8().q(x)
    assert not torch.equal(q, x)
    assert float((q - x).abs().max()) <= 3 / 448 * 16
    assert torch.equal(Plain().q(x), x)
