"""The port's losses against the JAX package's, on the CPU.

Every configured loss on binary and 5-class logits, with and without
``sample_weights`` (the second sample weighted 0, as a padded tail sample
is), ``ignore_index`` (255, on a stripe of pixels) and class weights where
the loss takes them: value and logit gradient within 1e-5 relative (f32
on both sides). Every loss class path the JAX package's config aliases
resolves in the port to the class of the same name; Dice keeps its
earlier behaviour bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from geo_deep_learning_tpu.cli import config as jconfig
from geo_deep_learning_tpu.ops import losses as jlosses
from geo_deep_learning_tpu_torch.cli.config import import_class, instantiate
from geo_deep_learning_tpu_torch.ops import losses as tlosses

WEIGHTS = [1.0, 0.0]
# (configured class, init_args, binary?, targets carry ignore_index 255?)
CASES = {
    "dice_binary": ("DiceLoss", dict(mode="binary"), True, False),
    "dice_multiclass": ("DiceLoss", dict(mode="multiclass"), False, False),
    "dice_ignore_log_smooth": ("DiceLoss", dict(mode="multiclass", ignore_index=255,
                                                log_loss=True, smooth=0.5), False, True),
    "jaccard_binary": ("JaccardLoss", dict(mode="binary"), True, False),
    "jaccard_multiclass": ("JaccardLoss", dict(mode="multiclass", smooth=0.1), False, False),
    "soft_ce": ("SoftCrossEntropyLoss", dict(smooth_factor=0.1), False, False),
    "soft_ce_ignore": ("SoftCrossEntropyLoss", dict(smooth_factor=0.1, ignore_index=255),
                       False, True),
    "ce": ("CrossEntropyLoss", dict(), False, False),
    "ce_weights_ignore": ("CrossEntropyLoss", dict(ignore_index=255,
                                                   class_weights=[0.5, 1.0, 2.0, 1.5, 0.25]),
                          False, True),
    "bce": ("BinaryCrossEntropyLoss", dict(), True, False),
    "focal_binary": ("FocalLoss", dict(mode="binary", alpha=0.25), True, False),
    "focal_multiclass": ("FocalLoss", dict(mode="multiclass", alpha=0.5, gamma=1.5), False, False),
}


def _data(binary: bool, ignore: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    c = 1 if binary else 5
    logits = (2.0 * rng.standard_normal((2, 8, 8, c))).astype(np.float32)  # NHWC
    targets = rng.integers(0, 2 if binary else c, (2, 8, 8)).astype(np.int32)
    if ignore:
        targets[:, 2] = 255
    return logits, targets


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weights"])
@pytest.mark.parametrize("case", list(CASES))
def test_loss_matches_jax(case, weighted):
    name, kwargs, binary, ignore = CASES[case]
    logits, targets = _data(binary, ignore)
    sw = WEIGHTS if weighted else None
    jloss = getattr(jlosses, name)(**kwargs)
    tloss = getattr(tlosses, name)(**kwargs)

    def jfn(x):
        return jloss(x, jnp.asarray(targets), None if sw is None else jnp.asarray(sw))

    want, want_grad = jax.value_and_grad(jfn)(jnp.asarray(logits))
    x = torch.from_numpy(logits).permute(0, 3, 1, 2).requires_grad_()
    got = tloss(x, torch.from_numpy(targets).long(), None if sw is None else torch.tensor(sw))
    got.backward()
    assert got.dtype == torch.float32 and got.ndim == 0
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5, atol=1e-7)
    grad, want_grad = x.grad.permute(0, 2, 3, 1).numpy(), np.asarray(want_grad)
    np.testing.assert_allclose(grad, want_grad, rtol=0, atol=1e-5 * np.abs(want_grad).max())
    if weighted:
        assert not grad[1].any()  # a zero-weighted sample gets no gradient


def test_every_jax_loss_alias_resolves():
    aliases = {k: v for k, v in jconfig.CLASS_PATH_ALIASES.items() if ".losses." in v}
    names = {v.rpartition(".")[2] for v in aliases.values()}
    assert len(aliases) == 6 and len(names) == 6
    for path in [*aliases, *(f"geo_deep_learning_tpu.ops.losses.{n}" for n in names)]:
        jname = jconfig.CLASS_PATH_ALIASES.get(path, path).rpartition(".")[2]
        cls = import_class(path)
        assert cls is getattr(tlosses, jname), path
    loss = instantiate({"class_path": "torch.nn.CrossEntropyLoss",
                        "init_args": {"ignore_index": 255}})
    assert isinstance(loss, tlosses.CrossEntropyLoss) and loss.kwargs == {"ignore_index": 255}


def _dice_before(logits, targets, mode, smooth=0.0, eps=1e-7, log_loss=False,
                 ignore_index=None, sample_weights=None):
    """``dice_loss`` as the port had it before the other losses came."""
    logits = logits.float()
    b, c = logits.shape[:2]
    probs = torch.sigmoid(logits) if mode == "binary" else torch.exp(F.log_softmax(logits, dim=1))
    probs = probs.reshape(b, c, -1)
    t = targets.reshape(b, 1, -1)
    if mode == "binary":
        onehot = t.float()
    else:
        onehot = F.one_hot(t[:, 0].clamp(0, c - 1), c).permute(0, 2, 1).float()
        onehot = onehot * (t >= 0) * (t < c)
    if ignore_index is not None:
        valid = (t != ignore_index).float()
        probs = probs * valid
        onehot = onehot * valid
    if sample_weights is not None:
        w = sample_weights.float().reshape(b, 1, 1)
        probs = probs * w
        onehot = onehot * w
    intersection = (probs * onehot).sum(dim=(0, 2))
    cardinality = (probs + onehot).sum(dim=(0, 2))
    dice = (2.0 * intersection + smooth) / torch.clamp(cardinality + smooth, min=eps)
    loss = -torch.log(torch.clamp(dice, min=eps)) if log_loss else 1.0 - dice
    return loss.mean()


@pytest.mark.parametrize("case", ["dice_binary", "dice_multiclass", "dice_ignore_log_smooth"])
def test_dice_is_unchanged_bit_for_bit(case):
    _, kwargs, binary, ignore = CASES[case]
    logits, targets = _data(binary, ignore, seed=5)
    x = torch.from_numpy(logits).permute(0, 3, 1, 2).to(torch.bfloat16)
    t = torch.from_numpy(targets).long()
    for sw in (None, torch.tensor(WEIGHTS)):
        assert torch.equal(tlosses.DiceLoss(**kwargs)(x, t, sw),
                           _dice_before(x, t, sample_weights=sw, **kwargs))
