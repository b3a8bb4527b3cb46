"""The port's training pieces beside the model, against the JAX package:
train-mode random layers, BatchNorm statistics, augmentation transforms at
injected parameters, LR schedules and the plateau controller, and the
training loader's shuffle order.

Random streams cannot match across frameworks, so dropout and DropPath
are checked on their distribution and masks, and the augmentations on
parameters handed to both packages. Tolerances are stated per test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from geo_deep_learning_tpu.data.loader import DataLoader as JaxLoader
from geo_deep_learning_tpu.ops import augment as jaug
from geo_deep_learning_tpu.training import optim as joptim
from geo_deep_learning_tpu_torch.data.loader import DataLoader
from geo_deep_learning_tpu_torch.models.heads.fcn import FCNHead
from geo_deep_learning_tpu_torch.models.layers import BatchNorm2d, DropPath, Dropout, set_generator
from geo_deep_learning_tpu_torch.ops import augment as taug
from geo_deep_learning_tpu_torch.training import optim as toptim


def test_fcn_dropout_drops_elements_not_channels():
    """The JAX package's FCN head drops single elements (flax ``Dropout``
    over NHWC, no broadcast dims); torch's ``Dropout2d`` would zero whole
    channels. At rate 0.5 over 2 x 64 channels of 16 x 16, every channel
    keeps some elements and loses some, and about half of all survive,
    scaled by 2."""
    head = FCNHead(8, channels=64, num_convs=1, num_classes=1, dropout_ratio=0.5).train()
    set_generator(head, torch.Generator().manual_seed(0))
    x = torch.ones((2, 64, 16, 16))
    y = head.dropout(x)
    kept = (y != 0).float()
    per_channel = kept.mean(dim=(2, 3))
    assert (per_channel > 0).all() and (per_channel < 1).all()
    assert abs(kept.mean().item() - 0.5) < 0.02  # 8192 draws: 4.4 standard deviations
    assert torch.equal(y[y != 0], torch.full_like(y[y != 0], 2.0))
    assert torch.equal(head.eval().dropout(x), x)


def test_drop_path_drops_whole_samples():
    """timm/JAX semantics: one Bernoulli(keep) per sample, kept samples
    scaled by 1 / keep; identity in eval and at rate 0."""
    dp = DropPath(0.5).train()
    dp.generator = torch.Generator().manual_seed(1)
    x = torch.ones((4096, 3, 5))
    y = dp(x)
    per_sample = y.flatten(1)
    assert ((per_sample == 0).all(1) | (per_sample == 2.0).all(1)).all()
    assert abs((per_sample[:, 0] != 0).float().mean().item() - 0.5) < 0.03  # 3.8 sd
    assert torch.equal(dp.eval()(x), x)
    assert torch.equal(DropPath(0.0).train()(x), x)


def test_random_layers_refuse_the_global_rng():
    with pytest.raises(RuntimeError, match="generator"):
        Dropout(0.1).train()(torch.ones(3))


def test_batchnorm_statistics_match_flax():
    """Train mode: output and running statistics as flax
    ``BatchNorm(momentum=0.9)`` gives them, i.e. the running variance
    takes the biased batch variance (torch's own would take the unbiased
    one, 0.8 % larger at these 2 x 8 x 8 values per channel). f32, 1e-5."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((2, 8, 8, 5)) * 1.5 + 0.3).astype(np.float32)
    mean0 = rng.standard_normal(5).astype(np.float32) * 0.1
    var0 = rng.uniform(0.5, 1.5, 5).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = {"params": {"scale": jnp.ones(5), "bias": jnp.zeros(5)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    want, updates = bn.apply(variables, jnp.asarray(x), mutable=["batch_stats"])
    port = BatchNorm2d(5, eps=1e-5, momentum=0.1).train()
    with torch.no_grad():
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    got = port(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).detach().numpy(), np.asarray(want),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(updates["batch_stats"]["mean"]), atol=1e-6, rtol=0)
    np.testing.assert_allclose(port.running_var.numpy(),
                               np.asarray(updates["batch_stats"]["var"]), atol=1e-6, rtol=0)


# ---------------------------------------------------------------------------
# augmentation at injected parameters: exact for flips and rotations; the
# resampled crops agree to 1e-5 (the same f32 tent weights, summed in
# another order) and their masks exactly


def _aug_inputs(seed=0):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((3, 24, 24, 3)).astype(np.float32)
    mask = rng.integers(0, 5, (3, 24, 24)).astype(np.int32)
    return img, mask


@pytest.mark.parametrize("name", ["hflip", "vflip"])
def test_flips_match_jax(name):
    img, mask = _aug_inputs()
    got = getattr(taug, name)(torch.from_numpy(img), torch.from_numpy(mask))
    want = getattr(jaug, name)(jnp.asarray(img), jnp.asarray(mask))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_rot90_matches_jax():
    img, mask = _aug_inputs(1)
    k = np.asarray([1, 2, 3], np.int32)
    got = taug.rot90_batch(torch.from_numpy(img), torch.from_numpy(mask), torch.from_numpy(k))
    want = jaug._rot90_batch(jnp.asarray(img), jnp.asarray(mask), jnp.asarray(k))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("scale", [(1.0, 2.0), (0.5, 1.0)], ids=["zoom_in", "zoom_out"])
def test_resized_crop_matches_jax(scale):
    img, mask = _aug_inputs(2)
    u = np.random.default_rng(3).uniform(size=(4, 3)).astype(np.float32)
    box = taug.crop_box(torch.from_numpy(u), 24, 24, scale, (3 / 4, 4 / 3))
    got = taug.grid_sample_crop(torch.from_numpy(img), torch.from_numpy(mask), *box)
    want = jaug._grid_sample_crop(jnp.asarray(img), jnp.asarray(mask),
                                  *(jnp.asarray(t.numpy()) for t in box))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=1e-5, rtol=0)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_crop_box_follows_the_jax_formula():
    """The JAX package draws the same four uniforms per sample inside
    ``random_resized_crop``; fed identical draws the box must agree (1e-4
    pixels: f32 log/exp/sqrt)."""
    u = np.random.default_rng(4).uniform(size=(4, 5)).astype(np.float32)
    for scale in ((1.0, 2.0), (0.5, 1.0)):
        y0, x0, ch, cw = (t.numpy() for t in taug.crop_box(torch.from_numpy(u), 32, 40, scale,
                                                           (3 / 4, 4 / 3)))
        area = (scale[0] + (scale[1] - scale[0]) * u[0]) * 32 * 40
        aspect = np.exp(np.log(3 / 4) + (np.log(4 / 3) - np.log(3 / 4)) * u[1])
        np.testing.assert_allclose(cw, np.sqrt(area * aspect), rtol=1e-5)
        np.testing.assert_allclose(ch, np.sqrt(area / aspect), rtol=1e-5)
        want_y = np.where(32 - ch > 0, u[2] * np.maximum(32 - ch, 0), (32 - ch) / 2)
        want_x = np.where(40 - cw > 0, u[3] * np.maximum(40 - cw, 0), (40 - cw) / 2)
        np.testing.assert_allclose(y0, want_y, atol=1e-4)
        np.testing.assert_allclose(x0, want_x, atol=1e-4)


def test_apply_augmentations_is_seeded_and_shape_preserving():
    img, mask = _aug_inputs(5)
    outs = []
    for _ in range(2):
        g = torch.Generator().manual_seed(7)
        outs.append([taug.apply_augmentations(g, torch.from_numpy(img), torch.from_numpy(mask))
                     for _ in range(6)])
    for (a_img, a_mask), (b_img, b_mask) in zip(*outs):
        assert a_img.shape == img.shape and a_mask.shape == mask.shape
        assert torch.equal(a_img, b_img) and torch.equal(a_mask, b_mask)


# ---------------------------------------------------------------------------
# schedules (f32 on the JAX side: rtol 1e-5) and the plateau controller

STEPS = np.arange(0, 60)


def _jax_values(schedule):
    return np.asarray([float(schedule(jnp.asarray(s))) for s in STEPS])


@pytest.mark.parametrize("args", [(5, 40, 1e-5, 1e-6, 1e-3), (1, 10, 0.0, 1e-5, 1e-2),
                                  (3, 20, 0.0, 0.0, 1e-3)])
def test_warmup_cosine_matches_jax(args):
    got = [toptim.linear_warmup_cosine_annealing(*args)(int(s)) for s in STEPS]
    np.testing.assert_allclose(got, _jax_values(joptim.linear_warmup_cosine_annealing(*args)),
                               rtol=1e-5, atol=1e-12)


@pytest.mark.parametrize("kind", ["cosine", "linear", "none"])
def test_linear_warmup_decay_matches_jax(kind):
    kw = {"cosine": kind == "cosine", "linear": kind == "linear"}
    got = [toptim.linear_warmup_decay(7, 50, 3e-4, **kw)(int(s)) for s in STEPS]
    np.testing.assert_allclose(got, _jax_values(joptim.linear_warmup_decay(7, 50, 3e-4, **kw)),
                               rtol=1e-5, atol=1e-12)


def test_one_cycle_matches_jax():
    got = [toptim.one_cycle(1e-2, 50, pct_start=0.25)(int(s)) for s in STEPS]
    np.testing.assert_allclose(got, _jax_values(joptim.one_cycle(1e-2, 50, pct_start=0.25)),
                               rtol=1e-5, atol=1e-12)


def test_plateau_controller_matches_jax():
    losses = [1.0, 0.9, 0.95, 0.96, 0.97, 0.9, 0.99, 1.0, 1.0, 0.5, 0.6, 0.7, 0.8, 0.9]
    kw = dict(factor=0.5, patience=1, cooldown=1, min_lr=1e-5, base_lr=1e-3)
    ours, theirs = toptim.PlateauController(**kw), joptim.PlateauController(**kw)
    for v in losses:
        assert ours.update(v) == theirs.update(v)
        assert ours.lr == theirs.lr
    restored = toptim.PlateauController(**kw)
    restored.load_state_dict(ours.state_dict())
    assert restored.update(0.95) == ours.update(0.95)


def test_clip_by_global_norm_uses_the_optax_formula():
    """No ``+1e-6``: above the limit the norm becomes exactly ``max_norm``
    (f32, 1e-6 relative); below it the gradients are untouched."""
    import optax

    rng = np.random.default_rng(6)
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,))]
    for max_norm in (0.5, 100.0):
        params = [torch.zeros(g.shape, requires_grad=True) for g in grads]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        norm = toptim.clip_by_global_norm_(params, max_norm)
        want, _ = optax.clip_by_global_norm(max_norm).update([jnp.asarray(g) for g in grads], None)
        for p, w in zip(params, want):
            np.testing.assert_allclose(p.grad.numpy(), np.asarray(w), rtol=1e-6, atol=0)
        assert abs(float(norm) - float(optax.global_norm([jnp.asarray(g) for g in grads]))) < 1e-5


def test_train_loader_order_matches_jax():
    """Shuffled, drop_last: the same sample order as the JAX loader for two
    epochs (both use ``np.random.default_rng(seed + epoch)``)."""

    class Items:
        def __len__(self):
            return 21

        def __getitem__(self, i):
            return {"i": np.asarray(i)}

    ours = DataLoader(Items(), batch_size=4, shuffle=True, drop_last=True, seed=42)
    theirs = JaxLoader(Items(), batch_size=4, shuffle=True, drop_last=True, num_workers=1, seed=42)
    assert len(ours) == len(theirs) == 5
    for _ in range(2):
        got = [b["i"].tolist() for b in ours]
        want = [b["i"].tolist() for b in theirs]
        assert got == want and len(got) == 5
    assert got != [list(range(i, i + 4)) for i in range(0, 20, 4)]
