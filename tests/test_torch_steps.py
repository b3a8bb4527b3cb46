"""The port's eval / predict steps against the JAX package's
``make_eval_step`` / ``make_predict_step`` on one uint8 batch.

Same weights (carried by the JAX package's converter), same uint8 NHWC
batch with per-sample stats, f32 on both sides. The batch holds 2 samples
of which ``valid_count`` = 1 is real, so the padded sample must drop out
of the loss and the confusion matrix. Predictions are compared wherever
the decision has a margin above the two forwards' rounding difference.
"""

import jax.numpy as jnp
import optax
import numpy as np
import pytest
import torch
from _torch_tiny import WAVES, jax_variables, register_tiny, tiny_model

from geo_deep_learning_tpu.core.precision import PrecisionPolicy as JaxPrecision
from geo_deep_learning_tpu.core.train_state import TrainState
from geo_deep_learning_tpu.models.segmentation.dofa import DOFASegmentation as JaxDOFASeg
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.training import steps as jsteps
from geo_deep_learning_tpu.training.task import SegmentationTask as JaxTask
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
from geo_deep_learning_tpu_torch.training import steps as tsteps
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

MARGIN = 1e-4  # logit margin below which the two forwards may decide apart


def _batch(rng):
    return {
        "image": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
        "mask": rng.integers(0, 2, (2, 64, 64)).astype(np.int32),
        "mean": np.tile(np.asarray([0.405, 0.432, 0.397], np.float32), (2, 1)),
        "std": np.tile(np.asarray([0.165, 0.161, 0.174], np.float32), (2, 1)),
        "valid_count": 1,
    }


@pytest.fixture(params=[1, 3], ids=["binary", "multiclass"])
def setup(request, monkeypatch):
    register_tiny(monkeypatch)
    num_classes = request.param
    mode = "binary" if num_classes == 1 else "multiclass"
    model = tiny_model(num_classes)
    table = model.encoder.pos_embed.numpy()
    port = SegmentationTask(model, DiceLoss(mode=mode), num_classes=num_classes,
                            default_wavelengths=list(WAVES))
    jmodel = JaxDOFASeg(encoder_name="tiny", num_classes=num_classes, decoder_channels=32,
                        pos_embed_table=table)
    jtask = JaxTask(jmodel, JaxDice(mode=mode), num_classes=num_classes,
                    default_wavelengths=list(WAVES))
    v = jax_variables(model)
    state = TrainState.create(apply_fn=jmodel.apply, params=v["params"], tx=optax.identity(),
                              batch_stats=v["batch_stats"])
    batch = _batch(np.random.default_rng(num_classes))
    tbatch = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v) for k, v in batch.items()}
    tbatch["mask"] = tbatch["mask"].long()
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return port, jtask, state, tbatch, jbatch


def _margin(logits: np.ndarray) -> np.ndarray:
    """Per-pixel decision margin of NHWC logits (sigmoid or argmax rule)."""
    if logits.shape[-1] == 1:
        return np.abs(logits[..., 0])
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return top2[..., 1] - top2[..., 0]


def test_eval_step_matches_jax(setup):
    port, jtask, state, tbatch, jbatch = setup
    got = tsteps.make_eval_step(port, PrecisionPolicy.create("32-true"))(tbatch)
    want = jsteps.make_eval_step(jtask, JaxPrecision.create("32-true"))(state, jbatch)
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]), atol=1e-5)
    with torch.no_grad():
        image = tsteps.prepare_image(tbatch, PrecisionPolicy.create("32-true"))
        logits = port.forward(tbatch, image.permute(0, 3, 1, 2)).out.permute(0, 2, 3, 1).numpy()
    sure = _margin(logits) > MARGIN
    assert sure.mean() > 0.99
    preds, jpreds = got["preds"].numpy(), np.asarray(want["preds"])
    np.testing.assert_array_equal(preds[sure], jpreds[sure])
    # confusion: the real sample only, equal up to the undecided pixels
    cm, jcm = got["confusion"].numpy(), np.asarray(want["confusion"])
    assert cm.sum() == 64 * 64
    assert np.abs(cm - jcm).sum() <= 2 * (~sure[0]).sum()


def test_predict_step_matches_jax(setup):
    port, jtask, state, tbatch, jbatch = setup
    got = tsteps.make_predict_step(port, PrecisionPolicy.create("32-true"))(tbatch)
    want = jsteps.make_predict_step(jtask, JaxPrecision.create("32-true"))(state, jbatch)
    np.testing.assert_allclose(
        got["probs"].permute(0, 2, 3, 1).numpy(), np.asarray(want["probs"]), atol=1e-5
    )
    agree = got["preds"].numpy() == np.asarray(want["preds"])
    assert agree.mean() > 0.99


def test_bf16_mixed_step_runs_on_cpu(setup):
    port, _, _, tbatch, _ = setup
    got = tsteps.make_eval_step(port, PrecisionPolicy.create("bf16-mixed"))(tbatch)
    assert torch.isfinite(got["loss"])
    assert got["preds"].shape == (2, 64, 64)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted", "sample_weights"])
def test_confusion_matrix_ignores_labels_outside_the_classes(weighted):
    """Targets 255, C and -1 count nowhere, as in the JAX package's one-hot
    confusion matrix; every other pixel counts exactly."""
    from geo_deep_learning_tpu.ops.metrics import confusion_matrix as jax_confusion
    from geo_deep_learning_tpu_torch.ops.metrics import confusion_matrix

    c = 3
    rng = np.random.default_rng(7)
    preds = rng.integers(0, c, (2, 8, 8)).astype(np.int64)
    targets = rng.integers(0, c, (2, 8, 8)).astype(np.int64)
    flat = targets.reshape(-1)
    flat[rng.choice(flat.size, 24, replace=False)] = np.repeat([255, c, -1], 8)
    weights = np.asarray([1.0, 0.0], np.float32) if weighted else None
    got = confusion_matrix(torch.from_numpy(preds), torch.from_numpy(targets), c,
                           None if weights is None else torch.from_numpy(weights))
    want = jax_confusion(jnp.asarray(preds), jnp.asarray(targets), c,
                         None if weights is None else jnp.asarray(weights))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    n_valid = 64 - int((targets[0] >= c).sum() + (targets[0] < 0).sum())
    if not weighted:
        n_valid = 128 - 24
    assert got.sum() == n_valid
