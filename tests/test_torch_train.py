"""The port's train step against the JAX package's ``make_train_step``.

Tiny DOFA + UperNet (``_torch_tiny``), the same weights on both sides
(carried by the JAX package's converter), the same uint8 batches, f32 on
both sides, ``augment=None``, DropPath and FCN dropout at rate 0 (random
streams cannot match across frameworks). The JAX step's gradients are
read from a pass-through transform chained in front of its optimizer, the
port's from post-accumulate hooks on its parameters: both before clipping. JAX
trees come back to port names through ``from_jax_params``.

Tolerances, f32 on both sides with summation orders that differ through
five blocks and the decoder:
- losses: 1e-5 absolute;
- gradients and Adam moments: per tensor, ``max|d| <= 2e-3 * max|want|
  + 1e-7`` (observed about 1e-3; the absolute term covers gradients that
  are mathematically zero, such as conv biases in front of BatchNorm,
  which both sides give as rounding noise near 1e-9). Under Adam they are
  compared after the first step only: the sign flips below move the
  second step's inputs apart by up to ``2 * lr``;
- BN running statistics: 1e-5 absolute;
- SGD parameters: 1e-6 absolute (exact update parity);
- Adam parameters: Adam's first update is ``lr * g / (|g| + eps)``, about
  ``+-lr`` whatever ``|g|``, so where ``g`` is rounding noise the two
  frameworks move an element in opposite directions. Every element must
  lie within ``4 * lr`` (two steps, each flip at most ``2 * lr``) and all
  but 1 % of them within ``0.1 * lr`` (observed 0.47 %: whole tensors,
  such as the conv biases in front of BatchNorm, have noise gradients).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_tiny import WAVES, jax_variables, register_tiny, tiny_model

import geo_deep_learning_tpu.models.segmentation.dofa as jsegdofa
from geo_deep_learning_tpu.core.precision import PrecisionPolicy as JaxPrecision
from geo_deep_learning_tpu.core.train_state import TrainState as JaxState
from geo_deep_learning_tpu.models.encoders.dofa import DOFAv2 as JaxDOFAv2
from geo_deep_learning_tpu.models.heads.fcn import FCNHead as JaxFCNHead
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.training import optim as joptim
from geo_deep_learning_tpu.training import steps as jsteps
from geo_deep_learning_tpu.training.task import SegmentationTask as JaxTask
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.models.convert import from_jax_params
from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout
from geo_deep_learning_tpu_torch.ops.cuda import layernorm as tln
from geo_deep_learning_tpu_torch.ops.cuda import mha as tmha
from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
from geo_deep_learning_tpu_torch.training import optim as toptim
from geo_deep_learning_tpu_torch.training import steps as tsteps
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

LR = 1e-3
CLIP = 0.05  # below the tiny model's gradient norm (~0.9), so the clip acts


def _batches(n=2):
    rng = np.random.default_rng(0)
    return [{
        "image": rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8),
        "mask": rng.integers(0, 2, (2, 64, 64)).astype(np.int32),
        "mean": np.tile(np.asarray([0.405, 0.432, 0.397], np.float32), (2, 1)),
        "std": np.tile(np.asarray([0.165, 0.161, 0.174], np.float32), (2, 1)),
    } for _ in range(n)]


def _torch_batch(b):
    out = {k: torch.from_numpy(v) for k, v in b.items()}
    out["mask"] = out["mask"].long()
    return out


def _capture():
    """Pass-through transform that keeps the last gradients in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}),
    )


def _find(state, attr):
    if isinstance(state, dict) and attr in state:
        return state[attr]
    if hasattr(state, attr):
        return getattr(state, attr)
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find(s, attr)
            if found is not None:
                return found
    return None


@pytest.fixture
def setup(monkeypatch):
    register_tiny(monkeypatch)
    monkeypatch.setattr(jsegdofa, "DOFAv2", functools.partial(JaxDOFAv2, drop_path_rate=0.0))
    monkeypatch.setattr(jsegdofa, "FCNHead", functools.partial(JaxFCNHead, dropout_ratio=0.0))
    model = tiny_model(1)
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    table = model.encoder.pos_embed.numpy()
    variables = jax_variables(model)
    jmodel = jsegdofa.DOFASegmentation(encoder_name="tiny", num_classes=1, decoder_channels=32,
                                       pos_embed_table=table)
    jtask = JaxTask(jmodel, JaxDice(mode="binary"), num_classes=1, default_wavelengths=list(WAVES))
    task = SegmentationTask(model, DiceLoss(mode="binary"), num_classes=1,
                            default_wavelengths=list(WAVES))
    calls = {"ln": 0, "ln_res": 0, "attn": 0}

    def counted(fn, key):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(tln, "layernorm_bwd", counted(tln.layernorm_bwd, "ln"))
    monkeypatch.setattr(tln, "layernorm_residual_bwd",
                        counted(tln.layernorm_residual_bwd, "ln_res"))
    # the tiny model's heads (2 x 32) take the head-major pair (K8/K9), as
    # the JAX package's do on a TPU; count either attention backward
    for name in ("attention_bwd_packed", "attention_hm_bwd"):
        monkeypatch.setattr(tmha, name, counted(getattr(tmha, name), "attn"))
    return task, jtask, variables, table, calls


def _run(setup, optimizer: str, freeze: list[str] | None):
    """Two steps on each side -> (port state, JAX state, per step
    (port loss, JAX loss, port grads, JAX grads and BN statistics, port
    optimizer state and BN statistics under "bn", JAX Adam moments), all
    by port name). The JAX step donates its state,
    so what is kept of it is copied out at once."""
    task, jtask, variables, table, _ = setup
    kw = {"momentum": 0.9} if optimizer == "sgd" else {}
    tx = optax.chain(
        _capture(),
        joptim.build_optimizer(variables["params"], optimizer, lr=LR, grad_clip=CLIP,
                               freeze_patterns=freeze, **kw),
    )
    jstate = JaxState.create(apply_fn=jtask.model.apply, params=variables["params"], tx=tx,
                             batch_stats=variables["batch_stats"])
    jstep = jsteps.make_train_step(jtask, JaxPrecision.create("32-true"), augment=None,
                                   freeze_patterns=freeze)
    model = task.model
    toptim.freeze(model, freeze)
    opt = toptim.build_optimizer([p for p in model.parameters() if p.requires_grad],
                                 optimizer, LR, **kw)
    grads = {}
    for n, p in model.named_parameters():
        if p.requires_grad:
            p.register_post_accumulate_grad_hook(
                lambda t, n=n: grads.__setitem__(n, t.grad.clone()))
    state = TrainState.create(model, opt, seed=0)
    step = tsteps.make_train_step(task, PrecisionPolicy.create("32-true"), augment=None,
                                  grad_clip=CLIP)
    steps = []
    for b in _batches():
        jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        loss = float(step(state, _torch_batch(b))["loss"])
        jgrads = _jax_state_dict(jstate, _find(jstate.opt_state, "g"), table)
        moments = {n: {k: v.clone() for k, v in opt.state[p].items()}
                   for n, p in model.named_parameters() if p in opt.state}
        moments["bn"] = {k: v.clone() for k, v in model.state_dict().items() if "running" in k}
        jmoments = {k: _jax_state_dict(jstate, _find(jstate.opt_state, k), table)
                    for k in ("mu", "nu") if _find(jstate.opt_state, k) is not None}
        steps.append((loss, float(jmetrics["loss"]), dict(grads), jgrads, moments, jmoments))
    return state, jstate, steps


def _jax_state_dict(jstate, tree, table):
    return from_jax_params(jax.tree.map(np.asarray, tree),
                           jax.tree.map(np.asarray, jstate.batch_stats), pos_embed=table)


def _assert_close_per_tensor(got: torch.Tensor, want: torch.Tensor, name: str):
    want = want.numpy()
    err = np.abs(got.numpy() - want).max()
    assert err <= 2e-3 * np.abs(want).max() + 1e-7, (name, err, np.abs(want).max())


def _assert_bn_stats(got: dict, want: dict):
    stats = [k for k in want if "running" in k]
    assert stats and len(stats) == len(got)
    for k in stats:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(), atol=1e-5, rtol=0, err_msg=k)


def test_train_step_matches_jax(setup):
    """Adam + clip, whole model: the loss of both steps; every gradient,
    Adam's moments and the BN statistics after the first; the parameters
    after the second."""
    task, _, _, table, calls = setup
    state, jstate, steps = _run(setup, "adam", None)
    # per train step: K5 at the 4 blocks that start without a pending
    # branch, K6 at the other norm1 and every norm2, K7 once per block
    assert calls == {"ln": 8, "ln_res": 12, "attn": 10}
    model = task.model
    for loss, jloss, *_ in steps:
        assert abs(loss - jloss) <= 1e-5
    _, _, grads, jgrads, moments, jmoments = steps[0]
    assert len(grads) == len(list(model.parameters())) - 2  # encoder.norm is unused
    for n, g in grads.items():
        _assert_close_per_tensor(g, jgrads[n], n)
    _assert_bn_stats(moments.pop("bn"), jgrads)
    assert len(moments) == len(grads)
    for n, m in moments.items():
        _assert_close_per_tensor(m["exp_avg"], jmoments["mu"][n], n)
        _assert_close_per_tensor(m["exp_avg_sq"], jmoments["nu"][n], n)
    want = _jax_state_dict(jstate, jstate.params, table)
    diffs = torch.cat([(p.detach() - want[n]).abs().flatten()
                       for n, p in model.named_parameters()])
    assert diffs.max() <= 4 * LR
    assert (diffs > 0.1 * LR).float().mean() <= 1e-2


def test_frozen_encoder_step_matches_jax(setup):
    """SGD + clip with ``freeze_layers=["encoder"]``: the encoder does not
    move on either side, runs no backward (no K5-K7 call, no gradient, no
    optimizer slot), the rest updates exactly as the JAX package updates
    it, and BN statistics still update."""
    task, _, _, table, calls = setup
    before = {n: t.clone() for n, t in task.model.state_dict().items()}
    state, jstate, steps = _run(setup, "sgd", ["encoder"])
    assert calls == {"ln": 0, "ln_res": 0, "attn": 0}
    model = task.model
    want = _jax_state_dict(jstate, jstate.params, table)
    for loss, jloss, grads, jgrads, port_state, _ in steps:
        assert abs(loss - jloss) <= 1e-5
        assert grads and not any(n.startswith("encoder.") for n in grads)
        for n in grads:
            _assert_close_per_tensor(grads[n], jgrads[n], n)
        _assert_bn_stats(port_state["bn"], jgrads)
    for n, p in model.named_parameters():
        if n.startswith("encoder."):
            assert torch.equal(p.detach(), before[n]), n
            assert torch.equal(want[n], before[n]), n
            assert p.grad is None and p not in state.optimizer.state, n
        else:
            np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), atol=1e-6, rtol=0,
                                       err_msg=n)
    moved = [k for k in want if "running_mean" in k]
    assert all(not torch.equal(model.state_dict()[k], before[k]) for k in moved)
