"""The port's UNet++ against the JAX package's, on the CPU.

Shallow ResNets (one block a stage, the published widths 64-512: basic,
bottleneck and grouped ResNeXt blocks) registered in both packages'
``resnet_configs``, the narrow decoder ``(16, 8, 8, 8, 8)`` and 64^2 inputs.
JAX variables, with every BatchNorm scale, bias and statistic drawn away
from its identity init, come to the port through
``from_jax_unetpp_params``. The JAX model runs
with its defaults (packed tail, factored up2, merged skips) and with
``wpacked_column=True``; the port has one plain form of the same function.
Inputs are drawn with numpy.

Tolerances, f32 on both sides with summation orders that differ: modules
and whole models within 1e-4 of the largest output magnitude, BatchNorm
running statistics within 1e-5. The train step: the loss to 1e-5; each
gradient of the port's f32 step within 1e-4 of the largest of its f64 run
(it lands within 1.7e-5), and within the JAX f32 step's own distance from
that f64 run plus the same 1e-4. The JAX step is the looser of the two: its
gradients land up to 5.4 % (relative to the largest) from f64, on the
first conv of node x_2_3, at these weights (flax's train-mode BatchNorm
takes the variance as E[x^2] - E[x]^2 in f32; the port's, as PyTorch's
does, from the deviations). The test prints both distances.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_tiny import TINY_DECODER, register_tiny_resnets

from geo_deep_learning_tpu.core.precision import PrecisionPolicy as JaxPrecision
from geo_deep_learning_tpu.core.train_state import TrainState as JaxState
from geo_deep_learning_tpu.models import convert as jconvert
from geo_deep_learning_tpu.models.decoders.unetpp import UnetPlusPlusDecoder as JaxDecoder
from geo_deep_learning_tpu.models.encoders.resnet import ResNetEncoder as JaxEncoder
from geo_deep_learning_tpu.models.segmentation.unetpp import UnetPlusPlus as JaxUnetPlusPlus
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.training import optim as joptim
from geo_deep_learning_tpu.training import steps as jsteps
from geo_deep_learning_tpu.training.task import SegmentationTask as JaxTask
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.models.convert import from_jax_unetpp_params
from geo_deep_learning_tpu_torch.models.decoders.unetpp import UnetPlusPlusDecoder
from geo_deep_learning_tpu_torch.models.encoders.resnet import ResNetEncoder
from geo_deep_learning_tpu_torch.models.segmentation.unetpp import UnetPlusPlus
from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
from geo_deep_learning_tpu_torch.training import optim as toptim
from geo_deep_learning_tpu_torch.training import steps as tsteps
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

SIZE = 64
WIDTHS = (64, 64, 128, 256, 512)  # the basic-block pyramid
FORMS = {"default": {}, "wpacked": {"wpacked_column": True}}


@pytest.fixture(autouse=True)
def _tiny(monkeypatch):
    register_tiny_resnets(monkeypatch)


def _init(module, seed: int, *args):
    return jax.jit(module.init)(jax.random.PRNGKey(seed), *args)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _perturb(tree, rng):
    """BN scales near 1, biases and means near 0, variances in [0.5, 1.5]."""
    def leaf(path, x):
        name = path[-1].key
        x = np.asarray(x)
        if name == "scale":
            return x + 0.2 * _normal(rng, x.shape)
        if name in ("bias", "mean"):
            return x + 0.1 * _normal(rng, x.shape)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _close(got: torch.Tensor, want, rel: float = 1e-4) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3  # the comparison is not of zeros
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _encoder_state(params, stats) -> dict[str, torch.Tensor]:
    state = from_jax_unetpp_params({"encoder": params}, {"encoder": stats})
    return {k[len("encoder."):]: v for k, v in state.items()}


def _stats_close(port: torch.nn.Module, jax_stats, convert) -> None:
    """Every BatchNorm's running statistics against the JAX update."""
    want = convert(jax_stats)
    state = port.state_dict()
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert keys and all(k in state for k in keys)
    for k in keys:
        np.testing.assert_allclose(state[k].numpy(), want[k].numpy(), atol=1e-5, err_msg=k)


@pytest.mark.parametrize("variant", ["tiny_resnet", "tiny_bottleneck", "tiny_resnext"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_encoder_pyramid_matches_jax(variant, train):
    rng = np.random.default_rng(0)
    x = _normal(rng, (2, SIZE, SIZE, 3))
    jmod = JaxEncoder(variant=variant)
    variables = _perturb(_init(jmod, 0, jnp.asarray(x)), rng)
    port = ResNetEncoder(variant)
    port.load_state_dict(_encoder_state(variables["params"], variables["batch_stats"]),
                         strict=True)
    port.train(train)
    if train:
        want, updates = jmod.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    assert len(got) == len(want) == 5
    assert [g.shape[1] for g in got] == list(port.out_channels) == list(jmod.out_channels)
    for g, w in zip(got, want):
        _close(g, w)
    if train:
        _stats_close(port, updates["batch_stats"],
                     lambda s: _encoder_state(variables["params"], s))


def test_encoder_conversion_inverts_convert_resnet():
    """The JAX package's own converter takes the port encoder's state back
    to the JAX variables it came from."""
    rng = np.random.default_rng(1)
    jmod = JaxEncoder(variant="tiny_bottleneck")
    variables = _perturb(_init(jmod, 1, jnp.zeros((1, SIZE, SIZE, 3))), rng)
    port = ResNetEncoder("tiny_bottleneck")
    port.load_state_dict(_encoder_state(variables["params"], variables["batch_stats"]))
    back = jconvert.convert_resnet({k: v.numpy() for k, v in port.state_dict().items()})
    flat_want = jax.tree_util.tree_leaves_with_path(dict(variables))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, value in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(value), err_msg=str(path))


def _features(rng):
    return [_normal(rng, (2, SIZE // s, SIZE // s, c)) for s, c in zip((2, 4, 8, 16, 32), WIDTHS)]


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_decoder_matches_jax(form, train):
    """The nested decoder alone (the JAX decoder's unpacked tail), eval with
    the running statistics, train with the batch's and their update."""
    rng = np.random.default_rng(2)
    feats = _features(rng)
    jfeats = [jnp.asarray(f) for f in feats]
    jmod = JaxDecoder(decoder_channels=TINY_DECODER, **FORMS[form])
    variables = _perturb(_init(jmod, 2, jfeats), rng)
    port = UnetPlusPlusDecoder(WIDTHS, TINY_DECODER)

    def convert(stats):
        state = from_jax_unetpp_params({"decoder": variables["params"]}, {"decoder": stats})
        return {k[len("decoder."):]: v for k, v in state.items()}

    port.load_state_dict(convert(variables["batch_stats"]), strict=True)
    port.train(train)
    if train:
        want, updates = jmod.apply(variables, jfeats, train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jfeats)
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    assert got.shape == (2, TINY_DECODER[-1], SIZE, SIZE)
    _close(got, want)
    if train:
        _stats_close(port, updates["batch_stats"], convert)


def _models(form: str, num_classes: int, rng, seed: int = 4):
    x = _normal(rng, (2, SIZE, SIZE, 3))
    jmodel = JaxUnetPlusPlus(encoder_name="tiny_resnet", num_classes=num_classes,
                             decoder_channels=TINY_DECODER, **FORMS[form])
    variables = _perturb(_init(jmodel, seed, jnp.asarray(x)), rng)
    port = UnetPlusPlus("tiny_resnet", num_classes=num_classes, decoder_channels=TINY_DECODER)
    port.load_state_dict(from_jax_unetpp_params(variables["params"], variables["batch_stats"]),
                         strict=True)
    return jmodel, variables, port.eval(), x


@pytest.mark.parametrize("form", list(FORMS))
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_unetpp_matches_jax(form, train):
    jmodel, variables, port, x = _models(form, 2, np.random.default_rng(5))
    port.train(train)
    if train:
        want, updates = jmodel.apply(variables, jnp.asarray(x), train=True,
                                     mutable=["batch_stats"])
    else:
        want = jmodel.apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.aux is None and want.aux is None and got.out.dtype == torch.float32
    assert got.out.shape == (2, 2, SIZE, SIZE)
    _close(got.out, want.out)
    if train:
        _stats_close(port, updates["batch_stats"],
                     lambda s: from_jax_unetpp_params(variables["params"], s))


def _capture():
    """Pass-through transform that keeps the last gradients in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}),
    )


def _f64_grads(model, batch) -> dict[str, torch.Tensor]:
    task = SegmentationTask(model.double().train(), DiceLoss(mode="binary"), num_classes=1)
    image = tsteps.prepare_image({k: torch.from_numpy(v) for k, v in batch.items()},
                                 PrecisionPolicy.create("32-true"))
    out = task.forward({}, image.double().permute(0, 3, 1, 2))
    task.compute_loss(out, torch.from_numpy(batch["mask"]).long()).backward()
    return {n: p.grad for n, p in model.named_parameters()}


@pytest.mark.parametrize("form", list(FORMS))
def test_train_step_matches_jax(form):
    """One SGD step with clipping and ``augment=None`` in train-mode
    BatchNorm: the loss, every gradient (before the clip) and every
    BatchNorm's updated statistics."""
    jmodel, variables, port, _ = _models(form, 1, np.random.default_rng(6))
    rng = np.random.default_rng(7)
    batch = {
        "image": rng.integers(0, 256, (2, SIZE, SIZE, 3), dtype=np.uint8),
        "mask": rng.integers(0, 2, (2, SIZE, SIZE)).astype(np.int32),
        "mean": np.tile(np.asarray([0.405, 0.432, 0.397], np.float32), (2, 1)),
        "std": np.tile(np.asarray([0.165, 0.161, 0.174], np.float32), (2, 1)),
    }
    tx = optax.chain(_capture(), joptim.build_optimizer(variables["params"], "sgd", lr=1e-3,
                                                        grad_clip=0.05))
    jstate = JaxState.create(apply_fn=jmodel.apply, params=variables["params"], tx=tx,
                             batch_stats=variables["batch_stats"])
    jtask = JaxTask(jmodel, JaxDice(mode="binary"), num_classes=1, uses_wavelengths=False)
    jstep = jsteps.make_train_step(jtask, JaxPrecision.create("32-true"), augment=None)
    jstate, jmetrics = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    jgrads = from_jax_unetpp_params(jax.tree.map(np.asarray, jstate.opt_state[0]["g"]),
                                    jax.tree.map(np.asarray, jstate.batch_stats))

    f64 = _f64_grads(copy.deepcopy(port), batch)
    task = SegmentationTask(port, DiceLoss(mode="binary"), num_classes=1)
    assert task.uses_wavelengths is False
    grads = {}
    for n, p in port.named_parameters():
        p.register_post_accumulate_grad_hook(lambda t, n=n: grads.__setitem__(n, t.grad.clone()))
    opt = toptim.build_optimizer(list(port.parameters()), "sgd", 1e-3)
    step = tsteps.make_train_step(task, PrecisionPolicy.create("32-true"), augment=None,
                                  grad_clip=0.05)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["mask"] = tbatch["mask"].long()
    loss = float(step(TrainState.create(port, opt, seed=0), tbatch)["loss"])

    assert abs(loss - float(jmetrics["loss"])) <= 1e-5
    assert len(grads) == len(list(port.parameters()))
    worst = {"port": 0.0, "jax": 0.0}
    for n, g in grads.items():
        exact = f64[n].numpy()
        bound = 1e-4 * np.abs(exact).max() + 1e-9
        err64 = np.abs(g.numpy() - exact).max()
        assert err64 <= bound, (n, err64, bound)
        jax_err64 = np.abs(jgrads[n].numpy() - exact).max()
        err = np.abs(g.numpy() - jgrads[n].numpy()).max()
        assert err <= jax_err64 + bound, (n, err, jax_err64, bound)
        top = np.abs(exact).max() + 1e-30
        worst = {"port": max(worst["port"], err64 / top), "jax": max(worst["jax"], jax_err64 / top)}
    print(f"largest gradient distance from f64, relative to the tensor's largest: "
          f"port {worst['port']:.3g}, JAX {worst['jax']:.3g}")
    state = port.state_dict()
    for k, want in jgrads.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(state[k].numpy(), want.numpy(), atol=1e-5, err_msg=k)


def test_init_weights_writes_every_tensor():
    """Built on the meta device, allocated uninitialised: ``init_weights``
    must write every parameter and buffer."""
    with torch.device("meta"):
        model = UnetPlusPlus("tiny_bottleneck", num_classes=2, decoder_channels=TINY_DECODER,
                             in_channels=4)
    model = model.to_empty(device="cpu")
    with torch.no_grad():
        for t in model.state_dict().values():
            t.fill_(float("nan") if t.is_floating_point() else -1)
    model.init_weights(torch.Generator().manual_seed(0))
    for name, t in model.state_dict().items():
        ok = torch.isfinite(t).all() if t.is_floating_point() else (t >= 0).all()
        assert ok, name
    with torch.no_grad():
        assert model.eval()(torch.zeros((1, 4, 64, 64))).out.shape == (1, 2, 64, 64)


def test_full_width_resnet34_unetpp_matches_jax_shapes():
    """resnet34 at full width, built on the meta device: every tensor of the
    JAX model's variables (shapes only, by ``jax.eval_shape``) has its port
    counterpart with the same number of elements, under smp's names."""
    shapes = jax.eval_shape(JaxUnetPlusPlus(encoder_name="resnet34").init, jax.random.PRNGKey(0),
                            jnp.zeros((1, SIZE, SIZE, 3)))
    with torch.device("meta"):
        model = UnetPlusPlus("resnet34")
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    want = from_jax_unetpp_params(zeros["params"], zeros["batch_stats"])
    got = model.state_dict()
    assert set(got) == set(want)
    for name, t in got.items():
        assert t.shape == want[name].shape, name
    for name in ("encoder.layer2.0.downsample.0.weight", "encoder.layer4.2.bn2.bias",
                 "decoder.blocks.x_0_0.conv1.0.weight", "decoder.blocks.x_3_3.conv2.1.weight",
                 "decoder.blocks.x_0_4.conv2.0.weight", "segmentation_head.0.bias"):
        assert name in got, name
