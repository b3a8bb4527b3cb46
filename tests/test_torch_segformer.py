"""The port's SegFormer against the JAX package's, on the CPU.

A narrow MiT (``_torch_tiny.TINY_MIT``: widths 16-64, one block a stage,
drop-path 0) registered in both packages' ``mit_configs``, at 128^2 inputs,
so that stage 1 attends 1024 queries over 16 reduced tokens and takes the
K10 dispatch on both sides: the JAX package's Pallas kernel in interpret
mode (its platform check lifted, its shape rule kept), the port's plain
version of K10. JAX variables, with every norm scale and bias and the
BatchNorm statistics drawn away from their identity inits, come to the
port through ``from_jax_segformer_params``. Inputs are drawn with numpy.

Tolerances, f32 on both sides with summation orders that differ: the
attention functions 1e-5 absolute on outputs of order 1 (2e-5 for their
gradients); modules and whole models 1e-4 of the largest output magnitude;
bf16 attention within one bf16 unit in the last place of the largest
output (both round one f32 result). The train step: the loss to 1e-5;
the gradients per tensor ``max|d| <= 5e-3 * max|want| + 1e-7``, and to
2e-2 for the fuse conv's ahead of the train-mode BatchNorm, whose backward
cancels terms. Those bounds are the JAX f32 step's own distance from an
f64 run of the port (up to 2.9e-3, and 1.1e-2 for the fuse conv, at these
weights), while the port's f32 step stays within 1e-4 of that f64 run,
which the test checks too; the absolute term covers the gradients that are
mathematically zero (biases ahead of a BatchNorm, ~1e-18 in f64).
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from _torch_tiny import TINY_MIT, register_tiny_mit

import geo_deep_learning_tpu.ops.pallas.sr_attention as jsra
from geo_deep_learning_tpu.core.precision import PrecisionPolicy as JaxPrecision
from geo_deep_learning_tpu.core.train_state import TrainState as JaxState
from geo_deep_learning_tpu.models import convert as jconvert
from geo_deep_learning_tpu.models.decoders.segformer_mlp import SegFormerMLPDecoder as JaxDecoder
from geo_deep_learning_tpu.models.encoders import mix_transformer as jmit
from geo_deep_learning_tpu.models.segmentation.segformer import SegFormer as JaxSegFormer
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.training import optim as joptim
from geo_deep_learning_tpu.training import steps as jsteps
from geo_deep_learning_tpu.training.task import SegmentationTask as JaxTask
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.models.convert import from_jax_mit_params, from_jax_segformer_params
from geo_deep_learning_tpu_torch.models.decoders.segformer_mlp import SegFormerMLPDecoder
from geo_deep_learning_tpu_torch.models.encoders import mix_transformer as tmit
from geo_deep_learning_tpu_torch.models.segmentation.segformer import SegFormer
from geo_deep_learning_tpu_torch.ops.cuda import sr_attention as tsra
from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
from geo_deep_learning_tpu_torch.training import optim as toptim
from geo_deep_learning_tpu_torch.training import steps as tsteps
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

SIZE = 128


def _jax_rule(q, k):
    """``sr_attention._supported`` without its platform check."""
    lq, d, lk = q.shape[2], q.shape[3], k.shape[2]
    if lq % 512 != 0 or lq < 512 or lk % 8 != 0:
        return False
    return 4 * (2 * lk * d + 512 * lk + 2 * 512 * d) <= 8 * 1024 * 1024


@pytest.fixture
def kernels(monkeypatch):
    """The JAX kernel in interpret mode on the CPU; counters of the calls
    that reach it and the port's plain K10."""
    calls = {"jax": 0, "port": 0}
    pallas, plain = jsra._pallas_attention, tsra.sr_attention_plain

    def jax_kernel(*a):
        calls["jax"] += 1
        return pallas(*a)

    def port_kernel(*a):
        calls["port"] += 1
        return plain(*a)

    monkeypatch.setattr(jsra, "_INTERPRET", True)
    monkeypatch.setattr(jsra, "_supported", _jax_rule)
    monkeypatch.setattr(jsra, "_pallas_attention", jax_kernel)
    monkeypatch.setattr(tsra, "sr_attention_plain", port_kernel)
    jax.clear_caches()
    yield calls
    jax.clear_caches()


def _init(module, seed: int, *args):
    """Flax variables of ``module``, initialised in one compiled program."""
    return jax.jit(module.init)(jax.random.PRNGKey(seed), *args)


def _normal(rng, shape, dtype=np.float32):
    return rng.standard_normal(shape).astype(dtype)


def _close(got: torch.Tensor, want, rel: float = 1e-4) -> None:
    want = np.asarray(want, np.float32)
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert scale > 1e-3  # the comparison is not of zeros
    np.testing.assert_allclose(got, want, atol=rel * scale, rtol=0)


def _perturb(tree, rng):
    """Norm scales near 1, every bias and BN mean near 0, BN variances in
    [0.5, 1.5]: no parameter stays at its identity init."""
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


def _to_nhwc(t: torch.Tensor) -> torch.Tensor:
    return t.permute(0, 2, 3, 1)


# ---------------------------------------------------------------- kernel K10


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sr_attention_functions_match_jax(kernels, dtype):
    """The plain version of K10 against the JAX kernel (interpret mode),
    and ``einsum_attention`` against ``_einsum_attention``."""
    rng = np.random.default_rng(0)
    q, k, v = (_normal(rng, (1, 2, l, 32)) for l in (1024, 64, 64))
    scale = 32**-0.5
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    jq, jk, jv = (jnp.asarray(t).astype(jdt) for t in (q, k, v))
    tq, tk, tv = (torch.from_numpy(t).to(tdt) for t in (q, k, v))
    for got, want in (
        (tsra.sr_attention_plain(tq, tk, tv, scale), jsra._pallas_attention(jq, jk, jv, scale)),
        (tsra.einsum_attention(tq, tk, tv, scale), jsra._einsum_attention(jq, jk, jv, scale)),
    ):
        assert got.dtype == tdt and want.dtype == jdt
        want = np.asarray(want.astype(jnp.float32))
        top = float(np.abs(want).max())
        tol = 1e-5 if dtype == "float32" else 2.0 ** (math.floor(math.log2(top)) - 7)
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=0)
    assert kernels["jax"] == 1 and kernels["port"] == 1


def test_sr_attention_fn_gradients_match_jax():
    """The K10 operator's registered backward against the JAX
    ``_attention_bwd``."""
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, (2, 2, l, 16)) for l in (512, 24, 24))
    g = _normal(rng, q.shape)
    scale = 0.25
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = tsra.sr_attention(*leaves, scale)
    assert out.grad_fn.name() == "GeneratedBackwardFor_gdl_sr_attention_fwd_defaultBackward"
    out.backward(torch.from_numpy(g))
    want = jsra._attention_bwd(scale, tuple(jnp.asarray(t) for t in (q, k, v)), jnp.asarray(g))
    for leaf, w in zip(leaves, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(w), atol=2e-5, rtol=0)


def test_sr_attention_dispatch_follows_the_jax_shape_rule():
    """Stage 4 of MiT at 512^2 (Lq 256) and ragged KV lengths take the
    einsum; stages 1-3 take the kernel."""
    def shapes(lq, lk, d=32):
        return torch.zeros((1, 1, lq, d)), torch.zeros((1, 1, lk, d))

    for lq, lk, d in ((16384, 256, 32), (4096, 256, 32), (1024, 256, 32), (16384, 256, 64),
                      (4096, 3584, 32), (256, 256, 32), (1024, 12, 32), (4096, 3592, 32),
                      (768, 256, 32)):
        q, k = shapes(lq, lk, d)
        assert tsra.supported(q, k) == _jax_rule(q, k), (lq, lk, d)
    assert tsra.supported(*shapes(16384, 256)) and not tsra.supported(*shapes(256, 256))


# ---------------------------------------------------------------- modules


def _attn_state(p) -> dict[str, torch.Tensor]:
    """JAX ``SRAttention`` parameters -> the port module's state."""
    def t(x):
        return torch.from_numpy(np.array(x, np.float32))

    sd = {}
    for name in ("q", "kv", "proj"):
        sd[f"{name}.weight"] = t(np.asarray(p[name]["kernel"]).T)
        sd[f"{name}.bias"] = t(p[name]["bias"])
    sd["sr.weight"] = t(np.transpose(np.asarray(p["sr"]["kernel"]), (3, 2, 0, 1)))
    sd["sr.bias"] = t(p["sr"]["bias"])
    sd["norm.weight"] = t(p["sr_norm"]["scale"])
    sd["norm.bias"] = t(p["sr_norm"]["bias"])
    return sd


def test_sr_attention_module_matches_jax(kernels):
    rng = np.random.default_rng(2)
    x = _normal(rng, (2, 32, 32, 32))
    jmod = jmit.SRAttention(num_heads=1, sr_ratio=4)
    variables = _perturb(_init(jmod, 0, jnp.asarray(x)), rng)
    kernels["jax"] = 0
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    port = tmit.SRAttention(32, num_heads=1, sr_ratio=4)
    port.load_state_dict(_attn_state(variables["params"]), strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).flatten(1, 2), 32, 32)
    _close(got, np.asarray(want).reshape(2, 1024, 32))
    assert kernels["jax"] == 1 and kernels["port"] == 1


def test_mit_block_matches_jax(kernels):
    rng = np.random.default_rng(3)
    x = _normal(rng, (2, 32, 32, 16))
    jmod = jmit.MiTBlock(num_heads=1, sr_ratio=8)
    variables = _perturb(_init(jmod, 1, jnp.asarray(x)), rng)
    kernels["jax"] = 0
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    port = tmit.MiTBlock(16, num_heads=1, sr_ratio=8)
    state = from_jax_mit_params({"block1_0": variables["params"]})
    port.load_state_dict({k[len("block1.0."):]: v for k, v in state.items()}, strict=True)
    with torch.no_grad():
        got = port(torch.from_numpy(x).flatten(1, 2), 32, 32)
    _close(got, np.asarray(want).reshape(2, 1024, 16))
    assert kernels["jax"] == 1 and kernels["port"] == 1


def test_mix_vision_transformer_matches_jax(kernels, monkeypatch):
    register_tiny_mit(monkeypatch)
    rng = np.random.default_rng(4)
    x = _normal(rng, (2, SIZE, SIZE, 3))
    jmod = jmit.MixVisionTransformer(variant="tiny_mit")
    variables = _perturb(_init(jmod, 2, jnp.asarray(x)), rng)
    kernels["jax"] = 0
    want = jax.jit(jmod.apply)(variables, jnp.asarray(x))
    port = tmit.MixVisionTransformer("tiny_mit")
    port.load_state_dict(from_jax_mit_params(variables["params"]), strict=True)
    with torch.no_grad():
        got = port(_nchw(x))
    assert len(got) == len(want) == 4
    for g, w, c in zip(got, want, TINY_MIT["embed_dims"]):
        assert g.shape[1] == c
        _close(_to_nhwc(g), w)
    assert kernels["jax"] == 1 and kernels["port"] == 1


def _decoder_params(variables) -> dict[str, torch.Tensor]:
    state = from_jax_segformer_params(
        {"encoder": {}, "decoder": variables["params"]},
        {"decoder": variables["batch_stats"]},
    )
    return {k[len("decoder."):]: v for k, v in state.items()}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_decoder_matches_jax(train):
    """Eval uses the running statistics; train normalizes with the batch's
    and updates them (dropout at rate 0: its masks cannot match)."""
    rng = np.random.default_rng(5)
    chans = TINY_MIT["embed_dims"]
    feats = [_normal(rng, (2, SIZE // s, SIZE // s, c)) for s, c in zip((4, 8, 16, 32), chans)]
    jmod = JaxDecoder(num_classes=3, embedding_dim=32, dropout_ratio=0.0)
    jfeats = [jnp.asarray(f) for f in feats]
    variables = _perturb(_init(jmod, 3, jfeats), rng)
    port = SegFormerMLPDecoder(chans, num_classes=3, embedding_dim=32, dropout_ratio=0.0)
    port.load_state_dict(_decoder_params(variables), strict=True)
    port.train(train)
    if train:
        want, updates = jmod.apply(variables, jfeats, train=True, mutable=["batch_stats"])
    else:
        want = jmod.apply(variables, jfeats)
    with torch.no_grad():
        got = port([_nchw(f) for f in feats])
    _close(_to_nhwc(got), want)
    if train:
        bn = port.linear_fuse[1]
        stats = updates["batch_stats"]["bn"]
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(stats["mean"]), atol=1e-5)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(stats["var"]), atol=1e-5)


def _models(dynamic: bool, num_classes: int, rng, channels: int = 3):
    x = _normal(rng, (2, SIZE, SIZE, channels))
    jmodel = JaxSegFormer(encoder_name="tiny_mit", num_classes=num_classes,
                          use_dynamic_encoder=dynamic)
    variables = _perturb(_init(jmodel, 4, jnp.asarray(x)), rng)
    port = SegFormer("tiny_mit", num_classes=num_classes, use_dynamic_encoder=dynamic,
                     in_channels=channels)
    port.load_state_dict(
        from_jax_segformer_params(variables["params"], variables["batch_stats"]), strict=True
    )
    return jmodel, variables, port.eval(), x


def test_from_jax_segformer_params_inverts_convert(monkeypatch):
    """The JAX package's own converter takes the port's state back to the
    JAX variables it came from."""
    register_tiny_mit(monkeypatch)
    _, variables, port, _ = _models(False, 2, np.random.default_rng(6))
    back = jconvert.convert_segformer_model({k: v.numpy() for k, v in port.state_dict().items()})
    flat_want = jax.tree_util.tree_leaves_with_path(variables)
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, value in flat_want:
        np.testing.assert_array_equal(flat_got[path], np.asarray(value), err_msg=str(path))


@pytest.mark.parametrize("dynamic", [False, True], ids=["mit", "dynamic"])
def test_segformer_matches_jax(kernels, monkeypatch, dynamic):
    register_tiny_mit(monkeypatch)
    channels = 4 if dynamic else 3
    jmodel, variables, port, x = _models(dynamic, 2, np.random.default_rng(7), channels)
    kernels["jax"] = 0
    want = jax.jit(jmodel.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = port(_nchw(x))
    assert got.aux is None and want.aux is None and got.out.dtype == torch.float32
    _close(_to_nhwc(got.out), want.out)
    assert kernels["jax"] == 1 and kernels["port"] == 1


# ---------------------------------------------------------------- train step


def _capture():
    """Pass-through transform that keeps the last gradients in its state."""
    return optax.GradientTransformation(
        lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        lambda g, s, p=None: (g, {"g": g}),
    )


def _f64_grads(model, batch) -> dict[str, torch.Tensor]:
    """The loss's gradients with the model and batch in f64."""
    task = SegmentationTask(model.double().train(), DiceLoss(mode="binary"), num_classes=1)
    image = tsteps.prepare_image({k: torch.from_numpy(v) for k, v in batch.items()},
                                 PrecisionPolicy.create("32-true"))
    out = task.forward({}, image.double().permute(0, 3, 1, 2))
    task.compute_loss(out, torch.from_numpy(batch["mask"]).long()).backward()
    return {n: p.grad for n, p in model.named_parameters()}


def test_train_step_matches_jax(kernels, monkeypatch):
    """One SGD step with clipping, ``augment=None``, decoder dropout at 0:
    the loss, every gradient (before the clip) and the BN statistics."""
    register_tiny_mit(monkeypatch)
    jmodel, variables, port, _ = _models(False, 1, np.random.default_rng(8))
    kernels["jax"] = 0
    jmodel = jmodel.clone(dropout_ratio=0.0)
    for m in port.modules():
        if isinstance(m, tmit.Dropout):
            m.rate = 0.0
    rng = np.random.default_rng(9)
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
    jgrads = from_jax_segformer_params(
        jax.tree.map(np.asarray, jstate.opt_state[0]["g"]),
        jax.tree.map(np.asarray, jstate.batch_stats),
    )

    f64 = _f64_grads(copy.deepcopy(port), batch)
    kernels["port"] = 0
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
    for n, g in grads.items():
        want = jgrads[n].numpy()
        err = np.abs(g.numpy() - want).max()
        rel = 2e-2 if n == "decoder.linear_fuse.0.weight" else 5e-3
        assert err <= rel * np.abs(want).max() + 1e-7, (n, err, np.abs(want).max())
        err64 = (g.double() - f64[n]).abs().max()
        assert err64 <= 1e-4 * f64[n].abs().max() + 1e-9, (n, float(err64))
    for k in ("running_mean", "running_var"):
        np.testing.assert_allclose(port.state_dict()[f"decoder.linear_fuse.1.{k}"].numpy(),
                                   jgrads[f"decoder.linear_fuse.1.{k}"].numpy(), atol=1e-5)
    assert kernels["port"] == 1 and kernels["jax"] == 1


def test_init_weights_writes_every_tensor(monkeypatch):
    """Built on the meta device, allocated uninitialised: ``init_weights``
    must write every parameter and buffer, for both encoders."""
    register_tiny_mit(monkeypatch)
    for dynamic in (False, True):
        with torch.device("meta"):
            model = SegFormer("tiny_mit", num_classes=2, use_dynamic_encoder=dynamic)
        model = model.to_empty(device="cpu")
        with torch.no_grad():
            for t in model.state_dict().values():
                t.fill_(float("nan") if t.is_floating_point() else -1)
        model.init_weights(torch.Generator().manual_seed(0))
        for name, t in model.state_dict().items():
            ok = torch.isfinite(t).all() if t.is_floating_point() else (t >= 0).all()
            assert ok, name
        with torch.no_grad():
            assert model.eval()(torch.zeros((1, 4 if dynamic else 3, 64, 64))).out.shape == (1, 2, 64, 64)
