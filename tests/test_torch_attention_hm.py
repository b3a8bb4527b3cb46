"""The head-major attention pair (K8/K9) and the port's attention dispatch.

- The plain versions of K8 and K9 (``attention_hm_reference``,
  ``attention_hm_bwd_reference``) against the JAX package's Pallas kernels
  ``_fwd_kernel`` / ``_bwd_kernel`` in interpreter mode, on inputs padded
  to the JAX kernels' 256-row tile with ``valid`` real columns: ``o`` and
  ``lse`` from ``_fwd``, and ``dq, dk, dv`` through ``jax.grad`` of the
  ``custom_vjp`` (which runs ``_bwd_pallas``).
- :func:`route` against the JAX package's own shape rules at the band's
  edges (L = 1592, 1593, 2304, 2305 at DOFA's head dim 64) and over a sweep,
  and :func:`attention` taking the Function that the route names.
- A narrow DOFA at 576^2 (41 x 41 tokens + cls = 1682, inside the band)
  against the JAX model on the same converted weights: forward, and one
  train step's loss and gradients.

Inputs come from numpy with a fixed seed. Tolerances: f32 outputs and lse
1e-5 absolute on values of order 1 (the sides sum in different orders;
observed below 1e-6); bf16 ``o`` one bf16 ulp of the largest |o| and bf16
gradients one ulp of the largest gradient (both sides round one f32
result; observed up to 0.3 of that); f32 gradients 1e-5 of the largest
(observed 1.1e-6); the model as in ``test_torch_model.py`` and
``test_torch_train.py``.
"""

import functools
import math
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tiny import WAVES, jax_variables, perturb

import geo_deep_learning_tpu.models.segmentation.dofa as jsegdofa
import geo_deep_learning_tpu.ops.pallas.mha as jmha
from geo_deep_learning_tpu.models.encoders import dofa as jdofa
from geo_deep_learning_tpu.models.encoders.dofa import DOFAv2 as JaxDOFAv2
from geo_deep_learning_tpu.models.heads.fcn import FCNHead as JaxFCNHead
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.training.task import SegmentationTask as JaxTask
from geo_deep_learning_tpu_torch.models.convert import from_jax_params
from geo_deep_learning_tpu_torch.models.encoders import dofa as tdofa
from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout
from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
from geo_deep_learning_tpu_torch.ops.cuda import mha as tmha
from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
from geo_deep_learning_tpu_torch.training.task import SegmentationTask


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jmha, "_INTERPRET", True)
    jax.clear_caches()  # the JAX kernels are jitted; drop traces of the real mode
    yield
    jax.clear_caches()


def _t(a, dtype):
    return torch.from_numpy(np.array(jnp.asarray(a).astype(jnp.float32))).to(dtype)


def _case(l, hd, dtype, seed=0):
    """Head-major q, k, v, g ``[1, 2, l, hd]``, and q, k, v padded to the
    JAX kernels' length, as JAX arrays of ``dtype``."""
    rng = np.random.default_rng(seed)
    q, k, v, g = (rng.standard_normal((1, 2, l, hd)).astype(np.float32) for _ in range(4))
    lp = jmha._pad_len(l)
    pad = lambda x: jnp.pad(jnp.asarray(x, dtype), ((0, 0), (0, 0), (0, lp - l), (0, 0)))  # noqa: E731
    return (q, k, v, g), tuple(pad(x) for x in (q, k, v))


def _ulp(a: np.ndarray) -> float:
    """One bf16 unit in the last place of the largest |a|."""
    return 2.0 ** (math.floor(math.log2(float(np.abs(a).max()))) - 7)


@pytest.mark.parametrize("l", [130, 300, 512])
@pytest.mark.parametrize("hd", [16, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_head_major_plain_versions_match_the_jax_kernels(interpret, l, hd, dtype):
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    (q, k, v, g), padded = _case(l, hd, jd)
    scale = 1.0 / math.sqrt(hd)
    jo, jlse = jmha._fwd(*padded, scale, l)
    tq, tk, tv = (_t(x, td) for x in padded)
    o, lse = tmha.attention_hm_reference(tq, tk, tv, scale, valid=l)
    want_o = np.asarray(jo.astype(jnp.float32))
    assert o.dtype == td and o.shape == tq.shape and lse.shape == tq.shape[:3]
    o_tol = 1e-5 if dtype == "float32" else _ulp(want_o)
    np.testing.assert_allclose(o.float().numpy(), want_o, atol=o_tol, rtol=0)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=1e-5, rtol=0)

    lp = padded[0].shape[2]

    def loss(q, k, v):
        pad = lambda x: jnp.pad(x, ((0, 0), (0, 0), (0, lp - l), (0, 0)))  # noqa: E731
        out = jmha._attention(pad(q), pad(k), pad(v), scale, l)[:, :, :l]
        return (out.astype(jnp.float32) * jnp.asarray(g)).sum()

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jd) for x in (q, k, v)))
    tg = torch.nn.functional.pad(_t(jnp.asarray(g, jd), td), (0, 0, 0, lp - l))
    grads = tmha.attention_hm_bwd_reference(tq, tk, tv, o, tg, lse, scale, valid=l)
    for name, got, want in zip("qkv", grads, jgrads):
        want = np.asarray(want.astype(jnp.float32))
        tol = 1e-5 * np.abs(want).max() if dtype == "float32" else _ulp(want)
        assert got.dtype == td
        np.testing.assert_allclose(got[:, :, :l].float().numpy(), want, atol=tol, rtol=0,
                                   err_msg=f"d{name}")
    for got in grads[1:]:  # key columns past `valid` get no gradient
        assert not got[:, :, l:].any()


def test_plain_backward_equals_autograd_f64():
    rng = np.random.default_rng(3)
    q, k, v, g = (torch.from_numpy(rng.standard_normal((2, 2, 37, 32))) for _ in range(4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o, lse = tmha.attention_hm_reference(*leaves, 0.25)
    (o * g).sum().backward()
    got = tmha.attention_hm_bwd_reference(q, k, v, o.detach(), g, lse.detach(), 0.25)
    for a, leaf in zip(got, leaves):
        torch.testing.assert_close(a, leaf.grad, atol=1e-10, rtol=0)


def _jax_route(monkeypatch, h, l, hd):
    """The JAX package's choice on one TPU: "packed", "head_major" or
    "einsum" (``fused_attention_packed`` -> ``fused_attention``)."""
    monkeypatch.setattr(jax, "devices", lambda *a: [SimpleNamespace(platform="tpu")])
    if jmha._packed_supported(h, l, hd):
        return "packed"
    q = SimpleNamespace(shape=(1, h, l, hd))
    return "head_major" if jmha._supported(q, q) else "einsum"


@pytest.mark.parametrize("l,want", [(1297, "packed"), (1592, "packed"), (1593, "head_major"),
                                    (2026, "head_major"), (2304, "head_major"), (2305, "packed")])
def test_route_at_the_band_edges(monkeypatch, l, want):
    """DOFA-base heads (12 x 64): K4/K7 up to 1592 tokens, K8/K9 from 1593
    to a padded 2304, K4/K7 past it, where the JAX package takes the einsum."""
    assert tmha.route(12, l, 64) == want
    jax_route = _jax_route(monkeypatch, 12, l, 64)
    assert jax_route == want or (jax_route, want) == ("einsum", "packed")


def test_route_mirrors_the_jax_shape_rules(monkeypatch):
    for h, hd in ((2, 32), (6, 32), (12, 64), (3, 64), (16, 64), (4, 128), (2, 16)):
        for l in range(17, 3000, 97):
            jax_route = _jax_route(monkeypatch, h, l, hd)
            assert tmha.route(h, l, hd) == ("packed" if jax_route == "einsum" else jax_route), (
                h, l, hd)


@pytest.mark.parametrize("l", [1592, 1593, 2304, 2305])
def test_attention_takes_the_routed_function(l):
    """Two 64-wide heads, as DOFA's: the output's autograd node is the
    routed pair's Function, the output equals the packed plain version's
    and the gradient reaches qkv in the packing order."""
    rng = np.random.default_rng(l)
    qkv = torch.from_numpy(rng.standard_normal((1, l, 3 * 128)).astype(np.float32))
    qkv.requires_grad_()
    o = tmha.attention(qkv, 2)
    fn = {"packed": "AttentionPackedFn", "head_major": "AttentionHeadMajorFn"}[tmha.route(2, l, 64)]
    node = o.grad_fn
    while not node.name().startswith(("AttentionPackedFn", "AttentionHeadMajorFn")):
        node = node.next_functions[0][0]
    assert node.name().startswith(fn)
    want, lse = tmha.attention_reference(qkv.detach(), 2, 0.125)
    torch.testing.assert_close(o.detach(), want, atol=1e-6, rtol=0)
    g = torch.from_numpy(rng.standard_normal((1, l, 128)).astype(np.float32))
    (o * g).sum().backward()
    torch.testing.assert_close(qkv.grad, tmha.attention_bwd_reference(
        qkv.detach(), want, g, lse, 2, 0.125), atol=1e-6, rtol=0)


# narrow DOFA whose heads are DOFA-base's (64 wide): at 576^2 its 1682
# tokens take the head-major route, as DOFA-base's do at 640^2
NARROW = dict(embed_dim=128, depth=4, num_heads=2, out_indices=(0, 1, 2, 3))
SIZE = 576


@pytest.fixture
def narrow(monkeypatch):
    monkeypatch.setitem(jdofa.dofa_configs, "narrow", jdofa.DOFAConfig(**NARROW))
    monkeypatch.setitem(tdofa.dofa_configs, "narrow", tdofa.DOFAConfig(**NARROW))
    monkeypatch.setattr(jsegdofa, "DOFAv2", functools.partial(JaxDOFAv2, drop_path_rate=0.0))
    monkeypatch.setattr(jsegdofa, "FCNHead", functools.partial(JaxFCNHead, dropout_ratio=0.0))
    calls = []
    for name in ("attention_hm", "attention_hm_bwd"):
        fn = getattr(tmha, name)
        monkeypatch.setattr(tmha, name,
                            lambda *a, fn=fn, name=name, **kw: calls.append(name) or fn(*a, **kw))
    model = DOFASegmentation("narrow", num_classes=1, decoder_channels=16, img_size=SIZE)
    model.init_weights(torch.Generator().manual_seed(0))
    perturb(model, np.random.default_rng(0))
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    table = model.encoder.pos_embed.numpy()
    jmodel = jsegdofa.DOFASegmentation(encoder_name="narrow", num_classes=1, decoder_channels=16,
                                       pos_embed_table=table)
    rng = np.random.default_rng(7)
    image = rng.integers(0, 256, (1, SIZE, SIZE, 3), dtype=np.uint8)
    x = ((image / 255.0 - 0.42) / 0.17).astype(np.float32)
    mask = rng.integers(0, 2, (1, SIZE, SIZE)).astype(np.int32)
    return model, jmodel, jax_variables(model), table, x, mask, calls


def test_narrow_dofa_in_the_band_matches_jax(narrow):
    """Eval forward (main and aux logits), then one f32 train step's Dice
    loss and gradients, against the JAX model; K8's plain version runs
    once per block, K9's once per block in the step. Tolerances: logits
    1e-4 absolute and the loss 1e-5, as the 5-block tests at 64^2;
    gradients per tensor ``tol * max|want| + 1e-7``, with ``tol`` 2e-3 for
    the encoder's tensors, as there (observed at most 2.3e-4), and 1e-2 for
    the neck, decoder and heads (observed at most 4.2e-3, at the neck's
    x4 level: 164^2 maps through train-mode BatchNorm); the absolute term
    covers gradients that are mathematically zero (conv biases ahead of
    BatchNorm), which both sides give as rounding noise near 1e-9."""
    model, jmodel, variables, table, x, mask, calls = narrow
    assert tmha.route(2, tdofa.token_grid(SIZE, 14) ** 2 + 1, 64) == "head_major"
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    with torch.no_grad():
        out = model.eval()(xt, torch.from_numpy(WAVES))
    jout = jmodel.apply(variables, jnp.asarray(x), jnp.asarray(WAVES), train=False)
    for got, want in ((out.out, jout.out), (out.aux, jout.aux)):
        np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)
    assert calls == ["attention_hm"] * 4

    jtask = JaxTask(jmodel, JaxDice(mode="binary"), num_classes=1)

    def jloss(params):
        o = jmodel.apply({**variables, "params": params}, jnp.asarray(x), jnp.asarray(WAVES),
                         train=True, mutable=["batch_stats"])[0]
        return jtask.compute_loss(o, jnp.asarray(mask))

    jl, jgrads = jax.value_and_grad(jloss)(variables["params"])
    jgrads = from_jax_params(jax.tree.map(np.asarray, jgrads),
                             jax.tree.map(np.asarray, variables["batch_stats"]), pos_embed=table)
    task = SegmentationTask(model.train(), DiceLoss(mode="binary"), num_classes=1)
    calls.clear()
    loss = task.compute_loss(model(xt, torch.from_numpy(WAVES)), torch.from_numpy(mask).long())
    loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= 1e-5
    assert sorted(calls) == ["attention_hm"] * 4 + ["attention_hm_bwd"] * 4
    with_grads = [(n, p) for n, p in model.named_parameters() if p.grad is not None]
    assert len(with_grads) == len(list(model.parameters())) - 2  # encoder.norm is unused
    for n, p in with_grads:
        want = jgrads[n].numpy()
        err = np.abs(p.grad.numpy() - want).max()
        tol = 2e-3 if n.startswith("encoder.") else 1e-2
        assert err <= tol * np.abs(want).max() + 1e-7, (n, err, np.abs(want).max())
