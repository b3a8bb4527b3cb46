"""The port's factored resize + 3x3 conv, fused neck and fused UperNet
bottleneck against the JAX package's, on the CPU.

Tolerances: the port's ``resize_conv3x3_factored`` within 1e-5 of the JAX
function's largest output magnitude in f32 (the same three products,
summed in other orders), and within 1e-10 of its own plain composition
(resize, then ``F.conv2d``) in f64; gradients within 1e-5 of ``jax.grad``'s
largest; the fused neck and UperNet within 1e-4 absolute of the JAX
modules (the DOFA parity tolerance); fused against unfused port modules on
one ``state_dict`` within 1e-10 in f64, forward and gradients.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tiny import jax_variables, register_tiny, tiny_model

from geo_deep_learning_tpu.models.decoders.upernet import UperNetDecoder as JaxUperNet
from geo_deep_learning_tpu.models.necks.multilevel import MultiLevelNeck as JaxNeck
from geo_deep_learning_tpu.ops import fused_upconv as jfu
from geo_deep_learning_tpu_torch.ops import fused_upconv as tfu

# (source H, W, out_hw): ratios 2, 4 and 8, a non-integer 5 -> 7, none
CASES = [
    (8, 6, (16, 12)),
    (5, 4, (20, 16)),
    (3, 3, (24, 24)),
    (5, 5, (7, 7)),
    (6, 5, None),
]
IDS = ["x2", "x4", "x8", "5to7", "none"]


def _inputs(h: int, w: int, seed: int = 0, cin: int = 6, cout: int = 5):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, h, w, cin)).astype(np.float32)  # NHWC
    k = rng.standard_normal((3, 3, cin, cout)).astype(np.float32)  # HWIO
    b = rng.standard_normal(cout).astype(np.float32)
    return x, k, b


def _port(x, k, b, dtype=torch.float32):
    """NHWC / HWIO numpy -> the port's NCHW / OIHW tensors."""
    return (torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype),
            torch.from_numpy(k).permute(3, 2, 0, 1).to(dtype), torch.from_numpy(b).to(dtype))


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.detach().permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize(("h", "w", "out_hw"), CASES, ids=IDS)
def test_factored_matches_jax(h, w, out_hw, align_corners):
    x, k, b = _inputs(h, w)
    want = np.asarray(jfu.resize_conv3x3_factored(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                                                  out_hw, align_corners))
    got = _nhwc(tfu.resize_conv3x3_factored(*_port(x, k, b), out_hw, align_corners))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


@pytest.mark.parametrize("align_corners", [False, True])
@pytest.mark.parametrize(("h", "w", "out_hw"), CASES, ids=IDS)
def test_factored_matches_the_plain_composition_in_f64(h, w, out_hw, align_corners):
    x, k, b = _port(*_inputs(h, w, seed=1), dtype=torch.float64)
    for xin in (x, x.to(memory_format=torch.channels_last)):
        got = tfu.resize_conv3x3_factored(xin, k, b, out_hw, align_corners)
        want = tfu.reference(x, k, b, out_hw, align_corners)
        assert got.is_contiguous(memory_format=torch.channels_last)
        torch.testing.assert_close(got, want, atol=1e-10, rtol=0)


@pytest.mark.parametrize(("h", "w", "out_hw"), CASES, ids=IDS)
def test_factored_gradients_match_jax(h, w, out_hw):
    x, k, b = _inputs(h, w, seed=2)
    oh, ow = out_hw or (h, w)
    g = np.random.default_rng(3).standard_normal((2, oh, ow, k.shape[-1])).astype(np.float32)

    def jloss(x, k, b):
        return jnp.sum(jfu.resize_conv3x3_factored(x, k, b, out_hw) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
    tx, tk, tb = (t.requires_grad_() for t in _port(x, k, b))
    y = tfu.resize_conv3x3_factored(tx, tk, tb, out_hw)
    (y * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    got = (_nhwc(tx.grad), tk.grad.permute(2, 3, 1, 0).numpy(), tb.grad.numpy())
    for name, gv, wv in zip(("x", "kernel", "bias"), got, want):
        wv = np.asarray(wv)
        np.testing.assert_allclose(gv, wv, atol=1e-5 * np.abs(wv).max(), rtol=0, err_msg=name)


@pytest.fixture
def tiny(monkeypatch):
    """The narrow DOFA's port model and its JAX variables, and random
    inputs for the neck (four 8^2 taps of width 64)."""
    register_tiny(monkeypatch)
    model = tiny_model(num_classes=2)
    variables = jax_variables(model)
    rng = np.random.default_rng(4)
    taps = [rng.standard_normal((2, 8, 8, 64)).astype(np.float32) for _ in range(4)]
    return model, variables, taps


def _sub(variables: dict, name: str) -> dict:
    return {"params": variables["params"][name], "batch_stats": variables["batch_stats"][name]}


def test_fused_neck_and_upernet_match_jax(tiny):
    model, variables, taps = tiny
    assert model.neck.fuse_scale4 and model.decoder.fuse_bottleneck
    jneck = JaxNeck(out_channels=[64] * 4, scales=[4, 2, 1, 0.5], use_norm_act=True,
                    fuse_scale4=True)
    jdec = JaxUperNet(channels=32, align_corners=False, fuse_bottleneck=True)

    @jax.jit
    def jax_forward(neck_vars, dec_vars, taps):
        feats = jneck.apply(neck_vars, taps, train=False)
        return feats, jdec.apply(dec_vars, feats, train=False)

    jfeats, jout = jax_forward(_sub(variables, "neck"), _sub(variables, "decoder"),
                               [jnp.asarray(t) for t in taps])
    jout = np.asarray(jout)
    with torch.no_grad():
        feats = model.neck([torch.from_numpy(t).permute(0, 3, 1, 2) for t in taps])
        out = _nhwc(model.decoder(feats))
    for got, want in zip(feats, jfeats):
        np.testing.assert_allclose(_nhwc(got), np.asarray(want), atol=1e-4, rtol=0)
    assert np.abs(jout).max() > 1e-2
    np.testing.assert_allclose(out, jout, atol=1e-4, rtol=0)


@pytest.mark.parametrize("train", [False, True])
def test_fused_equals_unfused_on_one_state_dict_in_f64(tiny, train):
    model, _, taps = tiny
    fused = copy.deepcopy(model).double().train(train)
    plain = copy.deepcopy(fused)
    plain.neck.fuse_scale4 = plain.decoder.fuse_bottleneck = False
    assert fused.state_dict().keys() == plain.state_dict().keys()
    outs, grads = [], []
    for m in (fused, plain):
        inputs = [torch.from_numpy(t).permute(0, 3, 1, 2).double().requires_grad_() for t in taps]
        y = m.decoder(m.neck(inputs))
        y.square().sum().backward()
        outs.append(y.detach())
        grads.append([t.grad for t in inputs] + [p.grad for p in m.parameters() if p.grad is not None])
    torch.testing.assert_close(outs[0], outs[1], atol=1e-10, rtol=0)
    assert len(grads[0]) == len(grads[1])
    for g0, g1 in zip(*grads):
        torch.testing.assert_close(g0, g1, atol=1e-10 * max(1.0, float(g1.abs().max())), rtol=0)


def test_tap_matrices_built_in_inference_mode_serve_training():
    """An evaluation (inference mode) may build the cached matrices first;
    a train step must still be able to save them for its backward."""
    tfu._tap_matrix.cache_clear()
    x, k, b = _port(*_inputs(3, 4, seed=6))
    with torch.inference_mode():
        tfu.resize_conv3x3_factored(x, k, b, (9, 11))
    x.requires_grad_()
    tfu.resize_conv3x3_factored(x, k, b, (9, 11)).sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
