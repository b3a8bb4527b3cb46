"""The plain versions of kernels K5, K6 and K7 (the port's LayerNorm,
residual LayerNorm and packed-attention backwards) against the JAX
package's Pallas backward kernels in interpreter mode, and against
``torch.autograd`` of the plain forwards in f64; and the autograd
Functions that bind each forward kernel to its backward.

Inputs come from numpy with a fixed seed and go to both packages; ``mu``,
``rstd`` and ``lse`` are the port's plain vectors broadcast to the JAX
kernels' 8-wide layout. Ragged lengths leave partial tiles on both
sides: 37 and 300 for LayerNorm; 197 and 300 for attention, whose JAX
kernel slices 128-row q tiles and cannot trace a length below 128.

Tolerances: f32 1e-5 absolute on outputs of order 1 (the two sides sum in
different orders); dgamma/dbeta sum 600 rows, 1e-4; bf16 attention: 2 ulp
of the largest gradient; f64 against autograd: 1e-10.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geo_deep_learning_tpu.ops.pallas.layernorm as jln
import geo_deep_learning_tpu.ops.pallas.mha as jmha
from geo_deep_learning_tpu_torch.ops.cuda import layernorm as tln
from geo_deep_learning_tpu_torch.ops.cuda import mha as tmha


@pytest.fixture
def interpret(monkeypatch):
    for mod in (jln, jmha):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    jax.clear_caches()  # the JAX kernels are jitted; drop traces of the real mode
    yield
    jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.array(a))


def _wide(v):
    """``[..., L]`` -> the JAX kernels' ``[..., L, 8]``."""
    return jnp.broadcast_to(jnp.asarray(v)[..., None], (*v.shape, 8))


def _ln_case(l, d, seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((2, l, d)) * 2.0 + 0.5).astype(np.float32)
    br = rng.standard_normal((2, l, d)).astype(np.float32)
    dy = rng.standard_normal((2, l, d)).astype(np.float32)
    ds = rng.standard_normal((2, l, d)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, br, dy, ds, gamma, beta


def _close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("l", [37, 300])
@pytest.mark.parametrize("d", [128, 256])
def test_layernorm_bwd_matches_jax(interpret, l, d):
    x, _, dy, _, gamma, beta = _ln_case(l, d)
    _, mu, rstd = tln.layernorm(_t(x), _t(gamma), _t(beta))
    dx, dg, db = tln.layernorm_bwd(_t(x), _t(dy), _t(gamma), mu, rstd)
    jdx, jdg, jdb = jln._bwd(jnp.asarray(x), jnp.asarray(dy), jnp.asarray(gamma),
                             _wide(mu.numpy()), _wide(rstd.numpy()))
    _close(dx, jdx, 1e-5)
    _close(dg, jdg, 1e-4)
    _close(db, jdb, 1e-4)


@pytest.mark.parametrize("l", [37, 300])
@pytest.mark.parametrize("d", [128, 256])
def test_layernorm_residual_bwd_matches_jax(interpret, l, d):
    x, br, dy, ds, gamma, beta = _ln_case(l, d, seed=1)
    s, _, mu, rstd = tln.layernorm_residual(_t(x), _t(br), _t(gamma), _t(beta))
    dx, dg, db = tln.layernorm_residual_bwd(s, _t(dy), _t(ds), _t(gamma), mu, rstd)
    jdx, jdg, jdb = jln._bwd_res(jnp.asarray(s.numpy()), jnp.asarray(dy), jnp.asarray(ds),
                                 jnp.asarray(gamma), _wide(mu.numpy()), _wide(rstd.numpy()))
    _close(dx, jdx, 1e-5)
    _close(dg, jdg, 1e-4)
    _close(db, jdb, 1e-4)


def _attn_case(l, heads, hd, dtype, seed=0):
    rng = np.random.default_rng(seed)
    qkv = _t(rng.standard_normal((2, l, 3 * heads * hd)).astype(np.float32)).to(dtype)
    g = _t(rng.standard_normal((2, l, heads * hd)).astype(np.float32)).to(dtype)
    return qkv, g


@pytest.mark.parametrize("l", [197, 300])
@pytest.mark.parametrize("hd", [32, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_bwd_matches_jax(interpret, l, hd, dtype):
    heads = 128 // hd  # one JAX block of 128 lanes
    qkv, g = _attn_case(l, heads, hd, getattr(torch, dtype))
    scale = 1.0 / math.sqrt(hd)
    o, lse = tmha.attention_packed(qkv, heads, scale)
    got = tmha.attention_bwd_packed(qkv, o, g, lse, heads, scale)
    jt = lambda t: jnp.asarray(t.float().numpy()).astype(dtype)  # noqa: E731
    jdq, jdk, jdv = jmha._bwd_packed(jt(qkv), jt(o), jt(g), _wide(lse.numpy()), heads, scale)
    want = np.concatenate([np.asarray(t, np.float32) for t in (jdq, jdk, jdv)], axis=-1)
    assert got.dtype == qkv.dtype and got.shape == qkv.shape
    if dtype == "float32":
        _close(got, want, 1e-5)
    else:
        # bf16 outputs: rounding of the last bit where the f32 sums differ
        _close(got.float(), want, 2 * 2.0**-7 * float(np.abs(want).max()))


def _f64(*arrays):
    return [_t(a).double().requires_grad_() for a in arrays]


@pytest.mark.parametrize("residual", [False, True])
def test_layernorm_plain_backwards_equal_autograd_f64(residual):
    x, br, dy, ds, gamma, beta = _ln_case(37, 128, seed=2)
    xt, brt, gt, bt = _f64(x, br, gamma, beta)
    dyt, dst = _t(dy).double(), _t(ds).double()
    if residual:
        s, y, mu, rstd = tln.layernorm_residual_reference(xt, brt, gt, bt, 1e-6)
        (s * dst + y * dyt).sum().backward()
        dx, dg, db = tln.layernorm_residual_bwd_reference(s.detach(), dyt, dst, gt, mu, rstd)
        for leaf in (xt, brt):
            torch.testing.assert_close(dx, leaf.grad, atol=1e-10, rtol=0)
    else:
        y, mu, rstd = tln.layernorm_reference(xt, gt, bt, 1e-6)
        (y * dyt).sum().backward()
        dx, dg, db = tln.layernorm_bwd_reference(xt.detach(), dyt, gt, mu, rstd)
        torch.testing.assert_close(dx, xt.grad, atol=1e-10, rtol=0)
    torch.testing.assert_close(dg, gt.grad, atol=1e-10, rtol=0)
    torch.testing.assert_close(db, bt.grad, atol=1e-10, rtol=0)


@pytest.mark.parametrize("hd", [32, 64])
def test_attention_plain_backward_equals_autograd_f64(hd):
    heads = 2
    qkv, g = _attn_case(37, heads, hd, torch.float64, seed=3)
    qkv.requires_grad_()
    scale = 1.0 / math.sqrt(hd)
    o, lse = tmha.attention_reference(qkv, heads, scale)
    (o * g).sum().backward()
    got = tmha.attention_bwd_reference(qkv.detach(), o.detach(), g, lse.detach(), heads, scale)
    torch.testing.assert_close(got, qkv.grad, atol=1e-10, rtol=0)


def test_functions_route_the_backwards():
    """The operators' registered backwards return the plain backwards'
    values; the residual form
    hands one gradient to both inputs; under bf16 autocast-style inputs
    (bf16 activations, f32 parameters) dx comes back in bf16 and
    dgamma/dbeta in f32."""
    x, br, dy, ds, gamma, beta = _ln_case(37, 128, seed=4)
    xt, brt = (_t(a).to(torch.bfloat16).requires_grad_() for a in (x, br))
    gt, bt = (_t(a).requires_grad_() for a in (gamma, beta))
    s, y, _, _ = tln.layernorm_residual(xt, brt, gt, bt, 1e-6)
    (s.float() * _t(ds) + y.float() * _t(dy)).sum().backward()
    assert xt.grad.dtype == torch.bfloat16 and gt.grad.dtype == torch.float32
    assert bt.grad.dtype == torch.float32
    assert torch.equal(xt.grad, brt.grad)
    _, _, mu, rstd = tln.layernorm_residual(xt, brt, gt, bt)
    want = tln.layernorm_residual_bwd(s.detach(), _t(dy).bfloat16(), _t(ds).bfloat16(), gt,
                                      mu, rstd)
    torch.testing.assert_close(xt.grad, want[0], atol=0, rtol=0)
    torch.testing.assert_close(gt.grad, want[1], atol=1e-6, rtol=0)

    qkv, g = _attn_case(37, 2, 64, torch.bfloat16, seed=5)
    qkv.requires_grad_()
    o = tmha.attention(qkv, 2)
    (o.float() * g.float()).sum().backward()
    _, lse = tmha.attention_packed(qkv.detach(), 2)
    want = tmha.attention_bwd_packed(qkv.detach(), o.detach(), g, lse, 2, 1.0 / 8.0)
    assert qkv.grad.dtype == torch.bfloat16
    torch.testing.assert_close(qkv.grad, want, atol=0, rtol=0)


def test_cuda_wrappers_refuse_the_cpu_fallback():
    """On a non-CPU, non-CUDA tensor the wrappers raise; they never hand
    such a tensor to the plain version."""
    x = torch.zeros((1, 8, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tln.layernorm_bwd(x, x, torch.zeros(128, device="meta"), x[..., 0], x[..., 0])
    qkv = torch.zeros((1, 8, 3 * 128), dtype=torch.bfloat16, device="meta")
    o = torch.zeros((1, 8, 128), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tmha.attention_bwd_packed(qkv, o, o, torch.zeros((1, 2, 8), device="meta"), 2, 0.125)
