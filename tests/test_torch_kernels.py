"""The port's kernel wrappers on CPU tensors (their plain versions) against
the JAX package's Pallas kernels in interpreter mode.

Inputs come from numpy with a fixed seed and go to both packages. The JAX
side runs its kernels as its own tests do (``_INTERPRET = True``, set here
through ``monkeypatch``). Tolerances are f32 unless a case says bf16.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geo_deep_learning_tpu.ops.pallas.layernorm as jln
import geo_deep_learning_tpu.ops.pallas.mha as jmha
import geo_deep_learning_tpu.ops.pallas.preprocess as jpp
from geo_deep_learning_tpu_torch.ops.cuda import layernorm as tln
from geo_deep_learning_tpu_torch.ops.cuda import mha as tmha
from geo_deep_learning_tpu_torch.ops.cuda import preprocess as tpp


@pytest.fixture
def interpret(monkeypatch):
    for mod in (jpp, jln, jmha):
        monkeypatch.setattr(mod, "_INTERPRET", True)
    jax.clear_caches()  # the JAX kernels are jitted; drop traces of the real mode
    yield
    jax.clear_caches()


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("shape", [(2, 16, 24, 3), (3, 7, 5, 4)])
def test_preprocess_matches_jax(interpret, shape):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    # stats in the range of the repo's configs: XLA may contract x*k - mean
    # into an FMA, a one-ulp difference that 1/std then amplifies
    mean = rng.uniform(0.38, 0.45, (shape[0], shape[-1])).astype(np.float32)
    std = rng.uniform(0.15, 0.18, (shape[0], shape[-1])).astype(np.float32)
    got = tpp.fused_normalize_standardize(_t(img), _t(mean), _t(std), torch.float32).numpy()
    kernel = jpp._pallas_call(jnp.asarray(img), jnp.asarray(mean), jnp.asarray(std), jnp.float32)
    ref = jpp._jnp_reference(jnp.asarray(img), jnp.asarray(mean), jnp.asarray(std), jnp.float32)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got, np.asarray(ref), atol=1e-6, rtol=0)


def test_preprocess_broadcasts_channel_stats():
    img = np.random.default_rng(1).integers(0, 256, (2, 4, 4, 3), dtype=np.uint8)
    mean, std = [0.405, 0.432, 0.397], [0.165, 0.161, 0.174]
    per_sample = tpp.fused_normalize_standardize(
        _t(img), torch.tensor([mean, mean]), torch.tensor([std, std])
    )
    assert torch.equal(tpp.fused_normalize_standardize(_t(img), mean, std), per_sample)
    out = tpp.fused_normalize_standardize(_t(img), mean, std, torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == img.shape


def _ln_inputs(l, d, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, l, d)).astype(np.float32) * 2.0 + 0.5
    br = rng.standard_normal((2, l, d)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, br, gamma, beta


@pytest.mark.parametrize("l", [37, 300])
@pytest.mark.parametrize("d", [128, 256])
def test_layernorm_matches_jax(interpret, l, d):
    x, _, gamma, beta = _ln_inputs(l, d)
    y, mu, rstd = tln.layernorm(_t(x), _t(gamma), _t(beta), 1e-6)
    jy, jmu, jrs = jln._fwd(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta), 1e-6)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu)[..., 0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrs)[..., 0], atol=1e-5, rtol=0)


@pytest.mark.parametrize("l", [37, 300])
@pytest.mark.parametrize("d", [128, 256])
def test_layernorm_residual_matches_jax(interpret, l, d):
    x, br, gamma, beta = _ln_inputs(l, d, seed=1)
    s, y, mu, rstd = tln.layernorm_residual(_t(x), _t(br), _t(gamma), _t(beta), 1e-6)
    js, jy, jmu, jrs = jln._fwd_res(
        jnp.asarray(x), jnp.asarray(br), jnp.asarray(gamma), jnp.asarray(beta), 1e-6
    )
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=1e-5, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-5, rtol=0)
    np.testing.assert_allclose(mu.numpy(), np.asarray(jmu)[..., 0], atol=1e-5, rtol=0)
    np.testing.assert_allclose(rstd.numpy(), np.asarray(jrs)[..., 0], atol=1e-5, rtol=0)


def _qkv(l, h, hd, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((2, l, 3 * h * hd)).astype(np.float32)


@pytest.mark.parametrize("l", [37, 300])
@pytest.mark.parametrize("hd", [32, 64])
def test_attention_matches_jax(interpret, l, hd):
    h = 128 // hd * 2  # whole groups of the TPU kernel's 128-lane blocks
    qkv = _qkv(l, h, hd)
    scale = 1.0 / np.sqrt(hd)
    o, lse = tmha.attention_packed(_t(qkv), h)
    if l >= jmha._TQ_PACKED:
        jo, jlse = jmha._fwd_packed(jnp.asarray(qkv), h, scale)
        jlse = np.asarray(jlse)[..., 0]
    else:
        # the interpreter cannot trace the TPU kernel's 256-row tile loop
        # below one tile; hold against the JAX package's off-TPU path
        jo = jmha.fused_attention_packed(jnp.asarray(qkv), h, scale)
        q, k, _ = (
            t.reshape(2, l, h, hd).transpose(0, 2, 1, 3)
            for t in jnp.split(jnp.asarray(qkv), 3, axis=-1)
        )
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k, precision="highest") * scale
        jlse = np.asarray(jax.nn.logsumexp(s, axis=-1))
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5, rtol=0)


def test_attention_bf16_matches_jax(interpret):
    h, hd, l = 4, 32, 300
    qkv = jnp.asarray(_qkv(l, h, hd, seed=2)).astype(jnp.bfloat16)
    o, lse = tmha.attention_packed(_t(qkv.astype(jnp.float32)).to(torch.bfloat16), h)
    jo, jlse = jmha._fwd_packed(qkv, h, 1.0 / np.sqrt(hd))
    assert o.dtype == torch.bfloat16
    np.testing.assert_allclose(
        o.float().numpy(), np.asarray(jo.astype(jnp.float32)), atol=2e-2, rtol=0
    )
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=2e-2, rtol=0)


def test_wrappers_reject_bad_inputs_before_any_build():
    """Device, dtype and shape are checked in Python before a CUDA call;
    a tensor on neither the CPU nor a CUDA device is refused."""
    meta = torch.empty((2, 8, 128), device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tln.layernorm(meta, torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        tmha.attention_packed(torch.empty((2, 8, 384), device="meta"), 4)
    with pytest.raises(ValueError, match="mean/std"):
        tpp.fused_normalize_standardize(
            torch.zeros((2, 4, 4, 3), dtype=torch.uint8), [0.1, 0.2], [0.3, 0.4]
        )
