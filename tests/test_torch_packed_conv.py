"""The port's K11 (W-packed 3x3 conv + BN-train statistics) and its column
entry point against the JAX package's, on the CPU.

The JAX kernel runs in interpret mode with a 4-row accumulation strip, as
``tests/test_pallas_packed_conv.py`` runs it; the port's wrapper takes its
plain version for CPU tensors. Inputs are drawn with numpy.

Tolerances: f32 outputs within 1e-5 of the largest |y| (the same f32
products summed in another order); bf16 outputs within one bf16 ulp of the
largest |y| (both round one f32 result); the statistics (sums over 128
pixels) within 1e-5 of the largest of their row. The eight-leg column in
f32 within 1e-4 of its largest output and scale (the legs' BatchNorms
carry f32 rounding forward).
"""

import importlib.util
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geo_deep_learning_tpu.ops.pallas.packed_conv as jpc
from geo_deep_learning_tpu_torch.ops.cuda import packed_conv as tpc
from geo_deep_learning_tpu_torch.tools import bench_column as tbench

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jpc, "_INTERPRET", True)
    monkeypatch.setattr(jpc, "_STRIP", 4)
    jax.clear_caches()
    yield
    jax.clear_caches()


@pytest.fixture
def jbench(interpret):
    """``scripts/bench_pallas_column.py`` as a module (its kernel in
    interpret mode)."""
    spec = importlib.util.spec_from_file_location(
        "bench_pallas_column", ROOT / "scripts" / "bench_pallas_column.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _data(b=2, h=8, w=8, c=64, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, h, w, c)).astype(np.float32)
    k = (rng.normal(size=(3, 3, c, c)) * 0.1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 2 * c).astype(np.float32)
    shift = (rng.normal(size=2 * c) * 0.2).astype(np.float32)
    return x, k, scale, shift


def _tol(want: np.ndarray, dtype: str) -> float:
    top = float(np.abs(want).max())
    return 1e-5 * top if dtype == "float32" else 2.0 ** (math.floor(math.log2(top)) - 7)


def test_packing_matches_jax():
    x, k, _, _ = _data(h=3, w=10)
    np.testing.assert_array_equal(tpc.pack_w_kernel(torch.from_numpy(k)).numpy(),
                                  np.asarray(jpc.pack_w_kernel(jnp.asarray(k))))
    xp = tpc.pack_nhwc(torch.from_numpy(x))
    np.testing.assert_array_equal(xp.numpy(), np.asarray(jpc.pack_nhwc(jnp.asarray(x))))
    assert torch.equal(tpc.unpack_nhwc(xp), torch.from_numpy(x))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("apply_bn_relu", [True, False], ids=["prologue", "plain"])
def test_plain_version_matches_jax_kernel(interpret, dtype, apply_bn_relu):
    x, k, scale, shift = _data()
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jxp = jpc.pack_nhwc(jnp.asarray(x)).astype(jdt)
    jkp = jpc.pack_w_kernel(jnp.asarray(k)).astype(jdt)
    want_y, want_s = jpc.packed_conv_bn_stats(jxp, jkp, jnp.asarray(scale), jnp.asarray(shift),
                                              apply_bn_relu=apply_bn_relu)
    txp = tpc.pack_nhwc(torch.from_numpy(x)).to(tdt)
    tkp = tpc.pack_w_kernel(torch.from_numpy(k)).to(tdt)
    got_y, got_s = tpc.packed_conv_bn_stats(txp, tkp, torch.from_numpy(scale),
                                            torch.from_numpy(shift), apply_bn_relu)
    want_y = np.asarray(want_y.astype(jnp.float32))
    assert got_y.dtype == tdt and got_y.shape == want_y.shape == (2, 8, 4, 128)
    np.testing.assert_allclose(got_y.float().numpy(), want_y, atol=_tol(want_y, dtype), rtol=0)
    assert got_s.dtype == torch.float32 and got_s.shape == (2, 128)
    for got, want in zip(got_s.numpy(), np.asarray(want_s)):
        np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max(), rtol=0)


def test_without_statistics(interpret):
    x, k, scale, shift = _data(seed=1)
    jy, js = jpc.packed_conv_bn_stats(jpc.pack_nhwc(jnp.asarray(x)), jpc.pack_w_kernel(jnp.asarray(k)),
                                      jnp.asarray(scale), jnp.asarray(shift), accumulate_stats=False)
    xp, kp = tpc.pack_nhwc(torch.from_numpy(x)), tpc.pack_w_kernel(torch.from_numpy(k))
    ty, ts = tpc.packed_conv_bn_stats(xp, kp, torch.from_numpy(scale), torch.from_numpy(shift),
                                      accumulate_stats=False)
    assert js is None and ts is None
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), atol=_tol(np.asarray(jy), "float32"), rtol=0)
    assert torch.equal(ty, tpc.packed_conv_bn_stats(xp, kp, torch.from_numpy(scale),
                                                    torch.from_numpy(shift))[0])


def test_halo_is_zero_after_the_prologue():
    """A shift that makes relu(shift) > 0 must not leak into the border: the
    packed conv equals the unpacked conv of the activated input."""
    x, k, scale, _ = _data(b=1, h=5, w=6, seed=2)
    shift = np.full(128, 0.7, np.float32)
    y, _ = tpc.packed_conv_bn_stats(tpc.pack_nhwc(torch.from_numpy(x)),
                                    tpc.pack_w_kernel(torch.from_numpy(k)),
                                    torch.from_numpy(scale), torch.from_numpy(shift))
    act = np.maximum(x.reshape(1, 5, 3, 128) * scale + shift, 0.0).reshape(x.shape)
    want = torch.nn.functional.conv2d(torch.from_numpy(act).permute(0, 3, 1, 2),
                                      torch.from_numpy(k).permute(3, 2, 0, 1), padding=1)
    np.testing.assert_allclose(tpc.unpack_nhwc(y).numpy(), want.permute(0, 2, 3, 1).numpy(),
                               atol=1e-5, rtol=0)


def test_shapes_are_checked():
    x = torch.zeros((1, 4, 4, 64))
    kp = torch.zeros((3, 3, 128, 128))
    with pytest.raises(ValueError, match="packed"):
        tpc.packed_conv_bn_stats(x, kp, torch.ones(128), torch.zeros(128))
    with pytest.raises(ValueError, match="block kernel"):
        tpc.packed_conv_bn_stats(torch.zeros((1, 4, 2, 128)), kp[:, :, :64], torch.ones(128),
                                 torch.zeros(128))


def _column_inputs(seed: int = 3):
    rng = np.random.default_rng(seed)
    n = tbench.N_NODES * tbench.LEGS
    x = rng.normal(size=(2, 8, 8, 64)).astype(np.float32)
    ks = (rng.normal(size=(n, 3, 3, 64, 64)) * 0.05).astype(np.float32)
    gammas = rng.uniform(0.5, 1.5, (n, 64)).astype(np.float32)
    betas = (rng.normal(size=(n, 64)) * 0.1).astype(np.float32)
    return x, ks, gammas, betas


def _close(got, want, rel: float) -> None:
    want = np.asarray(want, np.float32)
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=rel * float(np.abs(want).max()), rtol=0)


def test_column_matches_jax(jbench):
    """``column_kernel`` (K11's plain version) against ``column_pallas`` (the
    JAX kernel, interpreted) and ``column_torch`` against ``column_xla``, in
    f32: outputs and the last leg's scale and shift."""
    x, ks, gammas, betas = _column_inputs()
    kps = np.stack([np.asarray(jpc.pack_w_kernel(jnp.asarray(k))) for k in ks])
    jargs = [jnp.asarray(a) for a in (x, ks, gammas, betas)]
    targs = [torch.from_numpy(a) for a in (x, ks, gammas, betas)]
    want_k = jbench.column_pallas(jargs[0], jnp.asarray(kps), *jargs[2:])
    got_k = tbench.column_kernel(targs[0], torch.from_numpy(kps), *targs[2:])
    want_t = jbench.column_xla(*jargs)
    got_t = tbench.column_torch(*targs)
    for got, want in ((got_k, want_k), (got_t, want_t)):
        for g, w in zip(got, want):
            _close(g, w, 1e-4)
    _close(got_k[0], want_t[0], 1e-4)  # the two forms agree in f32


def test_finalize_packed_stats_matches_jax(jbench):
    rng = np.random.default_rng(4)
    stats = rng.uniform(1.0, 5.0, (2, 128)).astype(np.float32) * np.asarray([[1.0], [3.0]], np.float32)
    gamma = rng.uniform(0.5, 1.5, 64).astype(np.float32)
    beta = rng.normal(size=64).astype(np.float32)
    want = jbench.finalize_packed_stats(jnp.asarray(stats), 4, jnp.asarray(gamma), jnp.asarray(beta))
    got = tbench.finalize_packed_stats(torch.from_numpy(stats), 4, torch.from_numpy(gamma),
                                       torch.from_numpy(beta))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-6)


def test_bench_column_entry_point_on_the_cpu(capsys):
    """The entry point with the JAX script's inputs (``default_rng(0)``) at a
    tiny size on the CPU: finite times, the two columns within the card's
    5e-2 limit, one warm-up and 3 x iters kernel-column calls."""
    x, ks, kps, gammas, betas = tbench.inputs(1, 8, torch.device("cpu"))
    rng = np.random.default_rng(0)
    assert torch.equal(x, torch.from_numpy(rng.normal(size=(1, 8, 8, 64)).astype(np.float32)).bfloat16())
    assert kps.shape == (8, 3, 3, 128, 128) and kps.dtype == torch.bfloat16
    result = tbench.main(["--device", "cpu", "--batch", "1", "--size", "8", "--iters", "1"])
    assert result["kernel_calls"] == 4 and result["device"] == "cpu"
    assert result["rel_err"] < 5e-2
    assert all(math.isfinite(result[k]) for k in ("torch_ms", "kernel_ms", "bound_ms"))
    assert "rel-err" in capsys.readouterr().out
