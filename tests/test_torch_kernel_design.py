"""The arithmetic and the data structure the Hopper designs of K1, K2/K3,
K4/K8, K5/K6, K10 and K11 rest on, held on the CPU against the JAX package.

- K11 skips the 64 x 64 blocks of the packed kernel that hold no non-zero
  value. ``pack_w_kernel`` (port and JAX, the same numpy weights) must put
  zeros in exactly the 18 blocks the skip leaves out for a block-structured
  kernel, and non-zeros in the other 18; :func:`block_flags` (the plain
  version of the kernel's pre-pass) must flag exactly those, and any other
  structure too.
- K10's bf16 instance runs p v as two bf16 products, p split into
  ``hi = bf16(p)`` and ``lo = bf16(p - hi)``, with an online softmax over
  128-key chunks in exp2. Emulated in f32 on the CPU, that arithmetic must
  agree with the plain version (f32) and the JAX ``_einsum_attention`` (f32
  inputs) within 1/16 of one bf16 ulp of the largest |o|: the split costs
  far less than the one ulp the card's check allows.
- K4/K8 (one device code) run an online softmax over chunks of 128 keys
  (64 at head dim 128) in exp2, ``scale * log2 e`` folded into one FMA,
  keys at or past L masked to -inf in the last chunk; ``p`` is cast to
  bf16 once, against the running max, before ``P.V``; ``o`` is rescaled by
  ``alpha`` per chunk, divided by the f32 row sum and rounded to bf16 once;
  lse comes back from log2 units. Emulated on the CPU, that arithmetic
  must agree with the plain version and with the JAX ``_fwd`` (Pallas
  interpreter) on inputs padded to its 256-row tile with ``valid``: ``o``
  within one bf16 ulp of the largest |o| (both sides round an f32 result
  once), lse within 1e-5, or four f32 ulps of the largest |lse| where that
  is more: inputs x 4 reach |lse| = 85, where f32 resolves 7.6e-6, and
  every f32 lse (plain, JAX, emulated) is a score's f32 dot product plus
  two or three roundings away from the exact value (each measured up to
  1.3e-5 from an f64 reference there).
- K2/K3 (one device code) reduce a row per warp: lane l sums its 16-byte
  vectors l, l + 32, ... in order, the lane sums meet in a butterfly, and the
  statistics take JAX's fast variance ``max(E[x^2] - fl(mu mu), 0)``. On
  rows with |mean| >> std built so that every sum is exact (width 256,
  values 1024 or 1032, and their negatives), that variance is decided by
  the rounding of ``mu mu`` alone, so the emulated kernel, the plain
  version and JAX's ``_fwd``/``_fwd_res`` (Pallas interpreter) must agree
  to f32 rounding (rstd within 2 f32 ulps, JAX's rsqrt; y within 8 ulps of
  the largest |y|), while the exact variance, which a two-pass or fused
  multiply-add form would give, misses by over a hundred times that.
- K5/K6 keep per-lane dgamma/dbeta accumulators over tiles of R rows (warp
  w of a block takes rows w, w + 16, ... of each of its tiles at width 768;
  block b the tiles b, b + P, ...), sum a block's warps in warp order, then
  the blocks of each group of 16 in block order and the groups in group
  order. Emulated in f32 that order must agree with the plain version and
  JAX's ``_bwd``/``_bwd_res`` at 1, 74 (fewer rows than blocks), 5188 and
  10376 (DOFA's own; both past the 132 blocks of one an SM, with a partial
  last tile) rows: dx 1e-5, dgamma/dbeta 1e-3 (sums of order 100 taken in
  other orders).
- K1 walks tiles of one sample each (block p: tiles p, p + P, ...; the
  card's grid at DOFA's batch, and one block taking every tile), takes a
  vector's channels from the thread's phase (C = 3), channel 0 (C = 4) or
  the vector's offset (other C), and on unaligned samples bytes from the
  thread's phase; emulated in f32 it must write every element once and
  equal the plain version bit for bit and the JAX ``_jnp_reference`` and
  ``_pallas_call`` (Pallas interpreter) within 1e-6. Its 1/std, an IEEE
  reciprocal in the kernel, must equal ``np.float32(1) / std``,
  ``torch.reciprocal`` and the plain ``1.0 / std`` bit for bit on the
  repo's statistics.
"""

import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import geo_deep_learning_tpu.ops.pallas.layernorm as jln
import geo_deep_learning_tpu.ops.pallas.mha as jmha
import geo_deep_learning_tpu.ops.pallas.packed_conv as jpc
import geo_deep_learning_tpu.ops.pallas.preprocess as jpp
import geo_deep_learning_tpu.ops.pallas.sr_attention as jsra
from geo_deep_learning_tpu_torch.ops.cuda import layernorm as tln
from geo_deep_learning_tpu_torch.ops.cuda import mha as tmha
from geo_deep_learning_tpu_torch.ops.cuda import packed_conv as tpc
from geo_deep_learning_tpu_torch.ops.cuda import preprocess as tpp
from geo_deep_learning_tpu_torch.ops.cuda import sr_attention as tsra


def _structured_blocks() -> np.ndarray:
    """[3, 3, 2, 2] over (dh, dw, in-slot, out-slot): the blocks of
    pack_w_kernel that hold the unpacked kernel (dw = 1 all four; dw = 0
    in-slot 1 -> out-slot 0; dw = 2 in-slot 0 -> out-slot 1)."""
    want = np.zeros((3, 3, 2, 2), bool)
    want[:, 1] = True
    want[:, 0, 1, 0] = True
    want[:, 2, 0, 1] = True
    return want


def _blocks_nonzero(kp: np.ndarray) -> np.ndarray:
    return (kp.reshape(3, 3, 2, 64, 2, 64) != 0).any(axis=(3, 5))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_w_kernel_blocks_are_those_k11_takes(seed):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(3, 3, 64, 64)).astype(np.float32)
    tkp = tpc.pack_w_kernel(torch.from_numpy(k))
    jkp = np.asarray(jpc.pack_w_kernel(jnp.asarray(k)))
    want = _structured_blocks()
    assert int(want.sum()) == 18
    np.testing.assert_array_equal(_blocks_nonzero(jkp), want)
    np.testing.assert_array_equal(_blocks_nonzero(tkp.numpy()), want)
    np.testing.assert_array_equal(tpc.block_flags(tkp).numpy(), want)
    # a skipped block is zero in every entry, so leaving it out is exact
    skipped = ~want[:, :, :, None, :, None].repeat(64, 3).repeat(64, 5).reshape(3, 3, 128, 128)
    assert not jkp[skipped].any() and not tkp.numpy()[skipped].any()


@pytest.mark.parametrize("kind", ["dense", "single", "zero", "negative zero"])
def test_block_flags_of_other_kernels(kind):
    """The pre-pass flags a block for any non-zero entry, a NaN included;
    -0 is a zero."""
    rng = np.random.default_rng(3)
    kp = np.zeros((3, 3, 128, 128), np.float32)
    want = np.zeros((3, 3, 2, 2), bool)
    if kind == "dense":
        kp = rng.normal(size=kp.shape).astype(np.float32)
        want[:] = True
    elif kind == "single":
        kp = np.asarray(jpc.pack_w_kernel(jnp.asarray(rng.normal(size=(3, 3, 64, 64)).astype(np.float32))))
        kp = kp.copy()
        kp[0, 0, 5, 7] = np.nan
        want = _structured_blocks()
        want[0, 0, 0, 0] = True
    elif kind == "negative zero":
        kp[1, 2, 70, 3] = -0.0
    got = tpc.block_flags(torch.from_numpy(kp).bfloat16())
    assert got.dtype == torch.bool and got.shape == (3, 3, 2, 2)
    np.testing.assert_array_equal(got.numpy(), want)


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.bfloat16().float()


def hilo_attention(q, k, v, scale: float, chunk: int = 128) -> torch.Tensor:
    """K10's bf16 arithmetic in f32: per 128-key chunk, s = q k^T, keys past
    Lk at -inf, m = max(m, rowmax(s) * scale log2 e), alpha = exp2(m_old -
    m), p = exp2(s * scale log2 e - m); l = l alpha + rowsum(p) and o = o
    alpha + bf16(p) v + bf16(p - bf16(p)) v (v exact in bf16); o / l."""
    log2e = 1.4426950408889634
    b, h, lq, _ = q.shape
    lk = k.shape[2]
    c = scale * log2e
    m = torch.full((b, h, lq, 1), -math.inf)
    l = torch.zeros((b, h, lq, 1))
    o = torch.zeros(q.shape)
    for k0 in range(0, lk, chunk):
        s = torch.matmul(q, k[:, :, k0:k0 + chunk].transpose(-1, -2))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new)
        hi = _bf16(p)
        lo = _bf16(p - hi)
        vc = v[:, :, k0:k0 + chunk]
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(hi, vc) + torch.matmul(lo, vc)
        m = m_new
    return o / l


# (b, h, Lq, Lk, d): MiT-like stages cut to size (a stage-1 head over one
# 256-key chunk pair, a stage-2 pair of heads, head dim 64) and ragged Lk
# (the last chunk part past Lk)
HILO_SHAPES = [(2, 1, 512, 256, 32), (2, 2, 256, 256, 32), (1, 2, 256, 256, 64),
               (2, 1, 128, 300, 32), (1, 1, 64, 12, 64)]


@pytest.mark.parametrize("b,h,lq,lk,d", HILO_SHAPES)
def test_k10_hilo_split_against_plain_and_jax(b, h, lq, lk, d):
    rng = np.random.default_rng(lq + lk + d)
    # bf16 inputs, as the kernel receives them, held in f32
    q, k, v = (_bf16(torch.from_numpy(rng.normal(size=s).astype(np.float32)))
               for s in ((b, h, lq, d), (b, h, lk, d), (b, h, lk, d)))
    scale = d**-0.5
    got = hilo_attention(q, k, v, scale)
    plain = tsra.sr_attention_plain(q, k, v, scale)
    jax_o = torch.from_numpy(np.array(jsra._einsum_attention(
        jnp.asarray(q.numpy()), jnp.asarray(k.numpy()), jnp.asarray(v.numpy()), scale)))
    ulp = 2.0 ** (math.floor(math.log2(float(plain.abs().max()))) - 7)
    for want in (plain, jax_o):
        err = float((got - want).abs().max())
        assert err <= ulp / 16, f"{err} above {ulp / 16}"


def wgmma_forward(q, k, v, scale: float, valid: int):
    """K4/K8's arithmetic in f32 on bf16 inputs ``[B, H, L, hd]``: chunks of
    the kernel's width over the first ``valid`` keys, the last one's keys at
    or past ``valid`` at -inf; s = q k^T, m = max(m, rowmax(s) * c) with c =
    scale log2 e, alpha = exp2(m_old - m), p = exp2(s c - m); l = l alpha +
    rowsum(p), o = o alpha + bf16(p) v; returns (bf16(o / l), m ln 2 + ln l)."""
    c = scale * 1.4426950408889634
    chunk = 64 if q.shape[-1] == 128 else 128
    m = torch.full((*q.shape[:3], 1), -math.inf)
    l = torch.zeros_like(m)
    o = torch.zeros(q.shape)
    for k0 in range(0, valid, chunk):
        s = torch.matmul(q, k[:, :, k0:k0 + chunk].transpose(-1, -2))
        s = s.masked_fill(torch.arange(k0, k0 + s.shape[-1]) >= valid, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(torch.addcmul(-m_new, s, torch.tensor(c)))
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(_bf16(p), v[:, :, k0:k0 + chunk])
        m = m_new
    return (o / l).bfloat16(), (m * math.log(2.0) + torch.log(l))[..., 0]


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jmha, "_INTERPRET", True)
    monkeypatch.setattr(jln, "_INTERPRET", True)
    monkeypatch.setattr(jpp, "_INTERPRET", True)
    jax.clear_caches()  # the JAX kernels are jitted; drop traces of the real mode
    yield
    jax.clear_caches()


# (L, head dim, case): ragged last chunks at every head dim (5 and 37 keys
# in one chunk, 300 = 2 x 128 + 44 = 4 x 64 + 44, 1297 = 10 x 128 + 17 =
# 20 x 64 + 17, DOFA-base's token count at 512^2), then equal scores (q = 0:
# p = 1 on every key) and inputs x 4 (rows with a large lse)
WGMMA_CASES = [(l, hd, "plain") for l in (5, 37, 300, 1297) for hd in (32, 64, 128)] + [
    (l, hd, case) for case in ("equal scores", "inputs x4") for l, hd in ((300, 64), (37, 128))]


@pytest.mark.parametrize("l,hd,case", WGMMA_CASES)
def test_k4_k8_wgmma_arithmetic_against_plain_and_jax(interpret, l, hd, case):
    rng = np.random.default_rng(l + hd)
    lp = jmha._pad_len(l)
    x = rng.standard_normal((3, 1, 2, l, hd)).astype(np.float32)
    if case == "equal scores":
        x[0] = 0
    if case == "inputs x4":
        x *= 4
    x = np.pad(x, ((0, 0), (0, 0), (0, 0), (0, lp - l), (0, 0)))
    q, k, v = (torch.from_numpy(t).bfloat16() for t in x)
    scale = 1.0 / math.sqrt(hd)
    got_o, got_lse = wgmma_forward(q.float(), k.float(), v.float(), scale, l)
    plain_o, plain_lse = tmha.attention_hm_reference(q, k, v, scale, valid=l)
    jo, jlse = jmha._fwd(*(jnp.asarray(t, jnp.bfloat16) for t in x), scale, l)
    jax_o = torch.from_numpy(np.array(jo.astype(jnp.float32)))
    jax_lse = torch.from_numpy(np.array(jlse)[..., 0])
    ulp = 2.0 ** (math.floor(math.log2(float(plain_o.float().abs().max()))) - 7)
    lse_tol = max(1e-5, 4 * 2.0 ** (math.floor(math.log2(float(plain_lse.abs().max()))) - 23))
    for name, want_o, want_lse in (("plain", plain_o, plain_lse), ("jax", jax_o, jax_lse)):
        err = float((got_o[:, :, :l].float() - want_o[:, :, :l].float()).abs().max())
        assert err <= ulp, f"o against {name}: {err} above one ulp {ulp}"
        err = float((got_lse[:, :, :l] - want_lse[:, :, :l]).abs().max())
        assert err <= lse_tol, f"lse against {name}: {err} above {lse_tol}"


LN_WARPS = 16  # consumer warps of a backward block at width 768
LN_GROUP = 16  # blocks whose partials one block sums
LN_BLOCKS = 132  # the backward's resident blocks at width 768 on an H100: one an SM


def _row_sum(v: torch.Tensor, vec: int) -> torch.Tensor:
    """A warp's sum of each row of ``v`` ``[rows, d]``: lane l adds its
    vectors l, l + 32, ... element by element, then a butterfly (xor 16,
    8, 4, 2, 1) over the 32 lane sums."""
    rows, d = v.shape
    nv = -(-d // (32 * vec))
    lanes = torch.nn.functional.pad(v, (0, nv * 32 * vec - d)).view(rows, nv, 32, vec)
    acc = torch.zeros(rows, 32)
    for i in range(nv):
        for j in range(vec):
            acc = acc + lanes[:, i, :, j]
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[:, torch.arange(32) ^ o]
    return acc[:, 0]


def ln_fwd_emulated(s, gamma, beta, eps: float, vec: int = 8):
    """K2/K3's statistics and output in f32 on the (unrounded) rows ``s``:
    mu = sum / d, var = max(E[s^2] - fl(mu mu), 0), rstd = 1 / sqrt(var +
    eps), y = ((s - mu) rstd) gamma + beta."""
    d = s.shape[-1]
    mu = _row_sum(s, vec) / d
    var = torch.clamp(_row_sum(s * s, vec) / d - mu * mu, min=0.0)
    rstd = 1.0 / torch.sqrt(var + eps)
    return ((s - mu[:, None]) * rstd[:, None]) * gamma + beta, mu, rstd


def ln_bwd_emulated(x, dy, gamma, mu, rstd, ds=None, *, tile_rows: int, blocks: int,
                    vec: int = 8):
    """K5/K6 in f32 on ``[rows, d]``: dx row by row (warp sums of a and a
    xhat), and dgamma/dbeta in the kernel's order: the rows of tile t go to
    block t % P (P = min(tiles, blocks)), row r of a tile to warp r % 16,
    each warp accumulating its rows in order; the warps summed in warp
    order, the blocks of each group of 16 in block order, the groups in
    group order. Returns ``(dx, dgamma, dbeta)``."""
    rows, d = x.shape
    xh = (x - mu[:, None]) * rstd[:, None]
    a = dy * gamma
    t1 = _row_sum(a, vec)[:, None] / d
    t2 = _row_sum(a * xh, vec)[:, None] / d
    dx = rstd[:, None] * (a - t1 - xh * t2)
    if ds is not None:
        dx = dx + ds
    tiles = -(-rows // tile_rows)
    p = min(tiles, blocks)
    r = torch.arange(rows)
    tile, within = r // tile_rows, r % tile_rows
    block, warp = tile % p, within % LN_WARPS
    step = (tile // p) * -(-tile_rows // LN_WARPS) + within // LN_WARPS
    sums = []
    for term in (dy * xh, dy):
        acc = torch.zeros(p, LN_WARPS, d)
        for st in range(int(step.max()) + 1):
            sel = step == st
            acc[block[sel], warp[sel]] = acc[block[sel], warp[sel]] + term[sel]
        part = torch.zeros(p, d)
        for w in range(LN_WARPS):
            part = part + acc[:, w]
        total = torch.zeros(d)
        for g0 in range(0, p, LN_GROUP):
            group = torch.zeros(d)
            for b in range(g0, min(g0 + LN_GROUP, p)):
                group = group + part[b]
            total = total + group
        sums.append(total)
    return dx, sums[0], sums[1]


def _grid_rows(rng, mean: float, d: int = 256) -> np.ndarray:
    """Rows of ``mean`` with n values raised by 8 (n from 0 to 255): every
    sum, square sum and mean is exact in f32 at width 256."""
    rows = []
    for n in (0, 1, 3, 8, 24, 40, 100, 128, 200, 255):
        r = np.full(d, mean, np.float32)
        r[rng.choice(d, n, replace=False)] += 8.0
        rows.append(r)
    return np.stack(rows)


@pytest.mark.parametrize("residual", [False, True])
def test_layernorm_fast_variance_against_plain_and_jax(interpret, residual):
    rng = np.random.default_rng(7)
    d, eps = 256, 1e-6
    s = np.concatenate([_grid_rows(rng, 1024.0), -_grid_rows(rng, 1024.0)])[None]
    gamma = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(d)).astype(np.float32)
    # K3: s = x + branch with small integers in the branch, exact in f32
    br = rng.integers(-2, 3, s.shape).astype(np.float32) if residual else np.zeros_like(s)
    x = s - br
    y, mu, rstd = ln_fwd_emulated(torch.from_numpy(s[0]), torch.from_numpy(gamma),
                                  torch.from_numpy(beta), eps)
    g, b = torch.from_numpy(gamma), torch.from_numpy(beta)
    if residual:
        _, py, pmu, prstd = tln.layernorm_residual_reference(torch.from_numpy(x),
                                                             torch.from_numpy(br), g, b, eps)
        _, jy, jmu, jrstd = jln._fwd_res(*(jnp.asarray(t) for t in (x, br, gamma, beta)), eps)
    else:
        py, pmu, prstd = tln.layernorm_reference(torch.from_numpy(x), g, b, eps)
        jy, jmu, jrstd = jln._fwd(*(jnp.asarray(t) for t in (x, gamma, beta)), eps)
    y_tol = 8 * 2.0 ** (math.floor(math.log2(float(y.abs().max()))) - 23)
    for name, wy, wmu, wrstd in (("plain", py[0], pmu[0], prstd[0]),
                                 ("jax", _t(jy)[0], _t(jmu)[0, :, 0], _t(jrstd)[0, :, 0])):
        assert torch.equal(mu, wmu), f"mu against {name}"
        rel = float((rstd / wrstd - 1).abs().max())
        assert rel <= 2 * 2.0**-23, f"rstd against {name}: {rel}"
        err = float((y - wy).abs().max())
        assert err <= y_tol, f"y against {name}: {err} above {y_tol}"
    # the exact variance (two-pass, or E[s^2] - mu^2 in one fused
    # multiply-add) is a different result on these rows
    exact = torch.from_numpy(s[0]).double().var(dim=-1, unbiased=False)
    y_exact = ((torch.from_numpy(s[0]).double() - mu[:, None].double())
               / torch.sqrt(exact + eps)[:, None]) * g.double() + b.double()
    assert float((y_exact - py[0].double()).abs().max()) > 100 * y_tol


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _wide(v: torch.Tensor):
    """``[B, L]`` -> the JAX kernels' ``[B, L, 8]``."""
    return jnp.broadcast_to(jnp.asarray(v.numpy())[..., None], (*v.shape, 8))


# (B, L): one row; 74 rows, fewer than the blocks, in 5 tiles with a partial
# last one; 5188 and 10376 rows (DOFA-base at 512^2, bs 4 and 8): more
# tiles than blocks, the last partial
LN_BWD_ROWS = [(1, 1), (2, 37), (4, 1297), (8, 1297)]


@pytest.mark.parametrize("b,l", LN_BWD_ROWS)
@pytest.mark.parametrize("residual", [False, True])
def test_layernorm_bwd_order_against_plain_and_jax(interpret, b, l, residual):
    rng = np.random.default_rng(b * l)
    d = 768
    # bf16-exact inputs, as the kernels receive them on DOFA's path, held in f32
    x, dy, ds = (torch.from_numpy(rng.standard_normal((b, l, d)).astype(np.float32))
                 .bfloat16().float() for _ in range(3))
    x = x * 2.0 + 0.5
    gamma = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32))
    _, mu, rstd = tln.layernorm_reference(x, gamma, torch.zeros_like(gamma))
    tile_rows, _ = tln.ring_shape(d, 2, 3 if residual else 2, backward=True)
    got = ln_bwd_emulated(x.view(-1, d), dy.view(-1, d), gamma, mu.view(-1), rstd.view(-1),
                          ds.view(-1, d) if residual else None, tile_rows=tile_rows,
                          blocks=LN_BLOCKS)
    jargs = (jnp.asarray(x.numpy()), jnp.asarray(dy.numpy()))
    if residual:
        plain = tln.layernorm_residual_bwd_reference(x, dy, ds, gamma, mu, rstd)
        jax_out = jln._bwd_res(*jargs, jnp.asarray(ds.numpy()), jnp.asarray(gamma.numpy()),
                               _wide(mu), _wide(rstd))
    else:
        plain = tln.layernorm_bwd_reference(x, dy, gamma, mu, rstd)
        jax_out = jln._bwd(*jargs, jnp.asarray(gamma.numpy()), _wide(mu), _wide(rstd))
    for name, want in (("plain", plain), ("jax", [_t(t) for t in jax_out])):
        err = float((got[0] - want[0].reshape(-1, d)).abs().max())
        assert err <= 1e-5, f"dx against {name}: {err}"
        for what, g, w in zip(("dgamma", "dbeta"), got[1:], want[1:]):
            err = float((g - w).abs().max())
            assert err <= 1e-3, f"{what} against {name}: {err}"


# K1's grid at DOFA's batch [8,512,512,3] on the H100: min(1024 tiles,
# 132 SMs x 4 resident blocks), as the profiler's trace of chip_smoke.py
# shows it; its consumer threads a block, and its tile (the kernel's
# compile-time constant)
K1_GRID_H100 = 528
K1_CONSUMERS = 256
K1_TILE_BYTES = int(re.search(
    r"constexpr int PP_TILE_BYTES = (\d+);",
    (Path(tpp.__file__).resolve().parents[2] / "csrc" / "preprocess.cu").read_text()).group(1))
K1_SHAPES = [(8, 512, 512, 3), (3, 37, 41, 3), (2, 9, 7, 5), (2, 16, 24, 4), (2, 16, 16, 5)]


def k1_tile_walk(batch: int, n: int, blocks: int, tile_bytes: int):
    """K1's tiles in the order its blocks take them: block p takes tiles p,
    p + blocks, ...; tile t is sample t // tps at byte offset (t % tps) *
    tile_bytes, the last tile of a sample shorter. Yields ``(block, sample,
    offset, bytes)``."""
    tps = -(-n // tile_bytes)
    for p in range(blocks):
        for t in range(p, batch * tps, blocks):
            b, i = divmod(t, tps)
            off = i * tile_bytes
            yield p, b, off, min(tile_bytes, n - off)


def k1_emulated(img: np.ndarray, mean: np.ndarray, std: np.ndarray, blocks: int,
                tile_bytes: int, out_bytes: int) -> tuple[np.ndarray, np.ndarray]:
    """K1's walk in f32 (:func:`k1_tile_walk`). On the bulk-copy path (n %
    16 == 0) a tile starts at channel 0, and thread i takes its output
    vectors v = i + 256 r of E = 16 / out_bytes inputs each: for C = 3 at
    the thread's phase (E i) % 3
    plus r (E 256 % 3), for C = 4 at channel 0, for any other C at the
    vector's (off + E v) % C; on the generic path thread i takes bytes i,
    i + 256, ... from channel (off + i) % C, stepping 256 % C. x / 255 on
    the bulk-copy path is one fused multiply-add on the float 2^23 + x,
    which must equal the plain product. Returns the outputs and how often
    each was written."""
    b, c = img.shape[0], img.shape[-1]
    flat = img.reshape(b, -1)
    n = flat.shape[1]
    inv = np.float32(1) / std  # __frcp_rn
    out = np.zeros((b, n), np.float32)
    writes = np.zeros((b, n), np.int32)
    k255 = np.float32(1) / np.float32(255)
    threads = K1_CONSUMERS
    for _, s, off, size in k1_tile_walk(b, n, blocks, tile_bytes):
        if n % 16 == 0:
            e = 16 // out_bytes
            assert off % 48 == 0 and size % e == 0
            v = np.arange(size // e)
            j = np.arange(e)
            i, r = v % threads, v // threads
            if c == 3:  # stats rotated to the thread's phase, then register (r step + j) % 3
                ch = ((e * i)[:, None] % 3 + (r * (e * threads % 3))[:, None] + j) % 3
            elif c == 4:
                ch = np.broadcast_to(j % 4, (len(v), e))
            else:
                ch = ((off + e * v)[:, None] % c + j) % c
            pos = (e * v[:, None] + j).ravel()
            ch = ch.ravel()
        else:
            pos = np.arange(size)
            i, q = pos % threads, pos // threads
            ch = ((off + i) % c + q * (threads % c)) % c
        assert np.array_equal(ch, (off + pos) % c), "a channel off its element"
        x = flat[s, off + pos].astype(np.float32)
        if n % 16 == 0:  # the byte permute's 2^23 + x and one fused multiply-add, in f64 exactly
            f = (x + np.float32(2**23)).astype(np.float64)
            xk = (f * np.float64(k255) - np.float64(np.float32(2**23) * k255)).astype(np.float32)
            assert np.array_equal(xk, x * k255)
        else:
            xk = x * k255
        out[s, off + pos] = (xk - mean[s, ch]) * inv[s, ch]
        writes[s, off + pos] += 1
    return out.reshape(img.shape), writes


@pytest.mark.parametrize("shape", K1_SHAPES)
@pytest.mark.parametrize("grid", ["card", "one block"])
def test_k1_tile_walk_against_plain_and_jax(interpret, shape, grid):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape, dtype=np.uint8)
    b, c = shape[0], shape[-1]
    mean = rng.uniform(0.38, 0.45, (b, c)).astype(np.float32)
    std = rng.uniform(0.15, 0.18, (b, c)).astype(np.float32)
    n = img[0].size
    # one block takes every tile, crossing samples and their short last tiles
    blocks = min(b * -(-n // K1_TILE_BYTES), K1_GRID_H100) if grid == "card" else 1
    m, inv = tpp._stats(torch.from_numpy(mean), torch.from_numpy(std), torch.from_numpy(img))
    plain = tpp.normalize_reference(torch.from_numpy(img), m, inv, torch.float32).numpy()
    jargs = (jnp.asarray(img), jnp.asarray(mean), jnp.asarray(std))
    for out_bytes in (2, 4):  # the bf16 and f32 instances' vectors, arithmetic in f32
        got, writes = k1_emulated(img, mean, std, blocks, K1_TILE_BYTES, out_bytes)
        assert writes.min() == 1 and writes.max() == 1, "an element written other than once"
        assert np.array_equal(got, plain), "the plain version differs"
        for name, want in (("jnp", jpp._jnp_reference(*jargs, jnp.float32)),
                           ("pallas", jpp._pallas_call(*jargs, jnp.float32))):
            err = float(np.abs(got - np.asarray(want)).max())
            assert err <= 1e-6, f"against the JAX {name}: {err}"


def _repo_stds() -> list[list[float]]:
    """The std vectors of the port's configs, and the datasets' default."""
    import yaml

    root = Path(tpp.__file__).resolve().parents[2] / "configs"
    stds = [yaml.safe_load(f.read_text())["data"]["init_args"]["std"]
            for f in sorted(root.glob("*.yaml"))]
    assert stds, "no config found"
    return [*stds, [1.0]]


@pytest.mark.parametrize("std", _repo_stds() + [list(np.random.default_rng(0).uniform(0.15, 0.18, 64))])
def test_k1_reciprocal_is_plain_one_over_std(std):
    """The kernel forms 1/std with an IEEE round-to-nearest reciprocal: bit
    for bit the plain version's ``1.0 / std``, which also rests on it."""
    s32 = np.asarray(std, np.float32)
    t = torch.from_numpy(s32)
    want = (np.float32(1) / s32).view(np.uint32)
    assert np.array_equal(torch.reciprocal(t).numpy().view(np.uint32), want)
    assert np.array_equal((1.0 / t).numpy().view(np.uint32), want)
    assert np.array_equal(tpp._stats(t, t, torch.zeros((1, 1, 1, len(std)), dtype=torch.uint8))[1][0]
                          .numpy().view(np.uint32), want)
