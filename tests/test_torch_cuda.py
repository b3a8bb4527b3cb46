"""The port's CUDA kernels against their plain versions, on the card,
a train step's launch counts, the factored resize + conv in bf16 against
the plain f32 composition, and the threaded loader and the worker
processes feeding the card.

Marked ``cuda``; each test skips where no CUDA device is present. On the
machine with the card::

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

(``--noconftest``: the suite's conftest imports JAX, which that machine
does not have.)
"""

import math

import numpy as np
import pytest
import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib
from geo_deep_learning_tpu_torch.ops.cuda import layernorm as LN
from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA
from geo_deep_learning_tpu_torch.ops.cuda import packed_conv as PC
from geo_deep_learning_tpu_torch.ops.cuda import preprocess as PP
from geo_deep_learning_tpu_torch.ops.cuda import sr_attention as SR

pytestmark = pytest.mark.cuda

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# f32: the kernels repeat the plain arithmetic up to summation order;
# bf16: one or two units in the last place of outputs below 4 in magnitude
LN_TOL = {"bfloat16": 3.2e-2, "float32": 1e-5}


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


# K1: DOFA's 512^2 and 640^2 batches (both more tiles than the card holds
# blocks: each block takes several), the 4-band batch, a sample size
# that is no multiple of 16 (n = 4551: the generic path), a generic
# channel count (C = 5, n = 315; and n = 1280 on the bulk-copy path), 40
# samples of two whole tiles (n = 12288), C = 3 samples whose last tile is
# short (n = 13824 = 2 x 6144 + 1536; the 4-band samples end short too),
# and C = 4 at n = 252
PP_SHAPES = [(8, 512, 512, 3), (8, 640, 640, 3), (8, 512, 512, 4), (3, 37, 41, 3),
             (2, 9, 7, 5), (40, 64, 64, 3), (4, 32, 144, 3), (2, 9, 7, 4), (2, 16, 16, 5)]
PP_TOL = {"bfloat16": 1.6e-2, "float32": 1e-6}


def _pp_inputs(gen, shape, per_sample: bool):
    img = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
    rows = shape[0] if per_sample else 1
    mean = torch.rand((rows, shape[-1]), generator=gen, device="cuda") * 0.1 + 0.38
    std = torch.rand((rows, shape[-1]), generator=gen, device="cuda") * 0.03 + 0.15
    return img, (mean if per_sample else mean[0]), (std if per_sample else std[0])


def _pp_check(img, mean, std, dtype):
    got = PP.fused_normalize_standardize(img, mean, std, DTYPES[dtype])
    m, inv = PP._stats(mean, std, img)
    want = PP.normalize_reference(img, m, inv, DTYPES[dtype])
    torch.testing.assert_close(got.float(), want.float(), atol=PP_TOL[dtype], rtol=0)
    assert torch.equal(got, PP.fused_normalize_standardize(img, mean, std, DTYPES[dtype]))


@pytest.mark.parametrize("shape", PP_SHAPES)
@pytest.mark.parametrize("stats", ["[C]", "[B,C]"])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_preprocess(gen, shape, stats, dtype):
    _pp_check(*_pp_inputs(gen, shape, stats == "[B,C]"), dtype)


@pytest.mark.parametrize("shape", [(8, 64, 64, 3), (2, 16, 16, 4)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_preprocess_offset_view(gen, shape, dtype):
    """An image view one byte past an aligned base takes the generic path."""
    img, mean, std = _pp_inputs(gen, shape, True)
    view = torch.empty(img.numel() + 1, dtype=torch.uint8, device="cuda")[1:].view(shape)
    view.copy_(img)
    assert view.data_ptr() % 16 == 1
    _pp_check(view, mean, std, dtype)


PROFILED_CALLS = 3
# host time in the profiler session before the first launch and after the
# last synchronize: the profiler keeps a device record only if its
# timestamps, converted to the host clock, fall inside the session, and a
# kernel launched at the session's very start can land just outside it
PROFILE_MARGIN_S = 0.05


@pytest.mark.parametrize("shape", [(8, 512, 512, 3), (3, 37, 41, 3), (8, 512, 512, 4), (2, 9, 7, 5)])
@pytest.mark.parametrize("stats", ["[C]", "[B,C]"])
def test_preprocess_is_one_launch(gen, shape, stats):
    """A call on the card runs one CUDA kernel, K1, and nothing before it,
    on either path and any channel count: PROFILED_CALLS calls in one
    session record exactly that many K1 kernels and no other event."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    img, mean, std = _pp_inputs(gen, shape, stats == "[B,C]")
    PP.fused_normalize_standardize(img, mean, std, torch.bfloat16)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        time.sleep(PROFILE_MARGIN_S)
        for _ in range(PROFILED_CALLS):
            PP.fused_normalize_standardize(img, mean, std, torch.bfloat16)
        torch.cuda.synchronize()
        time.sleep(PROFILE_MARGIN_S)
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == PROFILED_CALLS and all("preprocess_kernel" in n for n in names), names


# row counts that leave a partial last tile of the kernels' ring (2594, 394,
# 111 and 1500 rows) and one row, at widths 128 to 1024
LN_SHAPES = [(2, 1297, 768), (2, 197, 768), (3, 37, 128), (1, 1, 768), (3, 37, 256),
             (5, 300, 256), (2, 197, 1024), (1, 1, 1024)]


@pytest.mark.parametrize("shape", LN_SHAPES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layernorms(gen, shape, dtype):
    dt = DTYPES[dtype]
    x = torch.randn(shape, generator=gen, device="cuda").to(dt)
    br = torch.randn(shape, generator=gen, device="cuda").to(dt)
    d = shape[-1]
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
    for got, want in (
        (LN.layernorm(x, gamma, beta), LN.layernorm_reference(x, gamma, beta)),
        (LN.layernorm_residual(x, br, gamma, beta),
         LN.layernorm_residual_reference(x, br, gamma, beta)),
    ):
        for g, w in zip(got, want):
            torch.testing.assert_close(g.float(), w.float(), atol=LN_TOL[dtype], rtol=0)


def _ulp(want: torch.Tensor) -> float:
    """One bf16 ulp of the largest |value| of ``want`` (0 where it is all
    zero): the kernels and the plain versions round one f32 result each."""
    top = float(want.float().abs().max())
    return 2.0 ** (math.floor(math.log2(top)) - 7) if top > 0 else 0.0


# ragged last key chunks of the forward (1297 = 10 x 128 + 17, 197, 37 and
# 5 keys in one chunk, 300 = 4 x 64 + 44 at head dim 128), then at DOFA's
# 1297 tokens a head of equal scores (q = 0) and inputs x 4 (rows with a
# large lse)
FWD_CASES = [(2, 1297, 12, 64, "plain"), (2, 197, 12, 64, "plain"), (2, 37, 4, 32, "plain"),
             (1, 300, 2, 128, "plain"), (2, 5, 3, 64, "plain"), (2, 1297, 12, 64, "equal scores"),
             (2, 1297, 12, 64, "inputs x4")]


def _fwd_inputs(gen, shape, case):
    x = torch.randn(shape, generator=gen, device="cuda").bfloat16()
    if case == "inputs x4":
        x *= 4
    return x


@pytest.mark.parametrize("b,l,h,hd,case", FWD_CASES)
def test_attention(gen, b, l, h, hd, case):
    """K4 against its plain version: o to one bf16 ulp of its largest |o|,
    lse 1e-4; two runs equal (every output written by one thread)."""
    qkv = _fwd_inputs(gen, (b, l, 3 * h * hd), case)
    if case == "equal scores":
        qkv[..., : h * hd] = 0
    o, lse = MHA.attention_packed(qkv, h)
    wo, wlse = MHA.attention_reference(qkv, h, 1.0 / math.sqrt(hd))
    torch.testing.assert_close(o.float(), wo.float(), atol=_ulp(wo), rtol=0)
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=0)
    again = MHA.attention_packed(qkv, h)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


def test_attention_refuses_f32(gen):
    """float32 takes the f32 instance (test_attention_f32); other dtypes
    are refused."""
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="bfloat16 or float32"):
            MHA.attention_packed(torch.zeros((1, 8, 3 * 64), dtype=dtype, device="cuda"), 1)


def test_tiny_model_launch_counts(gen, monkeypatch):
    """A 5-block model with taps (1, 2, 3, 4): K2 at blocks 0, 2, 3, 4; K3
    at block 1's norm1 and every norm2; K4 per block; K1 once per step."""
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.models.encoders import dofa
    from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
    from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
    from geo_deep_learning_tpu_torch.training.steps import make_predict_step
    from geo_deep_learning_tpu_torch.training.task import SegmentationTask

    monkeypatch.setitem(dofa.dofa_configs, "tiny", dofa.DOFAConfig(
        embed_dim=128, depth=5, num_heads=2, out_indices=(1, 2, 3, 4)))
    model = DOFASegmentation("tiny", num_classes=1, decoder_channels=32, img_size=64).cuda()
    model.init_weights(gen)
    task = SegmentationTask(model.eval(), DiceLoss(mode="binary"),
                            default_wavelengths=[0.665, 0.549, 0.481])
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)).cuda(),
        "mean": torch.tensor([0.405, 0.432, 0.397], device="cuda"),
        "std": torch.tensor([0.165, 0.161, 0.174], device="cuda"),
    }
    _lib.reset_launches()
    out = make_predict_step(task, PrecisionPolicy.create("bf16-mixed"))(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(out["probs"]).all()
    assert dict(_lib.LAUNCHES) == {
        "preprocess": 1, "layernorm_fwd": 4, "layernorm_residual_fwd": 6,
        "attention_fwd_packed": 5,
    }


@pytest.mark.parametrize("shape", [(2, 1297, 768), (3, 300, 256), (3, 37, 128), (1, 1, 768),
                                   (2, 197, 1024), (1, 1, 256), (3, 37, 1024)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_layernorm_backwards(gen, shape, dtype):
    """K5 and K6 against their plain versions; dgamma/dbeta sum up to 2594
    rows in another order (f32, 1e-3 on sums of order 100)."""
    dt = DTYPES[dtype]
    x, dy, ds = (torch.randn(shape, generator=gen, device="cuda").to(dt) for _ in range(3))
    d = shape[-1]
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    _, mu, rstd = LN.layernorm(x, gamma, torch.zeros_like(gamma))
    for got, want in (
        (LN.layernorm_bwd(x, dy, gamma, mu, rstd), LN.layernorm_bwd_reference(x, dy, gamma, mu, rstd)),
        (LN.layernorm_residual_bwd(x, dy, ds, gamma, mu, rstd),
         LN.layernorm_residual_bwd_reference(x, dy, ds, gamma, mu, rstd)),
    ):
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=LN_TOL[dtype], rtol=0)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, atol=1e-3, rtol=0)


def test_layernorm_widths_of_one_instance(gen):
    """Widths 256 and 128 in bf16 share a compiled instance (one vector a
    lane) with rings of different shared memory: after the smaller ring,
    the larger one still launches and is right, forward and backward."""
    for d in (256, 128, 256):
        x, dy = (torch.randn((3, 37, d), generator=gen, device="cuda").bfloat16() for _ in range(2))
        gamma = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
        beta = 0.1 * torch.randn(d, generator=gen, device="cuda")
        y, mu, rstd = LN.layernorm(x, gamma, beta)
        want = LN.layernorm_reference(x, gamma, beta)
        torch.testing.assert_close(y.float(), want[0].float(), atol=LN_TOL["bfloat16"], rtol=0)
        got = LN.layernorm_bwd(x, dy, gamma, mu, rstd)
        want = LN.layernorm_bwd_reference(x, dy, gamma, mu, rstd)
        torch.testing.assert_close(got[0].float(), want[0].float(), atol=LN_TOL["bfloat16"], rtol=0)
        for g, w in zip(got[1:], want[1:]):
            torch.testing.assert_close(g, w, atol=1e-3, rtol=0)


def test_layernorm_backward_counter(gen):
    """The backward's cached tickets: three K6 calls in a row give equal
    dgamma/dbeta (each call's last block resets the counters), a fourth at
    another row count (another grid) is still right, a fifth on a second
    stream takes that stream's own counters and gives the first call's
    sums, and every counter is left zero."""
    d = 768
    s, dy, ds = (torch.randn((8, 1297, d), generator=gen, device="cuda").bfloat16()
                 for _ in range(3))
    gamma = 1 + 0.1 * torch.randn(d, generator=gen, device="cuda")
    _, mu, rstd = LN.layernorm(s, gamma, torch.zeros_like(gamma))
    first, *again = (LN.layernorm_residual_bwd(s, dy, ds, gamma, mu, rstd) for _ in range(3))
    for other in again:
        assert all(torch.equal(a, b) for a, b in zip(first, other))
    part = (s[:1, :300].contiguous(), dy[:1, :300].contiguous(), ds[:1, :300].contiguous())
    got = LN.layernorm_residual_bwd(*part, gamma, mu[:1, :300].contiguous(),
                                    rstd[:1, :300].contiguous())
    want = LN.layernorm_residual_bwd_reference(*part, gamma, mu[:1, :300], rstd[:1, :300])
    torch.testing.assert_close(got[0].float(), want[0].float(), atol=LN_TOL["bfloat16"], rtol=0)
    for g, w in zip(got[1:], want[1:]):
        torch.testing.assert_close(g, w, atol=1e-3, rtol=0)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        other = LN.layernorm_residual_bwd(s, dy, ds, gamma, mu, rstd)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, other))
    n = LN._workspace(s.device.index, d, True, True)[3]
    counters = [LN._counters(s.device.index, st, n)
                for st in (torch.cuda.current_stream().cuda_stream, side.cuda_stream)]
    assert counters[0].data_ptr() != counters[1].data_ptr()
    assert not any(c.any() for c in counters)


# the backward's cases: L at every tile edge of the dK/dV and dQ kernels
# (64-row streamed tiles, 128-row blocks), DOFA-base's 1297 (512^2) and
# 2026 (640^2) and the head-major band's end (2304); head dims 32 and 128;
# a head of equal scores (q = 0: dk is all zero) and inputs x 4 (rows with a
# large lse)
BWD_CASES = [(2, 4, l, 64, 1.0, False) for l in (1, 63, 64, 65, 127, 128, 129)] + [
    (2, 12, 1297, 64, 1.0, False), (2, 12, 2026, 64, 1.0, False), (1, 12, 2304, 64, 1.0, False),
    (2, 4, 129, 32, 1.0, False), (2, 4, 1297, 32, 1.0, False),
    (2, 2, 129, 128, 1.0, False), (1, 2, 2026, 128, 1.0, False),
    (2, 12, 1297, 64, 1.0, True), (2, 12, 2026, 64, 4.0, False),
]


@pytest.mark.parametrize("b,h,l,hd,amp,zero_q", BWD_CASES)
def test_attention_backward(gen, b, h, l, hd, amp, zero_q):
    """K7 against its plain version, dq, dk and dv (the three column
    sections of dqkv) each to one bf16 ulp of its own largest |value| and
    exactly where that is zero (at L = 1, dq and dk are f32 rounding on
    both sides and are held below 2^-16); K9 on the head slices of the same
    packed tensors equals K7 bit for bit (the same device code on other
    strides); two runs equal (no atomics)."""
    qkv = torch.randn((b, l, 3 * h * hd), generator=gen, device="cuda").bfloat16() * amp
    if zero_q:
        qkv[..., : h * hd] = 0
    g = torch.randn((b, l, h * hd), generator=gen, device="cuda").bfloat16()
    scale = 1.0 / math.sqrt(hd)
    o, lse = MHA.attention_packed(qkv, h, scale)
    got = MHA.attention_bwd_packed(qkv, o, g, lse, h, scale)
    want = MHA.attention_bwd_reference(qkv, o, g, lse, h, scale)
    for name, a, w in zip("qkv", got.chunk(3, dim=-1), want.chunk(3, dim=-1)):
        if l == 1 and name != "v":
            # one key: p is identically 1 and ds = p (g v^T - rowsum(g o))
            # is zero but for the f32 rounding of two sums taken in another
            # order on each side, so dq and dk are that rounding, near 1e-7
            assert max(float(t.float().abs().max()) for t in (a, w)) <= 2.0**-16
        else:
            torch.testing.assert_close(a.float(), w.float(), atol=_ulp(w), rtol=0)
    assert torch.equal(got, MHA.attention_bwd_packed(qkv, o, g, lse, h, scale))
    assert torch.equal(MHA.attention_hm_bwd(qkv, o, g, lse, h, scale), got)


HM_SHAPES = [(2, 12, 2026, 64), (1, 12, 1601, 64), (1, 12, 2304, 64), (2, 3, 300, 32),
             (1, 2, 300, 128), (1, 1, 5, 64)]


@pytest.mark.parametrize("b,h,l,hd,case", [(*shape, "plain") for shape in HM_SHAPES] + [
    (2, 12, 2026, 64, "equal scores"), (2, 12, 2026, 64, "inputs x4")])
def test_attention_head_major(gen, b, h, l, hd, case):
    """K8 on the head slices of a packed tensor against its plain version,
    at its shapes (2026 = 15 x 128 + 106 keys) and at DOFA's 640^2 on a head
    of equal scores and on inputs x 4: o to one bf16 ulp of the largest
    |o| (both round one f32 result), lse 1e-4; two runs equal."""
    qkv = _fwd_inputs(gen, (b, l, 3 * h * hd), case)
    if case == "equal scores":
        qkv[..., : h * hd] = 0
    o, lse = MHA.attention_hm(qkv, h)
    wo, wlse = MHA.attention_reference(qkv, h, 1.0 / math.sqrt(hd))
    torch.testing.assert_close(o.float(), wo.float(), atol=_ulp(wo), rtol=0)
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=0)
    again = MHA.attention_hm(qkv, h)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


def test_attention_head_major_refusals(gen):
    qkv = torch.zeros((1, 8, 3 * 2 * 64), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        MHA.attention_hm(qkv.half(), 2)
    with pytest.raises(ValueError, match="width"):
        MHA.attention_hm(qkv[..., :-8].contiguous(), 2)
    with pytest.raises(ValueError, match="head dim"):
        MHA.attention_hm(torch.zeros((1, 8, 3 * 2 * 48), dtype=torch.bfloat16, device="cuda"), 2)
    wide = torch.zeros((1, 8, 3 * 2 * 64 + 4), dtype=torch.bfloat16, device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        MHA.attention_hm(wide[..., : 3 * 2 * 64], 2)
    o, lse = MHA.attention_hm(qkv, 2)
    with pytest.raises(ValueError, match="lse must be"):
        MHA.attention_hm_bwd(qkv, o, o, lse[:, :1], 2, 0.125)
    with pytest.raises(RuntimeError, match="failed to launch"):  # the row maxima need scale > 0
        MHA.attention_hm(qkv, 2, scale=-0.125)


@pytest.mark.parametrize("l", [2026, 300])
def test_attention_head_major_on_packed_views(gen, l):
    """K8 on the head slices of a packed QKV tensor, as the attention route
    gives them, writes its slices of o in place and equals K4 on the same
    tensor bit for bit (the same device code and arithmetic on other
    strides); the backward's bits: test_attention_backward."""
    h = 12
    qkv = torch.randn((2, l, 3 * h * 64), generator=gen, device="cuda").bfloat16()
    o, lse = MHA.attention_hm(qkv, h, 0.125)
    want_o, want_lse = MHA.attention_packed(qkv, h, 0.125)
    assert torch.equal(o, want_o) and torch.equal(lse, want_lse)


def test_attention_routes_launch_their_kernels(gen):
    """The dispatch at DOFA-base's heads: 1297 tokens launch K4 (and K7 in
    the backward), 2026 launch K8 (and K9), nothing else."""
    for l, fwd, bwd in ((1297, "attention_fwd_packed", "attention_bwd_packed"),
                        (2026, "attention_fwd_hm", "attention_bwd_hm")):
        qkv = torch.randn((1, l, 3 * 768), generator=gen, device="cuda").bfloat16().requires_grad_()
        _lib.reset_launches()
        o = MHA.attention(qkv, 12)
        o.backward(torch.ones_like(o))
        torch.cuda.synchronize()
        assert dict(_lib.LAUNCHES) == {fwd: 1, bwd: 1}
        assert qkv.grad.shape == qkv.shape and torch.isfinite(qkv.grad.float()).all()


def test_tiny_model_train_step_launch_counts(gen, monkeypatch):
    """One train step of the 5-block model: the forward's counts plus K5
    per K2, K6 per K3 and K7 per K4; with the encoder frozen, no K5-K7."""
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.models.encoders import dofa
    from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
    from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.steps import make_train_step
    from geo_deep_learning_tpu_torch.training.task import SegmentationTask

    monkeypatch.setitem(dofa.dofa_configs, "tiny", dofa.DOFAConfig(
        embed_dim=128, depth=5, num_heads=2, out_indices=(1, 2, 3, 4)))
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)).cuda(),
        "mask": torch.from_numpy(rng.integers(0, 2, (2, 64, 64))).cuda(),
        "mean": torch.tensor([0.405, 0.432, 0.397], device="cuda"),
        "std": torch.tensor([0.165, 0.161, 0.174], device="cuda"),
    }
    forward = {"preprocess": 1, "layernorm_fwd": 4, "layernorm_residual_fwd": 6,
               "attention_fwd_packed": 5}
    backward = {"layernorm_bwd": 4, "layernorm_residual_bwd": 6, "attention_bwd_packed": 5}
    for frozen in (None, ["encoder"]):
        model = DOFASegmentation("tiny", num_classes=1, decoder_channels=32, img_size=64).cuda()
        model.init_weights(gen)
        optim.freeze(model, frozen)
        task = SegmentationTask(model, DiceLoss(mode="binary"),
                                default_wavelengths=[0.665, 0.549, 0.481])
        opt = optim.build_optimizer([p for p in model.parameters() if p.requires_grad], "adam")
        state = TrainState.create(model, opt, seed=0)
        step = make_train_step(task, PrecisionPolicy.create("bf16-mixed"))
        _lib.reset_launches()
        out = step(state, batch)
        torch.cuda.synchronize()
        assert torch.isfinite(out["loss"])
        assert dict(_lib.LAUNCHES) == (forward if frozen else {**forward, **backward})


def test_checkpoint_round_trip_on_the_card(gen, tmp_path):
    """A train state saved from the card restores onto the card: weights,
    optimizer moments, step and both generators (whose states must come
    back as CPU byte tensors)."""
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.checkpoint import CheckpointManager

    def state():
        model = torch.nn.Sequential(torch.nn.Linear(4, 3)).cuda()
        return TrainState.create(model, optim.build_optimizer(model.parameters(), "adam"), seed=0)

    a = state()
    a.model(torch.randn((2, 4), generator=gen, device="cuda")).sum().backward()
    a.optimizer.step()
    a.step = 5
    torch.rand(3, generator=a.dropout_generator, device="cuda")
    path = CheckpointManager(tmp_path).save_last(a)
    b = CheckpointManager.restore(path, state())
    assert b.step == 5
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(a.optimizer.state[p]["exp_avg"], b.optimizer.state[q]["exp_avg"])
    assert torch.equal(torch.rand(3, generator=a.dropout_generator, device="cuda"),
                       torch.rand(3, generator=b.dropout_generator, device="cuda"))
    assert torch.equal(a.aug_generator.get_state(), b.aug_generator.get_state())


# Lq 1000 (not a multiple of the bf16 kernel's 64-row q tile) over short,
# odd and long KV, where the K/V chunks are resident (Lk <= 1024 at D 32,
# <= 512 at D 64) and where they stream as a ring (Lk 1000 at D 64, 1500
# at D 32); Lq 192 gives a block of one q tile, whose other consumers walk
# the ring idle
SR_RAGGED = ([(2, 3, 1000, lk, 64) for lk in (1, 12, 65, 256, 1000)]
             + [(2, 3, 1000, lk, 32) for lk in (1, 12, 65, 256, 1000)]
             + [(1, 1, 192, 1000, 64), (1, 1, 192, 1500, 32)])


@pytest.mark.parametrize("b,h,lq,lk,d", [(8, 1, 16384, 256, 32), (8, 2, 4096, 256, 32),
                                         (8, 5, 1024, 256, 32), (8, 1, 16384, 256, 64),
                                         (2, 3, 1536, 1000, 32), (1, 2, 512, 12, 64),
                                         *SR_RAGGED])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sr_attention(gen, b, h, lq, lk, d, dtype):
    """K10 against its plain version on q/k/v laid out as SegFormer makes
    them (views of [B, L, H, D] and [B, Lk, 2, H, D]), at the mit_b0 path
    shapes, the b1-b5 head dim and ragged lengths: f32 to 1e-5, bf16 to
    one ulp of the largest |o| (both round one f32 result); deterministic."""
    dt = DTYPES[dtype]
    q = torch.randn((b, lq, h, d), generator=gen, device="cuda").to(dt).transpose(1, 2)
    kv = torch.randn((b, lk, 2, h, d), generator=gen, device="cuda").to(dt)
    k, v = kv[:, :, 0].transpose(1, 2), kv[:, :, 1].transpose(1, 2)
    want = SR.sr_attention_plain(q, k, v, d**-0.5)
    got = SR.sr_attention_fwd(q, k, v, d**-0.5)
    top = float(want.float().abs().max())
    tol = 1e-5 if dtype == "float32" else 2.0 ** (math.floor(math.log2(top)) - 7)
    assert got.dtype == dt and got.shape == (b, h, lq, d)
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    assert torch.equal(got, SR.sr_attention_fwd(q, k, v, d**-0.5))


def test_sr_attention_refuses_other_head_dims(gen):
    q = torch.zeros((1, 1, 512, 16), device="cuda")
    with pytest.raises(ValueError, match="head dim"):
        SR.sr_attention_fwd(q, q[:, :, :8], q[:, :, :8], 0.25)


def test_sr_attention_refuses_unaligned_rows(gen):
    """A view whose rows do not start on 16 bytes raises; it is not copied."""
    buf = torch.zeros((1, 1, 512, 40), device="cuda")
    q = buf[..., 1:33]
    with pytest.raises(ValueError, match="16-byte aligned rows"):
        SR.sr_attention_fwd(q, q[:, :, :8], q[:, :, :8], 0.25)


def test_sr_attention_fn_card_against_cpu(gen):
    """``gdl::sr_attention_fwd``: K10 forward and the torch-math registered
    backward on the card against the same operator on CPU copies (plain
    version), bf16."""
    q, k, v = (torch.randn(s, generator=gen, device="cuda").bfloat16()
               for s in ((2, 2, 1024, 32), (2, 2, 64, 32), (2, 2, 64, 32)))
    g = torch.randn(q.shape, generator=gen, device="cuda").bfloat16()
    outs = []
    for device in ("cuda", "cpu"):
        leaves = [t.detach().to(device).requires_grad_() for t in (q, k, v)]
        o = SR.sr_attention(*leaves, 32**-0.5)
        o.backward(g.to(device))
        outs.append([o.detach().cpu()] + [t.grad.cpu() for t in leaves])
    for got, want in zip(*outs):
        torch.testing.assert_close(got.float(), want.float(), atol=1.6e-2, rtol=0)


def test_segformer_batch_launch_counts(gen):
    """SegFormer mit_b0 at full width on a bs-2 512^2 batch: K10 in both
    blocks of stages 1-3 (Lq 16384, 4096, 1024 over Lk 256), the einsum at
    stage 4 (Lq 256), K1 once, no DOFA kernel. A train step launches the
    same (K10's backward is torch math)."""
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.models.segmentation.segformer import SegFormer
    from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.steps import make_predict_step, make_train_step
    from geo_deep_learning_tpu_torch.training.task import SegmentationTask

    model = SegFormer("mit_b0", num_classes=1).cuda()
    model.init_weights(gen)
    task = SegmentationTask(model, DiceLoss(mode="binary"))
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.integers(0, 256, (2, 512, 512, 3), dtype=np.uint8)).cuda(),
        "mask": torch.from_numpy(rng.integers(0, 2, (2, 512, 512))).cuda(),
        "mean": torch.tensor([0.405, 0.432, 0.397], device="cuda"),
        "std": torch.tensor([0.165, 0.161, 0.174], device="cuda"),
    }
    want = {"preprocess": 1, "sr_attention_fwd": 6}
    _lib.reset_launches()
    out = make_predict_step(task, PrecisionPolicy.create("bf16-mixed"))(batch)
    torch.cuda.synchronize()
    assert torch.isfinite(out["probs"]).all() and out["probs"].shape == (2, 1, 512, 512)
    assert dict(_lib.LAUNCHES) == want
    opt = optim.build_optimizer(list(model.parameters()), "adam")
    step = make_train_step(task, PrecisionPolicy.create("bf16-mixed"))
    _lib.reset_launches()
    assert torch.isfinite(step(TrainState.create(model, opt, seed=0), batch)["loss"])
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == want


def _packed_inputs(gen, b, h, wp, kind="structured"):
    """x, kp, scale, shift; kp is pack_w_kernel's ("structured"), or has no
    all-zero 64 x 64 block ("dense"), or is the structured kp plus one entry
    in a block that is zero there ("single": dh 0, dw 0, in-slot 0 ->
    out-slot 0), or all zero ("zero")."""
    x = torch.randn((b, h, wp, 128), generator=gen, device="cuda").to(torch.bfloat16)
    k = 0.05 * torch.randn((3, 3, 64, 64), generator=gen, device="cuda")
    kp = PC.pack_w_kernel(k)
    if kind == "dense":
        kp = 0.05 * torch.randn((3, 3, 128, 128), generator=gen, device="cuda")
    elif kind == "single":
        kp[0, 0, 5, 7] = 0.25
    elif kind == "zero":
        kp = torch.zeros_like(kp)
    scale = 0.5 + torch.rand(128, generator=gen, device="cuda")
    shift = 0.2 * torch.randn(128, generator=gen, device="cuda")
    return x, kp.to(torch.bfloat16), scale, shift


@pytest.mark.parametrize("b,h,wp", [(32, 256, 128), (2, 37, 45), (3, 9, 33), (1, 1, 1)])
@pytest.mark.parametrize("kind", ["structured", "dense", "single", "zero"])
@pytest.mark.parametrize("apply_bn_relu", [True, False], ids=["prologue", "plain"])
def test_packed_conv(gen, b, h, wp, kind, apply_bn_relu):
    """K11 against its plain version at the UNet++ column shape and ragged
    ones (H not a multiple of the 4-row tile, Wp not of the 16-column one),
    for block kernels of every structure (K11 multiplies exactly the 64 x
    64 blocks that hold a non-zero, streaming them when more than 18):
    bf16 y within one bf16 ulp of the largest |y| (both round one f32
    result; exactly where it is all zero), f32 statistics within 1e-5 of
    the largest of their row (sums over up to 1M pixels in another order),
    deterministic."""
    x, kp, scale, shift = _packed_inputs(gen, b, h, wp, kind)
    y, stats = PC.packed_conv_bn_stats(x, kp, scale, shift, apply_bn_relu)
    wy, wstats = PC.packed_conv_bn_stats_plain(x, kp, scale, shift, apply_bn_relu)
    assert y.dtype == torch.bfloat16 and y.shape == x.shape and stats.dtype == torch.float32
    torch.testing.assert_close(y.float(), wy.float(), atol=_ulp(wy), rtol=0)
    for got, want in zip(stats, wstats):
        torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    y2, stats2 = PC.packed_conv_bn_stats(x, kp, scale, shift, apply_bn_relu)
    assert torch.equal(y, y2) and torch.equal(stats, stats2)
    y3, none = PC.packed_conv_bn_stats(x, kp, scale, shift, apply_bn_relu, accumulate_stats=False)
    assert none is None and torch.equal(y, y3)


def test_packed_conv_launch_counts_and_refusals(gen):
    x, kp, scale, shift = _packed_inputs(gen, 2, 8, 4)
    _lib.reset_launches()
    PC.packed_conv_bn_stats(x, kp, scale, shift)
    PC.packed_conv_bn_stats(x, kp, scale, shift, accumulate_stats=False)
    assert dict(_lib.LAUNCHES) == {"packed_conv_bn_stats": 2}
    with pytest.raises(ValueError, match="bfloat16"):
        PC.packed_conv_bn_stats(x.float(), kp, scale, shift)
    with pytest.raises(ValueError, match="packed"):
        PC.packed_conv_bn_stats(x[..., :64], kp, scale, shift)


def test_bench_column_kernel_against_cudnn(gen):
    """The kernel column (eight K11 legs) against the cuDNN column at a
    reduced batch: relative error below 5e-2 (the columns round the
    statistics at different places, and eight BatchNorm-normalised legs
    carry bf16 differences forward), eight launches per column."""
    from geo_deep_learning_tpu_torch.tools import bench_column as BC

    x, ks, kps, gammas, betas = BC.inputs(4, 256, torch.device("cuda"))
    _lib.reset_launches()
    yk, _, _ = BC.column_kernel(x, kps, gammas, betas)
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == {"packed_conv_bn_stats": 8}
    yt, _, _ = BC.column_torch(x, ks, gammas, betas)
    assert torch.isfinite(yk.float()).all() and BC.relative_error(yk, yt) < 5e-2


# the factored resize + 3x3 conv at narrow DOFA-like shapes: the neck's x4
# and x2 branches and UperNet's parts into the finest level
FACTORED_CASES = [((2, 96, 16, 16), 64, 4), ((2, 96, 16, 16), 64, 2), ((2, 64, 8, 8), 32, 8),
                  ((2, 64, 16, 16), 32, 2)]


@pytest.mark.parametrize("shape,cout,ratio", FACTORED_CASES)
def test_factored_resize_conv_bf16_against_plain_f32(gen, shape, cout, ratio):
    """The factored form under bf16 autocast, forward and input/weight
    gradients, against the plain resize + conv in f32 on the card, within
    2e-2 of each reference's largest magnitude (bf16 rounds ``x K``, the
    half-contracted map and the output)."""
    from geo_deep_learning_tpu_torch.ops import fused_upconv as FU

    x = torch.randn(shape, generator=gen, device="cuda").to(memory_format=torch.channels_last)
    w = torch.randn((cout, shape[1], 3, 3), generator=gen, device="cuda") / shape[1] ** 0.5
    b = torch.randn(cout, generator=gen, device="cuda")
    size = (ratio * shape[2], ratio * shape[3])
    g = torch.randn((shape[0], cout, *size), generator=gen, device="cuda")
    outs = []
    for factored in (True, False):
        xi, wi, bi = (t.detach().clone().requires_grad_() for t in (x, w, b))
        with torch.autocast("cuda", torch.bfloat16, enabled=factored):
            fn = FU.resize_conv3x3_factored if factored else FU.reference
            y = fn(xi, wi, bi, size)
        (y.float() * g).sum().backward()
        outs.append((y.float(), xi.grad, wi.grad, bi.grad))
    assert outs[0][0].dtype == torch.float32 and outs[0][0].shape == outs[1][0].shape
    for got, want in zip(*outs):
        torch.testing.assert_close(got, want, atol=2e-2 * float(want.abs().max()), rtol=0)


def test_threaded_loader_feeds_the_card_and_leaves_no_thread(gen, tmp_path):
    """The CSV datamodule's 8 reader threads into ``to_device``: every batch
    lands on the card, and after a full pass and after an early stop no
    reader thread is left."""
    import threading
    import time

    from geo_deep_learning_tpu_torch.data import loader
    from geo_deep_learning_tpu_torch.data.datamodule import CSVDataModule
    from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
    from geo_deep_learning_tpu_torch.training.steps import to_device

    rng = np.random.default_rng(0)
    rows = []
    for kind in ("image", "label"):
        (tmp_path / "tst" / kind).mkdir(parents=True)
    for i in range(21):
        write_geotiff(tmp_path / "tst" / "image" / f"{i}.tif",
                      rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        write_geotiff(tmp_path / "tst" / "label" / f"{i}_lbl.tif",
                      rng.integers(0, 2, (64, 64), dtype=np.uint8))
        rows.append(f"tst/image/{i}.tif;tst/label/{i}_lbl.tif")
    (tmp_path / "tst.csv").write_text("\n".join(rows) + "\n")
    data = CSVDataModule(str(tmp_path), str(tmp_path), batch_size=4, device_preprocess=True)
    data.setup("test")

    def leftover():
        end = time.monotonic() + 5.0
        while time.monotonic() < end:
            alive = [t for t in threading.enumerate() if t.name.startswith(loader.THREAD_PREFIX)]
            if not alive:
                return []
            time.sleep(0.01)
        return alive

    batches = [to_device(b, torch.device("cuda")) for b in data.test_dataloader()]
    assert [b["valid_count"] for b in batches] == [4, 4, 4, 4, 4, 1]
    assert all(b["image"].is_cuda and b["image"].dtype == torch.uint8 for b in batches)
    assert leftover() == []
    for b in data.test_dataloader():
        to_device(b, torch.device("cuda"))
        break
    assert leftover() == []


def test_worker_processes_feed_the_card_pinned_and_leave_nothing(gen, tmp_path):
    """``GrainCSVDataModule`` with the card as the run's device: pinned
    batches from 2 spawned workers, copied without blocking, equal to the
    threaded module's on the card; after ``close()`` no worker process and
    no pin-memory thread is left."""
    import multiprocessing
    import threading
    import time

    from geo_deep_learning_tpu_torch.data.datamodule import CSVDataModule
    from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
    from geo_deep_learning_tpu_torch.data.grain_pipeline import GrainCSVDataModule
    from geo_deep_learning_tpu_torch.training.steps import to_device

    rng = np.random.default_rng(0)
    rows = []
    (tmp_path / "tst").mkdir()
    for i in range(21):
        write_geotiff(tmp_path / "tst" / f"{i}.tif", rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
        write_geotiff(tmp_path / "tst" / f"{i}_lbl.tif", rng.integers(0, 2, (64, 64), dtype=np.uint8))
        rows.append(f"tst/{i}.tif;tst/{i}_lbl.tif")
    (tmp_path / "tst.csv").write_text("\n".join(rows) + "\n")
    kw = {"batch_size": 4, "num_workers": 2, "device_preprocess": True}
    threads = CSVDataModule(str(tmp_path), str(tmp_path), **kw)
    procs = GrainCSVDataModule(str(tmp_path), str(tmp_path), **kw)
    procs.set_device("cuda")
    for dm in (threads, procs):
        dm.setup("test")
    cuda = torch.device("cuda")

    def pin_threads():
        return [t for t in threading.enumerate()
                if getattr(getattr(t, "_target", None), "__name__", "") == "_pin_memory_loop"]

    try:
        host = list(procs.test_dataloader())
        assert all(b["image"].is_pinned() and b["mask"].is_pinned() for b in host)
        got = [to_device(b, cuda) for b in host]
        torch.cuda.synchronize()
        want = [to_device(b, cuda) for b in threads.test_dataloader()]
        assert [b["valid_count"] for b in got] == [4, 4, 4, 4, 4, 1]
        for g, w in zip(got, want):
            n = g["valid_count"]
            assert g["image"].is_cuda and g["mask"].dtype == torch.int64
            assert torch.equal(g["image"], w["image"][:n]) and torch.equal(g["mask"], w["mask"][:n])
        assert pin_threads()
    finally:
        procs.close()
    end = time.monotonic() + 5.0
    while (multiprocessing.active_children() or pin_threads()) and time.monotonic() < end:
        time.sleep(0.01)
    assert not multiprocessing.active_children() and not pin_threads()


# the f32 instances (csrc/attention_f32.cu; the backward's 3xTF32 kernels in
# csrc/attention_bwd_tf32.cuh): the forward's 64-row tiles and the
# backward's 128-row blocks (64 at head dim 128) and 32-row stages (16), so
# L at and around their edges (1, 63, 65, 129), ragged L (197, 300),
# DOFA-base's 1297 (512^2) and 2026 (640^2), head dims 32, 64 and 128
F32_CASES = [(2, 1297, 12, 64), (1, 2026, 12, 64), (2, 197, 4, 32), (2, 63, 4, 32),
             (1, 300, 2, 128), (2, 129, 2, 128), (2, 65, 3, 64), (1, 1, 2, 64)]


def _f32_close(got, want, what: str) -> None:
    """Within 1e-5 of ``want``'s largest |value| (exactly where that is 0)."""
    top = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= 1e-5 * top, (what, err, top)


def _f32_exact(got, plain, exact, what: str) -> None:
    """``got`` no further from the exact (f64) value than the plain f32
    version is, plus 1e-5 of the exact value's largest |value|: where f32
    arithmetic itself is about 1e-5 off (inputs x 4), two f32 results
    cannot be held to 1e-5 of each other."""
    top = float(exact.abs().max())
    reach = float((plain.double() - exact).abs().max())
    err = float((got.double() - exact).abs().max())
    assert err <= reach + 1e-5 * top, (what, err, reach, top)


@pytest.mark.parametrize("case", ["plain", "equal scores", "zero gradient", "inputs x4"])
@pytest.mark.parametrize("b,l,h,hd", F32_CASES)
def test_attention_f32(gen, b, l, h, hd, case):
    """The f32 forward and backward (packed entry points) against their
    plain f32 versions: o, dq, dk and dv within 1e-5 of each one's largest
    |value|, lse 1e-5; one launch of each; two runs equal; the head-major
    operators on the head slices of the same tensors equal them bit for
    bit (the same arithmetic on other strides); an all-zero gradient gives
    exactly zero. Inputs x 4 give peaked rows,
    where a single TF32 pass in the backward would be 5e-4 off: the lo
    terms of its 3xTF32 products carry them. There the plain f32 version
    itself is up to 1.5e-5 of the largest |value| from the exact one, so
    the gradients are held to the exact (f64) value (``_f32_exact``)."""
    qkv = torch.randn((b, l, 3 * h * hd), generator=gen, device="cuda")
    if case == "equal scores":
        qkv[..., : h * hd] = 0
    if case == "inputs x4":
        qkv *= 4
    g = torch.randn((b, l, h * hd), generator=gen, device="cuda")
    if case == "zero gradient":
        g.zero_()
    scale = 1.0 / math.sqrt(hd)
    _lib.reset_launches()
    o, lse = MHA.attention_packed(qkv, h, scale)
    got = MHA.attention_bwd_packed(qkv, o, g, lse, h, scale)
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == {"attention_fwd_f32": 1, "attention_bwd_f32": 1}
    wo, wlse = MHA.attention_reference(qkv, h, scale)
    _f32_close(o, wo, "o")
    torch.testing.assert_close(lse, wlse, atol=1e-5, rtol=0)
    want = MHA.attention_bwd_reference(qkv, o, g, lse, h, scale)
    exact = (MHA.attention_bwd_reference(*(t.double() for t in (qkv, o, g, lse)), h, scale)
             if case == "inputs x4" else want)
    for name, a, w, e in zip("qkv", got.chunk(3, dim=-1), want.chunk(3, dim=-1),
                             exact.chunk(3, dim=-1)):
        if case == "zero gradient":
            assert not a.any(), name
        elif l == 1 and name != "v":
            # one key: ds is the f32 rounding of two sums taken in another
            # order on each side (test_attention_backward)
            assert max(float(t.abs().max()) for t in (a, w)) <= 2.0**-16
        elif case == "inputs x4":
            _f32_exact(a, w, e, f"d{name}")
        else:
            _f32_close(a, w, f"d{name}")
    again = MHA.attention_packed(qkv, h, scale)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    assert torch.equal(got, MHA.attention_bwd_packed(qkv, o, g, lse, h, scale))
    _lib.reset_launches()
    o_hm, lse_hm = MHA.attention_hm(qkv, h, scale)
    dqkv = MHA.attention_hm_bwd(qkv, o, g, lse, h, scale)
    torch.cuda.synchronize()
    assert dict(_lib.LAUNCHES) == {"attention_fwd_hm_f32": 1, "attention_bwd_hm_f32": 1}
    assert torch.equal(o_hm, o) and torch.equal(lse_hm, lse) and torch.equal(dqkv, got)


def test_attention_f32_routes_launch_their_kernels(gen):
    """The dispatch on f32 inputs takes the same route as on bf16, through
    the f32 instances, and launches no bf16 kernel."""
    for l, fwd, bwd in ((1297, "attention_fwd_f32", "attention_bwd_f32"),
                        (2026, "attention_fwd_hm_f32", "attention_bwd_hm_f32")):
        qkv = torch.randn((1, l, 3 * 768), generator=gen, device="cuda").requires_grad_()
        _lib.reset_launches()
        o = MHA.attention(qkv, 12)
        o.backward(torch.ones_like(o))
        torch.cuda.synchronize()
        assert dict(_lib.LAUNCHES) == {fwd: 1, bwd: 1}
        assert qkv.grad.dtype == torch.float32 and torch.isfinite(qkv.grad).all()


def test_f32_scope_turns_tf32_off_and_restores_it(gen):
    """``32-true``'s scope runs an f32 convolution at f32 (TF32 would be
    about 1e-3 off) and restores both TF32 flags afterwards."""
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy

    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    x = torch.randn((2, 64, 32, 32), generator=gen, device="cuda")
    w = torch.randn((64, 64, 3, 3), generator=gen, device="cuda")
    want = torch.nn.functional.conv2d(x.double().cpu(), w.double().cpu(), padding=1)
    try:
        for f in flags:
            f.allow_tf32 = True
        with PrecisionPolicy.create("32-true").scope():
            assert not any(f.allow_tf32 for f in flags)
            y = torch.nn.functional.conv2d(x, w, padding=1)
            m = x.flatten(0, 2) @ w.flatten(1)[:, :32].T
        assert all(f.allow_tf32 for f in flags)
        with PrecisionPolicy.create("bf16-mixed").scope():
            assert all(f.allow_tf32 for f in flags)
    finally:
        for f, value in zip(flags, saved):
            f.allow_tf32 = value
    _f32_close(y.double().cpu(), want, "conv")
    want_m = x.double().cpu().flatten(0, 2) @ w.double().cpu().flatten(1)[:, :32].T
    _f32_close(m.double().cpu(), want_m, "matmul")


# ---------------------------------------------------------------- the gdl:: operators


def _op_cases(gen, dtype):
    """``name -> (operator, args)`` on the card at shapes the kernels take:
    K8/K9 at 640^2's 2026 tokens (two 64-wide heads), the others small."""
    def randn(shape, dt=dtype, grad=False):
        return torch.randn(shape, generator=gen, device="cuda").to(dt).requires_grad_(grad)

    x, br = randn((2, 37, 128), grad=True), randn((2, 37, 128), grad=True)
    dy, ds = randn((2, 37, 128)), randn((2, 37, 128))
    gamma, beta = randn((128,), torch.float32, True), randn((128,), torch.float32, True)
    _, mu, rstd = LN.layernorm(x.detach(), gamma.detach(), beta.detach())
    packed, hm = randn((2, 197, 3 * 128), grad=True), randn((1, 2026, 3 * 128), grad=True)
    o, lse = MHA.attention_packed(packed.detach(), 2, 0.125)
    g = randn(o.shape)
    o_hm, lse_hm = MHA.attention_hm(hm.detach(), 2, 0.125)
    g_hm = randn(o_hm.shape)
    q, k, v = randn((2, 2, 1024, 32), grad=True), randn((2, 2, 64, 32), grad=True), randn(
        (2, 2, 64, 32), grad=True)
    img = torch.randint(0, 256, (2, 16, 16, 3), generator=gen, device="cuda", dtype=torch.uint8)
    mean = torch.rand((2, 3), generator=gen, device="cuda") * 0.1 + 0.38
    std = torch.rand((2, 3), generator=gen, device="cuda") * 0.03 + 0.15
    xp = torch.randn((1, 9, 33, 128), generator=gen, device="cuda").bfloat16()
    kp = PC.pack_w_kernel(0.05 * torch.randn((3, 3, 64, 64), generator=gen,
                                             device="cuda")).bfloat16()
    scale, shift = randn((128,), torch.float32), randn((128,), torch.float32)
    cases = {
        "preprocess": (PP.PREPROCESS, (img, mean, std, dtype)),
        "layernorm_fwd": (LN.LAYERNORM_FWD, (x, gamma, beta, 1e-6)),
        "layernorm_residual_fwd": (LN.LAYERNORM_RESIDUAL_FWD, (x, br, gamma, beta, 1e-6)),
        "layernorm_bwd": (LN.LAYERNORM_BWD, (x.detach(), dy, gamma.detach(), mu, rstd)),
        "layernorm_residual_bwd": (LN.LAYERNORM_RESIDUAL_BWD,
                                   (x.detach(), dy, ds, gamma.detach(), mu, rstd)),
        "attention_fwd_packed": (MHA.ATTENTION_FWD_PACKED, (packed, 2, 0.125)),
        "attention_bwd_packed": (MHA.ATTENTION_BWD_PACKED,
                                 (packed.detach(), o, g, lse, 2, 0.125)),
        "attention_fwd_hm": (MHA.ATTENTION_FWD_HM, (hm, 2, 0.125)),
        "attention_bwd_hm": (MHA.ATTENTION_BWD_HM, (hm.detach(), o_hm, g_hm, lse_hm, 2, 0.125)),
        "sr_attention_fwd": (SR.SR_ATTENTION_FWD, (q, k, v, 32**-0.5)),
    }
    if dtype == torch.bfloat16:  # K11 takes bf16 only
        for stats in (True, False):
            cases[f"packed_conv_bn_stats{'' if stats else ' no stats'}"] = (
                PC.PACKED_CONV_BN_STATS, (xp, kp, scale, shift, stats, stats))
    return cases


OP_NAMES = ["preprocess", "layernorm_fwd", "layernorm_residual_fwd", "layernorm_bwd",
            "layernorm_residual_bwd", "attention_fwd_packed", "attention_bwd_packed",
            "attention_fwd_hm", "attention_bwd_hm", "sr_attention_fwd", "packed_conv_bn_stats",
            "packed_conv_bn_stats no stats"]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", OP_NAMES)
def test_opcheck_on_the_card(gen, name, dtype):
    """``torch.library.opcheck`` of every ``gdl::`` operator on CUDA
    tensors, each dtype it takes: schema, autograd registration, the fake
    implementation against the kernel's outputs, AOT dispatch with a
    dynamic batch (the registered backward's kernels included)."""
    cases = _op_cases(gen, DTYPES[dtype])
    if name not in cases:
        pytest.skip(f"{name} takes bfloat16 only")
    op, args = cases[name]
    torch.library.opcheck(op, args)


def test_op_gradients_card_against_cpu(gen):
    """Gradients through the differentiable operators (K2/K5, K3/K6, K4/K7,
    K8/K9 at 2026 tokens, K10 and its torch backward) on the card against
    the same operators on CPU copies (the plain versions), bf16 activations
    and f32 parameters: activations' gradients to one bf16 ulp of each
    one's largest |value| (attention) or ``LN_TOL`` (LayerNorm, K10's
    1.6e-2), dgamma/dbeta to 1e-2 (f32 sums of bf16 products)."""
    cases = _op_cases(gen, torch.bfloat16)
    for name in ("layernorm_fwd", "layernorm_residual_fwd", "attention_fwd_packed",
                 "attention_fwd_hm", "sr_attention_fwd"):
        op, args = cases[name]
        grads = {}
        for device in ("cuda", "cpu"):
            leaves = [a.detach().to(device).requires_grad_(a.requires_grad)
                      if isinstance(a, torch.Tensor) else a for a in args]
            outs = op(*leaves)
            outs = outs if isinstance(outs, tuple) else (outs,)
            gen_cpu = torch.Generator().manual_seed(1)
            loss = sum((t.float() * torch.randn(t.shape, generator=gen_cpu).to(device)).sum()
                       for t in outs if t.dtype == torch.bfloat16)
            loss.backward()
            grads[device] = [a.grad for a in leaves if isinstance(a, torch.Tensor) and a.requires_grad]
        for i, (got, want) in enumerate(zip(grads["cuda"], grads["cpu"])):
            assert got.dtype == want.dtype and got.device.type == "cuda", (name, i)
            if want.dtype == torch.float32:
                tol = 1e-2
            elif name.startswith("attention"):
                tol = _ulp(want)
            else:
                tol = LN_TOL["bfloat16"] if name.startswith("layernorm") else 1.6e-2
            torch.testing.assert_close(got.cpu().float(), want.float(), atol=tol, rtol=0,
                                       msg=f"{name} gradient {i}")


def test_exported_tiny_dofa_launches_exactly_its_kernels(gen, tmp_path, monkeypatch):
    """The 5-block model of test_tiny_model_launch_counts, exported with a
    symbolic batch (bf16-mixed) and loaded: its graph holds one gdl:: node
    a kernel call, and a call of the loaded program at batch 2 and 3
    launches exactly those kernels (K1 is not in serving: it takes floats);
    the probabilities equal the eager serving module's within 4e-3."""
    from geo_deep_learning_tpu_torch.inference.export import (
        export_model,
        gdl_nodes,
        load_exported,
        make_serving_fn,
    )
    from geo_deep_learning_tpu_torch.models.encoders import dofa
    from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation

    monkeypatch.setitem(dofa.dofa_configs, "tiny", dofa.DOFAConfig(
        embed_dim=128, depth=5, num_heads=2, out_indices=(1, 2, 3, 4)))
    model = DOFASegmentation("tiny", num_classes=3, decoder_channels=32, img_size=64).cuda()
    model.init_weights(gen)
    serving = make_serving_fn(model, [0.405, 0.432, 0.397], [0.165, 0.161, 0.174], 3,
                              wavelengths=[0.665, 0.549, 0.481], precision="bf16-mixed")
    path = export_model(serving, (2, 64, 64, 3), tmp_path / "tiny.pt2")
    program = load_exported(path)
    want = {"layernorm_fwd": 4, "layernorm_residual_fwd": 6, "attention_fwd_packed": 5}
    assert gdl_nodes(program.program) == want
    for b in (2, 3):
        x = torch.rand((b, 64, 64, 3), generator=gen, device="cuda") * 255
        with torch.inference_mode():
            eager = serving(x)
        torch.cuda.synchronize()
        _lib.reset_launches()
        got = program(x)
        torch.cuda.synchronize()
        assert dict(_lib.LAUNCHES) == want
        assert got.shape == (b, 64, 64, 3)
        torch.testing.assert_close(got, eager, atol=4e-3, rtol=0)


class _ConvBN(torch.nn.Module):
    """conv 3x3 -> the port's BatchNorm -> ReLU -> conv 1x1 (one class)."""

    def __init__(self) -> None:
        super().__init__()
        from geo_deep_learning_tpu_torch.models.layers import BatchNorm2d

        self.conv = torch.nn.Conv2d(3, 8, 3, padding=1)
        self.norm = BatchNorm2d(8)
        self.head = torch.nn.Conv2d(8, 1, 1)

    def forward(self, x):
        from geo_deep_learning_tpu_torch.models.base import SegmentationOutput

        return SegmentationOutput(self.head(torch.relu(self.norm(self.conv(x)))))


def test_ddp_step_in_an_nccl_group_of_one_equals_the_plain_step(gen, monkeypatch):
    """Under an NCCL group of one, the train step drives the model through
    ``DistributedDataParallel``; two steps then leave every parameter and
    BN statistic bit-equal to the unwrapped step's (cuDNN deterministic)."""
    import torch.distributed as dist

    from geo_deep_learning_tpu_torch.core.mesh import create_mesh, free_port
    from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
    from geo_deep_learning_tpu_torch.core.train_state import TrainState
    from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
    from geo_deep_learning_tpu_torch.training import optim
    from geo_deep_learning_tpu_torch.training.steps import make_train_step
    from geo_deep_learning_tpu_torch.training.task import SegmentationTask

    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", False)
    rng = np.random.default_rng(0)
    batch = {
        "image": torch.from_numpy(rng.integers(0, 256, (4, 32, 32, 3), dtype=np.uint8)).cuda(),
        "mask": torch.from_numpy(rng.integers(0, 2, (4, 32, 32))).cuda(),
        "mean": torch.tensor([0.405, 0.432, 0.397], device="cuda"),
        "std": torch.tensor([0.165, 0.161, 0.174], device="cuda"),
    }
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
                            rank=0)
    try:
        states = []
        for mesh in (create_mesh(device="cuda"), None):
            torch.manual_seed(0)
            model = _ConvBN().cuda()
            task = SegmentationTask(model, DiceLoss(mode="binary"))
            opt = optim.build_optimizer(list(model.parameters()), "adam", 1e-2)
            state = TrainState.create(model, opt, seed=0)
            step = make_train_step(task, PrecisionPolicy.create("bf16-mixed"), augment=None,
                                   mesh=mesh)
            assert (step.ddp is None) == (mesh is None)
            for _ in range(2):
                step(state, batch)
            states.append(model.state_dict())
    finally:
        dist.destroy_process_group()
    for k, v in states[0].items():
        assert torch.equal(v, states[1][k]), k


def test_two_gloo_ranks_on_one_card_batchnorm_and_global_sum(gen, tmp_path):
    """Two ranks sharing ``cuda:0`` over gloo: the port's BatchNorm over the
    global batch and ``global_sum`` (forward and backward) equal one rank's
    on the whole batch, to f32 reassociation (1e-5 of each output's largest)."""
    import sys
    from pathlib import Path

    sys.path.insert(0, str(Path(__file__).parent))
    import _torch_dp as D

    from geo_deep_learning_tpu_torch.core.mesh import Mesh, launch

    launch(D.batchnorm_on_card, (str(tmp_path),), size=2, backend="gloo", deadline_s=120)
    ranks = [dict(np.load(tmp_path / f"bn_rank{r}.npz")) for r in range(2)]
    want = D.batchnorm_step(Mesh(device=torch.device("cuda")), D.bn_batch())
    for key in ("y", "dx"):
        got = np.concatenate([r[key] for r in ranks])
        np.testing.assert_allclose(got, want[key], atol=1e-5 * np.abs(want[key]).max(), rtol=0)
    np.testing.assert_allclose(np.mean([r["dw"] for r in ranks], axis=0), want["dw"],
                               atol=1e-5 * np.abs(want["dw"]).max(), rtol=0)
    for key in ("mean", "var", "total"):
        for r in ranks:
            np.testing.assert_allclose(r[key], want[key], atol=1e-5 * np.abs(want[key]).max(),
                                       rtol=0, err_msg=key)
