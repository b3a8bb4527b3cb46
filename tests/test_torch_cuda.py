"""The port's CUDA kernels against their plain versions, on the card,
and a train step's launch counts.

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


@pytest.mark.parametrize("shape", [(8, 512, 512, 3), (3, 37, 41, 3), (2, 9, 7, 4)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_preprocess(gen, shape, dtype):
    img = torch.randint(0, 256, shape, generator=gen, device="cuda", dtype=torch.uint8)
    mean = torch.rand((shape[0], shape[-1]), generator=gen, device="cuda") * 0.1 + 0.38
    std = torch.rand((shape[0], shape[-1]), generator=gen, device="cuda") * 0.03 + 0.15
    m, inv = PP._stats(mean, std, img)
    got = PP.fused_normalize_standardize(img, mean, std, DTYPES[dtype])
    want = PP.normalize_reference(img, m, inv, DTYPES[dtype])
    torch.testing.assert_close(got.float(), want.float(), atol=1e-6 if dtype == "float32" else 1.6e-2, rtol=0)


@pytest.mark.parametrize("shape", [(2, 1297, 768), (2, 197, 768), (3, 37, 128)])
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


@pytest.mark.parametrize("b,l,h,hd", [(2, 1297, 12, 64), (2, 197, 12, 64), (2, 37, 4, 32), (1, 300, 2, 128)])
def test_attention(gen, b, l, h, hd):
    qkv = torch.randn((b, l, 3 * h * hd), generator=gen, device="cuda").to(torch.bfloat16)
    o, lse = MHA.attention_packed(qkv, h)
    wo, wlse = MHA.attention_reference(qkv, h, 1.0 / math.sqrt(hd))
    torch.testing.assert_close(o.float(), wo.float(), atol=2e-2, rtol=0)
    torch.testing.assert_close(lse, wlse, atol=1e-4, rtol=0)


def test_attention_refuses_f32(gen):
    with pytest.raises(ValueError, match="bfloat16"):
        MHA.attention_packed(torch.zeros((1, 8, 3 * 64), device="cuda"), 1)


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


@pytest.mark.parametrize("shape", [(2, 1297, 768), (3, 300, 256), (3, 37, 128)])
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


@pytest.mark.parametrize("b,l,h,hd", [(2, 1297, 12, 64), (2, 197, 12, 64), (2, 37, 4, 32), (1, 300, 2, 128)])
def test_attention_backward(gen, b, l, h, hd):
    """K7 against its plain version: bf16 gradients, 1e-2 absolute on
    gradients of order 1 (a few bf16 ulps)."""
    qkv = torch.randn((b, l, 3 * h * hd), generator=gen, device="cuda").to(torch.bfloat16)
    g = torch.randn((b, l, h * hd), generator=gen, device="cuda").to(torch.bfloat16)
    scale = 1.0 / math.sqrt(hd)
    o, lse = MHA.attention_packed(qkv, h, scale)
    got = MHA.attention_bwd_packed(qkv, o, g, lse, h, scale)
    want = MHA.attention_bwd_reference(qkv, o, g, lse, h, scale)
    torch.testing.assert_close(got.float(), want.float(), atol=1e-2, rtol=0)
    assert torch.equal(got, MHA.attention_bwd_packed(qkv, o, g, lse, h, scale))  # no atomics


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


@pytest.mark.parametrize("b,h,lq,lk,d", [(8, 1, 16384, 256, 32), (8, 2, 4096, 256, 32),
                                         (8, 5, 1024, 256, 32), (8, 1, 16384, 256, 64),
                                         (2, 3, 1536, 1000, 32), (1, 2, 512, 12, 64)])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_sr_attention(gen, b, h, lq, lk, d, dtype):
    """K10 against its plain version on q/k/v laid out as SegFormer makes
    them (views of [B, L, H, D] and [B, Lk, 2, H, D]), at the mit_b0 path
    shapes, the b1-b5 head dim and ragged KV lengths: f32 to 1e-5, bf16 to
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
    """SRAttentionFn: K10 forward and the torch-math backward on the card
    against the same Function on CPU copies (plain version), bf16."""
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
