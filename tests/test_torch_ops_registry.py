"""The port's ``gdl::`` operators on the CPU: every kernel K1-K11 and K10's
backward (and the f32 instances, under the same operators by dtype) is an
operator with a
CPU implementation (its plain version), a CUDA implementation (the kernel)
and a fake implementation, and the forwards with a backward have it
registered.

- ``torch.library.opcheck`` on every operator, bf16 and f32, at tiny
  shapes: schema, autograd registration, fake tensors and AOT dispatch
  with a dynamic batch (backward included for the differentiable ones);
- each operator's CPU result equals, bit for bit, the plain function it
  wraps on the same inputs;
- no module of the port defines a ``torch.autograd.Function`` around a
  kernel.
"""

import ast
from pathlib import Path

import pytest
import torch

from geo_deep_learning_tpu_torch.ops.cuda import _lib
from geo_deep_learning_tpu_torch.ops.cuda import layernorm as LN
from geo_deep_learning_tpu_torch.ops.cuda import mha as MHA
from geo_deep_learning_tpu_torch.ops.cuda import packed_conv as PC
from geo_deep_learning_tpu_torch.ops.cuda import preprocess as PP
from geo_deep_learning_tpu_torch.ops.cuda import sr_attention as SR

PORT = Path(__file__).resolve().parents[1] / "geo_deep_learning_tpu_torch"
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}
OPS = ("preprocess", "layernorm_fwd", "layernorm_residual_fwd", "layernorm_bwd",
       "layernorm_residual_bwd", "attention_fwd_packed", "attention_bwd_packed",
       "attention_fwd_hm", "attention_bwd_hm", "sr_attention_fwd", "sr_attention_bwd",
       "packed_conv_bn_stats")
DIFFERENTIABLE = ("layernorm_fwd", "layernorm_residual_fwd", "attention_fwd_packed",
                  "attention_fwd_hm", "sr_attention_fwd")


def _randn(gen, shape, dtype, grad: bool = False) -> torch.Tensor:
    return torch.randn(shape, generator=gen).to(dtype).requires_grad_(grad)


def _cases(dtype):
    """``name -> (operator, args, plain function)``: each operator at a tiny
    shape, forwards with inputs that require gradients; the backwards on
    their forwards' outputs."""
    gen = torch.Generator().manual_seed(0)
    x, br, dy, ds = (_randn(gen, (2, 5, 32), dtype, grad=i < 2) for i in range(4))
    gamma, beta = (_randn(gen, (32,), torch.float32, grad=True) for _ in range(2))
    _, _, mu, rstd = LN.layernorm_residual_reference(x.detach(), br.detach(), gamma.detach(),
                                                     beta.detach())
    qkv = _randn(gen, (2, 9, 3 * 2 * 32), dtype, grad=True)
    o, lse = MHA.attention_reference(qkv.detach(), 2, 0.125)
    g = _randn(gen, o.shape, dtype)
    q = _randn(gen, (2, 2, 512, 32), dtype, grad=True)
    k, v = (_randn(gen, (2, 2, 8, 32), dtype, grad=True) for _ in range(2))
    go = _randn(gen, q.shape, dtype)
    img = torch.randint(0, 256, (2, 4, 6, 3), dtype=torch.uint8, generator=gen)
    mean, std = torch.rand((2, 3), generator=gen), torch.rand((2, 3), generator=gen) + 0.5
    xp = _randn(gen, (2, 3, 4, 128), torch.bfloat16)
    kp = PC.pack_w_kernel(_randn(gen, (3, 3, 64, 64), torch.bfloat16) * 0.05)
    scale, shift = _randn(gen, (128,), torch.float32), _randn(gen, (128,), torch.float32)
    xd, gd = x.detach(), gamma.detach()
    return {
        "preprocess": (PP.PREPROCESS, (img, mean, std, dtype), lambda *a: PP.normalize_reference(
            img, mean, 1.0 / std, dtype)),
        "layernorm_fwd": (LN.LAYERNORM_FWD, (x, gamma, beta, 1e-6), LN.layernorm_reference),
        "layernorm_residual_fwd": (LN.LAYERNORM_RESIDUAL_FWD, (x, br, gamma, beta, 1e-6),
                                   LN.layernorm_residual_reference),
        "layernorm_bwd": (LN.LAYERNORM_BWD, (xd, dy, gd, mu, rstd), LN.layernorm_bwd_reference),
        "layernorm_residual_bwd": (LN.LAYERNORM_RESIDUAL_BWD, (xd, dy, ds, gd, mu, rstd),
                                   LN.layernorm_residual_bwd_reference),
        "attention_fwd_packed": (MHA.ATTENTION_FWD_PACKED, (qkv, 2, 0.125),
                                 MHA.attention_reference),
        "attention_bwd_packed": (MHA.ATTENTION_BWD_PACKED, (qkv.detach(), o, g, lse, 2, 0.125),
                                 MHA.attention_bwd_reference),
        "attention_fwd_hm": (MHA.ATTENTION_FWD_HM, (qkv, 2, 0.125), MHA.attention_reference),
        "attention_bwd_hm": (MHA.ATTENTION_BWD_HM, (qkv.detach(), o, g, lse, 2, 0.125),
                             MHA.attention_bwd_reference),
        "sr_attention_fwd": (SR.SR_ATTENTION_FWD, (q, k, v, 0.2), SR.sr_attention_plain),
        "sr_attention_bwd": (SR.SR_ATTENTION_BWD, (q.detach(), k.detach(), v.detach(), go, 0.2),
                             SR.sr_attention_bwd),
        # K11 takes bf16 only: the prologue on with statistics, off without
        "packed_conv_bn_stats": (PC.PACKED_CONV_BN_STATS,
                                 (xp, kp, scale, shift, dtype == torch.bfloat16,
                                  dtype == torch.bfloat16),
                                 PC.packed_conv_bn_stats_plain),
    }


def test_every_kernel_is_an_operator_with_three_implementations():
    """CPU (plain), CUDA (kernel) and Meta (the fake implementation) kernels
    for each ``gdl::`` operator, and a registered backward for each forward
    that has one."""
    defined = {name for name in OPS if hasattr(torch.ops.gdl, name)}
    assert defined == set(OPS)
    for name in OPS:
        qualified = f"{_lib.NAMESPACE}::{name}"
        for key in ("CPU", "CUDA", "Meta"):
            assert torch._C._dispatch_has_kernel_for_dispatch_key(qualified, key), (name, key)
        has_autograd = torch._C._dispatch_has_kernel_for_dispatch_key(qualified, "Autograd")
        assert has_autograd == (name in DIFFERENTIABLE), name


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", OPS)
def test_opcheck(name, dtype):
    op, args, _ = _cases(DTYPES[dtype])[name]
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", OPS)
def test_cpu_result_is_the_plain_version(name, dtype):
    op, args, plain = _cases(DTYPES[dtype])[name]
    with torch.no_grad():
        got, want = op(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    if name == "packed_conv_bn_stats" and want[1] is None:
        want = (want[0], got[1])  # the operator returns a [0, 128] in place of None
        assert got[1].shape == (0, 128)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b), name


def _function_classes() -> list[tuple[str, str, bool]]:
    """``(module path, class, whether the module reaches the kernel
    library)`` for every ``torch.autograd.Function`` subclass in the port."""
    found = []
    for path in sorted(PORT.rglob("*.py")):
        tree = ast.parse(path.read_text())
        names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
        for node in ast.walk(tree):
            if isinstance(node, ast.ClassDef) and any(
                    ast.unparse(b).endswith("Function") for b in node.bases):
                found.append((str(path.relative_to(PORT)), node.name, "_lib" in names))
    return found


def test_no_autograd_function_wraps_a_kernel():
    """The kernels' modules define none; the four Functions left (the
    factored resize + conv's explicit backward, torch products, the data
    axis's differentiable all-reduce, and the model axis's two Megatron
    operators) reach no kernel."""
    found = _function_classes()
    assert not any(kernel for _, _, kernel in found), found
    assert not any(path.startswith("ops/cuda/") for path, _, _ in found), found
    assert sorted(name for _, name, _ in found) == ["_AllReduceSum", "_CopyToModel", "_Factored",
                                                    "_ReduceFromModel"]
