"""The copied yardstick reproduces PERF.md's bound column."""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from gdl_bench.counts import dofa_upernet, kernels, peaks, segformer

BENCH = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("rec,ms", [
    (kernels.attention_fwd_packed(8, 1297, 12, 64), 0.0539),  # K4
    (kernels.attention_bwd_packed(8, 1297, 12, 64), 0.1166),  # K7
    (kernels.sr_attention_fwd(8, 1, 16384, 256, 32), 0.0090),  # K10
])
def test_bounds_match_the_kernel_table(rec, ms):
    got, by = peaks.bound(rec)
    assert by == "operations"
    assert round(got, 4) == ms


def test_families():
    assert peaks.family("void attention_fwd_wgmma_kernel<64>(...)") == "K1-K11"
    assert peaks.family("sm90_xmma_fprop_implicit_gemm_bf16_cudnn") == "convolution"
    assert peaks.family("nvjet_tst_256x160_64x4") == "GEMM"
    assert peaks.family("void at::native::vectorized_elementwise_kernel<4>") == "other"


def _cfg(name):
    return json.loads((BENCH / "configs" / f"{name}.json").read_text())


def test_dofa_counts():
    """About 1.27 TFLOP a patch forward and backward with the factored neck,
    far under the plain neck's count."""
    cfg = _cfg("dofa_base_upernet")
    per_patch = dofa_upernet.train_flops(cfg, 32) / 32
    assert 1.2e12 < per_patch < 1.35e12
    neck = {p: f for p, f, _ in dofa_upernet.parts(cfg) if p.startswith("neck.x4")}
    plain_x4 = 2.0 * 144 * 144 * 768 * 768 * 9
    assert sum(neck.values()) < plain_x4 / 8
    assert len(dofa_upernet.attention(cfg, 32, True)) == 24


def test_segformer_counts():
    cfg = _cfg("segformer_mit_b2")
    per_patch = segformer.train_flops(cfg, 1)
    assert 3.0e11 < per_patch < 4.2e11
    calls = list(segformer.sr_attention_calls(cfg, 32))
    assert len(calls) == 3 + 4 + 6  # stages 1-3 take K10; stage 4 (Lq 256) the einsum
    assert calls[0] == (32, 1, 16384, 256, 64)
