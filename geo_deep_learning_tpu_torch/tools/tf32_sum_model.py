"""A CPU model of how far the f32 attention forward's lse can sit from the
exact value when the tensor core truncates its sums.

K4-f32 / K8-f32 (``csrc/attention_fwd_tf32.cuh``) compute s = q k^T as
3xTF32 on wgmma: each k8 instruction adds eight exact tf32 products to an
f32 accumulator. This model takes the pessimistic reading of that sum: the
addends (the accumulator and the eight products) are aligned to the
largest one's exponent, truncated to ``BITS`` bits below it, summed exactly
and rounded toward zero to f32. It compares, at inputs x 4 (|lse| near 90,
where the plain f32 version itself is about 3e-5 from the exact value),
the largest |lse - exact| of

- the plain f32 version (``ops.cuda.mha.attention_hm_reference``);
- s summed over the whole head dim in one accumulator;
- s summed in groups of two k8 slices (16 columns), each group in a fresh
  accumulator, the groups added in f32 with round-to-nearest, as the
  kernel does;

with the softmax and lse taken in f64 from each s, so that only the sum of
q k^T differs. Run::

    python -m geo_deep_learning_tpu_torch.tools.tf32_sum_model [--heads 4]

(about 7 minutes on the CPU for the default cases).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from geo_deep_learning_tpu_torch.ops.cuda import mha

BITS = 23  # bits kept below the largest addend's leading bit
CASES = ((300, 64), (65, 128), (1297, 64), (2026, 64), (300, 32), (300, 128))


def _tf32(x: np.ndarray) -> np.ndarray:
    """``cvt.rna.tf32.f32`` on f32 bit patterns."""
    bits = x.astype(np.float32).view(np.int32)
    return ((bits + 0x1000) & -0x2000).view(np.float32)


def _rz32(x: np.ndarray) -> np.ndarray:
    """f64 to f32, rounded toward zero."""
    y = x.astype(np.float32)
    over = np.abs(y.astype(np.float64)) > np.abs(x)
    y[over] = np.nextafter(y[over], np.float32(0))
    return y


def _instruction(acc: np.ndarray, prods: np.ndarray) -> np.ndarray:
    """One k8 instruction: acc [M, N] f32 plus prods [M, N, 8] f64."""
    terms = np.concatenate([acc.astype(np.float64)[..., None], prods], -1)
    top = np.abs(terms).max(-1, keepdims=True)
    unit = 2.0 ** (np.floor(np.log2(np.where(top > 0, top, 1.0))) - BITS)
    return _rz32((np.trunc(terms / unit) * unit).sum(-1))


def scores(q: np.ndarray, k: np.ndarray, groups: int) -> np.ndarray:
    """q k^T [Lq, Lk] as 3xTF32 (lo hi, hi lo, hi hi, small terms first)
    in ``groups`` fresh accumulators over the head dim, added in order."""
    qh, kh = _tf32(q), _tf32(k)
    ql, kl = _tf32(q - qh), _tf32(k - kh)
    per = q.shape[1] // groups
    total = np.zeros((q.shape[0], k.shape[0]), np.float32)
    for g in range(groups):
        acc = np.zeros_like(total)
        for a, b in ((ql, kh), (qh, kl), (qh, kh)):
            for c in range(g * per, (g + 1) * per, 8):
                acc = _instruction(acc, a[:, None, c:c + 8].astype(np.float64)
                                   * b[None, :, c:c + 8].astype(np.float64))
        total = (total + acc).astype(np.float32)
    return total


def lse_from(s: np.ndarray, scale: float) -> np.ndarray:
    t = s.astype(np.float64) * scale
    m = t.max(-1, keepdims=True)
    return (m + np.log(np.exp(t - m).sum(-1, keepdims=True)))[..., 0]


def run(l: int, hd: int, heads: int) -> dict[str, float]:
    rng = np.random.default_rng(l + hd)
    qkv = torch.from_numpy(4 * rng.standard_normal((1, l, 3 * heads * hd)).astype(np.float32))
    q, k, v = mha._split_heads(qkv, heads)
    scale = hd**-0.5
    plain = mha.attention_hm_reference(q, k, v, scale)[1]
    exact = mha.attention_hm_reference(q.double(), k.double(), v.double(), scale)[1]
    out = {"plain f32": float((plain.double() - exact).abs().max())}
    for name, groups in (("whole row", 1), ("16-column groups", hd // 16)):
        out[name] = max(
            float(np.abs(lse_from(scores(q[0, h].numpy(), k[0, h].numpy(), groups), scale)
                         - exact[0, h].numpy()).max())
            for h in range(heads))
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--heads", type=int, default=4)
    args = parser.parse_args()
    for l, hd in CASES:
        res = run(l, hd, args.heads)
        print(f"L {l}, hd {hd}, inputs x 4, {args.heads} heads: largest |lse - exact| "
              + ", ".join(f"{k} {v:.3g}" for k, v in res.items()), flush=True)


if __name__ == "__main__":
    main()
