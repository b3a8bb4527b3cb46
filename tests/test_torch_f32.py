"""``32-true`` in the port against the JAX package in f32.

- The attention plain versions (what the f32 kernels K4/K7 and K8/K9 are
  held to on the card) against the JAX Pallas kernels in interpreter mode,
  at f32: every output within 1e-5 of its largest |value|, lse 1e-5.
- One ``32-true`` train step of a tiny DOFA + UperNet against the JAX
  package's f32 step on the same weights and batch: the loss within 1e-5
  relative, and the gradients of each part of the model (encoder blocks,
  patch embedding, neck, decoder, heads) at 1 - cosine <= 1e-5 with norms
  within 1e-4 relative. Per tensor the two frameworks differ by more (up
  to 2e-3 of a tensor's largest value, ``test_torch_train.py``): flax's
  BatchNorm takes the variance as E[x^2] - E[x]^2, and gradients that are
  mathematically zero come out as rounding noise on both sides.
- The precision scope: ``32-true`` turns TF32 off for cuBLAS and cuDNN for
  the length of a run and restores the flags; ``bf16-mixed`` leaves them.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tiny import WAVES, jax_variables, register_tiny, tiny_model

import geo_deep_learning_tpu.models.segmentation.dofa as jsegdofa
import geo_deep_learning_tpu.ops.pallas.mha as jmha
from geo_deep_learning_tpu.models.encoders.dofa import DOFAv2 as JaxDOFAv2
from geo_deep_learning_tpu.models.heads.fcn import FCNHead as JaxFCNHead
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.training.task import SegmentationTask as JaxTask
from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.models.convert import from_jax_params
from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout
from geo_deep_learning_tpu_torch.ops.cuda import mha as tmha
from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
from geo_deep_learning_tpu_torch.training import steps as tsteps
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

REL = 1e-5


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(jmha, "_INTERPRET", True)
    jax.clear_caches()  # the JAX kernels are jitted; drop traces of the real mode
    yield
    jax.clear_caches()


def _close(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want, np.float32)
    err = float(np.abs(got.numpy() - want).max())
    assert err <= REL * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


@pytest.mark.parametrize("l,hd", [(300, 64), (257, 32), (300, 128)])
def test_packed_plain_versions_match_the_jax_kernels_at_f32(interpret, l, hd):
    """K4's and K7's plain versions against ``_fwd_packed`` /
    ``_bwd_packed`` at f32, one 128-lane block of heads, ragged L."""
    h = 128 // hd
    rng = np.random.default_rng(l + hd)
    qkv = rng.standard_normal((2, l, 3 * h * hd)).astype(np.float32)
    g = rng.standard_normal((2, l, h * hd)).astype(np.float32)
    scale = 1.0 / math.sqrt(hd)
    o, lse = tmha.attention_packed(torch.from_numpy(qkv), h, scale)
    assert o.dtype == torch.float32
    jo, jlse = jmha._fwd_packed(jnp.asarray(qkv), h, scale)
    _close(o, jo, "o")
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse)[..., 0], atol=1e-5, rtol=0)
    got = tmha.attention_bwd_packed(torch.from_numpy(qkv), o, torch.from_numpy(g), lse, h, scale)
    wide = jnp.asarray(np.repeat(lse.numpy()[..., None], 8, axis=-1))
    want = jmha._bwd_packed(jnp.asarray(qkv), jnp.asarray(o.numpy()), jnp.asarray(g), wide, h,
                            scale)
    for name, a, w in zip("qkv", got.chunk(3, dim=-1), want):
        _close(a, w, f"d{name}")


@pytest.mark.parametrize("l", [300, 513])
def test_head_major_plain_versions_match_the_jax_kernels_at_f32(interpret, l):
    """K8's and K9's plain versions against ``_attention`` (forward and its
    custom VJP) at DOFA's head dim 64, f32, over the JAX kernels' padding."""
    hd, scale = 64, 0.125
    rng = np.random.default_rng(l)
    q, k, v, g = (rng.standard_normal((1, 2, l, hd)).astype(np.float32) for _ in range(4))
    lp = jmha._pad_len(l)

    def pad(x):
        return jnp.pad(jnp.asarray(x), ((0, 0), (0, 0), (0, lp - l), (0, 0)))

    def packed(*ts):  # [B, H, L, hd] each -> [B, L, H*hd] side by side
        return torch.cat([torch.from_numpy(t).transpose(1, 2).flatten(2) for t in ts], dim=-1)

    qkv = packed(q, k, v)
    o, lse = tmha.attention_hm(qkv, 2, scale)
    jo = jmha._attention(pad(q), pad(k), pad(v), scale, l)[:, :, :l]
    _close(o.unflatten(-1, (2, hd)).transpose(1, 2), jo, "o")

    def loss(q, k, v):
        return (jmha._attention(pad(q), pad(k), pad(v), scale, l)[:, :, :l] * g).sum()

    jgrads = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))
    grads = tmha.attention_hm_bwd(qkv, o, packed(g), lse, 2, scale).chunk(3, dim=-1)
    for name, a, w in zip("qkv", grads, jgrads):
        _close(a.unflatten(-1, (2, hd)).transpose(1, 2), w, f"d{name}")


def _groups(name: str) -> str:
    if name.startswith("encoder.blocks."):
        return "encoder.blocks"
    if name.startswith("encoder."):
        return "encoder.embed"
    return name.split(".", 1)[0]


def test_f32_train_step_matches_jax(monkeypatch):
    """One ``32-true`` step (f32 on both sides, no augmentation, DropPath
    and dropout at rate 0): the loss, then each part's gradients."""
    register_tiny(monkeypatch)
    monkeypatch.setattr(jsegdofa, "DOFAv2", functools.partial(JaxDOFAv2, drop_path_rate=0.0))
    monkeypatch.setattr(jsegdofa, "FCNHead", functools.partial(JaxFCNHead, dropout_ratio=0.0))
    model = tiny_model(1)
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    table = model.encoder.pos_embed.numpy()
    variables = jax_variables(model)
    jmodel = jsegdofa.DOFASegmentation(encoder_name="tiny", num_classes=1, decoder_channels=32,
                                       pos_embed_table=table)
    jtask = JaxTask(jmodel, JaxDice(mode="binary"), num_classes=1)
    rng = np.random.default_rng(4)
    image = rng.integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    x = ((image / 255.0 - 0.42) / 0.17).astype(np.float32)
    mask = rng.integers(0, 2, (2, 64, 64)).astype(np.int32)

    def jloss(params):
        out = jmodel.apply({**variables, "params": params}, jnp.asarray(x), jnp.asarray(WAVES),
                           train=True, mutable=["batch_stats"])[0]
        return jtask.compute_loss(out, jnp.asarray(mask))

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    jgrads = from_jax_params(jax.tree.map(np.asarray, jgrads),
                             jax.tree.map(np.asarray, variables["batch_stats"]), pos_embed=table)

    policy = PrecisionPolicy.create("32-true")
    task = SegmentationTask(model.train(), DiceLoss(mode="binary"), num_classes=1,
                            default_wavelengths=list(WAVES))
    batch = tsteps.to_device({"image": x, "mask": mask}, torch.device("cpu"))
    image_t = tsteps.prepare_image(batch, policy)
    assert image_t.dtype == torch.float32
    with policy.scope():
        loss = task.compute_loss(tsteps._forward(task, policy, batch, image_t), batch["mask"])
        loss.backward()
    assert abs(float(loss.detach()) - float(jl)) <= REL * abs(float(jl))
    parts: dict[str, list] = {}
    for n, p in model.named_parameters():
        if p.grad is not None:
            parts.setdefault(_groups(n), []).append((p.grad.flatten(), jgrads[n].flatten()))
    assert set(parts) == {"encoder.blocks", "encoder.embed", "neck", "decoder", "head",
                          "aux_head"}
    for part, pairs in parts.items():
        got = torch.cat([a for a, _ in pairs]).double()
        want = torch.cat([b for _, b in pairs]).double()
        cos = float(got @ want / (got.norm() * want.norm()))
        ratio = float(got.norm() / want.norm())
        assert 1.0 - cos <= 1e-5 and abs(ratio - 1.0) <= 1e-4, (part, 1.0 - cos, ratio)


def test_scope_turns_tf32_off_for_a_run_and_restores_it():
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    saved = [f.allow_tf32 for f in flags]
    try:
        for f in flags:
            f.allow_tf32 = True
        with PrecisionPolicy.create("32-true").scope():
            assert not any(f.allow_tf32 for f in flags)
        assert all(f.allow_tf32 for f in flags)
        with pytest.raises(RuntimeError, match="inside"):
            with PrecisionPolicy.create("32-true").scope():
                msg = "raised inside the run"
                raise RuntimeError(msg)
        assert all(f.allow_tf32 for f in flags)
        with PrecisionPolicy.create("bf16-mixed").scope():
            assert all(f.allow_tf32 for f in flags)
    finally:
        for f, value in zip(flags, saved):
            f.allow_tf32 = value
