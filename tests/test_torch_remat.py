"""``remat`` in the port: DOFA's ``"mlp"`` and ``"block"`` modes and MiT's
per-block recomputation against no recomputation, and against the JAX
models built with the same ``remat`` settings.

Recomputation changes what the backward keeps, not what it computes: in
the port the three DOFA modes give bit-equal losses and gradients in train
mode with DropPath drawing from its generator (the checkpoint replays the
forward's draws and leaves the generator where the forward left it); the
attention forward (K4/K8's plain version on the CPU) runs once a block a
step for ``"mlp"`` and none, twice for ``"block"``. Against JAX (f32,
DropPath at rate 0), the loss within 1e-5 relative and each part's
gradients at 1 - cosine <= 1e-5, norms within 1e-4, as
``test_torch_f32.py`` holds the step without remat.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tiny import TINY, WAVES, jax_variables, perturb, register_tiny, register_tiny_mit

import geo_deep_learning_tpu.models.segmentation.dofa as jsegdofa
from geo_deep_learning_tpu.models.encoders.dofa import DOFAv2 as JaxDOFAv2
from geo_deep_learning_tpu.models.heads.fcn import FCNHead as JaxFCNHead
from geo_deep_learning_tpu.ops.losses import DiceLoss as JaxDice
from geo_deep_learning_tpu.training.task import SegmentationTask as JaxTask
from geo_deep_learning_tpu_torch.models.convert import from_jax_params
from geo_deep_learning_tpu_torch.models.encoders.mix_transformer import (
    DynamicMixTransformer,
    MixVisionTransformer,
)
from geo_deep_learning_tpu_torch.models.layers import DropPath, Dropout, set_generator
from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
from geo_deep_learning_tpu_torch.models.segmentation.segformer import SegFormer
from geo_deep_learning_tpu_torch.ops.cuda import mha as tmha
from geo_deep_learning_tpu_torch.ops.losses import DiceLoss
from geo_deep_learning_tpu_torch.training.task import SegmentationTask

MODES = (None, "mlp", "block")


def _dofa(mode, seed=0):
    model = DOFASegmentation("tiny", num_classes=1, decoder_channels=32, img_size=64,
                             remat=mode is not None, remat_mode=mode or "mlp")
    model.init_weights(torch.Generator().manual_seed(seed))
    perturb(model, np.random.default_rng(seed))
    return model


def _batch(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    mask = rng.integers(0, 2, (2, 64, 64))
    return torch.from_numpy(x), torch.from_numpy(mask)


def _step(model, x, mask, generator=None):
    """Loss and gradients of one train-mode step; the attention forward
    calls counted."""
    model.train()
    if generator is not None:
        set_generator(model, generator)
    task = SegmentationTask(model, DiceLoss(mode="binary"), num_classes=1)
    loss = task.compute_loss(model(x, torch.from_numpy(WAVES)), mask)  # main + 0.4 aux
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()
                           if p.grad is not None}


@pytest.fixture
def counted(monkeypatch):
    register_tiny(monkeypatch)
    calls = []
    for name in ("attention_packed", "attention_hm"):
        fn = getattr(tmha, name)
        monkeypatch.setattr(tmha, name,
                            lambda *a, fn=fn, **kw: calls.append(1) or fn(*a, **kw))
    return calls


def test_dofa_remat_modes_give_equal_gradients(counted):
    """Train mode, DropPath 0.1 drawing from one seeded generator: equal
    losses and gradients bit for bit, the generator left in the same state,
    and the attention forward once a block (none, ``"mlp"``) or twice
    (``"block"``)."""
    x, mask = _batch()
    results = {}
    for mode in MODES:
        gen = torch.Generator().manual_seed(11)
        counted.clear()
        loss, grads = _step(_dofa(mode), x, mask, gen)
        results[mode] = (loss, grads, gen.get_state(), len(counted))
    depth = TINY["depth"]
    assert [results[m][3] for m in MODES] == [depth, depth, 2 * depth]
    loss, grads, state, _ = results[None]
    assert len(grads) == len(list(_dofa(None).parameters())) - 2  # encoder.norm is unused
    for mode in ("mlp", "block"):
        got_loss, got, got_state, _ = results[mode]
        assert torch.equal(got_loss, loss), mode
        assert torch.equal(got_state, state), mode
        assert got.keys() == grads.keys()
        for n in grads:
            assert torch.equal(got[n], grads[n]), (mode, n)


def test_dofa_remat_is_a_model_field_with_the_same_parameters(monkeypatch):
    """The same parameter names in every mode (checkpoints and the
    converters are untouched), an unknown mode refused, and no
    recomputation in evaluation."""
    register_tiny(monkeypatch)
    names = [list(_dofa(m).state_dict()) for m in MODES]
    assert names[0] == names[1] == names[2]
    with pytest.raises(ValueError, match="remat_mode"):
        DOFASegmentation("tiny", img_size=64, remat=True, remat_mode="layer")
    x = _batch()[0]
    with torch.no_grad():
        out = _dofa("block").eval()(x, torch.from_numpy(WAVES)).out
        want = _dofa(None).eval()(x, torch.from_numpy(WAVES)).out
    assert torch.equal(out, want)


def _groups(name: str) -> str:
    return "encoder" if name.startswith("encoder.") else name.split(".", 1)[0]


@pytest.mark.parametrize("mode", ["mlp", "block"])
def test_dofa_remat_matches_jax(counted, monkeypatch, mode):
    monkeypatch.setattr(jsegdofa, "DOFAv2", functools.partial(JaxDOFAv2, drop_path_rate=0.0))
    monkeypatch.setattr(jsegdofa, "FCNHead", functools.partial(JaxFCNHead, dropout_ratio=0.0))
    model = _dofa(mode)
    for m in model.modules():
        if isinstance(m, (DropPath, Dropout)):
            m.rate = 0.0
    table = model.encoder.pos_embed.numpy()
    variables = jax_variables(model)
    jmodel = jsegdofa.DOFASegmentation(encoder_name="tiny", num_classes=1, decoder_channels=32,
                                       remat=True, remat_mode=mode, pos_embed_table=table)
    jtask = JaxTask(jmodel, JaxDice(mode="binary"), num_classes=1)
    x, mask = _batch()
    xj = jnp.asarray(x.permute(0, 2, 3, 1).numpy())

    def jloss(params):
        out = jmodel.apply({**variables, "params": params}, xj, jnp.asarray(WAVES), train=True,
                           mutable=["batch_stats"])[0]
        return jtask.compute_loss(out, jnp.asarray(mask.numpy().astype(np.int32)))

    jl, jgrads = jax.jit(jax.value_and_grad(jloss))(variables["params"])
    jgrads = from_jax_params(jax.tree.map(np.asarray, jgrads),
                             jax.tree.map(np.asarray, variables["batch_stats"]), pos_embed=table)
    loss, grads = _step(model, x, mask)
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    parts: dict[str, list] = {}
    for n, g in grads.items():
        parts.setdefault(_groups(n), []).append((g.flatten(), jgrads[n].flatten()))
    for part, pairs in parts.items():
        got = torch.cat([a for a, _ in pairs]).double()
        want = torch.cat([b for _, b in pairs]).double()
        cos = float(got @ want / (got.norm() * want.norm()))
        ratio = float(got.norm() / want.norm())
        assert 1.0 - cos <= 1e-5 and abs(ratio - 1.0) <= 1e-4, (part, 1.0 - cos, ratio)


def test_mit_remat_gives_equal_gradients(monkeypatch):
    """SegFormer with ``remat`` checkpoints each standard MiT block: equal
    loss and gradients with DropPath 0.1 drawing from a generator; the
    Dynamic MiT does not take it, as in JAX."""
    register_tiny_mit(monkeypatch)
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((2, 3, 64, 64)).astype(np.float32))
    mask = torch.from_numpy(rng.integers(0, 2, (2, 64, 64)))
    results = []
    for remat in (False, True):
        model = SegFormer("tiny_mit", num_classes=1, remat=remat)
        model.init_weights(torch.Generator().manual_seed(0))
        for m in model.encoder.modules():
            if isinstance(m, DropPath):
                m.rate = 0.1
        assert isinstance(model.encoder, MixVisionTransformer) and model.encoder.remat is remat
        gen = torch.Generator().manual_seed(2)
        set_generator(model, gen)
        model.train()
        loss = DiceLoss(mode="binary")(model(x).out, mask)
        loss.backward()
        results.append((loss.detach(), {n: p.grad for n, p in model.named_parameters()},
                        gen.get_state()))
    (loss, grads, state), (rloss, rgrads, rstate) = results
    assert torch.equal(loss, rloss) and torch.equal(state, rstate)
    for n in grads:
        assert torch.equal(grads[n], rgrads[n]), n
    dynamic = SegFormer("tiny_mit", num_classes=1, use_dynamic_encoder=True, remat=True)
    assert isinstance(dynamic.encoder, DynamicMixTransformer) and not dynamic.encoder.remat
