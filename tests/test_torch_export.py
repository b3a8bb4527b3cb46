"""The port's exported serving programs against the JAX package's serving
functions, on the CPU.

``inference/export.py``: ``make_serving_fn`` -> ``export_model`` (a
``torch.export`` program with a symbolic batch, saved as ``.pt2``) ->
``load_exported``, held against the JAX ``make_serving_fn`` (jitted) on the
same raw NHWC 0..255 input, at batch 2 and batch 4 from one artifact: the
narrow DOFA of ``_torch_tiny`` with wavelengths and with a baked patch
embedding, the narrow MiT SegFormer at 128^2, and UNet++ ResNet-18 with the
decoder ``(8, 8, 8, 8, 8)`` at 32^2 with 3 classes (softmax) and 1 class
(sigmoid). Weights cross through the JAX package's converter (DOFA) or the
port's ``from_jax_*`` converters. Everything runs in f32.

Tolerances: probabilities within 1e-5 absolute (they lie in [0, 1]; the
logits agree within the model tests' 1e-4 of their largest value, and the
softmax and sigmoid only shrink a difference); the baked embedding within
1e-6 of JAX's (one generator, two frameworks); the encoder and neck
fields within 1e-4 of the largest output, as the model tests.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tiny import (
    TINY,
    TINY_MIT,
    WAVES,
    jax_variables,
    numpy_state,
    perturb,
    register_tiny,
    register_tiny_mit,
    tiny_model,
)

from geo_deep_learning_tpu.inference import export as jexport
from geo_deep_learning_tpu.models import convert as jconvert
from geo_deep_learning_tpu.models.encoders.dofa import DOFAv2 as JaxDOFAv2
from geo_deep_learning_tpu.models.necks.multilevel import MultiLevelNeck as JaxNeck
from geo_deep_learning_tpu.models.segmentation.dofa import DOFASegmentation as JaxDOFASeg
from geo_deep_learning_tpu.models.segmentation.segformer import SegFormer as JaxSegFormer
from geo_deep_learning_tpu.models.segmentation.unetpp import UnetPlusPlus as JaxUnetPlusPlus
from geo_deep_learning_tpu_torch.inference import export as texport
from geo_deep_learning_tpu_torch.models.convert import from_jax_unetpp_params
from geo_deep_learning_tpu_torch.models.encoders import dofa as tdofa
from geo_deep_learning_tpu_torch.models.necks.multilevel import MultiLevelNeck
from geo_deep_learning_tpu_torch.models.segmentation.segformer import SegFormer
from geo_deep_learning_tpu_torch.models.segmentation.unetpp import UnetPlusPlus
from geo_deep_learning_tpu_torch.ops import fused_upconv
from geo_deep_learning_tpu_torch.ops.cuda import mha as tmha
from geo_deep_learning_tpu_torch.tools.script_model import ScriptModel

ROOT = Path(__file__).resolve().parents[1]
PROB_TOL = 1e-5
MEAN, STD = [0.42, 0.45, 0.40], [0.17, 0.16, 0.18]
UNETPP_DECODER = (8, 8, 8, 8, 8)


def _raw(seed: int, b: int, size: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0, 255, (b, size, size, 3)).astype(np.float32)


def _call_nodes(program) -> int:
    return sum(n.op == "call_function" for gm in program.graph_module.modules()
               if hasattr(gm, "graph") for n in gm.graph.nodes)


def _export(serving, size: int, path: Path):
    texport.export_model(serving, (2, size, size, 3), path, device="cpu")
    return texport.load_exported(path, device="cpu")


def _hold(loaded, jax_serve, size: int, seed: int) -> None:
    """The loaded program at batch 4 and at batch 2 (the first two images)
    from one artifact, against the jitted JAX serving function at batch 4
    (its eval forward treats the images one by one)."""
    x = _raw(seed, 4, size)
    want = np.asarray(jax.jit(jax_serve)(jnp.asarray(x)))
    for b in (2, 4):
        got = loaded(x[:b]).numpy()
        assert got.shape == want[:b].shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want[:b], atol=PROB_TOL, rtol=0)


@pytest.fixture(scope="module")
def dofa_module(tmp_path_factory):
    """The tiny DOFA (port and JAX), and its wavelength and baked serving
    programs, exported once for the module's tests."""
    with pytest.MonkeyPatch.context() as mp:
        register_tiny(mp)
        port = tiny_model(num_classes=3)
        table = port.encoder.pos_embed.numpy()
        jmodel = JaxDOFASeg(encoder_name="tiny", num_classes=3, decoder_channels=32,
                            pos_embed_table=table)
        tmp = tmp_path_factory.mktemp("dofa")
        serving = texport.make_serving_fn(port, MEAN, STD, 3, wavelengths=WAVES,
                                          precision="32-true")
        x = torch.from_numpy(_raw(3, 2, 64))
        with torch.no_grad():
            before = serving(x)
        # the factored resize + conv's matrices, asked for first by the trace
        fused_upconv._tap_matrix.cache_clear()
        static = _export(serving, 64, tmp / "static.pt2")
        with torch.no_grad():
            after = serving(x)
        baked = _export(texport.make_serving_fn(
            port, MEAN, STD, 3, baked_embed=texport.bake_dofa_embedding(port, WAVES, 3,
                                                                        variant="tiny"),
            precision="32-true"), 64, tmp / "baked.pt2")
        yield port, jmodel, jax_variables(port), {
            "static": static, "baked": baked, "path": tmp / "static.pt2",
            "tap_check": (x, before, after)}


@pytest.fixture
def dofa(dofa_module, monkeypatch):
    register_tiny(monkeypatch)
    return dofa_module


def _taps_counts(size: int) -> dict[str, int]:
    """The tiny DOFA's LayerNorm and attention calls a forward: each block
    two LayerNorms, the plain one (K2) where no residual is pending (block 0
    and each block after a tap), one attention call a block."""
    depth, taps = TINY["depth"], set(TINY["out_indices"])
    plain = sum(1 for i in range(depth) if i == 0 or i - 1 in taps)
    hd = TINY["embed_dim"] // TINY["num_heads"]
    tokens = tdofa.token_grid(size, 14) ** 2 + 1
    attn = {"packed": "attention_fwd_packed", "head_major": "attention_fwd_hm"}[
        tmha.route(TINY["num_heads"], tokens, hd)]
    return {"layernorm_fwd": plain, "layernorm_residual_fwd": 2 * depth - plain, attn: depth}


def test_dofa_with_wavelengths_matches_jax(dofa):
    _, jmodel, variables, programs = dofa
    loaded = programs["static"]
    assert texport.gdl_nodes(loaded.program) == _taps_counts(64)
    _hold(loaded, jexport.make_serving_fn(jmodel.apply, variables, MEAN, STD, 3,
                                          wavelengths=WAVES), 64, seed=1)


@pytest.mark.parametrize("convert_to_16", [False, True], ids=["k14", "k16"])
def test_bake_dofa_embedding_matches_jax(dofa, convert_to_16):
    """The port's OIHW weight is the JAX HWIO kernel transposed."""
    port, _, variables, _ = dofa
    weight, bias = texport.bake_dofa_embedding(port, WAVES, 3, variant="tiny",
                                               convert_to_16=convert_to_16)
    jk, jb = jexport.bake_dofa_embedding(variables, WAVES, 3, variant="tiny",
                                         convert_to_16=convert_to_16)
    k = 16 if convert_to_16 else 14
    assert weight.shape == (TINY["embed_dim"], 3, k, k) and jk.shape == (k, k, 3, TINY["embed_dim"])
    np.testing.assert_allclose(weight.permute(2, 3, 1, 0).numpy(), np.asarray(jk), atol=1e-6,
                               rtol=0)
    np.testing.assert_allclose(bias.numpy(), np.asarray(jb), atol=1e-6, rtol=0)
    state = {k: v for k, v in port.state_dict().items() if k.startswith("encoder.")}
    again, _ = texport.bake_dofa_embedding({k[len("encoder."):]: v for k, v in state.items()},
                                           WAVES, 3, variant="tiny", convert_to_16=convert_to_16)
    assert torch.equal(again, weight)


def test_baked_dofa_matches_jax_with_fewer_nodes(dofa):
    """The baked program equals the JAX baked serving function and holds
    fewer call nodes than the wavelength program (the generator is gone),
    as the JAX package's ``test_baked_embedding_skips_generator`` asks."""
    _, jmodel, variables, programs = dofa
    loaded = programs["baked"]
    assert _call_nodes(loaded.program) < _call_nodes(programs["static"].program)
    assert texport.gdl_nodes(loaded.program) == _taps_counts(64)
    jbaked = jexport.bake_dofa_embedding(variables, WAVES, 3, variant="tiny")
    _hold(loaded, jexport.make_serving_fn(jmodel.apply, variables, MEAN, STD, 3,
                                          baked_embed=jbaked), 64, seed=2)


def test_export_leaves_no_fake_tensor_in_the_tap_cache(dofa):
    """The factored resize + conv's matrices (``fused_upconv._tap_matrix``,
    a cache, emptied first) asked for first under ``torch.export``'s fake
    tensors (the module fixture's first export): an eager forward
    afterwards returns real tensors equal to those before the export, and
    the exported program (its batch symbolic) holds them as constants."""
    programs = dofa[3]
    x, before, after = programs["tap_check"]
    assert type(after) is torch.Tensor
    assert torch.equal(after, before)
    assert torch.equal(programs["static"](x), before)


def _perturb(tree, rng):
    """BatchNorm and norm scales, biases and statistics away from their
    identity inits."""
    def leaf(path, x):
        name, x = path[-1].key, np.asarray(x)
        if name == "scale":
            return x + 0.2 * rng.standard_normal(x.shape).astype(np.float32)
        if name in ("bias", "mean"):
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        if name == "var":
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return x

    return jax.tree_util.tree_map_with_path(leaf, tree)


def test_segformer_matches_jax(monkeypatch, tmp_path):
    """Stage 1 at 128^2 attends 1024 queries over 16 reduced tokens: the
    program holds one K10 node, and the other stages the einsum."""
    register_tiny_mit(monkeypatch)
    size = 128
    port = SegFormer("tiny_mit", num_classes=3)
    port.init_weights(torch.Generator().manual_seed(4))
    perturb(port, np.random.default_rng(4))
    jmodel = JaxSegFormer(encoder_name="tiny_mit", num_classes=3)
    variables = jconvert.convert_segformer_model(numpy_state(port))
    loaded = _export(texport.make_serving_fn(port, MEAN, STD, 3, precision="32-true"), size,
                     tmp_path / "s.pt2")
    assert texport.gdl_nodes(loaded.program) == {"sr_attention_fwd": TINY_MIT["depths"][0]}
    _hold(loaded, jexport.make_serving_fn(jmodel.apply, variables, MEAN, STD, 3), size, seed=4)


@pytest.fixture(scope="module")
def unetpp_variables():
    """JAX UNet++ ResNet-18 variables with 3 classes, BatchNorms perturbed."""
    jmodel = JaxUnetPlusPlus(encoder_name="resnet18", num_classes=3,
                             decoder_channels=UNETPP_DECODER)
    return _perturb(jax.jit(jmodel.init)(jax.random.PRNGKey(5), jnp.asarray(_raw(0, 2, 32))),
                    np.random.default_rng(5))


@pytest.mark.parametrize("num_classes", [3, 1], ids=["softmax", "sigmoid"])
def test_unetpp_matches_jax(tmp_path, unetpp_variables, num_classes):
    """One class: the head's first output channel of the 3-class weights."""
    size = 32
    variables = jax.tree.map(np.asarray, unetpp_variables)
    head = variables["params"]["head"]
    head["kernel"], head["bias"] = head["kernel"][..., :num_classes], head["bias"][:num_classes]
    jmodel = JaxUnetPlusPlus(encoder_name="resnet18", num_classes=num_classes,
                             decoder_channels=UNETPP_DECODER)
    port = UnetPlusPlus("resnet18", num_classes=num_classes, decoder_channels=UNETPP_DECODER)
    port.load_state_dict(from_jax_unetpp_params(variables["params"], variables["batch_stats"]),
                         strict=True)
    loaded = _export(texport.make_serving_fn(port, MEAN, STD, num_classes, precision="32-true"),
                     size, tmp_path / "u.pt2")
    assert not texport.gdl_nodes(loaded.program)  # cuDNN's convolutions, no hand kernel
    _hold(loaded, jexport.make_serving_fn(jmodel.apply, variables, MEAN, STD, num_classes),
          size, seed=5)


@pytest.mark.parametrize("convert_patch_to_16", [False, True], ids=["k14", "k16"])
def test_encoder_fields_match_jax(dofa, convert_patch_to_16):
    """``out_indices`` and ``convert_patch_to_16`` of the encoder against
    the JAX encoder's fields, with its own sincos positions at the grid."""
    source, _, variables, _ = dofa
    size, taps = 64, (2,)
    port = tdofa.DOFAv2("tiny", img_size=size, out_indices=taps,
                        convert_patch_to_16=convert_patch_to_16)
    port.init_weights(torch.Generator().manual_seed(0))
    state = {k[len("encoder."):]: v for k, v in source.state_dict().items()
             if k.startswith("encoder.") and k != "encoder.pos_embed"}
    port.load_state_dict({**state, "pos_embed": port.pos_embed}, strict=True)
    jenc = JaxDOFAv2(variant="tiny", out_indices=taps, convert_patch_to_16=convert_patch_to_16)
    x = ((_raw(6, 2, size) / 255.0 - 0.4) / 0.2).astype(np.float32)
    want = jenc.apply({"params": variables["params"]["encoder"]}, jnp.asarray(x),
                      jnp.asarray(WAVES))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(WAVES))
    grid = size // 16 if convert_patch_to_16 else tdofa.token_grid(size, 14)
    assert len(got) == len(want) == 1 and got[0].shape == (2, TINY["embed_dim"], grid, grid)
    w = np.asarray(want[0])
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(), w,
                               atol=1e-4 * np.abs(w).max(), rtol=0)


def test_one_tap_neck_matches_jax():
    """One input feeds every scale through the one lateral conv, with the
    JAX neck's parameters (``lateral0`` and ``conv0``-``conv3``)."""
    d, scales = 16, (4, 2, 1, 0.5)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 4, 4, d)).astype(np.float32)
    jneck = JaxNeck(out_channels=[d] * 4, scales=list(scales), use_norm_act=True)
    variables = _perturb(jneck.init(jax.random.PRNGKey(8), [jnp.asarray(x)]), rng)
    params, stats = variables["params"], variables["batch_stats"]
    assert sorted(params) == ["conv0", "conv1", "conv2", "conv3", "lateral0"]
    port = MultiLevelNeck([d], [d] * 4, scales=scales)
    state = {}
    for src, dst in [("lateral0", "lateral_convs.0")] + [(f"conv{i}", f"convs.{i}")
                                                           for i in range(4)]:
        p, s = params[src], stats[src]
        state[f"{dst}.conv.weight"] = np.asarray(p["conv"]["kernel"]).transpose(3, 2, 0, 1)
        state[f"{dst}.conv.bias"] = np.asarray(p["conv"]["bias"])
        state[f"{dst}.norm.weight"] = np.asarray(p["bn"]["scale"])
        state[f"{dst}.norm.bias"] = np.asarray(p["bn"]["bias"])
        state[f"{dst}.norm.running_mean"] = np.asarray(s["bn"]["mean"])
        state[f"{dst}.norm.running_var"] = np.asarray(s["bn"]["var"])
        state[f"{dst}.norm.num_batches_tracked"] = np.zeros((), np.int64)
    port.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in state.items()},
                         strict=True)
    want = jneck.apply(variables, [jnp.asarray(x)])
    with torch.no_grad():
        got = port.eval()([torch.from_numpy(x).permute(0, 3, 1, 2)])
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.permute(0, 2, 3, 1).numpy(), w,
                                   atol=1e-4 * np.abs(w).max(), rtol=0)


def test_script_model_save_load(tmp_path):
    """As the JAX package's ``tests/test_tools.py::test_script_model_save_load``:
    UNet++ ResNet-18 at 32^2, 2 classes; probabilities sum to 1 and the
    saved program gives the module's."""
    model = UnetPlusPlus("resnet18", num_classes=2, decoder_channels=UNETPP_DECODER)
    model.init_weights(torch.Generator().manual_seed(0))
    x = _raw(0, 1, 32)
    sm = ScriptModel(model, (1, 32, 32, 3), mean=[0.4] * 3, std=[0.2] * 3, num_classes=2,
                     precision="32-true")
    probs = sm(x)
    torch.testing.assert_close(probs.sum(-1), torch.ones(1, 32, 32), atol=1e-4, rtol=0)
    path = sm.save(str(tmp_path / "m.pt2"), device="cpu")
    loaded = ScriptModel.load(path, device="cpu")
    torch.testing.assert_close(loaded(x), probs, atol=1e-5, rtol=0)


_LOAD = """
import sys
import numpy as np
from geo_deep_learning_tpu_torch.inference.export import load_exported
program = load_exported(sys.argv[1], device="cpu")
np.save(sys.argv[3], program(np.load(sys.argv[2])).numpy())
loaded = sorted(m for m in sys.modules if m.startswith("geo_deep_learning_tpu_torch.ops.cuda."))
print(",".join(loaded))
"""


def test_load_in_a_fresh_process(dofa, tmp_path):
    """A process that imports only ``inference.export`` loads the program
    (``load_exported`` defines the ``gdl::`` operators) and returns this
    process's output bit for bit."""
    programs = dofa[3]
    path, loaded = programs["path"], programs["static"]
    x = _raw(9, 3, 64)
    np.save(tmp_path / "x.npy", x)
    proc = subprocess.run(
        [sys.executable, "-c", _LOAD, str(path), str(tmp_path / "x.npy"), str(tmp_path / "y.npy")],
        capture_output=True, text=True, timeout=300, cwd=ROOT, check=False,
        env={**os.environ, "PYTHONPATH": str(ROOT)},
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "geo_deep_learning_tpu_torch.ops.cuda.layernorm" in proc.stdout
    np.testing.assert_array_equal(np.load(tmp_path / "y.npy"), loaded(x).numpy())
