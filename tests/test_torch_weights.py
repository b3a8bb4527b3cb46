"""Initial weights in the port against the JAX package, on the CPU: warm
starts from a port checkpoint (``weights_from_checkpoint_path`` with
``load_parts``) and pretrained encoders from torch files (``torch_weights``).

The pretrained files are synthetic ``torch.save`` files that the tests
write from seeded port encoders: a torchvision-layout ResNet (with its
``fc`` head, loaded for 3 and, through ``patch_first_conv``, 4 bands), a
SegFormer MiT, and an HF-layout DOFA artifact (a ``model.`` prefix, extra
pretraining keys, a 14^2 position grid). The JAX package's
``load_pretrained_tree`` + ``merge_pretrained`` on the same file, then its
forward, must equal the port's forward within 1e-4 absolute (f32 on both
sides, the DOFA parity tolerance). The DOFA encoder here is 128 wide with
2 heads, the head count the JAX converter infers from that width.
"""

import copy
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_tiny import (
    TINY_DECODER,
    perturb,
    register_tiny,
    register_tiny_mit,
    register_tiny_resnets,
    tiny_model,
)

from geo_deep_learning_tpu.models import convert as jconvert
from geo_deep_learning_tpu.models.encoders import dofa as jdofa
from geo_deep_learning_tpu.models.segmentation.dofa import DOFASegmentation as JaxDOFASeg
from geo_deep_learning_tpu.models.segmentation.segformer import SegFormer as JaxSegFormer
from geo_deep_learning_tpu.models.segmentation.unetpp import UnetPlusPlus as JaxUnetPlusPlus
from geo_deep_learning_tpu_torch.cli import main as cli
from geo_deep_learning_tpu_torch.cli.config import load_config
from geo_deep_learning_tpu_torch.core.train_state import TrainState
from geo_deep_learning_tpu_torch.data.geotiff import write_geotiff
from geo_deep_learning_tpu_torch.models import convert
from geo_deep_learning_tpu_torch.models.encoders import dofa as tdofa
from geo_deep_learning_tpu_torch.models.encoders.mix_transformer import MixVisionTransformer
from geo_deep_learning_tpu_torch.models.encoders.resnet import ResNetEncoder
from geo_deep_learning_tpu_torch.models.layers import init_torch_default
from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation
from geo_deep_learning_tpu_torch.models.segmentation.segformer import SegFormer
from geo_deep_learning_tpu_torch.models.segmentation.unetpp import UnetPlusPlus
from geo_deep_learning_tpu_torch.training import optim
from geo_deep_learning_tpu_torch.training.checkpoint import (
    CheckpointManager,
    load_weights_from_checkpoint,
)

ROOT = Path(__file__).resolve().parents[1]
PORT_CONFIG = ROOT / "geo_deep_learning_tpu_torch" / "configs" / "dofa_upernet_waterloo.yaml"
WAVES = np.asarray([0.665, 0.549, 0.481], np.float32)
TINY128 = dict(embed_dim=128, depth=4, num_heads=2, out_indices=(0, 1, 2, 3))


# ---------------------------------------------------------------- warm starts


def _checkpoint(tmp_path: Path, model: torch.nn.Module, extra: dict | None = None) -> Path:
    state = TrainState.create(model, optim.build_optimizer(model.parameters(), "adam", 1e-3), 0)
    path = CheckpointManager(tmp_path / "ckpt").save_last(state)
    if extra:
        saved = torch.load(path, weights_only=True)
        saved["model"].update(extra)
        torch.save(saved, path)
    return path


@pytest.fixture
def pair(tmp_path, monkeypatch):
    """A checkpoint of one tiny DOFA and a second, differently seeded one."""
    register_tiny(monkeypatch)
    source = tiny_model(num_classes=2, seed=0)
    path = _checkpoint(tmp_path, source, extra={"extra_head.weight": torch.ones(3)})
    return source.state_dict(), path, tiny_model(num_classes=2, seed=1)


def test_warm_start_loads_the_whole_model(pair):
    want, path, model = pair
    loaded = load_weights_from_checkpoint(path, model)
    assert sorted(loaded) == sorted(want)  # the file's extra tensor is ignored
    for name, t in model.state_dict().items():
        assert torch.equal(t, want[name]), name


@pytest.mark.parametrize("parts", [["encoder"], ["head"], "neck.convs.1", ["norm", "cls_token"]])
def test_warm_start_load_parts_rule(pair, parts):
    """A tensor is taken when its dotted name starts with an entry or
    contains it (JAX ``prefix.startswith(p) or p in prefix``): ``head``
    takes ``head.*`` and ``aux_head.*``, BatchNorm statistics included."""
    want, path, model = pair
    before = copy.deepcopy(model.state_dict())
    loaded = load_weights_from_checkpoint(path, model, parts)
    entries = [parts] if isinstance(parts, str) else parts
    rule = {n for n in before if any(n.startswith(p) or p in n for p in entries)}
    assert set(loaded) == rule and rule
    for name, t in model.state_dict().items():
        assert torch.equal(t, want[name] if name in rule else before[name]), name
    if parts == ["head"]:
        assert any(n.startswith("aux_head.") and n.endswith("running_var") for n in rule)


def test_warm_start_errors(pair, tmp_path):
    _, path, model = pair
    with pytest.raises(FileNotFoundError):
        load_weights_from_checkpoint(tmp_path / "absent.pt", model)
    saved = torch.load(path, weights_only=True)
    saved["model"]["head.conv.weight"] = torch.zeros(1)
    torch.save(saved, path)
    with pytest.raises(ValueError, match="shape mismatch at head.conv.weight"):
        load_weights_from_checkpoint(path, model)


# ------------------------------------------------------ pretrained encoders


def _init(module, *args):
    return jax.jit(module.init)(jax.random.PRNGKey(0), *args)


def _seeded(module: torch.nn.Module, seed: int) -> dict[str, torch.Tensor]:
    """``module``'s seeded weights, norms and statistics off their inits."""
    gen = torch.Generator().manual_seed(seed)
    if hasattr(module, "init_weights"):
        module.init_weights(gen)
    else:
        init_torch_default(module, gen)
    perturb(module, np.random.default_rng(seed))
    return module.state_dict()


def _compare(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.detach().permute(0, 2, 3, 1).numpy()
    assert got.shape == want.shape and np.abs(want).max() > 1e-2
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("bands", [3, 4])
def test_resnet_torch_weights_match_jax(tmp_path, monkeypatch, bands):
    register_tiny_resnets(monkeypatch)
    source = ResNetEncoder("tiny_resnet", 3)
    file = {**_seeded(source, 3), "fc.weight": torch.ones(10, 512), "fc.bias": torch.zeros(10)}
    path = tmp_path / "resnet.pth"
    torch.save(file, path)

    x = np.random.default_rng(0).standard_normal((2, 64, 64, bands)).astype(np.float32)
    jmodel = JaxUnetPlusPlus(encoder_name="tiny_resnet", decoder_channels=TINY_DECODER)
    variables = _init(jmodel, jnp.asarray(x))
    merged = jconvert.merge_pretrained(
        dict(variables), jconvert.load_pretrained_tree(str(path), "resnet", bands), "encoder")
    want = jax.jit(lambda v, x: jmodel.apply(v, x).out)(merged, jnp.asarray(x))

    port = UnetPlusPlus("tiny_resnet", decoder_channels=TINY_DECODER, in_channels=bands)
    port.load_state_dict(convert.from_jax_unetpp_params(variables["params"],
                                                        variables["batch_stats"]))
    converted = convert.load_pretrained_tree(path, "resnet", bands)
    written = convert.merge_pretrained(port.eval(), converted, "encoder")
    assert "encoder.fc.weight" not in written and "encoder.layer4.0.bn2.running_var" in written
    with torch.no_grad():
        _compare(port(torch.from_numpy(x).permute(0, 3, 1, 2)).out, want)


def test_mit_torch_weights_match_jax(tmp_path, monkeypatch):
    register_tiny_mit(monkeypatch)
    path = tmp_path / "mit.pth"
    torch.save({"state_dict": _seeded(MixVisionTransformer("tiny_mit", 3), 4)}, path)

    x = np.random.default_rng(1).standard_normal((2, 64, 64, 3)).astype(np.float32)
    jmodel = JaxSegFormer(encoder_name="tiny_mit", num_classes=1)
    variables = _init(jmodel, jnp.asarray(x))
    merged = jconvert.merge_pretrained(
        dict(variables), jconvert.load_pretrained_tree(str(path), "mit"), "encoder")
    want = jax.jit(lambda v, x: jmodel.apply(v, x).out)(merged, jnp.asarray(x))

    port = SegFormer("tiny_mit", num_classes=1)
    port.load_state_dict(convert.from_jax_segformer_params(variables["params"],
                                                           variables["batch_stats"]))
    convert.merge_pretrained(port.eval(), convert.load_pretrained_tree(path, "mit"), "encoder")
    with torch.no_grad():
        _compare(port(torch.from_numpy(x).permute(0, 3, 1, 2)).out, want)


def _hf_dofa_artifact(path: Path, variant: str, seed: int) -> dict[str, torch.Tensor]:
    """An HF-layout DOFA file from a seeded 196^2 encoder (14^2 grid):
    ``model.``-prefixed blocks, norm, cls_token and pos_embed, plus
    pretraining keys that the loaders must drop; returns the encoder's state."""
    encoder = tdofa.DOFAv2(variant, img_size=196)
    state = _seeded(encoder, seed)
    with torch.no_grad():
        state["pos_embed"].add_(0.1 * torch.randn(state["pos_embed"].shape,
                                                  generator=torch.Generator().manual_seed(seed)))
    file = {}
    for key, value in state.items():
        hf = key.startswith(("blocks.", "norm.")) or key in ("cls_token", "pos_embed")
        file[f"model.{key}" if hf else key] = value
    file["model.head.weight"] = torch.ones(4, encoder.embed_dim)
    file["model.mask_token"] = torch.zeros(1, 1, encoder.embed_dim)
    torch.save({"model": file}, path)
    return state


def test_dofa_torch_weights_match_jax(tmp_path, monkeypatch):
    monkeypatch.setitem(jdofa.dofa_configs, "tiny128", jdofa.DOFAConfig(**TINY128))
    monkeypatch.setitem(tdofa.dofa_configs, "tiny128", tdofa.DOFAConfig(**TINY128))
    path = tmp_path / "dofa.pth"
    state = _hf_dofa_artifact(path, "tiny128", 5)
    assert state["pos_embed"].shape[1] == 14 * 14 + 1  # the port's grid at 64^2 is 4^2

    x = np.random.default_rng(2).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jconverted = jconvert.load_pretrained_tree(str(path), "dofa")
    jmodel = JaxDOFASeg(encoder_name="tiny128", num_classes=2, decoder_channels=32,
                        pos_embed_table=np.asarray(jconverted["pos_embed"]))
    variables = _init(jmodel, jnp.asarray(x), jnp.asarray(WAVES))
    merged = jconvert.merge_pretrained(dict(variables), jconverted, "encoder")
    want = jax.jit(lambda v, x, w: jmodel.apply(v, x, w).out)(
        merged, jnp.asarray(x), jnp.asarray(WAVES))

    port = DOFASegmentation("tiny128", num_classes=2, decoder_channels=32, img_size=64)
    port.init_weights(torch.Generator().manual_seed(0))
    port.load_state_dict(convert.from_jax_params(
        variables["params"], variables["batch_stats"], pos_embed=port.encoder.pos_embed.numpy()))
    converted = convert.load_pretrained_tree(path, "dofa")
    assert not any(k.startswith(("model.", "head.", "mask_token")) for k in converted)
    written = convert.merge_pretrained(port.eval(), converted, "encoder")
    assert "encoder.pos_embed" in written
    for key, value in state.items():
        if key != "pos_embed":
            assert torch.equal(port.encoder.state_dict()[key], value), key
    with torch.no_grad():
        _compare(port(torch.from_numpy(x).permute(0, 3, 1, 2), torch.from_numpy(WAVES)).out,
                 want)


def test_pretrained_loader_errors(tmp_path, monkeypatch):
    register_tiny(monkeypatch)
    with pytest.raises(ValueError, match="Flax tree"):
        convert.load_pretrained_tree(tmp_path / "encoder.msgpack", "dofa")
    path = tmp_path / "dofa.pth"
    _hf_dofa_artifact(path, "tiny", 6)
    with pytest.raises(ValueError, match="unknown torch_weights format"):
        convert.load_pretrained_tree(path, "vit")
    model = tiny_model(num_classes=2)
    converted = convert.load_pretrained_tree(path, "dofa")
    with pytest.raises(KeyError, match="missing in model"):
        convert.merge_pretrained(model, {**converted, "blocks.9.ls1.gamma": torch.ones(64)})
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.merge_pretrained(model, {**converted, "cls_token": torch.ones(1, 1, 8)})
    np.testing.assert_array_equal(
        convert.bicubic_matrix(32, 14), jconvert._bicubic_matrix(32, 14))


# ------------------------------------------------ the recipe through the CLI


def _dataset(root: Path, splits: dict[str, int], size: int = 64) -> None:
    rng = np.random.default_rng(0)
    for split, n in splits.items():
        rows = []
        for kind in ("image", "label"):
            (root / split / kind).mkdir(parents=True, exist_ok=True)
        for i in range(n):
            write_geotiff(root / split / "image" / f"{i}.tif",
                          rng.integers(0, 256, (size, size, 3), dtype=np.uint8))
            write_geotiff(root / split / "label" / f"{i}_lbl.tif",
                          rng.integers(0, 2, (size, size), dtype=np.uint8))
            rows.append(f"{split}/image/{i}.tif;{split}/label/{i}_lbl.tif")
        (root / f"{split}.csv").write_text("\n".join(rows) + "\n")


def test_recipe_fit_from_torch_weights_then_warm_started_test(tmp_path, monkeypatch):
    """The DOFA recipe's shape: the encoder from an HF artifact and frozen,
    ``fit``; then ``test`` with ``weights_from_checkpoint_path`` at the best
    checkpoint gives the metrics of ``test --ckpt-path`` on it."""
    register_tiny(monkeypatch)
    _dataset(tmp_path / "data", {"trn": 4, "val": 2, "tst": 3})
    artifact = tmp_path / "dofa.pth"
    _hf_dofa_artifact(artifact, "tiny", 7)
    cfg = load_config(PORT_CONFIG)
    cfg["trainer"].update(default_root_dir=str(tmp_path / "run"), max_epochs=2,
                          precision="32-true")
    cfg["model"]["init_args"].update(
        encoder="tiny", image_size=[64, 64], decoder_channels=32, freeze_layers=["encoder"],
        torch_weights={"path": str(artifact), "format": "dofa"},
        loss={"class_path": "segmentation_models_pytorch.losses.JaccardLoss",
              "init_args": {"mode": "binary"}})
    cfg["data"]["init_args"].update(csv_root_folder=str(tmp_path / "data"),
                                    patches_root_folder=str(tmp_path / "data"), batch_size=2,
                                    patch_size=[64, 64], num_workers=2)
    fitted = cli.run(copy.deepcopy(cfg), "fit", device="cpu")
    assert np.isfinite(fitted["test_loss"])
    index = tmp_path / "run" / "checkpoints" / "index.json"
    best = json.loads(index.read_text())["best_path"]
    model = torch.load(best, weights_only=True)["model"]
    encoder = DOFASegmentation("tiny", num_classes=1, decoder_channels=32, img_size=64)
    encoder.init_weights(torch.Generator().manual_seed(0))
    convert.merge_pretrained(encoder, convert.load_pretrained_tree(artifact, "dofa"))
    for key, value in encoder.state_dict().items():
        if key.startswith("encoder."):
            assert torch.equal(model[key], value), key  # frozen: as converted
    restored = cli.run(copy.deepcopy(cfg), "test", device="cpu", ckpt_path=best)
    cfg["model"]["init_args"]["weights_from_checkpoint_path"] = best
    warm = cli.run(copy.deepcopy(cfg), "test", device="cpu")
    assert warm == restored
    assert {k: v for k, v in fitted.items() if k.startswith("test_")} == pytest.approx(restored)


def test_evaluation_skips_an_absent_artifact_with_a_warning(tmp_path, monkeypatch, caplog):
    """At evaluation a ``torch_weights`` file missing on the host is skipped
    with a warning (JAX ``_eval_torch_weights``); a warm start still loads."""
    register_tiny(monkeypatch)
    _dataset(tmp_path / "data", {"tst": 3})
    cfg = load_config(PORT_CONFIG)
    cfg["trainer"].update(default_root_dir=str(tmp_path / "run"), precision="32-true")
    cfg["model"]["init_args"].update(encoder="tiny", image_size=[64, 64], decoder_channels=32)
    cfg["data"]["init_args"].update(csv_root_folder=str(tmp_path / "data"),
                                    patches_root_folder=str(tmp_path / "data"), batch_size=2,
                                    patch_size=[64, 64], num_workers=2)
    plain = cli.run(copy.deepcopy(cfg), "test", device="cpu")
    cfg["model"]["init_args"]["torch_weights"] = {"path": str(tmp_path / "absent.pth"),
                                                  "format": "dofa"}
    with caplog.at_level("WARNING"):
        assert cli.run(copy.deepcopy(cfg), "test", device="cpu") == plain
    assert any("not found on this host" in r.message for r in caplog.records)
