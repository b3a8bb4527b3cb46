"""Shared helpers of the port's parity tests: a narrow DOFA variant, a
narrow MiT variant and shallow ResNets registered in both packages, and
seeded port weights carried to the JAX package through its own converter."""

import numpy as np
import torch

from geo_deep_learning_tpu.models import convert as jconvert
from geo_deep_learning_tpu.models.encoders import dofa as jdofa
from geo_deep_learning_tpu.models.encoders import mix_transformer as jmit
from geo_deep_learning_tpu.models.encoders import resnet as jresnet
from geo_deep_learning_tpu_torch.models.encoders import dofa as tdofa
from geo_deep_learning_tpu_torch.models.encoders import mix_transformer as tmit
from geo_deep_learning_tpu_torch.models.encoders import resnet as tresnet
from geo_deep_learning_tpu_torch.models.segmentation.dofa import DOFASegmentation

WAVES = np.asarray([0.665, 0.549, 0.481], np.float32)
# 5 blocks: block 0 is no tap, so block 1 starts from a pending branch
TINY = dict(embed_dim=64, depth=5, num_heads=2, out_indices=(1, 2, 3, 4))


# at 128^2, stage 1 attends Lq = 1024 queries over Lk = 16 reduced tokens,
# which the K10 dispatch takes (its plain version on the CPU); the other
# stages (Lq 256, 64, 16) take the einsum
TINY_MIT = dict(embed_dims=(16, 32, 48, 64), num_heads=(1, 2, 3, 4), depths=(1, 1, 1, 1),
                sr_ratios=(8, 4, 2, 1), drop_path_rate=0.0)


# one block a stage (the published widths 64-512 stay: the JAX config has no
# width field); with the narrow decoder below, a UNet++ at 64^2 runs in
# seconds on the CPU
TINY_RESNETS = {
    "tiny_resnet": dict(block="basic", layers=(1, 1, 1, 1)),
    "tiny_bottleneck": dict(block="bottleneck", layers=(1, 1, 1, 1)),
    "tiny_resnext": dict(block="bottleneck", layers=(1, 1, 1, 1), groups=32, width_per_group=4),
}
TINY_DECODER = (16, 8, 8, 8, 8)


def register_tiny(monkeypatch) -> None:
    monkeypatch.setitem(jdofa.dofa_configs, "tiny", jdofa.DOFAConfig(**TINY))
    monkeypatch.setitem(tdofa.dofa_configs, "tiny", tdofa.DOFAConfig(**TINY))


def register_tiny_mit(monkeypatch) -> None:
    monkeypatch.setitem(jmit.mit_configs, "tiny_mit", jmit.MiTConfig(**TINY_MIT))
    monkeypatch.setitem(tmit.mit_configs, "tiny_mit", tmit.MiTConfig(**TINY_MIT))


def register_tiny_resnets(monkeypatch) -> None:
    for name, cfg in TINY_RESNETS.items():
        monkeypatch.setitem(jresnet.resnet_configs, name, jresnet.ResNetConfig(**cfg))
        monkeypatch.setitem(tresnet.resnet_configs, name, tresnet.ResNetConfig(**cfg))


def perturb(model: torch.nn.Module, rng) -> None:
    """Random norm/BN/LayerScale values in place of their constant inits,
    so that every branch moves the output."""
    with torch.no_grad():
        for name, t in model.state_dict().items():
            leaf = name.rsplit(".", 1)[-1]
            shape = tuple(t.shape)
            if leaf == "gamma":
                value = rng.uniform(0.2, 0.6, shape)
            elif leaf == "running_mean":
                value = 0.2 * rng.standard_normal(shape)
            elif leaf == "running_var":
                value = rng.uniform(0.5, 1.5, shape)
            elif "norm" in name and leaf == "weight":
                value = 1.0 + 0.2 * rng.standard_normal(shape)
            elif "norm" in name and leaf == "bias":
                value = 0.2 * rng.standard_normal(shape)
            else:
                continue
            t.copy_(torch.from_numpy(value.astype(np.float32)))


def numpy_state(model: torch.nn.Module) -> dict:
    return {k: v.numpy() for k, v in model.state_dict().items()}


def tiny_model(num_classes: int, seed: int = 0) -> DOFASegmentation:
    model = DOFASegmentation("tiny", num_classes=num_classes, decoder_channels=32, img_size=64)
    model.init_weights(torch.Generator().manual_seed(seed))
    perturb(model, np.random.default_rng(seed))
    return model.eval()


def jax_variables(model: torch.nn.Module) -> dict:
    """The JAX package's variables for ``model``'s weights."""
    return jconvert.convert_dofa_model(numpy_state(model), num_heads=TINY["num_heads"])
