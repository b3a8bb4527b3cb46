"""Shared helpers of the port's parity tests: a narrow DOFA variant, a
narrow MiT variant and shallow ResNets registered in both packages, and
seeded port weights carried to the JAX package through its own converter."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from geo_deep_learning_tpu.models import convert as jconvert
from geo_deep_learning_tpu.models.encoders import dofa as jdofa
from geo_deep_learning_tpu.models.encoders import mix_transformer as jmit
from geo_deep_learning_tpu.models.encoders import resnet as jresnet
from geo_deep_learning_tpu_torch.models.encoders import dofa as tdofa
from geo_deep_learning_tpu_torch.models.encoders import mix_transformer as tmit
from geo_deep_learning_tpu_torch.models.encoders import resnet as tresnet

from _torch_tiny_port import (  # noqa: F401 (re-exported to the tests)
    TINY,
    TINY_DECODER,
    TINY_MIT,
    TINY_RESNETS,
    WAVES,
    numpy_state,
    perturb,
    tiny_model,
)


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


def jax_variables(model: torch.nn.Module) -> dict:
    """The JAX package's variables for ``model``'s weights."""
    return jconvert.convert_dofa_model(numpy_state(model), num_heads=TINY["num_heads"])


class GdlCalls(TorchDispatchMode):
    """Records, into ``calls``, the name of every ``gdl::`` operator in
    ``names`` that runs while the mode is on (forwards, and backwards that
    run on this thread)."""

    def __init__(self, calls: list, names) -> None:
        super().__init__()
        self.calls, self.names = calls, set(names)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.namespace == "gdl" and func._opname in self.names:
            self.calls.append(func._opname)
        return func(*args, **(kwargs or {}))
