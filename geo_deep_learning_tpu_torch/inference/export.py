"""Deployment export: a saved ``torch.export`` program with preprocessing baked in.

Port of ``geo_deep_learning_tpu/inference/export.py`` (reference
``tools/script_model.py:10-86``): the eval model with normalization and
standardization in front and softmax / sigmoid behind, so that the saved
artifact takes raw 0..255 imagery. Where the JAX package serializes
StableHLO, the port saves a ``torch.export`` program (``.pt2``) with a
symbolic batch dimension: one artifact serves any batch size.

The kernels run behind ``gdl::`` operators (``ops/cuda/_lib.py``), so the
exported graph holds one ``gdl::`` node a kernel call, and the loaded
program launches the same kernels as the eager model. A process that loads
a program must have those operators defined: :func:`load_exported` imports
their modules itself.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch
from torch import nn

from geo_deep_learning_tpu_torch.core.precision import PrecisionPolicy
from geo_deep_learning_tpu_torch.ops.cuda import _lib

BAKED_PREFIXES = ("encoder.patch_embed.", "patch_embed.")


def bake_dofa_embedding(
    model_or_state: nn.Module | dict,
    wavelengths: Sequence[float],
    in_channels: int,
    variant: str = "dofa_base",
    convert_to_16: bool = False,
) -> tuple[torch.Tensor, torch.Tensor]:
    """DOFA's wavelength-generated patch embedding, computed ONCE.

    ``model_or_state``: a ``DOFASegmentation`` or ``DOFAv2`` (or its state
    dict). Returns the OIHW conv weight ``[D, C, k, k]`` (``[D, C, 16, 16]``
    with ``convert_to_16``) and the bias ``[D]``, in f32 on the weights'
    device; :func:`make_serving_fn` takes them as ``baked_embed``, so the
    served program does not run the weight generator.
    """
    from geo_deep_learning_tpu_torch.models.encoders.dofa import DOFAv2Embedding, dofa_configs

    state = model_or_state.state_dict() if isinstance(model_or_state, nn.Module) else model_or_state
    prefix = next((p for p in BAKED_PREFIXES if any(k.startswith(p) for k in state)), None)
    if prefix is None:
        msg = f"no DOFA patch embedding ({' or '.join(BAKED_PREFIXES)}*) in the weights"
        raise ValueError(msg)
    sub = {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}
    cfg = dofa_configs[variant]
    embed = DOFAv2Embedding(cfg.embed_dim, cfg.patch_size, convert_to_16=convert_to_16)
    embed.load_state_dict(sub, strict=True)
    device = next(iter(sub.values())).device
    embed = embed.to(device).float().eval()
    with torch.no_grad(), torch.autocast(device_type=device.type, enabled=False):
        weight, bias = embed.generate(torch.as_tensor(wavelengths, dtype=torch.float32,
                                                      device=device))
    if weight.shape[1] != in_channels:
        msg = f"{len(wavelengths)} wavelengths give {weight.shape[1]} channels, not {in_channels}"
        raise ValueError(msg)
    return weight, bias


class ServingModule(nn.Module):
    """Raw ``[B, H, W, C]`` 0..``scale_max`` floats -> ``[B, H, W, classes]``
    probabilities: ``/ scale_max``, ``(x - mean) / std``, the model in eval
    mode under the precision policy (bf16 autocast for ``bf16-mixed``, as
    ``training/steps.py`` runs it), then softmax over the classes, or a
    sigmoid for one class."""

    def __init__(
        self, model: nn.Module, mean, std, num_classes: int, scale_max: float,
        wavelengths, baked_embed, precision: str,
    ) -> None:
        super().__init__()
        self.model = model.eval()
        self.num_classes = num_classes
        self.scale_max = float(scale_max)
        self.policy = PrecisionPolicy.create(precision)
        device = next(model.parameters()).device

        def buffer(value) -> torch.Tensor:
            return torch.as_tensor(np.asarray(value, np.float32), device=device)

        self.register_buffer("mean", buffer(mean))
        self.register_buffer("std", buffer(std))
        self.register_buffer("wavelengths", None if wavelengths is None else buffer(wavelengths))
        self.baked = baked_embed is not None
        if self.baked:
            weight, bias = baked_embed
            self.register_buffer("baked_weight", weight.detach().to(device, torch.float32))
            self.register_buffer("baked_bias", bias.detach().to(device, torch.float32))

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = (image.to(torch.float32) / self.scale_max - self.mean) / self.std
        x = self.policy.cast_input(x).permute(0, 3, 1, 2)
        with self.policy.autocast(x.device):
            if self.baked:
                out = self.model(x, baked_embed=(self.baked_weight, self.baked_bias))
            elif self.wavelengths is not None:
                out = self.model(x, self.wavelengths)
            else:
                out = self.model(x)
        logits = (out.out if hasattr(out, "out") else out).float()
        probs = torch.sigmoid(logits) if self.num_classes == 1 else torch.softmax(logits, dim=1)
        return probs.permute(0, 2, 3, 1)


def make_serving_fn(
    model: nn.Module,
    mean: Sequence[float],
    std: Sequence[float],
    num_classes: int,
    scale_max: float = 255.0,
    wavelengths: Sequence[float] | None = None,
    baked_embed: tuple | None = None,
    precision: str = "bf16-mixed",
) -> ServingModule:
    """Raw image batch ``[B, H, W, C]`` (0..255 floats) -> class
    probabilities ``[B, H, W, classes]``, as an ``nn.Module`` on the
    model's device.

    ``baked_embed``: DOFA's pre-baked patch embedding from
    :func:`bake_dofa_embedding`; the exported program then holds the
    generated conv weight as a constant and does not run the generator.
    ``precision``: ``"bf16-mixed"`` (the bf16 kernels) or ``"32-true"``.
    """
    return ServingModule(model, mean, std, num_classes, scale_max, wavelengths, baked_embed,
                         precision)


def export_model(
    serving: nn.Module,
    input_shape: tuple[int, ...],
    output_path: str | Path,
    batch_polymorphic: bool = True,
    device: str | torch.device = "cuda",
) -> Path:
    """``torch.export`` the serving module on a ``[B, H, W, C]`` f32 input
    of ``input_shape`` on ``device`` and save the program (``.pt2``).

    ``batch_polymorphic``: the batch dimension is symbolic (any B >= 1),
    so one artifact serves any batch size.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        msg = "export on the card: CUDA is not available (pass device='cpu' for the CPU)"
        raise RuntimeError(msg)
    serving = serving.to(device).eval()
    shape = tuple(input_shape)
    if batch_polymorphic:  # an example batch of 1 would fix the dimension at 1
        shape = (max(2, shape[0]), *shape[1:])
    example = torch.zeros(shape, dtype=torch.float32, device=device)
    dynamic = ({0: torch.export.Dim("batch", min=1)},) if batch_polymorphic else None
    with torch.no_grad():
        program = torch.export.export(serving, (example,), dynamic_shapes=dynamic)
    out = Path(output_path)
    torch.export.save(program, out)
    return out


def gdl_nodes(program) -> dict[str, int]:
    """The ``gdl::`` operator calls of an exported program, by operator, in
    all of its graphs (an autocast region is a graph of its own): one a
    kernel call of the traced forward."""
    counts: dict[str, int] = {}
    for gm in program.graph_module.modules():
        for node in gm.graph.nodes if hasattr(gm, "graph") else ():
            if node.op == "call_function" and getattr(node.target, "namespace", None) == "gdl":
                counts[node.target._opname] = counts.get(node.target._opname, 0) + 1
    return counts


class LoadedProgram:
    """A loaded serving program: takes a numpy array or a tensor ``[B, H,
    W, C]`` and returns the probabilities as a tensor on ``device``."""

    def __init__(self, program, device: torch.device) -> None:
        self.program = program
        self.module = program.module()
        self.device = device

    def __call__(self, image) -> torch.Tensor:
        x = torch.as_tensor(image, dtype=torch.float32).to(self.device)
        with torch.inference_mode():
            return self.module(x)


def load_exported(path: str | Path, device: str | torch.device = "cuda") -> LoadedProgram:
    """Load a program saved by :func:`export_model` onto ``device``.

    Defines the ``gdl::`` operators first (their modules' import), which a
    saved program names and ``torch.export.load`` needs.
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        msg = "load on the card: CUDA is not available (pass device='cpu' for the CPU)"
        raise RuntimeError(msg)
    _lib.load_ops()
    return LoadedProgram(torch.export.load(Path(path)), device)
