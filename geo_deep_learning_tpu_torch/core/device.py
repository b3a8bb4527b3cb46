"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``device``; raise if it is a CUDA device and CUDA is absent.

    Entry points default to ``"cuda"`` and never move to the CPU on their
    own: running on the CPU must be asked for (the tests pass ``"cpu"``).
    """
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        msg = (
            "CUDA is not available; pass device='cpu' to run the port on "
            "the CPU explicitly"
        )
        raise RuntimeError(msg)
    return device
