"""The run's device: synchronise and read the allocator's peak (no-ops on
the CPU, where the tests run)."""

from __future__ import annotations

import torch


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def peak(device: torch.device) -> int:
    """Bytes at the allocator's peak since the last :func:`reset_peak`."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reset_peak(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)


def release(device: torch.device) -> None:
    """Return freed blocks to the card once the program's state is gone."""
    import gc

    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
