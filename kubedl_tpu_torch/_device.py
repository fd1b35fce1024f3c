"""The one device rule every entry point of the port applies."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the card: ``cuda`` when one is present, else an
    error. The CPU runs only when the caller names it (``device="cpu"``,
    as the tests do) — a server that quietly fell back to the CPU would
    answer every request hundreds of times slower with a 200 status."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is not "
                           "available")
    return dev
