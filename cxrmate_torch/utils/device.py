"""Device selection: the port's entry points run on the card unless the caller
asks for the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``torch.device`` for ``device``; a CUDA device must exist — there is no
    silent fallback to the CPU (pass ``device="cpu"`` for that)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev
