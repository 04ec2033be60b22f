"""Device selection for the port's entry points.

The entry points run on the card unless the caller asks for the CPU; when
no card is present they raise instead of falling back."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """`device` as a `torch.device`; raises if it names CUDA and no card
    is available."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU"
        )
    return device
