"""Explicit device selection: the port never picks a device on its own and
never drops quietly from the card to the CPU."""
from __future__ import annotations

import torch

DEVICES = ("cuda", "cpu")


def resolve_device(name: str) -> torch.device:
    """'cuda' or 'cpu' -> torch.device. Raises when 'cuda' is asked for and
    no card is visible."""
    if name not in DEVICES:
        raise ValueError(f"device must be one of {DEVICES}, got {name!r}")
    if name == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "--device cuda was requested but torch.cuda.is_available() is "
            "False; pass --device cpu to run the CPU twin"
        )
    return torch.device(name)
