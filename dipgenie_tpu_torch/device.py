"""Explicit device selection: the port never picks a device behind the
caller's back, and never moves work to the CPU when a card was asked for."""

from __future__ import annotations

import torch


class NoCudaDevice(RuntimeError):
    """The card was asked for and CUDA is unavailable."""


def resolve_device(name: str | torch.device) -> torch.device:
    """torch.device for ``"cuda"`` (the card) or ``"cpu"`` (tests, and the
    plain PyTorch versions of the kernels). Raises when the card is asked
    for and CUDA is unavailable."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise NoCudaDevice(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "false (no NVIDIA GPU or no CUDA build of PyTorch); use "
                "--device cpu for the plain PyTorch path"
            )
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {name!r}: use 'cuda' or 'cpu'")
