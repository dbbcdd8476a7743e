"""The CUDA device the port runs on, and what the card reports about itself.

Counterpart of ``poasta_tpu/utils/device_probe.py``: there is no tethered
link to probe here, so a missing card is an error, never a fallback.
"""

from __future__ import annotations

import subprocess

import torch


class NoDeviceError(RuntimeError):
    """PyTorch sees no CUDA card."""


def cuda_device() -> torch.device:
    """The first CUDA device; raises when PyTorch sees no card."""
    if not torch.cuda.is_available():
        raise NoDeviceError(
            "no CUDA device: torch.cuda.is_available() is False")
    return torch.device("cuda", 0)


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; None means the card, and raises
    without one.  A caller that wants the CPU names it."""
    return cuda_device() if device is None else torch.device(device)


def card_info() -> str:
    """The first card's ``name, power.limit`` as nvidia-smi prints them.

    A card may run below its maximum power limit, and then runs slower
    under load, so every timing the port reports carries this line.
    """
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in res.stdout.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi reported no card")
    return lines[0]
