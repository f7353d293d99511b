"""Where the port runs: the card, unless the caller names the CPU.

``default_device()`` is what every entry point uses when no ``device=``
is passed.  It returns ``cuda:0`` or **raises** — it never returns the
CPU, so a missing card is an error at the entry point rather than a
silent slow run.  Tests (and anyone who really wants the CPU) pass
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import subprocess
from typing import List, Optional, Union

import torch

DeviceLike = Union[str, torch.device, None]

_SMI_QUERY = ("nvidia-smi", "--query-gpu=name,power.limit",
              "--format=csv,noheader")


def default_device() -> torch.device:
    """``cuda:0``, or ``RuntimeError`` when no CUDA device is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch needs a CUDA device and none is available; pass "
            "device='cpu' (devices=[torch.device('cpu')] for the "
            "scheduler) to run on the CPU explicitly")
    return torch.device("cuda", 0)


def default_devices() -> List[torch.device]:
    """Every visible CUDA device (raises like :func:`default_device`
    when there is none) — what the serving layer shards flushes over."""
    default_device()
    return [torch.device("cuda", i)
            for i in range(torch.cuda.device_count())]


def as_device(device: DeviceLike) -> torch.device:
    """``None`` -> :func:`default_device`; anything else ->
    ``torch.device(device)`` (a bare ``"cuda"`` pins index 0 so device
    comparisons are exact)."""
    if device is None:
        return default_device()
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return dev


def card_info(index: int = 0) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (line ``index``), or ``None`` when the tool is missing or fails.
    Every recorded time carries this string beside it."""
    try:
        out = subprocess.run(_SMI_QUERY, capture_output=True, text=True,
                             timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = [ln.strip() for ln in out.splitlines() if ln.strip()]
    return lines[index] if index < len(lines) else None
