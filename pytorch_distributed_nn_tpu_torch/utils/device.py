"""Device choice of the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> the card (raises when there is none); otherwise the
    named device. Never a silent CPU fallback."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless the caller "
            "asks for the CPU (device='cpu')"
        )
    return dev


def deterministic() -> None:
    """cuDNN's deterministic algorithms in this process, so that a run
    resumed from a checkpoint continues bit for bit: the sweep's trials
    and the chaos suite's ranks."""
    torch.backends.cudnn.deterministic = True
