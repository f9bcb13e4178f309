"""Explicit device selection: asking for CUDA without a GPU raises, never falls back."""

from __future__ import annotations

import torch
import torch.distributed


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device that is not there.  In a process group
    (parallel/distributed.py) a bare ``cuda`` is this process's card, ``cuda:LOCAL_RANK``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} was requested but torch.cuda.is_available() is False"
        )
    if dev.type == "cuda" and dev.index is None and torch.distributed.is_available() \
            and torch.distributed.is_initialized():
        return torch.device("cuda", torch.cuda.current_device())
    return dev
