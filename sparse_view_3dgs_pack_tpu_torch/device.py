"""Explicit device resolution.

Every entry point of the port takes a device name and resolves it here. A
request for CUDA on a machine without it raises: the port never falls back
to the CPU behind the caller's back.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device) -> torch.device:
    """`"cuda"`, `"cuda:N"` or `"cpu"` → torch.device; raises when CUDA is
    asked for and `torch.cuda.is_available()` is False."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but torch.cuda.is_available() "
                "is False (this torch build or machine has no CUDA)")
        if dev.index is not None and dev.index >= torch.cuda.device_count():
            raise RuntimeError(f"device {str(dev)!r} requested but only "
                               f"{torch.cuda.device_count()} CUDA device(s)")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {str(dev)!r}: use cuda or cpu")
    return dev
