"""General helpers (subset of `sparse_view_3dgs_pack_tpu/utils/general.py`
that the render path needs)."""

from __future__ import annotations

import os

import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def searchForMaxIteration(folder: str):
    """Max N over `iteration_N` subdirs (reference `system_utils.py`)."""
    if not os.path.isdir(folder):
        return None
    saved = [int(f.split("_")[-1]) for f in os.listdir(folder)
             if f.startswith("iteration_") and f.split("_")[-1].isdigit()]
    return max(saved) if saved else None
