"""General helpers: LR schedules, quaternion → rotation, seeding.

Counterpart of `sparse_view_3dgs_pack_tpu/utils/general.py` (reference
`utils/general_utils.py`, `utils/system_utils.py`).
"""

from __future__ import annotations

import os
import random
import sys
from datetime import datetime

import numpy as np
import torch


def inverse_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x / (1.0 - x))


def get_expon_lr_func(lr_init, lr_final, lr_delay_steps=0,
                      lr_delay_mult=1.0, max_steps=1000000):
    """Continuous log-lerp LR schedule with an optional sine warm-up delay
    (reference `general_utils.py:61`), evaluated in float32 like the JAX
    version. Returns 0 when either endpoint is 0 (a disabled group); the
    step is clamped to [0, max_steps]. → step → float."""
    f32 = np.float32

    def helper(step) -> float:
        if lr_init == 0.0 or lr_final == 0.0:
            return 0.0
        step = f32(step)
        if lr_delay_steps > 0:
            delay_rate = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps),
                                           f32(0), f32(1)))
        else:
            delay_rate = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                          + np.log(f32(lr_final)) * t)
        return float(f32(delay_rate * log_lerp))

    return helper


def build_rotation(q: torch.Tensor) -> torch.Tensor:
    """Unit-normalised quaternion (w, x, y, z) → rotation matrix, (..., 3, 3).
    The +1e-24 keeps the gradient finite at q = 0, as in the JAX version."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + 1e-24)
    q = q / torch.clamp(norm, min=1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


class _TimestampedStdout:
    def __init__(self, wrapped, silent):
        self._wrapped = wrapped
        self._silent = silent

    def write(self, x):
        if self._silent:
            return
        if x.endswith("\n"):
            stamp = datetime.now().strftime("%d/%m %H:%M:%S")
            x = x[:-1].replace("\n", f"\n[{stamp}]")
            self._wrapped.write(f"{x} [{stamp}]\n")
        else:
            self._wrapped.write(x)

    def flush(self):
        self._wrapped.flush()

    def __getattr__(self, name):
        return getattr(self._wrapped, name)


def safe_state(silent: bool = False, seed: int = 0) -> int:
    """Seed the host RNGs and torch, and timestamp stdout lines (reference
    `general_utils.py:113`)."""
    sys.stdout = _TimestampedStdout(sys.stdout, silent)
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    return seed


def searchForMaxIteration(folder: str):
    """Max N over `iteration_N` subdirs (reference `system_utils.py`)."""
    if not os.path.isdir(folder):
        return None
    saved = [int(f.split("_")[-1]) for f in os.listdir(folder)
             if f.startswith("iteration_") and f.split("_")[-1].isdigit()]
    return max(saved) if saved else None
