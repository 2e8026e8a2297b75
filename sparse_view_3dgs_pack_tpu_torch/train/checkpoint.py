"""Training checkpoints in the JAX package's `.npz` layout.

Counterpart of `sparse_view_3dgs_pack_tpu/train/checkpoint.py:20-81` (the
role of the reference's `torch.save((gaussians.capture(), iteration),
chkpntN.pth)`). A file holds the model, the per-group Adam state, the
exposure Adam state, the DWT running mean and the iteration, flattened
under the JAX keys: `state/['params']['xyz']`, `state/['alive']`,
`adam/['m']['xyz']`, `adam/['step']`, `exp_adam/['m']`,
`carry/['dwt_running_mean']`, `iteration`, ... The port writes its rows
only (`alive` all true, `n_alive` = N), so either package loads the other's
files; a JAX file loads here with its alive rows, as `from_jax_state`
takes them.
"""

from __future__ import annotations

import os
from types import SimpleNamespace
from typing import NamedTuple

import numpy as np
import torch

from ..models.gaussians import (PARAM_NAMES, STAT_NAMES, GaussianModel,
                                from_jax_state)
from .optim import AdamState, ExposureAdamState


class Checkpoint(NamedTuple):
    model: GaussianModel
    adam: AdamState
    exp_adam: ExposureAdamState
    dwt_running_mean: torch.Tensor   # () float32
    iteration: int


def _key(prefix: str, *path: str) -> str:
    """The JAX key of one leaf: prefix + "/" + ['a']['b'] (the
    `jax.tree_util.keystr` of a dict path)."""
    return prefix + "/" + "".join(f"['{p}']" for p in path)


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_checkpoint(path: str, model: GaussianModel, adam: AdamState,
                    exp_adam: ExposureAdamState,
                    dwt_running_mean: torch.Tensor, iteration: int) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = model.num_points
    flat = {_key("state", "params", k): _np(getattr(model, k))
            for k in PARAM_NAMES}
    flat[_key("state", "alive")] = np.ones(n, bool)
    flat[_key("state", "n_alive")] = np.asarray(n, np.int32)
    flat[_key("state", "exposure")] = _np(model.exposure)
    for k in STAT_NAMES:
        flat[_key("state", k)] = _np(getattr(model, k))
    for k in PARAM_NAMES:
        flat[_key("adam", "m", k)] = _np(adam.m[k])
        flat[_key("adam", "v", k)] = _np(adam.v[k])
    flat[_key("adam", "step")] = np.asarray(adam.step, np.int32)
    flat[_key("exp_adam", "m")] = _np(exp_adam.m)
    flat[_key("exp_adam", "v")] = _np(exp_adam.v)
    flat[_key("exp_adam", "step")] = np.asarray(exp_adam.step, np.int32)
    flat[_key("carry", "dwt_running_mean")] = np.asarray(
        _np(dwt_running_mean), np.float32)
    flat["iteration"] = np.asarray(iteration)
    np.savez_compressed(path, **flat)


def load_checkpoint(path: str,
                    device: str | torch.device = "cuda") -> Checkpoint:
    """A checkpoint written by either package, its alive rows on
    `device`."""
    with np.load(path, allow_pickle=False) as z:
        state = SimpleNamespace(
            params={k: z[_key("state", "params", k)] for k in PARAM_NAMES},
            n_alive=int(z[_key("state", "n_alive")]),
            exposure=z[_key("state", "exposure")],
            **{k: z[_key("state", k)] for k in STAT_NAMES})
        adam = SimpleNamespace(
            m={k: z[_key("adam", "m", k)] for k in PARAM_NAMES},
            v={k: z[_key("adam", "v", k)] for k in PARAM_NAMES},
            step=int(z[_key("adam", "step")]))
        exp_adam = SimpleNamespace(m=z[_key("exp_adam", "m")],
                                   v=z[_key("exp_adam", "v")],
                                   step=int(z[_key("exp_adam", "step")]))
        running = z[_key("carry", "dwt_running_mean")]
        iteration = int(z["iteration"])
    bridged = from_jax_state(state, adam, exp_adam, device=device)
    return Checkpoint(bridged.model, bridged.adam, bridged.exp_adam,
                      torch.tensor(np.asarray(running, np.float32),
                                   device=bridged.model.xyz.device),
                      iteration)
