"""Per-group Adam with one global step, LR schedules, the sparse-Adam
visibility mask, exposure Adam, and the moment surgery densification needs.

Counterpart of `sparse_view_3dgs_pack_tpu/train/optim.py` (reference
`torch.optim.Adam(l, lr=0.0, eps=1e-15)` param groups + `get_expon_lr_func`,
`gaussian_model.py:178-223`). `torch.optim.Adam` is not used: it counts
steps per parameter, while the JAX state has one `step` for every group
(`optim.py:65`), and its update is not written in the same order. Updates
are in place; the model holds only alive rows, so the moments are row
tensors of the same length as the parameters. DNGaussian's neural field
trains with the same update over its own parameters (JAX `init_tree_adam`
/ `tree_adam_update`, `optim.py:130-155`): `init_adam(field.params())`
gives it an AdamState, and so a step counter, of its own.

`adam_update` and `exposure_adam_update` dispatch on the device: CUDA
tensors take one launch of the hand-written kernel over every group
(`ops/adam.py::adam_multi`, `csrc/adam.cu`: the bias corrections computed
on the card from the step, the moments updated in place), or a raise on
a tensor it does not take; CPU tensors run the plain versions,
`adam_update_torch` and `exposure_adam_update_torch`, which the kernel
matches bit for bit on the card.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ..ops.adam import adam_multi
from ..utils.general import get_expon_lr_func
from ..utils.tracing import span

BETA1, BETA2 = 0.9, 0.999
EPS = 1e-15
EXPOSURE_EPS = 1e-8


@dataclass
class AdamState:
    m: dict      # name → first moment (same shape as the parameter)
    v: dict      # name → second moment
    step: int = 0


@dataclass
class ExposureAdamState:
    m: torch.Tensor
    v: torch.Tensor
    step: int = 0


def init_adam(params: dict) -> AdamState:
    return AdamState(m={k: torch.zeros_like(p) for k, p in params.items()},
                     v={k: torch.zeros_like(p) for k, p in params.items()})


def init_exposure_adam(exposure: torch.Tensor) -> ExposureAdamState:
    return ExposureAdamState(m=torch.zeros_like(exposure),
                             v=torch.zeros_like(exposure))


def make_lr_schedules(opt_args, spatial_lr_scale: float) -> dict:
    """name → lr(step). Mirrors `training_setup` (`gaussian_model.py:183-211`)."""
    xyz_sched = get_expon_lr_func(
        lr_init=opt_args.position_lr_init * spatial_lr_scale,
        lr_final=opt_args.position_lr_final * spatial_lr_scale,
        lr_delay_mult=opt_args.position_lr_delay_mult,
        max_steps=opt_args.position_lr_max_steps)
    consts = {
        "features_dc": opt_args.feature_lr,
        "features_rest": opt_args.feature_lr / 20.0,
        "opacity": opt_args.opacity_lr,
        "scaling": opt_args.scaling_lr,
        "rotation": opt_args.rotation_lr,
        "nir_albedo": getattr(opt_args, "nir_albedo_lr", 0.0025),
        "nir_gain": getattr(opt_args, "nir_gain_lr", 0.001),
    }
    scheds = {"xyz": xyz_sched}
    for k, lr in consts.items():
        scheds[k] = (lambda lr_: lambda step: float(lr_))(lr)
    return scheds


def make_exposure_schedule(opt_args) -> Callable:
    return get_expon_lr_func(
        lr_init=getattr(opt_args, "exposure_lr_init", 0.01),
        lr_final=getattr(opt_args, "exposure_lr_final", 0.001),
        lr_delay_steps=getattr(opt_args, "exposure_lr_delay_steps", 0),
        lr_delay_mult=getattr(opt_args, "exposure_lr_delay_mult", 0.0),
        max_steps=getattr(opt_args, "iterations", 30000))


def cleared(params: dict) -> dict:
    """`params` (name → parameter) with their gradients cleared."""
    for t in params.values():
        t.grad = None
    return params


def grads_or_zeros(params: dict) -> dict:
    """name → the parameter's gradient, zeros where the backward gave it
    none (a group the step detached still takes its Adam step)."""
    return {k: (t.grad if t.grad is not None else torch.zeros_like(t))
            for k, t in params.items()}


@torch.no_grad()
def adam_update(params: dict, grads: dict, state: AdamState, lrs: dict,
                visibility: Optional[torch.Tensor] = None) -> None:
    """One Adam step of every group, in place. `lrs`: name → lr for this
    step. `visibility`: optional (N,) bool mask — rows outside it keep
    their parameters AND moments (SparseGaussianAdam semantics). CUDA
    tensors: one kernel launch for every group; CPU: the plain version."""
    if next(iter(params.values())).device.type != "cuda":
        adam_update_torch(params, grads, state, lrs, visibility)
        return
    state.step += 1
    names = list(params)
    adam_multi([params[k] for k in names], [grads[k] for k in names],
               [state.m[k] for k in names], [state.v[k] for k in names],
               [lrs[k] for k in names], state.step, BETA1, BETA2, EPS,
               visibility)


@torch.no_grad()
def exposure_adam_update(exposure: torch.Tensor, grad: torch.Tensor,
                         state: ExposureAdamState, lr: float) -> None:
    """Exposure Adam (eps 1e-8, `optim.py:179-186`), in place. CUDA
    tensors: one kernel launch; CPU: the plain version."""
    if exposure.device.type != "cuda":
        exposure_adam_update_torch(exposure, grad, state, lr)
        return
    state.step += 1
    adam_multi([exposure], [grad], [state.m], [state.v], [lr], state.step,
               BETA1, BETA2, EXPOSURE_EPS, square_first=False)


def _bias_corrections(step: int, device):
    """1 - β^t in float32, as the JAX update computes them (three copies
    of host numbers to the device, each of which waits for it)."""
    with span("sync/adam_bias"):
        t = torch.tensor(float(step), dtype=torch.float32, device=device)
        b1 = torch.tensor(BETA1, dtype=torch.float32, device=device)
        b2 = torch.tensor(BETA2, dtype=torch.float32, device=device)
    return 1.0 - b1 ** t, 1.0 - b2 ** t


@torch.no_grad()
def adam_update_torch(params: dict, grads: dict, state: AdamState,
                      lrs: dict,
                      visibility: Optional[torch.Tensor] = None) -> None:
    """Plain version of `adam_update`'s kernel, on any device."""
    state.step += 1
    device = next(iter(params.values())).device
    bc1, bc2 = _bias_corrections(state.step, device)
    for k, p in params.items():
        g = grads[k]
        m = BETA1 * state.m[k] + (1 - BETA1) * g
        v = BETA2 * state.v[k] + (1 - BETA2) * (g * g)
        p_new = p - lrs[k] * (m / bc1) / (torch.sqrt(v / bc2) + EPS)
        if visibility is not None:
            vis = visibility.reshape((-1,) + (1,) * (p.ndim - 1))
            p_new = torch.where(vis, p_new, p)
            m = torch.where(vis, m, state.m[k])
            v = torch.where(vis, v, state.v[k])
        p.copy_(p_new)
        state.m[k] = m
        state.v[k] = v


@torch.no_grad()
def exposure_adam_update_torch(exposure: torch.Tensor, grad: torch.Tensor,
                               state: ExposureAdamState, lr: float) -> None:
    """Plain version of `exposure_adam_update`'s kernel, on any device."""
    state.step += 1
    bc1, bc2 = _bias_corrections(state.step, exposure.device)
    m = BETA1 * state.m + (1 - BETA1) * grad
    v = BETA2 * state.v + (1 - BETA2) * grad * grad
    exposure.copy_(exposure - lr * (m / bc1)
                   / (torch.sqrt(v / bc2) + EXPOSURE_EPS))
    state.m, state.v = m, v


def append_zero_rows(state: AdamState, names, n_new: int) -> None:
    """The moments of the row parameters `names` get `n_new` appended rows
    that start at zero (`zero_adam_slots`); the others stay as they are
    (`nir_gain`'s, as JAX's `a.shape[0] == cap` guard leaves them)."""
    for d in (state.m, state.v):
        for k in names:
            a = d[k]
            d[k] = torch.cat([a, a.new_zeros((n_new,) + a.shape[1:])])


def select_rows(state: AdamState, names, keep: torch.Tensor) -> None:
    """Keep the rows where `keep` is True, in order, of the moments of the
    row parameters `names` (`permute_adam` of the stable compaction)."""
    for d in (state.m, state.v):
        for k in names:
            d[k] = d[k][keep]


def zero_param(state: AdamState, name: str) -> None:
    state.m[name] = torch.zeros_like(state.m[name])
    state.v[name] = torch.zeros_like(state.v[name])
