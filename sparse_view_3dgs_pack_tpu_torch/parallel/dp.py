"""View data parallelism over `torch.distributed`.

Counterpart of `sparse_view_3dgs_pack_tpu/parallel/dp.py`. Each step
renders B distinct training views against replicated Gaussians, k = B /
world size of them on each rank (one process per device: NCCL between
CUDA cards, gloo between CPU processes). The parameter gradient is that of
the mean of the B per-view losses (`train/step.py::view_losses`, the full
objective): each rank runs `loss_and_grads` on its views with the loss
scaled by 1/B, so one SUM all-reduce gives the mean's gradient. Adam,
exposure Adam and the densification statistics then run identically on
every rank, so the replicas stay bitwise equal; densify, prune and opacity
reset run on each replica from the same statistics and the same generator
seeds (`train/loop.py`).

What JAX does and the port matches:
* one step of B views is one step on the mean of the B per-view losses;
  with `sparse_adam` the visibility is the OR over the views;
* the DWT running mean becomes the mean of the per-view new means;
* the metrics are the mean over views; `n_pairs` is the max;
* the densification statistics are the summed per-view norms of the
  view-space gradient, the summed visible counts and the max of the
  radii (`train/densify.py::densification_stats`, per view, summed
  here). The view-space gradient is that of the mean, so each view's norm
  is 1/B of its size in a single-device step: JAX differentiates
  `losses.mean()` with respect to the per-view offsets (JAX
  `parallel/dp.py:157-162`), which its module docstring (`:31-35`) calls
  identical to B sequential iterations.

The collectives are `torch.distributed` calls between kernels: one SUM
all-reduce of every parameter gradient, the exposure gradient, the summed
statistics, the metric sums and the running-mean sum, flattened into one
buffer, and one MAX all-reduce of the radii (which give the visibility)
and the pair count. JAX let XLA insert its psum; nothing here is a kernel.
"""

from __future__ import annotations

import datetime
import os
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..models.gaussians import STAT_NAMES, GaussianModel
from ..train.densify import apply_densification_stats, densification_stats
from ..train.optim import (AdamState, ExposureAdamState, adam_update,
                           exposure_adam_update)
from ..train.step import CameraBank, StepConfig, loss_and_grads
from ..utils.tracing import span

# How long a rank waits in a collective before the group fails: a viewer
# that holds training on rank 0 (`keep_alive`) holds the other ranks in
# the next all-reduce for as long.
DP_TIMEOUT = datetime.timedelta(minutes=30)


def resolve_data_parallel(value, device) -> int:
    """CLI `--data_parallel`: '', 'off' or None → 1; 'auto' → every CUDA
    card on a CUDA device, 1 on the CPU; else the int (at least 1). On the
    CPU an int N is used as given: N gloo processes are the counterpart of
    JAX's virtual host devices."""
    if value in (None, "", "off"):
        return 1
    if isinstance(value, str) and value.lower() == "auto":
        return (torch.cuda.device_count()
                if torch.device(device).type == "cuda" else 1)
    return max(int(value), 1)


def clamp_data_parallel(n: int, device) -> int:
    """`n` clamped to the CUDA cards there are, with the JAX CLI's warning
    (JAX `train/loop.py:134-139`); the CPU takes any `n`."""
    if torch.device(device).type != "cuda":
        return n
    n_dev = torch.cuda.device_count()
    if n > n_dev:
        print(f"[dp] WARNING: --data_parallel {n} > {n_dev} devices; "
              f"clamping")
        n = n_dev
    return n


class DPGroup(NamedTuple):
    """This process's place in a data-parallel run (the counterpart of
    JAX's mesh). Where a function takes `group=None`, one process does
    the work with no collective: the oracle of a world of B views."""
    rank: int
    world_size: int
    pg: object             # torch.distributed ProcessGroup
    device: torch.device


def init_group(rank: int, world_size: int, init_method: str, device,
               backend: Optional[str] = None) -> DPGroup:
    """Join the process group (NCCL for a CUDA device, gloo for the CPU,
    unless `backend` says otherwise; collectives time out after
    DP_TIMEOUT) and make `device` this process's."""
    device = resolve_device(device)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=DP_TIMEOUT)
    return DPGroup(rank, world_size, dist.group.WORLD, device)


def _run_rank(rank, fn, devices, init_method, backend, args, threads):
    torch.set_num_threads(threads)
    group = init_group(rank, len(devices), init_method, devices[rank],
                       backend)
    try:
        fn(group, *args)
    finally:
        dist.destroy_process_group()


def launch(fn, devices, rendezvous: str, args=(),
           backend: Optional[str] = None) -> None:
    """Run fn(group, *args) in one new process per entry of `devices`
    (rank r on devices[r]; a device may repeat where the backend allows
    it), joined through a file rendezvous at the path `rendezvous`, which
    must not be in use; blocks until every rank returns and raises if one
    fails. `fn` must be importable (a module-level function). Each rank
    gets an equal share of this process's intra-op threads."""
    path = os.path.abspath(rendezvous)
    if os.path.exists(path):
        os.remove(path)
    threads = max(1, torch.get_num_threads() // len(devices))
    try:
        torch.multiprocessing.spawn(
            _run_rank, args=(fn, [str(d) for d in devices], "file://" + path,
                             backend, tuple(args), threads),
            nprocs=len(devices), join=True)
    finally:
        if os.path.exists(path):
            os.remove(path)


def state_tensors(model: GaussianModel, adam: AdamState,
                  exp_adam: ExposureAdamState, running: torch.Tensor) -> list:
    """Every tensor of a replica's training state, in a fixed order."""
    names = list(model.params())
    return ([getattr(model, k) for k in names]
            + [model.exposure] + [getattr(model, k) for k in STAT_NAMES]
            + [adam.m[k] for k in names] + [adam.v[k] for k in names]
            + [exp_adam.m, exp_adam.v, running])


@torch.no_grad()
def broadcast_state(group: Optional[DPGroup], model, adam, exp_adam,
                    running) -> None:
    """Rank 0's training state into every replica, in place (the
    counterpart of JAX's `replicate`): after init and after a checkpoint
    restore."""
    if group is None or group.world_size == 1:
        return
    for t in state_tensors(model, adam, exp_adam, running):
        dist.broadcast(t, src=0, group=group.pg)


def _all_reduce(parts: list, op, pg, dtype) -> list:
    """One collective over `parts` flattened into a buffer of `dtype`;
    the parts back in their shapes."""
    flat = torch.cat([t.reshape(-1).to(dtype) for t in parts])
    dist.all_reduce(flat, op=op, group=pg)
    out, i = [], 0
    for t in parts:
        out.append(flat[i:i + t.numel()].reshape(t.shape).to(t.dtype))
        i += t.numel()
    return out


def _add(acc, x):
    return x if acc is None else acc + x


def dp_train_step(model: GaussianModel, adam: AdamState,
                  exp_adam: ExposureAdamState,
                  dwt_running_mean: torch.Tensor, bank: CameraBank,
                  cam_idxs, n_views: int, lrs: dict, exposure_lr: float,
                  depth_weight: float, active_degree: int, bg_color,
                  cfg: StepConfig, group: Optional[DPGroup] = None):
    """One data-parallel step: this rank's views `cam_idxs` of the step's
    `n_views` (B), forward and backward each, the all-reduces over
    `group`, then Adam + exposure Adam and the statistics. Updates
    `model`, `adam`, `exp_adam` in place; returns (metrics, new DWT running
    mean), both the means over the B views (`n_pairs` the max)."""
    scale = 1.0 / n_views
    names = list(model.params())
    grads = {k: None for k in names}
    exp_grad = norms = counts = max_r = run_sum = None
    metric_sums: dict = {}
    n_pairs = 0
    for cam_idx in cam_idxs:
        sg = loss_and_grads(model, bank, cam_idx, depth_weight,
                            active_degree, bg_color, dwt_running_mean, cfg,
                            loss_scale=scale)
        with span("step/stats"):
            g, c, r = densification_stats(sg.viewspace_grad[None],
                                          sg.radii[None], cfg.width,
                                          cfg.height)
        norms, counts = _add(norms, g), _add(counts, c)
        max_r = r if max_r is None else torch.maximum(max_r, r)
        for k in names:
            grads[k] = _add(grads[k], sg.grads[k])
        exp_grad = _add(exp_grad, sg.exposure_grad)
        run_sum = _add(run_sum, sg.new_running)
        for k, v in sg.metrics.items():
            if k == "n_pairs":
                n_pairs = max(n_pairs, v)
            else:
                metric_sums[k] = _add(metric_sums.get(k), v)
    keys = sorted(metric_sums)
    sums = ([grads[k] for k in names] + [exp_grad, norms, counts, run_sum]
            + [metric_sums[k] for k in keys])
    if group is not None:
        with span("dp/allreduce"):
            sums = _all_reduce(sums, dist.ReduceOp.SUM, group.pg,
                               torch.float32)
            max_r, n_pairs = _all_reduce(
                [max_r, torch.tensor(float(n_pairs), dtype=torch.float64,
                                     device=max_r.device)],
                dist.ReduceOp.MAX, group.pg, torch.float64)
    grads = dict(zip(names, sums))
    exp_grad, norms, counts, run_sum = sums[len(names):len(names) + 4]
    with span("step/adam"):
        visibility = (max_r > 0) if cfg.sparse_adam else None
        adam_update(model.params(), grads, adam, lrs, visibility=visibility)
        exposure_adam_update(model.exposure, exp_grad, exp_adam,
                             exposure_lr)
    with span("step/stats"):
        apply_densification_stats(model, norms, counts, max_r)
    metrics = {k: v / n_views for k, v in zip(keys, sums[len(names) + 4:])}
    metrics["n_pairs"] = int(n_pairs)
    return metrics, run_sum / n_views
