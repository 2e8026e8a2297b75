"""Densification statistics, clone / split / prune, FSGS proximity
densification, opacity reset, DNGaussian's prune of an arbitrary mask.

Counterpart of `sparse_view_3dgs_pack_tpu/train/densify.py:39-242`
(reference `gaussian_model.py:316-473`). The JAX state keeps a padded
buffer with an alive prefix; the port holds only alive rows, so appended
rows are concatenated and pruning keeps the surviving rows in order. The
row order is the JAX one: the appended rows follow Gaussian by Gaussian in
index order (a clone adds one row, a split adds its two samples), then the
stable compaction drops the pruned rows — so state compares index by index.
Every row parameter (`GaussianModel.row_names()`, mult-dwtgs's NIR albedo
too) follows its source row; `nir_gain` and its moments are never indexed.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..models.gaussians import NIR_ALBEDO, STAT_NAMES, GaussianModel
from ..utils.general import build_rotation, inverse_sigmoid
from ..utils.tracing import span
from . import optim


@torch.no_grad()
def densification_stats(viewspace_grads: torch.Tensor, radii: torch.Tensor,
                        width: int, height: int) -> tuple:
    """viewspace_grads (B, N, 2) d(loss)/d(means2d in pixels) and radii
    (B, N) of B views → (N,) the per-view gradient norms summed over the
    views that see each Gaussian, (N,) their count, (N,) the largest
    radius (JAX `parallel/dp.py:100-116`; summing the gradient vectors
    before the norm would cancel across views). Each norm is taken at the
    (W/2, H/2) scale of the reference CUDA backward's NDC gradient,
    keeping its 0.0002 threshold (`densify.py:42-43`)."""
    with span("sync/stats_scale"):     # a copy of host numbers
        scale = torch.tensor([width * 0.5, height * 0.5],
                             dtype=torch.float32,
                             device=viewspace_grads.device)
    g = torch.linalg.vector_norm(viewspace_grads[..., :2] * scale, dim=-1)
    visible = radii > 0
    return (torch.where(visible, g, torch.zeros_like(g)).sum(0),
            visible.to(torch.float32).sum(0),
            torch.where(visible, radii, torch.zeros_like(radii)).amax(0))


@torch.no_grad()
def apply_densification_stats(model: GaussianModel, norms: torch.Tensor,
                              counts: torch.Tensor,
                              max_radii: torch.Tensor) -> None:
    """Add `densification_stats`' sums to the model's accumulators."""
    model.xyz_gradient_accum += norms
    model.denom += counts
    model.max_radii2d.copy_(torch.maximum(model.max_radii2d,
                                          max_radii.to(torch.float32)))


def add_densification_stats(model: GaussianModel,
                            viewspace_grads: torch.Tensor,
                            radii: torch.Tensor, width: int,
                            height: int) -> None:
    """The statistics of one view ((N, 2) and (N,)) or of B views ((B, N,
    2) and (B, N)) into the model's accumulators."""
    if radii.dim() == 1:
        viewspace_grads, radii = viewspace_grads[None], radii[None]
    apply_densification_stats(model, *densification_stats(
        viewspace_grads, radii, width, height))


class DensifyResult(NamedTuple):
    cloned: int
    split: int
    pruned: int


@torch.no_grad()
def densify_and_prune(model: GaussianModel, adam: optim.AdamState,
                      max_grad: float, min_opacity: float, extent: float,
                      max_screen_size: int = 0, percent_dense: float = 0.01,
                      generator: Optional[torch.Generator] = None,
                      noise: Optional[torch.Tensor] = None,
                      extra_split_mask: Optional[torch.Tensor] = None
                      ) -> DensifyResult:
    """Clone small and split large Gaussians whose mean view-space gradient
    reaches `max_grad`, then prune: opacity < min_opacity, with
    `max_screen_size` also screen radius > max_screen_size or world size >
    0.1·extent, and every split original. Adam moments of appended rows are
    zero; statistics are zeroed afterwards. `extra_split_mask` (N,) bool
    splits those Gaussians too, whatever their gradient (FSGS's distance
    criterion, JAX `densify.py:82-85`); they are not also cloned.

    The two split samples are N(0, S) rotated into the world. `noise`
    (2, N, 3) standard-normal draws may be given (a test hands over the
    JAX draw, `densify.py:107-109`); otherwise they are drawn from
    `generator`."""
    params = model.params()
    n = model.num_points
    grads = torch.where(model.denom > 0, model.xyz_gradient_accum
                        / torch.clamp(model.denom, min=1.0),
                        torch.zeros_like(model.denom))
    stds = model.get_scaling()
    max_scale = stds.max(dim=-1).values
    selected = grads >= max_grad
    clone_mask = selected & (max_scale <= percent_dense * extent)
    split_mask = selected & (max_scale > percent_dense * extent)
    if extra_split_mask is not None:
        split_mask = split_mask | extra_split_mask
        clone_mask = clone_mask & ~split_mask

    # appended rows, Gaussian by Gaussian: one per clone, two per split
    n_new_per = clone_mask.to(torch.int64) + 2 * split_mask.to(torch.int64)
    src = torch.repeat_interleave(torch.arange(n, device=stds.device),
                                  n_new_per)
    offs = torch.cumsum(n_new_per, 0) - n_new_per
    j = torch.arange(src.shape[0], device=stds.device) - offs[src]
    is_split = split_mask[src]
    if noise is None:
        noise = torch.randn((2, n, 3), generator=generator,
                            device=stds.device)
    samples = noise[j, src] * stds[src]
    R = build_rotation(params["rotation"][src])
    split_xyz = torch.einsum("nij,nj->ni", R, samples) + params["xyz"][src]
    split_scaling = torch.log(stds[src] / (0.8 * 2))
    names = model.row_names()
    new_rows = {}
    for k in names:
        rows = params[k][src]
        if k == "xyz":
            rows = torch.where(is_split[:, None], split_xyz, rows)
        elif k == "scaling":
            rows = torch.where(is_split[:, None], split_scaling, rows)
        new_rows[k] = torch.cat([params[k], rows])
    optim.append_zero_rows(adam, names, src.shape[0])

    # prune (the appended rows carry no screen-size statistic yet)
    opac = torch.sigmoid(new_rows["opacity"][:, 0])
    prune = opac < min_opacity
    if max_screen_size:
        max_radii = torch.cat([model.max_radii2d,
                               model.max_radii2d.new_zeros(src.shape[0])])
        big_vs = max_radii > max_screen_size
        big_ws = torch.exp(new_rows["scaling"]).max(dim=-1).values \
            > 0.1 * extent
        prune = prune | big_vs | big_ws
    prune[:n] |= split_mask
    keep = ~prune
    model.set_rows({k: v[keep] for k, v in new_rows.items()})
    optim.select_rows(adam, names, keep)
    return DensifyResult(int(clone_mask.sum()), int(split_mask.sum()),
                         int(prune.sum()))


@torch.no_grad()
def proximity_densify(model: GaussianModel, adam: optim.AdamState,
                      nn_idx: torch.Tensor, mask: torch.Tensor) -> int:
    """FSGS proximity densification (JAX `densify.py:166-213`, reference
    `FSGS/scene/gaussian_model.py:405-421`): for each Gaussian in `mask`
    (N,) bool, in index order, append the midpoints to its three
    neighbours `nn_idx` (N, 3), each with the neighbour's scale, opacity
    and NIR albedo, an identity rotation and zero SH. Their Adam moments
    are zero and the statistics are cleared. Returns the number of rows
    appended."""
    params = model.params()
    src = torch.nonzero(mask).squeeze(1).repeat_interleave(3)
    nb = nn_idx[src, torch.arange(src.shape[0], device=src.device) % 3]
    nb = nb.to(torch.int64)
    n_new = src.shape[0]
    rotation = torch.zeros((n_new, 4), device=src.device)
    rotation[:, 0] = 1.0
    rows = {"xyz": 0.5 * (params["xyz"][src] + params["xyz"][nb]),
            "features_dc": torch.zeros_like(params["features_dc"][src]),
            "features_rest": torch.zeros_like(params["features_rest"][src]),
            "scaling": params["scaling"][nb], "rotation": rotation,
            "opacity": params["opacity"][nb]}
    if model.has_nir:
        rows[NIR_ALBEDO] = params[NIR_ALBEDO][nb]
    names = model.row_names()
    model.set_rows({k: torch.cat([params[k], rows[k]]) for k in names})
    optim.append_zero_rows(adam, names, n_new)
    return n_new


@torch.no_grad()
def reset_opacity(model: GaussianModel, adam: optim.AdamState) -> None:
    """opacity ← min(opacity, 0.01) pre-activation, its moments zeroed
    (reference `reset_opacity`, `gaussian_model.py:258-261`)."""
    model.opacity.copy_(inverse_sigmoid(
        torch.clamp(torch.sigmoid(model.opacity), max=0.01)))
    optim.zero_param(adam, "opacity")


@torch.no_grad()
def prune_only(model: GaussianModel, adam: optim.AdamState,
               mask: torch.Tensor) -> int:
    """Drop the Gaussians in `mask` (N,) bool, keeping the others in order
    with their Adam moments and densification statistics (JAX
    `prune_only`, `densify.py:227-242`; DNGaussian's spiral near-range
    prune, reference `train_llff.py:206-213`). Returns the number pruned."""
    keep = ~mask
    names = model.row_names()
    stats = {name: getattr(model, name)[keep] for name in STAT_NAMES}
    model.set_rows({k: getattr(model, k)[keep] for k in names})
    for name, value in stats.items():
        setattr(model, name, value)
    optim.select_rows(adam, names, keep)
    return int(mask.sum())
