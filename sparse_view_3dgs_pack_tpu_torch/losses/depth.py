"""Depth supervision losses.

Counterpart of `sparse_view_3dgs_pack_tpu/losses/depth.py`:
- `depth_l1_loss`: masked L1 between the rendered and the mono inverse
  depth (reference `LGDWT-GS/train.py:204-216`), a mean over ALL pixels —
  the mask zeroes unreliable ones;
- `pearson_corrcoef` + `fsgs_depth_loss`: FSGS's Pearson-correlation depth
  prior against a mono-depth map per view (`FSGS/train.py:100-108`), the
  min over the negated-depth and reciprocal-depth parameterisations;
- `pseudo_depth_loss`: the FSGS pseudo-view distillation term
  (`train.py:116-131`), and `warped_pseudo_depth_loss`, its masked form
  against a warped metric prior (`depth/warp.py`).
"""

from __future__ import annotations

from typing import Optional

import torch


def depth_l1_loss(rendered_invdepth: torch.Tensor,
                  mono_invdepth: torch.Tensor,
                  depth_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    d = (rendered_invdepth - mono_invdepth).abs()
    if depth_mask is not None:
        d = d * depth_mask
    return d.mean()


def pearson_corrcoef(x: torch.Tensor, y: torch.Tensor,
                     eps: float = 1e-8) -> torch.Tensor:
    x = x.reshape(-1)
    y = y.reshape(-1)
    xm = x - x.mean()
    ym = y - y.mean()
    denom = torch.sqrt((xm * xm).sum()) * torch.sqrt((ym * ym).sum())
    return (xm * ym).sum() / torch.clamp(denom, min=eps)


def pearson_corrcoef_masked(x: torch.Tensor, y: torch.Tensor,
                            mask: torch.Tensor,
                            eps: float = 1e-8) -> torch.Tensor:
    """Pearson over the masked pixels only (the warped pseudo priors cover
    part of the view)."""
    w = mask.reshape(-1).to(x.dtype)
    x = x.reshape(-1)
    y = y.reshape(-1)
    n = torch.clamp(w.sum(), min=1.0)
    xm = (x - (x * w).sum() / n) * w
    ym = (y - (y * w).sum() / n) * w
    denom = torch.sqrt((xm * xm).sum()) * torch.sqrt((ym * ym).sum())
    return (xm * ym).sum() / torch.clamp(denom, min=eps)


def warped_pseudo_depth_loss(rendered_depth: torch.Tensor,
                             warped_depth: torch.Tensor,
                             valid: torch.Tensor) -> torch.Tensor:
    """Pseudo-view distillation against a WARPED metric prior: both are
    depths, so the correlation sought is positive."""
    return 1.0 - pearson_corrcoef_masked(rendered_depth, warped_depth, valid)


def fsgs_depth_loss(rendered_depth: torch.Tensor,
                    midas_depth: torch.Tensor) -> torch.Tensor:
    """min(1 - ρ(-midas, rendered), 1 - ρ(1/(midas+200), rendered))."""
    a = 1.0 - pearson_corrcoef(-midas_depth, rendered_depth)
    b = 1.0 - pearson_corrcoef(1.0 / (midas_depth + 200.0), rendered_depth)
    return torch.minimum(a, b)


def pseudo_depth_loss(rendered_depth_pseudo: torch.Tensor,
                      midas_depth_pseudo: torch.Tensor) -> torch.Tensor:
    return 1.0 - pearson_corrcoef(rendered_depth_pseudo, -midas_depth_pseudo)
