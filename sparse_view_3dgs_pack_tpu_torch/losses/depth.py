"""Depth supervision (counterpart of `depth_l1_loss` in
`sparse_view_3dgs_pack_tpu/losses/depth.py`; reference
`LGDWT-GS/train.py:204-216`): masked L1 between the rendered and the mono
inverse depth, a mean over ALL pixels — the mask zeroes unreliable ones.
The FSGS Pearson and pseudo-view terms come with FSGS (ROADMAP Queue 1
item 8)."""

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
