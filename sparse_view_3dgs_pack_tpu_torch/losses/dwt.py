"""Haar DWT subbands, ELF maps, the patch-wise DWT loss and WEF heatmaps.

Counterpart of `sparse_view_3dgs_pack_tpu/losses/dwt.py:28-218` (reference
`LGDWT-GS/utils/loss_utils.py:106-441`). One orthonormal Haar analysis
level is written with strided slices (the JAX module uses banded matmuls,
a TPU layout choice; the coefficients agree to f32 rounding). Odd sizes are
edge-replicated to even first, as symmetric padding does for length-2
filters.

Subband keys and weighting follow the reference: `get_dwt_subbands` →
{LL1..HH2}; LH = detail along x, HL = detail along y. Images are
(..., H, W, C).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .photometric import l1_loss

_S = 1.0 / math.sqrt(2.0)
_KEYS = ("LL1", "LH1", "HL1", "HH1", "LL2", "LH2", "HL2", "HH2")


def _pad_to_even(x: torch.Tensor) -> torch.Tensor:
    """Edge-replicate one row and/or column onto odd sizes."""
    if x.shape[-3] % 2:
        x = torch.cat([x, x[..., -1:, :, :]], dim=-3)
    if x.shape[-2] % 2:
        x = torch.cat([x, x[..., :, -1:, :]], dim=-2)
    return x


def haar_dwt_level(x: torch.Tensor):
    """One orthonormal Haar analysis level: (..., H, W, C) →
    (LL, LH, HL, HH), each (..., ⌈H/2⌉, ⌈W/2⌉, C)."""
    x = _pad_to_even(x)
    lo_y = (x[..., 0::2, :, :] + x[..., 1::2, :, :]) * _S
    hi_y = (x[..., 0::2, :, :] - x[..., 1::2, :, :]) * _S

    def split_x(z):
        return ((z[..., 0::2, :] + z[..., 1::2, :]) * _S,
                (z[..., 0::2, :] - z[..., 1::2, :]) * _S)

    ll, lh = split_x(lo_y)
    hl, hh = split_x(hi_y)
    return ll, lh, hl, hh


def get_dwt_subbands(x: torch.Tensor) -> dict:
    """Two-level Haar subbands {'LL1', ..., 'HH2'}."""
    ll1, lh1, hl1, hh1 = haar_dwt_level(x)
    ll2, lh2, hl2, hh2 = haar_dwt_level(ll1)
    return dict(zip(_KEYS, (ll1, lh1, hl1, hh1, ll2, lh2, hl2, hh2)))


def dwt_subband_loss(pred, gt, weights: dict):
    """Weighted per-subband L1 (`LGDWT-GS/train.py:130-163`). weights keys:
    ll1_weight, lh1_weight, ... Returns (total, per-band dict of the bands
    with a non-zero weight)."""
    pb = get_dwt_subbands(pred)
    gb = get_dwt_subbands(gt)
    total = pred.new_zeros(())
    per_band = {}
    for key in _KEYS:
        w = float(weights.get(key.lower() + "_weight", weights.get(key, 0.0)))
        if w != 0.0:
            band = l1_loss(pb[key], gb[key])
            per_band[key] = band
            total = total + w * band
    return total, per_band


def _upsample_bilinear(x: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """(h, w, C) → (H, W, C), half-pixel centres (`jax.image.resize`
    bilinear; at the borders both keep the edge sample)."""
    y = F.interpolate(x.permute(2, 0, 1)[None], size=(H, W), mode="bilinear",
                      align_corners=False)
    return y[0].permute(1, 2, 0)


def compute_elf_map(image: torch.Tensor) -> torch.Tensor:
    """ELF = ‖LL1‖₁ / (‖LL1‖₁ + ‖HF1‖₁), channel-summed, upsampled to
    (H, W, 1). image: (H, W, C)."""
    bands = get_dwt_subbands(image)

    def l1c(v):
        return v.abs().sum(-1, keepdim=True)

    ll = l1c(bands["LL1"])
    hf = l1c(bands["LH1"]) + l1c(bands["HL1"]) + l1c(bands["HH1"])
    elf_low = ll / (ll + hf + 1e-8)
    return _upsample_bilinear(elf_low, image.shape[-3], image.shape[-2])


def compute_patch_dwt_loss(pred, gt, elf_map, patch_size: int = 128,
                           percentile: float = 0.2, lh1_weight: float = 1.0,
                           hl1_weight: float = 1.0) -> torch.Tensor:
    """L1 on the level-1 HF subbands of the top-`percentile` highest-ELF
    non-overlapping patches. Selection is `means >= sort(means)[k-1]` as in
    the JAX module (`dwt.py:158-160`): under ties that keeps more than k
    patches, which `topk` would not."""
    H, W = pred.shape[-3], pred.shape[-2]
    if H < patch_size or W < patch_size:
        return pred.new_zeros(())
    ny, nx = H // patch_size, W // patch_size
    L = ny * nx

    def to_patches(x):
        x = x[:ny * patch_size, :nx * patch_size]
        x = x.reshape(ny, patch_size, nx, patch_size, x.shape[-1])
        return x.permute(0, 2, 1, 3, 4).reshape(L, patch_size, patch_size,
                                                x.shape[-1])

    pp, gp, ep = to_patches(pred), to_patches(gt), to_patches(elf_map)
    means = ep.mean(dim=(1, 2, 3))                          # (L,)
    k = min(max(int(L * (1.0 - percentile)), 1), L)
    threshold = torch.sort(means).values[k - 1]             # kthvalue
    mask = (means >= threshold).to(pred.dtype)

    pb = get_dwt_subbands(pp)
    gb = get_dwt_subbands(gp)

    def sel_l1(a, b):
        per_patch = (a - b).abs().mean(dim=(1, 2, 3))
        return (per_patch * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    loss_lh = sel_l1(pb["LH1"], gb["LH1"])
    loss_hl = sel_l1(pb["HL1"], gb["HL1"])
    loss_hh = sel_l1(pb["HH1"], gb["HH1"])
    return (lh1_weight * loss_lh + hl1_weight * loss_hl
            + 0.5 * (lh1_weight + hl1_weight) * loss_hh)


def _normalize_01(x, eps=1e-8):
    mn = x.amin(dim=(-3, -2), keepdim=True)
    mx = x.amax(dim=(-3, -2), keepdim=True)
    return (x - mn) / (mx - mn + eps)


def compute_wef_maps(pred, gt) -> dict:
    """Level-2 Wavelet Error Field heatmaps (reference `compute_wef_maps`),
    each (H, W, 1) in [0, 1]."""
    b = get_dwt_subbands(pred - gt)
    H, W = pred.shape[-3], pred.shape[-2]
    out = {}
    for key, scale in (("LL2", 4.0), ("LH2", 2.0), ("HL2", 2.0)):
        e = (b[key] * b[key] * scale).mean(-1, keepdim=True)
        out[key] = _normalize_01(_upsample_bilinear(e, H, W))
    out["WEF"] = _normalize_01((out["LL2"] + out["LH2"] + out["HL2"]) / 3.0)
    return out


def make_heatmap_rgb(x01: torch.Tensor) -> torch.Tensor:
    """(H, W, 1) in [0, 1] → jet-like (H, W, 3)."""
    x = torch.clamp(x01[..., 0], 0, 1)
    g = torch.clamp(1.0 - (x - 0.5).abs() * 2.0, 0, 1)
    return torch.stack([x, g, 1.0 - x], dim=-1)
