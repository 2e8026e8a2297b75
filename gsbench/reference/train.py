"""Plain reference of the 3DGS / LGDWT-GS training step: the losses, Adam
and the learning rates, and the reference's steps from a seed-made state.

A frozen copy of the port's `losses/photometric.py`, `losses/ssim.py`,
`losses/dwt.py`, `train/step.py::photometric_losses`, `train/optim.py::
adam_update` and `utils/general.py::get_expon_lr_func`. The depth term of
the step is left out: the cells have no depth prior (`has_depth` 0), so
the program adds 0 · 0 and its gradient is zero. The densification
statistics are not kept: a refine step past the densify window never reads
them.
"""

from __future__ import annotations

import contextlib
import math

import numpy as np
import torch
import torch.nn.functional as F

from . import render as rr

BETA1, BETA2, EPS = 0.9, 0.999, 1e-15
SSIM_C1, SSIM_C2 = 0.01 ** 2, 0.03 ** 2
_S = 1.0 / math.sqrt(2.0)
_BANDS = ("LL1", "LH1", "HL1", "HH1", "LL2", "LH2", "HL2", "HH2")


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matmuls and convolutions in full f32 (the configurations'
    precision), or in TF32 (the control, one step below it)."""
    m, c = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


def expon_lr(lr_init, lr_final, lr_delay_steps=0, lr_delay_mult=1.0,
             max_steps=1000000):
    """The 3DGS log-linear learning-rate schedule, evaluated in float32."""
    f32 = np.float32

    def helper(step) -> float:
        if lr_init == 0.0 or lr_final == 0.0:
            return 0.0
        step = f32(step)
        if lr_delay_steps > 0:
            delay = f32(lr_delay_mult) + f32(1 - lr_delay_mult) * np.sin(
                f32(0.5 * np.pi) * np.clip(step / f32(lr_delay_steps),
                                           f32(0), f32(1)))
        else:
            delay = f32(1.0)
        t = np.clip(step / f32(max_steps), f32(0), f32(1))
        log_lerp = np.exp(np.log(f32(lr_init)) * (f32(1) - t)
                          + np.log(f32(lr_final)) * t)
        return float(f32(delay * log_lerp))

    return helper


def learning_rates(opt: dict, extent: float, it: int) -> dict:
    """Every group's learning rate at iteration `it` (3DGS `training_setup`)."""
    xyz = expon_lr(opt["position_lr_init"] * extent,
                   opt["position_lr_final"] * extent,
                   lr_delay_mult=opt["position_lr_delay_mult"],
                   max_steps=opt["position_lr_max_steps"])(it)
    return {"xyz": xyz, "features_dc": opt["feature_lr"],
            "features_rest": opt["feature_lr"] / 20.0,
            "opacity": opt["opacity_lr"], "scaling": opt["scaling_lr"],
            "rotation": opt["rotation_lr"]}


def l1(a, b):
    return (a - b).abs().mean()


def ssim(img1, img2, window_size: int = 11):
    """Mean SSIM of (H, W, C) images, 11×11 σ = 1.5 window, zero padding."""
    C = img1.shape[-1]
    g = np.exp(-((np.arange(window_size) - window_size // 2) ** 2)
               / (2.0 * 1.5 ** 2))
    g = g / g.sum()
    win = torch.as_tensor(np.outer(g, g).astype(np.float32),
                          device=img1.device)
    win = win.expand(C, 1, window_size, window_size).contiguous()
    x = img1.permute(2, 0, 1)[None]
    y = img2.permute(2, 0, 1)[None]

    def conv(z):
        return F.conv2d(z, win, padding=window_size // 2, groups=C)

    mu1, mu2 = conv(x), conv(y)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = conv(x * x) - mu1_sq
    s2 = conv(y * y) - mu2_sq
    s12 = conv(x * y) - mu1_mu2
    m = ((2 * mu1_mu2 + SSIM_C1) * (2 * s12 + SSIM_C2)) / (
        (mu1_sq + mu2_sq + SSIM_C1) * (s1 + s2 + SSIM_C2))
    return m.mean()


def _even(x):
    if x.shape[-3] % 2:
        x = torch.cat([x, x[..., -1:, :, :]], dim=-3)
    if x.shape[-2] % 2:
        x = torch.cat([x, x[..., :, -1:, :]], dim=-2)
    return x


def haar(x):
    """One orthonormal Haar level of (..., H, W, C): (LL, LH, HL, HH)."""
    x = _even(x)
    lo = (x[..., 0::2, :, :] + x[..., 1::2, :, :]) * _S
    hi = (x[..., 0::2, :, :] - x[..., 1::2, :, :]) * _S

    def split(z):
        return ((z[..., 0::2, :] + z[..., 1::2, :]) * _S,
                (z[..., 0::2, :] - z[..., 1::2, :]) * _S)

    ll, lh = split(lo)
    hl, hh = split(hi)
    return ll, lh, hl, hh


def subbands(x) -> dict:
    ll1, lh1, hl1, hh1 = haar(x)
    ll2, lh2, hl2, hh2 = haar(ll1)
    return dict(zip(_BANDS, (ll1, lh1, hl1, hh1, ll2, lh2, hl2, hh2)))


def dwt_loss(pred, gt, weights: dict):
    pb, gb = subbands(pred), subbands(gt)
    total = pred.new_zeros(())
    for key in _BANDS:
        w = float(weights.get(key.lower(), 0.0))
        if w != 0.0:
            total = total + w * l1(pb[key], gb[key])
    return total


def elf_map(image):
    """ELF = |LL1| / (|LL1| + |HF1|), channel-summed, bilinear to (H, W, 1)."""
    b = subbands(image)
    ll = b["LL1"].abs().sum(-1, keepdim=True)
    hf = (b["LH1"].abs().sum(-1, keepdim=True)
          + b["HL1"].abs().sum(-1, keepdim=True)
          + b["HH1"].abs().sum(-1, keepdim=True))
    low = ll / (ll + hf + 1e-8)
    up = F.interpolate(low.permute(2, 0, 1)[None],
                       size=(image.shape[-3], image.shape[-2]),
                       mode="bilinear", align_corners=False)
    return up[0].permute(1, 2, 0)


def patch_dwt_loss(pred, gt, elf, patch: int, percentile: float,
                   lh1_w: float, hl1_w: float):
    """L1 of the level-1 detail bands over the top-`percentile` ELF patches
    (kept: mean ≥ the (L·(1 − percentile))-th smallest)."""
    H, W = pred.shape[-3], pred.shape[-2]
    if H < patch or W < patch:
        return pred.new_zeros(())
    ny, nx = H // patch, W // patch
    L = ny * nx

    def patches(x):
        x = x[:ny * patch, :nx * patch]
        x = x.reshape(ny, patch, nx, patch, x.shape[-1])
        return x.permute(0, 2, 1, 3, 4).reshape(L, patch, patch, x.shape[-1])

    pp, gp, ep = patches(pred), patches(gt), patches(elf)
    means = ep.mean(dim=(1, 2, 3))
    k = min(max(int(L * (1.0 - percentile)), 1), L)
    mask = (means >= torch.sort(means).values[k - 1]).to(pred.dtype)
    pb, gb = subbands(pp), subbands(gp)

    def sel(a, b):
        per = (a - b).abs().mean(dim=(1, 2, 3))
        return (per * mask).sum() / torch.clamp(mask.sum(), min=1.0)

    return (lh1_w * sel(pb["LH1"], gb["LH1"]) + hl1_w * sel(pb["HL1"],
                                                             gb["HL1"])
            + 0.5 * (lh1_w + hl1_w) * sel(pb["HH1"], gb["HH1"]))


def loss(image, gt, running, opt: dict):
    """(loss, the new DWT running mean) of one view: L1 + SSIM, and for
    LGDWT-GS the scaled DWT subbands and the ELF-patch DWT."""
    ll1 = l1(image, gt)
    base = (1.0 - opt["lambda_dssim"]) * ll1 + opt["lambda_dssim"] * (
        1.0 - ssim(image, gt))
    total, new_running = base, running
    if opt["dwt_enable"]:
        weights = {k.lower(): opt[f"dwt_{k.lower()}_weight"] for k in _BANDS}
        d = dwt_loss(image, gt, weights)
        new_running = 0.95 * running + 0.05 * (base.detach()
                                               / (d.detach() + 1e-8))
        total = total + torch.clamp(new_running, 0.1, 10.0).detach() * d
    if opt["patch_dwt_enable"]:
        total = total + opt["patch_dwt_weight"] * patch_dwt_loss(
            image, gt, elf_map(gt), opt["patch_size"],
            opt["patch_percentile"], opt["patch_dwt_lh1_weight"],
            opt["patch_dwt_hl1_weight"])
    return total, new_running.detach()


@torch.no_grad()
def adam(params: dict, grads: dict, m: dict, v: dict, step: int,
         lrs: dict) -> None:
    """One Adam step of every group in place (one step count for all)."""
    dev = next(iter(params.values())).device
    t = torch.tensor(float(step), dtype=torch.float32, device=dev)
    bc1 = 1.0 - torch.tensor(BETA1, dtype=torch.float32, device=dev) ** t
    bc2 = 1.0 - torch.tensor(BETA2, dtype=torch.float32, device=dev) ** t
    for k, p in params.items():
        g = grads[k]
        m[k] = BETA1 * m[k] + (1 - BETA1) * g
        v[k] = BETA2 * v[k] + (1 - BETA2) * (g * g)
        p.copy_(p - lrs[k] * (m[k] / bc1) / (torch.sqrt(v[k] / bc2) + EPS))


def steps(params: dict, m: dict, v: dict, adam_step: int, start_it: int,
          views: list, targets: list, cfg: dict, extent: float,
          running: float = 1.0, tf32: bool = False) -> dict:
    """The reference's steps from a state: one view each (`views[i]` against
    `targets[i]`), in place on `params`, `m`, `v`. Returns each step's loss,
    each group's gradient norm at the first step, and the forward's `Work`
    and pair count of each step."""
    opt = cfg["opt"]
    W, H = cfg["width"], cfg["height"]
    bg = torch.zeros(3, device=params["xyz"].device)
    running = torch.tensor(running, device=bg.device)
    out = {"loss": [], "grad_norm": None, "work": [], "pairs": []}
    with precision(tf32):
        for i, (view, gt) in enumerate(zip(views, targets)):
            it = start_it + i + 1
            leaves = {k: p.detach().requires_grad_(True)
                      for k, p in params.items()}
            image, work, pairs = rr.render_train(leaves, view, W, H, bg,
                                                 cfg["sh_degree"])
            total, running = loss(image, gt, running, opt)
            total.backward()
            grads = {k: t.grad for k, t in leaves.items()}
            if out["grad_norm"] is None:
                out["grad_norm"] = {k: float(torch.linalg.vector_norm(g))
                                    for k, g in grads.items()}
            adam(params, grads, m, v, adam_step + i + 1,
                 learning_rates(opt, extent, it))
            out["loss"].append(float(total.detach()))
            out["work"].append(work)
            out["pairs"].append(pairs)
            del leaves, grads, image, total
    return out
