"""Port parity for the training losses (`losses/`): value and gradient of
each against `jax.value_and_grad` of the JAX function on the same numpy
images. Tolerance: values rtol 1e-5, gradients atol 1e-5 of the largest
JAX gradient — f32 sums taken in another order (the JAX SSIM and Haar steps
are banded matmuls, the port's a convolution and strided slices)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu.losses import depth as jax_depth
from sparse_view_3dgs_pack_tpu.losses import dwt as jax_dwt
from sparse_view_3dgs_pack_tpu.losses import photometric as jax_photo
from sparse_view_3dgs_pack_tpu.losses.ssim import ssim as jax_ssim
from sparse_view_3dgs_pack_tpu_torch.losses import depth, dwt, photometric
from sparse_view_3dgs_pack_tpu_torch.losses.ssim import ssim

WEIGHTS = {"ll1_weight": 1.0, "lh1_weight": 1.0, "hl1_weight": 0.5,
           "hh1_weight": 0.25, "lh2_weight": 0.5}


def _images(h, w, seed=0):
    rng = np.random.default_rng(seed)
    a = rng.random((h, w, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.2, 0, 1).astype(np.float32)
    return a, b


def _tie_elf(h, w):
    """An ELF map whose 16-px patch means all tie: the JAX threshold keeps
    every patch, more than k."""
    return np.full((h, w, 1), 0.5, np.float32)


CASES = {
    "l1": (lambda x, b, e: jax_photo.l1_loss(x, b),
           lambda x, b, e: photometric.l1_loss(x, b), (24, 40)),
    "ssim": (lambda x, b, e: jax_ssim(x, b),
             lambda x, b, e: ssim(x, b), (33, 47)),
    "dwt_subbands_even": (
        lambda x, b, e: jax_dwt.dwt_subband_loss(x, b, WEIGHTS)[0],
        lambda x, b, e: dwt.dwt_subband_loss(x, b, WEIGHTS)[0], (32, 48)),
    "dwt_subbands_odd": (
        lambda x, b, e: jax_dwt.dwt_subband_loss(x, b, WEIGHTS)[0],
        lambda x, b, e: dwt.dwt_subband_loss(x, b, WEIGHTS)[0], (33, 47)),
    "elf_map_odd": (
        lambda x, b, e: jnp.sum(jax_dwt.compute_elf_map(x) * b[..., :1]),
        lambda x, b, e: torch.sum(dwt.compute_elf_map(x) * b[..., :1]),
        (33, 47)),
    "patch_dwt": (
        lambda x, b, e: jax_dwt.compute_patch_dwt_loss(
            x, b, jax_dwt.compute_elf_map(b), patch_size=16, percentile=0.3,
            lh1_weight=0.7, hl1_weight=1.3),
        lambda x, b, e: dwt.compute_patch_dwt_loss(
            x, b, dwt.compute_elf_map(b), patch_size=16, percentile=0.3,
            lh1_weight=0.7, hl1_weight=1.3), (48, 64)),
    "patch_dwt_odd": (
        lambda x, b, e: jax_dwt.compute_patch_dwt_loss(
            x, b, jax_dwt.compute_elf_map(b), patch_size=16),
        lambda x, b, e: dwt.compute_patch_dwt_loss(
            x, b, dwt.compute_elf_map(b), patch_size=16), (37, 51)),
    "patch_dwt_tie": (
        lambda x, b, e: jax_dwt.compute_patch_dwt_loss(x, b, e,
                                                       patch_size=16),
        lambda x, b, e: dwt.compute_patch_dwt_loss(x, b, e, patch_size=16),
        (32, 48)),
    "depth_l1": (
        lambda x, b, e: jax_depth.depth_l1_loss(x[..., 0], b[..., 0],
                                                e[..., 0]),
        lambda x, b, e: depth.depth_l1_loss(x[..., 0], b[..., 0], e[..., 0]),
        (24, 40)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loss_value_and_grad_match_jax(case):
    jax_fn, port_fn, (h, w) = CASES[case]
    a, b = _images(h, w)
    if case == "patch_dwt_tie":
        e = _tie_elf(h, w)
    else:   # a depth mask with zeros, for depth_l1
        e = (np.random.default_rng(1).random((h, w, 1)) > 0.3).astype(
            np.float32)
    want, want_g = jax.value_and_grad(jax_fn)(jnp.asarray(a), jnp.asarray(b),
                                              jnp.asarray(e))
    x = torch.tensor(a, requires_grad=True)
    got = port_fn(x, torch.as_tensor(b), torch.as_tensor(e))
    got.backward()
    assert abs(float(got.detach()) - float(want)) <= 1e-5 * max(
        1.0, abs(float(want)))
    want_g = np.asarray(want_g)
    assert np.abs(want_g).max() > 0
    np.testing.assert_allclose(x.grad.numpy(), want_g,
                               atol=1e-5 * np.abs(want_g).max(), rtol=0)


@pytest.mark.parametrize("shape", [(32, 48, 3), (2, 33, 47, 3)])
def test_subbands_and_wef_maps_match_jax(shape):
    """Every subband (leading batch dim and odd sizes included), the ELF map
    on its border rows and columns, and the WEF heatmaps: atol 1e-6."""
    rng = np.random.default_rng(2)
    x = rng.random(shape).astype(np.float32)
    want = jax_dwt.get_dwt_subbands(jnp.asarray(x))
    got = dwt.get_dwt_subbands(torch.as_tensor(x))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-6, err_msg=key)
    img = x if len(shape) == 3 else x[0]
    np.testing.assert_allclose(
        dwt.compute_elf_map(torch.as_tensor(img)).numpy(),
        np.asarray(jax_dwt.compute_elf_map(jnp.asarray(img))), atol=1e-6)
    gt = np.clip(img + 0.1, 0, 1)
    want = jax_dwt.compute_wef_maps(jnp.asarray(img), jnp.asarray(gt))
    got = dwt.compute_wef_maps(torch.as_tensor(img), torch.as_tensor(gt))
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(
        dwt.make_heatmap_rgb(got["WEF"]).numpy(),
        np.asarray(jax_dwt.make_heatmap_rgb(want["WEF"])), atol=1e-5)
