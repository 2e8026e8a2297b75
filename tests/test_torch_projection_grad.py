"""The projection from the raw parameters (`ops/projection.py`): the plain
version of the backward kernel against autograd of the plain composition
on the CPU, `ProjectFunction`'s plumbing, and on a card (`-m cuda`) both
kernels against their plain versions and the main path's launch counts.

No JAX here: the card tests compare with the plain PyTorch versions."""

from __future__ import annotations

import itertools
from argparse import Namespace
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu_torch import renderer, testing
from sparse_view_3dgs_pack_tpu_torch.ops import projection as pj

torch.set_num_threads(1)

FIELDS = pj.ProjectionGrads._fields
OUTS = ("means2d", "depths", "conics", "colors", "opacities")


def _leaves(inp: pj.ProjectionInputs) -> pj.ProjectionInputs:
    """`inp` with every differentiable tensor a fresh leaf."""
    return inp._replace(**{f: getattr(inp, f).detach().clone()
                           .requires_grad_(True) for f in FIELDS
                           if getattr(inp, f) is not None})


def _autograd(inp: pj.ProjectionInputs, cot, fn=pj.project_raw_torch):
    """(gradients by input name, None where autograd gives none; the
    outputs) of Σ <output, cotangent> through `fn`."""
    inp = _leaves(inp)
    out = fn(inp)
    loss = sum((getattr(out, f) * c).sum() for f, c in zip(OUTS, cot))
    loss.backward()
    return {f: getattr(inp, f).grad for f in FIELDS
            if getattr(inp, f) is not None}, out


def _close(got, want, tol=1e-5):
    """|got - want| within `tol` of want's largest value."""
    assert got.shape == want.shape
    if not want.numel():
        return
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert err <= tol * max(scale, 1e-30), (err, scale)


@pytest.mark.parametrize("mode", testing.PROJECTION_MODES)
@pytest.mark.parametrize("channels", (1, 3))
@pytest.mark.parametrize("sh_degree", range(4))
def test_plain_backward_matches_autograd(sh_degree, channels, mode):
    """`project_backward_torch` against autograd of `project_raw_torch`
    with random cotangents, over every mask the backward tells apart
    (`testing.projection_case`: behind the near plane, beyond the
    Jacobian's clamp, rect-culled, SH colour clamped at 0): each gradient
    within 1e-5 of its largest (the same chain rule, summed in another
    order); where autograd gives none (the features under precomputed
    colours, the logit under an override), neither does it."""
    inp, cot = testing.projection_case(10 * sh_degree + channels, 400,
                                       channels=channels,
                                       sh_degree=sh_degree, mode=mode)
    want, out = _autograd(inp, cot)
    assert 0 < int((out.radii == 0).sum()) < 400
    got = pj.project_backward_torch(inp, cot)
    for f in FIELDS:
        g, w = getattr(got, f), want.get(f)
        if g is None:
            assert w is None, f
            continue
        if f == "features_rest" and sh_degree == 0:
            assert not bool(g.any()) and not bool(w.any())
            continue
        assert float(w.abs().max()) > 0, f
        _close(g, w)


@pytest.mark.parametrize("mode", testing.PROJECTION_MODES)
def test_project_function_runs_the_plain_versions_on_the_cpu(mode):
    """`ProjectFunction` on CPU tensors: its outputs are the plain
    composition's bit for bit, its gradients `project_backward_torch`'s,
    and it gives a gradient to exactly the inputs autograd gives one."""
    inp, cot = testing.projection_case(5, 300, sh_degree=3, mode=mode)
    want, ref = _autograd(inp, cot)
    got, out = _autograd(inp, cot, lambda i: pj.Projected(
        *pj.ProjectFunction.apply(
            i, i.xyz, i.scaling, i.opacity, i.rotation, i.features_dc,
            i.features_rest, i.colors_precomp, i.opacity_override)))
    for f in pj.Projected._fields:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    plain = pj.project_backward_torch(inp, cot)
    assert set(got) == set(want)
    for f, g in got.items():
        assert (g is None) == (want[f] is None), f
        if g is not None:
            assert torch.equal(g, getattr(plain, f)), f


def test_project_raw_on_the_cpu_is_the_plain_composition():
    """On CPU tensors `project_raw` runs the composition under autograd:
    its gradients are autograd's own, bit for bit."""
    inp, cot = testing.projection_case(6, 300, sh_degree=2,
                                       mode="confidence")
    want, ref = _autograd(inp, cot)
    got, out = _autograd(inp, cot, pj.project_raw)
    for f in pj.Projected._fields:
        assert torch.equal(getattr(out, f), getattr(ref, f)), f
    for f, g in got.items():
        assert (g is None and want[f] is None) or torch.equal(g, want[f]), f


@pytest.mark.parametrize("change", ("channels", "degree", "shape", "dtype"))
def test_project_forward_refuses_what_the_kernels_do_not_take(change):
    inp, _ = testing.projection_case(1, 50, sh_degree=3)
    bad = {"channels": lambda: inp._replace(
               features_dc=inp.features_dc.repeat(1, 1, 2)[..., :2],
               features_rest=inp.features_rest.repeat(1, 1, 2)[..., :2]),
           "degree": lambda: inp._replace(
               features_rest=inp.features_rest[:, :3]),
           "shape": lambda: inp._replace(rotation=inp.rotation[:, :3]),
           "dtype": lambda: inp._replace(xyz=inp.xyz.double())}[change]()
    with pytest.raises(ValueError):
        pj._check_inputs(bad)


# ------------------------------------------------------------------ card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _compare_forward(out, ref, P: int) -> torch.Tensor:
    """Kernel outputs against the plain version's: rows where a ceil() of
    the radius or of the rect flipped (or the tile-rect cull with it) are
    ties, at most 1e-5 of the rows and by at most 1 px; elsewhere the
    floats within 1e-5 of each value (1e-6 of the field's largest near
    zero): the 4x4 products and the two norms are summed in another
    order. Returns the rows that are not ties."""
    tie = ((out.radii != ref.radii)
           | (out.rect_radii != ref.rect_radii).any(1)
           | (torch.isinf(out.depths) != torch.isinf(ref.depths)))
    n_tie = int(tie.sum())
    assert n_tie <= int(1e-5 * P), n_tie
    assert int((out.radii - ref.radii).abs().max()) <= 1
    assert int((out.rect_radii - ref.rect_radii).abs().max()) <= 1
    keep = ~tie
    for f in OUTS:
        a, b = getattr(out, f)[keep], getattr(ref, f)[keep]
        finite = torch.isfinite(b)
        assert torch.equal(torch.isfinite(a), finite), f
        a, b = a[finite], b[finite]
        if not b.numel():
            continue
        tol = 1e-5 * b.abs() + 1e-6 * float(b.abs().max())
        assert bool(((a - b).abs() <= tol).all()), (
            f, float((a - b).abs().max()))
    return keep


def _check_kernels(inp: pj.ProjectionInputs, cot) -> None:
    """Both kernels against their plain versions: the forward as
    `_compare_forward`; the backward within 1e-4 of each gradient's
    largest against `project_backward_torch` and against autograd of the
    plain composition, on the rows that are not ties; two runs of each
    kernel bitwise equal; one launch each per call."""
    n = inp.xyz.shape[0]
    f0, b0 = pj.project_forward.launches, pj.project_backward.launches
    out = pj.project_forward(inp)
    again = pj.project_forward(inp)
    with torch.no_grad():
        ref = pj.project_raw_torch(inp)
    torch.cuda.synchronize()
    assert pj.project_forward.launches == f0 + 2
    for f in pj.Projected._fields:
        assert torch.equal(getattr(out, f), getattr(again, f)), f
    keep = _compare_forward(out, ref, n)

    got = pj.project_backward(inp, cot)
    twice = pj.project_backward(inp, cot)
    plain = pj.project_backward_torch(inp, cot)
    auto, _ = _autograd(inp, cot)
    torch.cuda.synchronize()
    assert pj.project_backward.launches == b0 + 2
    for f in FIELDS:
        g = getattr(got, f)
        if g is None:
            assert getattr(plain, f) is None and auto.get(f) is None, f
            continue
        assert torch.equal(g, getattr(twice, f)), f
        for want in (getattr(plain, f), auto[f]):
            _close(g[keep], want[keep], tol=1e-4)


CARD_CASES = [(deg, c, mode, 2000) for deg, c, mode in itertools.product(
    (0, 3), (1, 3), testing.PROJECTION_MODES)] + [(3, 3, "plain", 300_000)]


@pytest.mark.cuda
@pytest.mark.parametrize("sh_degree,channels,mode,n", CARD_CASES)
def test_cuda_projection_kernels_match_plain(sh_degree, channels, mode, n):
    """`_check_kernels` at a tenth of garden's 3M Gaussians (1297x840) and
    on the small cases of every mode."""
    dev = _card()
    w, h = (1297, 840) if n > 10_000 else (64, 48)
    inp, cot = testing.projection_case(7 + sh_degree, n, w, h, channels,
                                       sh_degree, mode, device=dev)
    _check_kernels(inp, cot)


@pytest.mark.cuda
@pytest.mark.parametrize("scene", testing.RASTER_SCENES)
def test_cuda_projection_kernels_on_the_raster_scenes(scene):
    """`_check_kernels` on the rasterizer's test scenes: SH degree 0 with
    no coefficient above the DC one, unit quaternions, piled Gaussians."""
    dev = _card()
    cloud, cam = testing.raster_scene(scene)
    p = cam.params()
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
    n, f = cloud["xyz"].shape[0], cloud["features"]
    inp = pj.ProjectionInputs(
        xyz=t(cloud["xyz"]), scaling=t(cloud["scales"]),
        opacity=t(cloud["opacity"]), rotation=t(cloud["quats"]),
        features_dc=t(f[:, :1]), features_rest=t(f[:, 1:]),
        cam=pj.ProjectionCamera(t(p.viewmat), t(p.full_proj),
                                t(p.cam_center), float(p.tan_fovx),
                                float(p.tan_fovy), cam.width, cam.height),
        sh_degree=0)
    rng = np.random.default_rng(1)
    cot = tuple(t(rng.normal(size=s)) for s in
                ((n, 2), (n,), (n, 3), (n, 3), (n,)))
    _check_kernels(inp, cot)


def _trainer(dev, n: int = 400, size: int = 48, sh_degree: int = 1):
    """An lgdwt `Trainer` of `n` Gaussians (random SH bands above the DC
    one) and 3 orbit views of random targets, on `dev`."""
    from sparse_view_3dgs_pack_tpu_torch.config import METHOD_OPTS
    from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
    from sparse_view_3dgs_pack_tpu_torch.train.loop import Trainer
    rng = np.random.default_rng(0)
    model = gm.create_from_pcd(rng.uniform(-0.8, 0.8, (n, 3)),
                               rng.random((n, 3)), n_images=3,
                               sh_degree=sh_degree, device=dev)
    with torch.no_grad():
        model.features_rest.copy_(torch.as_tensor(
            rng.normal(size=tuple(model.features_rest.shape)) * 0.2))
    cams = testing.make_orbit_cameras(3, radius=3.0, width=size)
    for c in cams:
        c.image = rng.random((size, size, 3)).astype(np.float32)
        c.alpha_mask = np.ones((size, size), np.float32)
    scene = SimpleNamespace(gaussians=model, cameras_extent=1.0,
                            getTrainCameras=lambda: cams)
    opt = Namespace(**{**METHOD_OPTS["lgdwt"], "patch_size": 16,
                       "densify_until_iter": 0})
    pipe = Namespace(debug=False, debug_from=-1, antialiasing=False)
    args = Namespace(sh_degree=sh_degree, white_background=False,
                     train_test_exp=False, source_path="", model_path="")
    return Trainer(scene, opt, pipe, args), cams


@pytest.mark.parametrize("case", [
    *(pytest.param(("cpu", a), id=str(a)) for a in range(4)),
    *(pytest.param(("cuda", a), id=f"cuda-{a}", marks=pytest.mark.cuda)
      for a in range(4))])
def test_step_evaluates_sh_to_the_active_degree_as_the_band_mask(
        case, monkeypatch):
    """`loss_and_grads` evaluates the SH colour to the active degree where
    the JAX step multiplies the bands above it by 0 (and every training
    render of FSGS, DNGaussian and mult-dwtgs does the same): the loss,
    every parameter's gradient and the view-space gradient bitwise those
    of the band-masked features evaluated at the full degree, on the CPU
    and through the kernels on a card."""
    from sparse_view_3dgs_pack_tpu_torch.train import step
    kind, active = case
    dev = _card() if kind == "cuda" else torch.device("cpu")
    # cuDNN may otherwise pick an SSIM convolution backward that adds with
    # atomics
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    tr, _ = _trainer(dev, sh_degree=3)
    model, cfg = tr.model, tr.cfg
    running = torch.ones((), device=dev)
    args = (tr.bank.gt[0], tr.bank.alpha_mask[0], tr.bank.invdepth[0],
            tr.bank.depth_mask[0], tr.bank.has_depth[0], tr.background,
            0.5, running, cfg, cfg.sh_degree)
    got = step.loss_and_grads(model, tr.bank, 0, 0.5, active, tr.background,
                              running, cfg)
    params = model.params()
    for t in params.values():
        t.grad = None
    p = dict(params)
    band = step.sh_band_mask(active, cfg.sh_degree, dev)
    p["features_rest"] = params["features_rest"] * band[1:][None]
    loss, _, _, res = step.view_losses(p, model.exposure[0],
                                       tr.bank.camera(0), *args)
    loss.backward()
    assert torch.equal(got.loss, loss.detach())
    assert torch.equal(got.viewspace_grad, res.viewspace_points.grad)
    for k, t in params.items():
        want = t.grad if t.grad is not None else torch.zeros_like(t)
        assert torch.equal(got.grads[k], want), k


@pytest.mark.cuda
def test_cuda_step_and_frame_launch_the_projection_once():
    """One `Trainer.step` launches one projection forward and one
    backward; one `renderer.render` one forward."""
    dev = _card()
    tr, cams = _trainer(dev)
    f0, b0 = pj.project_forward.launches, pj.project_backward.launches
    tr.step()
    torch.cuda.synchronize()
    assert (pj.project_forward.launches - f0,
            pj.project_backward.launches - b0) == (1, 1)
    renderer.render(tr.model, cams[0], np.zeros(3, np.float32))
    torch.cuda.synchronize()
    assert (pj.project_forward.launches - f0,
            pj.project_backward.launches - b0) == (2, 1)
