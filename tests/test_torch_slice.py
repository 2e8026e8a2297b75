"""Port parity for the render slice as a whole: a JAX `GaussianState`
carried across with `from_jax_params` renders like the JAX renderer; PLY IO,
scene readers and metrics agree with the JAX package; the port never
imports jax nor the JAX package."""

import filecmp
import os
import re
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu import renderer as jax_renderer
from sparse_view_3dgs_pack_tpu import testing as jax_testing
from sparse_view_3dgs_pack_tpu.data import readers as jax_readers
from sparse_view_3dgs_pack_tpu.metrics import image_metrics as jax_metrics
from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu_torch import renderer
from sparse_view_3dgs_pack_tpu_torch.data import readers
from sparse_view_3dgs_pack_tpu_torch.device import resolve_device
from sparse_view_3dgs_pack_tpu_torch.metrics import image_metrics
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from torch_port import REPO, subprocess_env

N_POINTS = 300
BG = [0.05, 0.1, 0.2]


def _jax_state(seed=0):
    """create_from_pcd at SH degree 3 (capacity > n: the bridge must drop
    the padding rows), with non-zero higher SH coefficients and a
    non-identity exposure."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1, 1, (N_POINTS, 3)).astype(np.float32)
    cols = rng.random((N_POINTS, 3)).astype(np.float32)
    state = jax_gm.create_from_pcd(pts, cols, n_images=2, sh_degree=3)
    rest = np.array(state.params["features_rest"])
    rest[:N_POINTS] = rng.normal(size=rest[:N_POINTS].shape) * 0.1
    exposure = np.array(state.exposure)
    exposure[:, :3, :3] += rng.normal(size=(2, 3, 3)) * 0.05
    exposure[:, :3, 3] = 0.02
    return state._replace(
        params={**state.params, "features_rest": jnp.asarray(rest)},
        exposure=jnp.asarray(exposure, jnp.float32))


def _port_model(state):
    return gm.from_jax_params({k: np.asarray(v)
                               for k, v in state.params.items()},
                              int(state.n_alive),
                              exposure=np.asarray(state.exposure),
                              device="cpu")


RENDER_CASES = {
    "plain": {},
    "antialiasing": {"antialiasing": True, "scaling_modifier": 0.8},
    "exposure": {"use_trained_exp": True, "exposure_idx": 1},
    "sh1": {"sh_degree_active": 1},
    "override_color": {"override_color": True},
}


@pytest.mark.parametrize("case", sorted(RENDER_CASES))
def test_render_matches_jax_render(case):
    """Port `render` (32×16 tiles, plain version) against JAX
    `render(use_pallas=False)` (XLA 16×16 tiles): atol 1e-5. At
    create_from_pcd's opacity 0.1 the alpha ≥ 1/255 ellipse of these
    Gaussians lies inside their binning rect with a pixel to spare, so both
    tile shapes cover the same contributing pixels (see
    `tests/test_torch_cli.py` for when they do not)."""
    kw = dict(RENDER_CASES[case])
    state = _jax_state()
    model = _port_model(state)
    jax_kw, port_kw = dict(kw), dict(kw)
    if kw.pop("override_color", False):
        rng = np.random.default_rng(1)
        colors = rng.random((state.capacity, 3)).astype(np.float32)
        jax_kw["override_color"] = jnp.asarray(colors)
        port_kw["override_color"] = torch.as_tensor(colors[:N_POINTS])
    cam = jax_testing.make_orbit_cameras(1, radius=3.0, width=64,
                                         height_px=48)[0]
    ref = jax_renderer.render(state, cam, jnp.asarray(BG, jnp.float32),
                              use_pallas=False, **jax_kw)
    out = renderer.render(model, cam, BG, **port_kw)
    assert out.n_pairs > 0
    for name in ("render", "alpha", "depth", "expected_depth"):
        np.testing.assert_allclose(getattr(out, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_array_equal(out.radii.numpy(),
                                  np.asarray(ref.radii)[:N_POINTS])
    assert float(out.alpha.max()) > 0.5


def test_save_ply_byte_identical(tmp_path):
    state = _jax_state()
    jax_gm.save_ply(state, str(tmp_path / "jax" / "point_cloud.ply"))
    gm.save_ply(_port_model(state), str(tmp_path / "port" /
                                        "point_cloud.ply"))
    assert filecmp.cmp(tmp_path / "jax" / "point_cloud.ply",
                       tmp_path / "port" / "point_cloud.ply", shallow=False)


def test_load_ply_reads_jax_ply(tmp_path):
    state = _jax_state()
    path = str(tmp_path / "point_cloud.ply")
    jax_gm.save_ply(state, path)
    model = gm.load_ply(path, sh_degree=3, n_images=3, device="cpu")
    for name, value in model.params().items():
        np.testing.assert_array_equal(
            value.detach().numpy(),
            np.asarray(state.params[name])[:N_POINTS], err_msg=name)
        assert value.is_contiguous(), name
    assert model.max_sh_degree == 3 and model.exposure.shape == (3, 3, 4)
    assert torch.equal(model.exposure[2], torch.eye(3, 4))


@pytest.mark.parametrize("layout", ["blender", "colmap"])
def test_readers_match_jax(tmp_path, layout):
    """Same SceneInfo from the port's readers as from the JAX ones (the
    Blender reader also writes its random init cloud: each side writes its
    own, from the same seed)."""
    src = tmp_path / "scene"
    if layout == "blender":
        jax_testing.write_blender_scene(str(src), width=32)
    else:
        jax_testing.write_colmap_scene(str(src), n_train=4, width=32,
                                       height=24)
    shutil.copytree(src, tmp_path / "scene_port")
    read = {"blender": ("read_nerf_synthetic_scene", dict(eval=True)),
            "colmap": ("read_colmap_scene", dict(eval=True, llffhold=2))}
    fn, kw = read[layout]
    ref = getattr(jax_readers, fn)(str(src), **kw)
    out = getattr(readers, fn)(str(tmp_path / "scene_port"), **kw)
    assert out.is_nerf_synthetic == ref.is_nerf_synthetic
    assert len(out.train_cameras) == len(ref.train_cameras) > 0
    assert len(out.test_cameras) == len(ref.test_cameras) > 0
    for a, b in zip(out.train_cameras + out.test_cameras,
                    ref.train_cameras + ref.test_cameras):
        for field in a._fields:
            va, vb = getattr(a, field), getattr(b, field)
            if field == "image_path":
                va = va.replace("scene_port", "scene")
            if isinstance(va, np.ndarray):
                np.testing.assert_array_equal(va, vb, err_msg=field)
            else:
                assert va == vb, field
    for field in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(out.point_cloud, field),
                                      getattr(ref.point_cloud, field))
    np.testing.assert_array_equal(out.nerf_normalization["translate"],
                                  ref.nerf_normalization["translate"])
    assert out.nerf_normalization["radius"] == \
        ref.nerf_normalization["radius"]


def test_metrics_match_jax():
    rng = np.random.default_rng(0)
    a = rng.random((40, 56, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(size=a.shape) * 0.05, 0, 1).astype(np.float32)
    for port_fn, jax_fn in ((image_metrics.psnr_metric,
                             jax_metrics.psnr_metric),
                            (image_metrics.ssim_metric,
                             jax_metrics.ssim_metric)):
        got = float(port_fn(torch.as_tensor(a), torch.as_tensor(b)))
        want = float(jax_fn(jnp.asarray(a), jnp.asarray(b)))
        assert abs(got - want) <= 1e-5 * max(1.0, abs(want)), port_fn
    assert float(image_metrics.psnr_metric(torch.as_tensor(a),
                                           torch.as_tensor(a))) == 120.0


def test_device_resolution_never_falls_back():
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            resolve_device("cuda")


_NO_JAX_SCRIPT = """
import importlib, pkgutil, sys
import numpy as np
import sparse_view_3dgs_pack_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from sparse_view_3dgs_pack_tpu_torch import renderer, testing
from sparse_view_3dgs_pack_tpu_torch.models.gaussians import GaussianModel
c = testing.make_sh3_cloud(0, 200, extent=1.0, scale_range=(0.02, 0.1))
f = c["features"]
m = GaussianModel(c["xyz"], f[:, :1], f[:, 1:], c["scales"], c["quats"],
                  c["opacity"])
cam = testing.make_orbit_cameras(1, radius=3.0, width=40, height_px=24)[0]
r = renderer.render(m, cam, [0, 0, 0])
assert r.render.shape == (24, 40, 3) and r.n_pairs > 0
# the train path: one lgdwt step through the differentiable rasterizer
import torch
from sparse_view_3dgs_pack_tpu_torch.train import optim, step
cam.image = np.zeros((24, 40, 3), np.float32)
bank = step.CameraBank.from_cameras([cam], device="cpu")
cfg = step.StepConfig(width=40, height=24, sh_degree=3, dwt_enable=True,
                      patch_dwt_enable=True, patch_size=8)
adam, eadam = optim.init_adam(m.params()), optim.init_exposure_adam(m.exposure)
metrics, _ = step.train_step(m, adam, eadam, torch.ones(()), bank, 0,
                             {k: 1e-3 for k in m.params()}, 0.0, 0.0, 0,
                             torch.zeros(3), cfg)
assert float(metrics["loss"]) > 0 and adam.step == 1
assert "jax" not in sys.modules, "the port imported jax"
ref = [k for k in sys.modules if k.split(".")[0] == "sparse_view_3dgs_pack_tpu"]
assert not ref, f"the port imported the JAX package: {ref}"
print("NO_JAX_OK")
"""

# an import of the JAX package (not of `..._torch`) in a port source
_JAX_PKG_IMPORT = re.compile(
    r"^\s*(from|import)\s+sparse_view_3dgs_pack_tpu(\.|\s|$)", re.M)


def test_port_never_imports_jax():
    """After every port module (CLIs included) is imported and the render
    and train paths have run, neither jax nor any module of the JAX package
    is loaded; no port source (nor `chip_smoke.py`) imports either."""
    proc = subprocess.run([sys.executable, "-c", _NO_JAX_SCRIPT], cwd=REPO,
                          env=subprocess_env(), capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "NO_JAX_OK" in proc.stdout
    src = os.path.join(REPO, "sparse_view_3dgs_pack_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(src):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    for path in paths:
        with open(path) as fh:
            text = fh.read()
        assert "import jax" not in text and "from jax" not in text, path
        assert not _JAX_PKG_IMPORT.search(text), path
