"""The port's render and metrics CLIs against the root JAX CLIs on one tiny
Blender scene and model directory, each in its own subprocess; the render
CLI's spiral videos; `metrics_dtu` and `metrics_count` against the root
scripts."""

import importlib.util
import json
import os
import subprocess
import sys
from argparse import Namespace

import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu import config
from sparse_view_3dgs_pack_tpu import testing as jax_testing
from sparse_view_3dgs_pack_tpu_torch import render as port_render
from sparse_view_3dgs_pack_tpu_torch.metrics import __main__ as port_metrics
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.utils import image_io
from torch_port import REPO, subprocess_env

ITER = 7

_PORT_CLI = """
import runpy, sys
mod = sys.argv[1]
sys.argv = [mod] + sys.argv[2:]
try:
    runpy.run_module(mod, run_name="__main__")
except SystemExit as exc:
    if exc.code:
        raise
assert "jax" not in sys.modules, "the port imported jax"
"""


def _model_dir(root, name):
    """Scene + model dir whose cfg_args point at each other.

    The port renders on 32×16 tiles, the JAX CPU path on 16×16, and the
    reference's tile rect (`getRect`) truncates: where a rect is the 3σ
    square, a pixel within its last pixel of radius can fall in a 32-wide
    tile and outside every 16-wide one. Large (σ ≳ 3 px) faint
    (opacity < 0.05) Gaussians have their alpha ≥ 1/255 ellipse at least a
    pixel inside the 3σ square, so both tile shapes cover the same
    contributing pixels."""
    scene = str(root / "scene")
    if not os.path.exists(scene):
        jax_testing.write_blender_scene(scene, n_train=2, n_test=2, width=40)
    model = str(root / name)
    cloud = testing.make_sh3_cloud(0, 300, extent=1.0,
                                   scale_range=(0.3, 0.5))
    cloud["opacity"][:] = np.random.default_rng(3).uniform(
        -4.0, -3.0, (300, 1)).astype(np.float32)
    f = cloud["features"]
    gm.save_ply(gm.GaussianModel(cloud["xyz"], f[:, :1], f[:, 1:],
                                 cloud["scales"], cloud["quats"],
                                 cloud["opacity"]),
                os.path.join(model, "point_cloud", f"iteration_{ITER}",
                             "point_cloud.ply"))
    config.write_cfg_args(model, Namespace(
        sh_degree=3, source_path=scene, model_path=model, images="images",
        depths="", resolution=-1, white_background=False,
        train_test_exp=False, data_device="cpu", eval=True, n_views=0,
        point_cloud_type="dense"))
    return model


def _run(cmd, env):
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    return proc


@pytest.mark.timeout(900)
def test_port_clis_match_jax_clis(tmp_path):
    port_dir = _model_dir(tmp_path, "port")
    jax_dir = _model_dir(tmp_path, "jax")
    env = subprocess_env()
    for mod in ("render", "metrics"):
        _run([sys.executable, "-c", _PORT_CLI,
              f"sparse_view_3dgs_pack_tpu_torch.{mod}", "-m", port_dir,
              "--device", "cpu"], env)
        _run([sys.executable, f"{mod}.py", "-m", jax_dir],
             subprocess_env(GS_FORCE_CPU="1", JAX_PLATFORMS="cpu"))

    n_png = 0
    for split in ("train", "test"):
        for kind in ("renders", "gt"):
            sub = os.path.join(split, f"ours_{ITER}", kind)
            names = sorted(os.listdir(os.path.join(jax_dir, sub)))
            assert names == sorted(os.listdir(os.path.join(port_dir, sub)))
            for name in names:
                a = image_io.read_image(os.path.join(port_dir, sub, name))
                b = image_io.read_image(os.path.join(jax_dir, sub, name))
                assert a.shape == b.shape
                # truncation to u8 of values that agree to ~1e-6
                assert np.abs(a.astype(int) - b.astype(int)).max() <= 1
                n_png += 1
    assert n_png == 8

    port_res = json.load(open(os.path.join(port_dir, "results.json")))
    jax_res = json.load(open(os.path.join(jax_dir, "results.json")))
    for key in ("PSNR", "SSIM"):
        assert abs(port_res[f"ours_{ITER}"][key]
                   - jax_res[f"ours_{ITER}"][key]) <= 1e-4, key
    # the same keys as the JAX CLI's, LPIPS (or LPIPS_proxy) included
    assert set(port_res[f"ours_{ITER}"]) == set(jax_res[f"ours_{ITER}"])
    assert port_res[f"ours_{ITER}"]["LPIPS_backend"] == \
        jax_res[f"ours_{ITER}"]["LPIPS_backend"]
    per_view = json.load(open(os.path.join(port_dir, "per_view.json")))
    jax_view = json.load(open(os.path.join(jax_dir, "per_view.json")))
    assert set(per_view[f"ours_{ITER}"]) == set(jax_view[f"ours_{ITER}"])
    assert sorted(per_view[f"ours_{ITER}"]["PSNR"]) == ["00000.png",
                                                        "00001.png"]


def test_clis_device_cuda_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    model = _model_dir(tmp_path, "m")
    with pytest.raises(RuntimeError, match="cuda"):
        port_render.main(["-m", model])          # --device defaults to cuda
    with pytest.raises(RuntimeError, match="cuda"):
        port_metrics.main(["-m", model])
    assert not os.path.exists(os.path.join(model, "test"))


def _root_module(name):
    """A root script of the repo as a module, without running its main."""
    spec = importlib.util.spec_from_file_location(
        f"root_{name}", os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.timeout(600)
def test_render_cli_video_writes_120_frame_mp4s(tmp_path):
    """`--video --depth_video` writes `video/ours_<it>.mp4` and
    `video/depth_ours_<it>.mp4`: 120 frames of the scene's size each, as
    cv2 reads them back."""
    cv2 = pytest.importorskip("cv2")
    model = _model_dir(tmp_path, "m")
    _run([sys.executable, "-c", _PORT_CLI,
          "sparse_view_3dgs_pack_tpu_torch.render", "-m", model, "--device",
          "cpu", "--skip_train", "--skip_test", "--video", "--depth_video"],
         subprocess_env())
    for name in (f"ours_{ITER}.mp4", f"depth_ours_{ITER}.mp4"):
        cap = cv2.VideoCapture(os.path.join(model, "video", name))
        assert cap.isOpened(), name
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame)
        cap.release()
        assert len(frames) == port_render.VIDEO_FRAMES == 120, name
        assert frames[0].shape == (40, 40, 3), name
        assert max(int(f.max()) for f in frames) > 0, name
    assert not os.path.exists(os.path.join(model, "test"))


def test_depth_colormap_equals_root_cli():
    """The depth-video colormap, bit for bit the root `render.py`'s, on a
    depth map with empty (alpha 0) pixels and on an empty frame."""
    root = _root_module("render")
    rng = np.random.default_rng(0)
    depth = rng.uniform(0.5, 5.0, (24, 32)).astype(np.float32)
    alpha = rng.random((24, 32)).astype(np.float32)
    alpha[:5] = 0.0
    for a in (alpha, np.zeros_like(alpha)):
        np.testing.assert_array_equal(port_render._depth_colormap(depth, a),
                                      root._depth_colormap(depth, a))


@pytest.mark.timeout(600)
def test_metrics_dtu_and_count_match_root_scripts(tmp_path):
    """`python -m ...metrics_dtu` against the root `metrics_dtu.py` on the
    same renders with an object mask (half the image, at another size so
    it is resized): PSNR and SSIM within 1e-4, the same keys (LPIPS values
    differ with the proxy, whose weights differ); `metrics_count` writes
    the root script's `gaussian_counts.json`."""
    model = _model_dir(tmp_path, "m")
    port_render.main(["-m", model, "--device", "cpu", "--skip_train"])
    scene = str(tmp_path / "scene")
    mask = np.zeros((80, 80), np.uint8)
    mask[:, :40] = 255
    os.makedirs(os.path.join(scene, "idr_masks"))
    image_io.write_png(os.path.join(scene, "idr_masks", "00000.png"), mask)
    from sparse_view_3dgs_pack_tpu_torch import metrics_count, metrics_dtu
    metrics_dtu.main(["-m", model, "-s", scene, "--device", "cpu"])
    with open(os.path.join(model, "results_dtu.json")) as f:
        port = json.load(f)[f"ours_{ITER}"]
    _root_module("metrics_dtu").evaluate_dtu([model], scene)
    with open(os.path.join(model, "results_dtu.json")) as f:
        root = json.load(f)[f"ours_{ITER}"]
    assert set(port) == set(root)
    for key in ("PSNR", "SSIM"):
        assert abs(port[key] - root[key]) <= 1e-4, key

    metrics_count.main(["-m", model])
    with open(os.path.join(model, "gaussian_counts.json")) as f:
        port = json.load(f)
    _root_module("metrics_count").main(["-m", model])
    with open(os.path.join(model, "gaussian_counts.json")) as f:
        assert json.load(f) == port == {f"iteration_{ITER}": 300}
