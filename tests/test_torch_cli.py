"""The port's render and metrics CLIs against the root JAX CLIs on one tiny
Blender scene and model directory, each in its own subprocess."""

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
    with pytest.raises(NotImplementedError, match="video"):
        port_render.main(["-m", model, "--device", "cpu", "--video"])
    assert not os.path.exists(os.path.join(model, "test"))
