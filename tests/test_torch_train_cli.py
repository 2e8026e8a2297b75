"""The port's training CLI on the CPU: a tiny Blender scene whose images are
renders of a known cloud, ~30 iterations with densify events, the JAX
CLI's output tree, read back by the JAX `load_ply` and rendered by the
port's render CLI; DNGaussian on a forward-facing scene, its neural field
read back by the render CLI; mult-dwtgs (and its `train_nir` alias) on a
forward-facing scene with an NIR band, scored by the render and metrics
CLIs, and the NIR images the port loads where the JAX CLI loads none;
`--data_parallel` over two gloo ranks with `--profile` (FSGS trains:
`tests/test_torch_fsgs.py::test_fsgs_train_cli_fires_every_mechanism`)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu_torch import render as port_render
from sparse_view_3dgs_pack_tpu.models import neural_field as jax_nf
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.train import __main__ as train_cli
from torch_port import REPO, subprocess_env

ITERS = 30
INIT_POINTS = 150

_PORT_TRAIN = """
import runpy, sys
sys.argv = ["train"] + sys.argv[1:]
runpy.run_module("sparse_view_3dgs_pack_tpu_torch.train", run_name="__main__")
assert "jax" not in sys.modules, "the port imported jax"
"""


def _scene(root):
    cloud = testing.make_gaussian_cloud(7, 300, extent=0.9,
                                        scale_range=(0.05, 0.15))
    return testing.write_blender_scene(str(root / "scene"), n_train=6,
                                       n_test=2, width=48, cloud=cloud,
                                       init_points=INIT_POINTS)


@pytest.mark.timeout(600)
def test_train_cli_writes_the_jax_tree(tmp_path):
    scene = _scene(tmp_path)
    out = str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_TRAIN, "-s", scene, "-m", out,
         "--method", "lgdwt", "--device", "cpu", "--eval", "--quiet",
         "--disable_viewer", "--iterations", str(ITERS), "--patch_size", "16",
         "--densify_from_iter", "5", "--densification_interval", "10",
         "--densify_until_iter", "25", "--densify_grad_threshold", "0.0001",
         "--test_iterations", "30", "--save_iterations", "15"],
        cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
        timeout=500)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for name in ("cfg_args", "input.ply", "cameras.json", "exposure.json"):
        assert os.path.exists(os.path.join(out, name)), name
    assert sorted(os.listdir(os.path.join(out, "point_cloud"))) == [
        "iteration_15", f"iteration_{ITERS}"]
    with open(os.path.join(out, "cameras.json")) as f:
        assert len(json.load(f)) == 8
    with open(os.path.join(out, "exposure.json")) as f:
        assert len(json.load(f)) == 6

    ply = os.path.join(out, "point_cloud", f"iteration_{ITERS}",
                       "point_cloud.ply")
    state = jax_gm.load_ply(ply, sh_degree=3, n_images=6)
    n = int(state.n_alive)
    assert n != INIT_POINTS, "no densify event changed the point count"
    for k, v in state.params.items():
        assert np.isfinite(np.asarray(v)[:n]).all(), k

    port_render.main(["-m", out, "--device", "cpu", "--skip_train"])
    renders = os.path.join(out, "test", f"ours_{ITERS}", "renders")
    assert sorted(os.listdir(renders)) == ["00000.png", "00001.png"]


@pytest.mark.timeout(600)
def test_train_cli_refuses_what_is_not_ported(tmp_path, capfd):
    """No flag of the train CLI is left unported: `--data_parallel 2
    --device cpu` trains through two gloo ranks (rank 0 alone prints and
    writes: one PLY, one save line) and `--profile DIR` writes rank 0's
    Chrome trace, which names the step's ranges. What the CLI still
    refuses: CUDA on a machine without it."""
    scene = _scene(tmp_path)
    out, prof = tmp_path / "o", tmp_path / "prof"
    base = ["-s", scene, "-m", str(out), "--device", "cpu",
            "--iterations", "4"]
    train_cli.main(base + ["--disable_viewer", "--patch_size", "16",
                           "--test_iterations", "4", "--data_parallel", "2",
                           "--profile", str(prof)])
    stdout = capfd.readouterr().out
    assert "[dp] data-parallel over 2 devices (cpu)" in stdout
    assert stdout.count("Saving Gaussians") == 1
    assert os.listdir(out / "point_cloud") == ["iteration_4"]
    state = jax_gm.load_ply(str(out / "point_cloud" / "iteration_4" /
                                "point_cloud.ply"), sh_degree=3, n_images=6)
    assert int(state.n_alive) == INIT_POINTS
    for k, v in state.params.items():
        assert np.isfinite(np.asarray(v)[:INIT_POINTS]).all(), k
    with open(prof / "train.pt.trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    for stage in ("render/rasterize", "step/losses", "step/backward",
                  "dp/allreduce", "step/adam", "step/stats"):
        assert stage in names, stage
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            train_cli.main(base[:4] + ["--iterations", "1"])


@pytest.mark.timeout(600)
def test_dng_train_cli_writes_the_neural_field(tmp_path):
    """`--method dngaussian` (the full-width field, the soft pass from
    iteration 2) trains 3 iterations on a 48-px forward-facing scene with
    disparity priors, writes `neural_renderer.npz` beside the PLY in the
    JAX layout (the JAX loader reads it), and the render CLI renders the
    test views through it."""
    scene = testing.write_llff_colmap_scene(str(tmp_path / "scene"),
                                            size=48, n_gauss=400,
                                            n_dense=300, n_sparse=60)
    out = str(tmp_path / "out")
    proc = subprocess.run(
        [sys.executable, "-c", _PORT_TRAIN, "-s", scene, "-m", out,
         "--method", "dngaussian", "--device", "cpu", "--eval",
         "--n_views", "3", "--depth_estimator", "precomputed",
         "--iterations", "3", "--soft_depth_start", "1", "--near_range",
         "0.05", "--test_iterations", "3", "--disable_viewer"],
        cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
        timeout=500)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "DNG counts: soft_passes=2" in proc.stdout
    it_dir = os.path.join(out, "point_cloud", "iteration_3")
    assert sorted(os.listdir(it_dir)) == ["neural_renderer.npz",
                                          "point_cloud.ply"]
    params, cfg = jax_nf.load_neural_npz(os.path.join(it_dir,
                                                      "neural_renderer.npz"))
    assert (cfg.grid.num_levels, cfg.grid.log2_hashmap_size,
            cfg.hidden_dim, cfg.sh_degree) == (16, 19, 64, 4)
    assert np.isfinite(np.asarray(params["encoder"])).all()

    proc = subprocess.run(
        [sys.executable, "-m", "sparse_view_3dgs_pack_tpu_torch.render",
         "-m", out, "--device", "cpu", "--skip_train"], cwd=REPO,
        env=subprocess_env(), capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "Rendering with neural field" in proc.stdout
    renders = os.path.join(out, "test", "ours_3", "renders")
    assert sorted(os.listdir(renders)) == ["00000.png", "00001.png",
                                           "00002.png"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("entry", ["train", "train_nir"])
def test_nir_train_cli_trains_and_is_scored(tmp_path, entry):
    """`python -m ...train --method mult-dwtgs` and `python -m
    ...train_nir` train 30 iterations (densify and an opacity reset
    inside) on a 48-px forward-facing scene with its `nir/` band: every
    training view's NIR image is loaded, the PLY carries a trained
    `nir_albedo` (read back by the JAX `load_ply`) and another point
    count, and the port's render and metrics CLIs score the model."""
    scene = testing.write_llff_colmap_scene(str(tmp_path / "scene"),
                                            size=48, n_gauss=400,
                                            n_dense=300, n_sparse=60,
                                            nir=True)
    out = str(tmp_path / "out")
    method = ["--method", "mult-dwtgs"] if entry == "train" else []
    proc = subprocess.run(
        [sys.executable, "-m", f"sparse_view_3dgs_pack_tpu_torch.{entry}",
         "-s", scene, "-m", out, *method, "--device", "cpu", "--eval",
         "--n_views", "3", "--iterations", str(ITERS), "--patch_size", "16",
         "--densify_from_iter", "5", "--densification_interval", "10",
         "--densify_until_iter", "25", "--opacity_reset_interval", "20",
         "--densify_grad_threshold", "0.0001", "--disable_viewer"],
        cwd=REPO, env=subprocess_env(), capture_output=True, text=True,
        timeout=500)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "NIR images: 3 of 3 training views" in proc.stdout
    assert "mult-dwtgs training took" in proc.stdout
    ply = os.path.join(out, "point_cloud", f"iteration_{ITERS}",
                       "point_cloud.ply")
    state = jax_gm.load_ply(ply, sh_degree=3, n_images=3)
    n = int(state.n_alive)
    assert n != 300, "no densify event changed the point count"
    albedo = np.asarray(state.params["nir_albedo"])[:n]
    assert np.isfinite(albedo).all() and np.abs(albedo).max() > 0

    for mod in ("render", "metrics"):
        extra = ["--skip_train"] if mod == "render" else []
        proc = subprocess.run(
            [sys.executable, "-m", f"sparse_view_3dgs_pack_tpu_torch.{mod}",
             "-m", out, "--device", "cpu", *extra], cwd=REPO,
            env=subprocess_env(), capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(os.path.join(out, "results.json")) as f:
        res = json.load(f)[f"ours_{ITERS}"]
    assert np.isfinite(res["PSNR"]) and res["PSNR"] > 5.0


def test_port_cameras_carry_nir_where_the_jax_cli_loads_none(tmp_path):
    """The JAX CLI's fault, documented and not changed: its camera loader
    reads `use_nir` from the ModelParams group, which has no such flag
    (it is an OptimizationParams option), so its Scene(use_nir=True)
    cameras carry no NIR image and the bank's target is the zero dummy.
    The port's Scene(use_nir=True) loads `<scene>/nir/<image name>`."""
    from argparse import ArgumentParser
    from sparse_view_3dgs_pack_tpu import config as jax_config
    from sparse_view_3dgs_pack_tpu.scene import Scene as JaxScene
    from sparse_view_3dgs_pack_tpu.train.step import \
        CameraBank as JaxCameraBank
    from sparse_view_3dgs_pack_tpu_torch import config
    from sparse_view_3dgs_pack_tpu_torch.scene import Scene
    from sparse_view_3dgs_pack_tpu_torch.train.step import CameraBank
    from sparse_view_3dgs_pack_tpu_torch.utils import image_io

    scene = testing.write_llff_colmap_scene(str(tmp_path / "scene"),
                                            size=32, n_gauss=200,
                                            n_dense=150, n_sparse=40,
                                            nir=True)
    argv = ["-s", scene, "--eval", "--n_views", "3"]
    groups = {}
    for name, pkg in (("jax", jax_config), ("port", config)):
        parser = ArgumentParser()
        lp = pkg.ModelParams(parser)
        op = pkg.OptimizationParams(parser, method="mult-dwtgs")
        out = tmp_path / name
        os.makedirs(out)
        args = parser.parse_args(argv + ["-m", str(out)])
        groups[name] = lp.extract(args)
        assert not hasattr(groups[name], "use_nir")
        assert op.extract(args).use_nir is True

    jcams = JaxScene(groups["jax"], sh_degree=3, use_nir=True,
                     shuffle=False).getTrainCameras()
    assert len(jcams) == 3 and all(c.nir is None for c in jcams)
    assert JaxCameraBank.from_cameras(jcams).nir.shape == (3, 1, 1)

    cams = Scene(groups["port"], sh_degree=3, use_nir=True, shuffle=False,
                 device="cpu").getTrainCameras()
    assert [c.image_name for c in cams] == [c.image_name for c in jcams]
    for c in cams:
        want = image_io.read_image(os.path.join(
            scene, "nir", c.image_name)).astype(np.float32) / 255.0
        np.testing.assert_array_equal(c.nir, want)
    bank = CameraBank.from_cameras(cams, 3, "cpu")
    assert bank.nir.shape == (3, 32, 32) and float(bank.nir.max()) > 0
