"""The port's debug snapshot (`train/debug.py`): the cases of
`tests/test_debug.py` on the port — arming, the snapshot round trip, the
dump on a non-finite loss, and a `Trainer` step with an injected NaN — and
snapshots read across the two packages with the same keys."""

import os
from argparse import ArgumentParser

import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu.train import debug as jax_debug
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.config import (ModelParams,
                                                    OptimizationParams,
                                                    PipelineParams)
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.train import debug


def _points(n=32):
    rng = np.random.default_rng(0)
    return rng.random((n, 3)), rng.random((n, 3))


def _model(n=32):
    pts, cols = _points(n)
    return gm.create_from_pcd(pts, cols, n_images=2, sh_degree=1,
                              device="cpu")


class _NS:
    def __init__(self, **kw):
        self.__dict__.update(kw)


def test_debug_active_arming():
    assert not debug.debug_active(_NS(), 100)
    assert debug.debug_active(_NS(debug=True), 0)
    assert not debug.debug_active(_NS(debug_from=50), 49)
    assert debug.debug_active(_NS(debug_from=50), 50)
    assert not debug.debug_active(_NS(debug_from=-1), 10)


def test_snapshot_roundtrip(tmp_path):
    model = _model()
    path = str(tmp_path / "snap.npz")
    debug.dump_snapshot(path, model, {"iteration": 7, "cam_idx": 3})
    params, arrays, meta = debug.load_snapshot(path)
    assert meta["iteration"] == 7 and meta["cam_idx"] == 3
    for k, v in model.params().items():
        np.testing.assert_array_equal(params[k], v.detach().numpy())
    assert arrays["alive"].all() and arrays["alive"].shape == (32,)
    assert int(arrays["n_alive"]) == 32


def test_check_step_dumps_on_nonfinite(tmp_path):
    model = _model()
    nan = {"loss": torch.tensor(float("nan"))}
    # off: a NaN loss passes through, nothing is read from the device
    debug.check_step(_NS(), 5, nan, model, str(tmp_path))
    # armed and finite: nothing happens
    debug.check_step(_NS(debug=True), 5, {"loss": torch.tensor(0.5)}, model,
                     str(tmp_path))
    assert not os.path.exists(tmp_path / "snapshot_fw.npz")
    # armed and NaN: the snapshot is written and the run stops
    with pytest.raises(RuntimeError, match="snapshot_fw.npz"):
        debug.check_step(_NS(debug_from=2), 5, nan, model, str(tmp_path),
                         {"cam_idx": 1})
    params, _, meta = debug.load_snapshot(str(tmp_path / "snapshot_fw.npz"))
    assert meta["iteration"] == 5 and meta["cam_idx"] == 1
    assert set(params) == set(model.params())


def test_trainer_step_snapshots_nan(tmp_path):
    """Through `Trainer.step`: NaN colour coefficients reach the blend and
    the loss, so the step raises and leaves a replayable snapshot."""
    from sparse_view_3dgs_pack_tpu_torch.scene import Scene
    from sparse_view_3dgs_pack_tpu_torch.train.loop import Trainer

    cloud = testing.make_gaussian_cloud(7, 100, extent=0.9,
                                        scale_range=(0.05, 0.15))
    scene_dir = testing.write_blender_scene(str(tmp_path / "scene"),
                                            n_train=2, n_test=1, width=32,
                                            cloud=cloud, init_points=60)
    model_dir = str(tmp_path / "model")
    os.makedirs(model_dir)
    parser = ArgumentParser()
    lp, op = ModelParams(parser), OptimizationParams(parser, method="3dgs")
    pp = PipelineParams(parser)
    args = parser.parse_args(["-s", scene_dir, "-m", model_dir, "--debug"])
    dataset, pipe = lp.extract(args), pp.extract(args)
    scene = Scene(dataset, sh_degree=dataset.sh_degree, device="cpu")
    trainer = Trainer(scene, op.extract(args), pipe, dataset)
    with torch.no_grad():
        trainer.model.features_dc.fill_(float("nan"))
    with pytest.raises(RuntimeError, match="non-finite loss"):
        trainer.step()
    params, _, meta = debug.load_snapshot(
        os.path.join(model_dir, "snapshot_fw.npz"))
    assert meta["iteration"] == 1 and meta["active_sh_degree"] == 0
    assert np.isnan(params["features_dc"]).all()


def test_snapshots_cross_packages(tmp_path):
    """The JAX `load_snapshot` reads a port snapshot, and the port's reads
    a JAX one, with the same keys and arrays for the same rows."""
    pts, cols = _points()
    model = _model()
    state = jax_gm.create_from_pcd(pts, cols, n_images=2, capacity=32,
                                   sh_degree=1)
    port_path = debug.dump_snapshot(str(tmp_path / "port.npz"), model,
                                    {"iteration": 3})
    jax_path = jax_debug.dump_snapshot(str(tmp_path / "jax.npz"), state,
                                       {"iteration": 3})
    for load in (debug.load_snapshot, jax_debug.load_snapshot):
        p_params, p_arrays, p_meta = load(port_path)
        j_params, j_arrays, j_meta = load(jax_path)
        assert set(p_params) == set(j_params)
        assert set(p_arrays) == set(j_arrays)
        assert p_meta == j_meta
        for k in p_params:
            np.testing.assert_allclose(p_params[k], j_params[k], rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        for k in p_arrays:
            np.testing.assert_array_equal(p_arrays[k], j_arrays[k],
                                          err_msg=k)
