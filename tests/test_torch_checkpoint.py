"""Training checkpoints of the port (`train/checkpoint.py`) in the JAX
package's `.npz` layout: a port file loads with the JAX `load_checkpoint`
and gives the same arrays, a JAX file loads into the port as
`from_jax_state` bridges it, and the train CLI resumes from its own
checkpoint."""

import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu.models import gaussians as jax_gm
from sparse_view_3dgs_pack_tpu.train import checkpoint as jax_ckpt
from sparse_view_3dgs_pack_tpu.train import optim as jax_optim
from sparse_view_3dgs_pack_tpu.train.step import StepCarry
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.models import gaussians as gm
from sparse_view_3dgs_pack_tpu_torch.train import checkpoint, optim
from torch_port import REPO, subprocess_env

PARAMS = gm.PARAM_NAMES


def _np(t):
    return t.detach().cpu().numpy()


def _random_like(rng, t):
    return torch.tensor(rng.normal(size=tuple(t.shape)).astype(np.float32))


def _port_state(n=40, seed=0):
    rng = np.random.default_rng(seed)
    model = gm.create_from_pcd(rng.uniform(-1, 1, (n, 3)), rng.random((n, 3)),
                               n_images=2, sh_degree=1, device="cpu")
    for k in gm.STAT_NAMES:
        setattr(model, k, torch.tensor(rng.random(n).astype(np.float32)))
    adam = optim.init_adam(model.params())
    adam.m = {k: _random_like(rng, v) for k, v in adam.m.items()}
    adam.v = {k: _random_like(rng, v).abs() for k, v in adam.v.items()}
    adam.step = 7
    exp = optim.init_exposure_adam(model.exposure)
    exp.m, exp.v, exp.step = (_random_like(rng, exp.m),
                              _random_like(rng, exp.v).abs(), 5)
    return model, adam, exp, torch.tensor(1.37)


def test_port_checkpoint_loads_in_jax(tmp_path):
    model, adam, exp, running = _port_state()
    path = str(tmp_path / "chkpnt123.npz")
    checkpoint.save_checkpoint(path, model, adam, exp, running, 123)
    state, jadam, jexp, carry, it = jax_ckpt.load_checkpoint(path)
    n = model.num_points
    assert it == 123 and int(state.n_alive) == n
    assert np.asarray(state.alive).all() and state.alive.shape == (n,)
    for k in PARAMS:
        np.testing.assert_array_equal(np.asarray(state.params[k]),
                                      _np(getattr(model, k)), err_msg=k)
        np.testing.assert_array_equal(np.asarray(jadam.m[k]), _np(adam.m[k]))
        np.testing.assert_array_equal(np.asarray(jadam.v[k]), _np(adam.v[k]))
    for k in gm.STAT_NAMES:
        np.testing.assert_array_equal(np.asarray(getattr(state, k)),
                                      _np(getattr(model, k)), err_msg=k)
    np.testing.assert_array_equal(np.asarray(state.exposure),
                                  _np(model.exposure))
    assert int(jadam.step) == 7 and int(jexp.step) == 5
    np.testing.assert_array_equal(np.asarray(jexp.m), _np(exp.m))
    np.testing.assert_array_equal(np.asarray(jexp.v), _np(exp.v))
    assert float(carry.dwt_running_mean) == float(running)

    # and back into the port, bit for bit
    c = checkpoint.load_checkpoint(path, device="cpu")
    assert c.iteration == 123 and c.adam.step == 7 and c.exp_adam.step == 5
    assert torch.equal(c.dwt_running_mean, running)
    for k in PARAMS:
        assert torch.equal(getattr(c.model, k), getattr(model, k)), k
        assert torch.equal(c.adam.m[k], adam.m[k])
        assert torch.equal(c.adam.v[k], adam.v[k])


def test_jax_checkpoint_loads_in_port(tmp_path):
    """A JAX file with padding rows past `n_alive` loads with its alive
    rows, as `from_jax_state` bridges the same state."""
    rng = np.random.default_rng(1)
    n, cap = 40, 64
    state = jax_gm.create_from_pcd(rng.uniform(-1, 1, (n, 3)),
                                   rng.random((n, 3)), n_images=2,
                                   capacity=cap, sh_degree=1)
    state = state._replace(**{k: jnp.asarray(rng.random(cap), jnp.float32)
                              for k in gm.STAT_NAMES})
    rand = lambda d: {k: jnp.asarray(rng.normal(size=v.shape), jnp.float32)
                      for k, v in d.items()}
    adam = jax_optim.AdamState(m=rand(state.params), v=rand(state.params),
                               step=jnp.asarray(9, jnp.int32))
    e = jax_optim.init_exposure_adam(state.exposure)
    exp = e._replace(m=e.m + 0.25, step=jnp.asarray(4, jnp.int32))
    carry = StepCarry(dwt_running_mean=jnp.asarray(0.8, jnp.float32))
    path = str(tmp_path / "chkpnt77.npz")
    jax_ckpt.save_checkpoint(path, state, adam, exp, carry, 77)

    c = checkpoint.load_checkpoint(path, device="cpu")
    ref = gm.from_jax_state(state, adam, exp, device="cpu")
    assert c.iteration == 77 and c.model.num_points == n
    assert c.adam.step == ref.adam.step == 9
    assert c.exp_adam.step == ref.exp_adam.step == 4
    assert float(c.dwt_running_mean) == np.float32(0.8)
    for k in PARAMS:
        assert torch.equal(getattr(c.model, k), getattr(ref.model, k)), k
        assert torch.equal(c.adam.m[k], ref.adam.m[k]), k
        assert torch.equal(c.adam.v[k], ref.adam.v[k]), k
    for k in gm.STAT_NAMES + ("exposure",):
        assert torch.equal(getattr(c.model, k), getattr(ref.model, k)), k
    assert torch.equal(c.exp_adam.m, ref.exp_adam.m)
    assert torch.equal(c.exp_adam.v, ref.exp_adam.v)


@pytest.mark.timeout(600)
def test_train_cli_resumes_from_checkpoint(tmp_path):
    """Train 20 iterations with densify events, a checkpoint at 20 and the
    debug snapshot armed from 0; then resume from the checkpoint to 40."""
    cloud = testing.make_gaussian_cloud(7, 300, extent=0.9,
                                        scale_range=(0.05, 0.15))
    scene = testing.write_blender_scene(str(tmp_path / "scene"), n_train=3,
                                        n_test=1, width=32, cloud=cloud,
                                        init_points=150)
    out = str(tmp_path / "out")
    base = [sys.executable, "-m", "sparse_view_3dgs_pack_tpu_torch.train",
            "-s", scene, "-m", out, "--method", "lgdwt", "--device", "cpu",
            "--disable_viewer", "--patch_size", "8", "--densify_from_iter", "5",
            "--densification_interval", "10", "--densify_until_iter", "35",
            "--densify_grad_threshold", "0.0001", "--test_iterations", "40"]

    def run(*extra):
        proc = subprocess.run(base + list(extra), cwd=REPO,
                              env=subprocess_env(), capture_output=True,
                              text=True, timeout=500)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        return proc.stdout

    run("--iterations", "20", "--checkpoint_iterations", "10", "20",
        "--debug_from", "0")
    ck = os.path.join(out, "chkpnt20.npz")
    assert os.path.exists(os.path.join(out, "chkpnt10.npz"))
    assert not os.path.exists(os.path.join(out, "snapshot_fw.npz"))
    saved = checkpoint.load_checkpoint(ck, device="cpu")
    assert saved.iteration == 20 and saved.adam.step == 20
    assert saved.model.num_points != 150     # a densify event ran

    log = run("--iterations", "40", "--start_checkpoint", ck)
    assert f"Resumed from {ck} (iteration 20)" in log
    ply = os.path.join(out, "point_cloud", "iteration_40", "point_cloud.ply")
    model = gm.load_ply(ply, sh_degree=3, device="cpu")
    assert all(bool(torch.isfinite(v).all()) for v in model.params().values())
