"""Shared helpers for the PyTorch port's parity tests (`test_torch_*.py`).

Inputs are made with numpy from a seed and handed to both packages; the JAX
side runs on the CPU (tests/conftest.py), Pallas kernels in interpret mode.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sparse_view_3dgs_pack_tpu.ops.projection import \
    project_gaussians as jax_project_gaussians
from sparse_view_3dgs_pack_tpu_torch.ops.projection import (
    Projected, project_gaussians)

# the suite runs several xdist workers on one machine
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def subprocess_env(**extra):
    """Environment for a CLI subprocess run from the repo root, with one
    intra-op thread like the workers themselves."""
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    env.update(extra)
    return env


def project_both(cloud, cam, sh_degree=0, antialiasing=False):
    """(JAX Projected, port Projected) of one numpy cloud and camera."""
    p = cam.params()
    kw = dict(tan_fovx=float(p.tan_fovx), tan_fovy=float(p.tan_fovy),
              width=cam.width, height=cam.height, sh_degree=sh_degree,
              antialiasing=antialiasing)
    jp = jax_project_gaussians(
        means3d=jnp.asarray(cloud["xyz"]),
        scales=jnp.exp(jnp.asarray(cloud["scales"])),
        quats=jnp.asarray(cloud["quats"]),
        opacities=jax.nn.sigmoid(jnp.asarray(cloud["opacity"][:, 0])),
        viewmat=jnp.asarray(p.viewmat), full_proj=jnp.asarray(p.full_proj),
        cam_center=jnp.asarray(p.cam_center),
        sh=jnp.asarray(cloud["features"]), **kw)
    t = torch.as_tensor
    tp = project_gaussians(
        means3d=t(cloud["xyz"]), scales=torch.exp(t(cloud["scales"])),
        quats=t(cloud["quats"]),
        opacities=torch.sigmoid(t(cloud["opacity"][:, 0])),
        viewmat=t(p.viewmat), full_proj=t(p.full_proj),
        cam_center=t(p.cam_center), sh=t(cloud["features"]), **kw)
    return jp, tp


def to_torch(jax_proj) -> Projected:
    """The JAX projection's arrays as the port's Projected, so both
    rasterizers see bit-identical inputs."""
    return Projected(*[torch.as_tensor(np.array(x)) for x in jax_proj])


def recv_exact(sock, n):
    """Exactly `n` bytes from a socket (a viewer client's reads)."""
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed early"
        buf += chunk
    return buf


@contextlib.contextmanager
def viewer_listener(network_gui):
    """`network_gui` listening on a free loopback port (port 0: the xdist
    workers never collide); yields the port and resets the module's
    listener and connection afterwards."""
    network_gui.init("127.0.0.1", 0)
    try:
        assert network_gui.listener is not None, "could not bind loopback"
        yield network_gui.listener.getsockname()[1]
    finally:
        close_viewer(network_gui)


def close_viewer(network_gui):
    """Close and forget `network_gui`'s listener and connection."""
    for sock in (network_gui.conn, network_gui.listener):
        if sock is not None:
            sock.close()
    network_gui.listener = network_gui.conn = None
