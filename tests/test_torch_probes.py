"""Port parity for the probe kernels (`ops/probes.py`) and their entry
points (`probes/prims.py`, `probes/fwd_bisect.py`): each probe's plain
PyTorch version against the Pallas kernel of `scripts/tpu_prims.py` or
`scripts/tpu_dbg.py` in interpret mode, on the scripts' own inputs, and —
on a card only — each CUDA kernel against its plain version.

The scripts run everything at import, on a TPU, so they are not imported:
their kernel `def`s (and `PIX, CHUNK, TILE = ...`) are parsed with `ast`
and executed, and each `pl.pallas_call` statement of the script runs as it
is written, with its own specs, under `pltpu.force_tpu_interpret_mode()`.
`tpu_dbg.py` predates the chunk-major pair layout: its kernels slice a
(16, NBUF) array, so they are fed `pack_pair_data(...)` transposed to that
layout, and only the lanes below each tile's real (unpadded) pair count are
compared (the aligned binning pads each tile with inert sentinels).
"""

import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from sparse_view_3dgs_pack_tpu.ops.binning import bin_gaussians_aligned
from sparse_view_3dgs_pack_tpu.ops.pallas import raster as jax_raster
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.ops import probes
from sparse_view_3dgs_pack_tpu_torch.ops.binning import bin_gaussians
from sparse_view_3dgs_pack_tpu_torch.probes import fwd_bisect, prims
from torch_port import REPO, project_both, to_torch

W, H, N = 64, 48, 300          # the scene of scripts/tpu_dbg.py
GRID_X = (W + 15) // 16
NT = GRID_X * ((H + 15) // 16)
MAX_PAIRS = 1 << 13


class _Script:
    """The kernels and `pallas_call` statements of one TPU probe script."""

    def __init__(self, name):
        self.path = os.path.join(REPO, "scripts", name)
        with open(self.path) as f:
            tree = ast.parse(f.read(), self.path)
        keep = [n for n in tree.body if isinstance(n, ast.FunctionDef)
                or (isinstance(n, ast.Assign)
                    and ast.unparse(n.targets[0]) == "(PIX, CHUNK, TILE)")]
        self.ns = dict(jax=jax, jnp=jnp, pl=pl, pltpu=pltpu, np=np)
        exec(compile(ast.Module(keep, []), self.path, "exec"), self.ns)
        self.stmts = sorted(
            (n for n in ast.walk(tree) if isinstance(n, ast.Assign)
             and any(k in ast.unparse(n.value) for k in
                     ("pallas_call", "PrefetchScalarGridSpec"))),
            key=lambda n: n.lineno)

    def run(self, kernel: str, **env) -> np.ndarray:
        """Run the script's `out = pl.pallas_call(<kernel>...)(...)` (and
        the grid spec `gs` just before it, if it takes one) with `env`."""
        call = f"pl.pallas_call({kernel}"
        i = next(i for i, n in enumerate(self.stmts)
                 if ast.unparse(n.targets[0]) == "out"
                 and ast.unparse(n.value).startswith(call))
        body = [self.stmts[i]]
        if "grid_spec=gs" in ast.unparse(self.stmts[i].value):
            body.insert(0, self.stmts[i - 1])
            assert ast.unparse(body[0].targets[0]) == "gs"
        self.ns.update(env)
        with pltpu.force_tpu_interpret_mode():
            exec(compile(ast.Module(body, []), self.path, "exec"), self.ns)
        return np.asarray(self.ns["out"])


@pytest.fixture(scope="module")
def prims_script():
    return _Script("tpu_prims.py")


@pytest.mark.parametrize("probe", ["iota", "cumsum", "copy", "alpha"])
def test_prim_probe_matches_pallas(prims_script, probe):
    """P1-P4 on the inputs of `tpu_prims.py`: P1 and P3 exact, P2 within
    the script's 1e-4 (a triangular matmul there, a scan here), P4 1e-6."""
    if probe == "iota":
        want = prims_script.run("k_iota")
        got = probes.tile_coords(8, 4, device="cpu")
        np.testing.assert_array_equal(got.numpy(), want)
    elif probe == "cumsum":
        x = jax.random.uniform(jax.random.PRNGKey(0), (256, 256),
                               minval=-0.1, maxval=0.0)
        want = prims_script.run("k_cumsum", x=x)
        got = probes.row_cumsum(torch.tensor(np.asarray(x)))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)
    elif probe == "copy":
        data, starts = prims.copy_input()
        want = prims_script.run("k_dma", data_j=jnp.asarray(data),
                                starts=jnp.asarray(starts))
        got = probes.offset_copy(torch.as_tensor(data),
                                 torch.as_tensor(starts))
        np.testing.assert_array_equal(got.numpy(), want)
    else:
        d = prims.alpha_input()
        want = prims_script.run("k_alpha", d=d)
        got = probes.pair_alpha(torch.as_tensor(d))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)


@pytest.fixture(scope="module", params=[N, 1500])
def dbg_scene(request):
    """`tpu_dbg.py`'s scene (and a denser one, whose pixels reach the ln 1e-4
    stop and whose tiles hold more than one batch): the JAX side as the
    script builds it (aligned binning, packed pairs in the script's
    (16, NBUF) layout), the port side from the same projection and the
    port's own 16x16 binning."""
    cloud = testing.make_gaussian_cloud(0, request.param, extent=1.0,
                                        scale_range=(0.02, 0.1))
    cam = testing.make_orbit_cameras(1, radius=4.0, width=W, height_px=H)[0]
    jp, _ = project_both(cloud, cam)
    jba = bin_gaussians_aligned(jp.means2d, jp.depths, jp.radii, W, H,
                                MAX_PAIRS)
    pd = np.asarray(jax_raster.pack_pair_data(jp, jba.ids))
    env = dict(ba=jba, pd=jnp.asarray(pd.transpose(1, 0, 2).reshape(16, -1)),
               pr=jax_raster, GRID_X=GRID_X, NT=NT)
    tp = to_torch(jp)
    ba = bin_gaussians(tp.means2d, tp.depths, tp.radii, W, H, 16, 16)
    # the aligned binning keeps the port's pair order, sentinels after it
    jids, jstarts = np.asarray(jba.ids), np.asarray(jba.tile_starts)
    for t, (s, c) in enumerate(zip(ba.tile_starts.tolist(),
                                   ba.tile_counts.tolist())):
        np.testing.assert_array_equal(
            jids[jstarts[t]:jstarts[t] + c], ba.ids[s:s + c].numpy())
    return _Script("tpu_dbg.py"), env, fwd_bisect.pair_args(tp, ba)


@pytest.mark.parametrize("walk_all", [False, True])
def test_tile_alpha_matches_pallas(dbg_scene, walk_all):
    """D1 (`make_kernel(with_loop)`): alpha within 1e-6 on every tile's
    real lanes; the port's lanes past the pair count are zero."""
    script, env, args = dbg_scene
    want = script.run("make_kernel", with_loop=walk_all, **env)
    m, _, con, _, op, ids, starts, counts = args
    got = probes.tile_alpha(m, con, op, ids, starts, counts, W, H,
                            walk_all=walk_all).numpy()
    assert got.shape == want.shape == (NT, 256, 256)
    for t, c in enumerate(counts.tolist()):
        c = min(c, probes.CHUNK)
        np.testing.assert_allclose(got[t][:, :c], want[t][:, :c], atol=1e-6,
                                   rtol=0, err_msg=f"tile {t}")
        assert not got[t][:, c:].any()
    assert (got > 0).sum() > 1000


def test_tile_blend_matches_pallas(dbg_scene):
    """D2 (`blend_kernel`): payload sums and log T within 1e-5 of the
    largest value, n_contrib exact, every other column zero."""
    script, env, args = dbg_scene
    want = script.run("blend_kernel", **env)
    got = probes.tile_blend(*args, W, H).numpy()
    scale = np.abs(want[..., :9]).max()
    np.testing.assert_allclose(got[..., :9], want[..., :9],
                               atol=1e-5 * scale, rtol=0)
    np.testing.assert_array_equal(got[..., 9], want[..., 9])
    assert not got[..., 10:].any() and not want[..., 10:].any()


@pytest.mark.parametrize("cli", ["prims", "fwd_bisect"])
def test_probe_cli_on_cpu(cli, capsys):
    """Both entry points pass on the CPU through the plain versions."""
    mod = prims if cli == "prims" else fwd_bisect
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "FAILED" not in out
    assert out.count("OK") == (4 if cli == "prims" else 1)


def test_fwd_bisect_two_batches_on_cpu(capsys):
    """A denser scene whose tiles hold more than one batch of pairs: the
    plain forward against the two-batch expectation on tiles of <= 512."""
    assert fwd_bisect.main(["--device", "cpu", "--points", "2000"]) == 0
    proj, ba = fwd_bisect.build_scene(W, H, 2000, torch.device("cpu"))
    counts = ba.tile_counts
    assert int(counts.max()) > probes.CHUNK
    assert bool(((counts > probes.CHUNK) & (counts <= 512)).any())


@pytest.mark.parametrize("opacity,near", [(None, True), (0.5, False)])
def test_skip_test_replay(opacity, near):
    """`fwd_bisect` excuses a pixel where the forward kernel and the plain
    expectation differ only if one of its pairs sits within rounding of a
    skip test: here alpha = op exp(-1/2) at pixel (1, 0), op set so that
    alpha lands on 1/255, or well above it."""
    from sparse_view_3dgs_pack_tpu_torch.ops.blending import ALPHA_EPS
    op = ALPHA_EPS / np.exp(-0.5) if opacity is None else opacity
    f = lambda *v: torch.tensor(v, dtype=torch.float32)
    i = lambda *v: torch.tensor(v, dtype=torch.int32)
    args = (f([0.0, 0.0]), f(4.0), f([1.0, 0.0, 1.0]), f([1.0, 1.0, 1.0]),
            f(op), i(0), i(0), i(1))
    assert fwd_bisect._at_skip_test(args, 0, 1, 1, 16) is near


def test_wrappers_on_cpu_run_plain_versions():
    """CPU tensors take the plain version and launch nothing; the wrappers
    refuse what the kernels do not take."""
    names = ("tile_coords", "row_cumsum", "offset_copy", "pair_alpha",
             "tile_alpha", "tile_blend")
    before = {n: getattr(probes, n).launches for n in names}
    x = torch.zeros((4, 64))
    assert torch.equal(probes.row_cumsum(x), probes.row_cumsum_torch(x))
    probes.tile_coords(2, 2, device="cpu")
    assert {n: getattr(probes, n).launches for n in names} == before
    with pytest.raises(ValueError):
        probes.row_cumsum(x.double())
    with pytest.raises(ValueError):
        probes.offset_copy(x, torch.zeros(2, dtype=torch.int64))
    with pytest.raises(ValueError):
        probes.pair_alpha(torch.zeros((5, 8)))
    ids = torch.zeros(0, dtype=torch.int32)
    z = torch.zeros(12, dtype=torch.int32)
    with pytest.raises(ValueError):     # 12 tiles is not a 64x64 grid
        probes.tile_alpha(torch.zeros((1, 2)), torch.zeros((1, 3)),
                          torch.zeros(1), ids, z, z, 64, 64)
    empty = probes.tile_alpha(torch.zeros((1, 2)), torch.zeros((1, 3)),
                              torch.zeros(1), ids, z, z, W, H)
    assert empty.shape == (12, 256, 256) and not empty.any()


@pytest.mark.cuda
@pytest.mark.parametrize("probe", ["tile_coords", "row_cumsum",
                                   "offset_copy", "pair_alpha",
                                   "tile_alpha", "tile_blend"])
def test_cuda_probe_matches_plain(probe):
    """Each CUDA probe against its plain version on the card: P1, P3 and
    D1's two instantiations bitwise, P2 1e-4, P4 and D1 1e-6, D2 1e-5 of
    the largest value with n_contrib exact."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dev = torch.device("cuda")
    fn = getattr(probes, probe)
    before, calls = fn.launches, 1
    if probe == "tile_coords":
        assert torch.equal(fn(8, 4, dev), probes.tile_coords_torch(8, 4, dev))
    elif probe == "row_cumsum":
        x = torch.as_tensor(prims.scan_input(), device=dev)
        torch.testing.assert_close(fn(x), probes.row_cumsum_torch(x),
                                   atol=1e-4, rtol=0)
    elif probe == "offset_copy":
        data, starts = (torch.as_tensor(a, device=dev)
                        for a in prims.copy_input())
        assert torch.equal(fn(data, starts),
                           probes.offset_copy_torch(data, starts))
        odd = torch.tensor([-3, 5, 8190], dtype=torch.int32, device=dev)
        assert torch.equal(fn(data, odd), probes.offset_copy_torch(data, odd))
        calls = 2
    elif probe == "pair_alpha":
        d = torch.as_tensor(prims.alpha_input(), device=dev)
        torch.testing.assert_close(fn(d), probes.pair_alpha_torch(d),
                                   atol=1e-6, rtol=0)
    else:
        proj, ba = fwd_bisect.build_scene(W, H, 2000, dev)
        args = fwd_bisect.pair_args(proj, ba)
        if probe == "tile_alpha":
            m, _, con, _, op, ids, starts, counts = args
            geo = (m, con, op, ids, starts, counts, W, H)
            got = fn(*geo)
            assert torch.equal(got, fn(*geo, walk_all=True))
            torch.testing.assert_close(got, probes.tile_alpha_torch(*geo),
                                       atol=1e-6, rtol=0)
            calls = 2
        else:
            got = fn(*args, W, H)
            want = probes.tile_blend_torch(*args, W, H)
            assert torch.equal(got[..., 9], want[..., 9])
            torch.testing.assert_close(
                got[..., :9], want[..., :9], rtol=0,
                atol=1e-5 * float(want[..., :9].abs().max()))
    torch.cuda.synchronize()
    assert fn.launches == before + calls
