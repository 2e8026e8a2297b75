"""Port parity for DNGaussian's encoders: the hash-grid encoding (values and
the table gradient, on a configuration with dense and hashed levels) and
the SH direction basis, against the JAX package (`ops/hashgrid.py`,
`ops/shencode.py`). Inputs are made with numpy from a seed."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu.ops import hashgrid as jax_hashgrid
from sparse_view_3dgs_pack_tpu.ops import shencode as jax_shencode
from sparse_view_3dgs_pack_tpu_torch.ops import hashgrid, shencode
import torch_port  # noqa: F401  (one intra-op thread)

# 4 levels from 4 to 32 in a 2^10 table: resolutions 4, 8 (dense: (r+1)³ ≤
# 1024) and 16, 32 (hashed)
CFG = dict(num_levels=4, level_dim=2, base_resolution=4,
           log2_hashmap_size=10, desired_resolution=32)
BOUND = 1.5
TOL = 1e-6


def _inputs(seed=0, n=500):
    """Points over and past the bound (the clamp), points on the faces
    (pos0 clamped, frac 1), a table of N(0, 1) features, a cotangent."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(-1.1 * BOUND, 1.1 * BOUND, (n, 3)).astype(np.float32)
    x[:12] = BOUND * np.array([[1, 1, 1], [-1, -1, -1], [1, -1, 0],
                               [0, 1, -1], [1, 0.3, 0.2], [-1, 0.5, 1],
                               [0.25, 0.5, 0.75], [2, 2, 2], [-2, 0, 2],
                               [0, 0, 0], [1, 1, -1], [-0.5, 1, 0]],
                              np.float32)
    table = rng.normal(size=(4, 1 << 10, 2)).astype(np.float32)
    cot = rng.normal(size=(n, 8)).astype(np.float32)
    return x, table, cot


def test_resolutions_and_index_kinds_match_jax():
    """The level resolutions (the np.floor of `:36-42`) for the test and
    the default configurations, and that the test's has both index kinds."""
    for kw in (CFG, {}):
        want = jax_hashgrid.HashGridConfig(**kw).resolutions()
        assert hashgrid.HashGridConfig(**kw).resolutions() == want
    res = hashgrid.HashGridConfig(**CFG).resolutions()
    dense = [(r + 1) ** 3 <= 1 << 10 for r in res]
    assert any(dense) and not all(dense), res


def test_hashgrid_encode_matches_jax():
    """Dense and hashed levels, clamped and face points: ≤ 1e-6 abs."""
    x, table, _ = _inputs()
    want = np.asarray(jax_hashgrid.hashgrid_encode(
        jnp.asarray(table), jnp.asarray(x),
        jax_hashgrid.HashGridConfig(**CFG), BOUND))
    got = hashgrid.hashgrid_encode(torch.tensor(table), torch.tensor(x),
                                   hashgrid.HashGridConfig(**CFG), BOUND)
    assert got.shape == want.shape == (x.shape[0], 8)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=0)


def test_hashgrid_table_gradient_matches_jax():
    """The scatter-add gradient of the table under a random cotangent,
    against jax.grad: ≤ 1e-6 of its largest entry; rows no point touches
    get exactly zero on both sides."""
    x, table, cot = _inputs(1)
    jcfg = jax_hashgrid.HashGridConfig(**CFG)
    want = np.asarray(jax.grad(lambda t: jnp.sum(
        jax_hashgrid.hashgrid_encode(t, jnp.asarray(x), jcfg, BOUND)
        * cot))(jnp.asarray(table)))
    t = torch.tensor(table, requires_grad=True)
    (hashgrid.hashgrid_encode(t, torch.tensor(x),
                              hashgrid.HashGridConfig(**CFG), BOUND)
     * torch.tensor(cot)).sum().backward()
    got = t.grad.numpy()
    np.testing.assert_allclose(got, want, atol=TOL * np.abs(want).max(),
                               rtol=0)
    np.testing.assert_array_equal(got == 0, want == 0)


def test_init_hashgrid_range_and_seed():
    """torch-ngp's init: uniform in [-1e-4, 1e-4], the same draw from the
    same generator seed."""
    cfg = hashgrid.HashGridConfig(**CFG)
    a = hashgrid.init_hashgrid(torch.Generator().manual_seed(3), cfg)
    b = hashgrid.init_hashgrid(torch.Generator().manual_seed(3), cfg)
    assert a.shape == (4, 1 << 10, 2) and torch.equal(a, b)
    assert float(a.abs().max()) <= 1e-4 and float(a.std()) > 1e-5


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_sh_encode_matches_jax(degree):
    """The real SH basis of unit directions at degrees 1-4: ≤ 1e-6."""
    rng = np.random.default_rng(degree)
    d = rng.normal(size=(300, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    want = np.asarray(jax_shencode.sh_encode(jnp.asarray(d), degree))
    got = shencode.sh_encode(torch.tensor(d), degree).numpy()
    assert got.shape == want.shape == (300, degree ** 2)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
