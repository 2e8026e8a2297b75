"""The port's exact 3-NN (`ops/knn.py`): the plain version against the JAX
package's brute-force oracle `knn3_bruteforce`, its tie order (equal
squared distances go to the lower index) and bits against a numpy brute
force on clouds with far outliers and exact duplicates, independence of
its chunk size, and the scale init built on it. `cuda`-marked tests hold
the kernel (`csrc/knn.cu`) to the plain version bit for bit on the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu.ops.knn import knn3 as jax_knn3
from sparse_view_3dgs_pack_tpu.ops.knn import knn3_bruteforce
from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.ops import knn
import torch_port  # noqa: F401  (one intra-op thread)


def _numpy_knn3(pts):
    """float32 brute force in the port's rounding order, ties by index."""
    d = pts[:, None, :] - pts[None, :, :]
    d2 = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] + d[..., 2] * d[..., 2]
    np.fill_diagonal(d2, np.inf)
    idx = np.argsort(d2, axis=1, kind="stable")[:, :3]
    top = np.take_along_axis(d2, idx, 1)
    return (top[:, 0] + top[:, 1] + top[:, 2]) / np.float32(3.0), idx


def test_knn3_plain_matches_jax_bruteforce():
    """Tie-free input: the same neighbours, the mean d² within 1e-6
    relative (the JAX oracle sums its squares in its own order)."""
    pts = np.random.default_rng(0).uniform(-1, 1, (400, 3)).astype(
        np.float32)
    want_d, want_i = knn3_bruteforce(jnp.asarray(pts))
    got_d, got_i = knn.knn3(torch.tensor(pts))
    assert got_i.dtype == torch.int32 and got_d.dtype == torch.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), rtol=1e-6)


@pytest.mark.parametrize("seed", [1, 2])
def test_knn3_plain_ties_and_outliers(seed):
    """Outliers and exact duplicates: indices equal to a stable brute force
    (ties to the lower index) and the mean bitwise."""
    pts = testing.knn_stress_cloud(seed, 600)
    want_d, want_i = _numpy_knn3(pts)
    got_d, got_i = knn.knn3(torch.tensor(pts))
    np.testing.assert_array_equal(got_i.numpy(), want_i)
    np.testing.assert_array_equal(got_d.numpy(), want_d)
    assert (got_d.numpy() == 0).sum() > 10       # whole lists tie at 0
    assert (got_i.numpy() != np.arange(600)[:, None]).all()


def test_knn3_plain_is_chunk_independent(monkeypatch):
    pts = torch.tensor(testing.knn_stress_cloud(3, 300))
    whole = knn.knn3(pts)
    monkeypatch.setattr(knn, "KNN_MAX_ELEMS", 300 * 7)
    chunked = knn.knn3(pts)
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])


def test_jax_windowed_knn3_against_the_exact_port():
    """FSGS's proximity and split masks read `knn3`: JAX's FSGS calls the
    windowed Morton search (3 rotations, ±32 sorted neighbours), the port
    the exact one. On a cloud built like the few-shot fixture's dense init
    (6,000 noisy points in its three slabs, 30 strays at 8 to 15 units
    around (0, 0, 1.2), seed 3) the windowed mean d² is never below the
    exact one (within JAX's own rounding of the sum), and the two pick
    other neighbours for some points, strays among them."""
    rng = np.random.default_rng(3)
    n = 6000
    xyz = rng.uniform(-1, 1, (n, 3))
    slab = rng.integers(0, 3, n)
    xyz[:, 2] = xyz[:, 2] * np.array([0.5, 0.4, 0.8])[slab] \
        + np.array([0.0, 1.2, 2.6])[slab]
    xyz += rng.normal(0, 0.01, xyz.shape)
    v = rng.normal(size=(30, 3))
    v *= rng.uniform(8, 15, (30, 1)) / np.linalg.norm(v, axis=1,
                                                       keepdims=True)
    pts = np.concatenate([xyz, v + np.array([0.0, 0.0, 1.2])]).astype(
        np.float32)
    jd, ji = (np.asarray(a) for a in jax_knn3(jnp.asarray(pts)))
    d, i = (a.numpy() for a in knn.knn3(torch.tensor(pts)))
    assert (jd >= d * np.float32(1 - 1e-6)).all()
    differ = (ji != i).any(1)
    assert differ[:n].any() and differ[n:].any()


def test_dist2_for_scale_init_and_input_checks():
    pts = testing.knn_stress_cloud(4, 200)
    d2 = knn.dist2_for_scale_init(torch.tensor(pts))
    want = np.maximum(_numpy_knn3(pts)[0], np.float32(1e-7))
    np.testing.assert_array_equal(d2.numpy(), want)
    three = torch.tensor([[0.0, 0, 0], [1.0, 0, 0], [0, 3.0, 0]])
    np.testing.assert_allclose(knn.dist2_for_scale_init(three).numpy(),
                               [1.0 / 2 + 9.0 / 2, 1.0 / 2 + 10.0 / 2,
                                9.0 / 2 + 10.0 / 2])
    assert knn.dist2_for_scale_init(three[:1]).tolist() == \
        pytest.approx([1e-7])
    with pytest.raises(ValueError, match="more than 3"):
        knn.knn3(three)
    with pytest.raises(ValueError, match="float32"):
        knn.knn3(torch.zeros((10, 3), dtype=torch.float64))


def _strays_in_one_warp(rng):
    """20,000 points in [-1, 1]³ and 20 strays at 8 to 15 units in the far
    octant: every stray's code is above every dense point's, so the strays
    fill sorted positions 20,000-20,019, one leaf, one warp."""
    dense = rng.uniform(-1, 1, (20_000, 3))
    return np.concatenate([dense, rng.uniform(8, 15, (20, 3))])


def _cuda_clouds(cloud):
    rng = np.random.default_rng(5)
    return {
        "uniform": lambda: rng.uniform(-2, 2, (20_000, 3)),
        "stress": lambda: testing.knn_stress_cloud(6, 20_000),
        "tiny": lambda: rng.uniform(-1, 1, (5, 3)),
        "n4": lambda: rng.uniform(-1, 1, (4, 3)),
        "leaf_plus_1": lambda: rng.uniform(-1, 1, (knn.LEAF + 1, 3)),
        "parent_plus_1": lambda: rng.uniform(
            -1, 1, (knn.LEAF * knn.FAN + 1, 3)),
        "strays_one_warp": lambda: _strays_in_one_warp(rng),
        "one_point": lambda: np.full((2_000, 3), 0.25),
        "duplicates": lambda: np.repeat(rng.uniform(-1, 1, (1_000, 3)), 4,
                                        axis=0)[rng.permutation(4_000)],
    }[cloud]()


@pytest.mark.cuda
@pytest.mark.parametrize("cloud", ["uniform", "stress", "tiny", "n4",
                                   "leaf_plus_1", "parent_plus_1",
                                   "strays_one_warp", "one_point",
                                   "duplicates", "listed"])
def test_cuda_knn3_bitwise_matches_plain(cloud, monkeypatch):
    """The kernel against the plain version on the card, bitwise in
    indices and mean d²: a uniform cloud, the outlier and duplicate cloud
    (some of its queries finished by a block each: `knn3.listed`), 5 and 4
    points (one leaf), a leaf and a parent plus one point, 20 strays in one
    warp, 2,000 copies of one point and 1,000 points four times each; and
    the uniform cloud with a budget of one leaf, so that most queries are
    listed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    if cloud == "listed":
        monkeypatch.setattr(knn, "BUDGET", 1)
    pts = _cuda_clouds("uniform" if cloud == "listed" else cloud)
    p = torch.tensor(np.asarray(pts, np.float32), device="cuda")
    before = knn.knn3.launches
    d, i = knn.knn3(p)
    listed = int(knn.knn3.listed)
    rd, ri = knn.knn3_torch(p)
    torch.cuda.synchronize()
    assert knn.knn3.launches == before + 1
    assert torch.equal(i, ri)
    assert torch.equal(d, rd)
    if cloud in ("stress", "listed"):
        assert listed > 0
