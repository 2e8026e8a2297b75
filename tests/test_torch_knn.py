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


@pytest.mark.cuda
@pytest.mark.parametrize("cloud", ["uniform", "stress", "tiny"])
def test_cuda_knn3_bitwise_matches_plain(cloud):
    """The kernel against the plain version on the card, bitwise in
    indices and mean d²: a uniform cloud, the outlier and duplicate
    cloud, and 5 points (one box, every point a seed of every other)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    rng = np.random.default_rng(5)
    pts = {"uniform": lambda: rng.uniform(-2, 2, (20_000, 3)),
           "stress": lambda: testing.knn_stress_cloud(6, 20_000),
           "tiny": lambda: rng.uniform(-1, 1, (5, 3))}[cloud]()
    p = torch.tensor(np.asarray(pts, np.float32), device="cuda")
    before = knn.knn3.launches
    d, i = knn.knn3(p)
    rd, ri = knn.knn3_torch(p)
    torch.cuda.synchronize()
    assert knn.knn3.launches == before + 1
    assert torch.equal(i, ri)
    assert torch.equal(d, rd)
