"""The boxes of the 3-NN kernel (`csrc/knn.cu`) through their plain versions
in `ops/knn.py`: the Morton codes and the leaf and parent boxes against a
direct computation, and a property test that the search may prune by them:
over random clouds (uniform, strays, exact duplicates, flat, tiny extents,
mixed scales), a box's distance to a query, and to the box of the query's
leaf, rounded in float32 step by step without FMA as the kernel rounds it
(numpy float32 here), is at most the squared distance of the query to any
member. Needs `hypothesis` for the property test."""

import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu_torch import testing
from sparse_view_3dgs_pack_tpu_torch.ops import knn
import torch_port  # noqa: F401  (one intra-op thread)

_F0 = np.float32(0.0)


def _gap2(qlo, qhi, lo, hi):
    """The kernel's `gap2` in float32, each operation rounded on its own."""
    d = [np.maximum(np.maximum(lo[..., a] - qhi[..., a],
                               qlo[..., a] - hi[..., a]), _F0)
         for a in range(3)]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def _sqdist(pts):
    """(N, N) float32 dx·dx + dy·dy + dz·dz, query minus point."""
    d = [pts[:, None, a] - pts[None, :, a] for a in range(3)]
    return d[0] * d[0] + d[1] * d[1] + d[2] * d[2]


def _tree(pts):
    t = torch.as_tensor(pts)
    order = torch.sort(knn.morton_codes_torch(t), stable=True).indices
    leaves, parents = knn.tree_boxes_torch(t, order)
    return order.numpy(), leaves, parents


def _direct_codes(pts):
    """Morton codes by a loop over the bits: 21 a coordinate, x lowest."""
    lo, hi = pts.min(0), pts.max(0)
    ext = hi - lo
    cells = np.float32(knn.CELLS)
    codes = []
    for p in pts:
        code = 0
        for a in range(3):
            q = ((p[a] - lo[a]) / ext[a]) * cells if ext[a] > 0 else _F0
            c = int(min(max(q, _F0), cells))
            for b in range(21):
                code |= ((c >> b) & 1) << (3 * b + a)
        codes.append(code)
    return np.array(codes, np.int64)


def _direct_runs(pts, idx, size):
    """Per run of `size` consecutive rows: (lo, hi, least index, count)."""
    out = []
    for s in range(0, len(idx), size):
        run = idx[s:s + size]
        out.append((pts[run].min(0), pts[run].max(0), run.min(), len(run)))
    return out


@pytest.mark.parametrize("cloud", ["stress", "strays", "flat"])
def test_codes_and_boxes_match_a_direct_computation(cloud):
    """`morton_codes_torch` bit for bit against a loop over the bits (its
    stable sort equal to numpy's), and each leaf's and parent's corners,
    least original index and count against the runs' own min, max and
    length; 2,100 points, so three parents, the last one short."""
    rng = np.random.default_rng(11)
    pts = {"stress": lambda: testing.knn_stress_cloud(12, 2100),
           "strays": lambda: np.concatenate([
               rng.normal(0, 0.05, (2070, 3)),
               rng.uniform(-15, 15, (30, 3))]),
           "flat": lambda: np.stack([rng.uniform(-1, 1, 2100),
                                     np.full(2100, 0.5),
                                     rng.uniform(0, 1e-3, 2100)], 1),
           }[cloud]().astype(np.float32)
    codes = knn.morton_codes_torch(torch.as_tensor(pts)).numpy()
    np.testing.assert_array_equal(codes, _direct_codes(pts))
    order, leaves, parents = _tree(pts)
    np.testing.assert_array_equal(order, np.argsort(codes, kind="stable"))
    want_leaves = _direct_runs(pts, order, knn.LEAF)
    assert leaves.lo.shape == (len(want_leaves), 3)
    for j, (lo, hi, least, count) in enumerate(want_leaves):
        np.testing.assert_array_equal(leaves.lo[j].numpy(), lo)
        np.testing.assert_array_equal(leaves.hi[j].numpy(), hi)
        assert int(leaves.least[j]) == least
        assert int(leaves.count[j]) == count
    want_parents = _direct_runs(pts, order, knn.LEAF * knn.FAN)
    assert parents.lo.shape == (3, 3) and len(want_parents) == 3
    for j, (lo, hi, least, count) in enumerate(want_parents):
        np.testing.assert_array_equal(parents.lo[j].numpy(), lo)
        np.testing.assert_array_equal(parents.hi[j].numpy(), hi)
        assert int(parents.least[j]) == least
        assert int(parents.count[j]) == count


def test_knn3_work_needs_the_card():
    with pytest.raises(ValueError, match="CUDA"):
        knn.knn3_work(torch.zeros((8, 3)))


try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:   # the property test skips without hypothesis
    st = None

if st is None:
    def test_box_distances_are_lower_bounds():
        pytest.skip("needs hypothesis")
else:
    @st.composite
    def _clouds(draw):
        """A float32 cloud of 4 to 1,300 points: uniform, with far
        strays, with exact duplicates, flat along an axis, of a tiny extent
        away from the origin, or of mixed scales."""
        n = draw(st.integers(4, 1300))
        rng = np.random.default_rng(draw(st.integers(0, 2 ** 31)))
        kind = draw(st.sampled_from(["uniform", "strays", "duplicates",
                                     "flat", "tiny", "scales"]))
        pts = rng.uniform(-1, 1, (n, 3))
        if kind == "strays":
            k = max(1, n // 50)
            v = rng.normal(size=(k, 3))
            pts[:k] = v * 10.0 ** rng.uniform(0.5, 4.0, (k, 1))
        elif kind == "duplicates":
            pts = pts[rng.integers(0, max(1, n // 4), n)]
        elif kind == "flat":
            pts[:, rng.integers(0, 3)] = rng.uniform(-2, 2)
        elif kind == "tiny":
            pts = 1000.0 + pts * 1e-4
        elif kind == "scales":
            pts *= 10.0 ** rng.uniform(-3, 3, (n, 1))
        return pts.astype(np.float32)

    @settings(max_examples=60, deadline=None, database=None,
              derandomize=True)
    @given(_clouds())
    def test_box_distances_are_lower_bounds(pts):
        """Every leaf's and parent's distance to every query, and to the
        box of the query's own leaf (the warp's test), rounded as the kernel
        rounds it, is at most the query's d² to each member; boxes hold
        their members and the query's leaf box holds the query."""
        n = len(pts)
        order, leaves, parents = _tree(pts)
        srt = pts[order]
        d2 = _sqdist(srt)                       # (query, member), sorted
        own = np.arange(n) // knn.LEAF          # the query's leaf
        q = srt[:, None, :]
        for boxes, size in ((leaves, knn.LEAF),
                            (parents, knn.LEAF * knn.FAN)):
            lo, hi = boxes.lo.numpy()[None], boxes.hi.numpy()[None]
            m = lo.shape[1]
            member = np.arange(n) // size       # each sorted point's box
            nearest = np.full((n, m), np.inf, np.float32)
            np.minimum.at(nearest.T, member, d2.T)   # min d² in each box
            assert (srt >= boxes.lo.numpy()[member]).all()
            assert (srt <= boxes.hi.numpy()[member]).all()
            to_query = _gap2(q, q, lo, hi)      # (query, box)
            assert (to_query <= nearest).all()
            llo = leaves.lo.numpy()[own][:, None, :]
            lhi = leaves.hi.numpy()[own][:, None, :]
            assert (llo <= q).all() and (q <= lhi).all()
            to_leaf = _gap2(llo, lhi, lo, hi)   # the warp's test
            assert (to_leaf <= to_query).all()
