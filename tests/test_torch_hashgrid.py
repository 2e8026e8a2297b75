"""Port parity for DNGaussian's encoders: the hash-grid encoding (values,
the table's gradient and the points', on a configuration with dense and
hashed levels) and the SH direction basis, against the JAX package
(`ops/hashgrid.py`, `ops/shencode.py`); on the CPU, `hashgrid_encode`'s
dispatch to the plain composition, the kernels' argument checks and the
field's module-level encode that the benchmark's `coarse_grid` fault
patches. Inputs are made with numpy from a seed. The kernels themselves
are held to the plain version on a card in `test_torch_hashgrid_card.py`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu.ops import hashgrid as jax_hashgrid
from sparse_view_3dgs_pack_tpu.ops import shencode as jax_shencode
from sparse_view_3dgs_pack_tpu_torch.models import neural_field as nf
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


def test_hashgrid_x_gradient_matches_jax():
    """The points' gradient under a random cotangent, against jax.grad:
    ≤ 1e-6 of its largest entry, and exactly zero on both sides where the
    clamp holds a coordinate outside [0, 1]. On the faces (u exactly 0 or
    1) JAX's clip splits the tie between its two branches and passes half;
    torch.clamp's backward, which the kernel follows, passes all of it:
    there the port's is twice JAX's."""
    x, table, cot = _inputs(2)
    jcfg = jax_hashgrid.HashGridConfig(**CFG)
    want = np.asarray(jax.grad(lambda p: jnp.sum(
        jax_hashgrid.hashgrid_encode(jnp.asarray(table), p, jcfg, BOUND)
        * cot))(jnp.asarray(x)))
    xt = torch.tensor(x, requires_grad=True)
    (hashgrid.hashgrid_encode(torch.tensor(table), xt,
                              hashgrid.HashGridConfig(**CFG), BOUND)
     * torch.tensor(cot)).sum().backward()
    got = xt.grad.numpy()
    u = (x + BOUND) / (2 * BOUND)
    face, outside = (u == 0) | (u == 1), (u < 0) | (u > 1)
    assert face.sum() >= 12 and outside.sum() >= 100
    atol = TOL * np.abs(want).max()
    np.testing.assert_allclose(got[~face], want[~face], atol=atol, rtol=0)
    np.testing.assert_allclose(got[face], 2 * want[face], atol=atol, rtol=0)
    assert not got[outside].any() and not want[outside].any()
    assert np.abs(got[~face & ~outside]).min() > 0


@pytest.mark.parametrize("grads", ["table_and_x", "table", "x"])
def test_hashgrid_function_on_the_cpu_is_the_plain_composition(grads):
    """`hashgrid_encode`'s dispatch on CPU tensors: its values are the
    plain composition's and its gradients autograd's of it, bit for bit;
    it gives a gradient to exactly the inputs that ask for one.
    `HashGridFunction` itself takes CUDA tensors only."""
    x, table, cot = _inputs(3)
    cfg = hashgrid.HashGridConfig(**CFG)

    def run(fn):
        t = torch.tensor(table, requires_grad="table" in grads)
        p = torch.tensor(x, requires_grad="x" in grads)
        out = fn(t, p, cfg, BOUND)
        (out * torch.tensor(cot)).sum().backward()
        return out.detach(), t.grad, p.grad

    got = run(hashgrid.hashgrid_encode)
    want = run(hashgrid.hashgrid_encode_torch)
    assert torch.equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert (g is None) == (w is None)
        assert g is None or torch.equal(g, w)
    assert (got[1] is None, got[2] is None) == ("table" not in grads,
                                                "x" not in grads)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        run(hashgrid.HashGridFunction.apply)


@pytest.mark.parametrize("entry", ["forward", "backward"])
def test_the_kernel_entries_refuse_cpu_tensors(entry):
    """`hashgrid_forward` and `hashgrid_backward` have no CPU path: on CPU
    tensors they raise before any launch, and the counters stay."""
    x, table, cot = (torch.tensor(a) for a in _inputs(6, 40))
    cfg = hashgrid.HashGridConfig(**CFG)
    call = {"forward": lambda: hashgrid.hashgrid_forward(table, x, cfg,
                                                         BOUND),
            "backward": lambda: hashgrid.hashgrid_backward(
                table, x, cot, cfg, BOUND)}[entry]
    counts = (hashgrid.hashgrid_forward.launches,
              hashgrid.hashgrid_backward.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        call()
    assert (hashgrid.hashgrid_forward.launches,
            hashgrid.hashgrid_backward.launches) == counts


def test_the_fields_encode_is_the_module_level_name(monkeypatch):
    """`NeuralField.neural_density` reaches the encode through the
    module-level name `neural_field.hashgrid_encode`: patching it, as the
    benchmark's `coarse_grid` fault does, changes the field's output."""
    field = nf.NeuralField(nf.NeuralFieldConfig(
        grid=hashgrid.HashGridConfig(**CFG), bound=BOUND),
        torch.Generator().manual_seed(1))
    with torch.no_grad():
        field.encoder.normal_(generator=torch.Generator().manual_seed(2))
    x = torch.tensor(_inputs(4, 200)[0])
    sigma, geo = field.neural_density(x)
    calls = []

    def coarse(table, p, cfg, bound):
        calls.append(p.shape[0])
        out = hashgrid.hashgrid_encode(table, p, cfg, bound)
        return torch.cat([out[:, :-cfg.level_dim],
                          torch.zeros_like(out[:, -cfg.level_dim:])], 1)

    monkeypatch.setattr(nf, "hashgrid_encode", coarse)
    sigma2, geo2 = field.neural_density(x)
    assert calls == [200]
    assert not torch.equal(sigma, sigma2) and not torch.equal(geo, geo2)


@pytest.mark.parametrize("change", ["dtype", "contiguous", "x_shape",
                                    "table_shape", "level_dim", "levels",
                                    "device"])
def test_hashgrid_kernels_refuse_what_they_do_not_take(change):
    """The kernels' checks: float32, contiguous, x (N, 3), the table as the
    configuration shapes it, a level_dim of 1, 2, 4 or 8, at most 32
    levels, one device."""
    x, table, _ = _inputs(5, 50)
    x, table = torch.tensor(x), torch.tensor(table)
    cfg = hashgrid.HashGridConfig(**CFG)
    bad = {"dtype": lambda: (table.double(), x, cfg),
           "contiguous": lambda: (table.transpose(0, 1).contiguous()
                                  .transpose(0, 1), x, cfg),
           "x_shape": lambda: (table, x[:, :2].contiguous(), cfg),
           "table_shape": lambda: (table, x, cfg._replace(
               log2_hashmap_size=11)),
           "level_dim": lambda: (table[..., :1].repeat(1, 1, 3), x,
                                 cfg._replace(level_dim=3)),
           "levels": lambda: (table.repeat(9, 1, 1), x,
                              cfg._replace(num_levels=36)),
           "device": lambda: (table, x.to("meta"), cfg)}[change]()
    hashgrid._check_inputs(table, x, cfg)
    with pytest.raises(ValueError):
        hashgrid._check_inputs(*bad)


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
