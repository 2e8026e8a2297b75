"""Adam (`train/optim.py`, `ops/adam.py`, `csrc/adam.cu`): on the CPU the
dispatch runs the plain version unchanged, the kernel's arithmetic written
out in numpy matches it bit for bit, the wrapper refuses what the kernel
does not take and its chunk plan covers every value once; on a card
(`-m cuda`) the kernel against the plain version bit for bit over three
consecutive steps, and one launch a call.

No JAX here: the card tests compare with the plain PyTorch version."""

from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from sparse_view_3dgs_pack_tpu_torch.ops import adam as adam_ops
from sparse_view_3dgs_pack_tpu_torch.train import optim

torch.set_num_threads(1)

# the Gaussians' groups and their row widths
GAUSSIAN_GROUPS = (("xyz", (3,)), ("features_dc", (1, 3)),
                   ("features_rest", (15, 3)), ("opacity", (1,)),
                   ("scaling", (3,)), ("rotation", (4,)))


def _state(params: dict, seed: int, device) -> tuple:
    """(gradients, a warm AdamState at step 0): first moments N(0, 1e-3),
    second moments 1e-8·U(0.5, 1.5), gradients N(0, 1e-3) with some
    zeros and some tiny (their squares subnormal)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rand(t, kind):
        u = (torch.randn if kind == "n" else torch.rand)(
            t.shape, generator=g, device=device)
        return u
    grads, m, v = {}, {}, {}
    for k, p in params.items():
        gr = 1e-3 * rand(p, "n")
        flat = gr.view(-1)
        flat[::7] = 0.0
        flat[3::11] *= 1e-17
        grads[k] = gr
        m[k] = 1e-3 * rand(p, "n")
        v[k] = 1e-8 * (0.5 + rand(p, "u"))
    return grads, optim.AdamState(m=m, v=v)


def _gaussians(n: int, device, seed: int = 0) -> dict:
    g = torch.Generator(device=device).manual_seed(seed)
    return {k: torch.randn((n,) + s, generator=g, device=device)
            for k, s in GAUSSIAN_GROUPS}


def _lrs(params: dict) -> dict:
    return {k: 1e-3 * (i + 1) for i, k in enumerate(params)}


def _mask(n: int, device, seed: int = 1) -> torch.Tensor:
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(n, generator=g, device=device) < 0.6


def _clone(params: dict, state) -> tuple:
    return ({k: p.clone() for k, p in params.items()},
            copy.deepcopy(state))


def _assert_equal(params_a, state_a, params_b, state_b) -> None:
    assert state_a.step == state_b.step
    for k in params_a:
        for what, a, b in (("p", params_a[k], params_b[k]),
                           ("m", state_a.m[k], state_b.m[k]),
                           ("v", state_a.v[k], state_b.v[k])):
            assert torch.equal(a, b), (k, what)


# ---------------------------------------------------------------------------
# CPU


@pytest.mark.parametrize("masked", (False, True))
def test_cpu_dispatch_runs_the_plain_version(masked):
    """On CPU tensors `adam_update` and `exposure_adam_update` give the
    plain versions' results bit for bit, and launch nothing."""
    params = _gaussians(257, "cpu")
    grads, state = _state(params, 0, "cpu")
    vis = _mask(257, "cpu") if masked else None
    ref_params, ref_state = _clone(params, state)
    launches = adam_ops.adam_multi.launches
    for _ in range(3):
        optim.adam_update(params, grads, state, _lrs(params), vis)
        optim.adam_update_torch(ref_params, grads, ref_state,
                                _lrs(ref_params), vis)
    _assert_equal(params, state, ref_params, ref_state)
    if masked:
        out = ~vis
        for k in params:
            assert torch.equal(params[k][out], _gaussians(257, "cpu")[k][out])
    exp = torch.randn(4, 3, 4)
    eg = 1e-3 * torch.randn(4, 3, 4)
    es = optim.ExposureAdamState(m=torch.zeros_like(exp),
                                 v=torch.zeros_like(exp))
    ref_exp, ref_es = exp.clone(), copy.deepcopy(es)
    for _ in range(3):
        optim.exposure_adam_update(exp, eg, es, 0.01)
        optim.exposure_adam_update_torch(ref_exp, eg, ref_es, 0.01)
    assert torch.equal(exp, ref_exp) and torch.equal(es.m, ref_es.m)
    assert torch.equal(es.v, ref_es.v) and es.step == ref_es.step == 3
    assert adam_ops.adam_multi.launches == launches


def _kernel_arithmetic(p, g, m, v, lr, step, eps, square_first):
    """`csrc/adam.cu::update` in numpy float32, one rounding an operation,
    the bias corrections taken from the plain version's. The square root
    is PyTorch's: its CPU sqrt is not correctly rounded (an ulp off in
    about 1 of 140 values here), while numpy's, the card's `sqrtf` and
    PyTorch's CUDA sqrt are."""
    f = np.float32
    bc1, bc2 = (float(b) for b in optim._bias_corrections(step, "cpu"))
    b1, c1 = f(optim.BETA1), f(1 - optim.BETA1)
    b2, c2 = f(optim.BETA2), f(1 - optim.BETA2)
    m = b1 * m + c1 * g
    v = b2 * v + (c2 * (g * g) if square_first else (c2 * g) * g)
    root = torch.sqrt(torch.from_numpy(v / f(bc2))).numpy()
    p = p - f(lr) * (m / f(bc1)) / (root + f(eps))
    return p, m, v


@pytest.mark.parametrize("step", (1, 2, 15001))
@pytest.mark.parametrize("square_first", (True, False))
def test_kernel_arithmetic_is_the_plain_versions(step, square_first):
    """The kernel's expression, written out with numpy's float32
    operations, is the plain version's bit for bit on the CPU: the same
    operations in the same order on the same float32 scalars (the
    Gaussians' (1 - β2)·(g·g) and the exposure's ((1 - β2)·g)·g)."""
    params = {"x": torch.randn(4099)}
    grads, state = _state(params, 3, "cpu")
    state.step = step - 1
    want = [t.numpy().copy() for t in (params["x"], grads["x"],
                                      state.m["x"], state.v["x"])]
    eps = optim.EPS if square_first else optim.EXPOSURE_EPS
    if square_first:
        optim.adam_update_torch(params, grads, state, {"x": 3e-3})
        got = (params["x"], state.m["x"], state.v["x"])
    else:
        es = optim.ExposureAdamState(m=state.m["x"], v=state.v["x"],
                                     step=step - 1)
        optim.exposure_adam_update_torch(params["x"], grads["x"], es, 3e-3)
        got = (params["x"], es.m, es.v)
    ref = _kernel_arithmetic(*want, 3e-3, step, eps, square_first)
    for a, b in zip(got, ref):
        assert np.array_equal(a.numpy(), b)


def _refusals():
    ok = lambda n=8: torch.zeros(n, 3)
    mask = torch.ones(8, dtype=torch.bool)
    return {
        "f64 parameter": ([ok().double()], [ok()], [ok()], [ok()], None),
        "f64 gradient": ([ok()], [ok().double()], [ok()], [ok()], None),
        "non-contiguous moment": ([ok()], [ok()],
                                  [torch.zeros(3, 8).t()], [ok()], None),
        "non-contiguous gradient": ([ok()], [torch.zeros(8, 6)[:, ::2]],
                                    [ok()], [ok()], None),
        "gradient of another shape": ([ok()], [torch.zeros(8, 4)], [ok()],
                                      [ok()], None),
        "moment of another shape": ([ok()], [ok()], [ok()], [ok(9)], None),
        "mask of the wrong length": ([ok()], [ok()], [ok()], [ok()],
                                     torch.ones(7, dtype=torch.bool)),
        "mask not bool": ([ok()], [ok()], [ok()], [ok()],
                          torch.ones(8, dtype=torch.uint8)),
        "mask of two dims": ([ok()], [ok()], [ok()], [ok()],
                             mask.reshape(2, 4)),
        "no tensor": ([], [], [], [], None),
        "too many tensors": ([ok()] * 49, [ok()] * 49, [ok()] * 49,
                             [ok()] * 49, None),
    }


@pytest.mark.parametrize("case", sorted(_refusals()))
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    ps, gs, ms, vs, vis = _refusals()[case]
    with pytest.raises(ValueError):
        adam_ops.plan(ps, gs, ms, vs, [1e-3] * len(ps), vis)


def test_wrapper_launches_only_on_cuda():
    """CPU tensors that the kernel would take: `adam_multi` raises (no
    fallback) and counts nothing."""
    t = [torch.zeros(8, 3) for _ in range(4)]
    launches = adam_ops.adam_multi.launches
    with pytest.raises(ValueError, match="CUDA"):
        adam_ops.adam_multi([t[0]], [t[1]], [t[2]], [t[3]], [1e-3], 1,
                            optim.BETA1, optim.BETA2, optim.EPS)
    assert adam_ops.adam_multi.launches == launches


def _block_spans(pl: adam_ops.Plan) -> list:
    """`csrc/adam.cu::adam_kernel`'s walk over a plan: per block (tensor,
    start, tail, end), its values [start, end) of that tensor, [start,
    tail) in float4s."""
    spans = []
    for b in range(pl.first[-1]):
        i = 0
        while i + 1 < len(pl.numel) and pl.first[i + 1] <= b:
            i += 1
        start = (b - pl.first[i]) * adam_ops.CHUNK
        end = min(start + adam_ops.CHUNK, pl.numel[i])
        tail = start + ((end - start) & ~3) if pl.vec[i] else start
        spans.append((i, start, tail, end))
    return spans


# lengths about a chunk and about a float4: not multiples of 4, a chunk
# and one more, empty
_C = adam_ops.CHUNK
PLAN_LENGTHS = ((1, 3, 5, 7), (_C - 1, _C, _C + 1, 2 * _C + 3),
                (0, 4, 13, _C + 5), (3 * 1001, 45 * 1001, 1001, 4 * 1001))


@pytest.mark.parametrize("offset", (0, 1, 3))
@pytest.mark.parametrize("lengths", PLAN_LENGTHS)
def test_plan_covers_every_value_once(lengths, offset):
    """The kernel's walk over the plan (`_block_spans`) covers each value
    of each tensor exactly once; float4 spans start on a multiple of 4 and
    hold whole float4s, and only where all four pointers are 16-B aligned
    (`offset` floats into a buffer: views at odd offsets, as the
    data-parallel step's all-reduced gradients are)."""
    bufs = [torch.zeros(sum(lengths) + 8 * len(lengths)) for _ in range(4)]
    groups, at = [], 0
    for n in lengths:
        groups.append([b[at + offset:at + offset + n] for b in bufs])
        at += -(-(n + 4) // 4) * 4
    pl = adam_ops.plan(*zip(*groups), [1e-3] * len(lengths))
    assert pl.vec == [int(all(t.data_ptr() % 16 == 0 for t in g))
                      for g in groups]
    assert all(v == int(offset == 0) for v, n in zip(pl.vec, lengths) if n)
    seen = [np.zeros(n, np.int64) for n in lengths]
    spans = _block_spans(pl)
    assert len(spans) == pl.first[-1] == sum(-(-n // _C) for n in lengths)
    for i, start, tail, end in spans:
        assert 0 <= start <= tail <= end <= lengths[i] and start < end
        assert start % 4 == 0 and (tail - start) % 4 == 0
        if not pl.vec[i]:
            assert tail == start
        seen[i][start:end] += 1
    for s in seen:
        assert (s == 1).all()


def test_plan_row_widths_for_the_mask():
    """Each tensor's row width is its values over its first dimension:
    the Gaussians' 3, 3, 45, 1, 3, 4; the mask's rows are the first
    dimension of every tensor."""
    params = _gaussians(11, "cpu")
    grads, state = _state(params, 0, "cpu")
    names = list(params)
    pl = adam_ops.plan([params[k] for k in names], [grads[k] for k in names],
                       [state.m[k] for k in names],
                       [state.v[k] for k in names], [1e-3] * len(names),
                       torch.ones(11, dtype=torch.bool))
    assert pl.width == [3, 3, 45, 1, 3, 4]
    assert pl.numel == [11 * w for w in pl.width]


# ---------------------------------------------------------------------------
# card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _field(dev) -> dict:
    """DNGaussian's neural field at its published widths (a 16 x 2^19 x 2
    table, the MLPs), as `init_adam(field.params())` sees it."""
    from sparse_view_3dgs_pack_tpu_torch.models.neural_field import (
        NeuralField, NeuralFieldConfig)
    field = NeuralField(NeuralFieldConfig(),
                        torch.Generator(device=dev).manual_seed(0))
    return {k: p.detach() for k, p in field.params().items()}


CARD_CASES = (("gaussians", False), ("gaussians", True),
              ("gaussians_views", False), ("field", False),
              ("exposure", False))


@pytest.mark.cuda
@pytest.mark.parametrize("first_step", (1, 15001))
@pytest.mark.parametrize("groups,masked", CARD_CASES)
def test_cuda_kernel_matches_plain_bitwise(groups, masked, first_step):
    """Three consecutive steps from `first_step` (1, 2, 3 and 15001, 15002,
    15003): p, m and v of the kernel's path `torch.equal` to the plain
    version's on the card. Groups: the Gaussians' six (100,003 rows, so
    float4 tails), with and without a visibility mask; the same with
    gradients that are views at odd offsets of one flat buffer (the
    data-parallel step's); the neural field; the exposure (eps 1e-8)."""
    dev = _card()
    lrs = None
    if groups == "exposure":
        params = {"exposure": torch.randn(9, 3, 4, device=dev)}
    elif groups == "field":
        params = _field(dev)
    else:
        params = _gaussians(100_003, dev)
    grads, state = _state(params, 5, dev)
    if groups == "gaussians_views":
        flat = torch.cat([g.reshape(-1) for g in grads.values()])
        flat = torch.cat([flat.new_zeros(1), flat])
        at = 1
        for k, g in grads.items():
            grads[k] = flat[at:at + g.numel()].view(g.shape)
            at += g.numel()
    state.step = first_step - 1
    lrs = _lrs(params)
    vis = _mask(100_003, dev) if masked else None
    ref_params, ref_state = _clone(params, state)
    for _ in range(3):
        if groups == "exposure":
            es = optim.ExposureAdamState(state.m["exposure"],
                                         state.v["exposure"], state.step)
            optim.exposure_adam_update(params["exposure"],
                                       grads["exposure"], es, 0.01)
            state.m["exposure"], state.v["exposure"] = es.m, es.v
            state.step = es.step
            rs = optim.ExposureAdamState(ref_state.m["exposure"],
                                         ref_state.v["exposure"],
                                         ref_state.step)
            optim.exposure_adam_update_torch(ref_params["exposure"],
                                             grads["exposure"], rs, 0.01)
            ref_state.m["exposure"], ref_state.v["exposure"] = rs.m, rs.v
            ref_state.step = rs.step
        else:
            optim.adam_update(params, grads, state, lrs, vis)
            optim.adam_update_torch(ref_params, grads, ref_state, lrs, vis)
        torch.cuda.synchronize()
        _assert_equal(params, state, ref_params, ref_state)


@pytest.mark.cuda
def test_cuda_one_launch_per_call():
    """`adam_update` over the six Gaussian groups is one launch, with a
    mask too; `exposure_adam_update` one."""
    dev = _card()
    params = _gaussians(1000, dev)
    grads, state = _state(params, 0, dev)
    launches = adam_ops.adam_multi.launches
    optim.adam_update(params, grads, state, _lrs(params))
    assert adam_ops.adam_multi.launches == launches + 1
    optim.adam_update(params, grads, state, _lrs(params), _mask(1000, dev))
    assert adam_ops.adam_multi.launches == launches + 2
    exp = torch.zeros(3, 3, 4, device=dev)
    es = optim.ExposureAdamState(torch.zeros_like(exp), torch.zeros_like(exp))
    optim.exposure_adam_update(exp, torch.ones_like(exp), es, 0.01)
    torch.cuda.synchronize()
    assert adam_ops.adam_multi.launches == launches + 3
