"""The DNGaussian cell (`dng_llff3.train`) at a tiny cut on the CPU: 2,000
Gaussians, 64×48, 3 views, the field at its published widths (16 levels
of 2 features, a 2^19 table, both MLPs 64 wide), through the port's plain
path. The reference's field against the port's; a whole run `correct`
with its line; each planted fault failing its check; no JAX loaded; each
new reader on a synthetic context; the work counts against a hand count.
"""

from __future__ import annotations

import copy
import json
import os
import subprocess
import sys
import time

import pytest
import torch

import gsbench
from gsbench import cell as cell_mod
from gsbench import run
from gsbench.reference import dng as ref_dng
from gsbench.reference.render import Work
from gsbench.tests.test_bench_trace import EVENTS
from gsbench import trace as trace_mod
from gsbench.work import dng as work_dng
from gsbench.work.peaks import PEAK_BYTES, PEAK_F32_OPS

CPU = torch.device("cpu")
SEED = 2 ** 31 + 12345       # larger than 32 signed bits hold
WORKLOAD = "dng_llff3.train"
REPO = os.path.dirname(os.path.dirname(gsbench.__file__))
METRICS = ("field_ms.dng", "field_roofline.dng", "depth_losses_ms.dng",
           "backward_ms.dng", "device_idle.dng", "dng_mfu")


def tiny(n: int = 2000, width: int = 64, height: int = 48):
    """The cell cut for the CPU: the frame and the Gaussians made small,
    fewer set-up iterations; the field, the views and the limits its
    own."""
    c = cell_mod.load(WORKLOAD)
    cfg = copy.deepcopy(c.cfg)
    cfg.update(n_gaussians=n, width=width, height=height,
               focal_px=cfg["focal_px"] * width / cfg["width"])
    t = dict(c.traffic)
    t.update(checked_steps=2, warm_steps=1, traced_steps=2)
    return c._replace(cfg=cfg, traffic=t)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_reference_field_matches_the_port():
    """The reference's field and the port's `gaussian_outputs` on seeded
    random weights (the table spread to ± 0.3 so every level counts) and
    500 points inside the bound: the colour and opacity to 1e-6 (the same
    float32 operations, summed in the same order), every gradient to 1e-5
    of its leaf's largest (autograd sums the table's scatter-add and the
    MLPs' products in orders of its own)."""
    from sparse_view_3dgs_pack_tpu_torch.models import neural_field as nf
    cfg = tiny().cfg
    f = cfg["field"]
    g = torch.Generator().manual_seed(3)
    w = ref_dng.field_values(f, g)
    xyz = (2 * torch.rand((500, 3), generator=g) - 1) * 0.95
    opacity = torch.randn((500, 1), generator=g)
    cam = torch.tensor([0.3, -2.1, 0.4])
    cot = torch.randn((500, 4), generator=g)

    port = nf.NeuralField(generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        for k, p in port.params().items():
            p.copy_(w[k])
    pts = [xyz.clone().requires_grad_(True),
           opacity.clone().requires_grad_(True)]
    c1, o1 = nf.gaussian_outputs(port, *pts, cam)
    (torch.cat([c1, o1[:, None]], 1) * cot).sum().backward()
    got = {**{k: p.grad for k, p in port.params().items()},
           "xyz": pts[0].grad, "opacity": pts[1].grad}

    leaves = {k: v.clone().requires_grad_(True) for k, v in w.items()}
    pts = [xyz.clone().requires_grad_(True),
           opacity.clone().requires_grad_(True)]
    c2, o2 = ref_dng.field_outputs(leaves, f, 1.0, *pts, cam)
    (torch.cat([c2, o2[:, None]], 1) * cot).sum().backward()
    want = {**{k: p.grad for k, p in leaves.items()}, "xyz": pts[0].grad,
            "opacity": pts[1].grad}

    assert torch.allclose(c1, c2, rtol=1e-6, atol=1e-7)
    assert torch.allclose(o1, o2, rtol=1e-6, atol=1e-7)
    assert float(o1.detach().std()) > 1e-3
    assert float(c1.detach().std()) > 1e-3
    for k, gw in want.items():
        scale = float(gw.abs().max())
        assert scale > 0 or k == "coord_center", k
        assert float((got[k] - gw).abs().max()) <= 1e-5 * scale, k


def test_encode_levels_dense_and_hashed():
    """The published grid has dense levels ((r + 1)³ ≤ 2^19: r ≤ 79) and
    hashed ones, and its resolutions grow from 16 to 512."""
    f = cell_mod.load(WORKLOAD).cfg["field"]
    res = ref_dng.resolutions(f)
    assert res[0] == 16 and res[-1] == 512 and len(res) == 16
    dense = [(r + 1) ** 3 <= 1 << f["log2_hashmap_size"] for r in res]
    assert any(dense) and not all(dense)


def test_cell_runs_correct_with_its_line():
    cell = tiny()
    res = run.run_cell(cell, SEED, 0.5, False, CPU, time.perf_counter())
    assert list(res) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert res["correct"] is True, res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"train_it_per_s", "setup_s"}
    for m in cell.end_to_end:
        v = res["metrics"][m["name"]]
        assert v["unit"] == m["unit"] and v["value"] > 0
    assert set(res["checks"]) == {"loss_gap", "grad_gap", "delta_gap"}
    json.loads(json.dumps(res))


@pytest.mark.parametrize("fault", ("half_batch", "state_unchanged",
                                   "coarse_grid"))
def test_fault_in_the_timed_path_is_not_correct(fault):
    res = run.run_cell(tiny(), SEED, 0.5, False, CPU, time.perf_counter(),
                       faults=(fault,))
    assert res["correct"] is False, res["checks"]


_SCRIPT = r"""
import json, sys, time, torch
torch.set_num_threads(2)
from gsbench import run
from gsbench.tests.test_bench_dng import tiny
res = run.run_cell(tiny(), 5, 0.3, False, torch.device("cpu"),
                   time.perf_counter())
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"forbidden": run.forbidden_modules(), "tops": tops,
                  "correct": res["correct"]}))
"""


def test_a_run_loads_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["forbidden"] == []
    assert "sparse_view_3dgs_pack_tpu_torch" in out["tops"]
    for name in ("jax", "jaxlib", "flax", "sparse_view_3dgs_pack_tpu"):
        assert name not in out["tops"]


def _dng_trace():
    """The hand-made trace of `test_bench_trace.py`, its stages those of
    a DNG iteration: `render/projection` as `step/field`, and a
    `step/depth_losses` and a `step/backward` with K3 in it."""
    tr = trace_mod.read(EVENTS, "gsbench/call")
    stages = dict(tr.stages)
    stages["step/field"] = stages.pop("render/projection")
    stages["step/depth_losses"] = [1e-4, 5e-5]
    stages["step/backward"] = [3.4e-4, 2e-4]
    kernels = dict(tr.stage_kernels)
    kernels["step/field"] = kernels.pop("render/projection")
    kernels["step/backward"] = {"void raster_bwd_kernel<3, 128>()": 5e-5,
                                "void at::elementwise()": 1.5e-4}
    return tr._replace(stages=stages, stage_kernels=kernels)


def _ctx(kind="dng"):
    cfg = cell_mod.load(WORKLOAD).cfg
    work = [(Work(1000, 50), 400, 12), (Work(1200, 40), 420, 12),
            (Work(1100, 50), 410, 12)] * 2
    return {"kind": kind, "trace": _dng_trace(), "call_s": 5e-3,
            "work": work, "passes": ["hard", "soft", "photo"], "P": 3000,
            "n_values": 3000 * 59, "field": cfg["field"], "width": 64,
            "height": 48, "C": 3}


def test_new_readers_read_a_dng_context_and_nothing_else():
    ctx = _ctx()
    tr = ctx["trace"]
    got = {m: run._reader(m)(ctx) for m in METRICS}
    for m, v in got.items():
        assert isinstance(v, float) and v > 0, (m, v)
    assert got["field_ms.dng"] == pytest.approx(
        1e3 * tr.stages["step/field"][1] / tr.calls)
    evals = 3 * tr.calls
    least = evals * work_dng.field_bound(3000, ctx["field"])[0]
    assert got["field_roofline.dng"] == pytest.approx(
        100 * least / tr.stages["step/field"][1])
    assert got["depth_losses_ms.dng"] == pytest.approx(1e3 * 5e-5 / tr.calls)
    assert got["backward_ms.dng"] == pytest.approx(1e3 * 1.5e-4 / tr.calls)
    assert got["device_idle.dng"] == pytest.approx(
        100 * (1 - tr.busy_s / tr.calls / 5e-3))
    for m in METRICS:
        assert run._reader(m)(_ctx("train")) is None, m
        assert run._reader(m)({"kind": "dng", "trace": None}) is None, m
    # no existing reader answers for a DNG context
    bench = json.loads((cell_mod.ROOT / "BENCHMARK.json").read_text())
    for m in bench["per_layer"]:
        if m["name"] not in METRICS:
            assert run._reader(m["name"])(ctx) is None, m["name"]


def test_field_counts_against_a_hand_count():
    """One level of 2 features, a 4-entry table, sigma 2 → 3 → 1 + 2,
    colour (SH 1 + 2) → 2 → 3."""
    f = dict(num_levels=1, level_dim=2, base_resolution=2,
             log2_hashmap_size=2, desired_resolution=2, hidden_dim=3,
             geo_feat_dim=2, num_layers_sigma=2, hidden_dim_color=2,
             num_layers_color=2, sh_degree=1)
    # encode: input 12; the level's position, fraction, complements 9 and
    # 8 corners × (weight 2 + 2 features × 2) = 48
    assert work_dng.encode_ops(f) == 12 + 9 + 48
    # sigma 2→3→3: 2·2·3 + 3 + 2·3·3 + 3 = 36; colour 3→2→3: 2·3·2 + 2 +
    # 2·2·3 + 3 = 29
    assert work_dng.mlp_ops(work_dng.mlp_dims(f)[0]) == 36
    assert work_dng.mlp_ops(work_dng.mlp_dims(f)[1]) == 29
    assert work_dng.field_fwd_ops(f) == 69 + 36 + 29 + 12 + 36 + 9 + 3
    # bytes: 8 corners × 2 features, 4 in and 4 out, 4 bytes each
    assert work_dng.field_bytes(f) == 4 * (16 + 8)
    # values: the table 4 × 2, sigma 2·3 + 3 + 3·3 + 3, colour 3·2 + 2 +
    # 2·3 + 3, the centre 3
    assert work_dng.field_values(f) == 8 + 21 + 17 + 3
    t, by = work_dng.field_bound(1000, f)
    assert t == pytest.approx(max(1000 * 96 / PEAK_BYTES,
                                  1000 * 194 / PEAK_F32_OPS))
    assert by == "bytes"


def test_published_field_counts():
    """The published field: 32,476 operations and 1,056 bytes a Gaussian
    and evaluation (≈ 31.5k of them in the MLPs); at 300k Gaussians one
    evaluation is bound by operations at ≈ 0.145 ms."""
    f = cell_mod.load(WORKLOAD).cfg["field"]
    sigma, color = work_dng.mlp_dims(f)
    assert (sigma, color) == ([32, 64, 64, 65], [80, 64, 3])
    assert work_dng.mlp_ops(sigma) + work_dng.mlp_ops(color) == 31492
    assert work_dng.field_fwd_ops(f) == 32476
    assert work_dng.field_bytes(f) == 1056
    assert work_dng.field_values(f) == 16 * 2 ** 19 * 2 + 15876 + 3
    t, by = work_dng.field_bound(300_000, f)
    assert by == "operations" and t == pytest.approx(1.454e-4, rel=1e-3)


def test_iteration_counts_add_up():
    """An iteration's operations: the three passes' projection, blend,
    losses and Adam, and the field's three evaluations each way."""
    f = cell_mod.load(WORKLOAD).cfg["field"]
    w = (Work(1000, 50), 400, 12)
    passes = ["hard", "soft", "photo"]
    total = work_dng.iteration_ops(10, 590, 100, 8, 6, f, [w] * 3, passes)
    no_soft = work_dng.iteration_ops(10, 590, 100, 8, 6, f, [w] * 2,
                                     ["hard", "photo"])
    field = 3 * work_dng.field_fwd_ops(f)
    assert total - no_soft == (
        10 * (work_dng.projection_fwd_ops() + 45)
        + work_dng.blend_ops(3, 1000, 50)
        + 1000 * work_dng.bwd_ops_per_contrib(3) + 400 * 11 + 590 * 14
        + 48 * work_dng.depth_loss_ops_per_pixel(True)
        + 10 * field + 100 * 14)
    assert work_dng.projection_bwd_ops(True) < work_dng.projection_bwd_ops(
        False)
