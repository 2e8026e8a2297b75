"""Nothing a benchmark run loads is JAX or the JAX package: after each
cell's path runs at a tiny size on the CPU in a fresh interpreter, no
module's top-level name (the part before the first dot) is `jax`,
`jaxlib`, `flax` or `sparse_view_3dgs_pack_tpu`, compared whole (the
port's own name begins with the JAX package's)."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import gsbench
from gsbench import run
from gsbench.tests.tiny import WORKLOADS

REPO = os.path.dirname(os.path.dirname(gsbench.__file__))

_SCRIPT = r"""
import json, sys, time, torch
torch.set_num_threads(2)
from gsbench import run
from gsbench.tests.tiny import tiny
res = run.run_cell(tiny(sys.argv[1]), 5, 0.3, False, torch.device("cpu"),
                   time.perf_counter())
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"forbidden": run.forbidden_modules(), "tops": tops,
                  "correct": res["correct"]}))
"""


@pytest.mark.parametrize("workload", WORKLOADS)
def test_a_run_loads_no_jax(workload):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _SCRIPT, workload],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True
    assert out["forbidden"] == []
    assert "sparse_view_3dgs_pack_tpu_torch" in out["tops"]
    for name in ("jax", "jaxlib", "flax", "sparse_view_3dgs_pack_tpu"):
        assert name not in out["tops"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    for name in ("sparse_view_3dgs_pack_tpu_torch.ops", "jax_free_thing",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in run.forbidden_modules()
                if m.startswith(("sparse_view_3dgs_pack_tpu_torch",
                                 "jax_free", "flaxen"))]
    monkeypatch.setitem(sys.modules, "sparse_view_3dgs_pack_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert {"sparse_view_3dgs_pack_tpu.ops", "jaxlib.xla_client"} <= set(
        run.forbidden_modules())


def test_no_harness_source_imports_jax():
    here = os.path.dirname(gsbench.__file__)
    for root, _, files in os.walk(here):
        if os.path.basename(root) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                text = open(os.path.join(root, f)).read()
                for bad in ("import jax", "from jax", "import flax",
                            "from sparse_view_3dgs_pack_tpu ",
                            "from sparse_view_3dgs_pack_tpu.",
                            "import sparse_view_3dgs_pack_tpu\n",
                            "import sparse_view_3dgs_pack_tpu."):
                    assert bad not in text, (f, bad)
