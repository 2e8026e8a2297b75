"""Debug snapshot: what the reference rasterizer's `debug` flag does, for
the port.

Counterpart of `sparse_view_3dgs_pack_tpu/train/debug.py`. The reference,
with `pipe.debug` set (armed from iteration N by `--debug_from N`), wraps
each kernel launch in CHECK_CUDA and on an error pickles the inputs to
`snapshot_fw/bw.dump` for an offline replay. The port's kernel wrappers
already raise on a launch error; the failure left to catch is a
non-finite loss. When armed, the loop reads each step's loss on the host
(one sync per step) and, on NaN or Inf, writes the step's replayable
input — parameters, the alive mask, the densification statistics and the
step context (iteration, camera index, active SH degree) — to
`<model_path>/snapshot_fw.npz` with the JAX package's keys, then raises.
`load_snapshot` reads a snapshot of either package.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np

from ..models.gaussians import STAT_NAMES


def debug_active(pipe, it: int) -> bool:
    """Armed by `pipe.debug` outright or from `--debug_from N` onward."""
    if getattr(pipe, "debug", False):
        return True
    debug_from = int(getattr(pipe, "debug_from", -1))
    return 0 <= debug_from <= it


def dump_snapshot(path: str, model, meta: dict) -> str:
    """Parameters, alive mask, exposure, densification statistics and the
    JSON-encodable `meta` to an npz."""
    arrays = {f"params.{k}": v.detach().cpu().numpy()
              for k, v in model.params().items()}
    n = model.num_points
    arrays["alive"] = np.ones(n, bool)
    arrays["n_alive"] = np.asarray(n, np.int32)
    arrays["exposure"] = model.exposure.detach().cpu().numpy()
    for k in STAT_NAMES:
        arrays[k] = getattr(model, k).detach().cpu().numpy()
    arrays["meta"] = np.frombuffer(
        json.dumps(meta, default=float).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def load_snapshot(path: str):
    """→ (params dict, arrays dict incl. alive/stats, meta dict)."""
    with np.load(path) as z:
        params = {k[len("params."):]: z[k] for k in z.files
                  if k.startswith("params.")}
        arrays = {k: z[k] for k in z.files
                  if not k.startswith("params.") and k != "meta"}
        meta = json.loads(bytes(z["meta"]).decode())
    return params, arrays, meta


def check_step(pipe, it: int, metrics, model, model_path: str,
               context: dict | None = None, write: bool = True) -> None:
    """When debugging is armed, read the step's loss; on a non-finite value
    dump the snapshot (unless `write` is False: a data-parallel replica
    other than rank 0) and raise. Unarmed, it returns at once and reads
    nothing from the device."""
    if not debug_active(pipe, it):
        return
    loss = float(metrics["loss"])
    if math.isfinite(loss):
        return
    path = os.path.join(model_path or ".", "snapshot_fw.npz")
    meta = {"iteration": it, "loss": loss}
    meta.update(context or {})
    if write:
        dump_snapshot(path, model, meta)
    raise RuntimeError(
        f"[debug] non-finite loss ({loss}) at iteration {it}; step input "
        f"snapshot written to {path} — load with "
        f"sparse_view_3dgs_pack_tpu_torch.train.debug.load_snapshot for "
        f"offline replay")
