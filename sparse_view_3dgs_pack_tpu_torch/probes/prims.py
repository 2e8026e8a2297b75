"""Primitive probes P1-P4 on the inputs of `scripts/tpu_prims.py`:

    python -m sparse_view_3dgs_pack_tpu_torch.probes.prims [--device cuda]

P1 pixel coordinates of a 4x2 grid of 16x16 tiles, P2 the row-wise
inclusive scan of a (256, 256) array in [-0.1, 0], P3 copies of
data[:, s:s+256] from 8 starts known only on the device, P4 alpha of 256
pairs at the 256 pixels of a tile. Each is held to a numpy expectation with
the script's bar (P1, P3 exact; P2 1e-4; P4 1e-5) and prints one
"OK/FAILED, maxerr" line; the exit code is 1 if any failed.
"""

from __future__ import annotations

import sys
from argparse import ArgumentParser

import numpy as np
import torch

from ..device import resolve_device
from ..ops import probes

COPY_COLS = 1 << 13
COPY_STARTS = (0, 256, 384, 512, 1024, 2048, 4096, 7680)


def scan_input() -> np.ndarray:
    """(256, 256) uniform in [-0.1, 0) (the script's `PRNGKey(0)` draw)."""
    return np.random.default_rng(0).uniform(
        -0.1, 0.0, (probes.PIX, probes.CHUNK)).astype(np.float32)


def copy_input():
    """(16, 8192) data (`arange % 977`) and the 8 starts of the script."""
    data = (np.arange(16 * COPY_COLS, dtype=np.float32)
            .reshape(16, COPY_COLS) % 977).astype(np.float32)
    return data, np.asarray(COPY_STARTS, np.int32)


def alpha_input() -> np.ndarray:
    """(16, 256): rows mx, my, conic a, b, c, opacity, the rest zero."""
    rng = np.random.default_rng(0)
    n = probes.CHUNK
    d = np.zeros((16, n), np.float32)
    d[0] = rng.uniform(0, 16, n)
    d[1] = rng.uniform(0, 16, n)
    d[2] = rng.uniform(0.05, 0.5, n)
    d[3] = rng.uniform(-0.05, 0.05, n)
    d[4] = rng.uniform(0.05, 0.5, n)
    d[5] = rng.uniform(0.3, 0.95, n)
    return d


def _maxerr(got: torch.Tensor, want: np.ndarray) -> float:
    return float(np.abs(got.cpu().numpy() - want).max())


def run(device: torch.device) -> list:
    """[(name, maxerr, bar)] of the four probes on `device`."""
    p = np.arange(probes.PIX)
    want = np.stack([
        np.stack([(t % 4) * 16 + p % 16, (t // 4) * 16 + p // 16], -1)
        for t in range(8)]).astype(np.float32)
    out = [("iota", _maxerr(probes.tile_coords(8, 4, device), want), 0.0)]

    x = scan_input()
    got = probes.row_cumsum(torch.as_tensor(x, device=device))
    out.append(("cumsum", _maxerr(got, np.cumsum(x, axis=1)), 1e-4))

    data, starts = copy_input()
    got = probes.offset_copy(torch.as_tensor(data, device=device),
                             torch.as_tensor(starts, device=device))
    want = np.stack([data[:, s:s + probes.CHUNK] for s in starts])
    out.append(("copy", _maxerr(got, want), 0.0))

    d = alpha_input()
    px = (p % 16).astype(np.float32)[:, None]
    py = (p // 16).astype(np.float32)[:, None]
    dx, dy = px - d[0][None], py - d[1][None]
    power = -0.5 * (d[2][None] * dx * dx + d[4][None] * dy * dy) \
        - d[3][None] * dx * dy
    want = np.minimum(0.99, d[5][None] * np.exp(np.minimum(power, 0)))
    got = probes.pair_alpha(torch.as_tensor(d, device=device))
    out.append(("alpha", _maxerr(got, want), 1e-5))
    return out


def main(argv=None) -> int:
    parser = ArgumentParser(description="primitive probes P1-P4")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the probe kernels) or cpu (their plain "
                             "PyTorch versions); never falls back")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    results = run(device)
    for i, (name, err, bar) in enumerate(results, 1):
        ok = err <= bar
        print(f"probe{i} {name}: {'OK' if ok else 'FAILED'}, maxerr {err:.3g}"
              f" (bar {bar:g})", flush=True)
    return 0 if all(err <= bar for _, err, bar in results) else 1


if __name__ == "__main__":
    sys.exit(main())
