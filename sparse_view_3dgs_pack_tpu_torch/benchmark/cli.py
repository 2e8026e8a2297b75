"""`gs_benchmark_torch` console entry point (reference
`fs3dgs_benchmark/cli.py:5-24`; the port's copy of
`sparse_view_3dgs_pack_tpu/benchmark/cli.py`):

    python -m sparse_view_3dgs_pack_tpu_torch.benchmark.cli runall \
        [-c config.yaml] [--dry] [--out_dir D --resume]

Without `-c` it reads the port's `benchmark/config.yaml`.
"""

from __future__ import annotations

import sys


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if argv and argv[0] in ("runall", "run"):
        argv = argv[1:]
    elif argv and argv[0] in ("-h", "--help"):
        print("usage: gs_benchmark_torch runall [-c config.yaml] [--dry] "
              "[--python P]")
        return 0
    from .benchmark import main as bench_main
    bench_main(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
