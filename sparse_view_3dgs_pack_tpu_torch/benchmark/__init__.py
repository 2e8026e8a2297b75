"""The `gs_benchmark` harness of the port: train, render and score several
methods side by side through their CLIs (`cli.py`, `benchmark.py`), and
tabulate the results (`bench_tables.py`)."""
