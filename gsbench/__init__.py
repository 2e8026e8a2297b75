"""gsbench: the benchmark of the PyTorch / CUDA port
(`sparse_view_3dgs_pack_tpu_torch`) on one NVIDIA H100.

Run from the root of a checkout: `python3 -m gsbench --workload <name>
--seed <n> --seconds <s> --trace <0|1>` (`run.py`). The cells are listed
in `BENCHMARK.json`; each is data found by name:

  configs/<config>.json      a configuration as it is run: method, frame,
                             views, Gaussians, the step's settings, the
                             scene generator's parameters, what was assumed
  traffic/<mix>.json         a traffic mix: the entry it drives
                             (`entries/<entry>.py`) and its parameters
  limits/<workload>.json     each compared number's limit
  metrics/<metric>.py        one reader per per-layer metric
  work/                      peaks and the counts of operations and bytes
  reference/                 the plain reference that decides `correct`
  scene.py                   the inputs, made from the seed on the card
  program.py                 the port's objects, built from those inputs
  trace.py                   the traced run's reading of the profiler
  calibrate.py               the readings the limits are set from
  tests/                     CPU tests (`python -m pytest gsbench/tests`),
                             and the card's (`-m cuda`)

Imports neither jax nor the JAX package; a run refuses to print a result
when either is loaded.
"""
