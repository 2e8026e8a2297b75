"""`python3 -m gsbench --workload <name> --seed <n> --seconds <s> --trace
<0|1>`: one run of one cell (`gsbench/run.py`)."""

import time

T0 = time.perf_counter()   # set-up is timed from here, before any import

if __name__ == "__main__":
    from gsbench.run import main
    main(t0=T0)
