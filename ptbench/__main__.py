"""`python -m ptbench --workload NAME --seed N --seconds S --trace 0|1`:
one run of one benchmark cell (ptbench/harness.py)."""
import time

T0 = time.perf_counter()   # the set-up time counts from here

import sys  # noqa: E402

from ptbench.harness import main  # noqa: E402

sys.exit(main(t0=T0))
