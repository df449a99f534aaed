"""python -m portbench --workload NAME --seed N --seconds S --trace 0|1"""

import time

T0 = time.perf_counter()    # the process's start, for setup_s

if __name__ == "__main__":
    import sys

    from portbench.harness import main
    sys.exit(main(t0=T0))
