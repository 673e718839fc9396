"""``python3 -m portbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``: one run of one cell of ``BENCHMARK.json``."""

import time

T_START = time.perf_counter()  # before torch and the port are imported

if __name__ == "__main__":
    import sys

    from portbench.run import main

    sys.exit(main(sys.argv[1:], T_START))
