"""The benchmark of ``optimaltextures_tpu_torch`` on NVIDIA GPUs.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout: one run of the cell that BENCHMARK.json
names, its result as one JSON line, the last line of standard output. It
exits with another code than 0, and prints no result, without the CUDA
devices the cell asks for, or where JAX or the JAX package was loaded."""

import time

WALL0 = time.time()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

if __name__ == "__main__":
    from benchlib import cell

    sys.exit(cell.main(sys.argv[1:], WALL0))
