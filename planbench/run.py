"""Run one cell of the benchmark once; see ``README.md`` beside this file.

    python3 planbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>
"""
import os
import sys
import time

# one process, few threads: the host's numeric libraries run one thread
# each, so the service's two threads (front end, solve lane) are what runs
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ.setdefault(_var, "1")
# a library that would load JAX by itself is kept from doing so
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from pbench import runstate  # noqa: E402

if __name__ == "__main__":
    from pbench import cli
    # set-up is timed from the process's start
    sys.exit(cli.main(t_start=time.perf_counter() - runstate.process_age_s()))
