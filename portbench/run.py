#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the CUDA devices of this machine.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout. It exits non-zero, and prints no result,
when the cell asks for more CUDA devices than there are. Its last line on
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``).
"""

import os
import sys
import time

START = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

if __name__ == "__main__":
    # kernel caches at fixed places inside the checkout, so that only a
    # checkout's first run of a cell builds
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv_compute")):
        os.environ[var] = os.path.join(ROOT, ".portbench_cache", sub)
    sys.path.insert(0, ROOT)
    from portbench import harness

    sys.exit(harness.main(sys.argv[1:], START))
