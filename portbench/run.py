#!/usr/bin/env python3
"""Run one cell of the benchmark of ``panoptic_forecasting_tpu_torch``
(the PyTorch + CUDA port) once, on the machine's CUDA device:

    python3 portbench/run.py --workload forecast_short.scene8 --seed 7 \\
        --seconds 20 --trace 0

from the root of a checkout. ``--trace 0`` prints the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics read from a profiler trace
of a short window. The last line of standard output is the result (JSON);
the numbers the check compared, each beside its limit, are the last
lines of standard error. Without enough CUDA devices it exits 2 and
prints no result.

Build outputs stay inside the checkout: the port's nvcc libraries in its
own ``_build/`` directory, and the caches of Triton and of torch's
extension builds (none of which the port uses yet) under
``portbench/_cache/``. ``USE_FLAX=0`` keeps a library from loading JAX's
flax by itself: a run that has loaded JAX fails.

Before torch is imported the run puts its OpenMP threads, which carry
the program's host copies, to sleep between parallel regions
(``OMP_WAIT_POLICY=PASSIVE``). Spinning, they took four of an 8-CPU
machine's cores through the window and the frames slowed in stretches
(PERF.md §2). The port's own entry points do not set this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache = os.path.join(HERE, "_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["OMP_WAIT_POLICY"] = "PASSIVE"
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    from portbench.harness.cell import main as run_cell

    return run_cell(args, T_START)


if __name__ == "__main__":
    sys.exit(main())
