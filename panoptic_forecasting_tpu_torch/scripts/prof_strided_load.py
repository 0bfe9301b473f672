"""The strided-load probes (K4) on the JAX script's input, or a larger one.

    python -m panoptic_forecasting_tpu_torch.scripts.prof_strided_load [--device cpu]
        [--rows R --cols C]

Counterpart of the JAX package's ``scripts/prof_strided_load.py``: runs
each probe of ``kernels/strided_load.py`` on ``arange(R·C)`` as an (R, C)
float32 matrix (by default the script's (8, 2048); even lanes for the
first two probes, odd lanes for ``dyn_row_strided``), holds the result
against numpy's slice and prints ``<name> OK`` or ``<name> WRONG``. On
the GPU it then prints the CUDA-event ms of each probe, of its library
call (``x[:, start::2].contiguous()``) and of the launch floor (a
one-element ``zero_()``), and the byte bound at 3.35 TB/s; a CPU run
prints no time. Last ``DONE``. A kernel that fails to build or launch
ends the run with its exception; a WRONG probe makes the exit code 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.strided_load import dyn_row_strided, strided_ref, strided_val
from ._timing import time_ms

ROWS, COLS = 8, 2048
LARGE = (8192, 8192)  # where the bytes, not the launch, bound a probe
HBM_BYTES_PER_S = 3.35e12  # H100 SXM
CASES = (("strided_ref", strided_ref, 0), ("strided_val", strided_val, 0),
         ("dyn_row_strided", dyn_row_strided, 1))


def bound_ms(rows: int, cols: int) -> float:
    """Least ms to read (R, C) and write (R, C/2) float32 at HBM rate."""
    return (rows * cols + rows * (cols // 2)) * 4 / HBM_BYTES_PER_S * 1e3


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--rows", type=int, default=ROWS)
    ap.add_argument("--cols", type=int, default=COLS)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    x = torch.arange(args.rows * args.cols, dtype=torch.float32, device=dev)
    x = x.reshape(args.rows, args.cols)
    x_np = x.cpu().numpy()
    wrong = 0
    for name, probe, start in CASES:
        out = probe(x, start)
        ok = np.array_equal(out.cpu().numpy(), x_np[:, start::2])
        wrong += not ok
        print(name, "OK" if ok else "WRONG", flush=True)
    if dev.type == "cuda":
        one = torch.zeros(1, device=dev)
        for name, probe, start in CASES:
            print(f"{name} {time_ms(lambda: probe(x, start), 100, 10):.4f} ms"
                  f", library {time_ms(lambda: x[:, start::2].contiguous(), 100, 10):.4f}"
                  " ms", flush=True)
        print(f"launch floor {time_ms(one.zero_, 100, 10):.4f} ms, bound "
              f"{bound_ms(args.rows, args.cols):.5f} ms", flush=True)
    print("DONE", flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
