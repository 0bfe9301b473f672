"""The strided-load probes (K4) on the JAX script's input.

    python -m panoptic_forecasting_tpu_torch.scripts.prof_strided_load [--device cpu]

Counterpart of the JAX package's ``scripts/prof_strided_load.py``: runs
each probe of ``kernels/strided_load.py`` on ``arange(8·2048)`` as an
(8, 2048) float32 matrix (even lanes for the first two probes, odd lanes
for ``dyn_row_strided``), holds the result against numpy's slice and
prints ``<name> OK`` or ``<name> WRONG``, then ``DONE``. A kernel that
fails to build or launch ends the run with its exception; a WRONG probe
makes the exit code 1.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.strided_load import dyn_row_strided, strided_ref, strided_val

ROWS, COLS = 8, 2048
CASES = (("strided_ref", strided_ref, 0), ("strided_val", strided_val, 0),
         ("dyn_row_strided", dyn_row_strided, 1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    x = torch.arange(ROWS * COLS, dtype=torch.float32, device=dev)
    x = x.reshape(ROWS, COLS)
    x_np = x.cpu().numpy()
    wrong = 0
    for name, probe, start in CASES:
        out = probe(x, start)
        ok = np.array_equal(out.cpu().numpy(), x_np[:, start::2])
        wrong += not ok
        print(name, "OK" if ok else "WRONG", flush=True)
    print("DONE", flush=True)
    return 1 if wrong else 0


if __name__ == "__main__":
    sys.exit(main())
