#!/usr/bin/env python3
"""Readings that set the limits of a cell's check (PERF.md §2), at the
cell's own size, in one process:

    python3 portbench/control.py --workload forecast_short.scene8 \\
        --seeds 11,12,13 --control-seeds 11,12,13 --faults altered,half_batch \\
        --fault-seeds 11,12,13 --seconds 2

For each of ``--seeds`` a run of the cell (short window, ``--seconds``)
prints the program's numbers; for each of ``--control-seeds`` the
control (the reference computed in TF32, the precision below the
configuration's float32, in the program's place) prints its numbers
against the float32 reference; for each fault of the cell's runner
(``FAULTS`` of ``portbench/harness/<kind>.py``, with the data faults of
``portbench/harness/faults.py`` where the traffic is ``files``) and each of
``--fault-seeds`` a run with the fault planted prints its numbers. One
JSON line each. ``--emulate`` rounds the control's operands to TF32 by hand
(the CPU has no TF32).
The benchmark's runs never run this.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--emulate", action="store_true")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import torch

    from portbench.harness import cell
    from portbench.harness.faults import DATA_FAULTS

    ints = lambda s: [int(x) for x in s.split(",") if x]  # noqa: E731
    if torch.cuda.is_available():
        from panoptic_forecasting_tpu_torch.cli.common import config_device
        dev = config_device({})
    else:
        dev = torch.device("cpu")
    spec = cell.resolve(args.workload)
    runner = cell.runner(spec["config"]["kind"])
    faults = dict(runner.FAULTS, **(DATA_FAULTS if spec["traffic"]["kind"] == "files" else {}))

    def numbers(line):
        return {r["name"]: r["value"] for r in line["checks"]}

    for seed in ints(args.seeds):
        line = cell.execute(args.workload, seed, args.seconds, False, dev, time.perf_counter())
        print(json.dumps({"what": "program", "seed": seed, "correct": line["correct"],
                          "numbers": numbers(line), "metrics": line["metrics"]}), flush=True)
    for seed in ints(args.control_seeds):
        print(json.dumps({"what": "control", "seed": seed,
                          "numbers": runner.control(spec, seed, dev, args.emulate)}),
              flush=True)
    for name in [f for f in args.faults.split(",") if f]:
        for seed in ints(args.fault_seeds):
            line = cell.execute(args.workload, seed, args.seconds, False, dev,
                                time.perf_counter(), fault=faults[name])
            print(json.dumps({"what": f"fault:{name}", "seed": seed, "correct": line["correct"],
                              "numbers": numbers(line)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
