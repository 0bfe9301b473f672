"""One run of one cell: resolve it by name from ``BENCHMARK.json``, check
the card, hand set-up, window and check to the configuration's runner
(``portbench/harness/<kind>.py``), read the per-layer metrics from the
trace, and print the result line.

Everything a cell is made of is found by its names: the configuration's
file (``BENCHMARK.json``'s ``configs[].file``), whose ``kind`` names its
runner, the traffic file ``portbench/traffic/<traffic>.json``, the limits
of its check ``portbench/limits/<cell>.json`` and each per-layer metric's
reader ``portbench/metrics/<metric>.py``. A runner is the one module that
knows its kind: ``run(ctx)``, its ``FAULTS`` (name -> fault),
``control(spec, seed, dev, emulate)`` and ``tiny(spec)``. A new cell,
traffic mix, metric or configuration kind is new files and new entries;
no file here changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import resource
import subprocess
import sys
import time
from typing import Callable, Dict, List, Optional

from portbench.harness import check

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "portbench")
FORBIDDEN = ("jax", "jaxlib", "flax", "panoptic_forecasting_tpu")


def manifest() -> Dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def resolve(name: str, man: Optional[Dict] = None) -> Dict:
    """The cell ``name``: its entry, configuration, traffic, limits and
    the end-to-end and per-layer metrics it reports."""
    man = man or manifest()
    (cell,) = [w for w in man["workloads"] if w["name"] == name]
    (conf,) = [c for c in man["configs"] if c["name"] == cell["config"]]
    with open(os.path.join(ROOT, conf["file"])) as f:
        config = json.load(f)
    with open(os.path.join(BENCH, "traffic", f"{cell['traffic']}.json")) as f:
        traffic = json.load(f)

    def here(m):
        return name in m.get("workloads", [name])

    e2e = [m for m in man["end_to_end"] if here(m)]
    names = {m["name"] for m in e2e}
    layer = [m for m in man["per_layer"] if here(m) and m["moves"] in names]
    return {"cell": cell, "config": config, "traffic": traffic, "end_to_end": e2e,
            "per_layer": layer, "limits": check.limits(name)}


def runner(kind: str):
    """The runner module of a configuration kind, ``portbench/harness/<kind>.py``."""
    return importlib.import_module(f"portbench.harness.{kind}")


def reader(metric: str) -> Callable:
    """The ``read`` function of ``portbench/metrics/<metric>.py``."""
    path = os.path.join(BENCH, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> List[str]:
    """Modules loaded in this process whose top-level name is one the
    benchmark must not load (JAX, or the JAX package the port mirrors)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


class Ctx:
    """What a runner gets: the cell's configuration and traffic, the run's
    arguments and device, and the run's clock."""

    def __init__(self, spec: Dict, seed: int, seconds: float, trace: bool, device,
                 t_start: float, fault: Optional[Callable] = None):
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device, self.t_start, self.fault = device, t_start, fault
        self.setup_s: Optional[float] = None
        self.marks: Dict[str, float] = {}
        self.card: Dict[str, Dict] = {}
        self.cpu_s: Optional[float] = None  # the process's CPU seconds in the window
        self.mark("imports")

    def mark(self, what: str) -> None:
        """Set-up's split: the seconds from process start to the end of ``what``."""
        self.marks[what] = time.perf_counter() - self.t_start

    def setup_done(self) -> None:
        """Set-up ends: the next call is timed. The card's clock and
        temperature as the window opens go into the result line."""
        if self.device.type == "cuda":
            import torch
            torch.cuda.synchronize(self.device)
            self.card["window_start"] = card_state()
        self.setup_s = time.perf_counter() - self.t_start
        self.mark("warmup")
        self._cpu0 = cpu_seconds()

    def window_done(self) -> None:
        """The window has closed (and the device is synchronised): the
        card's clock and temperature then."""
        self.cpu_s = cpu_seconds() - self._cpu0
        if self.device.type == "cuda":
            self.card["window_end"] = card_state()

    def memory_peak(self) -> int:
        import torch
        if self.device.type != "cuda":
            return 0
        torch.cuda.synchronize(self.device)
        return int(torch.cuda.max_memory_allocated(self.device))

    def free(self) -> None:
        import gc

        import torch
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _smi(query: str, units: bool = True) -> str:
    """``nvidia-smi``'s one line for the card, "" where it reads nothing."""
    fmt = "csv,noheader" + ("" if units else ",nounits")
    try:
        out = subprocess.run(["nvidia-smi", "-i", "0", f"--query-gpu={query}",
                              f"--format={fmt}"], capture_output=True, text=True, timeout=60)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    except (OSError, subprocess.SubprocessError):
        return ""


def cpu_seconds() -> float:
    """The CPU seconds this process has used, all its threads."""
    use = resource.getrusage(resource.RUSAGE_SELF)
    return use.ru_utime + use.ru_stime


def card_line() -> str:
    return _smi("name,power.limit")


def card_state() -> Dict[str, str]:
    """The card's SM clock (MHz), temperature (C) and active clock
    throttle reasons (NVML's bit mask: 0x20 is the software thermal
    slowdown)."""
    keys = ("sm_mhz", "temp_c", "throttle")
    vals = [v.strip() for v in _smi("clocks.sm,temperature.gpu,clocks_throttle_reasons.active",
                                    units=False).split(",")]
    return dict(zip(keys, vals)) if len(vals) == len(keys) else {}


def host_line(device) -> Dict:
    """What the run's process ran on: its CPUs, the card's NUMA node
    (None where the machine does not expose it) and torch's intra-op
    threads, which carry the program's host copies."""
    import torch

    cpus = sorted(os.sched_getaffinity(0))
    node = None
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        bdf = "%04x:%02x:%02x.0" % (getattr(props, "pci_domain_id", 0),
                                    getattr(props, "pci_bus_id", 0),
                                    getattr(props, "pci_device_id", 0))
        try:
            with open(f"/sys/bus/pci/devices/{bdf}/numa_node") as f:
                node = int(f.read())
        except (OSError, ValueError):
            node = None
    return {"cpus": len(cpus), "cpu_list": ",".join(map(str, cpus)), "numa_node": node,
            "threads": torch.get_num_threads()}


def execute(name: str, seed: int, seconds: float, trace: bool, device,
            t_start: float, fault: Optional[Callable] = None,
            spec: Optional[Dict] = None) -> Dict:
    """Run the cell and return its result line (a dict), the compared
    numbers under ``checks``, last. ``fault`` breaks the timed path
    underneath and ``spec`` replaces the cell's resolved files (the
    harness's tests, at a size the CPU holds)."""
    spec = spec or resolve(name)
    ctx = Ctx(spec, seed, seconds, trace, device, t_start, fault)
    res = runner(spec["config"]["kind"]).run(ctx)
    ok, rows = check.judge(res["numbers"], spec["limits"])
    metrics: Dict[str, Dict] = {}
    if trace:
        tr = res["trace"]
        for m in spec["per_layer"]:
            v = reader(m["name"])(tr, res["counts"], spec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in spec["end_to_end"]:
            v = ctx.setup_s if m["name"] == "setup_s" else res["metrics"].get(m["name"])
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": "", "count": 1, "memory_peak_bytes": res["memory_peak_bytes"]}
    if device.type == "cuda":
        import torch
        dev["kind"] = torch.cuda.get_device_name(device)
        dev["card"] = card_line()
    line = {"correct": ok, "attempted": res["attempted"], "failed": res["failed"],
            "metrics": metrics, "device": dev}
    if trace:
        light, full = res["trace"].light, res["trace"].full
        a, b = light.window()
        dev["busy_s"], dev["window_s"] = light.busy_us() / 1e6, (b - a) / 1e6
        line["breakdown"] = {"device_ops": light.device_ops(), "idle_gaps": full.idle_gaps()}
        n = res["counts"].get("frames") or res["counts"]["steps"]
        fa, fb = full.window()
        line["traced_ms"] = {"untraced": res["counts"]["host_s"] * 1e3,
                             "light": (b - a) / 1e3 / n, "full": (fb - fa) / 1e3 / n}
    line["setup_split_s"] = ctx.marks
    if "quarters_ms" in res:
        line["window_quarters_ms"] = res["quarters_ms"]
    line["host"] = dict(host_line(device), card=ctx.card, window_cpu_s=ctx.cpu_s)
    line["checks"] = rows
    return line


def main(args, t_start: float) -> int:
    import torch

    spec = resolve(args.workload)
    chips = int(spec["cell"]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() = {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    from panoptic_forecasting_tpu_torch.cli.common import config_device

    device = config_device({})  # the port's CLI device: cuda, TF32 off
    line = execute(args.workload, args.seed, float(args.seconds), bool(args.trace),
                   device, t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for row in line["checks"]:
        print(f"check {row['name']} = {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line))
    return 0
