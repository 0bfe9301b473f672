"""BENCHMARK.json against the benchmark's contract, and the harness's
data-driven layout: every cell resolves by name, and a new cell, traffic
mix, metric and configuration kind are new files plus entries, with no
file edited."""

import json
import os
import re
import shutil
import sys
import time

import pytest
import torch

import portbench.harness
from portbench import control
from portbench.harness import cell, check

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_names_units_and_keys():
    man = cell.manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    names = []
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        names += [w["name"], w["traffic"]]
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in man["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for n in names:
        assert NAME.match(n), n
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]


@pytest.mark.parametrize("name", [w["name"] for w in cell.manifest()["workloads"]])
def test_every_cell_resolves(name):
    spec = cell.resolve(name)
    assert os.path.exists(os.path.join(cell.BENCH, "harness", f"{spec['config']['kind']}.py"))
    runner = cell.runner(spec["config"]["kind"])
    assert all(callable(getattr(runner, f)) for f in ("run", "control", "tiny"))
    assert runner.FAULTS and all(callable(f) for f in runner.FAULTS.values())
    reported = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(cell.reader(m["name"]))
    assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())


# What each accepted cell reports, pinned: a metric's ``workloads`` list
# decides it, and a list edited by mistake moves a metric in or out.
FORECAST_LAYERS = ["forecast.bg_ms", "forecast.bg_span_ms", "forecast.fg_ms",
                   "forecast.fg_span_ms", "forecast.fusion_ms", "forecast.fusion_span_ms",
                   "forecast.h2d_ms", "forecast.idle_share", "forecast.k1_roofline",
                   "forecast.k2_roofline", "forecast.mfu", "forecast.pc_ms",
                   "forecast.pc_span_ms"]
REPORTED = {
    "forecast_short.scene8": (["forecast_ms", "forecast_p95_ms", "setup_s"], FORECAST_LAYERS),
    "forecast_short.crowd32": (["forecast_ms", "forecast_p95_ms", "setup_s"], FORECAST_LAYERS),
    "bg_train.pool8": (["setup_s", "train_step_ms"],
                       ["train.data_wait_ms", "train.h2d_ms", "train.idle_share",
                        "train.launches_per_step", "train.loader_wait_ms", "train.mfu",
                        "train.optim_ms"]),
}


@pytest.mark.parametrize("name", sorted(REPORTED))
def test_cell_reports_pinned_metrics(name):
    spec = cell.resolve(name)
    assert (sorted(m["name"] for m in spec["end_to_end"]),
            sorted(m["name"] for m in spec["per_layer"])) == REPORTED[name]


def test_every_metric_names_its_cells():
    man = cell.manifest()
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert m["workloads"] and set(m["workloads"]) <= cells, m["name"]


ORIGINAL_ROOT, ORIGINAL_BENCH = cell.ROOT, cell.BENCH


def _original():
    """The original BENCHMARK.json's entries."""
    with open(os.path.join(ORIGINAL_ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _copy(tmp_path, monkeypatch):
    """A copy of the benchmark that the harness then reads in place of the
    original: -> (its root, BENCHMARK.json's entries to add to)."""
    root = tmp_path / "repo"
    shutil.copytree(ORIGINAL_BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    man = _original()
    monkeypatch.setattr(cell, "ROOT", str(root))
    monkeypatch.setattr(cell, "BENCH", str(root / "portbench"))
    monkeypatch.setattr(check, "HERE", str(root / "portbench"))
    return root, man


def _unchanged(root):
    """No file of the original benchmark differs from the copy's."""
    for dirpath, _, files in os.walk(ORIGINAL_BENCH):
        for f in files:
            if "__pycache__" in dirpath or "_cache" in dirpath:
                continue
            here = os.path.join(dirpath, f)
            there = os.path.join(root, os.path.relpath(here, ORIGINAL_ROOT))
            assert open(here, "rb").read() == open(there, "rb").read(), here


def test_adding_is_new_files_only(tmp_path, monkeypatch):
    """A throwaway configuration, traffic mix, metric and cell, added as
    new files and entries of a copy: the harness finds them by name."""
    root, man = _copy(tmp_path, monkeypatch)
    base = json.loads(open(os.path.join(ORIGINAL_ROOT, man["configs"][0]["file"])).read())
    (root / "portbench" / "configs" / "throwaway.json").write_text(json.dumps(base))
    (root / "portbench" / "traffic" / "one4.json").write_text(json.dumps(
        {"kind": "scenes", "pool": 1, "slots": 4, "valid_slots": [4, 4],
         "classes": {"car": 1.0}, "speed": [5.0, 6.0], "yaw_rate": [0.0, 0.0],
         "frame_gap": 3}))
    (root / "portbench" / "metrics" / "throwaway.count.py").write_text(
        "def read(trace, counts, spec):\n    return float(counts['frames'])\n")
    (root / "portbench" / "limits" / "throwaway.one4.json").write_text(
        json.dumps({"limits": {"ids_off": 0}}))
    man["configs"].append({"name": "throwaway", "source": "a test", "reduced": [],
                           "file": "portbench/configs/throwaway.json", "why": "a test"})
    man["workloads"].append({"name": "throwaway.one4", "config": "throwaway",
                             "traffic": "one4", "chips": 1, "why": "a test"})
    man["per_layer"].append({"name": "throwaway.count", "unit": "frames", "better": "higher",
                             "source": "program_counter", "layer": "a test",
                             "moves": "forecast_ms", "workloads": ["throwaway.one4"]})
    for m in man["end_to_end"]:
        if "workloads" in m and m["name"].startswith("forecast"):
            m["workloads"].append("throwaway.one4")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    spec = cell.resolve("throwaway.one4")
    assert spec["traffic"]["slots"] == 4 and spec["limits"] == {"ids_off": 0.0}
    assert "throwaway.count" in [m["name"] for m in spec["per_layer"]]
    assert cell.reader("throwaway.count")(None, {"frames": 3}, spec) == 3.0
    _unchanged(root)
    assert sys.modules.get("portbench.harness.cell") is cell


# A throwaway configuration kind ``sums``: running sums of seeded rows, in
# float32 against a float64 reference. Its runner, traffic kind, traffic
# mix, limits and metric reader are the files a new kind brings.
SUMS_RUNNER = '''"""Running sums of seeded rows (a throwaway kind)."""
import time

import torch

from portbench.harness import traffic


def altered(step):
    def broken(x):
        out = step(x)
        out[:, 0] += 1
        return out
    return broken


FAULTS = {"altered": altered}


def _reference(x, dtype=torch.float64):
    return torch.cumsum(x.to(dtype), -1).double()


def _gap(got, want):
    return max(float((g.double() - w).abs().max() / w.abs().max()) for g, w in zip(got, want))


def run(ctx):
    pool = traffic.make(ctx.traffic, ctx.config, ctx.seed, ctx.device)
    step = lambda x: torch.cumsum(x, -1)
    step = ctx.fault(step) if ctx.fault is not None else step
    ctx.setup_done()
    t0 = time.perf_counter()
    got = [step(x) for x in pool]
    ms = (time.perf_counter() - t0) * 1e3 / len(pool)
    return {"attempted": len(pool), "failed": 0, "memory_peak_bytes": ctx.memory_peak(),
            "metrics": {"sums_ms": ms},
            "numbers": {"sum_rel": _gap(got, [_reference(x) for x in pool])}}


def control(spec, seed, dev, emulate):
    pool = traffic.make(spec["traffic"], spec["config"], seed, dev)
    return {"sum_rel": _gap([_reference(x, torch.bfloat16) for x in pool],
                            [_reference(x) for x in pool])}


def tiny(spec):
    spec["traffic"]["pool"] = 2
'''
SUMS_TRAFFIC = '''import torch

from portbench.harness.traffic import generator


def make(params, cfg, seed, dev):
    g = generator(seed, 9, dev)
    shape = (int(params["rows"]), int(cfg["width"]))
    return [torch.rand(shape, generator=g, device=dev) + 0.5 for _ in range(int(params["pool"]))]
'''


@pytest.fixture
def sums_kind(tmp_path, monkeypatch):
    """The copy with the ``sums`` kind added as new files and entries,
    its runner and traffic kind importable by name from the copy."""
    root, man = _copy(tmp_path, monkeypatch)
    bench = root / "portbench"
    (bench / "harness" / "sums.py").write_text(SUMS_RUNNER)
    (bench / "harness" / "traffic_sums.py").write_text(SUMS_TRAFFIC)
    (bench / "configs" / "sums64.json").write_text(json.dumps({"kind": "sums", "width": 64}))
    (bench / "traffic" / "rows8.json").write_text(
        json.dumps({"kind": "sums", "pool": 3, "rows": 8}))
    (bench / "limits" / "sums64.rows8.json").write_text(json.dumps({"limits": {"sum_rel": 1e-4}}))
    (bench / "metrics" / "sums.rows.py").write_text(
        "def read(trace, counts, spec):\n    return float(spec['traffic']['rows'])\n")
    man["configs"].append({"name": "sums64", "source": "a test", "reduced": [],
                           "file": "portbench/configs/sums64.json", "why": "a test"})
    man["workloads"].append({"name": "sums64.rows8", "config": "sums64", "traffic": "rows8",
                             "chips": 1, "why": "a test"})
    man["end_to_end"].append({"name": "sums_ms", "unit": "ms", "better": "lower",
                              "bound": 0.1, "source": "host_clock",
                              "workloads": ["sums64.rows8"]})
    man["per_layer"].append({"name": "sums.rows", "unit": "rows", "better": "higher",
                             "source": "program_counter", "layer": "a test",
                             "moves": "sums_ms", "workloads": ["sums64.rows8"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    monkeypatch.setattr(portbench.harness, "__path__",
                        list(portbench.harness.__path__) + [str(bench / "harness")])
    yield root
    for name in ("portbench.harness.sums", "portbench.harness.traffic_sums"):
        sys.modules.pop(name, None)


def test_new_kind_runs_as_new_files_only(sums_kind):
    spec = cell.resolve("sums64.rows8")
    assert sorted(m["name"] for m in spec["end_to_end"]) == ["setup_s", "sums_ms"]
    assert [m["name"] for m in spec["per_layer"]] == ["sums.rows"]
    runner = cell.runner("sums")
    runner.tiny(spec)
    line = cell.execute("sums64.rows8", 2**31 + 5, 0.1, False, torch.device("cpu"),
                        time.perf_counter(), spec=spec)
    assert line["correct"] and line["attempted"] == 2, line["checks"]
    assert set(line["metrics"]) == {"sums_ms", "setup_s"}
    assert list(line)[-1] == "checks"
    assert {"cpus", "numa_node", "threads"} <= set(line["host"])
    for name in ("forecast_short.scene8", "bg_train.pool8", "forecast_short.crowd32"):
        assert cell.resolve(name)["per_layer"] == cell.resolve(name, _original())["per_layer"]
    _unchanged(sums_kind)


def test_new_kind_control_and_fault(sums_kind, capsys):
    """``control.main`` finds the new kind's control and fault by name:
    the program passes, the control (bfloat16 sums) and the fault fail."""
    seed = str(2**31 + 6)
    assert control.main(["--workload", "sums64.rows8", "--seeds", seed, "--control-seeds",
                         seed, "--faults", "altered", "--fault-seeds", seed,
                         "--seconds", "0.1"]) == 0
    lines = {x["what"]: x for x in map(json.loads, capsys.readouterr().out.splitlines())}
    assert lines["program"]["correct"]
    ok, rows = check.judge(lines["control"]["numbers"], check.limits("sums64.rows8"))
    assert not ok, rows
    assert not lines["fault:altered"]["correct"], lines["fault:altered"]["numbers"]
    _unchanged(sums_kind)
