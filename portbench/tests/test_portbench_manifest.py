"""BENCHMARK.json against the benchmark's contract, and the harness's
data-driven layout: every cell resolves by name, and a new cell, traffic
mix and metric are new files plus entries, with no file edited."""

import json
import os
import re
import shutil
import sys

import pytest

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
    assert spec["config"]["kind"] in ("forecast", "bg_train")
    assert os.path.exists(os.path.join(cell.BENCH, "harness", f"{spec['config']['kind']}.py"))
    reported = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in reported and len(reported) >= 2 and spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(cell.reader(m["name"]))
    assert set(spec["limits"]) and all(v >= 0 for v in spec["limits"].values())


def test_adding_is_new_files_only(tmp_path, monkeypatch):
    """A throwaway configuration, traffic mix, metric and cell, added as
    new files and entries of a copy: the harness finds them by name."""
    root = tmp_path / "repo"
    shutil.copytree(cell.BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("_cache", "__pycache__"))
    man = cell.manifest()
    base = json.loads(open(os.path.join(cell.ROOT, man["configs"][0]["file"])).read())
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
    monkeypatch.setattr(cell, "ROOT", str(root))
    monkeypatch.setattr(cell, "BENCH", str(root / "portbench"))
    monkeypatch.setattr(check, "HERE", str(root / "portbench"))
    spec = cell.resolve("throwaway.one4")
    assert spec["traffic"]["slots"] == 4 and spec["limits"] == {"ids_off": 0.0}
    assert "throwaway.count" in [m["name"] for m in spec["per_layer"]]
    assert cell.reader("throwaway.count")(None, {"frames": 3}, spec) == 3.0
    # no file of the benchmark differs from the original's
    for dirpath, _, files in os.walk(cell.BENCH):
        for f in files:
            if "__pycache__" in dirpath or "_cache" in dirpath:
                continue
            here = os.path.join(dirpath, f)
            there = os.path.join(root, os.path.relpath(here, cell.ROOT))
            assert open(here, "rb").read() == open(there, "rb").read()
    assert sys.modules.get("portbench.harness.cell") is cell
