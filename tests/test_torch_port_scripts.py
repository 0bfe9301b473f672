"""The port's workflow scripts (``panoptic_forecasting_tpu_torch/scripts/
{odom,bg,fg,preprocessing}/*.sh``): one for each of the JAX package's
``scripts/*/*.sh``, with its arguments, defaults and pass-through
(``"${@:N}"``), each command a ``panoptic_forecasting_tpu_torch.cli``
module that exists, whose parser takes the script's flags (a text
check: the JAX scripts stay as they are). Then one chain of them on
the CPU (``--set platform cpu``) on a synthetic fixture:
remove_fg_from_gt.sh, run_odom_train.sh and export_odom.sh on the run
it trained.
"""

import glob
import importlib.util
import os
import re
import shlex
import subprocess

import h5py
import pytest

from panoptic_forecasting_tpu_torch.core.config import build_arg_parser
from panoptic_forecasting_tpu_torch.data import io, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "panoptic_forecasting_tpu_torch", "scripts")
JAX_SCRIPTS = sorted(os.path.relpath(p, os.path.join(REPO, "scripts"))
                     for p in glob.glob(os.path.join(REPO, "scripts", "*", "*.sh")))
# the CLIs whose flags are the run config's (core/config.py::build_arg_parser)
CONFIG_CLIS = {"train", "export_odom", "export_segmentation", "export_instances",
               "export_panoptic", "forecast_fused", "prepare_bg_data"}


def _code(path):
    """The script's lines without comments, continuations joined."""
    with open(path) as f:
        text = f.read().replace("\\\n", " ")
    return [line.split("#")[0].strip() for line in text.splitlines()
            if line.strip() and not line.lstrip().startswith("#")]


def _commands(path):
    """(cli module, its arguments) of every ``python -m`` command, the
    script's variables read as placeholders and pass-through dropped."""
    out = []
    for line in _code(path):
        if not line.startswith("python -m "):
            continue
        line = line.split("|")[0].replace('"${@:', '"').replace("}\"", '"')
        line = re.sub(r'"\d+"', "", line)
        toks = shlex.split(re.sub(r"\$\{?\w+\}?", "X", line))
        out.append((toks[2], toks[3:]))
    return out


def test_every_jax_script_has_a_port_script():
    assert len(JAX_SCRIPTS) == 9
    port = sorted(os.path.relpath(p, PORT) for p in glob.glob(os.path.join(PORT, "*", "*.sh")))
    assert port == JAX_SCRIPTS


@pytest.mark.parametrize("rel", JAX_SCRIPTS)
def test_port_script_is_the_jax_script_on_the_port(rel):
    """The same lines but the package: arguments, defaults, pass-through."""
    jax_code = _code(os.path.join(REPO, "scripts", rel))
    port_code = _code(os.path.join(PORT, rel))
    assert [line.replace("panoptic_forecasting_tpu_torch.", "panoptic_forecasting_tpu.")
            for line in port_code] == jax_code
    assert os.access(os.path.join(PORT, rel), os.X_OK)


@pytest.mark.parametrize("rel", JAX_SCRIPTS)
def test_port_script_commands_parse(rel):
    commands = _commands(os.path.join(PORT, rel))
    assert commands
    for module, args in commands:
        assert module.startswith("panoptic_forecasting_tpu_torch.cli."), module
        assert importlib.util.find_spec(module) is not None, module
        name = module.rsplit(".", 1)[1]
        if name in CONFIG_CLIS:
            build_arg_parser().parse_args(args)
            continue
        with open(importlib.util.find_spec(module).origin) as f:
            flags = set(re.findall(r'add_argument\(\s*"(--\w+)"', f.read()))
        used = {a for a in args if a.startswith("--")}
        assert used and used <= flags, (module, used - flags)


def _bash(script, *args, cwd=REPO):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(os.pathsep) if p]))
    out = subprocess.run(["bash", os.path.join(PORT, script), *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (script, out.stdout[-2000:], out.stderr[-3000:])
    return out


def test_script_chain_runs_on_the_cpu(tmp_path):
    """remove_fg_from_gt.sh on a Cityscapes fixture, then
    run_odom_train.sh (two steps) and export_odom.sh on the run it
    trained, each with the CPU set: the files each step writes."""
    cs, data, run = (str(tmp_path / d) for d in ("cs", "odom", "run"))
    synthetic.write_cityscapes_fixture(cs, "val", n_snippets=1, height=32, width=64)
    _bash("preprocessing/remove_fg_from_gt.sh", cs, "--splits", "val",
          "--out_dir", str(tmp_path / "nofg"))
    assert glob.glob(str(tmp_path / "nofg" / "val" / "*" / "*_gtFine_labelTrainIds.png"))

    synthetic.write_odom_fixture(data, n_snippets=2)
    cpu = ["--set", "platform", "cpu", "--set", "data.data_dir", data,
           "--set", "model.rnn_hidden", "16"]
    _bash("odom/run_odom_train.sh", run, *cpu, "--set", "training.batch_size", "4",
          "--set", "training.steps_per_epoch", "2", "--set", "training.num_epochs", "1")
    assert os.path.exists(os.path.join(run, "best_model"))
    with open(os.path.join(run, "results.txt")) as f:
        assert "EPOCH 1" in f.read()
    _bash("odom/export_odom.sh", run, *cpu)
    for split in ("train", "val"):
        with h5py.File(os.path.join(run, f"odometry_{split}.h5"), "r") as h5:
            keys = []
            h5.visititems(lambda k, v: keys.append(k) if isinstance(v, h5py.Dataset)
                          else None)
        rows = io.read_table(os.path.join(data, f"{split}_3d_info.pkl"))
        assert len(keys) == len(rows) * 24, (split, len(keys))  # starts 6..29
