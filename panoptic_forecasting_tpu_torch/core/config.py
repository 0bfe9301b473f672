"""Config system: YAML trees + CLI with dotted overrides.

Counterpart of ``panoptic_forecasting_tpu/core/config.py`` (reference
``utils/config.py``: ``load_config`` :34, ``merge_config`` :81-93,
``convert_val`` :12-32), with the same precedence (low -> high): saved
run config < ``--config_file`` YAML < first-class CLI flags < dotted
``--set a.b.c value`` overrides; typed coercion of string overrides,
including ``[a,b]`` lists. PyYAML is imported only where a YAML file is
read or written.

``save_config`` writes the merged config to ``working_dir/config.yaml``
(reference utils/misc.py:22-26). ``--platform`` picks the device of the
CLIs (``cli/common.py``): ``cpu`` runs on the CPU, anything else on
``cuda``. ``--distributed`` joins a process group before anything is
built (``parallel/mesh.py::init_distributed``): at the coordinator given
by ``--coordinator_address``, ``--num_processes`` and ``--process_id``,
or, without them, through torchrun's environment; the keys land in the
config as the JAX package's ``load_config`` writes them. Only process 0
writes ``config.yaml``.
"""

from __future__ import annotations

import argparse
import os
from typing import Any, Dict, Optional, Sequence

from ..parallel.mesh import is_main_process


def coerce_value(val: str) -> Any:
    """Coerce a CLI string into bool/int/float/None/list, else keep str.

    Mirrors the coercion surface of the reference's ``convert_val``
    (utils/config.py:12-32): ``[a,b,c]`` becomes a list with element-wise
    coercion; bare scalars try bool, None, int, float in that order.
    """
    if not isinstance(val, str):
        return val
    s = val.strip()
    if s.startswith("[") and s.endswith("]"):
        inner = s[1:-1].strip()
        if not inner:
            return []
        return [coerce_value(tok) for tok in inner.split(",")]
    low = s.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    if low in ("none", "null"):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return s


def merge_config(base: Dict, override: Dict) -> Dict:
    """Recursive dict merge; ``override`` wins (reference config.py:81-93)."""
    out = dict(base)
    for k, v in override.items():
        if k in out and isinstance(out[k], dict) and isinstance(v, dict):
            out[k] = merge_config(out[k], v)
        else:
            out[k] = v
    return out


def apply_dotted_override(cfg: Dict, dotted: str, value: Any) -> None:
    """Set ``cfg['a']['b']['c'] = value`` for dotted path ``a.b.c`` in place."""
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        nxt = node.get(k)
        if not isinstance(nxt, dict):
            nxt = {}
            node[k] = nxt
        node = nxt
    node[keys[-1]] = value


class Config(dict):
    """A nested mapping with attribute access and safe ``get`` chains.

    ``cfg.model.rnn_hidden`` works when the keys exist; ``cfg.get('model', {})``
    always works.
    """

    def __getattr__(self, name: str) -> Any:
        try:
            v = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(v, dict) and not isinstance(v, Config):
            return Config(v)
        return v

    def to_dict(self) -> Dict:
        """Plain nested dicts and lists (what ``yaml.safe_dump`` takes)."""
        def conv(x):
            if isinstance(x, dict):
                return {k: conv(v) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return [conv(v) for v in x]
            return x

        return conv(dict(self))


def save_config(cfg: Dict, working_dir: str) -> str:
    """Write the merged config to ``working_dir/config.yaml`` (process 0
    only); returns the path."""
    import yaml

    path = os.path.join(working_dir, "config.yaml")
    if not is_main_process():
        return path
    os.makedirs(working_dir, exist_ok=True)
    with open(path, "w") as f:
        yaml.safe_dump(Config(cfg).to_dict(), f, sort_keys=False)
    return path


def _read_yaml(path: str) -> Dict:
    import yaml

    with open(path) as f:
        out = yaml.safe_load(f)
    return out or {}


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="panoptic_forecasting_tpu_torch")
    p.add_argument("--working_dir", required=True)
    p.add_argument("--config_file", default=None)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--load_model", default=None)
    p.add_argument(
        "--load_torch_model", default=None,
        help="reference *.pt checkpoint, loaded straight into the port's "
             "modules (they keep the reference's parameter names)",
    )
    p.add_argument("--continue_training", action="store_true")
    p.add_argument("--load_best_model", action="store_true")
    p.add_argument("--platform", default=None,
                   help="device: cpu, else cuda (the default)")
    # Data parallelism (reference utils/dist.py:12-32): under torchrun
    # --distributed alone reads its environment; the coordinator keys
    # serve manual launches and the CPU tests.
    p.add_argument("--distributed", action="store_true",
                   help="join a torch.distributed process group before building")
    p.add_argument("--coordinator_address", default=None, help="HOST:PORT of rank 0")
    p.add_argument("--num_processes", type=int, default=None)
    p.add_argument("--process_id", type=int, default=None)
    p.add_argument(
        "--set",
        dest="overrides",
        nargs=2,
        action="append",
        metavar=("PATH", "VALUE"),
        default=[],
        help="dotted config override, e.g. --set training.lr 1e-3",
    )
    return p


def load_config(argv: Optional[Sequence[str]] = None) -> Config:
    """Build the run config from CLI + YAML with reference-parity precedence."""
    args = build_arg_parser().parse_args(argv)
    cfg: Dict = {}

    saved = os.path.join(args.working_dir, "config.yaml")
    if (args.continue_training or args.load_best_model) and os.path.exists(saved):
        cfg = merge_config(cfg, _read_yaml(saved))
    if args.load_model:
        near = os.path.join(os.path.dirname(args.load_model), "config.yaml")
        if os.path.exists(near):
            cfg = merge_config(cfg, _read_yaml(near))
    if args.config_file:
        cfg = merge_config(cfg, _read_yaml(args.config_file))

    cfg["working_dir"] = args.working_dir
    if args.seed is not None:
        cfg["seed"] = args.seed
    cfg.setdefault("seed", 0)
    if args.load_model:
        cfg["load_model"] = args.load_model
    if args.load_torch_model:
        cfg["load_torch_model"] = args.load_torch_model
    cfg["continue_training"] = bool(args.continue_training)
    cfg["load_best_model"] = bool(args.load_best_model)
    if args.platform:
        cfg["platform"] = args.platform
    if args.distributed:
        cfg["distributed"] = True
        for k in ("coordinator_address", "num_processes", "process_id"):
            if getattr(args, k) is not None:
                cfg[k] = getattr(args, k)

    for dotted, raw in args.overrides:
        apply_dotted_override(cfg, dotted, coerce_value(raw))
    return Config(cfg)
