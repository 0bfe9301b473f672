"""The port stands alone: every module of ``panoptic_forecasting_tpu_torch``
imports in a fresh interpreter where ``jax`` cannot be imported, and none
of them loads the JAX package (not even its host-side numpy modules),
Pillow (PNG goes through the port's own codec) or cv2 (the odometry
images' resize is the port's own, run here with cv2 blocked)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r"""
import importlib, json, pkgutil, sys
sys.modules["jax"] = None  # any import of jax raises ImportError
sys.modules["cv2"] = None
import numpy as np
import panoptic_forecasting_tpu_torch as port
names = sorted(m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + "."))
for name in names:
    importlib.import_module(name)
from panoptic_forecasting_tpu_torch.data.odom_data import resize_short_side
assert resize_short_side(np.zeros((6, 10, 3), np.float32), 3).shape == (3, 5, 3)
print(json.dumps({"modules": names,
                  "loaded": sorted(k for k, v in sys.modules.items() if v is not None)}))
"""


def test_port_imports_no_jax_no_jax_package_no_pillow():
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    import json

    rep = json.loads(out.stdout.strip().splitlines()[-1])
    names = set(rep["modules"])
    for must in ("cli.export_segmentation", "cli.prepare_bg_data", "cli.prepare_gt_nofg",
                 "cli.export_panoptic", "cli.export_instances", "cli.evaluate_instances",
                 "cli.viz_panoptic", "eval.fusion", "eval.instance_ap",
                 "data.bg_data", "data.transforms", "cli.train", "train.loop",
                 "train.optim", "core.metrics", "models.torch_import", "models.bg",
                 "models.hardnet", "models.convert", "data.loader", "data.synthetic",
                 "data.pipelines", "parallel", "parallel.mesh", "native"):
        assert f"panoptic_forecasting_tpu_torch.{must}" in names, must
    loaded = rep["loaded"]
    assert not [m for m in loaded if m == "jax" or m.startswith("jax.")]
    assert not [m for m in loaded if m == "panoptic_forecasting_tpu"
                or m.startswith("panoptic_forecasting_tpu.")]
    assert not [m for m in loaded if m == "PIL" or m.startswith("PIL.")]
    assert not [m for m in loaded if m == "cv2" or m.startswith("cv2.")]
