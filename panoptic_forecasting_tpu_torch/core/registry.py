"""Task registries for datasets and models.

Counterpart of ``panoptic_forecasting_tpu/core/registry.py`` (reference
``data/__init__.py:14-31``, ``models/__init__.py:16-28``). Model builders
take the device the port's modules are placed on.
"""

from __future__ import annotations

from typing import Any, Callable, Dict

from ..device import DeviceLike

_DATASETS: Dict[str, Callable] = {}
_MODELS: Dict[str, Callable] = {}


def register_dataset(task: str):
    def deco(fn):
        _DATASETS[task] = fn
        return fn

    return deco


def register_model(task: str):
    def deco(fn):
        _MODELS[task] = fn
        return fn

    return deco


def _ensure_registered() -> None:
    # Import for registration side effects; deferred to avoid import cycles.
    from ..data import pipelines as _  # noqa: F401
    from ..models import factory as _  # noqa: F401


def build_dataset(cfg, test: bool = False) -> Any:
    """Build the per-task dataset bundle. Reference: data/__init__.py:14-31."""
    _ensure_registered()
    task = cfg["task"]
    if task not in _DATASETS:
        raise KeyError(f"unknown dataset task {task!r}; known: {sorted(_DATASETS)}")
    return _DATASETS[task](cfg, test=test)


def build_model(cfg, data_card=None, device: DeviceLike = None) -> Any:
    """Build the per-task model on ``device``. Reference:
    models/__init__.py:16-41."""
    _ensure_registered()
    task = cfg["task"]
    if task not in _MODELS:
        raise KeyError(f"unknown model task {task!r}; known: {sorted(_MODELS)}")
    return _MODELS[task](cfg, data_card, device)
