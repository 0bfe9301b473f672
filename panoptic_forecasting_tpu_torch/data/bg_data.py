"""Background (semantic forecast) dataset: the part serving reads.

Counterpart of ``panoptic_forecasting_tpu/data/bg_data.py`` (reference
``BGDataset``, datasets/bg_dataset.py:25-232), reduced to what a server
restoring a trained bg model takes from it: the data card. The class
count is 11 stuff classes with ``only_background`` and 19 otherwise
(bg_dataset.py:61-65). Depth statistics are set on the card only for the
train split outside test mode (bg_data.py:108-134 of the JAX package),
so a test-mode dataset leaves them unset and the model normalises depth
with mean 0, std 1, as the JAX package's serving does.

The sample list, transforms and loading serve training and are not
ported yet: a training-mode train split raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any, Dict

from .cards import DataCard


class BGDataset:
    def __init__(self, split: str, cfg: Dict[str, Any], card: DataCard,
                 test: bool = False):
        if split == "train" and not test:
            raise NotImplementedError("the bg training data is not ported yet")
        d = cfg.get("data", {})
        self.split = split
        self.test = test
        self.only_background = bool(d.get("only_background"))
        self.num_classes = 11 if self.only_background else 19
        card.num_classes = self.num_classes
