"""The bg train split's files, written from the ``files`` traffic under a
directory of the run's ``TMPDIR``, in the layout ``data/bg_data.py``
reads:

    <root>/seg<k>/train/<city>/<city>_<seq>_<frame>_gtFine_labelIds.png
        (k = 0, 1, 2: the three reprojected segs, trainIds)
    <root>/gt/train/<city>/<city>_<seq>_<frame>_gtFine_labelTrainIds.png
    <root>/depth_train.u16: the (H, W, 3) raw uint16 depth blocks, one
        after another, at the offsets of an index keyed as the HDF5 file's

PNGs are 8-bit grey, every row unfiltered, deflated at level 1: the
port's own profile for id maps (``data/io.py::PNG_IDS``). The flat depth
file stands in for the HDF5 file that the loader opens through
``data/io.py::open_h5``: h5py is not installed where the benchmark runs,
so the run hands the loader ``Blocks``, which maps each block from the
flat file as the port maps a contiguous HDF5 dataset
(``LazyH5.mmap_dataset``).
"""

from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, Iterable, Tuple

import numpy as np


def png_bytes(a: np.ndarray) -> bytes:
    """An (H, W) uint8 array as an 8-bit grey PNG, rows unfiltered."""
    h, w = a.shape
    rows = np.zeros((h, w + 1), np.uint8)
    rows[:, 1:] = a

    def chunk(tag: bytes, data: bytes) -> bytes:
        crc = zlib.crc32(tag + data) & 0xFFFFFFFF
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 1)) + chunk(b"IEND", b""))


def stem(name: Tuple[str, int, int]) -> str:
    city, seq, frame = name
    return f"{city}_{seq:06d}_{frame:06d}_gtFine"


def key(name: Tuple[str, int, int]) -> str:
    """The depth block's key (``start_fr`` 0: ``gap_len`` 9)."""
    city, seq, frame = name
    return f"{city}/{seq:06d}/{frame:06d}/0"


def write(samples: Iterable[Dict], root: str, t_in: int) -> Dict:
    """Write the samples; returns the dataset's ``data`` paths and the
    depth file's ``index`` and block ``shape``."""
    segs = [os.path.join(root, f"seg{k}") for k in range(t_in)]
    gt = os.path.join(root, "gt")
    depth = os.path.join(root, "depth_%s.u16")
    index, offset, shape = {}, 0, None
    with open(depth % "train", "wb") as f:
        for s in samples:
            city = s["name"][0]
            for d in segs + [gt]:
                os.makedirs(os.path.join(d, "train", city), exist_ok=True)
            for k, d in enumerate(segs):
                with open(os.path.join(d, "train", city, stem(s["name"]) + "_labelIds.png"),
                          "wb") as out:
                    out.write(png_bytes(s["segs"][k]))
            with open(os.path.join(gt, "train", city, stem(s["name"]) + "_labelTrainIds.png"),
                      "wb") as out:
                out.write(png_bytes(s["gt"]))
            block = np.ascontiguousarray(s["depth"])
            shape = block.shape
            index[key(s["name"])] = offset
            f.write(block.tobytes())
            offset += block.nbytes
    return {"data": {"data_dir": segs, "gt_dir": gt, "depth_h5_path": depth},
            "index": index, "shape": shape}


class Blocks:
    """The depth file's reader, in place of ``open_h5``'s."""

    def __init__(self, path: str, index: Dict[str, int], shape):
        self.path, self.index, self.shape = path, index, tuple(shape)

    def mmap_dataset(self, key: str) -> np.ndarray:
        return np.memmap(self.path, np.uint16, "r", self.index[key], self.shape)

    def __getitem__(self, key: str) -> np.ndarray:
        return self.mmap_dataset(key)
