"""Artifact IO: disparity/depth decoding, JSON, PNG, tables and HDF5.

Counterpart of ``panoptic_forecasting_tpu/data/io.py`` (the reference's
unshipped ``data_utils.read_json_file`` / ``load_depth``,
pc_transform_dataset.py:115,141,274, re-derived from the Cityscapes
disparity encoding). PNG goes through the port's ``native`` module (a
compiled row codec over Python's ``zlib``, libpng's arrays and bytes), not
libpng or Pillow.

Every reader of a pandas table goes through ``read_table``, every reader
of an HDF5 file through ``open_h5`` and every writer of one through
``write_h5`` (a whole file) or ``append_h5`` (keys of a file): the one
place each format's package (pandas, h5py) is imported for each.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .. import native


def read_json_file(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def read_table(path: str) -> List[Dict[str, Any]]:
    """A pickled pandas table (``{split}_3d_info.pkl``, the fg meta and
    depth tables) -> its rows, as dicts of column -> value."""
    import pandas as pd

    return pd.read_pickle(path).to_dict("records")


def open_h5(path: str) -> "LazyH5":
    """An HDF5 file (ROI features, predicted odometry) for reading."""
    return LazyH5(path)


def write_h5(path: str, arrays: Dict[str, np.ndarray]) -> None:
    """Write ``{key: array}`` as an HDF5 file (each ``/`` of a key makes a
    group), replacing ``path``."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with h5py.File(path, "w") as h5:
        for key, arr in arrays.items():
            h5.create_dataset(key, data=arr)


def append_h5(path: str, arrays: Dict[str, np.ndarray],
              compression: Optional[str] = None) -> None:
    """Write ``{key: array}`` into the HDF5 file at ``path`` (made if it
    is missing), each key created or, if there, replaced; the file's
    other keys stay. ``compression`` is h5py's (e.g. ``gzip``)."""
    import h5py

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    kw = {} if compression is None else {"compression": compression}
    with h5py.File(path, "a") as h5:
        for key, arr in arrays.items():
            if key in h5:
                del h5[key]
            h5.create_dataset(key, data=arr, **kw)


def load_png(path: str) -> np.ndarray:
    return native.load_png(path)


def load_png_batch(paths) -> np.ndarray:
    """Decode N same-geometry PNGs into one (N, H, W[, C]) array, the files
    on threads at once (``native.load_png_batch``)."""
    return native.load_png_batch(paths)


# PNG write profiles (the JAX package's): id/label maps and masks with
# every row unfiltered (libpng's PNG_FILTER_NONE mask, 0x08) at zlib level
# 1; 16-bit depth and disparity with libpng's per-row filter choice at
# level 1.
PNG_IDS = {"compress_level": 1, "filters": native.FILTER_NONE}
PNG_SMOOTH16 = {"compress_level": 1}


def save_png(path: str, arr: np.ndarray, compress_level: int = 6,
             filters: Optional[int] = None) -> None:
    """Write ``arr`` as PNG, the bytes libpng writes: ``filters`` is
    libpng's ``PNG_FILTER_*`` mask, ``None`` for all five filters chosen
    per row (``native.save_png``)."""
    native.save_png(path, np.asarray(arr), compress_level,
                    native.FILTER_ADAPTIVE if filters is None else filters)


class AsyncWriter:
    """Bounded thread pool for host-side artifact writes (PNG/npy/txt).

    Export loops interleave device steps with per-frame file writes (the
    reference writes synchronously inside its export loop,
    export_cityscapes_segmentation_results.py:53-127); offloading the
    encode+write overlaps host IO with the next frame's device step.
    Only host work is submitted; submitted arrays must not be mutated
    after ``submit``. ``max_pending`` bounds in-flight jobs
    (backpressure). The first worker exception re-raises on the caller's
    thread at the next ``submit()`` or at ``close()``. ``workers=0``
    makes the calls synchronous.
    """

    def __init__(self, workers: int = 4, max_pending: int = 32):
        self._ex = None
        self._err: Optional[BaseException] = None
        if workers > 0:
            import threading
            from concurrent.futures import ThreadPoolExecutor

            self._ex = ThreadPoolExecutor(
                max_workers=workers, thread_name_prefix="pf-write"
            )
            self._slots = threading.Semaphore(max_pending)

    def submit(self, fn, *args, **kwargs) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err
        if self._ex is None:
            fn(*args, **kwargs)
            return
        self._slots.acquire()

        def job():
            try:
                fn(*args, **kwargs)
            except BaseException as e:  # surfaced on the caller's thread
                if self._err is None:
                    self._err = e
            finally:
                self._slots.release()

        self._ex.submit(job)

    def close(self) -> None:
        """Drain the queue; raise the first worker error, if any."""
        if self._ex is not None:
            self._ex.shutdown(wait=True)
            self._ex = None
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def __enter__(self) -> "AsyncWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if exc_type is None:
            self.close()
        else:  # don't mask the in-flight exception with a writer error
            try:
                self.close()
            except BaseException:
                pass
        return False


def decode_disparity_png(png: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Cityscapes ``disparity_sequence`` uint16 PNG -> (disparity px, valid).

    Official encoding: p > 0 ⇒ d = (p − 1) / 256; p == 0 ⇒ invalid.
    """
    png = png.astype(np.float32)
    valid = png > 0
    disp = np.where(valid, (png - 1.0) / 256.0, 0.0)
    return disp, valid


def disparity_to_depth(
    disp: np.ndarray, valid: np.ndarray, baseline: float, fx: float
) -> Tuple[np.ndarray, np.ndarray]:
    """Stereo disparity (px) -> metric depth: z = baseline·fx / d.

    Zero-disparity (infinitely far / sky) is marked invalid rather than inf.
    """
    ok = valid & (disp > 0)
    depth = np.where(ok, baseline * fx / np.maximum(disp, 1e-6), 0.0)
    return depth.astype(np.float32), ok


def load_depth(
    path: str,
    baseline: float,
    fx: float,
    use_cascade: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """Load a disparity artifact and convert to (depth, valid_mask):
    stereo ``*_disparity.png`` files decode with the Cityscapes rule;
    cascade-stereo outputs are float disparity maps (.npy or 16-bit PNG
    already in pixels)."""
    if path.endswith(".npy"):
        disp = np.load(path)
        valid = disp > 0
    else:
        png = load_png(path)
        if use_cascade:
            disp = png.astype(np.float32) / 256.0
            valid = png > 0
        else:
            disp, valid = decode_disparity_png(png)
    return disparity_to_depth(disp, valid, baseline, fx)


def encode_depth_png(depth: np.ndarray) -> np.ndarray:
    """Metric depth -> uint16 PNG payload: round((d+1).clip(0,255)·256).

    Inverse of the bg-dataset decode ``png/256 − 1`` (bg_dataset.py:224-228).
    Invalid depths (−1) encode to 0.
    """
    enc = (np.clip(depth + 1.0, 0.0, 255.0) * 256.0).round()
    return enc.astype(np.uint16)


def encode_disparity_from_depth(depth: np.ndarray,
                                disp_factor: float) -> np.ndarray:
    """Depth -> uint16 disparity PNG payload as the reference exports it:
    ``clamp(disp_factor / depth, 0, 255)·256`` for depth >= 0, else 0
    (export_cityscapes_segmentation_results.py:111-118)."""
    out = np.zeros_like(depth, dtype=np.float32)
    pos = depth >= 0
    out[pos] = np.clip(disp_factor / np.maximum(depth[pos], 1e-6), 0, 255) * 256.0
    return out.round().astype(np.uint16)


def decode_depth_png(png: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """uint16 depth PNG -> (depth, valid); 0 ⇒ invalid (depth −1)."""
    valid = png > 0
    depth = np.where(valid, png.astype(np.float32) / 256.0 - 1.0, -1.0)
    return depth.astype(np.float32), valid


class LazyH5:
    """HDF5 file opened on its first read (h5py imported there), shared
    by the loader's threads."""

    def __init__(self, path: str):
        import threading

        self.path = path
        self._fh = None
        self._lock = threading.Lock()
        self._mm = None  # shared whole-file mapping for mmap_dataset

    def handle(self):
        import h5py

        if self._fh is None:
            # double-checked: loader threads may hit the first open together
            with self._lock:
                if self._fh is None:
                    self._fh = h5py.File(self.path, "r")
        return self._fh

    def __getitem__(self, key):
        return self.handle()[key]

    def mmap_dataset(self, key):
        """Zero-copy numpy view of a contiguous uncompressed dataset
        (plain page-cache reads; all datasets share one whole-file
        mapping); the live h5py dataset for chunked or compressed
        layouts."""
        import h5py

        d = self.handle()[key]
        layout = d.id.get_create_plist().get_layout()
        off = d.id.get_offset() if layout == h5py.h5d.CONTIGUOUS else None
        if off is None or off < 0:
            return d
        if self._mm is None:
            import mmap

            with self._lock:
                if self._mm is None:
                    with open(self.path, "rb") as f:
                        mm = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ)
                    self._mm = np.frombuffer(mm, np.uint8)
        return self._mm[off : off + d.nbytes].view(d.dtype).reshape(d.shape)

    def close(self):
        if self._fh is not None:
            try:
                self._fh.close()
            finally:
                self._fh = None
