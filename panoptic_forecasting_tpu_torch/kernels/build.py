"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use into ``_build/lib<name>-<hash>.so`` inside the package (a
directory ``.gitignore`` lists), for ``sm_90a``. The hash covers the
source and the flags, so an edited source is rebuilt. No PyTorch headers
are included: a build takes seconds, not minutes.

Sources come from this package only. Several kernels are built in
parallel (one ``nvcc`` process each) by ``build``; ``load`` builds one
when it is missing, sets the ctypes signatures of its functions once, and
returns the loaded library; ``load_edited`` builds textually edited copies
of a source for the profiling scripts. ``launch`` calls a function on a
tensor's device and current stream and raises on a CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, Mapping, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME); the CUDA kernels are built "
            "on the machine with the GPU"
        )
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha1(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _compile(jobs: Mapping[str, tuple], verbose: bool) -> Dict[str, float]:
    """Run one nvcc per (source, library) job, all at once; the wall
    seconds each took."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for label, (src, out) in jobs.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        procs[label] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp, out, time.perf_counter(),
        )
    seconds = {}
    failed = []
    for label, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[label] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{label}:\n{log}")
            continue
        if verbose and log:
            print(f"[nvcc {label}]\n{log.rstrip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return seconds


def build(names: Iterable[str], verbose: bool = False) -> Dict[str, float]:
    """Compile every missing library, all nvcc processes at once.

    Returns the wall seconds each build took (0.0 when already built).
    ``verbose`` adds ``-Xptxas -v`` and prints what ptxas reports
    (registers, shared memory, spills) for each kernel.
    """
    names = list(names)
    jobs = {f"{n}.cu": (CSRC / f"{n}.cu", library_path(n)) for n in names
            if not library_path(n).exists()}
    seconds = _compile(jobs, verbose)
    return {n: seconds.get(f"{n}.cu", 0.0) for n in names}


def _bind(lib: ctypes.CDLL, signatures: Optional[Mapping[str, Sequence]]):
    for fn_name, argtypes in (signatures or {}).items():
        fn = getattr(lib, fn_name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def load_edited(name: str, edits: Mapping[str, Mapping[str, str]],
                signatures: Mapping[str, Sequence]) -> Dict[str, ctypes.CDLL]:
    """Copies of ``csrc/<name>.cu`` with textual edits, built together and
    loaded: for profiling scripts that time a kernel against variants of
    it. ``edits`` maps a variant's name to {anchor: replacement}; each
    anchor must occur exactly once in the source."""
    src = (CSRC / f"{name}.cu").read_text()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs, paths = {}, {}
    for variant, subs in edits.items():
        text = src
        for anchor, repl in subs.items():
            if src.count(anchor) != 1:
                raise ValueError(f"{variant}: an anchor is not once in {name}.cu")
            text = text.replace(anchor, repl)
        digest = hashlib.sha1(text.encode() + " ".join(NVCC_FLAGS).encode())
        stem = BUILD_DIR / f"{name}-{variant}-{digest.hexdigest()[:12]}"
        paths[variant] = stem.with_suffix(".so")
        if not paths[variant].exists():
            stem.with_suffix(".cu").write_text(text)
            jobs[variant] = (stem.with_suffix(".cu"), paths[variant])
    _compile(jobs, verbose=False)
    return {v: _bind(ctypes.CDLL(str(p)), signatures) for v, p in paths.items()}


def load(name: str,
         signatures: Optional[Mapping[str, Sequence]] = None) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use.

    ``signatures`` maps each C function to its ctypes argument types (every
    function returns a CUDA error code, ``int``); they are set when the
    library is first loaded, not on every call.
    """
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = _bind(ctypes.CDLL(str(path)), signatures)
        _loaded[name] = lib
    return lib


def launch(fn: Callable[..., int], device: torch.device, *args) -> None:
    """``fn(*args, stream)`` with ``device`` current and its current CUDA
    stream last; raises ``RuntimeError`` when ``fn`` returns a CUDA error
    (a refused launch never runs, and no synchronise would report it)."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index != current:
        with torch.cuda.device(index):
            return launch(fn, device, *args)
    # The current stream's raw handle, as PyTorch's generated launchers
    # read it: torch.cuda.current_stream() builds a Stream object on every
    # call, which costs a small kernel's launch as much again.
    err = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"{fn.__name__} kernel launch failed: CUDA error {err}")
