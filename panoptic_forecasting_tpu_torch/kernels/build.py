"""Build the port's hand-written native code and load it with ctypes.

Each ``csrc/<name>.cu`` (a CUDA kernel) or ``csrc/<name>.cpp`` (host
code: the PNG row codec and pixel transforms of ``native/``) exposes a
plain C interface and is compiled on first use into
``_build/lib<name>-<hash>.so`` inside the package (a directory
``.gitignore`` lists): a ``.cu`` with nvcc for ``sm_90a``, a ``.cpp`` with
the host compiler (``CXX``, else ``c++`` or ``g++``). The hash covers the
source and the flags, so an edited source is rebuilt. No PyTorch or
Python headers are included: a build takes seconds, not minutes. A
failed build raises with the compiler's output; nothing falls back.

Sources come from this package only. Several libraries are built in
parallel (one compiler process each) by ``build``; ``load`` builds one
when it is missing, sets the ctypes signatures of its functions once, and
returns the loaded library; ``load_edited`` builds textually edited copies
of a CUDA source for the profiling scripts. ``launch`` calls a kernel on
a tensor's device and current stream and raises on a CUDA error.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Mapping, Optional, Sequence

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)
HOST_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")

_loaded: Dict[str, ctypes.CDLL] = {}
_load_lock = threading.Lock()  # threads that load one library build it once


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


def cxx() -> List[str]:
    """The host compiler's command: ``CXX`` (split as a shell would), else
    ``c++`` or ``g++`` on the PATH."""
    if os.environ.get("CXX"):
        return shlex.split(os.environ["CXX"])
    found = shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError("no C++ compiler found (set CXX); the port's host "
                           "IO library is built with it")
    return [found]


def source(name: str) -> Path:
    """``csrc/<name>.cu`` where it exists, else ``csrc/<name>.cpp``."""
    cu = CSRC / f"{name}.cu"
    return cu if cu.exists() else CSRC / f"{name}.cpp"


def _flags(src: Path) -> tuple:
    return NVCC_FLAGS if src.suffix == ".cu" else HOST_FLAGS


def library_path(name: str) -> Path:
    src = source(name)
    digest = hashlib.sha1(src.read_bytes() + " ".join(_flags(src)).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:12]}.so"


def _compile(jobs: Mapping[str, tuple], verbose: bool) -> Dict[str, float]:
    """Run one compiler per (source, library) job, all at once: nvcc for a
    ``.cu``, the host compiler for a ``.cpp``; the wall seconds each took."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (src, out) in jobs.items():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cuda = src.suffix == ".cu"
        cmd = [*([_nvcc()] if cuda else cxx()), *_flags(src), "-o", str(tmp), str(src)]
        if verbose and cuda:
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
            print(f"[build {label}]\n{log.rstrip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return seconds


def build(names: Iterable[str], verbose: bool = False) -> Dict[str, float]:
    """Compile every missing library, all compiler processes at once.

    Returns the wall seconds each build took (0.0 when already built).
    ``verbose`` adds ``-Xptxas -v`` to nvcc and prints what ptxas reports
    (registers, shared memory, spills) for each kernel.
    """
    names = list(names)
    jobs = {source(n).name: (source(n), library_path(n)) for n in names
            if not library_path(n).exists()}
    seconds = _compile(jobs, verbose)
    return {n: seconds.get(source(n).name, 0.0) for n in names}


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
    """The loaded library for ``csrc/<name>.cu`` or ``.cpp``, built on
    first use.

    ``signatures`` maps each C function to its ctypes argument types (every
    function returns an ``int``: a CUDA error code, or 0 or a negative code
    for host code); they are set when the library is first loaded, not on
    every call.
    """
    lib = _loaded.get(name)
    if lib is None:
        with _load_lock:
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
