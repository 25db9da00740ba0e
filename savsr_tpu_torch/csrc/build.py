"""nvcc build + ctypes loader for the port's CUDA kernels, and the g++
build of the host resampler.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/savsr_tpu_torch/lib<name>-<digest>.so``; the digest covers the
source text, every header it includes from ``csrc/`` (``#include "..."``,
followed through headers that include others) and the flags, so an edited
source or shared header rebuilds and a stale library is never loaded.
``build_all`` starts one nvcc per source at once (the chip smoke run's
build phase); ``load`` builds one library on first use.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so <name>.cu

``resample_native`` runs ``csrc/resample.cpp`` (host code of the data
pipeline), built by g++ on first use into the same directory; without a
host compiler it returns None and the caller keeps its numpy path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Iterable, List, Optional, Tuple

CSRC_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(CSRC_DIR))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "savsr_tpu_torch")
SOURCES = ("conv", "sta", "stau", "tail", "osconv")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.isfile(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def source_files(name: str) -> List[str]:
    """``csrc/<name>.cu`` and the ``csrc/`` headers it includes, directly or
    through other headers, in the order first met."""
    files, todo = [], [f"{name}.cu"]
    while todo:
        rel = todo.pop(0)
        path = os.path.join(CSRC_DIR, rel)
        if path in files or not os.path.isfile(path):
            continue
        files.append(path)
        with open(path, "rb") as f:
            todo += [m.decode() for m in _LOCAL_INCLUDE.findall(f.read())]
    return files


def library_path(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in source_files(name):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:12]}.so")


def _start(name: str) -> Tuple[str, subprocess.Popen, str]:
    out = library_path(name)
    tmp = f"{out}.{os.getpid()}.tmp"
    with open(f"{out}.log", "w") as log:
        proc = subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT,
        )
    return out, proc, tmp


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every source that has no current library, all nvcc processes
    in parallel; raise with the compiler log if any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {n: _start(n) for n in names if not os.path.isfile(library_path(n))}
    failed = []
    for name, (out, proc, tmp) in jobs.items():
        if proc.wait() != 0:
            failed.append(name)
            continue
        os.replace(tmp, out)
    if failed:
        logs = []
        for n in failed:
            with open(f"{library_path(n)}.log") as f:
                logs.append(f.read())
        raise RuntimeError(f"nvcc failed for {failed}:\n" + "\n".join(logs))


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>``, built first if needed."""
    path = library_path(name)
    if not os.path.isfile(path):
        build_all([name])
    lib = ctypes.CDLL(path)
    lib.savsr_error_string.restype = ctypes.c_char_p
    lib.savsr_error_string.argtypes = [ctypes.c_int]
    return lib


# the host resampler: the JAX package's flags, so that both packages' builds
# contract the same multiply-adds
HOST_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17", "-pthread")
_HOST_LOCK = threading.Lock()  # loader threads may ask at once: one g++ at a time


@functools.lru_cache(maxsize=None)
def _load_resampler() -> Optional[ctypes.CDLL]:
    """The ctypes handle of the host resampler, built first if needed; None
    if it cannot be built here (no g++)."""
    src = os.path.join(CSRC_DIR, "resample.cpp")
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    with open(src, "rb") as f:
        h.update(f.read())
    out = os.path.join(BUILD_DIR, f"libresample-{h.hexdigest()[:12]}.so")
    with _HOST_LOCK:
        try:
            if not os.path.isfile(out):
                os.makedirs(BUILD_DIR, exist_ok=True)
                tmp = f"{out}.{os.getpid()}.tmp"
                subprocess.run(["g++", *HOST_FLAGS, src, "-o", tmp], check=True,
                               capture_output=True)
                os.replace(tmp, out)
            lib = ctypes.CDLL(out)
        except (OSError, subprocess.CalledProcessError):
            return None
    fp = ctypes.POINTER(ctypes.c_float)
    lib.resample_hw_f32.restype = None
    lib.resample_hw_f32.argtypes = [fp, fp, fp, fp, fp] + [ctypes.c_int64] * 6 + [ctypes.c_int]
    return lib


def resample_native(x, mh, mw, n_threads: int = 0):
    """Two-pass resample of [N, H, W, C] float32 by the [H_out, H] and
    [W_out, W] float32 weight matrices on the host; None if the resampler
    cannot be built here."""
    import numpy as np

    lib = _load_resampler()
    if lib is None:
        return None
    x = np.ascontiguousarray(x, dtype=np.float32)
    mh = np.ascontiguousarray(mh, dtype=np.float32)
    mw = np.ascontiguousarray(mw, dtype=np.float32)
    n, h_in, w_in, c = x.shape
    if mh.shape[1] != h_in or mw.shape[1] != w_in:
        raise ValueError(f"weights {mh.shape} x {mw.shape} do not fit frames {x.shape}")
    h_out, w_out = mh.shape[0], mw.shape[0]
    scratch = np.empty((n, h_out, w_in, c), dtype=np.float32)
    out = np.empty((n, h_out, w_out, c), dtype=np.float32)
    if n_threads <= 0:
        n_threads = min(8, os.cpu_count() or 1)
    fp = ctypes.POINTER(ctypes.c_float)
    lib.resample_hw_f32(x.ctypes.data_as(fp), scratch.ctypes.data_as(fp),
                        out.ctypes.data_as(fp), mh.ctypes.data_as(fp), mw.ctypes.data_as(fp),
                        n, h_in, w_in, c, h_out, w_out, n_threads)
    return out
