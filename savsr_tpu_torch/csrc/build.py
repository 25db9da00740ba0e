"""nvcc build + ctypes loader for the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own
into ``build/savsr_tpu_torch/lib<name>-<digest>.so``; the digest covers the
source text and the flags, so an edited source rebuilds and a stale library
is never loaded. ``build_all`` starts one nvcc per source at once (the
chip smoke run's build phase); ``load`` builds one library on first use.

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o lib<name>.so <name>.cu
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from typing import Iterable, Tuple

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


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}-{digest[:12]}.so")


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
