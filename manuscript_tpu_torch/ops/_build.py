"""Build the CUDA kernels of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>-<digest>.so``
at the root of the checkout; the digest covers the source and the flags, so an
edited source never loads a stale library. ``build()`` starts one ``nvcc`` per
source, all at once. Nothing here runs when the package is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("attention_step", "quad_iou")
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# per-source extra flags (quad_iou.cu explains its -fmad=false)
EXTRA_FLAGS = {"quad_iou": ["-fmad=false"]}

_libs: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """nvcc from PATH, else from the CUDA toolkit (CUDA_HOME, by default
    /usr/local/cuda)."""
    toolkit = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    found = shutil.which("nvcc") or (toolkit if os.path.exists(toolkit) else None)
    if found is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of manuscript_tpu_torch are "
            "built from source at first use and need the CUDA toolkit"
        )
    return found


def _flags(name: str):
    return FLAGS + EXTRA_FLAGS.get(name, [])


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> float:
    """Compile every named source that has no library yet, all in parallel.
    Returns the wall seconds; raises with nvcc's output on a failure.
    ``verbose`` adds ``-Xptxas -v`` and prints what ptxas reports."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [exe, *_flags(name), *(["-Xptxas", "-v"] if verbose else []),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        if verbose and log.strip():
            print(f"[nvcc {name}]\n{log.strip()}")
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _libs[name] = lib
    return lib


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
