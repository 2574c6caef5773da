"""Build the native sources of ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for Hopper (``sm_90a``); ``csrc/lanms.cpp``, the host LANMS, is
compiled by the host C++ compiler (``c++``, else ``g++``). Each goes into
``lib<name>-<digest>.so`` in the build directory: ``build/kernels/`` at the
root of the checkout, or the persistent cache that
``utils/compile_cache.enable_compile_cache`` set. The digest covers the
source and the flags, so an edited source never loads a stale library, not
even from a cache that several checkouts share. ``build()`` starts one
compiler per source, all at once. Nothing here runs when the package is
imported.
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
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"  # the default
cache_dir = None  # set by utils/compile_cache.enable_compile_cache; wins over BUILD_DIR
CUDA_SOURCES = ("attention_step", "quad_iou", "multi_tensor", "batch_norm", "beam_select")
HOST_SOURCES = ("lanms",)
SOURCES = CUDA_SOURCES + HOST_SOURCES
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# per-source extra flags (quad_iou.cu, multi_tensor.cu and beam_select.cu explain their -fmad=false)
EXTRA_FLAGS = {"quad_iou": ["-fmad=false"], "multi_tensor": ["-fmad=false"],
               "beam_select": ["-fmad=false"]}
# the JAX package's native/Makefile flags; no -march=native (lanms.cpp says why)
HOST_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared"]

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


def host_cxx() -> str:
    """The host C++ compiler from PATH: ``c++``, else ``g++``."""
    found = shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError(
            "no host C++ compiler (c++ or g++) on PATH: the host LANMS of "
            "manuscript_tpu_torch (csrc/lanms.cpp) is built from source at first use"
        )
    return found


def _source(name: str) -> Path:
    return CSRC / (f"{name}.cpp" if name in HOST_SOURCES else f"{name}.cu")


def _flags(name: str):
    if name in HOST_SOURCES:
        return list(HOST_FLAGS)
    return FLAGS + EXTRA_FLAGS.get(name, [])


def build_dir() -> Path:
    """Where the libraries are built and looked for, read at each build."""
    return BUILD_DIR if cache_dir is None else Path(cache_dir)


def library_path(name: str) -> Path:
    src = _source(name).read_bytes()
    digest = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return build_dir() / f"lib{name}-{digest[:16]}.so"


def build(names: Iterable[str] = SOURCES, verbose: bool = False) -> Dict[str, float]:
    """Compile every named source that has no library yet, all in parallel.
    Returns each compiled source's seconds from the common start to the end
    of its compiler; raises with the compiler's output on a failure.
    ``verbose`` adds ``-Xptxas -v`` to nvcc and prints what it reports."""
    t0 = time.perf_counter()
    todo = [n for n in names if not library_path(n).exists()]
    if not todo:
        return {}
    build_dir().mkdir(parents=True, exist_ok=True)
    # every compiler is found before any starts
    compilers = {n: host_cxx() if n in HOST_SOURCES else nvcc() for n in todo}
    procs = {}
    for name in todo:
        out = library_path(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        extra = ["-Xptxas", "-v"] if verbose and name not in HOST_SOURCES else []
        cmd = [compilers[name], *_flags(name), *extra, "-o", str(tmp), str(_source(name))]
        log = open(tmp.with_suffix(".log"), "w+")
        procs[name] = (out, tmp, log, subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT))
    failed, seconds = [], {}
    while len(seconds) < len(procs):
        for name, (out, tmp, log, proc) in procs.items():
            if name in seconds or proc.poll() is None:
                continue
            seconds[name] = time.perf_counter() - t0
            log.seek(0)
            text = log.read()
            log.close()
            os.unlink(log.name)
            if proc.returncode != 0:
                failed.append(f"{name}:\n{text}")
                continue
            if verbose and text.strip():
                print(f"[{name}]\n{text.strip()}")
            os.replace(tmp, out)
        time.sleep(0.01)
    if failed:
        raise RuntimeError("build failed for " + "\n".join(failed))
    return seconds


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if needed."""
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
