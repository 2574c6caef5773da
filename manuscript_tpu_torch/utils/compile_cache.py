"""Persistent kernel build cache — one switch for every entry point
(counterpart of ``manuscript_tpu/utils/compile_cache.py``).

The port compiles nothing but its hand-written kernels: ``ops/_build.py``
runs ``nvcc`` (and the host C++ compiler for the LANMS) at first use, a few
seconds a source, into ``build/kernels/`` of the checkout. A host that runs
several checkouts, or a container whose checkout is new at every start,
points all of them at one directory here, and a process that finds its
libraries there starts without compiling. Each library's file name carries
the digest of its source and flags, so a stale library is never loaded from
a shared cache.

Resolution order, as in the JAX module:

1. ``MANUSCRIPT_TPU_KERNEL_CACHE``, if set — always wins.
2. ``default_dir``, if given.
3. Otherwise nothing changes, and the kernels stay in ``build/kernels/``.

The CLI (``python -m manuscript_tpu_torch ...``) and the bench call
``enable_compile_cache(None)`` first.
"""

from __future__ import annotations

import os
import tempfile
import warnings
from pathlib import Path
from typing import Optional

ENV = "MANUSCRIPT_TPU_KERNEL_CACHE"


def enable_compile_cache(default_dir: Optional[str] = None) -> Optional[str]:
    """Point the kernel build at a persistent directory. Returns the
    directory enabled, or ``None`` when none was resolved (see the module
    docstring) or the resolved one cannot be written, which warns. Safe to
    call more than once; the last call that resolves a directory wins."""
    cache_dir = os.environ.get(ENV) or default_dir
    if not cache_dir:
        return None
    from ..ops import _build

    try:
        Path(cache_dir).mkdir(parents=True, exist_ok=True)
        with tempfile.NamedTemporaryFile(dir=cache_dir):
            pass
    except OSError as exc:
        # a host that SET a cache but cannot use it would silently rebuild
        # every kernel at every start: make it observable
        warnings.warn(
            f"persistent kernel cache disabled ({cache_dir}): {type(exc).__name__}: {exc}",
            RuntimeWarning,
            stacklevel=2,
        )
        return None
    _build.cache_dir = Path(cache_dir)
    return str(cache_dir)
