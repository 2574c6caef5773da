"""The import guard: the JAX package and JAX itself never load in a run.

Modules are compared by their top-level name, the part before the first
dot, whole: ``manuscript_tpu_torch`` is the port and passes, ``manuscript_tpu``
is the JAX package and fails."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "manuscript_tpu")


def forbidden_loaded(names: Iterable[str] = None) -> List[str]:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    names = list(sys.modules) if names is None else list(names)
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)
