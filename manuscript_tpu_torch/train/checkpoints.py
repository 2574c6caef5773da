"""Checkpoint files (counterpart of ``manuscript_tpu/train/checkpoints.py``).

The trainers write flax ``.msgpack`` files through
``utils.weights.msgpack_serialize``, so their weights load in the port and in
the JAX package alike. ``OrbaxCheckpointer`` keeps the JAX class's name and
API — ``save(step, state)``, ``restore(template, step=None)``,
``latest_step``, ``all_steps``, ``close`` and retention of the newest
``max_to_keep`` — as a manager of plain files: step ``s`` is
``<directory>/<s>/state.msgpack``. There is no orbax behind it, nor async
saves; ``wait`` is accepted and ignored.
"""

from __future__ import annotations

import shutil
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..utils.weights import msgpack_restore, msgpack_serialize


def restore_tree(template: Any, blob: Any) -> Any:
    """``blob`` (msgpack-restored) in the structure of ``template``: dicts
    with the same keys, arrays and tensors of the same shapes (tensors come
    back as tensors on the template's device), lists and tuples from their
    {"0": ...} maps, scalars converted to the template's type."""
    if isinstance(template, dict):
        if not isinstance(blob, dict) or set(map(str, template)) != set(blob):
            raise ValueError("checkpoint keys differ from the template's")
        return {k: restore_tree(v, blob[str(k)]) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        items = [restore_tree(v, blob[str(i)]) for i, v in enumerate(template)]
        return type(template)(items)
    if isinstance(template, torch.Tensor):
        arr = np.asarray(blob)
        if tuple(arr.shape) != tuple(template.shape):
            raise ValueError(f"checkpoint shape {arr.shape} vs {tuple(template.shape)}")
        return torch.from_numpy(np.array(arr)).to(template.device, template.dtype)
    if isinstance(template, np.ndarray):
        arr = np.asarray(blob)
        if arr.shape != template.shape:
            raise ValueError(f"checkpoint shape {arr.shape} vs {template.shape}")
        return arr.astype(template.dtype)
    if isinstance(template, (bool, int, float)):
        return type(template)(np.asarray(blob))
    return blob


class OrbaxCheckpointer:
    """Step-indexed checkpoint manager over plain msgpack files."""

    def __init__(self, directory: str, max_to_keep: int = 3):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, step: int) -> Path:
        return self.directory / str(step) / "state.msgpack"

    def save(self, step: int, state: Dict[str, Any], wait: bool = False) -> None:
        path = self._path(step)
        path.parent.mkdir(parents=True, exist_ok=True)
        tmp = path.with_suffix(".tmp")
        tmp.write_bytes(msgpack_serialize(state))
        tmp.replace(path)
        for old in self.all_steps()[: -self.max_to_keep or None]:
            shutil.rmtree(self.directory / str(old), ignore_errors=True)

    def restore(self, template: Dict[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return restore_tree(template, msgpack_restore(self._path(step)))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        return sorted(int(d.name) for d in self.directory.iterdir()
                      if d.name.isdigit() and (d / "state.msgpack").exists())

    def close(self) -> None:
        pass
