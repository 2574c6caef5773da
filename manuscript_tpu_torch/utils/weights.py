"""Weights for the port: the flax checkpoint reader and writer, the flax ⇄
torch conversion, and seeded random init.

* ``msgpack_restore`` decodes a flax ``.msgpack`` checkpoint with a small
  MessagePack reader of its own: nil, bool, ints, floats, str, bin, arrays,
  maps, and the ext types flax writes for arrays (1, an ndarray as
  ``[shape, dtype name, bytes]``) and numpy scalars (3).
* ``msgpack_serialize`` is the writer: nested dicts (lists and tuples
  become {"0": ..., "1": ...} maps, as flax's ``to_state_dict`` makes them),
  numpy arrays and torch tensors as flax's ndarray ext type, numpy scalars
  as its scalar ext type, and plain ints, floats, strings, bools and None,
  so that ``flax.serialization.msgpack_restore`` reads the bytes back.
* ``params_from_jax`` turns a flax variable tree ({"params", "batch_stats"} of
  nested dicts of numpy arrays) into the port's state dict: conv kernels HWIO
  → OIHW, Dense kernels transposed, BatchNorm scale/bias/mean/var →
  weight/bias/running_mean/running_var. The LSTM and decoder parameters keep
  their flax names and layouts ((in, 4H) kernels, gates i,f,g,o, one folded
  bias), so the port computes the same sums. ``params_to_jax`` is its
  inverse.
* ``init_random_`` fills a model from a seeded ``torch.Generator`` (LeCun
  normal kernels, zero biases, identity BatchNorm) — the full-width models
  have no trained weights in the repository.
* ``cached_checkpoint`` finds a ``.msgpack`` checkpoint in the user's cache
  (``~/.manuscript_tpu/<name>``), and ``allow_random_init_default`` reads
  ``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT``; nothing is ever downloaded.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import Any, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        out = self.data[self.pos : self.pos + n]
        if len(out) != n:
            raise ValueError("truncated msgpack data")
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> Any:
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(self.unpack(">b"), bytes(self.take(n)))
        fixed = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fixed:
            return self.unpack(fixed[b])
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):  # fixext 1..16
            code = self.unpack(">b")
            return self.ext(code, bytes(self.take(1 << (b - 0xD4))))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            n = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return str(self.take(n), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def array(self, n: int):
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    @staticmethod
    def ext(code: int, payload: bytes):
        if code in (1, 3):  # flax ndarray / numpy scalar
            shape, dtype, buf = _Reader(payload).value()
            if isinstance(dtype, bytes):
                dtype = dtype.decode()
            arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr[()] if code == 3 else arr
        raise ValueError(f"unsupported msgpack ext type {code}")


def msgpack_restore(data: Union[bytes, str, Path]) -> Any:
    """Decode a flax ``.msgpack`` checkpoint (bytes or a path) into nested
    dicts of numpy arrays."""
    if not isinstance(data, (bytes, bytearray)):
        data = Path(data).read_bytes()
    reader = _Reader(bytes(data))
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return out


class _Writer:
    def __init__(self):
        self.out = bytearray()

    def head(self, small: Optional[int], codes: Tuple[int, int, int], n: int, fix_max: int) -> None:
        """A length header: ``small | n`` up to ``fix_max``, else the 8-, 16-
        or 32-bit form (``codes``; None where the type has no such form)."""
        if small is not None and n <= fix_max:
            self.out.append(small | n)
        elif codes[0] is not None and n < 1 << 8:
            self.out += struct.pack(">BB", codes[0], n)
        elif n < 1 << 16:
            self.out += struct.pack(">BH", codes[1], n)
        else:
            self.out += struct.pack(">BI", codes[2], n)

    def value(self, v: Any) -> None:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        if v is None:
            self.out.append(0xC0)
        elif isinstance(v, (bool, np.bool_)) and not isinstance(v, np.ndarray):
            self.out.append(0xC3 if v else 0xC2)
        elif isinstance(v, int):
            self.int(v)
        elif isinstance(v, float):
            self.out += struct.pack(">Bd", 0xCB, v)
        elif isinstance(v, str):
            raw = v.encode("utf-8")
            self.head(0xA0, (0xD9, 0xDA, 0xDB), len(raw), 31)
            self.out += raw
        elif isinstance(v, (bytes, bytearray)):
            self.head(None, (0xC4, 0xC5, 0xC6), len(v), 0)
            self.out += v
        elif isinstance(v, np.ndarray):
            self.ext(1, v)
        elif isinstance(v, np.generic):
            self.ext(3, np.asarray(v))
        elif isinstance(v, dict):
            self.head(0x80, (None, 0xDE, 0xDF), len(v), 15)
            for k, x in v.items():
                self.value(str(k))
                self.value(x)
        elif isinstance(v, (list, tuple)):
            self.value({str(i): x for i, x in enumerate(v)})
        else:
            raise TypeError(f"msgpack_serialize: cannot write {type(v).__name__}")

    def int(self, v: int) -> None:
        if 0 <= v <= 0x7F or -32 <= v < 0:
            self.out += struct.pack(">b" if v < 0 else ">B", v)
        elif v >= 0:
            for code, fmt, lim in ((0xCC, ">B", 8), (0xCD, ">H", 16), (0xCE, ">I", 32), (0xCF, ">Q", 64)):
                if v < 1 << lim:
                    self.out += struct.pack(">B", code) + struct.pack(fmt, v)
                    return
            raise OverflowError(v)
        else:
            for code, fmt, lim in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31), (0xD3, ">q", 63)):
                if v >= -(1 << lim):
                    self.out += struct.pack(">B", code) + struct.pack(fmt, v)
                    return
            raise OverflowError(v)

    def ext(self, code: int, arr: np.ndarray) -> None:
        if arr.dtype.hasobject or arr.dtype.fields is not None:
            raise TypeError(f"msgpack_serialize: cannot write arrays of {arr.dtype}")
        if arr.nbytes > 1 << 30:
            raise ValueError("msgpack_serialize: arrays over 1 GiB are not supported")
        # (shape, dtype name, bytes) as a msgpack array, as flax packs it
        payload = _ndarray_payload(arr)
        n = len(payload)
        fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
        if n in fixed:
            self.out += struct.pack(">Bb", fixed[n], code)
        elif n < 1 << 8:
            self.out += struct.pack(">BBb", 0xC7, n, code)
        elif n < 1 << 16:
            self.out += struct.pack(">BHb", 0xC8, n, code)
        else:
            self.out += struct.pack(">BIb", 0xC9, n, code)
        self.out += payload


def _ndarray_payload(arr: np.ndarray) -> bytes:
    """The ndarray ext payload: the msgpack array [shape, dtype name, bytes]."""
    w = _Writer()
    w.head(0x90, (None, 0xDC, 0xDD), 3, 15)
    w.head(0x90, (None, 0xDC, 0xDD), arr.ndim, 15)
    for n in arr.shape:
        w.int(int(n))
    w.value(arr.dtype.name)
    w.value(np.ascontiguousarray(arr).tobytes())
    return bytes(w.out)


def msgpack_serialize(tree: Any) -> bytes:
    """Encode nested dicts of arrays (numpy or torch), numpy scalars and plain
    values as flax ``to_bytes`` does; ``msgpack_restore`` here and in flax
    read the bytes back."""
    w = _Writer()
    w.value(tree)
    return bytes(w.out)


def _walk(tree: Dict, prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _walk(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


_BN_STATS = {"mean": "running_mean", "var": "running_var"}


def params_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """Flax variables {"params": ..., "batch_stats": ...} → the port's state
    dict (other top-level keys, such as a checkpoint's itos, are ignored)."""
    out: Dict[str, torch.Tensor] = {}
    for path, arr in _walk(tree.get("params", {})):
        *mods, leaf = path
        if leaf == "kernel" and arr.ndim == 4:  # conv HWIO → OIHW
            leaf, arr = "weight", arr.transpose(3, 2, 0, 1)
        elif leaf == "kernel" and arr.ndim == 2:  # Dense (in, out) → (out, in)
            leaf, arr = "weight", arr.T
        elif leaf == "scale":  # BatchNorm
            leaf = "weight"
        out[".".join(mods + [leaf])] = torch.from_numpy(
            np.array(arr, dtype=np.float32)
        )
    for path, arr in _walk(tree.get("batch_stats", {})):
        *mods, leaf = path
        out[".".join(mods + [_BN_STATS[leaf]])] = torch.from_numpy(
            np.array(arr, dtype=np.float32)
        )
    return out


_BN_LEAVES = {v: k for k, v in _BN_STATS.items()}


def params_to_jax(state: Dict[str, torch.Tensor]) -> Dict[str, Dict]:
    """The port's state dict → flax variables {"params": ..., "batch_stats":
    ...} of nested dicts of float32 numpy arrays: the inverse of
    ``params_from_jax`` (OIHW conv weights → HWIO kernels, Linear weights →
    transposed kernels, BatchNorm weight → scale, running statistics →
    batch_stats)."""
    out: Dict[str, Dict] = {"params": {}, "batch_stats": {}}
    for name, t in state.items():
        *mods, leaf = name.split(".")
        arr = t.detach().float().cpu().numpy()
        if leaf in _BN_LEAVES:
            group, leaf = "batch_stats", _BN_LEAVES[leaf]
        else:
            group = "params"
            if leaf == "weight" and arr.ndim == 4:
                leaf, arr = "kernel", arr.transpose(2, 3, 1, 0)
            elif leaf == "weight" and arr.ndim == 2:
                leaf, arr = "kernel", arr.T
            elif leaf == "weight":
                leaf = "scale"
        node = out[group]
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.ascontiguousarray(arr, dtype=np.float32)
    return out


@torch.no_grad()
def init_random_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Seeded random init in place: LeCun-normal convs, linears and flax-named
    ``*kernel*`` parameters (std 1/√fan_in), zero biases, BatchNorm as the
    identity."""
    gen = torch.Generator(device="cpu").manual_seed(seed)
    for name, t in sorted(model.state_dict().items()):
        leaf = name.rsplit(".", 1)[-1]
        if leaf == "running_var" or (leaf == "weight" and t.dim() == 1):
            val = torch.ones(t.shape)
        elif leaf == "running_mean" or "bias" in leaf:
            val = torch.zeros(t.shape)
        else:
            if leaf == "weight":  # (out, in, ...) torch layout
                fan_in = int(np.prod(t.shape[1:]))
            else:  # flax-named (in, out) kernel
                fan_in = t.shape[0]
            val = torch.randn(t.shape, generator=gen) / np.sqrt(fan_in)
        t.copy_(val.to(t.dtype))
    return model


def cached_checkpoint(name: str) -> Optional[Path]:
    """The first ``*.msgpack`` (sorted, subfolders included) under
    ``~/.manuscript_tpu/<name>``, or None."""
    cache = Path.home() / ".manuscript_tpu" / name
    hits = sorted(cache.glob("**/*.msgpack")) if cache.exists() else []
    return hits[0] if hits else None


def allow_random_init_default() -> bool:
    """Whether a wrapper given no checkpoint, and finding none in the cache,
    may fill its model with random weights: only when
    MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1, so that a user gets an error rather
    than plausible-looking garbage."""
    return os.environ.get("MANUSCRIPT_TPU_ALLOW_RANDOM_INIT") == "1"
