"""The reference's torch checkpoints → the port's models (counterpart of
``manuscript_tpu/utils/convert.py``): the released ``east_quad_23_05.pth``
and ``trba_exp_1_64.pth``, and any ``.pth`` of the reference's layout.

``convert_east``/``convert_trba`` build the flax-layout variable tree
exactly as the JAX converters do (conv (O, I, kh, kw) → (kh, kw, I, O),
linear (O, I) → (I, O), an LSTM's two biases folded into one,
BatchNorm weight/bias/running_mean/running_var → scale/bias/mean/var), and
``merge_converted`` overlays that tree on a model's state dict through
``utils/weights.params_to_jax``/``params_from_jax``: the flax ⇄ torch layout
rules stay in that one place. As in the JAX package, the loader accepts a
raw state dict or one under ``model_state``/``state_dict``/``model``, strips
``module.``/``model.`` prefixes, and a leaf whose shape differs from the
model's keeps the model's value and is reported.
"""

from __future__ import annotations

import os
import warnings
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..models.resnet import STAGE_BLOCKS
from .weights import params_from_jax, params_to_jax

# SEResNet31 stage plan of the reference: (planes, blocks, stride)
SERESNET_PLAN = [(256, 1, 2), (256, 2, 1), (512, 5, 2), (512, 3, 1)]


def load_torch_state_dict(path: str) -> Dict[str, np.ndarray]:
    """A ``.pth`` file → a flat {key: np.ndarray} dict on the CPU.

    ``torch.load(weights_only=True)`` refuses pickled objects other than
    tensors and plain containers; a checkpoint that embeds other payloads
    (configs, schedulers) loads only with ``MANUSCRIPT_TPU_UNSAFE_LOAD=1``,
    since full unpickling runs code from the file."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:
        if os.environ.get("MANUSCRIPT_TPU_UNSAFE_LOAD") != "1":
            raise RuntimeError(
                f"{path} is not loadable with weights_only=True ({exc}). "
                "If you trust this checkpoint, set MANUSCRIPT_TPU_UNSAFE_LOAD=1 "
                "to allow full unpickling (this can execute code from the file)."
            ) from exc
        warnings.warn(
            f"Loading {path} with weights_only=False (MANUSCRIPT_TPU_UNSAFE_LOAD=1): "
            "unpickling can execute arbitrary code from the checkpoint."
        )
        ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict):
        for key in ("model_state", "state_dict", "model"):
            if key in ckpt and isinstance(ckpt[key], dict):
                ckpt = ckpt[key]
                break
    out = {}
    for k, v in ckpt.items():
        if hasattr(v, "detach"):
            for prefix in ("module.", "model."):
                if k.startswith(prefix):
                    k = k[len(prefix):]
            out[k] = v.detach().cpu().numpy()
    return out


def _conv(w: np.ndarray) -> np.ndarray:
    return np.transpose(w, (2, 3, 1, 0))


class _TreeBuilder:
    """Collects params/batch_stats leaves from the keys of a state dict; a
    key the state dict lacks leaves its leaf out."""

    def __init__(self, state: Dict[str, np.ndarray]):
        self.state = dict(state)
        self.params: Dict[str, Any] = {}
        self.batch_stats: Dict[str, Any] = {}

    def take(self, key: str) -> Optional[np.ndarray]:
        return self.state.pop(key, None)

    def put(self, tree: Dict, path: Tuple[str, ...], value) -> None:
        if value is None:
            return
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.asarray(value)

    def linear_kernel(self, key: str, path: Tuple[str, ...]) -> None:
        w = self.take(key)
        self.put(self.params, path, None if w is None else np.transpose(w))

    def conv(self, tkey: str, path: Tuple[str, ...], bias: bool = False) -> None:
        w = self.take(f"{tkey}.weight")
        self.put(self.params, path + ("kernel",), None if w is None else _conv(w))
        if bias:
            self.put(self.params, path + ("bias",), self.take(f"{tkey}.bias"))

    def linear(self, tkey: str, path: Tuple[str, ...], bias: bool = True) -> None:
        self.linear_kernel(f"{tkey}.weight", path + ("kernel",))
        if bias:
            self.put(self.params, path + ("bias",), self.take(f"{tkey}.bias"))

    def bn(self, tkey: str, path: Tuple[str, ...]) -> None:
        self.put(self.params, path + ("scale",), self.take(f"{tkey}.weight"))
        self.put(self.params, path + ("bias",), self.take(f"{tkey}.bias"))
        self.put(self.batch_stats, path + ("mean",), self.take(f"{tkey}.running_mean"))
        self.put(self.batch_stats, path + ("var",), self.take(f"{tkey}.running_var"))
        self.state.pop(f"{tkey}.num_batches_tracked", None)

    def lstm(self, tkey: str, path: Tuple[str, ...], prefix: str, suffix: Optional[str] = "") -> None:
        """One torch LSTM (a direction of an ``nn.LSTM`` layer with ``_l0``
        names, or an ``nn.LSTMCell`` with ``suffix=None``) → fused params."""
        tail = "" if suffix is None else f"_l0{suffix}"
        self.linear_kernel(f"{tkey}.weight_ih{tail}", path + (f"{prefix}_kernel_ih",))
        self.linear_kernel(f"{tkey}.weight_hh{tail}", path + (f"{prefix}_kernel_hh",))
        b_ih, b_hh = self.take(f"{tkey}.bias_ih{tail}"), self.take(f"{tkey}.bias_hh{tail}")
        if b_ih is not None and b_hh is not None:
            self.put(self.params, path + (f"{prefix}_bias",), b_ih + b_hh)

    def variables(self) -> Dict[str, Any]:
        return {"params": self.params, "batch_stats": self.batch_stats}


def convert_east(state: Dict[str, np.ndarray], backbone: str = "resnet50") -> Dict[str, Any]:
    """The reference's EAST state dict → flax-layout variables of
    ``EASTModel(backbone)``."""
    tb = _TreeBuilder(state)
    bb = "backbone.extractor"
    tb.conv(f"{bb}.conv1", ("backbone", "conv1"))
    tb.bn(f"{bb}.bn1", ("backbone", "bn1"))
    for stage_idx, n_blocks in enumerate(STAGE_BLOCKS[backbone], start=1):
        for b in range(n_blocks):
            src, dst = f"{bb}.layer{stage_idx}.{b}", ("backbone", f"layer{stage_idx}_{b}")
            for i in (1, 2, 3):
                tb.conv(f"{src}.conv{i}", dst + (f"conv{i}",))
                tb.bn(f"{src}.bn{i}", dst + (f"bn{i}",))
            if b == 0:
                tb.conv(f"{src}.downsample.0", dst + ("down_conv",))
                tb.bn(f"{src}.downsample.1", dst + ("down_bn",))
    for n in range(1, 5):
        src, dst = f"decoder.block{n}", ("decoder", f"block{n}")
        tb.conv(f"{src}.conv1x1.0", dst + ("conv1x1",), bias=True)
        tb.bn(f"{src}.conv1x1.1", dst + ("bn1",))
        tb.conv(f"{src}.conv3x3.0", dst + ("conv3x3",), bias=True)
        tb.bn(f"{src}.conv3x3.1", dst + ("bn2",))
    tb.conv("output_head.score_map", ("score_head",), bias=True)
    tb.conv("output_head.geo_map", ("geo_head",), bias=True)
    return tb.variables()


def convert_trba(state: Dict[str, np.ndarray]) -> Dict[str, Any]:
    """The reference's TRBA state dict → flax-layout variables of
    ``TRBAModel`` (the full SEResNet31 plan; a shallower model takes the
    blocks it has)."""
    tb = _TreeBuilder(state)
    # SEResNet31 stem (torch Sequential indices 0, 1, 3, 4)
    tb.conv("cnn.conv0.0", ("cnn", "stem_conv1"))
    tb.bn("cnn.conv0.1", ("cnn", "stem_bn1"))
    tb.conv("cnn.conv0.3", ("cnn", "stem_conv2"))
    tb.bn("cnn.conv0.4", ("cnn", "stem_bn2"))
    in_planes = 128
    for stage_idx, (planes, blocks, stride) in enumerate(SERESNET_PLAN, start=1):
        for b in range(blocks):
            src, dst = f"cnn.layer{stage_idx}.{b}", ("cnn", f"layer{stage_idx}_{b}")
            tb.conv(f"{src}.conv1", dst + ("conv1",))
            tb.bn(f"{src}.bn1", dst + ("bn1",))
            tb.conv(f"{src}.conv2", dst + ("conv2",))
            tb.bn(f"{src}.bn2", dst + ("bn2",))
            tb.linear(f"{src}.se.fc.0", dst + ("se", "fc1"), bias=False)
            tb.linear(f"{src}.se.fc.2", dst + ("se", "fc2"), bias=False)
            if b == 0 and (stride != 1 or in_planes != planes):
                tb.conv(f"{src}.downsample.0", dst + ("down_conv",))
                tb.bn(f"{src}.downsample.1", dst + ("down_bn",))
        in_planes = planes
    tb.conv("cnn.conv_out.0", ("cnn", "out_conv1"))
    tb.bn("cnn.conv_out.1", ("cnn", "out_bn1"))
    tb.conv("cnn.conv_out.3", ("cnn", "out_conv2"))
    tb.bn("cnn.conv_out.4", ("cnn", "out_bn2"))

    for i in (0, 1):  # encoder BiLSTMs (torch enc_rnn.0 / enc_rnn.1)
        dst = (f"enc_rnn{i + 1}",)
        tb.lstm(f"enc_rnn.{i}.rnn", dst, "fwd")
        tb.lstm(f"enc_rnn.{i}.rnn", dst, "bwd", suffix="_reverse")
        tb.linear(f"enc_rnn.{i}.linear", dst + ("proj",))

    d, cell = ("decoder",), "attn.attention_cell"
    tb.linear_kernel(f"{cell}.i2h.weight", d + ("i2h_kernel",))
    tb.linear_kernel(f"{cell}.h2h.weight", d + ("h2h_kernel",))
    tb.put(tb.params, d + ("h2h_bias",), tb.take(f"{cell}.h2h.bias"))
    tb.linear_kernel(f"{cell}.score.weight", d + ("score_kernel",))
    tb.lstm(f"{cell}.rnn", d, "lstm", suffix=None)
    tb.linear_kernel("attn.generator.weight", d + ("gen_kernel",))
    tb.put(tb.params, d + ("gen_bias",), tb.take("attn.generator.bias"))
    return tb.variables()


def merge_converted(
    state_dict: Dict[str, torch.Tensor], converted: Dict[str, Any], verbose: bool = True
) -> Dict[str, torch.Tensor]:
    """Overlay converted leaves on a model's ``state_dict()`` → a state dict
    for ``load_state_dict``. A converted leaf whose shape differs from the
    model's keeps the model's value (strict=False semantics) and is reported
    by its flax path; leaves the model lacks are ignored. Prints the JAX
    package's lines: "skipped N shape-mismatched tensors" and "loaded N
    tensors"."""
    init = params_to_jax(state_dict)
    skipped, loaded = [], 0

    def overlay(init_node, conv_node, path=()):
        nonlocal loaded
        out = {}
        for k, v in init_node.items():
            if isinstance(v, dict):
                out[k] = overlay(v, conv_node.get(k, {}), path + (k,))
                continue
            cv = conv_node.get(k) if isinstance(conv_node, dict) else None
            if cv is not None and tuple(np.shape(cv)) == tuple(v.shape):
                loaded += 1
                out[k] = np.asarray(cv, dtype=v.dtype)
            else:
                if cv is not None:
                    skipped.append("/".join(path + (k,)))
                out[k] = v
        return out

    merged = {col: overlay(init[col], converted.get(col, {})) for col in init}
    if verbose and skipped:
        print(f"[convert] skipped {len(skipped)} shape-mismatched tensors: "
              f"{skipped[:5]}{'…' if len(skipped) > 5 else ''}")
    if verbose:
        print(f"[convert] loaded {loaded} tensors")
    return {k: v.to(state_dict[k].dtype) for k, v in params_from_jax(merged).items()}
