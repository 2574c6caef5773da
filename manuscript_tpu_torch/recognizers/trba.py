"""TRBA recognizer wrapper (counterpart of ``manuscript_tpu/recognizers/trba.py``).

Weights, in this order: ``model_path`` (or its alias ``weights_path``);
the first ``.msgpack``, else ``.pth``, under ``~/.manuscript_tpu/trba``
(``MANUSCRIPT_TPU_CACHE``); the reference's released ``.pth`` and its
``config.json``, fetched into that cache on first use
(``utils/weights.fetch_artifact``; ``MANUSCRIPT_TPU_NO_DOWNLOAD=1`` turns the
fetch off). A flax ``.msgpack`` is read with the port's own reader, a
``.pth`` converted (``utils/convert.py``). With none of these, weights from
a seeded generator only when ``allow_random_init`` (by default
``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1``) allows them; else the constructor
raises. The model config (max_len,
hidden_size, img_h, img_w, cnn_stage_plan) comes from ``config_path``, else
from a sidecar ``<checkpoint>.json`` or ``config.json`` beside the
checkpoint, else from the checkpoint itself; the charset from
``charset_path``, else from the checkpoint, else the default one. The CNN
and BiLSTMs compute in ``dtype``; the decoder stays float32. ``save`` writes
the trainer's checkpoint layout, and ``TRBA.train`` is the trainer.
"""

from __future__ import annotations

import json
import os
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.trba import TRBAModel
from ..ops.image import read_image, resize_and_pad, to_rgb_u8
from ..utils.device import resolve_device
from ..utils.weights import (
    MissingWeightsError,
    allow_random_init_default,
    cached_checkpoint,
    fetch_artifact,
    init_random_,
    msgpack_restore,
    msgpack_serialize,
    params_from_jax,
    params_to_jax,
)
from .charset import (
    BLANK_TOKEN,
    EOS_TOKEN,
    PAD_TOKEN,
    SOS_TOKEN,
    decode_tokens,
    default_charset,
    load_charset,
)


def sequence_confidence(logits: torch.Tensor, preds: torch.Tensor, eos_id: int):
    """Mean exp(log-softmax at the predicted ids) over each row's steps up to
    and including its first EOS → (preds, conf (B,))."""
    log_probs = torch.log_softmax(logits, dim=-1)
    token_lp = torch.gather(log_probs, -1, preds[..., None])[..., 0]
    t = preds.shape[1]
    is_eos = preds == eos_id
    has_eos = is_eos.any(dim=1)
    first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
    upto = torch.where(has_eos, first_eos + 1, torch.full_like(first_eos, t))
    mask = torch.arange(t, device=preds.device)[None, :] < upto[:, None]
    conf = (torch.exp(token_lp) * mask).sum(dim=1) / upto.clamp_min(1)
    return preds, conf


def _config_beside(model_path: Union[str, Path]) -> Optional[Path]:
    """``<checkpoint>.json``, else ``config.json`` in its folder, if present."""
    wf = Path(model_path)
    return next((c for c in (wf.with_suffix(".json"), wf.parent / "config.json") if c.exists()), None)


class TRBA:
    def __init__(
        self,
        model_path: Optional[Union[str, Path]] = None,
        charset_path: Optional[Union[str, Path]] = None,
        config_path: Optional[Union[str, Path]] = None,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
        allow_random_init: Optional[bool] = None,
        seed: int = 0,
        max_length: int = 25,
        hidden_size: int = 256,
        img_h: int = 64,
        img_w: int = 256,
        cnn_stage_plan: Optional[str] = None,
        **kwargs: Any,
    ):
        """``max_length``, ``hidden_size``, ``img_h`` and ``img_w`` apply
        where the config has no value; ``cnn_stage_plan`` given here wins
        over the config ("full" where neither has one)."""
        self.device = resolve_device(device)
        weights_path = kwargs.pop("weights_path", None)
        if kwargs:
            raise TypeError(f"Unexpected keyword argument(s): {', '.join(kwargs)}")
        if weights_path is not None and model_path is not None:
            if os.path.abspath(os.fspath(weights_path)) != os.path.abspath(os.fspath(model_path)):
                raise ValueError("Provide either model_path or weights_path, not both.")
        model_path = model_path or weights_path
        if model_path is not None and not os.path.exists(model_path):
            raise FileNotFoundError(f"Model checkpoint not found: {model_path}")
        if model_path is None:
            model_path = cached_checkpoint("trba")
        if model_path is None:
            model_path = fetch_artifact("trba")
            if model_path is not None and config_path is None:
                config_path = fetch_artifact("trba_config")
        if allow_random_init is None:
            allow_random_init = allow_random_init_default()
        if model_path is None and not allow_random_init:
            raise MissingWeightsError(
                "TRBA found no checkpoint (none given, none in ~/.manuscript_tpu/trba, "
                "and the release could not be fetched): pass model_path=, or "
                "allow_random_init=True (or set MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1) "
                "for untrained weights"
            )
        if config_path is None and model_path is not None:
            config_path = _config_beside(model_path)
        if config_path is not None and not os.path.exists(config_path):
            raise FileNotFoundError(f"Config file not found: {config_path}")

        is_pth = model_path is not None and str(model_path).endswith(".pth")
        raw: Dict[str, Any] = (
            msgpack_restore(Path(model_path)) if model_path is not None and not is_pth else {}
        )
        if config_path is not None:
            config = json.loads(Path(config_path).read_text(encoding="utf-8"))
        else:
            config = raw.get("config") if isinstance(raw.get("config"), dict) else {}
        self.model_path = model_path
        self.config_path = config_path
        self.allow_random_init = allow_random_init
        self.max_length = config.get("max_len", max_length)
        self.hidden_size = config.get("hidden_size", hidden_size)
        self.img_h = config.get("img_h", img_h)
        self.img_w = config.get("img_w", img_w)
        self.cnn_stage_plan = cnn_stage_plan or config.get("cnn_stage_plan", "full")

        if charset_path is not None:
            if not os.path.exists(charset_path):
                raise FileNotFoundError(f"Charset file not found: {charset_path}")
            self.itos, stoi = load_charset(charset_path)
        else:
            itos = raw.get("itos")
            if isinstance(itos, dict):  # flax stores lists as {"0": ..., "1": ...}
                itos = [itos[key] for key in sorted(itos, key=int)]
            self.itos = [str(s) for s in itos] if itos is not None else default_charset()
            stoi = {s: i for i, s in enumerate(self.itos)}
        self.charset_path = charset_path
        self.pad_id, self.sos_id = stoi[PAD_TOKEN], stoi[SOS_TOKEN]
        self.eos_id, self.blank_id = stoi[EOS_TOKEN], stoi.get(BLANK_TOKEN)

        self.model = TRBAModel(
            len(self.itos), self.hidden_size, self.sos_id, self.eos_id,
            self.blank_id, self.cnn_stage_plan,
        )
        if is_pth:
            from ..utils.convert import convert_trba, load_torch_state_dict, merge_converted

            state = load_torch_state_dict(str(model_path))
            self.model.load_state_dict(
                merge_converted(self.model.state_dict(), convert_trba(state))
            )
        elif raw:
            self.model.load_state_dict(params_from_jax(raw))
        else:
            init_random_(self.model, seed)
        self.model.to(self.device).cast(dtype).eval()
        self.dtype = dtype

    def save(self, path: Union[str, Path]) -> None:
        """Write a self-describing flax ``.msgpack`` checkpoint (the model's
        variables, ``itos`` and the model config, the trainer's layout): the
        port's and the JAX package's ``TRBA(model_path=...)`` load it."""
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        payload = params_to_jax(self.model.state_dict())
        payload["itos"] = list(self.itos)
        payload["config"] = {
            "max_len": self.max_length, "hidden_size": self.hidden_size,
            "img_h": self.img_h, "img_w": self.img_w, "cnn_stage_plan": self.cnn_stage_plan,
        }
        Path(path).write_bytes(msgpack_serialize(payload))

    @staticmethod
    def train(*args, **kwargs):
        """Train a recognizer (``train/trba_train.train``; on the card unless
        ``device="cpu"``)."""
        from ..train.trba_train import train as _train

        return _train(*args, **kwargs)

    @torch.inference_mode()
    def recognize_tensor(
        self,
        crops: torch.Tensor,
        mode: str = "beam",
        beam_size: int = 8,
        alpha: float = 0.9,
        temperature: float = 1.7,
        model: Optional[TRBAModel] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(N, img_h, img_w, 3) uint8 crops on the model's device → (token ids
        (N, steps), confidences (N,)) on that device, enqueued on the current
        stream and not waited for. ``model``: a copy of the wrapper's model
        on the crops' device (a mesh's replica), else the wrapper's own."""
        if mode not in ("greedy", "beam"):
            raise ValueError(f"Unknown mode: {mode}")
        model = self.model if model is None else model
        x = (crops.to(self.dtype) / 255.0 - 0.5) / 0.5
        if mode == "greedy":
            logits, preds = model.greedy(x, self.max_length)
        else:
            logits, preds = model.beam(x, self.max_length, beam_size, alpha, temperature)
        return sequence_confidence(logits, preds, self.eos_id)

    def recognize_u8(
        self,
        crops: np.ndarray,
        mode: str = "beam",
        beam_size: int = 8,
        alpha: float = 0.9,
        temperature: float = 1.7,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(N, img_h, img_w, 3) uint8 crops → (token ids (N, steps),
        confidences (N,)) as numpy."""
        x = torch.from_numpy(np.ascontiguousarray(crops)).to(self.device)
        preds, confs = self.recognize_tensor(x, mode, beam_size, alpha, temperature)
        return preds.cpu().numpy(), confs.cpu().numpy()

    def decode(self, ids: Sequence[int]) -> str:
        return decode_tokens(ids, self.itos, self.pad_id, self.eos_id, self.blank_id)

    def _preprocess_one(self, image) -> np.ndarray:
        if isinstance(image, (str, Path)):
            if not os.path.exists(str(image)):
                raise FileNotFoundError(f"Image file not found: {image}")
            img = read_image(image)
        else:
            img = to_rgb_u8(np.asarray(read_image(image)))
        return resize_and_pad(img, self.img_h, self.img_w)

    def predict(
        self,
        images: Union[Any, List[Any]],
        batch_size: int = 32,
        mode: str = "beam",
        beam_size: int = 8,
        temperature: float = 1.7,
        alpha: float = 0.9,
    ) -> List[Dict[str, Any]]:
        """Recognize one image or a list (arrays, paths or PIL images) →
        [{"text", "confidence"}], ``batch_size`` crops per device pass. A
        short last chunk is not padded: each row's confidence depends on its
        own steps only."""
        if mode not in ("beam", "greedy"):
            raise ValueError(f"Unknown mode: {mode}")
        images = images if isinstance(images, list) else [images]
        results: List[Dict[str, Any]] = []
        for i in range(0, len(images), max(1, batch_size)):
            batch = np.stack([self._preprocess_one(im) for im in images[i : i + max(1, batch_size)]])
            preds, confs = self.recognize_u8(batch, mode, beam_size, alpha, temperature)
            results.extend(
                {"text": self.decode(p), "confidence": float(np.clip(c, 0.0, 1.0))}
                for p, c in zip(preds, confs)
            )
        return results
