"""TRBA recognizer wrapper (counterpart of ``manuscript_tpu/recognizers/trba.py``).

Loads a flax ``.msgpack`` checkpoint with the port's own reader — its
embedded charset (itos) and config (max_len, hidden_size, img_h, img_w,
cnn_stage_plan) are adopted — or, with ``allow_random_init=True``, fills the
model from a seeded generator. It never downloads anything. The CNN and
BiLSTMs compute in ``dtype``; the decoder stays float32.
"""

from __future__ import annotations

from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ..models.trba import TRBAModel
from ..ops.image import read_image, resize_and_pad, to_rgb_u8
from ..utils.device import resolve_device
from ..utils.weights import init_random_, msgpack_restore, params_from_jax
from .charset import BLANK_TOKEN, EOS_TOKEN, PAD_TOKEN, SOS_TOKEN, decode_tokens, default_charset


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


class TRBA:
    def __init__(
        self,
        model_path: Optional[Union[str, Path]] = None,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
        allow_random_init: bool = False,
        seed: int = 0,
        max_length: int = 25,
        hidden_size: int = 256,
        img_h: int = 64,
        img_w: int = 256,
        cnn_stage_plan: str = "full",
    ):
        self.device = resolve_device(device)
        raw: Dict[str, Any] = {}
        if model_path is not None:
            raw = msgpack_restore(Path(model_path))
        elif not allow_random_init:
            raise ValueError(
                "TRBA needs model_path=, or allow_random_init=True for untrained weights"
            )
        config = raw.get("config") or {}
        self.model_path = model_path
        self.max_length = config.get("max_len", max_length)
        self.hidden_size = config.get("hidden_size", hidden_size)
        self.img_h = config.get("img_h", img_h)
        self.img_w = config.get("img_w", img_w)
        self.cnn_stage_plan = config.get("cnn_stage_plan", cnn_stage_plan)
        itos = raw.get("itos")
        if isinstance(itos, dict):  # flax stores lists as {"0": ..., "1": ...}
            itos = [itos[key] for key in sorted(itos, key=int)]
        self.itos = [str(s) for s in itos] if itos is not None else default_charset()
        stoi = {s: i for i, s in enumerate(self.itos)}
        self.pad_id, self.sos_id = stoi[PAD_TOKEN], stoi[SOS_TOKEN]
        self.eos_id, self.blank_id = stoi[EOS_TOKEN], stoi.get(BLANK_TOKEN)

        self.model = TRBAModel(
            len(self.itos), self.hidden_size, self.sos_id, self.eos_id,
            self.blank_id, self.cnn_stage_plan,
        )
        if raw:
            self.model.load_state_dict(params_from_jax(raw))
        else:
            init_random_(self.model, seed)
        self.model.to(self.device).cast(dtype).eval()
        self.dtype = dtype

    @torch.inference_mode()
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
        if mode not in ("greedy", "beam"):
            raise ValueError(f"Unknown mode: {mode}")
        x = torch.from_numpy(np.ascontiguousarray(crops)).to(self.device)
        x = (x.to(self.dtype) / 255.0 - 0.5) / 0.5
        if mode == "greedy":
            logits, preds = self.model.greedy(x, self.max_length)
        else:
            logits, preds = self.model.beam(x, self.max_length, beam_size, alpha, temperature)
        preds, confs = sequence_confidence(logits, preds, self.eos_id)
        return preds.cpu().numpy(), confs.cpu().numpy()

    def decode(self, ids: Sequence[int]) -> str:
        return decode_tokens(ids, self.itos, self.pad_id, self.eos_id, self.blank_id)

    def predict(self, images: Union[Any, List[Any]], mode: str = "beam", **decode) -> List[Dict]:
        """Recognize one image or a list → [{"text", "confidence"}]."""
        images = images if isinstance(images, list) else [images]
        if not images:
            return []
        batch = np.stack([
            resize_and_pad(to_rgb_u8(read_image(im)), self.img_h, self.img_w) for im in images
        ])
        preds, confs = self.recognize_u8(batch, mode, **decode)
        return [
            {"text": self.decode(p), "confidence": float(np.clip(c, 0.0, 1.0))}
            for p, c in zip(preds, confs)
        ]
