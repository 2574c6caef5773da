"""The surface the recognizer wrappers share (``TRBA``, ``TrOCR``):
``recognize_tensor``, ``recognize_u8``, ``predict`` and
``sequence_confidence``.

A wrapper sets ``model``, ``device``, ``dtype`` (its model's input dtype),
``max_length`` and ``eos_id``; defines ``_preprocess_one`` (an image → a
uint8 crop of the model's input size) and ``decode`` (ids → text); and
names its profiler region ``SPAN`` and its decode defaults. Its model's
``greedy(x, max_len)`` and ``beam(x, max_len, k, α, T)`` take normalised
images (``ops.image.normalize_u8``) → (logits (N, steps, V), tokens (N,
steps)), each in its own encode and decode regions.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..ops.image import normalize_u8
from ..utils.profiling import annotate


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


class Recognizer:
    SPAN: str
    BEAM_SIZE: int
    ALPHA = 0.9
    TEMPERATURE: float
    BATCH_SIZE: int

    @torch.inference_mode()
    def recognize_tensor(
        self,
        crops: torch.Tensor,
        mode: str = "beam",
        beam_size: Optional[int] = None,
        alpha: Optional[float] = None,
        temperature: Optional[float] = None,
        model: Optional[torch.nn.Module] = None,
        return_logits: bool = False,
    ) -> Tuple[torch.Tensor, ...]:
        """(N, H, W, 3) uint8 crops of the model's input size on its device →
        (token ids (N, steps), confidences (N,)), and with ``return_logits``
        the chosen path's logits (N, steps, V) (beam: temperature-scaled),
        on that device, enqueued on the current stream and not waited for.
        ``beam_size``, ``alpha``, ``temperature``: the wrapper's defaults
        where None. ``model``: a copy of the wrapper's model on the crops'
        device (a mesh's replica), else the wrapper's own. Profiler region
        ``SPAN`` (``trba.recognize``, ``trocr.recognize``) around the
        model's encode and decode."""
        if mode not in ("greedy", "beam"):
            raise ValueError(f"Unknown mode: {mode}")
        model = self.model if model is None else model
        with annotate(self.SPAN):
            x = normalize_u8(crops, self.dtype)
            if mode == "greedy":
                logits, preds = model.greedy(x, self.max_length)
            else:
                logits, preds = model.beam(
                    x, self.max_length, self.BEAM_SIZE if beam_size is None else beam_size,
                    self.ALPHA if alpha is None else alpha,
                    self.TEMPERATURE if temperature is None else temperature,
                )
            preds, conf = sequence_confidence(logits, preds, self.eos_id)
            return (preds, conf, logits) if return_logits else (preds, conf)

    def recognize_u8(
        self,
        crops: np.ndarray,
        mode: str = "beam",
        beam_size: Optional[int] = None,
        alpha: Optional[float] = None,
        temperature: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(N, H, W, 3) uint8 crops → (token ids (N, steps), confidences
        (N,)) as numpy."""
        x = torch.from_numpy(np.ascontiguousarray(crops)).to(self.device)
        preds, confs = self.recognize_tensor(x, mode, beam_size, alpha, temperature)
        return preds.cpu().numpy(), confs.cpu().numpy()

    def predict(
        self,
        images: Union[Any, List[Any]],
        batch_size: Optional[int] = None,
        mode: str = "beam",
        beam_size: Optional[int] = None,
        temperature: Optional[float] = None,
        alpha: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Recognize one image or a list (arrays, paths or PIL images) →
        [{"text", "confidence"}], ``batch_size`` crops per device pass (the
        wrapper's ``BATCH_SIZE`` where None). A short last chunk is not
        padded: each row's confidence depends on its own steps only."""
        if mode not in ("beam", "greedy"):
            raise ValueError(f"Unknown mode: {mode}")
        images = images if isinstance(images, list) else [images]
        step = max(1, self.BATCH_SIZE if batch_size is None else batch_size)
        results: List[Dict[str, Any]] = []
        for i in range(0, len(images), step):
            batch = np.stack([self._preprocess_one(im) for im in images[i : i + step]])
            preds, confs = self.recognize_u8(batch, mode, beam_size, alpha, temperature)
            results.extend(
                {"text": self.decode(p), "confidence": float(np.clip(c, 0.0, 1.0))}
                for p, c in zip(preds, confs)
            )
        return results
