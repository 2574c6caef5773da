"""TrOCR recognizer wrapper: ``microsoft/trocr-base-handwritten``'s
architecture (``models/trocr.py``) behind the recognizers' shared surface
(``recognizers/base.Recognizer``, with this wrapper's defaults), so that
``Pipeline(recognizer=TrOCR(...))`` reads each word or line with it on the
classic route.

Weights: ``model_path``, a ``torch.save``d state dict named as Hugging
Face's ``VisionEncoderDecoderModel`` names it (the checkpoint's
``pytorch_model.bin``; the tied ``decoder.output_projection.weight`` is the
token embedding and is dropped), or such a dict itself. With none, weights
from a seeded generator on the device only when ``allow_random_init`` (by default
``MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1``) allows them; else the constructor
raises. The repository holds neither the published weights nor RoBERTa's
byte-level BPE tables (``vocab.json``, ``merges.txt``), so ``decode`` maps
ids through a stand-in table of the vocabulary's width (``stand_in_vocab``).

A line image is resized to the model's square input (``image_size``²,
bilinear, antialiased, the port's ``resize_bilinear``) and normalised as
(x/255 − 0.5)/0.5, as TrOCR's processor does. The model computes in
``dtype``; the beam's scores and the confidences are float32.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from ..models.trocr import TrOCRConfig, TrOCRModel
from ..ops.image import read_image, resize_bilinear, to_rgb_u8
from ..utils.device import resolve_device
from ..utils.weights import MissingWeightsError, allow_random_init_default
from .base import Recognizer

SPECIALS = ("<s>", "<pad>", "</s>", "<unk>")  # RoBERTa's ids 0-3


def stand_in_vocab(size: int) -> List[str]:
    """A stand-in for the BPE vocabulary: RoBERTa's four special tokens at
    ids 0-3, then id i the base-95 digits of i − 4 over printable ASCII,
    least significant first (ids 4-98 are one character each)."""
    out = list(SPECIALS[:size])
    for i in range(len(out), size):
        n, s = i - len(SPECIALS), ""
        while True:
            s += chr(32 + n % 95)
            n //= 95
            if not n:
                break
        out.append(s)
    return out


def init_random_(model: TrOCRModel, seed: int) -> TrOCRModel:
    """Seeded weights on the model's device: matrices and the patch kernel
    N(0, 1/fan_in), embeddings, the CLS token and the positions N(0, 0.02²)
    (the checkpoint's ``init_std``), LayerNorms the identity, biases zero."""
    gen = torch.Generator(device=next(model.parameters()).device).manual_seed(seed)
    with torch.no_grad():
        for name, p in sorted(model.named_parameters()):
            if p.dim() == 1:
                p.fill_(1.0 if "norm" in name and name.endswith("weight") else 0.0)
            elif name.endswith(("cls_token", "position_embeddings", "embed_tokens.weight",
                                "embed_positions.weight")):
                p.normal_(0.0, 0.02, generator=gen)
            else:
                p.normal_(0.0, p[0].numel() ** -0.5, generator=gen)
    return model


def load_state(model: TrOCRModel, src: Union[str, Path, Mapping[str, torch.Tensor]]) -> None:
    """A checkpoint by Hugging Face's names into ``model``: its file, or the
    state dict itself."""
    state = (dict(src) if isinstance(src, Mapping)
             else torch.load(str(src), map_location="cpu", weights_only=True))
    state.pop("decoder.output_projection.weight", None)
    model.load_state_dict(state)


class TrOCR(Recognizer):
    SPAN = "trocr.recognize"
    BEAM_SIZE, TEMPERATURE, BATCH_SIZE = 4, 1.0, 16

    def __init__(
        self,
        model_path: Optional[Union[str, Path, Mapping[str, torch.Tensor]]] = None,
        device: Optional[Union[str, torch.device]] = None,
        dtype: torch.dtype = torch.float32,
        allow_random_init: Optional[bool] = None,
        seed: int = 0,
        max_length: int = 32,
        config: Optional[TrOCRConfig] = None,
    ):
        """``config`` the widths (the published ones by default);
        ``max_length`` the decode steps."""
        self.device = resolve_device(device)
        if isinstance(model_path, (str, os.PathLike)) and not os.path.exists(model_path):
            raise FileNotFoundError(f"Model checkpoint not found: {model_path}")
        if allow_random_init is None:
            allow_random_init = allow_random_init_default()
        if model_path is None and not allow_random_init:
            raise MissingWeightsError(
                "TrOCR has no checkpoint (none given): pass model_path=, or "
                "allow_random_init=True (or set MANUSCRIPT_TPU_ALLOW_RANDOM_INIT=1) "
                "for untrained weights"
            )
        self.config = config or TrOCRConfig()
        self.model_path, self.max_length, self.dtype = model_path, max_length, dtype
        with torch.device("meta"):
            self.model = TrOCRModel(self.config)
        self.model.to_empty(device=self.device)
        if model_path is not None:
            load_state(self.model, model_path)
        else:
            init_random_(self.model, seed)
        self.model.to(dtype).eval()
        self.itos = stand_in_vocab(self.config.vocab_size)
        c = self.config
        self.bos_id, self.pad_id, self.eos_id = c.bos_token_id, c.pad_token_id, c.eos_token_id

    def decode(self, ids: Sequence[int]) -> str:
        """Token ids → text through the stand-in table: stop at EOS, skip the
        other special tokens."""
        out = []
        for t in ids:
            t = int(t)
            if t == self.eos_id:
                break
            if t >= len(SPECIALS):
                out.append(self.itos[t])
        return "".join(out)

    def _preprocess_one(self, image) -> np.ndarray:
        if isinstance(image, (str, Path)) and not os.path.exists(str(image)):
            raise FileNotFoundError(f"Image file not found: {image}")
        img = to_rgb_u8(np.asarray(read_image(image)))
        s = self.config.image_size
        x = resize_bilinear(torch.from_numpy(np.ascontiguousarray(img)).float(), s, s)
        return x.round().clamp(0, 255).to(torch.uint8).numpy()
