"""Deterministic synthetic manuscript pages with ground truth, in numpy alone
(counterpart of ``manuscript_tpu/utils/synthetic.py``: ``VOCAB``,
``render_page``, ``eval_pages``).

The JAX package draws each word with PIL. The port reads the same glyphs,
as ``render_word(word, None, height=36, noise=0.0)`` drew them, from
``configs/synthetic_glyphs.npz`` (one gray channel per word), and replays
``render_page``'s random draws in the same order, so a seed gives the same
page bytes and the same ground truth as the JAX package.
"""

from __future__ import annotations

from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

import numpy as np

GLYPHS = Path(__file__).resolve().parent.parent / "configs" / "synthetic_glyphs.npz"

# Small latin vocabulary; every char is in the default charset.
VOCAB = (
    "the", "old", "manuscript", "text", "word", "page", "line", "quill",
    "ink", "scribe", "letter", "codex", "folio", "margin", "glyph", "seal",
    "abbey", "monk", "vellum", "psalm", "verse", "amen", "ornate", "gold",
)


@lru_cache(maxsize=1)
def _glyphs() -> Dict[str, np.ndarray]:
    with np.load(GLYPHS) as z:
        return {w: np.repeat(z[w][..., None], 3, axis=2) for w in z.files}


def render_word(word: str, rng: np.random.Generator, noise: float = 4.0) -> np.ndarray:
    """One word crop, 36 px high: the stored glyph plus gaussian pixel noise
    (the draw ``render_page`` makes for it)."""
    arr = _glyphs()[word].astype(np.float32)
    if noise > 0:
        arr = arr + rng.normal(0, noise, arr.shape)
    return np.clip(arr, 0, 255).astype(np.uint8)


def render_page(
    rng: np.random.Generator,
    page_h: int = 1024,
    page_w: int = 768,
    n_rows: int = 8,
    n_cols: int = 3,
    vocab: Sequence[str] = VOCAB,
) -> Tuple[np.ndarray, List[Dict]]:
    """One page: words pasted at jittered grid positions on a parchment-ish
    background. Returns ``(page_u8, words)`` where each word is
    ``{"quad": (4,2) float32 page coords, "text": str}``."""
    page = np.full((page_h, page_w, 3), 235, np.float32)
    page += rng.normal(0, 3, page.shape)

    words: List[Dict] = []
    cell_h = page_h // (n_rows + 1)
    cell_w = page_w // n_cols
    for r in range(n_rows):
        for c in range(n_cols):
            text = str(vocab[int(rng.integers(len(vocab)))])
            crop = render_word(text, rng)
            ch, cw = crop.shape[:2]
            if cw > cell_w - 16:  # keep words inside their cell
                crop = crop[:, : cell_w - 16]
                cw = crop.shape[1]
            y = (r + 1) * cell_h + int(rng.integers(-8, 9)) - ch // 2
            x = c * cell_w + 8 + int(rng.integers(0, max(1, cell_w - cw - 16)))
            y = int(np.clip(y, 0, page_h - ch))
            x = int(np.clip(x, 0, page_w - cw))
            page[y : y + ch, x : x + cw] = crop
            quad = np.array(
                [[x, y], [x + cw, y], [x + cw, y + ch], [x, y + ch]], np.float32
            )
            words.append({"quad": quad, "text": text})
    return np.clip(page, 0, 255).astype(np.uint8), words


def eval_pages(
    n_pages: int, seed: int = 9000, **page_kwargs
) -> List[Tuple[np.ndarray, List[Dict]]]:
    """Held-out evaluation pages (seeds disjoint from the micro checkpoints'
    training seeds) → [(page_u8, [{"quad", "text"}, ...]), ...]."""
    rng = np.random.default_rng(seed)
    return [render_page(rng, **page_kwargs) for _ in range(n_pages)]
