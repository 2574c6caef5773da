"""Character set of the TRBA recognizer and the token-id → text decode.

The port's own copy of what inference and training use from
``manuscript_tpu/recognizers/charset.py``: the special tokens, the default
194-token charset (index-compatible with the released weights),
``load_charset``/``save_charset``, ``charset_maps``, ``pack_targets`` and
``decode_tokens``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

PAD_TOKEN = "<PAD>"
SOS_TOKEN = "<SOS>"
EOS_TOKEN = "<EOS>"
BLANK_TOKEN = "<BLANK>"


def default_charset() -> List[str]:
    """The default 194-token charset (index-compatible with the reference)."""
    tokens = [PAD_TOKEN, SOS_TOKEN, EOS_TOKEN, " "]
    tokens += [chr(c) for c in range(ord("a"), ord("z") + 1)]
    tokens += [chr(c) for c in range(ord("A"), ord("Z") + 1)]
    tokens += [chr(c) for c in range(ord("0"), ord("9") + 1)]
    # modern Russian lowercase: а-е, ё, ж-я
    lower = [chr(c) for c in range(ord("а"), ord("е") + 1)]
    lower += ["ё"] + [chr(c) for c in range(ord("ж"), ord("я") + 1)]
    tokens += lower
    upper = [chr(c) for c in range(ord("А"), ord("Е") + 1)]
    upper += ["Ё"] + [chr(c) for c in range(ord("Ж"), ord("Я") + 1)]
    tokens += upper
    # pre-reform / Old Church Slavonic pairs (lower, upper)
    tokens += list("ѣѢіІѳѲѵѴѫѪѭѬѯѮѱѰѡѠѕЅѧѦѩѨ")
    tokens += list(".,:;!?-–—…«»()[]{}\"'`/\\|_+=*^%$#@&<>~№")
    return tokens


def load_charset(charset_path: Union[str, Path]) -> Tuple[List[str], Dict[str, int]]:
    """A charset file, one token a line (blank lines skipped) → (itos, stoi)."""
    itos: List[str] = []
    with open(charset_path, "r", encoding="utf-8") as f:
        for line in f:
            tok = line.rstrip("\n")
            if tok:
                itos.append(tok)
    return itos, {s: i for i, s in enumerate(itos)}


def save_charset(itos: Sequence[str], charset_path: Union[str, Path]) -> None:
    """Write a charset file, one token a line."""
    with open(charset_path, "w", encoding="utf-8") as f:
        f.write("\n".join(itos) + "\n")


def charset_maps(itos: Sequence[str]) -> Dict[str, int]:
    """itos → stoi."""
    return {s: i for i, s in enumerate(itos)}


def pack_targets(
    texts: Sequence[str],
    stoi: Dict[str, int],
    max_len: int,
    drop_blank: bool = True,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Attention-decoder targets → (text_in, target_y, lengths), int32:
    ``text_in`` (B, max_len+1) is [SOS, ids…, PAD…], ``target_y`` [ids…, EOS,
    PAD…], ``lengths`` the supervised steps (chars + EOS). Unknown characters
    are dropped, and BLANK too when ``drop_blank``."""
    pad, sos, eos = stoi[PAD_TOKEN], stoi[SOS_TOKEN], stoi[EOS_TOKEN]
    blank = stoi.get(BLANK_TOKEN)
    b, t = len(texts), max_len + 1
    text_in = np.full((b, t), pad, dtype=np.int32)
    text_in[:, 0] = sos
    target_y = np.full((b, t), pad, dtype=np.int32)
    lengths = np.zeros((b,), dtype=np.int32)
    for i, s in enumerate(texts):
        ids = [stoi[ch] for ch in s if ch in stoi
               and not (drop_blank and blank is not None and stoi[ch] == blank)]
        n = min(len(ids), max_len)
        text_in[i, 1 : 1 + n] = ids[:n]
        target_y[i, :n] = ids[:n]
        target_y[i, n] = eos
        lengths[i] = n + 1
    return text_in, target_y, lengths


def decode_tokens(
    ids: Sequence[int],
    itos: Sequence[str],
    pad_id: int,
    eos_id: int,
    blank_id: Optional[int] = None,
) -> str:
    """Token ids → string: stop at EOS, skip PAD/BLANK."""
    out = []
    for t in ids:
        t = int(t)
        if t == eos_id:
            break
        if t == pad_id or (blank_id is not None and t == blank_id):
            continue
        out.append(itos[t])
    return "".join(out)
