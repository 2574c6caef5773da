"""Character set of the TRBA recognizer and the token-id → text decode.

The port's own copy of what inference uses from
``manuscript_tpu/recognizers/charset.py``: the special tokens, the default
194-token charset (index-compatible with the released weights),
``load_charset`` and ``decode_tokens``.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

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
