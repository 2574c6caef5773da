from .charset import (
    charset_maps,
    decode_tokens,
    default_charset,
    load_charset,
    pack_targets,
    save_charset,
)
from .trba import TRBA

__all__ = [
    "TRBA",
    "default_charset",
    "load_charset",
    "save_charset",
    "charset_maps",
    "pack_targets",
    "decode_tokens",
]
