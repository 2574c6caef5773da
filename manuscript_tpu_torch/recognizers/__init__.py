from .charset import decode_tokens, default_charset, load_charset
from .trba import TRBA

__all__ = ["TRBA", "decode_tokens", "default_charset", "load_charset"]
