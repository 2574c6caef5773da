from .trba import TRBA

__all__ = ["TRBA"]
