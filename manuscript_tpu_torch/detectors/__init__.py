from .east import EAST

__all__ = ["EAST"]
