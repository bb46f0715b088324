from .engine import EsIndex

__all__ = ["EsIndex"]
