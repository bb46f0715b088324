from .engine import Engine, EsIndex

__all__ = ["Engine", "EsIndex"]
