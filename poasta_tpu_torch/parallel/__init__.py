from .mapper import BatchMapper

__all__ = ["BatchMapper"]
