"""Serving pipelines."""
from .restorer import CodeFormerRestorer

__all__ = ['CodeFormerRestorer']
