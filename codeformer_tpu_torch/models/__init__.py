"""Model architectures."""
from .codeformer import CodeFormer
from .vqgan import VQAutoEncoder

__all__ = ['CodeFormer', 'VQAutoEncoder']
