"""Model architectures."""
from .codeformer import CodeFormer
from .parsenet import ParseNet
from .retinaface import RetinaFace
from .vqgan import VQAutoEncoder

__all__ = ['CodeFormer', 'ParseNet', 'RetinaFace', 'VQAutoEncoder']
