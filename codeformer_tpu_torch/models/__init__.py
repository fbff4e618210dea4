"""Model architectures."""
from .arcface import ResNetArcFace
from .bisenet import BiSeNet
from .codeformer import CodeFormer
from .parsenet import ParseNet
from .retinaface import RetinaFace
from .rrdbnet import RRDBNet
from .vgg import VGGFeatureExtractor
from .vqgan import VQAutoEncoder, VQGANDiscriminator
from .yolov5face import YoloFace

__all__ = ['BiSeNet', 'CodeFormer', 'ParseNet', 'RRDBNet', 'RetinaFace',
           'ResNetArcFace', 'VGGFeatureExtractor', 'VQAutoEncoder',
           'VQGANDiscriminator', 'YoloFace']
