"""Serving pipelines: aligned-face restoration, the fused whole-image
path (detector, face helper, device pipeline), the classic per-stage
path (face helper, compositor, batched video) and the Real-ESRGAN
upsampler."""
from .detector import FaceDetector, YoloFaceDetector, init_detection_model
from .device_pipeline import DeviceRestorePipeline
from .face_helper import FaceRestoreHelper
from .realesrgan import RealESRGANer, set_realesrgan
from .restorer import CodeFormerRestorer

__all__ = ['CodeFormerRestorer', 'DeviceRestorePipeline', 'FaceDetector',
           'FaceRestoreHelper', 'RealESRGANer', 'YoloFaceDetector',
           'init_detection_model', 'set_realesrgan']
