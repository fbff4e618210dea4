"""Serving pipelines: aligned-face restoration, the fused whole-image
path (detector, face helper, device pipeline) and the classic per-stage
path (face helper, compositor, batched video)."""
from .detector import FaceDetector, init_detection_model
from .device_pipeline import DeviceRestorePipeline
from .face_helper import FaceRestoreHelper
from .restorer import CodeFormerRestorer

__all__ = ['CodeFormerRestorer', 'DeviceRestorePipeline', 'FaceDetector',
           'FaceRestoreHelper', 'init_detection_model']
