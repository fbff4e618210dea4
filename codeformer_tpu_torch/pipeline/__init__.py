"""Serving pipelines: aligned-face restoration and the fused whole-image
path (detector, face helper, device pipeline)."""
from .detector import FaceDetector, init_detection_model
from .device_pipeline import DeviceRestorePipeline
from .face_helper import FaceRestoreHelper
from .restorer import CodeFormerRestorer

__all__ = ['CodeFormerRestorer', 'DeviceRestorePipeline', 'FaceDetector',
           'FaceRestoreHelper', 'init_detection_model']
