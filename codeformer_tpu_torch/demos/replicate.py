"""Replicate (cog) predictor of the PyTorch port (counterpart of
web-demos/replicate/predict.py): `predict(image, codeformer_fidelity,
background_enhance, face_upsample, upscale)` reads an image file,
restores it through demos/hugging_face.py `inference` on `device` (CUDA
unless another is given) and writes the result. The cog `Predictor` is
defined only where cog imports.
"""
from __future__ import annotations


def predict(image: str, codeformer_fidelity: float = 0.5,
            background_enhance: bool = True, face_upsample: bool = True,
            upscale: int = 2, output_path: str = 'output.png',
            device='cuda') -> str:
    """image: an input path; returns the output path."""
    import cv2

    from codeformer_tpu_torch.demos.hugging_face import inference
    img = cv2.imread(image, cv2.IMREAD_COLOR)
    out = inference(img, background_enhance, face_upsample, upscale,
                    codeformer_fidelity, device)
    cv2.imwrite(output_path, out)
    return output_path


try:
    from cog import BasePredictor, Input, Path
except ImportError:
    BasePredictor = None

if BasePredictor is not None:
    class Predictor(BasePredictor):
        def predict(self,
                    image: Path = Input(description='Input image'),
                    codeformer_fidelity: float = Input(
                        default=0.5, ge=0, le=1),
                    background_enhance: bool = Input(default=True),
                    face_upsample: bool = Input(default=True),
                    upscale: int = Input(default=2)) -> Path:
            return Path(predict(str(image), codeformer_fidelity,
                                background_enhance, face_upsample, upscale))
