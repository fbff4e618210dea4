"""Gradio demo of the PyTorch port (counterpart of
web-demos/hugging_face/app.py; reference web-demos/hugging_face/app.py):

    python -m codeformer_tpu_torch.demos.hugging_face

`inference(image, background_enhance, face_upsample, upscale,
codeformer_fidelity)` restores one BGR image on `device` (CUDA unless
another is given) through the classic path: the port's
FaceRestoreHelper (RetinaFace resnet50, ParseNet), the restorer and,
when asked, the x2 Real-ESRGAN upsampler for the background and the
faces. The restorer is built once a device, from
weights/CodeFormer/codeformer.pth or, with CODEFORMER_RANDOM_INIT=1,
seeded random weights (also for the detector, the parser and the
upsampler). The gradio UI is built only where gradio imports.
"""
from __future__ import annotations

import os
from typing import Dict

from codeformer_tpu_torch.cli.common import resolve_checkpoint
from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper
from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer

_restorers: Dict[str, CodeFormerRestorer] = {}   # one a device


def random_init() -> bool:
    """CODEFORMER_RANDOM_INIT=1: seeded random weights where the files
    are missing (a smoke run)."""
    return os.environ.get('CODEFORMER_RANDOM_INIT') == '1'


def get_restorer(device='cuda') -> CodeFormerRestorer:
    """The restoration model on `device`, built at its first request."""
    key = str(device)
    if key not in _restorers:
        ckpt = resolve_checkpoint(None, 'restoration', random_init())
        _restorers[key] = CodeFormerRestorer(device=device, checkpoint=ckpt)
    return _restorers[key]


def upscale_clamps(h: int, w: int, upscale, background_enhance: bool,
                   face_upsample: bool):
    """The demo's limits for large inputs (app.py:45-52): upscale at most
    4, at most 2 past 1000 px on the long side, 1 and no upsampler past
    1500. Returns (upscale, background_enhance, face_upsample)."""
    upscale = int(upscale)
    if upscale > 4:
        upscale = 4
    if upscale > 2 and max(h, w) > 1000:
        upscale = 2
    if max(h, w) > 1500:
        upscale = 1
        background_enhance = False
        face_upsample = False
    return upscale, background_enhance, face_upsample


def inference(image, background_enhance: bool, face_upsample: bool,
              upscale: int, codeformer_fidelity: float, device='cuda'):
    """image: a BGR uint8 array or a path. Returns the restored BGR image:
    detect, align, restore, paste back (app.py's flow)."""
    if isinstance(image, str):
        import cv2
        image = cv2.imread(image, cv2.IMREAD_COLOR)
    img = image
    upscale, background_enhance, face_upsample = upscale_clamps(
        img.shape[0], img.shape[1], upscale, background_enhance,
        face_upsample)
    restorer = get_restorer(device)
    allow_random = random_init()
    face_helper = FaceRestoreHelper(
        upscale, face_size=512, crop_ratio=(1, 1),
        det_model='retinaface_resnet50', use_parse=True, device=device,
        allow_random_weights=allow_random)
    bg_upsampler = None
    if background_enhance or face_upsample:
        from codeformer_tpu_torch.pipeline.realesrgan import set_realesrgan
        bg_upsampler = set_realesrgan(allow_random=allow_random,
                                      device=device)

    face_helper.read_image(img)
    face_helper.get_face_landmarks_5(only_center_face=False, resize=640,
                                     eye_dist_threshold=5)
    face_helper.align_warp_face()
    if face_helper.cropped_faces:
        restored = restorer.restore_batch(
            face_helper.cropped_faces, w=codeformer_fidelity, adain=True)
        for cropped, rest in zip(face_helper.cropped_faces, restored):
            face_helper.add_restored_face(rest, cropped)
    bg_img = None
    if background_enhance and bg_upsampler is not None:
        bg_img = bg_upsampler.enhance(img, outscale=upscale)[0]
    face_helper.get_inverse_affine(None)
    if face_upsample and bg_upsampler is not None:
        return face_helper.paste_faces_to_input_image(
            upsample_img=bg_img, face_upsampler=bg_upsampler)
    return face_helper.paste_faces_to_input_image(upsample_img=bg_img)


def build_ui(device='cuda'):
    """The gradio Interface over `inference` (RGB in and out); exits where
    gradio is not installed."""
    try:
        import gradio as gr
    except ImportError:
        raise SystemExit('gradio is not installed in this image; import '
                         'and call inference() directly instead')

    def _run(image, background_enhance, face_upsample, upscale, fidelity):
        out = inference(image[..., ::-1], background_enhance,
                        face_upsample, upscale, fidelity, device)
        return out[..., ::-1]

    return gr.Interface(
        _run,
        inputs=[
            gr.Image(type='numpy', label='Input'),
            gr.Checkbox(value=True, label='Background_Enhance'),
            gr.Checkbox(value=True, label='Face_Upsample'),
            gr.Number(value=2, label='Rescaling_Factor (up to 4)'),
            gr.Slider(0, 1, value=0.5, step=0.01,
                      label='Codeformer_Fidelity'),
        ],
        outputs=gr.Image(type='numpy', label='Output'),
        title='CodeFormer: Robust Face Restoration')


if __name__ == '__main__':
    build_ui().launch()
