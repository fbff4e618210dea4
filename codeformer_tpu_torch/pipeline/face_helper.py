"""FaceRestoreHelper, counterpart of codeformer_tpu/pipeline/
face_helper.py (the reference's facelib/utils/face_restoration_helper.py:
54-525): the FFHQ 5-point template, the detector and the parser, shared
with DeviceRestorePipeline, which runs the whole-image path on the
device.

Only what the device pipeline needs is ported: the construction and
`_parse_masks`. The per-image classic methods (read, detect, align,
paste back, dlib) raise NotImplementedError: the classic per-stage path
is ROADMAP.md Queue 1 item 1.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np
import torch

from codeformer_tpu_torch.models.parsenet import ParseNet
from codeformer_tpu_torch.ops.geometry import resize_linear
from codeformer_tpu_torch.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.utils.convert import load_pth

PARSENET_WEIGHTS = 'weights/facelib/parsing_parsenet.pth'

_CLASSIC = ('the classic per-stage whole-image path is not ported yet '
            '(ROADMAP.md Queue 1 item 1); the fused device pipeline '
            '(DeviceRestorePipeline) serves whole images')


class FaceRestoreHelper:
    """Template, detector and parser of the whole-image path.

    det_dtype / parse_dtype: the detector's and parser's compute types
    (float32 matches the reference; the fused pipeline runs both in
    bfloat16 on the card, as the JAX package does on the TPU). Weights
    come from weights/facelib/*.pth when present, else a seeded random
    init (seed 0) if `allow_random_weights`, else FileNotFoundError.
    """

    def __init__(self, upscale_factor: int, face_size: int = 512,
                 crop_ratio=(1, 1), det_model: str = 'retinaface_resnet50',
                 use_parse: bool = False, device='cuda',
                 allow_random_weights: bool = False, detector=None,
                 det_dtype: torch.dtype = torch.float32,
                 parse_dtype: torch.dtype = torch.float32):
        if det_model == 'dlib':
            raise NotImplementedError(
                'the dlib detector is not ported yet (ROADMAP.md Queue 1 '
                'item 3)')
        self.upscale_factor = int(upscale_factor)
        self.crop_ratio = crop_ratio
        if crop_ratio[0] < 1 or crop_ratio[1] < 1:
            raise ValueError('crop ratio only supports >= 1')
        self.face_size = (int(face_size * crop_ratio[1]),
                          int(face_size * crop_ratio[0]))
        self.det_model = det_model
        self.device = torch.device(device)

        # the facexlib FFHQ 5-point template at 512
        # (face_restoration_helper.py:76-93), shifted for crop_ratio > 1
        self.face_template = np.array(
            [[192.98138, 239.94708], [318.90277, 240.1936],
             [256.63416, 314.01935], [201.26117, 371.41043],
             [313.08905, 371.15118]], np.float32) * (face_size / 512.0)
        if self.crop_ratio[0] > 1:
            self.face_template[:, 1] += face_size * (
                self.crop_ratio[0] - 1) / 2
        if self.crop_ratio[1] > 1:
            self.face_template[:, 0] += face_size * (
                self.crop_ratio[1] - 1) / 2

        from .detector import init_detection_model
        self.face_detector = detector or init_detection_model(
            det_model, allow_random=allow_random_weights, dtype=det_dtype,
            device=self.device)

        self.use_parse = use_parse
        parser = ParseNet()
        if os.path.exists(PARSENET_WEIGHTS):
            parser.load_state_dict(load_pth(PARSENET_WEIGHTS))
        elif allow_random_weights:
            init_params_fast(parser, 0)
        else:
            raise FileNotFoundError(
                f'ParseNet weights not found at {PARSENET_WEIGHTS}')
        parser = parser.to(self.device, parse_dtype).eval() \
            .requires_grad_(False)
        if self.device.type == 'cuda':
            parser = parser.to(memory_format=torch.channels_last)
        self._parse_model = parser
        self.parse_dtype = parse_dtype

    @torch.inference_mode()
    def _parse(self, faces_rgb_u8: torch.Tensor,
               res: Optional[int] = None) -> torch.Tensor:
        """(B, H, W, 3) uint8 RGB on the device -> (B, res, res) class ids
        (int64; the first maximum on ties, as jnp.argmax): [-1, 1],
        resized to `res` when given, ParseNet, argmax."""
        x = faces_rgb_u8.permute(0, 3, 1, 2).float() / 127.5 - 1.0
        if res is not None and res != x.shape[2]:
            x = resize_linear(x, (res, res))
        mask, _ = self._parse_model(x.to(self.parse_dtype))
        return torch.argmax(mask, dim=1)

    def _parse_masks(self, restored_faces: List[np.ndarray]) -> np.ndarray:
        """Batched ParseNet over BGR faces: (N, 512, 512) class ids, in
        device batches of 8."""
        import cv2
        batch = np.stack([
            cv2.resize(f, (512, 512),
                       interpolation=cv2.INTER_LINEAR)[..., ::-1]
            for f in restored_faces]).astype(np.uint8)
        outs = [self._parse(torch.from_numpy(batch[i:i + 8]).to(
            self.device)).cpu().numpy() for i in range(0, len(batch), 8)]
        return np.concatenate(outs)

    # the classic per-image surface of the reference helper
    def read_image(self, img):
        raise NotImplementedError(_CLASSIC)

    def get_face_landmarks_5(self, *args, **kwargs):
        raise NotImplementedError(_CLASSIC)

    def align_warp_face(self, *args, **kwargs):
        raise NotImplementedError(_CLASSIC)

    def get_inverse_affine(self, *args, **kwargs):
        raise NotImplementedError(_CLASSIC)

    def add_restored_face(self, *args, **kwargs):
        raise NotImplementedError(_CLASSIC)

    def paste_faces_to_input_image(self, *args, **kwargs):
        raise NotImplementedError(_CLASSIC)
