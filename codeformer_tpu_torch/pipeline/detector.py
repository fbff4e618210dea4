"""Face detection services, counterpart of codeformer_tpu/pipeline/
detector.py (the reference's RetinaFace.detect_faces,
retinaface.py:194-239, and YoloDetector.detect_faces,
face_detector.py:105-138): the detector's graph and a static-shape
post-processing on the device (decode, threshold to -inf, top-k, NMS),
bucketed by input size; only a (B, max_faces, 15) block and its
validity mask cross to the host. RetinaFace's inputs are mean-subtracted
and zero-padded to 64-multiples, and its device front end
(`batched_detect_device*`) also resizes uint8 frames on the device
first; YOLOv5-face's are RGB / 255 padded with 114 / 255 to
32-multiples.

Decode, top-k and NMS stay fp32 whatever the backbone's dtype (bf16
roughly halves the detector's time on the card, with sub-pixel drift).
"""
from __future__ import annotations

import math
import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from codeformer_tpu_torch.models.retinaface import RetinaFace
from codeformer_tpu_torch.models.yolov5face import YoloFace
from codeformer_tpu_torch.ops.anchors import prior_boxes
from codeformer_tpu_torch.ops.geometry import resize_linear
from codeformer_tpu_torch.ops.nms import decode_boxes, decode_landmarks, nms
from codeformer_tpu_torch.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.utils.convert import load_pth
from codeformer_tpu_torch.utils.profiler import span

# BGR means subtracted before the backbone (retinaface.py:88)
_MEANS = (104.0, 117.0, 123.0)

WEIGHTS = {
    'retinaface_resnet50': 'weights/facelib/detection_Resnet50_Final.pth',
    'retinaface_mobile0.25':
        'weights/facelib/detection_mobilenet0.25_Final.pth',
    'YOLOv5l': 'weights/facelib/yolov5l-face.pth',
    'YOLOv5n': 'weights/facelib/yolov5n-face.pth',
}


def init_detection_model(model_name: str, checkpoint=None,
                         allow_random: bool = False,
                         dtype: torch.dtype = torch.float32,
                         device='cuda'):
    """Factory mirroring facelib/detection/__init__.py:14-22."""
    if model_name.startswith('retinaface'):
        return FaceDetector(model_name, checkpoint=checkpoint,
                            allow_random=allow_random, dtype=dtype,
                            device=device)
    if model_name.startswith('YOLOv5'):
        return YoloFaceDetector(model_name, checkpoint=checkpoint,
                                allow_random=allow_random, dtype=dtype,
                                device=device)
    raise NotImplementedError(f'{model_name} is not implemented.')


def _load_model(model, model_name, checkpoint, allow_random, dtype, device):
    """Weights: `checkpoint`, else the reference file under
    weights/facelib/, else a seeded (0) random init if `allow_random`;
    then eval mode on `device` in `dtype`."""
    ckpt = checkpoint or WEIGHTS.get(model_name)
    if ckpt and os.path.exists(ckpt):
        model.load_state_dict(load_pth(ckpt))
    elif allow_random:
        init_params_fast(model, 0)
    else:
        raise FileNotFoundError(
            f'detector weights not found at {ckpt}; place the released '
            f'.pth there or pass checkpoint=/allow_random=True')
    model = model.to(device, dtype).eval().requires_grad_(False)
    if device.type == 'cuda':   # cuDNN's bf16 convs are NHWC
        model = model.to(memory_format=torch.channels_last)
    return model


def _select(boxes, scores, landms, conf_threshold, nms_threshold,
            pre_nms_topk: int, max_faces: int):
    """Scores at or below the threshold -> -inf, the top `pre_nms_topk`,
    then NMS: (B, N, 4) boxes, (B, N) scores, (B, N, 10) landmarks ->
    (dets (B, max_faces, 15), valid (B, max_faces))."""
    scores = torch.where(scores > conf_threshold, scores,
                         torch.full_like(scores, -torch.inf))
    # the top-k prefilter bounds the NMS cost; a stable sort puts the
    # lower index first on ties, as jax.lax.top_k
    k = min(pre_nms_topk, scores.shape[1])
    top_scores, top_idx = torch.sort(scores, dim=1, descending=True,
                                     stable=True)
    top_scores, top_idx = top_scores[:, :k], top_idx[:, :k]
    top_boxes = boxes.gather(1, top_idx[..., None].expand(-1, -1, 4))
    top_landms = landms.gather(1, top_idx[..., None].expand(-1, -1, 10))
    keep, valid = nms(top_boxes, top_scores, nms_threshold, max_faces)
    pick = keep[..., None]
    out = torch.cat([
        top_boxes.gather(1, pick.expand(-1, -1, 4)),
        top_scores.gather(1, keep)[..., None],
        top_landms.gather(1, pick.expand(-1, -1, 10))], dim=-1)
    return out, valid


class _DetectorService:
    """What both detectors share: graphs bucketed by input size and keep
    bucket, the keep-bucket escalation and detect_faces(img_bgr) ->
    (n, 15) float32 [x1, y1, x2, y2, score, lmk_x1, lmk_y1, ...,
    lmk_x5, lmk_y5], the reference's layout. A subclass sets
    `model`, `device`, `dtype`, `max_faces`, `pre_nms_topk` and
    `_graphs`, and gives `_make_graph` and `_host_batch`."""

    # largest keep-bucket tried before warning (the reference has no cap;
    # beyond this a warning beats ever-larger NMS loops)
    MAX_FACES_CEILING = 512

    @staticmethod
    def _bucket(size: int, step: int = 64) -> int:
        return int(math.ceil(size / step) * step)

    def _graph(self, hw: Tuple[int, int], max_faces: int):
        """The detection body for padded batches of exactly `hw`:
        fn(x (B, 3, H, W) float, conf_threshold, nms_threshold) ->
        (dets (B, max_faces, 15), valid (B, max_faces)) on the device."""
        key = (tuple(hw), max_faces)
        if key not in self._graphs:
            self._graphs[key] = self._make_graph(hw, max_faces)
        return self._graphs[key]

    def _run_escalating(self, x, hw, conf_threshold, nms_threshold):
        """Run the body, and again with a 4x larger keep-bucket while any
        frame's NMS saturated, so crowds never silently lose faces."""
        max_f = self.max_faces
        while True:
            outs, valids = self._graph(hw, max_f)(x, conf_threshold,
                                                  nms_threshold)
            valids = valids.cpu().numpy()
            if valids.all(axis=1).any() and max_f < self.MAX_FACES_CEILING:
                max_f = min(max_f * 4, self.MAX_FACES_CEILING)
                continue
            return outs.cpu().numpy(), valids, max_f

    def detect_faces(self, img_bgr: np.ndarray,
                     conf_threshold: float = 0.8,
                     nms_threshold: float = 0.4) -> np.ndarray:
        h, w = img_bgr.shape[:2]
        x, hb, wb = self._host_batch(np.asarray(img_bgr)[None])
        outs, valids, max_f = self._run_escalating(
            x, (hb, wb), conf_threshold, nms_threshold)
        if valids.all() and max_f >= self.MAX_FACES_CEILING:
            warnings.warn(
                f'detection kept {max_f} faces and may still be truncated '
                f'(MAX_FACES_CEILING={self.MAX_FACES_CEILING})')
        return _rows(outs[0], valids[0], h, w)


class FaceDetector(_DetectorService):
    """RetinaFace. device: where the detector runs; dtype: the
    backbone's compute type (float32 matches the reference; bfloat16 is
    the fused pipeline's). Weights: `checkpoint`, else the reference
    file under weights/facelib/, else a seeded (0) random init if
    `allow_random`.
    """

    def __init__(self, model_name: str = 'retinaface_resnet50',
                 checkpoint: Optional[str] = None,
                 allow_random: bool = False, max_faces: int = 32,
                 pre_nms_topk: int = 1024,
                 dtype: torch.dtype = torch.float32, device='cuda'):
        self.device = torch.device(device)
        self.dtype = dtype
        self.max_faces = max_faces
        self.pre_nms_topk = pre_nms_topk
        self.model = _load_model(
            RetinaFace('resnet50' if 'resnet50' in model_name
                       else 'mobile0.25'),
            model_name, checkpoint, allow_random, dtype, self.device)
        self._graphs = {}

    def _make_graph(self, hw: Tuple[int, int], max_faces: int):
        h, w = hw
        priors = torch.as_tensor(prior_boxes(h, w), device=self.device)
        scale_b = torch.tensor([w, h, w, h], dtype=torch.float32,
                               device=self.device)
        scale_l = scale_b[:2].repeat(5)
        means = torch.tensor(_MEANS, device=self.device).reshape(1, 3, 1, 1)

        @torch.inference_mode()
        def run(x, conf_threshold, nms_threshold):
            with span('detect.net'):
                x = (x.float() - means).to(self.dtype)
                loc, conf, landm = self.model(x)
            with span('detect.select'):
                boxes = decode_boxes(loc.float(), priors) * scale_b
                landms = decode_landmarks(landm.float(), priors) * scale_l
                return _select(boxes, conf[..., 1], landms, conf_threshold,
                               nms_threshold, self.pre_nms_topk, max_faces)

        return run

    def _host_batch(self, imgs: np.ndarray) -> Tuple[torch.Tensor, int, int]:
        """(B, H, W, 3) BGR -> a zero-padded (B, 3, hb, wb) device batch;
        uint8 inputs cross as bytes."""
        b, h, w = imgs.shape[:3]
        hb, wb = self._bucket(h), self._bucket(w)
        dt = np.uint8 if imgs.dtype == np.uint8 else np.float32
        padded = np.zeros((b, hb, wb, 3), dt)
        padded[:, :h, :w] = imgs
        return (torch.from_numpy(padded).to(self.device).permute(0, 3, 1, 2),
                hb, wb)

    def align_multi(self, img_bgr: np.ndarray, conf_threshold: float = 0.8,
                    limit: Optional[int] = None):
        """Detect + warp each face to the canonical 112x112 crop
        (reference retinaface.py:241-264 align_multi; the warp is cv2's,
        on the host). Returns ((n, 5) boxes and scores, the crops)."""
        from .align_trans import get_reference_facial_points, \
            warp_and_crop_face
        det = self.detect_faces(img_bgr, conf_threshold)
        if limit:
            det = det[:limit]
        reference = get_reference_facial_points(default_square=True)
        faces = []
        for row in det:
            landmark = row[5:15].reshape(5, 2)
            faces.append(warp_and_crop_face(
                img_bgr, landmark, reference, crop_size=(112, 112)))
        return det[:, :5], faces

    def batched_detect_faces(self, frames, conf_threshold: float = 0.8,
                             nms_threshold: float = 0.4):
        """Detect over a batch of SAME-SIZE frames (the video path,
        reference retinaface.py:310-372). Returns a list of (n_i, 15)
        arrays, one a frame."""
        frames = np.asarray(frames)
        h, w = frames.shape[1:3]
        x, hb, wb = self._host_batch(frames)
        outs, valids, _ = self._run_escalating(
            x, (hb, wb), conf_threshold, nms_threshold)
        return [_rows(o, v, h, w) for o, v in zip(outs, valids)]

    def _device_graph(self, det_hw: Tuple[int, int], max_faces: int):
        """Device front end: uint8 BGR frames (B, H, W, 3) -> resized
        (linear, as jax.image.resize) to det_hw -> zero-padded to the
        64-bucket -> the detection body."""
        dh, dw = det_hw
        hb, wb = self._bucket(dh), self._bucket(dw)
        body = self._graph((hb, wb), max_faces)

        def run(frames, conf_threshold, nms_threshold):
            x = resize_linear(frames.permute(0, 3, 1, 2).float(), (dh, dw))
            x = F.pad(x, (0, wb - dw, 0, hb - dh))
            return body(x, conf_threshold, nms_threshold)

        return run

    def batched_detect_device_start(self, frames_dev, det_hw,
                                    conf_threshold: float = 0.8,
                                    nms_threshold: float = 0.4):
        """Enqueue this chunk's detection without waiting for it. On a
        card the results are copied into pinned host buffers behind the
        detection, with an event, so `..._finish` waits for this chunk's
        detection only and not for work enqueued after it (the next
        chunk's detection)."""
        with span('detect'):
            outs, valids = self._device_graph(tuple(det_hw),
                                              self.max_faces)(
                frames_dev, conf_threshold, nms_threshold)
            if not outs.is_cuda:
                return outs, valids, None
            h_outs = torch.empty(outs.shape, dtype=outs.dtype,
                                 pin_memory=True)
            h_valids = torch.empty(valids.shape, dtype=valids.dtype,
                                   pin_memory=True)
            h_outs.copy_(outs, non_blocking=True)
            h_valids.copy_(valids, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return h_outs, h_valids, done

    def batched_detect_device_finish(self, frames_dev, det_hw, pending,
                                     conf_threshold: float = 0.8,
                                     nms_threshold: float = 0.4):
        """Wait for a `..._start` dispatch, escalating to a larger
        keep-bucket (synchronously; rare) if any frame's NMS saturated.
        Returns host (B, max_faces, 15) and (B, max_faces) arrays."""
        with span('detect.finish'):
            outs, valids, done = pending
            if done is not None:
                done.synchronize()
            valids = valids.cpu().numpy()
            max_f = self.max_faces
            while valids.all(axis=1).any() and \
                    max_f < self.MAX_FACES_CEILING:
                max_f = min(max_f * 4, self.MAX_FACES_CEILING)
                outs, valids = self._device_graph(tuple(det_hw), max_f)(
                    frames_dev, conf_threshold, nms_threshold)
                valids = valids.cpu().numpy()
            outs = outs.cpu().numpy().copy()
            outs[~valids] = 0.0
            valids = valids & np.isfinite(outs).all(axis=2)
            return outs, valids

    def batched_detect_device(self, frames_dev, det_hw,
                              conf_threshold: float = 0.8,
                              nms_threshold: float = 0.4):
        """Detect over a device-resident uint8 BGR batch (B, H, W, 3),
        resized on the device to det_hw. Returns host (B, max_faces, 15)
        in det_hw coordinates and a (B, max_faces) validity mask."""
        pending = self.batched_detect_device_start(
            frames_dev, det_hw, conf_threshold, nms_threshold)
        return self.batched_detect_device_finish(
            frames_dev, det_hw, pending, conf_threshold, nms_threshold)


class YoloFaceDetector(_DetectorService):
    """YOLOv5-face (YOLOv5n or YOLOv5l) with FaceDetector's
    detect_faces() -> (n, 15) surface (the reference YoloDetector's
    [x1, y1, x2, y2, score, lmk * 10], face_detector.py:105-138): RGB /
    255 padded with 114 / 255 to 32-multiples, score objectness x class,
    the top 1024, NMS. Frame by frame: it has no batched entry point, as
    JAX's has none. Weights as FaceDetector's."""

    def __init__(self, model_name: str = 'YOLOv5n',
                 checkpoint: Optional[str] = None,
                 allow_random: bool = False, max_faces: int = 32,
                 pre_nms_topk: int = 1024,
                 dtype: torch.dtype = torch.float32, device='cuda'):
        self.device = torch.device(device)
        self.dtype = dtype
        self.max_faces = max_faces
        self.pre_nms_topk = pre_nms_topk
        variant = 'yolov5l' if model_name.endswith('l') else 'yolov5n'
        self.model = _load_model(YoloFace(variant), model_name, checkpoint,
                                 allow_random, dtype, self.device)
        self._graphs = {}

    def _host_batch(self, imgs: np.ndarray) -> Tuple[torch.Tensor, int, int]:
        """(B, H, W, 3) BGR -> (B, 3, hb, wb) RGB / 255 on the device,
        padded with 114 / 255 to the 32-bucket; uint8 crosses as bytes."""
        b, h, w = imgs.shape[:3]
        hb, wb = self._bucket(h, 32), self._bucket(w, 32)
        x = torch.full((b, 3, hb, wb), 114 / 255.0, dtype=torch.float32,
                       device=self.device)
        rgb = torch.from_numpy(np.ascontiguousarray(imgs)).to(self.device)
        x[:, :, :h, :w] = rgb.permute(0, 3, 1, 2).flip(1).float() / 255.0
        return x, hb, wb

    def _make_graph(self, hw: Tuple[int, int], max_faces: int):
        @torch.inference_mode()
        def run(x, conf_threshold, nms_threshold):
            pred = self.model(x.to(self.dtype))          # (B, N, 16) fp32
            xy, wh = pred[..., 0:2], pred[..., 2:4]
            boxes = torch.cat([xy - wh / 2, xy + wh / 2], dim=-1)
            return _select(boxes, pred[..., 4] * pred[..., 15],
                           pred[..., 5:15], conf_threshold, nms_threshold,
                           self.pre_nms_topk, max_faces)

        return run


def _rows(out: np.ndarray, valid: np.ndarray, h: int, w: int) -> np.ndarray:
    """A frame's valid, finite rows, without those centred in the
    padding: (n, 15)."""
    det = out[valid]
    det = det[np.isfinite(det).all(axis=1)]
    if det.size:
        cx = (det[:, 0] + det[:, 2]) / 2
        cy = (det[:, 1] + det[:, 3]) / 2
        det = det[(cx < w) & (cy < h)]
    return det.reshape(-1, 15)
