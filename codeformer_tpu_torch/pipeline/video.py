"""Batched video restoration on the classic per-stage path, counterpart
of codeformer_tpu/pipeline/video.py: frames flow through each neural
stage in batches instead of the reference's strictly per-frame loop
(inference_codeformer.py:90-109). The host steps (resizes, landmark
solves, the align warp) are cv2's, as the JAX package's; detection,
restoration, parsing and the default compositor run on the helper's and
the restorer's device.

Stages:
  1. detection: same-size frames run through the detector in chunks
     (FaceDetector.batched_detect_faces)
  2. alignment: host-side 5-landmark similarity solves + warps (cheap)
  3. restoration: ALL faces of the chunk in one CodeFormer batch
  4. parsing: all faces in one ParseNet batch
  5. paste-back: per frame (the device compositor or the cv2 parity
     path)
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np

from codeformer_tpu_torch.utils.profiler import stage
from .face_helper import FaceRestoreHelper


def restore_video_frames(frames: List[np.ndarray], restorer,
                         face_helper: FaceRestoreHelper,
                         w: float = 0.5, upscale: int = 2,
                         only_center_face: bool = False,
                         detect_chunk: int = 8,
                         eye_dist_threshold: float = 5.0,
                         resize: int = 640) -> List[np.ndarray]:
    """Returns the restored frames (uint8 BGR, upscaled)."""
    import cv2
    n = len(frames)
    if n == 0:
        return []
    # min side >= 512 like read_image (face_restoration_helper.py:148-150)
    if min(frames[0].shape[:2]) < 512:
        f = 512.0 / min(frames[0].shape[:2])
        frames = [cv2.resize(fr, (0, 0), fx=f, fy=f,
                             interpolation=cv2.INTER_LINEAR)
                  for fr in frames]
    h0, w0 = frames[0].shape[:2]

    # frames share a size -> one detector scale for the whole video
    scale = resize / min(h0, w0)
    interp = cv2.INTER_AREA if scale < 1 else cv2.INTER_LINEAR
    dh, dw = int(h0 * scale), int(w0 * scale)

    # ---- stage 1: batched detection ----
    all_dets: List[np.ndarray] = []
    detector = face_helper.face_detector
    with stage('video_detect'):
        for i in range(0, n, detect_chunk):
            chunk = frames[i:i + detect_chunk]
            small = np.stack([
                cv2.resize(f, (dw, dh), interpolation=interp)
                for f in chunk])
            dets = detector.batched_detect_faces(small)
            all_dets.extend(d / scale for d in dets)

    # ---- stage 2: per-frame landmark filtering + alignment (host) ----
    per_frame: List[Dict] = []
    all_faces: List[np.ndarray] = []
    with stage('video_align'):
        for frame, dets in zip(frames, all_dets):
            landmarks = []
            for bbox in dets:
                eye_dist = np.linalg.norm(
                    [bbox[6] - bbox[8], bbox[7] - bbox[9]])
                if eye_dist_threshold is not None and \
                        eye_dist < eye_dist_threshold:
                    continue
                landmarks.append(
                    np.array([[bbox[i], bbox[i + 1]]
                              for i in range(5, 15, 2)]))
            if only_center_face and landmarks:
                centers = [lm.mean(0) for lm in landmarks]
                mid = np.array([w0 / 2, h0 / 2])
                idx = int(np.argmin(
                    [np.linalg.norm(c - mid) for c in centers]))
                landmarks = [landmarks[idx]]
            affines, faces = [], []
            for lm in landmarks:
                affine = cv2.estimateAffinePartial2D(
                    lm, face_helper.face_template, method=cv2.LMEDS)[0]
                affines.append(affine)
                faces.append(cv2.warpAffine(
                    frame, affine, face_helper.face_size,
                    borderMode=cv2.BORDER_CONSTANT,
                    borderValue=(135, 133, 132)))
            per_frame.append({'affines': affines,
                              'faces': list(range(len(all_faces),
                                                  len(all_faces)
                                                  + len(faces)))})
            all_faces.extend(faces)

    # ---- stage 3: one restoration batch over every face ----
    with stage('video_restore'):
        restored = restorer.restore_batch(all_faces, w=w, adain=True) \
            if all_faces else []

    # ---- stage 4: one parsing batch over every face ----
    parse_ids = None
    if face_helper.use_parse and restored:
        with stage('video_parse'):
            parse_ids = face_helper._parse_masks(restored)

    # ---- stage 5: per-frame paste-back ----
    out_frames: List[np.ndarray] = []
    with stage('video_paste'):
        for frame, info in zip(frames, per_frame):
            face_helper.clean_all()
            face_helper.input_img = frame
            face_helper.affine_matrices = info['affines']
            face_helper.restored_faces = [restored[j]
                                          for j in info['faces']]
            face_helper.get_inverse_affine(None)
            if parse_ids is not None:
                ids = np.stack([parse_ids[j] for j in info['faces']]) \
                    if info['faces'] else None
            else:
                ids = None
            # reuse the helper compositor with precomputed parse ids
            face_helper._precomputed_parse_ids = ids
            try:
                out = face_helper.paste_faces_to_input_image()
            finally:
                face_helper._precomputed_parse_ids = None
            out_frames.append(out)
    return out_frames
