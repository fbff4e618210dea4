"""Fused whole-image/video pipeline on the device, counterpart of
codeformer_tpu/pipeline/device_pipeline.py: frames in, restored frames
out, every bulk tensor on the device between stages.

    frames (uint8 BGR, uploaded once)
      -> detect     (device: resize + RetinaFace + NMS; only the
                     (B, max_faces, 15) landmark block crosses to the host)
      -> align      (host: 5-point similarity solves; device: the
                     bilinear warp gather to the face crops)
      -> restore    (device: CodeFormer on the chunk's faces in runs of
                     the restorer's top bucket; its ResBlock convs and
                     Downsamples are the hand-written kernels of
                     ops/conv3x3.py)
      -> parse      (device: ParseNet at parse_res, in the same runs)
      -> composite  (device: inverse warps into per-face windows, erosion,
                     soft edge, parse-guided blend over the upscaled
                     canvas, faces in the reference's overwrite order)
      -> final frames (uint8, fetched once or kept on the device)

JAX traces warp -> restore -> parse -> composite into one merged graph a
chunk, restoring all m face slots in one call; here they are one eager
call sequence on one device, with the same arithmetic and the same order
of blends (a plain loop over blend rounds takes the place of XLA's
unrolled groups), and the restore and parse split into runs so that a
crowded chunk does not run the card out of memory. Frames come in and go
out as uint8 arrays: no cv2 on the device path. cv2 is imported only to
upsample frames whose short side is under 512 (`restore_frames`,
`restore_frames_stream`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from codeformer_tpu_torch.ops.geometry import (estimate_similarity,
                                               invert_affine, resize_linear,
                                               warp_affine)
from .compositor import (_pow2_bucket, _round_up, _shape_parse_masks, blend,
                         edge_width, soft_paste)

# cv2 constant-border gray of align_warp_face (BGR)
_BORDER_BGR = (135.0, 133.0, 132.0)


@dataclass
class ChunkPlan:
    """Host bookkeeping of one chunk: the faces to warp (m slots, a power
    of two; padding slots warp frame 0 with the identity) and the
    composite's c*fpf slots (slot i*fpf + k is frame i's k-th face;
    padding slots sit off the window and blend nothing)."""
    frame_idx: np.ndarray     # (m,) int32: source frame of each face
    affines: np.ndarray       # (m, 2, 3) float32: frame -> template
    face_map: np.ndarray      # (c*fpf,) int32: slot -> face
    inv_affines: np.ndarray   # (c*fpf, 2, 3) float32: face -> window
    roi_pos: np.ndarray       # (c*fpf, 3) int32: (frame, y0, x0)
    m: int
    fpf: int
    w_edge: int
    roi: int                  # window side, or 0 for the whole canvas
    counts: List[int]         # faces of each frame

    def windows_mask(self, shape) -> np.ndarray:
        """(C, H, W) bool of a (C, H, W, 3) result: inside a real face's
        window, or the whole frame of a frame with faces on the
        whole-canvas path. Outside it the result is the upscaled frame."""
        inside = np.zeros(shape[:3], bool)
        for slot in range(len(self.face_map)):
            i, k = divmod(slot, self.fpf)
            if k >= self.counts[i]:
                continue
            if not self.roi:
                inside[i] = True
                continue
            _, y0, x0 = self.roi_pos[slot]
            inside[i, y0:y0 + self.roi, x0:x0 + self.roi] = True
        return inside


class DeviceRestorePipeline:
    """Frames -> restored frames with device-resident intermediates.

    Borrows the detector, parser and template from a FaceRestoreHelper
    and the CodeFormer from a CodeFormerRestorer (its `restore_device`),
    so weights load once. Runs on the restorer's device.
    """

    def __init__(self, restorer, face_helper, upscale: int = 2,
                 frame_chunk: int = 16, detect_resize: int = 640,
                 conf_threshold: float = 0.8,
                 eye_dist_threshold: Optional[float] = 5.0,
                 only_center_face: bool = False, w: float = 0.5,
                 parse_res: int = 256):
        from .detector import FaceDetector
        if not isinstance(face_helper.face_detector, FaceDetector):
            raise NotImplementedError(
                'DeviceRestorePipeline requires a RetinaFace detector '
                '(YOLO keeps its own host preprocessing)')
        self.restorer = restorer
        self.device = restorer.device
        self.helper = face_helper
        self.detector = face_helper.face_detector
        self.upscale = int(upscale)
        self.frame_chunk = frame_chunk
        self.detect_resize = detect_resize
        self.conf_threshold = conf_threshold
        self.eye_dist_threshold = eye_dist_threshold
        self.only_center_face = only_center_face
        self.w = w
        self.use_parse = face_helper.use_parse
        # ParseNet's resolution for the blend mask: 512 is the reference
        # (the parser sees the whole restored face); 256, the default,
        # parses and shapes the mask at half size and resizes the soft
        # mask to 512 (kernel, sigma and border scaled 101/11/10 ->
        # 51/5.5/5), a boundary shift of about 2 px under a >= 49-tap
        # blur (the JAX package's DeviceRestorePipeline.__init__)
        self.parse_res = int(parse_res) if face_helper.use_parse else 512
        self.last_plan: Optional[ChunkPlan] = None

    # ------------------------------------------------------------------
    # device stages
    # ------------------------------------------------------------------
    def _warp(self, frames: torch.Tensor, plan: ChunkPlan) -> torch.Tensor:
        """frames (C, H, W, 3) uint8 BGR -> (m, face, face, 3) uint8 RGB
        crops (the restorer's input). The warp gathers bytes from the
        frames, the frame index folded into the gather."""
        face = self.helper.face_size[0]
        faces = warp_affine(frames, plan.affines, (face, face),
                            border_value=_BORDER_BGR,
                            img_idx=torch.as_tensor(plan.frame_idx,
                                                    device=self.device))
        faces = torch.round(faces.flip(-1)).clamp(0, 255)
        return faces.to(torch.uint8)

    def _parse_ids(self, restored: torch.Tensor) -> torch.Tensor:
        """(m, face, face, 3) uint8 RGB -> (m, parse_res, parse_res) class
        ids."""
        return self.helper._parse(restored, self.parse_res)

    def _restore_parse(self, faces_rgb: torch.Tensor, n_real: int):
        """Restore, then parse, the first `n_real` crops (the real faces;
        the plan's padding slots are never restored) in runs of at most
        the restorer's top bucket, the last run padded with zeros to its
        bucket, as restore_batch runs them: the batch, and so the
        memory, stays bounded however many faces a chunk holds. Returns
        (restored (n, face, face, 3) uint8 RGB, parse ids (n, parse_res,
        parse_res) or None), n = max(n_real, 1). The composite reads only
        real faces (its padding slots map to face 0 and sit off the
        window), so a chunk without faces gets one blank face that
        blends nothing."""
        restorer = self.restorer
        top = restorer.batch_buckets[-1]
        restored, pids = [], []
        for i in range(0, n_real, top):
            run = faces_rgb[i:min(i + top, n_real)]
            r = run.shape[0]
            pad = restorer._bucket(r) - r
            if pad:
                run = torch.cat([run, run.new_zeros((pad, *run.shape[1:]))])
            out = restorer.restore_device(run, self.w, adain=True,
                                          enable_fuse=self.w > 0)
            restored.append(out[:r])
            if self.use_parse:
                pids.append(self._parse_ids(out)[:r])
        if not restored:
            face = faces_rgb.shape[1]
            restored = [faces_rgb.new_zeros((1, face, face, 3))]
            pids = [torch.zeros((1, self.parse_res, self.parse_res),
                                dtype=torch.long, device=self.device)]
        return torch.cat(restored), (torch.cat(pids) if self.use_parse
                                     else None)

    def _composite(self, frames: torch.Tensor, restored: torch.Tensor,
                   pids: Optional[torch.Tensor],
                   plan: ChunkPlan) -> torch.Tensor:
        """Paste the restored faces back: (C, H*up, W*up, 3) uint8 BGR.

        With plan.roi > 0 each face warps and filters into a (roi, roi)
        window of the canvas; else into the whole canvas. Round k warps
        and blends the k-th face of every frame, so later faces blend
        over earlier ones as in the reference's per-face loop, and a
        round's canvases (one a frame, whatever the faces a frame) bound
        the memory. The warp and the blend weights are
        compositor.soft_paste, shared with paste_faces."""
        c, h, w = frames.shape[:3]
        up = self.upscale
        h_up, w_up = h * up, w * up
        hc, wc = _round_up(h_up, 128), _round_up(w_up, 128)
        face = restored.shape[1]
        roi, f = plan.roi, plan.fpf
        out_hw = (roi, roi) if roi else (hc, wc)
        dev = self.device

        canv = resize_linear(frames.permute(0, 3, 1, 2).float(),
                             (h_up, w_up))
        canv = F.pad(canv, (0, wc - w_up, 0, hc - h_up))
        canv = canv.permute(0, 2, 3, 1).contiguous()   # (C, hc, wc, 3)
        if pids is not None:
            pm = _shape_parse_masks(pids, face)
            pm_u8 = torch.round(pm * 255.0).clamp(0, 255).to(torch.uint8)
            src = torch.cat([restored, pm_u8.permute(0, 2, 3, 1)], dim=-1)
        else:
            src = restored
        inv_affines = torch.as_tensor(plan.inv_affines, device=dev)
        face_map = torch.as_tensor(plan.face_map, device=dev)

        def paste_pieces(sel):
            """Warp + filter the slots `sel`: (soft blend weights (n, oh,
            ow, 1), eroded pasted faces (n, oh, ow, 3) BGR)."""
            soft, pasted, _ = soft_paste(
                src, inv_affines[sel], out_hw, up, plan.w_edge,
                parse_div=255.0 if pids is not None else None,
                img_idx=face_map[sel])
            return soft, pasted

        out = canv
        frame_ids = torch.arange(c, device=dev)
        if roi:
            roi_pos = torch.as_tensor(plan.roi_pos, device=dev).long()
            span = torch.arange(roi, device=dev)
        for k in range(f):
            sel = frame_ids * f + k
            soft, pasted = paste_pieces(sel)
            if roi:
                rows = (roi_pos[sel, 1, None] + span)[:, :, None]
                cols = (roi_pos[sel, 2, None] + span)[:, None, :]
                at = (frame_ids[:, None, None], rows, cols)
                out[at] = blend(soft, pasted, out[at])
            else:
                out = blend(soft, pasted, out)
        out = torch.round(out).clamp(0, 255).to(torch.uint8)
        return out[:, :h_up, :w_up]

    # ------------------------------------------------------------------
    # host-side orchestration
    # ------------------------------------------------------------------
    def _landmarks_from_dets(self, dets, valids, det_scale, frame_hw):
        """Filter detections like get_face_landmarks_5; returns a list of
        (n_i, 5, 2) landmark arrays in frame coordinates."""
        h, w = frame_hw
        out = []
        for det_rows, valid in zip(dets, valids):
            rows = det_rows[valid] / det_scale
            landmarks = []
            for bbox in rows:
                eye_dist = np.linalg.norm(
                    [bbox[6] - bbox[8], bbox[7] - bbox[9]])
                if self.eye_dist_threshold is not None and \
                        eye_dist < self.eye_dist_threshold:
                    continue
                landmarks.append(
                    np.array([[bbox[i], bbox[i + 1]]
                              for i in range(5, 15, 2)]))
            if self.only_center_face and landmarks:
                centers = [lm.mean(0) for lm in landmarks]
                mid = np.array([w / 2, h / 2])
                idx = int(np.argmin(
                    [np.linalg.norm(cc - mid) for cc in centers]))
                landmarks = [landmarks[idx]]
            out.append(landmarks)
        return out

    def _det_hw(self, h: int, w: int):
        det_scale = self.detect_resize / min(h, w)
        return det_scale, (int(h * det_scale), int(w * det_scale))

    def _detect_start(self, frames_dev):
        """Enqueue this chunk's detection."""
        _, det_hw = self._det_hw(*frames_dev.shape[1:3])
        return self.detector.batched_detect_device_start(
            frames_dev, det_hw, conf_threshold=self.conf_threshold)

    def _plan(self, per_frame, frame_hw: Tuple[int, int]) -> ChunkPlan:
        """Affine solves, buckets, the edge width and the windows of one
        chunk (host, tiny)."""
        h, w = frame_hw
        c = len(per_frame)
        template = self.helper.face_template
        face = self.helper.face_size[0]
        up = self.upscale

        frame_idx, affines, inv_affines = [], [], []
        face_map = []  # per frame: indices into the flat face list
        for i, landmarks in enumerate(per_frame):
            ids = []
            for lm in landmarks:
                a = estimate_similarity(lm, template)
                ia = invert_affine(a, up)
                if up > 1:
                    ia = ia.copy()
                    ia[:, 2] += 0.5 * up
                ids.append(len(frame_idx))
                frame_idx.append(i)
                affines.append(a)
                inv_affines.append(ia)
            face_map.append(ids)

        n_real = len(frame_idx)
        m = _pow2_bucket(max(n_real, 1))
        fpf = _pow2_bucket(max(max((len(x) for x in face_map), default=0),
                               1))
        a_pad = np.zeros((m, 2, 3), np.float32)
        a_pad[:, 0, 0] = a_pad[:, 1, 1] = 1.0
        idx_pad = np.zeros((m,), np.int32)
        for j, (fi, a) in enumerate(zip(frame_idx, affines)):
            idx_pad[j] = fi
            a_pad[j] = a

        # composite inputs: c*fpf slots, dummies parked off the window
        cf = c * fpf
        map_pad = np.zeros((cf,), np.int32)
        ia_pad = np.zeros((cf, 2, 3), np.float32)
        ia_pad[:, 0, 0] = ia_pad[:, 1, 1] = 1.0
        ia_pad[:, 0, 2] = -4 * face  # off the window -> zero coverage
        areas = []  # real faces only (dummies must not set w_edge)
        bboxes = {}  # slot -> (y0, y1, x0, x1) on the upscaled canvas
        corners_face = np.array([[0, 0, 1], [face, 0, 1], [0, face, 1],
                                 [face, face, 1]], np.float32)
        for i, ids in enumerate(face_map):
            for k, j in enumerate(ids):
                slot = i * fpf + k
                map_pad[slot] = j
                ia_pad[slot] = inv_affines[j]
                det = abs(inv_affines[j][0, 0] * inv_affines[j][1, 1]
                          - inv_affines[j][0, 1] * inv_affines[j][1, 0])
                areas.append(face * face * det)
                cc = corners_face @ inv_affines[j].T  # (4, 2) = (x, y)
                bboxes[slot] = (cc[:, 1].min(), cc[:, 1].max(),
                                cc[:, 0].min(), cc[:, 0].max())
        w_edge = edge_width(max(areas, default=float(face * face)))

        # per-face windows when every face (+ margin) fits one. The soft
        # edge cannot spill past the warped face's coverage: the erosion
        # by 2*w_edge pulls the boundary in by w_edge and the
        # (2*w_edge+1)-tap blur pushes it back out by exactly w_edge, so
        # outside the face's bounding box (+1 px for the even kernel's
        # asymmetry, +1 px rounding) the blend returns the background
        # bit-exactly, and a fixed 8 px margin loses nothing
        hc, wc = _round_up(h * up, 128), _round_up(w * up, 128)
        margin = 8
        extent = max((max(y1 - y0, x1 - x0)
                      for y0, y1, x0, x1 in bboxes.values()), default=0)
        roi = _round_up(int(extent) + 2 * margin + 2, 32)
        roi_pos = np.zeros((cf, 3), np.int32)
        if 0 < roi < min(hc, wc):
            for slot, (y0, _, x0, _) in bboxes.items():
                yy = int(np.clip(np.floor(y0) - margin, 0, hc - roi))
                xx = int(np.clip(np.floor(x0) - margin, 0, wc - roi))
                roi_pos[slot] = (slot // fpf, yy, xx)
                ia_pad[slot][:, 2] -= (xx, yy)  # window-local coords
        else:
            roi = 0  # face ~ canvas: the whole-canvas path
        return ChunkPlan(idx_pad, a_pad, map_pad, ia_pad, roi_pos, m, fpf,
                         w_edge, roi, [len(ids) for ids in face_map])

    @torch.inference_mode()
    def _restore_chunk_device(self, frames_dev, pending_dets=None,
                              collect_faces=None):
        """(C, H, W, 3) uint8 BGR on the device -> (C, H*up, W*up, 3)
        uint8 BGR on the device. `pending_dets`: this chunk's
        `_detect_start`, made earlier so the next chunk's detection is
        already queued while the host solves this one's affines.
        `collect_faces`: optional list; gets (cropped RGB (m, face, face,
        3), restored RGB of the real faces (`_restore_parse`), faces of
        each frame) for callers that save faces (the folder CLI)."""
        c, h, w = frames_dev.shape[:3]
        det_scale, det_hw = self._det_hw(h, w)
        if pending_dets is None:
            pending_dets = self._detect_start(frames_dev)
        dets, valids = self.detector.batched_detect_device_finish(
            frames_dev, det_hw, pending_dets,
            conf_threshold=self.conf_threshold)
        per_frame = self._landmarks_from_dets(dets, valids, det_scale,
                                              (h, w))
        plan = self._plan(per_frame, (h, w))
        self.last_plan = plan
        faces_rgb = self._warp(frames_dev, plan)
        restored, pids = self._restore_parse(faces_rgb, sum(plan.counts))
        out = self._composite(frames_dev, restored, pids, plan)
        if collect_faces is not None:
            collect_faces.append((faces_rgb, restored, plan.counts))
        return out

    def restore_frames_device(self, frames, collect_faces=None):
        """frames: (N, H, W, 3) uint8 BGR (numpy or tensor). Returns the
        restored (N, H*up, W*up, 3) uint8 BGR as a tensor on the
        device."""
        frames = torch.as_tensor(frames, device=self.device)
        n = frames.shape[0]
        ck = min(self.frame_chunk, n)  # short inputs run at their size
        chunks, reals = [], []
        for i in range(0, n, ck):
            r = min(ck, n - i)  # real frames in this chunk
            chunk = frames[i:i + r]
            if r < ck:
                chunk = torch.cat([chunk, chunk[-1:].expand(
                    ck - r, *chunk.shape[1:])])
            chunks.append(chunk)
            reals.append(r)
        # chunk k+1's detection is queued before chunk k's results are
        # fetched
        outs = []
        pending = self._detect_start(chunks[0])
        for i, (chunk, r) in enumerate(zip(chunks, reals)):
            nxt = self._detect_start(chunks[i + 1]) \
                if i + 1 < len(chunks) else None
            outs.append(self._restore_chunk_device(
                chunk, pending_dets=pending,
                collect_faces=collect_faces)[:r])
            pending = nxt
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def restore_frames_stream(self, frames_iter):
        """Bounded-memory streaming form of restore_frames: uint8 BGR
        frames from an iterator in, restored frames (numpy uint8 BGR) out,
        in order. At most two chunks are held; chunk k+1 is read and its
        detection queued before chunk k is restored. The output equals
        restore_frames on the same list (same chunking, a short first
        chunk run at its size, the tail padded by repeating its last
        frame)."""
        it = iter(frames_iter)
        first = next(it, None)
        if first is None:
            return
        scale = 1.0
        if min(first.shape[:2]) < 512:
            scale = 512.0 / min(first.shape[:2])

        def prep(fr):
            if scale != 1.0:
                import cv2
                fr = cv2.resize(fr, (0, 0), fx=scale, fy=scale,
                                interpolation=cv2.INTER_LINEAR)
            return fr

        def chunked():
            buf = [prep(first)]
            for fr in it:
                buf.append(prep(fr))
                if len(buf) == self.frame_chunk:
                    yield buf
                    buf = []
            if buf:
                yield buf

        prev = None  # (device chunk, pending detection, real frames)
        for buf in chunked():
            r = len(buf)
            arr = np.stack(buf)
            if r < self.frame_chunk and prev is not None:
                arr = np.concatenate(
                    [arr, np.repeat(arr[-1:], self.frame_chunk - r,
                                    axis=0)])
            chunk = torch.as_tensor(arr, device=self.device)
            pending = self._detect_start(chunk)
            if prev is not None:
                out = self._restore_chunk_device(prev[0],
                                                 pending_dets=prev[1])
                yield from out[:prev[2]].cpu().numpy()
            prev = (chunk, pending, r)
        out = self._restore_chunk_device(prev[0], pending_dets=prev[1])
        yield from out[:prev[2]].cpu().numpy()

    def restore_frames(self, frames: List[np.ndarray],
                       return_faces: bool = False):
        """Host-facing wrapper: the min-side-512 upscale rule, then the
        final frames fetched (the only bulk device -> host copy).

        return_faces=True also returns, a frame, the list of
        (cropped_face_bgr, restored_face_bgr) uint8 pairs, which the
        folder CLI saves (reference inference_codeformer.py:215-228)."""
        if not len(frames):
            return ([], []) if return_faces else []
        if min(frames[0].shape[:2]) < 512:
            import cv2
            f = 512.0 / min(frames[0].shape[:2])
            frames = [cv2.resize(fr, (0, 0), fx=f, fy=f,
                                 interpolation=cv2.INTER_LINEAR)
                      for fr in frames]
        collect = [] if return_faces else None
        out = self.restore_frames_device(np.stack(frames),
                                         collect_faces=collect)
        out = list(out.cpu().numpy())
        if not return_faces:
            return out
        faces_per_frame = []
        for cropped, restored, counts in collect:
            cropped = cropped.cpu().numpy()
            restored = restored.cpu().numpy()
            j = 0
            for n_faces in counts:
                faces_per_frame.append(
                    [(cropped[j + k][..., ::-1], restored[j + k][..., ::-1])
                     for k in range(n_faces)])
                j += n_faces
        # padded tail chunks repeat the last frame; drop their records
        return out, faces_per_frame[:len(frames)]
