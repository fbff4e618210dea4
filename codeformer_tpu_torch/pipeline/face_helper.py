"""FaceRestoreHelper, counterpart of codeformer_tpu/pipeline/
face_helper.py (the reference's facelib/utils/face_restoration_helper.py:
54-525): the FFHQ 5-point template, the detector and the parser, shared
with DeviceRestorePipeline, and the classic per-image path: read ->
detect -> filter -> align-warp -> (restore) -> parse-guided paste-back.

The detector and the parser run on the helper's device. The classic
path's host steps (read, resize, landmark solves, the align warp, the
inverse affines) go through cv2, as the JAX package's do; the paste-back
defaults to the device compositor (compositor.paste_faces), and the cv2
transcription of the reference's per-face compositing stays as the
pixel-parity oracle (compositor='cv2') and as the automatic fallback for
inputs the device compositor does not cover (16-bit, an alpha canvas, a
non-square crop_ratio). cv2 is imported inside the methods that use it.
The dlib detector is not ported (ROADMAP.md Queue 1 item 3).
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
from codeformer_tpu_torch.utils.img_util import (adain_color_transfer,
                                                 bgr2gray3, imwrite, is_gray,
                                                 normalize_img_dtype)
from .compositor import MASK_COLORMAP

PARSENET_WEIGHTS = 'weights/facelib/parsing_parsenet.pth'


def get_largest_face(det_faces, h, w):
    """(face_restoration_helper.py:18-37)"""
    def get_location(val, length):
        return max(min(val, length), 0)
    face_areas = []
    for det_face in det_faces:
        left = get_location(det_face[0], w)
        right = get_location(det_face[2], w)
        top = get_location(det_face[1], h)
        bottom = get_location(det_face[3], h)
        face_areas.append((right - left) * (bottom - top))
    largest_idx = int(np.argmax(face_areas))
    return [det_faces[largest_idx]], largest_idx


def get_center_face(det_faces, h=0, w=0, center=None):
    """(face_restoration_helper.py:40-51)"""
    if center is not None:
        center = np.array(center)
    else:
        center = np.array([w / 2, h / 2])
    dists = []
    for det_face in det_faces:
        face_center = np.array([(det_face[0] + det_face[2]) / 2,
                                (det_face[1] + det_face[3]) / 2])
        dists.append(np.linalg.norm(face_center - center))
    center_idx = int(np.argmin(dists))
    return [det_faces[center_idx]], center_idx


class FaceRestoreHelper:
    """Template, detector, parser and the classic per-image surface.

    det_dtype / parse_dtype: the detector's and parser's compute types
    (float32 matches the reference and is the classic path's; the fused
    pipeline runs both in bfloat16 on the card, as the JAX package does
    on the TPU). compositor: 'xla' (the device compositor, named as the
    JAX CLI's flag) or 'cv2' (the reference's per-face transcription).
    Weights come from weights/facelib/*.pth when present, else a seeded
    random init (seed 0) if `allow_random_weights`, else
    FileNotFoundError.
    """

    def __init__(self, upscale_factor: int, face_size: int = 512,
                 crop_ratio=(1, 1), det_model: str = 'retinaface_resnet50',
                 save_ext: str = 'png', template_3points: bool = False,
                 pad_blur: bool = False, use_parse: bool = False,
                 device='cuda', allow_random_weights: bool = False,
                 detector=None, compositor: str = 'xla',
                 det_dtype: torch.dtype = torch.float32,
                 parse_dtype: torch.dtype = torch.float32):
        if det_model == 'dlib':
            raise NotImplementedError(
                'the dlib detector is not ported yet (ROADMAP.md Queue 1 '
                'item 3)')
        if compositor not in ('xla', 'cv2'):
            raise ValueError(f'compositor must be xla or cv2, got '
                             f'{compositor!r}')
        self.compositor = compositor
        self.template_3points = template_3points
        self.upscale_factor = int(upscale_factor)
        self.crop_ratio = crop_ratio
        if crop_ratio[0] < 1 or crop_ratio[1] < 1:
            raise ValueError('crop ratio only supports >= 1')
        self.face_size = (int(face_size * crop_ratio[1]),
                          int(face_size * crop_ratio[0]))
        self.det_model = det_model
        self.device = torch.device(device)

        # the facexlib FFHQ templates at 512 (face_restoration_helper.py:
        # 76-93), shifted for crop_ratio > 1
        if self.template_3points:
            self.face_template = np.array(
                [[192, 240], [319, 240], [257, 371]], np.float32)
        else:
            self.face_template = np.array(
                [[192.98138, 239.94708], [318.90277, 240.1936],
                 [256.63416, 314.01935], [201.26117, 371.41043],
                 [313.08905, 371.15118]], np.float32)
        self.face_template = self.face_template * (face_size / 512.0)
        if self.crop_ratio[0] > 1:
            self.face_template[:, 1] += face_size * (
                self.crop_ratio[0] - 1) / 2
        if self.crop_ratio[1] > 1:
            self.face_template[:, 0] += face_size * (
                self.crop_ratio[1] - 1) / 2
        self.save_ext = save_ext
        self.pad_blur = pad_blur
        if self.pad_blur:
            self.template_3points = False

        self.all_landmarks_5: List[np.ndarray] = []
        self.det_faces: List[np.ndarray] = []
        self.affine_matrices: List[np.ndarray] = []
        self.inverse_affine_matrices: List[np.ndarray] = []
        self.cropped_faces: List[np.ndarray] = []
        self.restored_faces: List[np.ndarray] = []
        self.pad_input_imgs: List[np.ndarray] = []
        self.is_gray = False
        self._precomputed_parse_ids = None  # batched folder / video paths

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

    def set_upscale_factor(self, upscale_factor):
        self.upscale_factor = upscale_factor

    def read_image(self, img):
        """img: path or BGR array. Normalizes to uint8 BGR and upsamples so
        min side >= 512 (face_restoration_helper.py:130-150)."""
        import cv2
        if isinstance(img, str):
            img = cv2.imread(img)
        if np.max(img) > 256:  # 16-bit
            img = (img / 65535 * 255).astype(np.uint8)
        img = normalize_img_dtype(np.asarray(img))
        self.input_img = img
        self.is_gray = is_gray(img, threshold=10)
        if self.is_gray:
            print('Grayscale input: True')
        if min(self.input_img.shape[:2]) < 512:
            f = 512.0 / min(self.input_img.shape[:2])
            self.input_img = cv2.resize(self.input_img, (0, 0), fx=f, fy=f,
                                        interpolation=cv2.INTER_LINEAR)

    def get_face_landmarks_5(self, only_keep_largest=False,
                             only_center_face=False, resize=None,
                             blur_ratio=0.01,
                             eye_dist_threshold=None) -> int:
        """Detect, filter and keep each face's 5 landmarks
        (face_restoration_helper.py:195-317); with pad_blur, the
        reference's reflect + blur padded input a face."""
        import cv2
        if resize is None:
            scale = 1.0
            input_img = self.input_img
        else:
            h, w = self.input_img.shape[0:2]
            scale = resize / min(h, w)
            h, w = int(h * scale), int(w * scale)
            interp = cv2.INTER_AREA if scale < 1 else cv2.INTER_LINEAR
            input_img = cv2.resize(self.input_img, (w, h),
                                   interpolation=interp)

        bboxes = self.face_detector.detect_faces(input_img)
        if bboxes is None or bboxes.shape[0] == 0:
            return 0
        bboxes = bboxes / scale

        for bbox in bboxes:
            eye_dist = np.linalg.norm(
                [bbox[6] - bbox[8], bbox[7] - bbox[9]])
            if eye_dist_threshold is not None and \
                    eye_dist < eye_dist_threshold:
                continue
            if self.template_3points:
                landmark = np.array(
                    [[bbox[i], bbox[i + 1]] for i in range(5, 11, 2)])
            else:
                landmark = np.array(
                    [[bbox[i], bbox[i + 1]] for i in range(5, 15, 2)])
            self.all_landmarks_5.append(landmark)
            self.det_faces.append(bbox[0:5])

        if len(self.det_faces) == 0:
            return 0
        if only_keep_largest:
            h, w, _ = self.input_img.shape
            self.det_faces, largest_idx = get_largest_face(
                self.det_faces, h, w)
            self.all_landmarks_5 = [self.all_landmarks_5[largest_idx]]
        elif only_center_face:
            h, w, _ = self.input_img.shape
            self.det_faces, center_idx = get_center_face(
                self.det_faces, h, w)
            self.all_landmarks_5 = [self.all_landmarks_5[center_idx]]

        # pad blurry surroundings (FFHQ reflect+blur padding,
        # face_restoration_helper.py:249-315)
        if self.pad_blur:
            from .face_utils import ffhq_quad
            self.pad_input_imgs = []
            for landmarks in self.all_landmarks_5:
                quad, qsize = ffhq_quad(landmarks,
                                        shrink_ratio=(1.5, 1.5))
                border = max(int(np.rint(qsize * 0.1)), 3)
                pad = (int(np.floor(min(quad[:, 0]))),
                       int(np.floor(min(quad[:, 1]))),
                       int(np.ceil(max(quad[:, 0]))),
                       int(np.ceil(max(quad[:, 1]))))
                pad = [max(-pad[0] + border, 1),
                       max(-pad[1] + border, 1),
                       max(pad[2] - self.input_img.shape[0] + border, 1),
                       max(pad[3] - self.input_img.shape[1] + border, 1)]
                if max(pad) > 1:
                    pad_img = np.pad(self.input_img,
                                     ((pad[1], pad[3]), (pad[0], pad[2]),
                                      (0, 0)), 'reflect')
                    landmarks[:, 0] += pad[0]
                    landmarks[:, 1] += pad[1]
                    h, w, _ = pad_img.shape
                    yy, xx, _ = np.ogrid[:h, :w, :1]
                    mask = np.maximum(
                        1.0 - np.minimum(np.float32(xx) / pad[0],
                                         np.float32(w - 1 - xx) / pad[2]),
                        1.0 - np.minimum(np.float32(yy) / pad[1],
                                         np.float32(h - 1 - yy) / pad[3]))
                    blur = int(qsize * blur_ratio)
                    if blur % 2 == 0:
                        blur += 1
                    blur_img = cv2.boxFilter(pad_img, 0,
                                             ksize=(blur, blur))
                    pad_img = pad_img.astype('float32')
                    pad_img += (blur_img - pad_img) * np.clip(
                        mask * 3.0 + 1.0, 0.0, 1.0)
                    pad_img += (np.median(pad_img, axis=(0, 1)) - pad_img
                                ) * np.clip(mask, 0.0, 1.0)
                    self.pad_input_imgs.append(np.clip(pad_img, 0, 255))
                else:
                    self.pad_input_imgs.append(np.copy(self.input_img))
        return len(self.det_faces)

    def align_warp_face(self, save_cropped_path=None,
                        border_mode='constant'):
        """5-landmark similarity alignment + warp to the template
        (face_restoration_helper.py:319-349)."""
        import cv2
        border = {'constant': cv2.BORDER_CONSTANT,
                  'reflect101': cv2.BORDER_REFLECT101,
                  'reflect': cv2.BORDER_REFLECT}[border_mode]
        if self.pad_blur and \
                len(self.pad_input_imgs) != len(self.all_landmarks_5):
            raise ValueError(
                f'pad_blur: {len(self.pad_input_imgs)} padded inputs for '
                f'{len(self.all_landmarks_5)} faces')
        for idx, landmark in enumerate(self.all_landmarks_5):
            affine_matrix = cv2.estimateAffinePartial2D(
                landmark, self.face_template, method=cv2.LMEDS)[0]
            self.affine_matrices.append(affine_matrix)
            input_img = (self.pad_input_imgs[idx] if self.pad_blur
                         else self.input_img)
            cropped_face = cv2.warpAffine(
                input_img, affine_matrix, self.face_size,
                borderMode=border, borderValue=(135, 133, 132))
            self.cropped_faces.append(cropped_face)
            if save_cropped_path is not None:
                path = os.path.splitext(save_cropped_path)[0]
                imwrite(cropped_face, f'{path}_{idx:02d}.{self.save_ext}')

    def get_inverse_affine(self, save_inverse_affine_path=None):
        """Each face's inverse affine, scaled to the upscaled output
        (face_restoration_helper.py:351-361)."""
        import cv2
        for affine_matrix in self.affine_matrices:
            inverse_affine = cv2.invertAffineTransform(affine_matrix)
            inverse_affine *= self.upscale_factor
            self.inverse_affine_matrices.append(inverse_affine)

    def add_restored_face(self, restored_face, input_face=None):
        """Keep a restored face; a gray input's face goes gray and takes
        the input face's tone (face_restoration_helper.py:363-370)."""
        if self.is_gray:
            restored_face = bgr2gray3(restored_face)
            if input_face is not None:
                restored_face = adain_color_transfer(restored_face,
                                                     input_face)
        self.restored_faces.append(restored_face)

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
        device batches of 8. A face not of 512x512 (an upsampled face) is
        resized to it with cv2 first, as the JAX helper resizes every
        face (a resize to its own size is a copy there)."""
        faces = []
        for f in restored_faces:
            if f.shape[:2] != (512, 512):
                import cv2
                f = cv2.resize(f, (512, 512),
                               interpolation=cv2.INTER_LINEAR)
            faces.append(f[..., ::-1])
        batch = np.stack(faces).astype(np.uint8)
        outs = [self._parse(torch.from_numpy(batch[i:i + 8]).to(
            self.device)).cpu().numpy() for i in range(0, len(batch), 8)]
        return np.concatenate(outs)

    def paste_faces_to_input_image(self, save_path=None, upsample_img=None,
                                   draw_box=False, face_upsampler=None):
        """Inverse-warp each restored face onto the (upscaled) input with
        erosion + soft-edge + parse-guided masks
        (face_restoration_helper.py:372-516)."""
        import cv2
        h, w, _ = self.input_img.shape
        h_up, w_up = (int(h * self.upscale_factor),
                      int(w * self.upscale_factor))

        if upsample_img is None:
            upsample_img = cv2.resize(self.input_img, (w_up, h_up),
                                      interpolation=cv2.INTER_LINEAR)
        else:
            upsample_img = cv2.resize(upsample_img, (w_up, h_up),
                                      interpolation=cv2.INTER_LANCZOS4)

        if len(self.restored_faces) != len(self.inverse_affine_matrices):
            raise ValueError(
                f'{len(self.restored_faces)} restored faces for '
                f'{len(self.inverse_affine_matrices)} inverse affines')

        use_device = (self.compositor == 'xla' and upsample_img.ndim == 3
                      and upsample_img.shape[2] == 3
                      and np.max(upsample_img) <= 256
                      and self.face_size[0] == self.face_size[1])
        # reference upsamples every restored face before pasting,
        # independent of use_parse (face_restoration_helper.py:386-391)
        upsampled_faces = None
        if face_upsampler is not None and self.restored_faces:
            upsampled_faces = [
                face_upsampler.enhance(f, outscale=self.upscale_factor)[0]
                for f in self.restored_faces]

        if self.use_parse and self.restored_faces and \
                self._precomputed_parse_ids is not None:
            parse_ids = self._precomputed_parse_ids
        elif self.use_parse and self.restored_faces:
            # batched device parsing (the reference parses per face, on the
            # upsampled face when a face_upsampler is given)
            parse_ids = self._parse_masks(upsampled_faces
                                          or self.restored_faces)
        else:
            parse_ids = [None] * len(self.restored_faces)

        if use_device:
            from .compositor import paste_faces
            inv_affines = []
            for inverse_affine in self.inverse_affine_matrices:
                ia = inverse_affine.copy()
                if face_upsampler is not None:
                    # upsampled faces: rescale the linear part, keep the
                    # translation at output scale (reference :387-390)
                    ia = ia / self.upscale_factor
                    ia[:, 2] *= self.upscale_factor
                elif self.upscale_factor > 1:
                    ia[:, 2] += 0.5 * self.upscale_factor
                inv_affines.append(ia)
            faces = (upsampled_faces if face_upsampler is not None
                     else self.restored_faces)
            out = paste_faces(
                upsample_img, faces, inv_affines,
                parse_ids if self.use_parse else None,
                self.upscale_factor, draw_box=draw_box, device=self.device)
            if save_path is not None:
                path = os.path.splitext(save_path)[0]
                imwrite(out, f'{path}.{self.save_ext}')
            return out

        inv_mask_borders = []
        upsample_img = upsample_img.astype(np.float32)
        for i, (restored_face, inverse_affine) in enumerate(
                zip(self.restored_faces, self.inverse_affine_matrices)):
            if face_upsampler is not None:
                restored_face = upsampled_faces[i]
                inverse_affine = inverse_affine / self.upscale_factor
                inverse_affine[:, 2] *= self.upscale_factor
                face_size = (self.face_size[0] * self.upscale_factor,
                             self.face_size[1] * self.upscale_factor)
            else:
                extra_offset = (0.5 * self.upscale_factor
                                if self.upscale_factor > 1 else 0)
                inverse_affine = inverse_affine.copy()
                inverse_affine[:, 2] += extra_offset
                face_size = self.face_size
            inv_restored = cv2.warpAffine(restored_face, inverse_affine,
                                          (w_up, h_up))

            # square mask, eroded to kill warp borders
            mask = np.ones(face_size, dtype=np.float32)
            inv_mask = cv2.warpAffine(mask, inverse_affine, (w_up, h_up))
            k = int(2 * self.upscale_factor)
            inv_mask_erosion = cv2.erode(inv_mask,
                                         np.ones((k, k), np.uint8))
            pasted_face = inv_mask_erosion[:, :, None] * inv_restored
            total_face_area = np.sum(inv_mask_erosion)
            if draw_box:
                hh, ww = face_size
                mask_border = np.ones((hh, ww, 3), dtype=np.float32)
                border = int(1400 / np.sqrt(total_face_area))
                mask_border[border:hh - border, border:ww - border, :] = 0
                inv_mask_borders.append(
                    cv2.warpAffine(mask_border, inverse_affine,
                                   (w_up, h_up)))

            # fusion edge sized by face area
            w_edge = int(total_face_area ** 0.5) // 20
            erosion_radius = w_edge * 2
            inv_mask_center = cv2.erode(
                inv_mask_erosion,
                np.ones((erosion_radius, erosion_radius), np.uint8))
            blur_size = w_edge * 2
            inv_soft_mask = cv2.GaussianBlur(
                inv_mask_center, (blur_size + 1, blur_size + 1), 0)
            inv_soft_mask = inv_soft_mask[:, :, None]

            if self.use_parse:
                out_ids = parse_ids[i]
                parse_mask = np.zeros(out_ids.shape, np.float32)
                for idx, color in enumerate(MASK_COLORMAP):
                    parse_mask[out_ids == idx] = color
                parse_mask = cv2.GaussianBlur(parse_mask, (101, 101), 11)
                parse_mask = cv2.GaussianBlur(parse_mask, (101, 101), 11)
                thres = 10
                parse_mask[:thres, :] = 0
                parse_mask[-thres:, :] = 0
                parse_mask[:, :thres] = 0
                parse_mask[:, -thres:] = 0
                parse_mask = parse_mask / 255.0
                parse_mask = cv2.resize(parse_mask, face_size)
                parse_mask = cv2.warpAffine(parse_mask, inverse_affine,
                                            (w_up, h_up), flags=3)
                inv_soft_parse_mask = parse_mask[:, :, None]
                fuse_mask = (inv_soft_parse_mask
                             < inv_soft_mask).astype('int')
                inv_soft_mask = (inv_soft_parse_mask * fuse_mask
                                 + inv_soft_mask * (1 - fuse_mask))

            if upsample_img.ndim == 3 and upsample_img.shape[2] == 4:
                alpha = upsample_img[:, :, 3:]
                upsample_img = (inv_soft_mask * pasted_face
                                + (1 - inv_soft_mask)
                                * upsample_img[:, :, 0:3])
                upsample_img = np.concatenate((upsample_img, alpha), axis=2)
            else:
                upsample_img = (inv_soft_mask * pasted_face
                                + (1 - inv_soft_mask) * upsample_img)

        if np.max(upsample_img) > 256:
            upsample_img = upsample_img.astype(np.uint16)
        else:
            upsample_img = upsample_img.astype(np.uint8)

        if draw_box:
            img_color = np.ones(upsample_img.shape, dtype=np.float32)
            img_color[:, :, 0] = 0
            img_color[:, :, 1] = 255
            img_color[:, :, 2] = 0
            for inv_mask_border in inv_mask_borders:
                upsample_img = (inv_mask_border * img_color
                                + (1 - inv_mask_border) * upsample_img)
            upsample_img = upsample_img.astype(np.uint8)

        if save_path is not None:
            path = os.path.splitext(save_path)[0]
            save_path = f'{path}.{self.save_ext}'
            imwrite(upsample_img, save_path)
        return upsample_img

    def clean_all(self):
        self.all_landmarks_5 = []
        self.det_faces = []
        self.affine_matrices = []
        self.inverse_affine_matrices = []
        self.cropped_faces = []
        self.restored_faces = []
        self.pad_input_imgs = []
