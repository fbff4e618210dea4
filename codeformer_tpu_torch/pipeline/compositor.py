"""The paste-back compositor on the device, counterpart of
codeformer_tpu/pipeline/compositor_xla.py: the reference's
FaceRestoreHelper.paste_faces_to_input_image
(face_restoration_helper.py:372-516) as batched tensor work.

One compositing core serves both callers: `soft_paste` warps each face
(with its shaped parse mask and draw-box border as extra channels) and
builds its blend weights, and `blend` lays a face over what is under
it. `paste_faces` (the classic per-image path, `paste_faces_xla`'s
counterpart) blends the faces of one image over its whole canvas;
DeviceRestorePipeline._composite blends the faces of a chunk of frames
into per-face windows.

What the two keep from the JAX compositor: the canvas is rounded up to
multiples of 128 (erosion and blur see zeros past the image, as JAX's
do), the edge width is one quantized value a call (`edge_width`), and
padding face slots are parked off the canvas, where they blend nothing.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from codeformer_tpu_torch.ops.filters import erode, gaussian_blur
from codeformer_tpu_torch.ops.geometry import resize_linear, warp_affine

# 19-class parse mask -> binary face mask (face_restoration_helper.py:468)
MASK_COLORMAP = (0, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255, 255,
                 255, 255, 0, 255, 0, 0, 0)


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _pow2_bucket(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def colormap_lookup(parse_ids: torch.Tensor) -> torch.Tensor:
    """MASK_COLORMAP[parse_ids] as fp32."""
    table = torch.tensor(MASK_COLORMAP, dtype=torch.float32,
                         device=parse_ids.device)
    return table[parse_ids.long()]


def _shape_parse_masks(parse_ids: torch.Tensor,
                       face_size: int) -> torch.Tensor:
    """Parse ids (N, res, res) -> soft parse masks (N, 1, face, face) in
    [0, 1]: the colormap, two Gaussian blurs (101 taps, sigma 11),
    `thres` border pixels zeroed, /255, then a linear resize to the face.

    res == 512 is the reference exactly (kernel 101, sigma 11, 10 px
    border). Other resolutions (the pipeline's parse_res) scale kernel,
    sigma and border by res/512 and resize the soft mask, as the JAX
    package does."""
    res = parse_ids.shape[1]
    s = res / 512.0
    ksize = max(int(round(101 * s)) | 1, 3)
    sigma = 11.0 * s
    thres = max(int(round(10 * s)), 1)
    pm = colormap_lookup(parse_ids)[:, None]          # (N, 1, res, res)
    pm = gaussian_blur(gaussian_blur(pm, ksize, sigma), ksize, sigma)
    pm[:, :, :thres] = 0
    pm[:, :, -thres:] = 0
    pm[:, :, :, :thres] = 0
    pm[:, :, :, -thres:] = 0
    pm = pm / 255.0
    if face_size != res:
        pm = resize_linear(pm, (face_size, face_size))
    return pm


def edge_width(max_area: float) -> int:
    """The soft edge's width from the largest warped face's area: the
    reference's int(sqrt(area)) // 20 (face_restoration_helper.py:425),
    quantized to a multiple of 8 in [4, 64] as the JAX compositor does
    (one width a call; the soft edge moves by at most 4 px under a
    blur of over 100 taps)."""
    w_edge = int(max_area ** 0.5) // 20
    return min(max((w_edge + 4) // 8 * 8, 4), 64)


def soft_paste(src: torch.Tensor, inv_affines: torch.Tensor,
               out_hw: Tuple[int, int], upscale: int, w_edge: int,
               parse_div: Optional[float] = None,
               img_idx: Optional[torch.Tensor] = None):
    """Warp faces into `out_hw` and build their blend weights.

    src (M, face, face, C): RGB in channels 0-2, then, when `parse_div`
    is given, the shaped parse mask times `parse_div` in channel 3, then
    any further channels (the draw-box border). inv_affines (n, 2, 3):
    face -> output coordinates; img_idx (n,): the source face of each
    output (else n = M). The warp's coverage is eroded by 2*upscale (the
    warp's border) and multiplies the face; eroded again by 2*w_edge and
    blurred with 2*w_edge+1 taps, it is the soft edge, capped by the
    parse mask. Returns (soft (n, oh, ow, 1), pasted BGR (n, oh, ow, 3),
    warped (n, oh, ow, C))."""
    warped, cov = warp_affine(src, inv_affines, out_hw,
                              return_coverage=True, img_idx=img_idx)
    inv_restored = warped[..., :3].flip(-1)     # RGB -> BGR
    erosion1 = erode(cov.permute(0, 3, 1, 2), max(int(2 * upscale), 1))
    pasted = erosion1.permute(0, 2, 3, 1) * inv_restored
    soft = gaussian_blur(erode(erosion1, max(w_edge * 2, 1)),
                         w_edge * 2 + 1)
    if parse_div is not None:
        inv_parse = warped[..., 3:4].permute(0, 3, 1, 2) / parse_div
        soft = torch.where(inv_parse < soft, inv_parse, soft)
    return soft.permute(0, 2, 3, 1), pasted, warped


def blend(weight: torch.Tensor, top: torch.Tensor,
          under: torch.Tensor) -> torch.Tensor:
    """weight * top + (1 - weight) * under, the reference's blend."""
    return weight * top + (1 - weight) * under


# draw_box's colour, (0, 255, 0) in BGR and in RGB
_GREEN = (0.0, 255.0, 0.0)


def paste_faces(upsample_img, restored_faces: Sequence[np.ndarray],
                inverse_affines: Sequence[np.ndarray],
                parse_ids: Optional[np.ndarray], upscale: int,
                draw_box: bool = False, device='cuda') -> np.ndarray:
    """Paste restored faces onto one upscaled image on `device`, the
    counterpart of paste_faces_xla (compositor_xla.py:158-210).

    upsample_img: (h, w, 3) uint8 BGR, the canvas (array or tensor);
    restored_faces: uint8 BGR (face, face, 3) each; inverse_affines:
    face -> canvas, the reference's extra offset already added;
    parse_ids: (n, 512, 512) class ids, or None for no parse mask.
    Faces blend in order (later faces over earlier ones), then the green
    draw-box borders, sized from each affine's determinant. Returns
    (h, w, 3) uint8 BGR, truncated as the JAX compositor's astype."""
    dev = torch.device(device)
    canvas = torch.as_tensor(upsample_img, device=dev)
    if not len(restored_faces):
        return canvas.cpu().numpy().astype(np.uint8)
    h, w = canvas.shape[:2]
    hc, wc = _round_up(h, 128), _round_up(w, 128)
    n = len(restored_faces)
    nb = _pow2_bucket(n)
    face_size = restored_faces[0].shape[0]

    faces = np.zeros((nb, face_size, face_size, 3), np.float32)
    affines = np.zeros((nb, 2, 3), np.float32)
    # park padded faces off-canvas so their masks never touch it
    affines[:, 0, 2] = -4 * face_size
    affines[:, 0, 0] = affines[:, 1, 1] = 1.0
    pids = None if parse_ids is None else np.zeros((nb, 512, 512), np.int64)
    borders = np.zeros((nb, face_size, face_size, 1), np.float32) \
        if draw_box else None
    areas = []
    for i, (f, a) in enumerate(zip(restored_faces, inverse_affines)):
        faces[i] = np.asarray(f)[..., ::-1]      # BGR -> RGB
        affines[i] = a
        det = abs(a[0, 0] * a[1, 1] - a[0, 1] * a[1, 0])
        area = face_size * face_size * det
        areas.append(area)
        if parse_ids is not None:
            pids[i] = parse_ids[i]
        if draw_box:
            # border width from the warped-face area (the determinant in
            # place of the reference's eroded-mask sum, as w_edge)
            border = int(1400 / np.sqrt(max(area, 1.0)))
            if border > 0:
                borders[i] = 1.0
                borders[i, border:face_size - border,
                        border:face_size - border] = 0.0

    src = [torch.from_numpy(faces).to(dev)]
    if parse_ids is not None:
        pm = _shape_parse_masks(torch.from_numpy(pids).to(dev), face_size)
        src.append(pm.permute(0, 2, 3, 1))
    if draw_box:
        src.append(torch.from_numpy(borders).to(dev))
    src = torch.cat(src, dim=-1) if len(src) > 1 else src[0]
    soft, pasted, warped = soft_paste(
        src, torch.from_numpy(affines).to(dev), (hc, wc), upscale,
        edge_width(max(areas)),
        parse_div=1.0 if parse_ids is not None else None)

    out = F.pad(canvas.float(), (0, 0, 0, wc - w, 0, hc - h))
    for i in range(nb):
        out = blend(soft[i], pasted[i], out)
    if draw_box:
        green = torch.tensor(_GREEN, device=dev)
        for i in range(nb):
            out = blend(warped[i, ..., -1:], green, out)
    out = out[:h, :w].clamp(0, 255).to(torch.uint8)
    return out.cpu().numpy()

