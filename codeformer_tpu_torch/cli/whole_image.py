"""Whole-image path of the port's CLI, counterpart of
codeformer_tpu/cli/whole_image.py (the reference's main loop,
inference_codeformer.py:160-272): a folder of same-size colour images
with a RetinaFace detector goes through the fused device pipeline
(pipeline/device_pipeline.py), which batches the folder like video
frames; cropped, restored and final images are written with the JAX
CLI's names.

Only the fused path is ported. Inputs that need the classic per-stage
path (mixed sizes, gray images, --draw_box, a YOLO detector, Real-ESRGAN)
or the video path raise instead of being routed elsewhere.
"""
from __future__ import annotations

import os

import torch

from codeformer_tpu_torch.utils import img_util

CLASSIC = 'ROADMAP.md Queue 1 item 1, the classic per-stage path'
VIDEO = 'ROADMAP.md Queue 1 item 2, the video path'
UPSAMPLERS = 'ROADMAP.md Queue 1 item 3, the other detectors and upsamplers'


def _fused_ineligibility(args, input_video, input_img_list):
    """Why the fused device pipeline cannot serve this invocation, with
    the ROADMAP item that would, or None if it can. Folder images must
    already be loaded (size and gray checks)."""
    if args.bg_upsampler == 'realesrgan' or args.face_upsample:
        return f'bg/face upsampler requested ({UPSAMPLERS})'
    if args.draw_box:
        return f'draw_box requested ({CLASSIC})'
    if not args.detection_model.startswith('retinaface'):
        return (f'detector {args.detection_model} keeps host preprocessing '
                f'({UPSAMPLERS})')
    if input_video:
        return f'video input ({VIDEO})'
    shapes = {im.shape for im in input_img_list}
    if len(shapes) != 1:
        return f'folder images differ in size ({len(shapes)} shapes; ' \
               f'{CLASSIC})'
    if any(img_util.is_gray(im, threshold=10) for im in input_img_list):
        return f'grayscale inputs need per-face tone adaptation ({CLASSIC})'
    return None


def run_whole_images(args, input_img_list, result_root, restorer,
                     input_video):
    """Restore whole images through the fused device pipeline and write
    cropped_faces/, restored_faces/ and final_results/ under
    result_root. Raises NotImplementedError for what is not ported."""
    if args.fused_pipeline == 'off':
        raise NotImplementedError(
            f'--fused_pipeline off: not ported yet ({CLASSIC})')
    names = None
    if not input_video:
        import cv2
        loaded, names = [], []
        for i, entry in enumerate(input_img_list):
            if isinstance(entry, str):
                names.append(os.path.splitext(os.path.basename(entry))[0])
                img = cv2.imread(entry, cv2.IMREAD_COLOR)
                if img is None:
                    raise FileNotFoundError(f'cannot read image: {entry}')
                loaded.append(img)
            else:
                names.append(str(i).zfill(6))
                loaded.append(entry)
        input_img_list = loaded
    reason = _fused_ineligibility(args, input_video, input_img_list)
    if reason is not None:
        raise NotImplementedError(
            f'the fused pipeline cannot serve this invocation: {reason}; '
            f'that path is not ported yet')

    from codeformer_tpu_torch.pipeline.device_pipeline import \
        DeviceRestorePipeline
    from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper

    # bf16 detection and parsing on the card, as the JAX fused pipeline
    # on the TPU; fp32 on the CPU (the reference's numerics)
    aux_dtype = torch.bfloat16 if restorer.device.type == 'cuda' \
        else torch.float32
    face_helper = FaceRestoreHelper(
        args.upscale, face_size=512, crop_ratio=(1, 1),
        det_model=args.detection_model, use_parse=True,
        device=restorer.device, allow_random_weights=args.random_init,
        det_dtype=aux_dtype, parse_dtype=aux_dtype)
    pipe = DeviceRestorePipeline(
        restorer, face_helper, upscale=args.upscale,
        w=args.fidelity_weight, only_center_face=args.only_center_face,
        parse_res=getattr(args, 'parse_res', 256))
    restored_frames, faces = pipe.restore_frames(input_img_list,
                                                 return_faces=True)
    for i, (name, frame) in enumerate(zip(names, restored_frames)):
        print(f'[{i + 1}/{len(names)}] Processing: {name} '
              f'({len(faces[i])} faces)')
        for idx, (cropped, restored) in enumerate(faces[i]):
            img_util.imwrite(cropped, os.path.join(
                result_root, 'cropped_faces', f'{name}_{idx:02d}.png'))
            face_name = f'{name}_{idx:02d}.png'
            if args.suffix is not None:
                face_name = f'{face_name[:-4]}_{args.suffix}.png'
            img_util.imwrite(restored, os.path.join(
                result_root, 'restored_faces', face_name))
        save_base = name if args.suffix is None else f'{name}_{args.suffix}'
        img_util.imwrite(frame, os.path.join(
            result_root, 'final_results', f'{save_base}.png'))
