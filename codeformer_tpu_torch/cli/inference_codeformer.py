"""Face restoration CLI of the PyTorch port, counterpart of
codeformer_tpu/cli/inference_codeformer.py:

    # whole images: detect -> align -> restore -> parse -> paste back,
    # on the device (pipeline/device_pipeline.py)
    python -m codeformer_tpu_torch.cli.inference_codeformer \\
        -i inputs/whole_imgs --random-init [-w 0.5] [-s 2] [-o DIR]
    # aligned 512x512 faces
    python -m codeformer_tpu_torch.cli.inference_codeformer --has_aligned \\
        -i inputs/cropped_faces --random-init

Whole images go through the fused device pipeline (cli/whole_image.py)
and are written to <output>/{cropped_faces,restored_faces,final_results}/;
aligned faces are restored in device batches and written to
<output>/restored_faces/. Inputs the port cannot serve yet (videos, mixed
sizes, gray images, other detectors, upsamplers) raise and name the
ROADMAP item. cv2 is imported only where images are read and written.
"""
from __future__ import annotations

import argparse
import os

from codeformer_tpu_torch.cli.common import list_inputs, resolve_checkpoint
from codeformer_tpu_torch.utils import img_util


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('-i', '--input_path', type=str,
                   default='./inputs/whole_imgs',
                   help='Input image, video or folder. '
                        'Default: inputs/whole_imgs')
    p.add_argument('-o', '--output_path', type=str, default=None,
                   help='Output folder. Default: results/<input_name>_<w>')
    p.add_argument('-w', '--fidelity_weight', type=float, default=0.5,
                   help='Balance the quality and fidelity. Default: 0.5')
    p.add_argument('-s', '--upscale', type=int, default=2,
                   help='The final upsampling scale of the image. '
                        'Default: 2')
    p.add_argument('--has_aligned', action='store_true',
                   help='Inputs are cropped and aligned faces.')
    p.add_argument('--only_center_face', action='store_true',
                   help='Only restore the center face.')
    p.add_argument('--draw_box', action='store_true',
                   help='Draw the bounding box for the detected faces '
                        '(the classic path; not ported yet).')
    p.add_argument('--detection_model', type=str,
                   default='retinaface_resnet50',
                   help='Face detector: retinaface_resnet50, '
                        'retinaface_mobile0.25 (YOLOv5l/YOLOv5n not '
                        'ported yet)')
    p.add_argument('--bg_upsampler', type=str, default='None',
                   help='Background upsampler. Optional: realesrgan '
                        '(not ported yet)')
    p.add_argument('--face_upsample', action='store_true',
                   help='Face upsampler after enhancement (not ported '
                        'yet).')
    p.add_argument('--suffix', type=str, default=None,
                   help='Suffix of the restored faces.')
    p.add_argument('--save_video_fps', type=float, default=None,
                   help='Frame rate for saving video (the video path is '
                        'not ported yet).')
    p.add_argument('--fused_pipeline', nargs='?', const='on',
                   default='auto', choices=['auto', 'on', 'off'],
                   help='Fused device pipeline for whole images '
                        '(pipeline/device_pipeline.py). auto (default) '
                        'and on: use it; an input it cannot serve raises, '
                        'since the classic per-stage path is not ported '
                        'yet. off: the classic path (raises).')
    p.add_argument('--parse_res', type=int, default=256, choices=[256, 512],
                   help='ParseNet resolution in the fused pipeline: 512 is '
                        'the reference (the parser sees the whole restored '
                        'face); 256 (default) parses and shapes the blend '
                        'mask at half size and resizes it.')
    p.add_argument('--checkpoint', type=str, default=None,
                   help='Path to a reference .pth. Default: '
                        'weights/CodeFormer/codeformer.pth')
    p.add_argument('--random-init', action='store_true',
                   help='Run with seeded random weights (smoke testing).')
    p.add_argument('--batch', type=int, default=8,
                   help='Max faces per device batch (aligned path). '
                        'Default: 8')
    p.add_argument('--device', type=str, default='cuda',
                   help="Torch device, e.g. 'cuda' (default) or 'cpu'.")
    return p


def run_aligned(args, input_img_list, result_root, restorer):
    """Read, resize to the restorer's face size (512 for the released
    models), restore in device batches, write restored_faces/; a gray
    input keeps its tone (face_restoration_helper.py:364-369)."""
    import cv2
    size = restorer.face_size
    faces, grays, names = [], [], []
    for i, img_path in enumerate(input_img_list):
        print(f'[{i + 1}/{len(input_img_list)}] Processing: '
              f'{os.path.basename(img_path)}')
        img = cv2.imread(img_path, cv2.IMREAD_COLOR)
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        faces.append(img)
        grays.append(img_util.is_gray(img, threshold=10))
        names.append(os.path.splitext(os.path.basename(img_path))[0])
    restored = restorer.restore_batch(faces, w=args.fidelity_weight,
                                      adain=True)
    for face, gray, name, out in zip(faces, grays, names, restored):
        if gray:
            out = img_util.adain_color_transfer(img_util.bgr2gray3(out),
                                                face)
        suffix = '' if args.suffix is None else f'_{args.suffix}'
        img_util.imwrite(out, os.path.join(result_root, 'restored_faces',
                                           f'{name}{suffix}.png'))


def main(argv=None):
    args = build_parser().parse_args(argv)
    input_img_list, result_root, input_video = list_inputs(
        args.input_path, args.fidelity_weight)
    if args.output_path is not None:
        result_root = args.output_path
    if not input_img_list:
        raise FileNotFoundError(f'no input image found at {args.input_path}')
    from codeformer_tpu_torch.pipeline import CodeFormerRestorer
    ckpt = resolve_checkpoint(args.checkpoint, args.random_init)
    restorer = CodeFormerRestorer(
        device=args.device, checkpoint=ckpt,
        batch_buckets=sorted({1, 2, 4, args.batch}))
    if args.has_aligned:
        run_aligned(args, input_img_list, result_root, restorer)
    else:
        from .whole_image import run_whole_images
        run_whole_images(args, input_img_list, result_root, restorer,
                         input_video)
    print(f'\nAll results are saved in {result_root}')


if __name__ == '__main__':
    main()
