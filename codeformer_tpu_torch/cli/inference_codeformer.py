"""Face restoration CLI of the PyTorch port, counterpart of
codeformer_tpu/cli/inference_codeformer.py:

    # whole images or a video: detect -> align -> restore -> parse ->
    # paste back (cli/whole_image.py)
    python -m codeformer_tpu_torch.cli.inference_codeformer \
        -i inputs/whole_imgs --random-init [-w 0.5] [-s 2] [-o DIR]
    python -m codeformer_tpu_torch.cli.inference_codeformer \
        -i inputs/whole_imgs --random-init --bg_upsampler realesrgan \
        --face_upsample [--detection_model YOLOv5n]
    python -m codeformer_tpu_torch.cli.inference_codeformer \
        -i clip.mp4 --random-init [--save_video_fps 24]
    # aligned 512x512 faces
    python -m codeformer_tpu_torch.cli.inference_codeformer --has_aligned \
        -i inputs/cropped_faces --random-init [--dtype fp32] [--quant int8]

Whole images and videos go through the fused device pipeline where it
can serve them, else the classic per-stage path (--fused_pipeline), and
are written to <output>/{cropped_faces,restored_faces,final_results}/
(and <output>/<video>.mp4); aligned faces are restored in device batches
and written to <output>/restored_faces/. The YOLOv5 detectors
(--detection_model YOLOv5l|YOLOv5n) and the Real-ESRGAN upsamplers
(--bg_upsampler realesrgan, --face_upsample; weights/realesrgan/
RealESRGAN_x2plus.pth, or seeded with --random-init) take the classic
path. --dtype fp32 serves the restorer's plain path in IEEE fp32 (bf16,
the default, runs the kernels); --quant int8 serves JAX's int8 convs.
cv2 is imported only where images and videos are read and written, and
by the classic path's host steps. --profile reports the aligned path's
read, restore and write stages.
"""
from __future__ import annotations

import argparse
import os

from codeformer_tpu_torch.cli.common import (add_dtype_flag, list_inputs,
                                             resolve_checkpoint,
                                             resolve_dtype)
from codeformer_tpu_torch.utils import img_util
from codeformer_tpu_torch.utils.profiler import stage


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
                        '(the classic path).')
    p.add_argument('--detection_model', type=str,
                   default='retinaface_resnet50',
                   help='Face detector: retinaface_resnet50, '
                        'retinaface_mobile0.25, YOLOv5l, YOLOv5n (the '
                        'YOLOv5 detectors take the classic path)')
    p.add_argument('--bg_upsampler', type=str, default='None',
                   help='Background upsampler. Optional: realesrgan (x2 '
                        'Real-ESRGAN, the classic path)')
    p.add_argument('--face_upsample', action='store_true',
                   help='Face upsampler after enhancement (the same '
                        'Real-ESRGAN, the classic path).')
    p.add_argument('--bg_tile', type=int, default=400,
                   help='Tile size for background sampler. Default: 400')
    p.add_argument('--suffix', type=str, default=None,
                   help='Suffix of the restored faces.')
    p.add_argument('--save_video_fps', type=float, default=None,
                   help='Frame rate for saving video.')
    p.add_argument('--fused_pipeline', nargs='?', const='on',
                   default='auto', choices=['auto', 'on', 'off'],
                   help='Fused device pipeline '
                        '(pipeline/device_pipeline.py): frames stay on the '
                        'device between detect/align/restore/parse/'
                        'composite. auto (default): use it whenever it can '
                        'serve the input (RetinaFace detector, no '
                        'upsampler, no draw_box, same-size colour folder '
                        'images or a video), else the classic per-stage '
                        'path. on: '
                        'require it (error if it cannot serve the input). '
                        'off: always classic.')
    p.add_argument('--compositor', type=str, default='xla',
                   choices=['cv2', 'xla'],
                   help='Paste-back compositor of the classic path: xla '
                        '(default; on the device, pipeline/compositor.py, '
                        'named as the JAX CLI names it) or cv2 (pixel '
                        'parity with the reference, on the host).')
    p.add_argument('--parse_res', type=int, default=256, choices=[256, 512],
                   help='ParseNet resolution in the fused pipeline: 512 is '
                        'the reference (the parser sees the whole restored '
                        'face); 256 (default) parses and shapes the blend '
                        'mask at half size and resizes it. The classic '
                        'path always parses at 512.')
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
    add_dtype_flag(p)
    p.add_argument('--quant', type=str, default=None,
                   choices=['int8'],
                   help='Quantized serving path for the restorer convs '
                        '(int8: s8 x s8 -> s32 products, dynamic '
                        'per-tensor activation scales, per-channel weight '
                        'scales; slight quality delta, see '
                        'tests/test_torch_quant.py). Default: off.')
    p.add_argument('--profile', action='store_true',
                   help='Print per-stage host timings at the end.')
    return p


def run_aligned(args, input_img_list, result_root, restorer):
    """Read, resize to the restorer's face size (512 for the released
    models), restore in device batches, write restored_faces/; a gray
    input keeps its tone (face_restoration_helper.py:364-369). The three
    steps are the stages `read`, `restore` and `write` of --profile."""
    import cv2
    size = restorer.face_size
    faces, grays, names = [], [], []
    with stage('read'):
        for i, img_path in enumerate(input_img_list):
            print(f'[{i + 1}/{len(input_img_list)}] Processing: '
                  f'{os.path.basename(img_path)}')
            img = cv2.imread(img_path, cv2.IMREAD_COLOR)
            img = cv2.resize(img, (size, size),
                             interpolation=cv2.INTER_LINEAR)
            faces.append(img)
            grays.append(img_util.is_gray(img, threshold=10))
            names.append(os.path.splitext(os.path.basename(img_path))[0])
    with stage('restore'):
        restored = restorer.restore_batch(faces, w=args.fidelity_weight,
                                          adain=True)
    with stage('write'):
        for face, gray, name, out in zip(faces, grays, names, restored):
            if gray:
                out = img_util.adain_color_transfer(
                    img_util.bgr2gray3(out), face)
            suffix = '' if args.suffix is None else f'_{args.suffix}'
            img_util.imwrite(out, os.path.join(
                result_root, 'restored_faces', f'{name}{suffix}.png'))


def main(argv=None):
    args = build_parser().parse_args(argv)
    input_img_list, result_root, input_video = list_inputs(
        args.input_path, args.fidelity_weight)
    if args.output_path is not None:
        result_root = args.output_path
    video_meta = None
    if input_video:
        # a lazy frame stream: the fused pipeline takes it chunk by chunk
        # (bounded memory for any length); the classic path lists it
        input_img_list, video_meta = _open_video_stream(args.input_path)
    elif not input_img_list:
        raise FileNotFoundError(
            f'no input image or video found at {args.input_path} (a video '
            f'path should end with .mp4|.mov|.avi)')
    from codeformer_tpu_torch.pipeline import CodeFormerRestorer
    ckpt = resolve_checkpoint(args.checkpoint, 'restoration',
                              args.random_init)
    restorer = CodeFormerRestorer(
        device=args.device, checkpoint=ckpt,
        batch_buckets=sorted({1, 2, 4, args.batch}), quant=args.quant,
        dtype=resolve_dtype(args.dtype))
    if args.has_aligned:
        run_aligned(args, input_img_list, result_root, restorer)
    else:
        from .whole_image import run_whole_images
        run_whole_images(args, input_img_list, result_root, restorer,
                         input_video, video_meta=video_meta)
    if args.profile:
        from codeformer_tpu_torch.utils.profiler import TIMER
        print('\n' + TIMER.report())
    print(f'\nAll results are saved in {result_root}')


def _open_video_stream(path):
    """A lazy frame generator and the video's meta: an ffmpeg pipe if
    ffmpeg is installed, else cv2.VideoCapture. The first frame is
    decoded at once, so an empty or unreadable video fails here and not
    mid-pipeline; the rest stream on demand (the reference decodes the
    whole video into memory first, inference_codeformer.py:90-103)."""
    import cv2

    from codeformer_tpu_torch.utils.video_util import VideoReader, have_ffmpeg
    if have_ffmpeg():
        reader = VideoReader(path)
        meta = {'fps': reader.get_fps(), 'audio': reader.get_audio()}
        first = reader.get_frame()
        if first is None:
            reader.close()
            raise FileNotFoundError(f'no decodable frames in {path}')

        def gen():
            frame = first
            while frame is not None:
                yield frame
                frame = reader.get_frame()
            reader.close()

        return gen(), meta
    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise RuntimeError(f'cannot open video {path} (no ffmpeg and '
                           f'cv2.VideoCapture failed)')
    fps = cap.get(cv2.CAP_PROP_FPS) or 24.0
    ok, first = cap.read()
    if not ok:
        cap.release()
        raise FileNotFoundError(f'no decodable frames in {path}')

    def gen():
        frame, good = first, True
        while good:
            yield frame
            good, frame = cap.read()
        cap.release()

    # cv2 cannot demux audio; the source path is still recorded: the
    # ffmpeg writer muxes from it ('-map 1:a?', missing audio is not an
    # error) and the cv2 writer warns that audio is dropped
    return gen(), {'fps': fps, 'audio': path}


if __name__ == '__main__':
    main()
