"""FFHQ-style face crop and align of a folder of images (counterpart of
scripts/crop_align_face.py; reference scripts/crop_align_face.py):

    python -m codeformer_tpu_torch.cli.crop_align_face \
        -i inputs/whole_imgs -o inputs/cropped_faces [--output_size 512] \
        [--landmark-source retinaface|dlib] [--device cuda] [--random-init]

The largest face of each image is cropped along the FFHQ oriented quad
of its landmarks (`pipeline/face_utils.py align_crop_face_landmarks`) and
written as <name>.png. `--landmark-source retinaface` (the default) takes
the 5 landmarks of the port's RetinaFace resnet50 detector on `--device`
(weights/facelib/detection_Resnet50_Final.pth, or seeded with
--random-init); `dlib` the 68 points of dlib's frontal detector and
shape predictor on the host (the dlib package and
weights/dlib/shape_predictor_68_face_landmarks-fbdc2cb8.dat). cv2 and
dlib are imported inside the functions that use them.
"""
from __future__ import annotations

import argparse
import glob
import os
from typing import Optional

import numpy as np

from codeformer_tpu_torch.pipeline.detector import init_detection_model
from codeformer_tpu_torch.pipeline.face_utils import align_crop_face_landmarks

DLIB_68_WEIGHTS = 'weights/dlib/shape_predictor_68_face_landmarks-fbdc2cb8.dat'


def largest_face_landmarks(bboxes: np.ndarray) -> Optional[np.ndarray]:
    """detect_faces rows (n, 15) -> the 5 landmarks (5, 2) of the face
    with the largest box, or None without a face (the first on ties)."""
    if bboxes.shape[0] == 0:
        return None
    areas = (bboxes[:, 2] - bboxes[:, 0]) * (bboxes[:, 3] - bboxes[:, 1])
    return bboxes[int(areas.argmax())][5:15].reshape(5, 2)


def get_landmarks_retinaface(detector, img: np.ndarray):
    return largest_face_landmarks(detector.detect_faces(img,
                                                        conf_threshold=0.8))


def make_dlib_landmarker():
    """dlib's frontal detector and 68-point predictor, the largest face
    kept (reference scripts/crop_align_face.py:38-70). Exits when the
    dlib package or its .dat weights are missing."""
    try:
        import dlib
    except ImportError as e:
        raise SystemExit('dlib package not installed: '
                         'conda install -c conda-forge dlib') from e
    if not os.path.exists(DLIB_68_WEIGHTS):
        raise SystemExit(f'dlib weights missing at {DLIB_68_WEIGHTS}')
    detector = dlib.get_frontal_face_detector()
    predictor = dlib.shape_predictor(DLIB_68_WEIGHTS)

    def get_landmarks(img_bgr):
        img = img_bgr[..., ::-1]  # dlib takes RGB
        dets = detector(img, 1)
        print(f'\tNumber of faces detected: {len(dets)}')
        if not dets:
            return None
        areas = [(d.right() - d.left()) * (d.bottom() - d.top())
                 for d in dets]
        shape = predictor(img, dets[int(np.argmax(areas))])
        return np.array([[p.x, p.y] for p in shape.parts()])  # (68, 2)

    return get_landmarks


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('-i', '--in_dir', type=str, default='./inputs/whole_imgs')
    p.add_argument('-o', '--out_dir', type=str,
                   default='./inputs/cropped_faces')
    p.add_argument('--output_size', type=int, default=512)
    p.add_argument('--landmark-source', type=str, default='retinaface',
                   choices=['retinaface', 'dlib'])
    p.add_argument('--random-init', action='store_true',
                   help='seeded detector weights when the checkpoint is '
                        'missing (a smoke run: random weights find no '
                        'faces)')
    p.add_argument('--device', type=str, default='cuda',
                   help="Torch device of the detector, e.g. 'cuda' "
                        "(default) or 'cpu'.")
    return p


def main(argv=None) -> str:
    import cv2
    args = build_parser().parse_args(argv)
    os.makedirs(args.out_dir, exist_ok=True)
    img_list = sorted(glob.glob(os.path.join(args.in_dir,
                                             '*.[jpJP][pnPN]*[gG]')))
    if args.landmark_source == 'dlib':
        get_lm = make_dlib_landmarker()
    else:
        detector = init_detection_model('retinaface_resnet50',
                                        allow_random=args.random_init,
                                        device=args.device)

        def get_lm(img):
            return get_landmarks_retinaface(detector, img)

    for i, in_path in enumerate(img_list):
        img_name = os.path.basename(in_path)
        print(f'[{i + 1}/{len(img_list)}] Processing: {img_name}')
        img = cv2.imread(in_path)
        lm = get_lm(img)
        if lm is None:
            print('\tno face detected, skipping')
            continue
        face, _ = align_crop_face_landmarks(img, lm, args.output_size)
        cv2.imwrite(os.path.join(args.out_dir,
                                 img_name.replace('.jpg', '.png')), face)
    return args.out_dir


if __name__ == '__main__':
    main()
