"""Aligned-face restoration CLI of the PyTorch port (the `--has_aligned`
path of codeformer_tpu/cli/inference_codeformer.py):

    python -m codeformer_tpu_torch.cli.inference_codeformer --has_aligned \\
        -i inputs/cropped_faces --random-init [-w 0.5] [-o DIR] [--device cuda]

Inputs are 512x512 cropped, aligned faces; they are restored in device
batches and written to <output>/restored_faces/. The whole-image and
video paths are not ported yet. cv2 is imported only where images are
read and written.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from codeformer_tpu_torch.cli.common import list_inputs, resolve_checkpoint


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('-i', '--input_path', type=str,
                   default='./inputs/cropped_faces',
                   help='Input image or folder of aligned 512x512 faces.')
    p.add_argument('-o', '--output_path', type=str, default=None,
                   help='Output folder. Default: results/<input_name>_<w>')
    p.add_argument('-w', '--fidelity_weight', type=float, default=0.5,
                   help='Balance the quality and fidelity. Default: 0.5')
    p.add_argument('--has_aligned', action='store_true',
                   help='Inputs are cropped and aligned faces (the only '
                        'mode ported so far).')
    p.add_argument('--suffix', type=str, default=None,
                   help='Suffix of the restored faces.')
    p.add_argument('--checkpoint', type=str, default=None,
                   help='Path to a reference .pth. Default: '
                        'weights/CodeFormer/codeformer.pth')
    p.add_argument('--random-init', action='store_true',
                   help='Run with seeded random weights (smoke testing).')
    p.add_argument('--batch', type=int, default=8,
                   help='Max faces per device batch. Default: 8')
    p.add_argument('--device', type=str, default='cuda',
                   help="Torch device, e.g. 'cuda' (default) or 'cpu'.")
    return p


def _is_gray(img: np.ndarray, cv2, threshold: int = 10) -> bool:
    """Channel-difference grayscale test (facelib/utils/misc.py:146-160)."""
    img = cv2.resize(img, (256, 256)).astype(np.float32)
    diff1 = np.abs(img[..., 0] - img[..., 1]).mean()
    diff2 = np.abs(img[..., 1] - img[..., 2]).mean()
    return (diff1 + diff2) / 2.0 <= threshold


def _gray_tone(restored: np.ndarray, source: np.ndarray, cv2) -> np.ndarray:
    """Gray output with the input's per-channel mean/std
    (face_restoration_helper.py:364-369)."""
    g = cv2.cvtColor(restored, cv2.COLOR_BGR2GRAY)
    x = np.stack([g, g, g], -1).astype(np.float32).reshape(-1, 3)
    y = source.astype(np.float32).reshape(-1, 3)
    out = (x - x.mean(0)) / (x.std(0) + 1e-5) * (y.std(0) + 1e-5) \
        + y.mean(0)
    return np.clip(out, 0, 255).astype(np.uint8).reshape(restored.shape)


def run_aligned(args, input_img_list, result_root, restorer):
    """Read, resize to the restorer's face size (512 for the released
    models), restore in device batches, write restored_faces/."""
    import cv2
    size = restorer.face_size
    faces, grays, names = [], [], []
    for i, img_path in enumerate(input_img_list):
        print(f'[{i + 1}/{len(input_img_list)}] Processing: '
              f'{os.path.basename(img_path)}')
        img = cv2.imread(img_path, cv2.IMREAD_COLOR)
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_LINEAR)
        faces.append(img)
        grays.append(_is_gray(img, cv2))
        names.append(os.path.splitext(os.path.basename(img_path))[0])
    restored = restorer.restore_batch(faces, w=args.fidelity_weight,
                                      adain=True)
    out_dir = os.path.join(result_root, 'restored_faces')
    os.makedirs(out_dir, exist_ok=True)
    for face, gray, name, out in zip(faces, grays, names, restored):
        if gray:
            out = _gray_tone(out, face, cv2)
        suffix = '' if args.suffix is None else f'_{args.suffix}'
        path = os.path.join(out_dir, f'{name}{suffix}.png')
        if not cv2.imwrite(path, out):
            raise IOError(f'failed to write image: {path}')


def main(argv=None):
    args = build_parser().parse_args(argv)
    if not args.has_aligned:
        raise SystemExit('only --has_aligned (cropped 512x512 faces) is '
                         'ported; use the JAX CLI for whole images')
    input_img_list, result_root = list_inputs(args.input_path,
                                              args.fidelity_weight)
    if args.output_path is not None:
        result_root = args.output_path
    if not input_img_list:
        raise FileNotFoundError(f'no input image found at {args.input_path}')
    from codeformer_tpu_torch.pipeline import CodeFormerRestorer
    ckpt = resolve_checkpoint(args.checkpoint, args.random_init)
    restorer = CodeFormerRestorer(
        device=args.device, checkpoint=ckpt,
        batch_buckets=sorted({1, 2, 4, args.batch}))
    run_aligned(args, input_img_list, result_root, restorer)
    print(f'\nAll results are saved in {result_root}')


if __name__ == '__main__':
    main()
