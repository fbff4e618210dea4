"""Face colorization CLI of the PyTorch port, counterpart of
codeformer_tpu/cli/inference_colorization.py (the reference's
inference_colorization.py): 512x512 aligned gray faces through the
colorization model (codebook 1024, connect 32/64/128) with w=0 and
AdaIN, in device batches:

    python -m codeformer_tpu_torch.cli.inference_colorization \\
        -i inputs/gray_faces --random-init [--device cuda]

Results go to results/<input name>/<name>.png. cv2 reads and writes the
images, so the CLI runs where cv2 is installed.
"""
from __future__ import annotations

import argparse
import os

from codeformer_tpu_torch.cli.common import (add_dtype_flag, list_inputs,
                                             resolve_checkpoint,
                                             resolve_dtype)
from codeformer_tpu_torch.utils import img_util


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('-i', '--input_path', type=str,
                   default='./inputs/gray_faces',
                   help='Input image or folder. Default: inputs/gray_faces')
    p.add_argument('-o', '--output_path', type=str, default=None,
                   help='Output folder. Default: results/<input_name>')
    p.add_argument('--suffix', type=str, default=None,
                   help='Suffix of the restored faces. Default: None')
    p.add_argument('--checkpoint', type=str, default=None,
                   help='Path to a reference .pth. Default: '
                        'weights/CodeFormer/codeformer_colorization.pth')
    p.add_argument('--random-init', action='store_true',
                   help='Run with seeded random weights (smoke testing).')
    p.add_argument('--batch', type=int, default=8,
                   help='Max faces per device batch. Default: 8')
    p.add_argument('--device', type=str, default='cuda',
                   help="Torch device, e.g. 'cuda' (default) or 'cpu'.")
    add_dtype_flag(p)
    return p


def main(argv=None):
    import cv2
    args = build_parser().parse_args(argv)
    print('[NOTE] The input face images should be aligned and cropped to a '
          'resolution of 512x512.')
    input_img_list, result_root, _ = list_inputs(
        args.input_path, None, default_root='test_colorization_img')
    if args.output_path is not None:
        result_root = args.output_path
    if not input_img_list:
        raise FileNotFoundError('No input image is found.')

    from codeformer_tpu_torch.pipeline import CodeFormerRestorer
    ckpt = resolve_checkpoint(args.checkpoint, 'colorization',
                              args.random_init)
    restorer = CodeFormerRestorer(
        device=args.device, checkpoint=ckpt, dim_embd=512,
        codebook_size=1024, n_head=8, n_layers=9,
        connect_list=('32', '64', '128'),
        batch_buckets=sorted({1, 2, 4, args.batch}),
        dtype=resolve_dtype(args.dtype))

    faces, names = [], []
    for i, img_path in enumerate(input_img_list):
        print(f'[{i + 1}/{len(input_img_list)}] Processing: '
              f'{os.path.basename(img_path)}')
        img = cv2.imread(img_path)
        if img.shape[:2] != (512, 512):
            raise ValueError(
                'Input resolution must be 512x512 for colorization.')
        faces.append(img)
        names.append(os.path.splitext(os.path.basename(img_path))[0])

    # w fixed to 0 (no fusion for colorization), adain on
    restored = restorer.restore_batch(faces, w=0.0, adain=True)
    for name, out in zip(names, restored):
        if args.suffix is not None:
            name = f'{name}_{args.suffix}'
        img_util.imwrite(out, os.path.join(result_root, f'{name}.png'))

    print(f'\nAll results are saved in {result_root}')


if __name__ == '__main__':
    main()
