"""Face inpainting CLI of the PyTorch port, counterpart of
codeformer_tpu/cli/inference_inpainting.py (the reference's
inference_inpainting.py): 512x512 aligned faces whose masked regions are
pure white, through the inpainting model (codebook 512, connect
32/64/128) with w=1 and no AdaIN, in device batches; the output keeps
the input outside the white pixels:

    python -m codeformer_tpu_torch.cli.inference_inpainting \\
        -i inputs/masked_faces --random-init [--device cuda]

Results go to results/<input name>/<name>.png. cv2 reads and writes the
images, so the CLI runs where cv2 is installed.
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from codeformer_tpu_torch.cli.common import (add_dtype_flag, list_inputs,
                                             resolve_checkpoint,
                                             resolve_dtype)
from codeformer_tpu_torch.utils import img_util


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('-i', '--input_path', type=str,
                   default='./inputs/masked_faces',
                   help='Input image or folder. Default: inputs/masked_faces')
    p.add_argument('-o', '--output_path', type=str, default=None,
                   help='Output folder. Default: results/<input_name>')
    p.add_argument('--suffix', type=str, default=None,
                   help='Suffix of the restored faces. Default: None')
    p.add_argument('--checkpoint', type=str, default=None,
                   help='Path to a reference .pth. Default: '
                        'weights/CodeFormer/codeformer_inpainting.pth')
    p.add_argument('--random-init', action='store_true',
                   help='Run with seeded random weights (smoke testing).')
    p.add_argument('--batch', type=int, default=8,
                   help='Max faces per device batch. Default: 8')
    p.add_argument('--device', type=str, default='cuda',
                   help="Torch device, e.g. 'cuda' (default) or 'cpu'.")
    add_dtype_flag(p)
    return p


def white_mask_composite(face: np.ndarray, out: np.ndarray) -> np.ndarray:
    """The model's output on the input's pure-white pixels, the input
    elsewhere (reference inference_inpainting.py:75-77). uint8 BGR."""
    mask = (face == 255).all(axis=-1)[..., None].astype(np.float32)
    comp = ((1.0 - mask) * face.astype(np.float32)
            + mask * out.astype(np.float32))
    return np.clip(comp, 0, 255).astype(np.uint8)


def main(argv=None):
    import cv2
    args = build_parser().parse_args(argv)
    print('[NOTE] The input face images should be aligned and cropped to a '
          'resolution of 512x512.')
    input_img_list, result_root, _ = list_inputs(
        args.input_path, None, default_root='test_inpainting_img')
    if args.output_path is not None:
        result_root = args.output_path
    if not input_img_list:
        raise FileNotFoundError('No input image is found.')

    from codeformer_tpu_torch.pipeline import CodeFormerRestorer
    ckpt = resolve_checkpoint(args.checkpoint, 'inpainting',
                              args.random_init)
    restorer = CodeFormerRestorer(
        device=args.device, checkpoint=ckpt, dim_embd=512,
        codebook_size=512, n_head=8, n_layers=9,
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
                'Input resolution must be 512x512 for inpainting.')
        faces.append(img)
        names.append(os.path.splitext(os.path.basename(img_path))[0])

    # w fixed to 1, adain off for inpainting (inference_inpainting.py:73)
    restored = restorer.restore_batch(faces, w=1.0, adain=False)
    for face, name, out in zip(faces, names, restored):
        if args.suffix is not None:
            name = f'{name}_{args.suffix}'
        img_util.imwrite(white_mask_composite(face, out),
                         os.path.join(result_root, f'{name}.png'))

    print(f'\nAll results are saved in {result_root}')


if __name__ == '__main__':
    main()
