"""CLI plumbing (counterpart of codeformer_tpu/cli/common.py): input
enumeration, results layout and weight lookup, reference conventions
(inference_codeformer.py:86-120)."""
from __future__ import annotations

import glob
import os
import sys
from typing import List, Optional, Tuple

IMG_EXTS = ('jpg', 'jpeg', 'png', 'JPG', 'JPEG', 'PNG')
VIDEO_EXTS = ('mp4', 'mov', 'avi', 'MP4', 'MOV', 'AVI')

# released checkpoint names, matching the reference weights layout
# (weights/README.md; scripts/download_pretrained_models.py:27-47)
WEIGHT_FILES = {
    'restoration': 'weights/CodeFormer/codeformer.pth',
    'colorization': 'weights/CodeFormer/codeformer_colorization.pth',
    'inpainting': 'weights/CodeFormer/codeformer_inpainting.pth',
}


def list_inputs(input_path: str, w: Optional[float] = None,
                default_root: str = 'test_img'
                ) -> Tuple[List[str], str, bool]:
    """An image, a video or a folder of images -> (inputs, result root,
    is_video); the root takes `_<w>` when w is given."""
    suffix = '' if w is None else f'_{w}'
    if input_path.endswith(IMG_EXTS):
        return [input_path], f'results/{default_root}{suffix}', False
    if input_path.endswith(VIDEO_EXTS):
        video_name = os.path.splitext(os.path.basename(input_path))[0]
        return [input_path], f'results/{video_name}{suffix}', True
    input_path = input_path.rstrip('/')
    imgs = sorted(glob.glob(os.path.join(input_path, '*.[jpJP][pnPN]*[gG]')))
    return imgs, f'results/{os.path.basename(input_path)}{suffix}', False


def resolve_checkpoint(explicit: Optional[str], task: str,
                       allow_random: bool) -> Optional[str]:
    """Weights: the explicit flag, else the weights/ convention for the
    task (restoration, colorization, inpainting), else an error unless
    random weights were asked for."""
    if explicit:
        if not os.path.exists(explicit):
            sys.exit(f'checkpoint not found: {explicit}')
        return explicit
    default = WEIGHT_FILES[task]
    if os.path.exists(default):
        return default
    if allow_random:
        print('[WARN] no checkpoint found -- using RANDOM weights '
              '(--random-init); outputs will be meaningless.')
        return None
    sys.exit(f'No checkpoint found at {default}. Put the released weights '
             f'there, pass --checkpoint PATH, or use --random-init for a '
             f'smoke test.')


def add_dtype_flag(p) -> None:
    """--dtype of the restorer's activations."""
    p.add_argument('--dtype', type=str, default='bf16',
                   choices=['bf16', 'fp32'],
                   help='Restorer compute dtype: bf16 (default) or fp32 '
                        '(the reference numerics; on a CUDA device the '
                        'kernels compute in bf16 only and the restorer '
                        'refuses fp32, so fp32 needs --device cpu).')


def resolve_dtype(name: str):
    import torch
    return torch.float32 if name == 'fp32' else torch.bfloat16
