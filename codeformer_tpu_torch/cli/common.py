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

# the released restoration checkpoint (weights/README.md of the reference)
DEFAULT_WEIGHTS = 'weights/CodeFormer/codeformer.pth'


def list_inputs(input_path: str, w: float) -> Tuple[List[str], str, bool]:
    """An image, a video or a folder of images -> (inputs, result root,
    is_video)."""
    suffix = f'_{w}'
    if input_path.endswith(IMG_EXTS):
        return [input_path], f'results/test_img{suffix}', False
    if input_path.endswith(VIDEO_EXTS):
        video_name = os.path.splitext(os.path.basename(input_path))[0]
        return [input_path], f'results/{video_name}{suffix}', True
    input_path = input_path.rstrip('/')
    imgs = sorted(glob.glob(os.path.join(input_path, '*.[jpJP][pnPN]*[gG]')))
    return imgs, f'results/{os.path.basename(input_path)}{suffix}', False


def resolve_checkpoint(explicit: Optional[str],
                       allow_random: bool) -> Optional[str]:
    """Weights: the explicit flag, else the weights/ convention, else an
    error unless random weights were asked for."""
    if explicit:
        if not os.path.exists(explicit):
            sys.exit(f'checkpoint not found: {explicit}')
        return explicit
    default = DEFAULT_WEIGHTS
    if os.path.exists(default):
        return default
    if allow_random:
        print('[WARN] no checkpoint found -- using RANDOM weights '
              '(--random-init); outputs will be meaningless.')
        return None
    sys.exit(f'No checkpoint found at {default}. Put the released weights '
             f'there, pass --checkpoint PATH, or use --random-init for a '
             f'smoke test.')
