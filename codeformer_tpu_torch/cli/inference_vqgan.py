"""VQGAN round trip of a folder of faces (counterpart of
scripts/inference_vqgan.py; reference scripts/inference_vqgan.py), the
de facto codebook-health test:

    python -m codeformer_tpu_torch.cli.inference_vqgan \
        -i inputs/cropped_faces -o results/vqgan_rec \
        --ckpt_path experiments/pretrained_models/vqgan/vqgan_code1024.pth \
        [--batch 4] [--dtype fp32|bf16] [--device cuda] [--random-init]

Every image goes through the VQAutoEncoder (encoder, nearest code K3,
generator) a batch at a time and is written under the same name. fp32
by default, as the JAX script's model (the textbook blocks, K3 on fp32
tokens); `--dtype bf16` runs the encoder's and the generator's ResBlocks
and Downsamples on K1/K2 (`build_vqgan`). `reconstruct` is the batched
core, uint8 in and out on the device; the file walk around it reads and
writes with cv2, imported inside it.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Sequence

import numpy as np
import torch

from codeformer_tpu_torch.cli.generate_latent_gt import DTYPES, build_vqgan
from codeformer_tpu_torch.models.vqgan import VQAutoEncoder


@torch.no_grad()
def reconstruct(model: VQAutoEncoder, x: torch.Tensor,
                dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 RGB on the model's device -> its round trip,
    (B, H, W, 3) uint8 RGB: x / 127.5 - 1 in `dtype`, the forward, then
    clip to [-1, 1] and round (y + 1) * 127.5 half to even (the JAX
    script's `rec`)."""
    half = torch.full((), 127.5, device=x.device)   # an IEEE division
    xn = (x.float() / half - 1.0).to(dtype).permute(0, 3, 1, 2)
    out, _, _ = model(xn)
    y = out.float().clamp(-1.0, 1.0)
    return torch.round((y + 1.0) * 127.5).to(torch.uint8).permute(0, 2, 3, 1)


def run(model: VQAutoEncoder, paths: Sequence[str], save_root: str,
        batch: int = 4, dtype: torch.dtype = torch.float32) -> None:
    """Read `paths` (BGR files), reconstruct `batch` at a time, write each
    under its name in `save_root`."""
    import cv2
    device = next(model.parameters()).device
    for i in range(0, len(paths), batch):
        chunk = paths[i:i + batch]
        imgs = []
        for p in chunk:
            img = cv2.imread(p)
            if img is None:
                raise FileNotFoundError(f'cannot read image: {p}')
            imgs.append(img[..., ::-1])
        x = torch.from_numpy(np.ascontiguousarray(np.stack(imgs)))
        out = reconstruct(model, x.to(device), dtype).cpu().numpy()
        for p, im in zip(chunk, out):
            name = os.path.basename(p)
            cv2.imwrite(os.path.join(save_root, name), im[..., ::-1])
            print(f'reconstructed {name}')


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('-i', '--test_path', type=str,
                   default='inputs/cropped_faces')
    p.add_argument('-o', '--save_root', type=str,
                   default='./results/vqgan_rec')
    p.add_argument('--codebook_size', type=int, default=1024)
    p.add_argument('--ckpt_path', type=str,
                   default='./experiments/pretrained_models/vqgan/'
                           'vqgan_code1024.pth')
    p.add_argument('--random-init', action='store_true',
                   help='seeded random weights when the checkpoint is '
                        'missing (a smoke run)')
    p.add_argument('--batch', type=int, default=4)
    p.add_argument('--dtype', choices=sorted(DTYPES), default='fp32')
    p.add_argument('--device', type=str, default='cuda',
                   help="Torch device, e.g. 'cuda' (default) or 'cpu'.")
    args = p.parse_args(argv)
    if torch.device(args.device).type == 'cuda' and \
            not torch.cuda.is_available():
        sys.exit(f'--device {args.device}: no CUDA device is available '
                 f'(pass --device cpu to run on the host)')
    ckpt = args.ckpt_path if os.path.exists(args.ckpt_path) else None
    if ckpt is None and not args.random_init:
        sys.exit(f'checkpoint not found: {args.ckpt_path} (use '
                 f'--random-init for a smoke test)')
    dtype = DTYPES[args.dtype]
    model = build_vqgan({'codebook_size': args.codebook_size}, ckpt,
                        dtype=dtype, device=args.device)
    os.makedirs(args.save_root, exist_ok=True)
    paths = sorted(glob.glob(os.path.join(args.test_path, '*.[jp][pn]g')))
    run(model, paths, args.save_root, args.batch, dtype)
    print(f'Results saved in {args.save_root}')
    return args.save_root


if __name__ == '__main__':
    main()
