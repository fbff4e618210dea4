"""Precompute the ground-truth code maps of stages II and III (counterpart
of scripts/generate_latent_gt.py; reference scripts/generate_latent_gt.py):

    python -m codeformer_tpu_torch.cli.generate_latent_gt \
        -i datasets/ffhq/ffhq_512 -o experiments/pretrained_models/vqgan \
        --ckpt_path experiments/pretrained_models/vqgan/vqgan_code1024.pth \
        [--batch 8] [--dtype fp32|bf16] [--device cuda] [--random-init]

Every image of the folder, and its horizontal flip, goes through the HQ
VQAutoEncoder's encoder and the nearest-code search K3 (ops/vq.py), a
batch at a time: T = batch * 256 tokens a K3 call (2048 at the batch of
8). The result is `<save_root>/latent_gt_code<K>.pth`, {'orig' | 'hflip':
{image name: (16, 16) int32}}, the file `latent_gt_path` hands to
FFHQBlindDataset (data/ffhq_blind_dataset.py:46-51). fp32 by default, as
the JAX script (the encoder's textbook blocks, K3 on fp32 tokens);
`--dtype bf16` runs the encoder on K1/K2 and K3 on bf16 tokens, as stage
II's on-the-fly idx_gt does. `encode` is the batched core, on device
tensors; the file walk around it reads with cv2, imported inside it.
"""
from __future__ import annotations

import argparse
import glob
import os
import sys
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from codeformer_tpu_torch.models.vqgan import VQAutoEncoder
from codeformer_tpu_torch.nn.blocks import set_kernels
from codeformer_tpu_torch.ops import vq
from codeformer_tpu_torch.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.utils.convert import load_pth

DTYPES = {'fp32': torch.float32, 'bf16': torch.bfloat16}


def build_vqgan(net_opt: Optional[Dict] = None,
                ckpt_path: Optional[str] = None, seed: int = 0,
                dtype: torch.dtype = torch.float32,
                device='cuda') -> VQAutoEncoder:
    """The HQ VQAutoEncoder (`net_opt`: its constructor keys) in eval mode
    on `device`, from `ckpt_path` (a reference .pth) or, without one,
    seeded random weights. bf16 runs its ResBlocks and Downsamples on
    K1/K2 (which take bf16 only), fp32 on their textbook forms."""
    model = VQAutoEncoder(**(net_opt or {}))
    if ckpt_path:
        model.load_state_dict(load_pth(ckpt_path))
    else:
        init_params_fast(model, seed)
    set_kernels(model, dtype == torch.bfloat16)
    return model.eval().requires_grad_(False).to(device)


@torch.no_grad()
def encode(model: VQAutoEncoder, x: torch.Tensor,
           dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, 3, H, W) images in [-1, 1] -> (B, h, w) int32 code maps: the
    encoder in `dtype`, then K3 against the model's codebook over the
    B*h*w latents in row-major (h, w) order."""
    z, _ = model.encoder(x.to(dtype))
    b, d, h, w = z.shape
    tokens = z.permute(0, 2, 3, 1).reshape(-1, d).contiguous()
    idx = vq.nearest_code_indices(tokens, model.quantize.embedding.weight)
    return idx.reshape(b, h, w).to(torch.int32)


def read_images(paths: Sequence[str], hflip: bool) -> np.ndarray:
    """BGR files -> (B, H, W, 3) RGB float32 in [-1, 1] (the JAX script's
    img[..., ::-1] / 127.5 - 1), flipped left-right with `hflip`."""
    import cv2
    imgs = []
    for p in paths:
        img = cv2.imread(p)
        if img is None:
            raise FileNotFoundError(f'cannot read image: {p}')
        if hflip:
            img = cv2.flip(img, 1)
        imgs.append(img[..., ::-1].astype(np.float32) / 127.5 - 1)
    return np.stack(imgs)


def generate(model: VQAutoEncoder, paths: Sequence[str], batch: int = 8,
             dtype: torch.dtype = torch.float32,
             verbose: bool = False) -> Dict[str, Dict[str, torch.Tensor]]:
    """{'orig' | 'hflip': {name: (h, w) int32}} for the images at `paths`
    (name: the file name without its 4-character extension, as the
    dataset looks it up), `batch` images an encode."""
    device = next(model.parameters()).device
    latent: Dict[str, Dict[str, torch.Tensor]] = {'orig': {}, 'hflip': {}}
    for key in ('orig', 'hflip'):
        for i in range(0, len(paths), batch):
            chunk = paths[i:i + batch]
            x = torch.from_numpy(read_images(chunk, key == 'hflip'))
            idx = encode(model, x.to(device).permute(0, 3, 1, 2), dtype)
            for p, m in zip(chunk, idx.cpu()):
                name = os.path.basename(p)[:-4]
                latent[key][name] = m.clone()
                if verbose:
                    print(name, key, tuple(m.shape))
    return latent


def main(argv=None) -> str:
    p = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    p.add_argument('-i', '--test_path', type=str,
                   default='datasets/ffhq/ffhq_512')
    p.add_argument('-o', '--save_root', type=str,
                   default='./experiments/pretrained_models/vqgan')
    p.add_argument('--codebook_size', type=int, default=1024)
    p.add_argument('--ckpt_path', type=str,
                   default='./experiments/pretrained_models/vqgan/'
                           'vqgan_code1024.pth')
    p.add_argument('--batch', type=int, default=8)
    p.add_argument('--dtype', choices=sorted(DTYPES), default='fp32')
    p.add_argument('--device', type=str, default='cuda',
                   help="Torch device, e.g. 'cuda' (default) or 'cpu'.")
    p.add_argument('--random-init', action='store_true',
                   help='seeded random weights when the checkpoint is '
                        'missing (a smoke run; the codes are meaningless)')
    args = p.parse_args(argv)
    dtype = DTYPES[args.dtype]
    if torch.device(args.device).type == 'cuda' and \
            not torch.cuda.is_available():
        sys.exit(f'--device {args.device}: no CUDA device is available '
                 f'(pass --device cpu to run on the host)')
    ckpt = args.ckpt_path if os.path.exists(args.ckpt_path) else None
    if ckpt is None and not args.random_init:
        sys.exit(f'checkpoint not found: {args.ckpt_path} (pass '
                 f'--random-init for a smoke run)')
    model = build_vqgan({'codebook_size': args.codebook_size}, ckpt,
                        dtype=dtype, device=args.device)
    paths = sorted(glob.glob(os.path.join(args.test_path, '*.[jp][pn]g')))
    latent = generate(model, paths, args.batch, dtype, verbose=True)
    os.makedirs(args.save_root, exist_ok=True)
    out = os.path.join(args.save_root,
                       f'latent_gt_code{args.codebook_size}.pth')
    torch.save(latent, out)
    print(f'\nLatent GT code saved to {out}')
    return out


if __name__ == '__main__':
    main()
