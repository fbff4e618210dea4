"""Batched aligned-face restoration on a torch device (counterpart of
codeformer_tpu/pipeline/restorer.py).

Faces go through the model in bucketed batches: uint8 RGB in,
normalize -> CodeFormer -> denormalize on the device, uint8 out, so one
byte per pixel crosses between host and device. On a CUDA device every
ResBlock conv, every Downsample and the decoder's tail conv run the
hand-written kernels of ops/conv3x3.py.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from codeformer_tpu_torch.models import CodeFormer
from codeformer_tpu_torch.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.utils.convert import load_pth


class CodeFormerRestorer:
    """Loads weights and serves batched aligned-face restoration.

    device: where the model runs ('cuda', 'cuda:0', 'cpu'); required.
    checkpoint: a reference `.pth`, loaded into the model. model: a
    pre-built CodeFormer (e.g. a small test topology), used with the
    parameters it has unless a checkpoint is given; overrides the
    architecture arguments. With neither, the full-width model gets a
    seeded random init (`seed`). Parameters stay fp32; activations run
    in `dtype` (bf16 by default). On a CUDA device the kernels take only
    bf16, so any other dtype is refused here rather than failing every
    request (which the passthrough would hide).
    """

    def __init__(self, *, device, checkpoint: Optional[str] = None,
                 dim_embd: int = 512, codebook_size: int = 1024,
                 n_head: int = 8, n_layers: int = 9,
                 connect_list: Sequence[str] = ('32', '64', '128', '256'),
                 dtype: torch.dtype = torch.bfloat16, face_size: int = 512,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8, 16),
                 seed: int = 0, model: Optional[CodeFormer] = None):
        self.device = torch.device(device)
        if self.device.type == 'cuda' and dtype != torch.bfloat16:
            raise ValueError(f'on {self.device} the kernels compute in '
                             f'bfloat16; got dtype {dtype}')
        self.dtype = dtype
        self.face_size = face_size
        self.batch_buckets = sorted(batch_buckets)
        if model is None:
            model = CodeFormer(dim_embd=dim_embd,
                               codebook_size=codebook_size, n_head=n_head,
                               n_layers=n_layers,
                               connect_list=tuple(connect_list))
            if checkpoint is None:
                init_params_fast(model, seed)
        if checkpoint is not None:
            model.load_state_dict(load_pth(checkpoint))
        self.model = model.to(self.device).eval().requires_grad_(False)

    def _bucket(self, n: int) -> int:
        for b in self.batch_buckets:
            if n <= b:
                return b
        top = self.batch_buckets[-1]
        return int(top * math.ceil(n / top))

    def normalize(self, x: torch.Tensor) -> torch.Tensor:
        """uint8 RGB (B, H, W, 3) -> (B, 3, H, W) in [-1, 1], `dtype`."""
        return (x.float() / 127.5 - 1.0).to(self.dtype).permute(0, 3, 1, 2)

    @staticmethod
    def denormalize(out: torch.Tensor) -> torch.Tensor:
        """(B, 3, H, W) in [-1, 1] -> uint8 RGB (B, H, W, 3); clip, then
        round half to even, as the JAX restorer."""
        y = out.float().clamp(-1.0, 1.0)
        return torch.round((y + 1.0) * 127.5).to(torch.uint8) \
            .permute(0, 2, 3, 1)

    @torch.inference_mode()
    def _fwd(self, x: torch.Tensor, w: float, adain: bool,
             enable_fuse: bool) -> torch.Tensor:
        out, _, _ = self.model(self.normalize(x), w, adain=adain,
                               enable_fuse=enable_fuse)
        return self.denormalize(out)

    def restore_batch(self, faces_bgr: Sequence[np.ndarray],
                      w: float = 0.5, adain: bool = True,
                      enable_fuse: Optional[bool] = None
                      ) -> List[np.ndarray]:
        """uint8 BGR faces (face_size^2) -> restored uint8 BGR faces.

        enable_fuse defaults to (w > 0), the reference's gate
        (codeformer_arch.py:276). A chunk that fails passes through
        unchanged, as the reference's runtime guard
        (inference_codeformer.py:203-211).
        """
        if enable_fuse is None:
            enable_fuse = w > 0
        out: List[np.ndarray] = []
        max_b = self.batch_buckets[-1]
        faces = list(faces_bgr)
        for i in range(0, len(faces), max_b):
            chunk = faces[i:i + max_b]
            try:
                out.extend(self._restore_chunk(chunk, w, adain, enable_fuse))
            except Exception as error:  # passthrough, as the reference
                print(f'\tFailed inference for CodeFormer: '
                      f'{type(error).__name__}: {error}')
                out.extend(chunk)
        return out

    def restore_device(self, x_rgb_uint8, w: float = 0.5, adain: bool = True,
                       enable_fuse: Optional[bool] = None) -> torch.Tensor:
        """(B, face, face, 3) uint8 RGB (array or tensor) -> restored uint8
        RGB tensor on the device; no copy back to the host."""
        if enable_fuse is None:
            enable_fuse = w > 0
        x = torch.as_tensor(x_rgb_uint8, device=self.device)
        return self._fwd(x, w, adain, enable_fuse)

    def _restore_chunk(self, chunk, w, adain, enable_fuse):
        n = len(chunk)
        fs = self.face_size
        x = np.zeros((self._bucket(n), fs, fs, 3), np.uint8)
        for j, face in enumerate(chunk):
            if face.shape[:2] != (fs, fs):
                raise ValueError(f'face {j} has shape {face.shape}, '
                                 f'expected {fs}x{fs}')
            x[j] = face[..., ::-1]                     # BGR -> RGB
        y = self._fwd(torch.from_numpy(x).to(self.device), w, adain,
                      enable_fuse)
        y = y[:n].cpu().numpy()
        return [im[..., ::-1] for im in y]             # RGB -> BGR
