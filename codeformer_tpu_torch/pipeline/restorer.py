"""Batched aligned-face restoration on a torch device (counterpart of
codeformer_tpu/pipeline/restorer.py).

Faces go through the model in bucketed batches: uint8 RGB in,
normalize -> CodeFormer -> denormalize on the device, uint8 out, so one
byte per pixel crosses between host and device. In bf16 on a CUDA
device every ResBlock conv, every Downsample and the decoder's tail conv
run the hand-written kernels of ops/conv3x3.py; fp32 serves the plain
path in IEEE fp32 (TF32 off for the call), as JAX's fp32 runs on XLA's
convs; `quant='int8'` serves JAX's int8 path (nn/quant.py). With several
devices each holds a replica of the model and takes an equal shard of
every batch, as JAX's `mesh=` shards the batch over its 'data' axis.
"""
from __future__ import annotations

import contextlib
import copy
import math
from typing import List, Optional, Sequence

import numpy as np
import torch

from codeformer_tpu_torch.models import CodeFormer
from codeformer_tpu_torch.nn.blocks import set_kernels, set_quant
from codeformer_tpu_torch.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.utils.convert import load_pth

# bf16 runs the kernels (bf16 only); fp32 the plain path. JAX serves no
# fp16 either.
SERVING_DTYPES = (torch.bfloat16, torch.float32)


def check_serving_dtype(device, dtype: torch.dtype) -> None:
    """Refuse a dtype the restorer does not serve on a CUDA device (any
    but bf16 and fp32), before a model or the device is touched, rather
    than failing every request (which the passthrough would hide)."""
    device = torch.device(device)
    if device.type == 'cuda' and dtype not in SERVING_DTYPES:
        raise ValueError(f'on {device} the restorer serves bfloat16 (the '
                         f'kernels) or float32 (the plain path); got dtype '
                         f'{dtype}')


@contextlib.contextmanager
def ieee_fp32():
    """cuDNN convs and CUDA matmuls in IEEE fp32 (TF32 off) inside, the
    caller's flags restored after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _on(device: torch.device):
    """The CUDA device context of `device` (launches go to its card)."""
    return torch.cuda.device(device) if device.type == 'cuda' \
        else contextlib.nullcontext()


class CodeFormerRestorer:
    """Loads weights and serves batched aligned-face restoration.

    device: where the model runs ('cuda', 'cuda:0', 'cpu'); or
    devices: several (['cuda:0', 'cuda:1']), one replica of the model on
    each (with its own kept kernel operands), every batch split into
    equal shards launched in turn (the cards overlap), gathered on
    devices[0] (`restore_device`) or the host (`restore_batch`); the
    buckets are rounded to multiples of len(devices) as JAX's mesh
    restorer rounds them. checkpoint: a reference `.pth`, loaded into
    the model. model: a pre-built CodeFormer (e.g. a small test
    topology), used with the parameters it has unless a checkpoint is
    given; overrides the architecture arguments. With neither, the
    full-width model gets a seeded random init (`seed`). Parameters stay
    fp32; activations run in `dtype`: bf16 (the default; the kernels on
    a CUDA device) or fp32 (the plain path, TF32 off for each call; fp16
    is refused on CUDA, `check_serving_dtype`). quant: 'int8' serves
    JAX's int8 path (`set_quant`), None or 'off' the float one.
    """

    def __init__(self, *, device=None, devices: Optional[Sequence] = None,
                 checkpoint: Optional[str] = None,
                 dim_embd: int = 512, codebook_size: int = 1024,
                 n_head: int = 8, n_layers: int = 9,
                 connect_list: Sequence[str] = ('32', '64', '128', '256'),
                 dtype: torch.dtype = torch.bfloat16, face_size: int = 512,
                 batch_buckets: Sequence[int] = (1, 2, 4, 8, 16),
                 seed: int = 0, model: Optional[CodeFormer] = None,
                 quant: Optional[str] = None):
        if devices:
            devices = [torch.device(d) for d in devices]
            if device is not None and torch.device(device) != devices[0]:
                raise ValueError(f'device {device} is not devices[0] '
                                 f'{devices[0]}')
        elif device is not None:
            devices = [torch.device(device)]
        else:
            raise TypeError('CodeFormerRestorer needs device= or devices=')
        for d in devices:
            check_serving_dtype(d, dtype)
        self.devices, self.device = devices, devices[0]
        self.dtype = dtype
        self.quant = quant
        self.face_size = face_size
        n = len(devices)
        if n > 1:
            batch_buckets = {max(b // n, 1) * n for b in batch_buckets} | {n}
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
        if dtype != torch.bfloat16:
            set_kernels(model, False)    # the kernels take bf16 only
        if quant is not None:
            set_quant(model, quant)
        model.eval().requires_grad_(False)
        self.models = [model] + [copy.deepcopy(model) for _ in devices[1:]]
        self.models = [m.to(d) for m, d in zip(self.models, devices)]
        self.model = self.models[0]

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
             enable_fuse: bool, out_device=None) -> torch.Tensor:
        """uint8 RGB (B, H, W, 3) -> uint8 RGB on `out_device` (default
        devices[0]); B a multiple of len(devices), one shard a device."""
        n = len(self.devices)
        if x.shape[0] % n:
            raise ValueError(f'a batch of {x.shape[0]} does not split into '
                             f'{n} equal shards')
        outs = []
        with ieee_fp32() if self.dtype == torch.float32 \
                else contextlib.nullcontext():
            for model, dev, xs in zip(self.models, self.devices,
                                      x.chunk(n)):
                with _on(dev):
                    out, _, _ = model(self.normalize(xs.to(dev)), w,
                                      adain=adain, enable_fuse=enable_fuse)
                    outs.append(self.denormalize(out))
        out_device = self.device if out_device is None else out_device
        if n == 1:
            return outs[0].to(out_device)
        return torch.cat([o.to(out_device) for o in outs])

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
        x = torch.as_tensor(x_rgb_uint8)
        return self._fwd(x if len(self.devices) > 1 else x.to(self.device),
                         w, adain, enable_fuse)

    def _restore_chunk(self, chunk, w, adain, enable_fuse):
        n = len(chunk)
        fs = self.face_size
        x = np.zeros((self._bucket(n), fs, fs, 3), np.uint8)
        for j, face in enumerate(chunk):
            if face.shape[:2] != (fs, fs):
                raise ValueError(f'face {j} has shape {face.shape}, '
                                 f'expected {fs}x{fs}')
            x[j] = face[..., ::-1]                     # BGR -> RGB
        y = self._fwd(torch.from_numpy(x), w, adain, enable_fuse,
                      out_device='cpu')
        y = y[:n].numpy()
        return [im[..., ::-1] for im in y]             # RGB -> BGR
