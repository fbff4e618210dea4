"""The Real-ESRGAN background and face upsampler, counterpart of
codeformer_tpu/pipeline/realesrgan.py (the reference's
basicsr/utils/realesrgan_utils.py RealESRGANer): x`scale` RRDBNet
inference over overlapping tiles, 0-255 BGR in and out.

The tile walk is the JAX package's, on the device: the image is
edge-padded (`F.pad` replicate) so that every `tile + 2 * tile_pad`
square window fits, the windows are cut with `unfold`, run `tile_batch`
at a time (the last batch padded with zero tiles, so every batch has one
shape), each upscaled tile is rounded to uint8, and the core of each is
written back. An image that fits one tile runs whole, reflect-padded to
a multiple of the scale. The same walk serves one image (`enhance`,
`upscale_device`) and a batch of device frames
(`upscale_frames_device`, the fused pipeline's background), whose
windows are batched across the frames. Only the uint8 result crosses
back to the host,
where the reference's mode handling (gray, alpha, 16-bit, the Lanczos
`outscale` resize) runs; cv2 is imported only there.
"""
from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from codeformer_tpu_torch.models.rrdbnet import RRDBNet
from codeformer_tpu_torch.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.utils.convert import load_pth

REALESRGAN_X2_WEIGHTS = 'weights/realesrgan/RealESRGAN_x2plus.pth'


class RealESRGANer:
    """Tiled x`scale` upsampler: enhance(img_bgr, outscale) -> (img, mode),
    the reference's API (realesrgan_utils.py:176-252).

    model: a built RRDBNet, used with the parameters it has unless
    `model_path` is given; else the x2plus architecture, loaded from
    `model_path` or weights/realesrgan/RealESRGAN_x2plus.pth
    ('params_ema', then 'params'), or seeded (0) if `allow_random`.
    The model runs on `device` in `dtype` (bf16 by default, as the JAX
    package's; fp32 is the reference's numerics).
    """

    def __init__(self, scale: int = 2, model_path: Optional[str] = None,
                 model: Optional[RRDBNet] = None, tile: int = 400,
                 tile_pad: int = 10, pre_pad: int = 0, tile_batch: int = 4,
                 allow_random: bool = False,
                 dtype: torch.dtype = torch.bfloat16, device='cuda'):
        self.scale = scale
        self.tile_size = tile
        self.tile_pad = tile_pad
        self.pre_pad = pre_pad
        self.tile_batch = tile_batch
        self.dtype = dtype
        self.device = torch.device(device)
        if model is None:
            model = RRDBNet(num_in_ch=3, num_out_ch=3, num_feat=64,
                            num_block=23, num_grow_ch=32, scale=scale)
            path = model_path or REALESRGAN_X2_WEIGHTS
            if os.path.exists(path):
                model.load_state_dict(load_pth(path))
            elif allow_random:
                init_params_fast(model, 0)
            else:
                raise FileNotFoundError(
                    f'RealESRGAN weights not found at {path}')
        elif model_path is not None:
            model.load_state_dict(load_pth(model_path))
        model = model.to(self.device, dtype).eval().requires_grad_(False)
        if self.device.type == 'cuda':   # cuDNN's bf16 convs are NHWC
            model = model.to(memory_format=torch.channels_last)
        self.model = model
        self._tile_counts = {'calls': 0, 'tiles': 0, 'pad_tiles': 0,
                             'fused_calls': 0}

    @torch.inference_mode()
    def _fwd(self, tiles: torch.Tensor) -> torch.Tensor:
        """(N, 3, t, t) fp32 RGB in [0, 1] -> (N, 3, t*s, t*s) uint8, each
        tile rounded on its own (JAX's `_fwd`)."""
        x = tiles.to(self.dtype)
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        before = self.model.dense_calls
        out = self.model(x).float().clamp(0.0, 1.0)
        self._tile_counts['fused_calls'] += self.model.dense_calls - before
        return torch.round(out * 255.0).to(torch.uint8)

    def tile_counts(self) -> dict:
        """Model forwards since the last reset: `calls` (forwards),
        `tiles` (windows of an image run through them, a whole image
        counting as one), `pad_tiles` (zero windows that filled a last
        batch), `fused_calls` (forwards whose trunk ran on the Hopper conv
        core, models/rrdbnet.py `uses_dense_trunk`)."""
        return dict(self._tile_counts)

    def reset_tile_counts(self) -> None:
        for k in self._tile_counts:
            self._tile_counts[k] = 0

    def _count(self, tiles: int, pad_tiles: int = 0) -> None:
        c = self._tile_counts
        c['calls'] += 1
        c['tiles'] += tiles
        c['pad_tiles'] += pad_tiles

    def _process_whole(self, x: torch.Tensor,
                       batch: Optional[int] = None) -> torch.Tensor:
        """(N, 3, h, w) fp32 -> (N, 3, h*s, w*s) uint8, `batch` images a
        forward (default tile_batch). The input is reflect-padded to a
        multiple of the scale (the scale-2 model pixel-unshuffles it; the
        reference's mod_pad, realesrgan_utils.py:79-87) and the output
        cropped back."""
        h, w = x.shape[2:]
        s = self.scale
        ph, pw = (s - h % s) % s, (s - w % s) % s
        if ph or pw:
            x = F.pad(x, (0, pw, 0, ph), mode='reflect')
        batch = batch or self.tile_batch
        outs = []
        for i in range(0, x.shape[0], batch):
            part = x[i:i + batch]
            self._count(part.shape[0])
            outs.append(self._fwd(part)[:, :, :h * s, :w * s])
        return torch.cat(outs)

    def _process_tiled(self, x: torch.Tensor,
                       batch: Optional[int] = None) -> torch.Tensor:
        """(N, 3, h, w) fp32 -> (N, 3, h*s, w*s) uint8 from tile +
        2*tile_pad windows of each edge-padded image, the windows of all
        N images run tile_batch at a time, or `batch` but never more than
        there are windows (the last batch padded with zero windows), the
        core of each upscaled window written back."""
        n, c, h, w = x.shape
        t, pad, s = self.tile_size, self.tile_pad, self.scale
        tiles_y, tiles_x = math.ceil(h / t), math.ceil(w / t)
        padded = F.pad(x, (pad, t * tiles_x - w + pad,
                           pad, t * tiles_y - h + pad), mode='replicate')
        tin = t + 2 * pad
        tiles = padded.unfold(2, tin, t).unfold(3, tin, t)  # n, c, ty, tx
        tiles = tiles.permute(0, 2, 3, 1, 4, 5).reshape(-1, c, tin, tin)
        chunk = self.tile_batch if batch is None \
            else min(batch, tiles.shape[0])
        cores = []
        for i in range(0, tiles.shape[0], chunk):
            part = tiles[i:i + chunk]
            k = part.shape[0]
            if k < chunk:   # one batch shape: pad with zero tiles
                part = torch.cat([part, part.new_zeros(
                    (chunk - k,) + part.shape[1:])])
            self._count(k, chunk - k)
            cores.append(self._fwd(part)[:k, :, pad * s:(pad + t) * s,
                                         pad * s:(pad + t) * s])
        ts = t * s
        core = torch.cat(cores).reshape(n, tiles_y, tiles_x, c, ts, ts) \
            .permute(0, 3, 1, 4, 2, 5).reshape(n, c, tiles_y * ts,
                                               tiles_x * ts)
        return core[:, :, :h * s, :w * s]

    def _upscale(self, x: torch.Tensor,
                 batch: Optional[int] = None) -> torch.Tensor:
        """(N, 3, h, w) fp32 RGB in [0, 1] on the device -> (N, 3, h*s,
        w*s) uint8 RGB: tiled when a side exceeds the tile."""
        if self.tile_size > 0 and max(x.shape[2:]) > self.tile_size:
            return self._process_tiled(x, batch)
        return self._process_whole(x, batch)

    def upscale_device(self, rgb: torch.Tensor) -> torch.Tensor:
        """(3, h, w) fp32 RGB in [0, 1] on the device -> (3, h*s, w*s)
        uint8 RGB on the device."""
        return self._upscale(rgb[None])[0]

    def upscale_frames_device(self, frames: torch.Tensor,
                              tile_batch: Optional[int] = None
                              ) -> torch.Tensor:
        """(C, H, W, 3) uint8 BGR frames on the device -> (C, H*s, W*s, 3)
        uint8 BGR on the device: enhance's arithmetic on each frame (RGB
        in [0, 1], the same walk, each window rounded on its own), the
        windows of all C frames batched together, `tile_batch` (default
        the upsampler's) a forward, at most as many as there are."""
        x = frames.flip(-1).permute(0, 3, 1, 2).float() / 255.0
        return self._upscale(x, tile_batch).permute(0, 2, 3, 1).flip(-1)

    def enhance(self, img: np.ndarray, outscale: Optional[float] = None,
                alpha_upsampler: str = 'realesrgan'):
        """img: uint8 BGR (or 16-bit, gray, BGRA). Returns (output, mode),
        mode one of 'RGB', 'L', 'RGBA', '16bit', as the reference
        (realesrgan_utils.py:176-252); the alpha channel is resized
        linearly, as the JAX package does."""
        img = np.asarray(img)
        h_input, w_input = img.shape[0], img.shape[1]
        max_range = 65535.0 if np.max(img) > 256 else 255.0
        img_mode = '16bit' if max_range == 65535.0 else 'RGB'
        alpha = None
        if img.ndim == 2:
            img_mode = 'L'
            img = np.repeat(img[..., None], 3, axis=2)  # cv2 GRAY2BGR
        elif img.shape[2] == 4:
            img_mode = 'RGBA'
            alpha = img[:, :, 3].astype(np.float32) / max_range
            img = img[:, :, 0:3]
        rgb = np.ascontiguousarray(img[..., ::-1])
        if rgb.dtype == np.uint8:      # one byte a pixel crosses
            x = torch.from_numpy(rgb).to(self.device).float() / max_range
        else:
            x = torch.from_numpy(rgb.astype(np.float32) / max_range) \
                .to(self.device)
        out_u8 = self.upscale_device(x.permute(2, 0, 1))
        out_u8 = out_u8.permute(1, 2, 0).cpu().numpy()[..., ::-1]
        resize = outscale is not None and outscale != float(self.scale)
        if img_mode == 'RGB' and not resize:
            # u8 / 255 * 255 rounds back to u8 exactly
            return np.ascontiguousarray(out_u8), img_mode

        import cv2
        output = out_u8.astype(np.float32) / 255.0
        if img_mode == 'RGBA':
            a_up = cv2.resize(alpha, (w_input * self.scale,
                                      h_input * self.scale),
                              interpolation=cv2.INTER_LINEAR)
            output = np.concatenate([output, a_up[..., None]], axis=2)
        if img_mode == 'L':
            output = cv2.cvtColor((output * 255).astype(np.uint8),
                                  cv2.COLOR_BGR2GRAY)
            output = output.astype(np.float32) / 255.0
        if resize:
            output = cv2.resize(
                output, (int(w_input * outscale), int(h_input * outscale)),
                interpolation=cv2.INTER_LANCZOS4)
        if max_range == 65535.0:
            output = (output * 65535.0).round().astype(np.uint16)
        else:
            output = (output * 255.0).round().astype(np.uint8)
        return output, img_mode


def set_realesrgan(tile: int = 400, allow_random: bool = False,
                   device='cuda') -> RealESRGANer:
    """The x2 background upsampler as the reference CLI builds it
    (inference_codeformer.py:19-53): tile 400, tile_pad 40."""
    return RealESRGANer(scale=2, tile=tile, tile_pad=40, pre_pad=0,
                        allow_random=allow_random, device=device)
