"""FFHQ blind-degradation datasets — on-the-fly LQ synthesis.

Behavioral spec: basicsr/data/{ffhq_blind_dataset.py,
ffhq_blind_joint_dataset.py}: hflip augment, iso/aniso Gaussian blur,
random downsample+restore, Gaussian noise, JPEG, optional inpainting
brush masks and colorization jitter/gray augments, (0.5, 0.5) normalize.

Outputs are NHWC RGB float32 numpy (the JAX package's layout) instead of CHW
tensors; batching/sharding happens in loader.py.
"""
from __future__ import annotations

import math
import os
import os.path as osp
from typing import Dict, List

import cv2
import numpy as np

from codeformer_tpu_torch.utils.registry import DATASET_REGISTRY
from . import degradations
from .masks import brush_stroke_mask


def _paths_from_folder(folder: str) -> List[str]:
    exts = ('.png', '.jpg', '.jpeg', '.PNG', '.JPG', '.JPEG')
    return sorted(osp.join(folder, f) for f in os.listdir(folder)
                  if f.endswith(exts))


@DATASET_REGISTRY.register()
class FFHQBlindDataset:
    """Map-style dataset: __getitem__ -> {'in', 'gt', 'gt_path'
    [, 'latent_gt']} with NHWC RGB float32 normalized arrays."""

    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_folder = opt['dataroot_gt']
        self.gt_size = opt.get('gt_size', 512)
        self.in_size = opt.get('in_size', 512)
        assert self.gt_size >= self.in_size, 'Wrong setting.'
        self.mean = np.asarray(opt.get('mean', [0.5, 0.5, 0.5]), np.float32)
        self.std = np.asarray(opt.get('std', [0.5, 0.5, 0.5]), np.float32)

        self.latent_gt_path = opt.get('latent_gt_path')
        if self.latent_gt_path is not None:
            import torch
            self.latent_gt_dict = torch.load(self.latent_gt_path,
                                             map_location='cpu')
            self.load_latent_gt = True
        else:
            self.load_latent_gt = False

        io_type = (opt.get('io_backend') or {}).get('type', 'disk')
        if io_type != 'disk':
            raise NotImplementedError(
                f'io_backend {io_type}; use disk (lmdb planned)')
        self.paths = _paths_from_folder(self.gt_folder)

        self.gen_inpaint_mask = opt.get('gen_inpaint_mask', False)
        self.use_corrupt = opt.get('use_corrupt', True)

        if self.use_corrupt and not self.gen_inpaint_mask:
            self.blur_kernel_size = opt['blur_kernel_size']
            self.blur_sigma = opt['blur_sigma']
            self.kernel_list = opt['kernel_list']
            self.kernel_prob = opt['kernel_prob']
            self.downsample_range = opt['downsample_range']
            self.noise_range = opt['noise_range']
            self.jpeg_range = opt['jpeg_range']

        self.color_jitter_prob = opt.get('color_jitter_prob')
        self.color_jitter_pt_prob = opt.get('color_jitter_pt_prob')
        self.color_jitter_shift = opt.get('color_jitter_shift', 20) / 255.0
        self.gray_prob = opt.get('gray_prob', 0.0)

        # per-call Generators (see _make_rng): numpy Generators are not
        # thread-safe and the loader maps __getitem__ across a thread pool
        self._seed = opt.get('seed')
        if self._seed is None:
            self._seed = int(np.random.SeedSequence().entropy) % (2 ** 63)
        self._visit_counts: Dict[int, int] = {}
        import threading
        self._rng_lock = threading.Lock()

    def _make_rng(self, index: int) -> np.random.Generator:
        """Fresh Generator per __getitem__ call: thread-safe and, for a
        fixed seed, a reproducible stream per (index, visit-number) —
        independent of thread scheduling across indices."""
        with self._rng_lock:
            n = self._visit_counts.get(index, 0)
            self._visit_counts[index] = n + 1
        return np.random.default_rng((self._seed, index, n))

    def __len__(self):
        return len(self.paths)

    # -------------------- degradation steps --------------------
    def _degrade(self, img_gt: np.ndarray, rng) -> np.ndarray:
        """img_gt: float32 BGR [0,1] (gt_size^2) -> degraded in_size^2.

        Dispatches blur+downsample+noise to the fused native kernel
        (native/degrade.cpp) at large downsample factors where its
        sample-only evaluation beats cv2's dense FFT filter; cv2 otherwise.
        """
        img_in = img_gt
        kernel = degradations.random_mixed_kernels(
            self.kernel_list, self.kernel_prob, self.blur_kernel_size,
            self.blur_sigma, self.blur_sigma, (-math.pi, math.pi),
            noise_range=None, rng=rng)

        scale = rng.uniform(*self.downsample_range)
        dsize = int(self.gt_size // scale)
        sigma = 0.0
        if self.noise_range is not None:
            sigma = rng.uniform(self.noise_range[0] / 255.0,
                                self.noise_range[1] / 255.0)

        img_small = None
        if scale >= 8 and self.opt.get('native_degrade', True):
            from .native import degrade_batch_native
            out = degrade_batch_native(
                np.ascontiguousarray(img_in)[None], kernel[None],
                np.array([[dsize, dsize]], np.int32),
                np.array([sigma], np.float32), dsize,
                seed=int(rng.integers(2 ** 62)))
            if out is not None:
                img_small = out[0]
        if img_small is None:
            img_small = cv2.filter2D(img_in, -1, kernel)
            img_small = cv2.resize(img_small, (dsize, dsize),
                                   interpolation=cv2.INTER_LINEAR)
            if sigma > 0:
                img_small = degradations.add_gaussian_noise(img_small,
                                                            sigma, rng)

        if self.jpeg_range is not None:
            quality = rng.uniform(*self.jpeg_range)
            img_small = degradations.jpeg_compress(img_small, quality)

        return cv2.resize(img_small, (self.in_size, self.in_size),
                          interpolation=cv2.INTER_LINEAR)

    def _colorize_augments(self, img_in: np.ndarray, rng) -> np.ndarray:
        if self.color_jitter_prob is not None and \
                rng.uniform() < self.color_jitter_prob:
            jitter = rng.uniform(-self.color_jitter_shift,
                                 self.color_jitter_shift, 3).astype(
                                     np.float32)
            img_in = np.clip(img_in + jitter, 0, 1)
        if self.gray_prob and rng.uniform() < self.gray_prob:
            g = cv2.cvtColor(img_in, cv2.COLOR_BGR2GRAY)
            img_in = np.tile(g[:, :, None], (1, 1, 3))
        return img_in

    def __getitem__(self, index: int) -> Dict:
        rng = self._make_rng(index)
        gt_path = self.paths[index]
        name = osp.basename(gt_path)[:-4]
        img_gt = cv2.imread(gt_path, cv2.IMREAD_COLOR).astype(
            np.float32) / 255.0

        hflip = bool(self.opt.get('use_hflip')) and rng.uniform() < 0.5
        if hflip:
            img_gt = cv2.flip(img_gt, 1)

        latent_gt = None
        if self.load_latent_gt:
            key = 'hflip' if hflip else 'orig'
            latent_gt = np.asarray(self.latent_gt_dict[key][name],
                                   np.int32).reshape(-1)

        img_in = img_gt
        if self.use_corrupt and not self.gen_inpaint_mask:
            img_in = self._degrade(img_gt, rng)

        if self.gen_inpaint_mask:
            from PIL import Image
            img_u8 = (img_in * 255).astype('uint8')
            img_in = np.array(
                brush_stroke_mask(Image.fromarray(img_u8))) / 255.0
            img_in = img_in.astype(np.float32)

        img_in = self._colorize_augments(img_in.astype(np.float32), rng)

        # BGR->RGB, round/clip to the uint8 grid, normalize (NHWC stays)
        img_in = np.ascontiguousarray(img_in[..., ::-1])
        img_gt_rgb = img_gt[..., ::-1]

        # pt-style jitter runs on RGB, after the BGR-space augments and
        # before the uint8 rounding (ffhq_blind_dataset.py:268-276)
        if self.color_jitter_pt_prob is not None and \
                rng.uniform() < self.color_jitter_pt_prob:
            from .transforms import color_jitter_pt
            img_in = color_jitter_pt(
                img_in,
                self.opt.get('brightness', (0.5, 1.5)),
                self.opt.get('contrast', (0.5, 1.5)),
                self.opt.get('saturation', (0, 1.5)),
                self.opt.get('hue', (-0.1, 0.1)), rng)

        img_in = np.clip((img_in * 255.0).round(), 0, 255) / 255.0
        img_in = (img_in - self.mean) / self.std
        img_gt_rgb = (img_gt_rgb - self.mean) / self.std

        out = {'in': img_in.astype(np.float32),
               'gt': img_gt_rgb.astype(np.float32),
               'gt_path': gt_path}
        if latent_gt is not None:
            out['latent_gt'] = latent_gt
        return out


@DATASET_REGISTRY.register()
class FFHQBlindJointDataset(FFHQBlindDataset):
    """Stage-III joint dataset: adds a second, larger-degradation branch
    `in_large_de` using the *_large ranges
    (ffhq_blind_joint_dataset.py:215-248)."""

    def __init__(self, opt: Dict):
        super().__init__(opt)
        self.blur_sigma_large = opt['blur_sigma_large']
        self.downsample_range_large = opt['downsample_range_large']
        self.noise_range_large = opt['noise_range_large']
        self.jpeg_range_large = opt['jpeg_range_large']

    def _degrade_large(self, img_gt: np.ndarray, rng) -> np.ndarray:
        img_in = img_gt
        kernel = degradations.random_mixed_kernels(
            self.kernel_list, self.kernel_prob, self.blur_kernel_size,
            self.blur_sigma_large, self.blur_sigma_large,
            (-math.pi, math.pi), noise_range=None, rng=rng)
        img_in = cv2.filter2D(img_in, -1, kernel)
        scale = rng.uniform(*self.downsample_range_large)
        img_in = cv2.resize(img_in, (int(self.gt_size // scale),
                                     int(self.gt_size // scale)),
                            interpolation=cv2.INTER_LINEAR)
        sigma = rng.uniform(self.noise_range_large[0] / 255.0,
                            self.noise_range_large[1] / 255.0)
        img_in = degradations.add_gaussian_noise(img_in, sigma, rng)
        quality = rng.uniform(*self.jpeg_range_large)
        img_in = degradations.jpeg_compress(img_in, quality)
        return cv2.resize(img_in, (self.in_size, self.in_size),
                          interpolation=cv2.INTER_LINEAR)

    def __getitem__(self, index: int) -> Dict:
        rng = self._make_rng(index)
        gt_path = self.paths[index]
        name = osp.basename(gt_path)[:-4]
        img_gt = cv2.imread(gt_path, cv2.IMREAD_COLOR).astype(
            np.float32) / 255.0
        hflip = bool(self.opt.get('use_hflip')) and rng.uniform() < 0.5
        if hflip:
            img_gt = cv2.flip(img_gt, 1)

        latent_gt = None
        if self.load_latent_gt:
            key = 'hflip' if hflip else 'orig'
            latent_gt = np.asarray(self.latent_gt_dict[key][name],
                                   np.int32).reshape(-1)

        img_in = self._degrade(img_gt, rng)
        img_in_large = self._degrade_large(img_gt, rng)

        def norm(x):
            x = x[..., ::-1]
            x = np.clip((x * 255.0).round(), 0, 255) / 255.0
            return ((x - self.mean) / self.std).astype(np.float32)

        gt_rgb = ((img_gt[..., ::-1] - self.mean) / self.std).astype(
            np.float32)
        out = {'in': norm(img_in), 'in_large_de': norm(img_in_large),
               'gt': gt_rgb, 'gt_path': gt_path}
        if latent_gt is not None:
            out['latent_gt'] = latent_gt
        return out
