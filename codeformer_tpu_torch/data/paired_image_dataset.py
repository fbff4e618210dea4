"""Paired LQ/GT folder dataset for validation
(reference: basicsr/data/paired_image_dataset.py)."""
from __future__ import annotations

import os
import os.path as osp
from typing import Dict

import cv2
import numpy as np

from codeformer_tpu_torch.utils.registry import DATASET_REGISTRY


@DATASET_REGISTRY.register()
class PairedImageDataset:
    def __init__(self, opt: Dict):
        self.opt = opt
        self.gt_folder = opt['dataroot_gt']
        self.lq_folder = opt['dataroot_lq']
        self.mean = np.asarray(opt.get('mean', [0.5, 0.5, 0.5]), np.float32)
        self.std = np.asarray(opt.get('std', [0.5, 0.5, 0.5]), np.float32)
        exts = ('.png', '.jpg', '.jpeg')
        self.gt_paths = sorted(
            osp.join(self.gt_folder, f) for f in os.listdir(self.gt_folder)
            if f.lower().endswith(exts))
        self.lq_paths = sorted(
            osp.join(self.lq_folder, f) for f in os.listdir(self.lq_folder)
            if f.lower().endswith(exts))
        assert len(self.gt_paths) == len(self.lq_paths)

    def __len__(self):
        return len(self.gt_paths)

    def __getitem__(self, index: int) -> Dict:
        def load(path):
            img = cv2.imread(path, cv2.IMREAD_COLOR).astype(
                np.float32) / 255.0
            img = img[..., ::-1]  # BGR->RGB, NHWC
            return ((img - self.mean) / self.std).astype(np.float32)
        return {'lq': load(self.lq_paths[index]),
                'gt': load(self.gt_paths[index]),
                'lq_path': self.lq_paths[index],
                'gt_path': self.gt_paths[index]}
