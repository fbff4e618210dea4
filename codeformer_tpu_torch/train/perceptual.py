"""Perceptual and LPIPS losses over the port's VGG extractor (counterpart
of codeformer_tpu/train/perceptual.py; reference basicsr/losses/
losses.py:144-282).

Both need pretrained VGG weights, torchvision state dicts under
`weights/vgg/` relative to the working directory; none ship with the
repository, and a loss whose file is missing raises FileNotFoundError.

LPIPS is the lpips package's net='vgg': VGG16 taps relu1_2/2_2/3_3/4_3/
5_3, the lpips ScalingLayer, unit-normalised channels, the trained 1x1
linear heads and a spatial mean. The reference ImageNet-normalises before
handing the images to lpips' own scaling layer (losses.py:268-281); that
double normalisation is kept, so the loss surface is the reference's.
The VGG runs in the trainer's compute dtype; channel norms and
distances are fp32, and the target gets no gradient.

The degraded fallbacks are loud: a missing vgg16.pth falls back to VGG19
taps and missing linear heads to uniform heads, each with a warning and
the `degraded` flag set.
"""
from __future__ import annotations

import logging
import os
from typing import Dict, List, Optional

import torch
import torch.nn as nn

from codeformer_tpu_torch.models.vgg import (IMAGENET_MEAN, IMAGENET_STD,
                                             VGGFeatureExtractor,
                                             _channel_norm)

logger = logging.getLogger('codeformer_tpu_torch')

VGG19_WEIGHTS = 'weights/vgg/vgg19.pth'
VGG16_WEIGHTS = 'weights/vgg/vgg16.pth'
LPIPS_LIN_WEIGHTS = 'weights/vgg/lpips_vgg.pth'

# lpips net='vgg' (VGG16) taps; the VGG19 fallback taps the same depths
LPIPS_LAYERS_VGG16 = ('relu1_2', 'relu2_2', 'relu3_3', 'relu4_3',
                      'relu5_3')
LPIPS_LAYERS_VGG19 = ('relu1_2', 'relu2_2', 'relu3_4', 'relu4_4',
                      'relu5_4')

# lpips.ScalingLayer constants (lpips/lpips.py)
_LPIPS_SHIFT = (-0.030, -0.088, -0.188)
_LPIPS_SCALE = (0.458, 0.448, 0.450)


def _frozen_vgg(path: str, what: str, **kw) -> VGGFeatureExtractor:
    """A VGGFeatureExtractor with the torchvision weights at `path`,
    frozen in eval mode."""
    if not os.path.exists(path):
        raise FileNotFoundError(
            f'{what} needs pretrained VGG weights at {path} (a torchvision '
            f'state dict; none ship with the repository). Remove '
            f'perceptual_opt or provide the file.')
    net = VGGFeatureExtractor(**kw)
    net.load_torchvision(torch.load(path, map_location='cpu',
                                    weights_only=True))
    return net.eval().requires_grad_(False)


def load_lpips_lin_heads(path: str) -> List[torch.Tensor]:
    """The lpips package's trained linear heads (`lin{i}.model.1.weight`,
    (1, C, 1, 1)) as five (C,) weights."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    return [sd[f'lin{i}.model.1.weight'].float().reshape(-1)
            for i in range(5)]


class PerceptualLoss(nn.Module):
    """Weighted L1/L2/Frobenius distance between VGG feature maps
    (losses.py:144-253), with an optional Gram-matrix style term."""

    def __init__(self, layer_weights: Dict[str, float],
                 vgg_type: str = 'vgg19', use_input_norm: bool = True,
                 range_norm: bool = False, perceptual_weight: float = 1.0,
                 style_weight: float = 0.0, criterion: str = 'l1',
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if criterion not in ('l1', 'l2', 'mse', 'fro'):
            raise NotImplementedError(f'{criterion} criterion')
        self.layer_weights = dict(layer_weights)
        self.perceptual_weight = perceptual_weight
        self.style_weight = style_weight
        self.criterion = criterion
        self.dtype = dtype
        self.net = _frozen_vgg(
            VGG16_WEIGHTS if vgg_type == 'vgg16' else VGG19_WEIGHTS,
            'PerceptualLoss', layer_name_list=tuple(self.layer_weights),
            vgg_type=vgg_type, use_input_norm=use_input_norm,
            range_norm=range_norm)

    def _dist(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        d = a.float() - b.float()
        if self.criterion == 'l1':
            return d.abs().mean()
        if self.criterion == 'fro':
            return torch.linalg.vector_norm(d)
        return d.pow(2).mean()

    @staticmethod
    def _gram(feat: torch.Tensor) -> torch.Tensor:
        b, c, h, w = feat.shape
        f = feat.float().reshape(b, c, h * w)
        return f @ f.transpose(1, 2) / (c * h * w)

    def forward(self, x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        fx = self.net(x.to(self.dtype))
        with torch.no_grad():
            fg = self.net(gt.detach().to(self.dtype))
        total = sum(self._dist(fx[n], fg[n]) * w
                    for n, w in self.layer_weights.items())
        total = total * self.perceptual_weight
        if self.style_weight > 0:
            style = sum(self._dist(self._gram(fx[n]), self._gram(fg[n])) * w
                        for n, w in self.layer_weights.items())
            total = total + style * self.style_weight
        return total


class LPIPSLoss(nn.Module):
    """lpips.LPIPS(net='vgg') as the reference wraps it
    (losses.py:256-282); see the module docstring. `degraded` is True
    when a fallback (VGG19 taps or uniform heads) is in use."""

    def __init__(self, loss_weight: float = 1.0, use_input_norm: bool = True,
                 range_norm: bool = False,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.loss_weight = loss_weight
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        self.dtype = dtype
        self.degraded = False
        if os.path.exists(VGG16_WEIGHTS) or not os.path.exists(VGG19_WEIGHTS):
            # the exact path (with neither file, raise naming vgg16)
            self.layers, vgg_type, path = (LPIPS_LAYERS_VGG16, 'vgg16',
                                           VGG16_WEIGHTS)
        else:
            self.degraded = True
            logger.warning(
                'LPIPSLoss DEGRADED: %s missing, falling back to VGG19 taps '
                '%s. The loss surface differs from the reference lpips '
                'net="vgg"; provide the torchvision vgg16 state dict for '
                'the exact loss.', VGG16_WEIGHTS, LPIPS_LAYERS_VGG19)
            self.layers, vgg_type, path = (LPIPS_LAYERS_VGG19, 'vgg19',
                                           VGG19_WEIGHTS)
        self.net = _frozen_vgg(path, 'LPIPSLoss',
                               layer_name_list=self.layers,
                               vgg_type=vgg_type, use_input_norm=False,
                               range_norm=False)
        self.lins: Optional[nn.ParameterList] = None
        if os.path.exists(LPIPS_LIN_WEIGHTS):
            self.lins = nn.ParameterList(
                nn.Parameter(w, requires_grad=False)
                for w in load_lpips_lin_heads(LPIPS_LIN_WEIGHTS))
            if not self.degraded:
                logger.info('LPIPSLoss: the exact lpips net="vgg" pipeline '
                            '(VGG16 taps and trained linear heads)')
        else:
            self.degraded = True
            logger.warning(
                'LPIPSLoss DEGRADED: linear-head weights missing at %s, '
                'using uniform heads (the channel mean). Still a perceptual '
                'distance, but NOT the calibrated LPIPS the reference '
                'trains against.', LPIPS_LIN_WEIGHTS)

    def _pre(self, img: torch.Tensor) -> torch.Tensor:
        """Range norm, ImageNet norm, then lpips' ScalingLayer, in fp32;
        out in the compute dtype."""
        img = img.float()
        if self.range_norm:
            img = (img + 1.0) / 2.0
        if self.use_input_norm:
            img = _channel_norm(img, IMAGENET_MEAN, IMAGENET_STD)
        return _channel_norm(img, _LPIPS_SHIFT, _LPIPS_SCALE).to(self.dtype)

    def forward(self, x: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
        fx = self.net(self._pre(x))
        with torch.no_grad():
            fg = self.net(self._pre(gt.detach()))
        total = 0.0
        for i, name in enumerate(self.layers):
            a, b = fx[name].float(), fg[name].float()
            a = a / torch.sqrt(a.pow(2).sum(1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(b.pow(2).sum(1, keepdim=True) + 1e-10)
            d = (a - b).pow(2)
            if self.lins is not None:   # the 1x1 head: a weighted sum
                d = (d * self.lins[i].view(1, -1, 1, 1)).sum(1, keepdim=True)
            else:
                d = d.mean(1, keepdim=True)
            total = total + d.mean((1, 2, 3)).mean()
        return total * self.loss_weight


def build_perceptual_loss(opt: Dict, dtype: torch.dtype = torch.float32):
    """A `perceptual_opt` block (type LPIPSLoss or PerceptualLoss) -> the
    loss module. `dtype` is the trainer's compute dtype."""
    opt = dict(opt)
    ltype = opt.pop('type')
    if ltype == 'LPIPSLoss':
        return LPIPSLoss(loss_weight=opt.get('loss_weight', 1.0),
                         use_input_norm=opt.get('use_input_norm', True),
                         range_norm=opt.get('range_norm', False),
                         dtype=dtype)
    if ltype == 'PerceptualLoss':
        return PerceptualLoss(
            layer_weights=opt['layer_weights'],
            vgg_type=opt.get('vgg_type', 'vgg19'),
            use_input_norm=opt.get('use_input_norm', True),
            range_norm=opt.get('range_norm', False),
            perceptual_weight=opt.get('perceptual_weight', 1.0),
            style_weight=opt.get('style_weight', 0.0),
            criterion=opt.get('criterion', 'l1'), dtype=dtype)
    raise NotImplementedError(f'perceptual loss {ltype}')
