"""Pixel and token losses (counterpart of codeformer_tpu/train/losses.py:
21-66). Each casts to fp32 at entry and reduces to an fp32 scalar. The
GAN and regularisation losses wait for stages I and III."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_REDUCTIONS = {'none': lambda x: x, 'mean': torch.mean, 'sum': torch.sum}


def _reduce(x: torch.Tensor, weight: Optional[torch.Tensor],
            reduction: str) -> torch.Tensor:
    if weight is not None:
        x = x * weight
    return _REDUCTIONS[reduction](x)


def l1_loss(pred, target, weight=None, reduction='mean', loss_weight=1.0):
    """Reference losses.py:30-56 (L1Loss)."""
    return loss_weight * _reduce((pred.float() - target.float()).abs(),
                                 weight, reduction)


def mse_loss(pred, target, weight=None, reduction='mean', loss_weight=1.0):
    """Reference losses.py:59-85 (MSELoss)."""
    d = pred.float() - target.float()
    return loss_weight * _reduce(d * d, weight, reduction)


def charbonnier_loss(pred, target, weight=None, reduction='mean',
                     loss_weight=1.0, eps=1e-12):
    """Reference losses.py:88-121 (CharbonnierLoss, sqrt(d^2 + eps))."""
    d = pred.float() - target.float()
    return loss_weight * _reduce(torch.sqrt(d * d + eps), weight, reduction)


def cross_entropy_loss(logits, labels, loss_weight=1.0):
    """Token cross-entropy of the code-index head (stage II/III,
    codeformer_idx_model.py:108-110): logits (..., K), labels (...,) int,
    mean over tokens."""
    k = logits.shape[-1]
    return loss_weight * F.cross_entropy(logits.float().reshape(-1, k),
                                         labels.reshape(-1).long())
