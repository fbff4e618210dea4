"""Losses (counterpart of codeformer_tpu/train/losses.py): pixel, token,
total-variation, the GAN family and the GAN regularisers. Each casts to
fp32 at entry and reduces to an fp32 scalar. Images are NCHW."""
from __future__ import annotations

import math
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


def weighted_tv_loss(pred, weight=None, loss_weight=1.0):
    """Total-variation loss (reference losses.py:124-141): the L1
    distance of each pixel to its lower and its right neighbour."""
    wy = None if weight is None else weight[:, :, :-1, :]
    wx = None if weight is None else weight[:, :, :, :-1]
    y = l1_loss(pred[:, :, :-1, :], pred[:, :, 1:, :], wy)
    x = l1_loss(pred[:, :, :, :-1], pred[:, :, :, 1:], wx)
    return loss_weight * (x + y)


def gan_loss(pred, target_is_real: bool, gan_type: str = 'hinge',
             is_disc: bool = False, real_label_val: float = 1.0,
             fake_label_val: float = 0.0, loss_weight: float = 1.0):
    """GAN loss family (reference losses.py:285-387): vanilla | lsgan |
    wgan | wgan_softplus | hinge. `loss_weight` weighs the generator side
    only, as in the reference (losses.py:381-387)."""
    pred = pred.float()
    if gan_type == 'hinge':
        if is_disc:
            loss = F.relu(1.0 + (-pred if target_is_real else pred)).mean()
        else:
            loss = -pred.mean()
    elif gan_type in ('vanilla', 'lsgan'):
        target = torch.full_like(
            pred, real_label_val if target_is_real else fake_label_val)
        loss = (F.binary_cross_entropy_with_logits(pred, target)
                if gan_type == 'vanilla' else F.mse_loss(pred, target))
    elif gan_type == 'wgan':
        loss = -pred.mean() if target_is_real else pred.mean()
    elif gan_type == 'wgan_softplus':
        loss = F.softplus(-pred if target_is_real else pred).mean()
    else:
        raise NotImplementedError(f'GAN type {gan_type} not implemented')
    return loss if is_disc else loss * loss_weight


def r1_penalty(real_pred, real_img):
    """R1 penalty (reference losses.py:390-404): the mean over images of
    |d sum(real_pred) / d real_img|^2. `real_img` requires grad; the
    penalty keeps its graph (create_graph) so it can be minimised."""
    (grad,) = torch.autograd.grad(real_pred.sum(), real_img,
                                  create_graph=True)
    return grad.float().pow(2).sum((1, 2, 3)).mean()


def g_path_regularize(fake_img, latents, mean_path_length, decay=0.01,
                      noise=None, generator=None):
    """StyleGAN2 path-length regulariser (reference losses.py:407-416):
    the spread of |J^T n| over the batch, n image-shaped noise over
    sqrt(H W). `fake_img` (B, C, H, W) is computed from `latents`
    (B, n, dim), which require grad. `noise` (B, C, H, W, standard
    normal), or drawn from `generator`. Returns (penalty, the updated
    mean path length, detached, and the path lengths)."""
    h, w = fake_img.shape[2:]
    if noise is None:
        noise = torch.randn(fake_img.shape, generator=generator,
                            device=fake_img.device)
    noise = noise / math.sqrt(h * w)
    (grad,) = torch.autograd.grad((fake_img * noise).sum(), latents,
                                  create_graph=True)
    path_lengths = grad.float().pow(2).sum(2).mean(1).sqrt()
    path_mean = mean_path_length + decay * (
        path_lengths.mean() - mean_path_length)
    penalty = (path_lengths - path_mean.detach()).pow(2).mean()
    return penalty, path_mean.detach(), path_lengths


def gradient_penalty_loss(discriminator, real_data, fake_data, weight=None,
                          alpha=None, generator=None):
    """WGAN-GP penalty (reference losses.py:419-455) at random
    interpolates of the real and fake images. `alpha` (B, 1, 1, 1) in
    [0, 1), or drawn from `generator`."""
    if alpha is None:
        alpha = torch.rand((real_data.shape[0], 1, 1, 1),
                           generator=generator, device=real_data.device)
    interp = (alpha * real_data + (1.0 - alpha) * fake_data).detach() \
        .requires_grad_(True)
    (grad,) = torch.autograd.grad(discriminator(interp).sum(), interp,
                                  create_graph=True)
    grad = grad.float()
    if weight is not None:
        grad = grad * weight
    penalty = ((grad.pow(2).sum((1, 2, 3)) + 1e-12).sqrt() - 1.0) \
        .pow(2).mean()
    if weight is not None:
        penalty = penalty / weight.mean()
    return penalty
