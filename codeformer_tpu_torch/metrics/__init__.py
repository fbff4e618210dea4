"""Evaluation metrics (the port's copy of codeformer_tpu/metrics;
reference basicsr/metrics)."""
from codeformer_tpu_torch.utils.registry import METRIC_REGISTRY

from .psnr_ssim import calculate_psnr, calculate_ssim


def calculate_metric(data: dict, opt: dict):
    """Factory mirroring basicsr/metrics/__init__.py:9-19: opt['type'] is
    a registered metric, the rest its keyword arguments."""
    opt = dict(opt)
    metric_type = opt.pop('type')
    return METRIC_REGISTRY.get(metric_type)(**data, **opt)


__all__ = ['calculate_psnr', 'calculate_ssim', 'calculate_metric']
