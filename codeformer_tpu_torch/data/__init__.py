"""Data pipeline (the port's own copy of codeformer_tpu/data): degradation
synthesis datasets, samplers, prefetching loaders, host-side numpy and
cv2. The datasets need cv2 and PIL, so `build_dataset` imports them (and
so registers them in DATASET_REGISTRY) when first called, and
`data.loader` imports without them: the card's machine has no cv2. Only
the training entry point builds datasets."""
import importlib

from .loader import DataLoader, DevicePrefetcher, EnlargedSampler

_DATASET_MODULES = ('ffhq_blind_dataset', 'paired_image_dataset')


def build_dataset(dataset_opt: dict):
    """Factory mirroring basicsr/data/__init__.py:25-37."""
    from codeformer_tpu_torch.utils.registry import DATASET_REGISTRY
    for module in _DATASET_MODULES:
        importlib.import_module(f'.{module}', __name__)
    dataset_opt = dict(dataset_opt)
    return DATASET_REGISTRY.get(dataset_opt['type'])(dataset_opt)


__all__ = ['build_dataset', 'DataLoader', 'DevicePrefetcher',
           'EnlargedSampler']
