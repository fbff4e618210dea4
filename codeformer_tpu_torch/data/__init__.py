"""Data pipeline (the port's own copy of codeformer_tpu/data): degradation
synthesis datasets, samplers, prefetching loaders, host-side numpy and
cv2. Importing registers the datasets in DATASET_REGISTRY. The package
`codeformer_tpu_torch` does not import this one, which needs cv2 and PIL:
only the training entry point does, inside its functions."""
from codeformer_tpu_torch.utils.registry import DATASET_REGISTRY

from .ffhq_blind_dataset import FFHQBlindDataset, FFHQBlindJointDataset
from .paired_image_dataset import PairedImageDataset
from .loader import DataLoader, EnlargedSampler


def build_dataset(dataset_opt: dict):
    """Factory mirroring basicsr/data/__init__.py:25-37."""
    dataset_opt = dict(dataset_opt)
    dataset = DATASET_REGISTRY.get(dataset_opt['type'])(dataset_opt)
    return dataset


__all__ = ['build_dataset', 'FFHQBlindDataset', 'FFHQBlindJointDataset',
           'PairedImageDataset', 'DataLoader', 'EnlargedSampler']
