"""VGG feature extractor for the perceptual and LPIPS losses (counterpart
of codeformer_tpu/models/vgg.py; reference basicsr/archs/vgg_arch.py).

`features` is torchvision's `nn.Sequential` numbering (conv, ReLU, ...,
max-pool), so a torchvision `vgg16.pth`/`vgg19.pth` state dict loads by
its own `features.N.*` names. Only the layers up to the deepest
requested tap are built. Layer names are the reference's ('conv1_1',
'relu1_1', ..., 'pool5'). Convs compute in the input's dtype (fp32
parameters cast on use, as flax's `dtype=`).
"""
from __future__ import annotations

from typing import Dict, Sequence

import torch
import torch.nn as nn

from codeformer_tpu_torch.nn.blocks import Conv2d
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY

# (out_channels, convs) per stage (torchvision cfgs A/B/D/E)
_VGG_PLANS = {
    'vgg11': ((64, 1), (128, 1), (256, 2), (512, 2), (512, 2)),
    'vgg13': ((64, 2), (128, 2), (256, 2), (512, 2), (512, 2)),
    'vgg16': ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)),
    'vgg19': ((64, 2), (128, 2), (256, 4), (512, 4), (512, 4)),
}

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def vgg_layer_names(vgg_type: str = 'vgg19') -> list:
    """The reference's layer names in `features` order."""
    names = []
    for stage, (_, n_convs) in enumerate(_VGG_PLANS[vgg_type], start=1):
        for i in range(1, n_convs + 1):
            names += [f'conv{stage}_{i}', f'relu{stage}_{i}']
        names.append(f'pool{stage}')
    return names


def _channel_norm(x: torch.Tensor, mean, std) -> torch.Tensor:
    shape = (1, 3, 1, 1)
    return (x - torch.tensor(mean, dtype=x.dtype, device=x.device)
            .view(shape)) / torch.tensor(std, dtype=x.dtype,
                                         device=x.device).view(shape)


@ARCH_REGISTRY.register()
class VGGFeatureExtractor(nn.Module):
    """Runs VGG to the deepest requested layer and returns {name: tapped
    activation (B, C, H, W)} (vgg_arch.py:54-161)."""

    def __init__(self, layer_name_list: Sequence[str] = ('conv5_4',),
                 vgg_type: str = 'vgg19', use_input_norm: bool = True,
                 range_norm: bool = False):
        super().__init__()
        self.layer_name_list = tuple(layer_name_list)
        self.use_input_norm = use_input_norm
        self.range_norm = range_norm
        names = vgg_layer_names(vgg_type)
        unknown = set(self.layer_name_list) - set(names)
        if unknown:
            raise ValueError(f'{vgg_type} has no layers {sorted(unknown)}')
        depth = max(names.index(n) for n in self.layer_name_list) + 1
        layers, in_ch = [], 3
        for ch, n_convs in _VGG_PLANS[vgg_type]:
            for _ in range(n_convs):
                layers += [Conv2d(in_ch, ch, 3, padding=1), nn.ReLU()]
                in_ch = ch
            layers.append(nn.MaxPool2d(2, 2))
        self.names = names[:depth]
        self.features = nn.Sequential(*layers[:depth])

    def load_torchvision(self, state_dict: Dict[str, torch.Tensor]) -> None:
        """Load a torchvision VGG state dict: its `features.N.*` entries
        for the layers built here; the rest (deeper layers, the
        classifier) are left out."""
        own = self.state_dict()
        missing = set(own) - set(state_dict)
        if missing:
            raise KeyError(f'VGG state dict lacks {sorted(missing)[:4]}')
        self.load_state_dict({k: state_dict[k] for k in own})

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        if self.range_norm:
            x = (x + 1.0) / 2.0
        if self.use_input_norm:
            x = _channel_norm(x, IMAGENET_MEAN, IMAGENET_STD)
        wanted = set(self.layer_name_list)
        out = {}
        for name, layer in zip(self.names, self.features):
            x = layer(x)
            if name in wanted:
                out[name] = x
        return out
