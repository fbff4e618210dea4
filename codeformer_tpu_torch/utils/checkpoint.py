"""Seeded parameter initialisation (counterpart of
codeformer_tpu/utils/checkpoint.py `init_params_fast`)."""
from __future__ import annotations

import torch
import torch.nn as nn

_ZEROS = ('bias', 'in_proj_bias', 'position_emb')


@torch.no_grad()
def init_params_fast(model: nn.Module, seed: int = 0) -> nn.Module:
    """Fill every parameter from one seeded torch.Generator with the JAX
    package's random-init scheme: norm scales 1, biases and position
    embeddings 0, codebooks uniform(+-1/K), other weights
    normal(0, sqrt(2 / fan_in)). Returns the model."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (nn.GroupNorm, nn.LayerNorm)) \
                    and name == 'weight':
                p.fill_(1.0)
            elif name in _ZEROS:
                p.zero_()
            elif isinstance(mod, nn.Embedding):
                k = p.shape[0]
                p.copy_(torch.empty(p.shape).uniform_(-1.0 / k, 1.0 / k,
                                                      generator=g))
            else:
                std = (2.0 / max(p[0].numel(), 1)) ** 0.5
                p.copy_(torch.empty(p.shape).normal_(0.0, std, generator=g))
    return model
