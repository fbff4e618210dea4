"""Seeded random weights, made on the device in one draw.

Released weights are not in the repository, so every run makes its own
from `--seed`: one `torch.randn` over all parameters from a
`torch.Generator` on the card, then each parameter's slice scaled by its
kind. The scheme follows the program's own random init
(`init_params_fast`: He-normal weights, unit norm scales, codebook rows
of size 1/K) with small random biases, norm shifts and position
embeddings, so that no term of the network is zero. The state dict is
float32, the type the program keeps its parameters in, and both sides
load the same tensors: the program through `load_state_dict`, the
reference likewise.
"""
from __future__ import annotations

import re
from typing import Dict, Iterable, Tuple

import torch
import torch.nn as nn

NORMS = (nn.GroupNorm, nn.LayerNorm, nn.modules.batchnorm._BatchNorm)
BIAS_STD = 0.02
NORM_STD = 0.1


def param_kinds(model: nn.Module) -> Iterable[Tuple[str, torch.Size, str, int]]:
    """(name, shape, kind, fan_in) of every parameter, in state-dict
    order; kind is 'norm_weight', 'bias', 'codebook' or 'weight'."""
    for mod_name, mod in model.named_modules():
        for name, p in mod.named_parameters(recurse=False):
            full = f'{mod_name}.{name}' if mod_name else name
            if isinstance(mod, NORMS) and name == 'weight':
                kind = 'norm_weight'
            elif p.dim() == 1 or name == 'position_emb':
                kind = 'bias'
            elif isinstance(mod, nn.Embedding):
                kind = 'codebook'
            else:
                kind = 'weight'
            yield full, p.shape, kind, max(p[0].numel(), 1)


def make_state_dict(model: nn.Module, seed: int, device,
                    tame: Dict[str, float] = None) -> Dict[str, torch.Tensor]:
    """The seeded float32 state dict of `model`'s architecture on
    `device` (the model itself may live on the meta device). `tame` maps
    a regular expression over parameter names to a factor applied after
    the draw (the SFT branches' last convs: random SFT weights grow the
    generator's activations past fp32 range)."""
    kinds = list(param_kinds(model))
    total = sum(s.numel() for _, s, _, _ in kinds)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=g, device=device)
    sd, off = {}, 0
    for name, shape, kind, fan_in in kinds:
        n = shape.numel()
        v = flat[off:off + n].view(shape)
        off += n
        if kind == 'norm_weight':
            v.mul_(NORM_STD).add_(1.0)
        elif kind == 'bias':
            v.mul_(BIAS_STD)
        elif kind == 'codebook':
            v.mul_(1.0 / shape[0])
        else:
            v.mul_((2.0 / fan_in) ** 0.5)
        for pattern, factor in (tame or {}).items():
            if re.fullmatch(pattern, name):
                v.mul_(factor)
        sd[name] = v
    for mod_name, mod in model.named_modules():
        if isinstance(mod, nn.modules.batchnorm._BatchNorm):
            sd[f'{mod_name}.running_mean'] = torch.zeros(
                mod.num_features, device=device)
            sd[f'{mod_name}.running_var'] = torch.ones(
                mod.num_features, device=device)
            sd[f'{mod_name}.num_batches_tracked'] = torch.zeros(
                (), dtype=torch.long, device=device)
    return sd
