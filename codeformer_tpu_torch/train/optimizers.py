"""Optimizer from a YAML `optim_g:` block (counterpart of
codeformer_tpu/train/optimizers.py:14-43).

The JAX chain scale_by_adam -> add_decayed_weights(wd) ->
scale_by_learning_rate is DECOUPLED weight decay, p -= lr * (adam + wd*p):
torch.optim.AdamW with eps 1e-8, not torch.optim.Adam(weight_decay=...),
which adds wd*p to the gradient (L2) before the moments see it. Frozen
modules are left out of `params` by the caller (requires_grad False), as
the JAX trainers differentiate only the trainable subtree.
"""
from __future__ import annotations

from typing import Iterable

import torch


def build_optimizer(optim_opt: dict,
                    params: Iterable[torch.nn.Parameter]
                    ) -> torch.optim.AdamW:
    """Adam only, as the reference (base_model.py:83) and the JAX
    package. The lr given here is the base lr; the trainer sets the
    scheduled lr before every step."""
    opt = dict(optim_opt)
    otype = opt.pop('type', 'Adam')
    if otype != 'Adam':
        raise NotImplementedError(
            f'optimizer {otype} is not supported (the reference supports '
            f'Adam only, base_model.py:83)')
    betas = tuple(opt.get('betas', (0.9, 0.999)))
    wd = float(opt.get('weight_decay', 0) or 0)
    return torch.optim.AdamW(list(params), lr=float(opt['lr']), betas=betas,
                             eps=1e-8, weight_decay=wd)
