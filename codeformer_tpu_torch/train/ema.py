"""Shadow EMA of the generator (counterpart of
codeformer_tpu/train/gan_step.py:30-34 `ema_update`; reference
base_model.py:51-58)."""
from __future__ import annotations

from typing import Dict

import torch


@torch.no_grad()
def ema_update(ema: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> None:
    """ema <- ema * decay + params * (1 - decay), in place, for every key
    of `ema` (the trainers keep every parameter there, frozen ones
    included, as params_g_ema does in JAX)."""
    names = list(ema)
    e = [ema[k] for k in names]
    torch._foreach_mul_(e, decay)
    torch._foreach_add_(e, [params[k].detach().to(ema[k].dtype)
                            for k in names], alpha=1.0 - decay)
