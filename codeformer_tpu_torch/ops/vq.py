"""Codebook lookup (counterpart of codeformer_tpu/ops/vq.py
`codebook_lookup`). The nearest-code search (`_nearest_code_pallas`, the
TPU kernel K3) is not on the serving path and is not ported yet."""
from __future__ import annotations

import torch


def codebook_lookup(indices: torch.Tensor, codebook: torch.Tensor,
                    dtype=None) -> torch.Tensor:
    """indices (...,) -> codebook rows (..., D), gathered in fp32 and then
    cast to `dtype` (default: the codebook's)."""
    out = codebook.float()[indices]
    return out.to(dtype or codebook.dtype)
