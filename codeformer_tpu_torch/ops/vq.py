"""Vector quantisation: the nearest-code search (K3) and the codebook
lookup (counterpart of codeformer_tpu/ops/vq.py).

  nearest_code_indices  argmin_j (|e_j|^2 - 2 z . e_j) per token, fp32,
                        ties to the lowest j (the TPU kernel K3,
                        `_nearest_code_pallas`)
  codebook_lookup       indices -> codebook rows

Dispatch: a tensor on the CPU goes to the plain PyTorch version
(`_nearest_code_ref`); a CUDA tensor launches the hand-written kernel
(csrc/nearest_code.cu) or raises. There is no fallback from the kernel to
the plain version.
"""
from __future__ import annotations

import contextlib

import torch

_launches = {'nearest_code': 0}


def launch_counts() -> dict:
    """Kernel launches since the last reset, by kernel."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for k in _launches:
        _launches[k] = 0


@contextlib.contextmanager
def _fp32_matmul():
    """Full-fp32 CUDA matmuls (TF32 off) for the duration."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _nearest_code_ref(z: torch.Tensor, codebook: torch.Tensor) -> torch.Tensor:
    """Plain K3, counterpart of `_nearest_code_xla`: z (T, D), codebook
    (K, D) -> int64 (T,) argmin_j (|e_j|^2 - 2 z . e_j) in fp32 with TF32
    off; |z|^2 is the same for every code and is left out. torch.argmin
    returns the first of equal minima: ties go to the lowest index."""
    z = z.float()
    e = codebook.float()
    with _fp32_matmul():
        dot = z @ e.t()
    d = e.square().sum(1)[None] - 2.0 * dot
    return d.argmin(1)


def nearest_code_indices(z: torch.Tensor,
                         codebook: torch.Tensor) -> torch.Tensor:
    """K3: nearest codebook row per token. z (T, D) and codebook (K, D)
    fp32 (contiguous on CUDA); returns int64 (T,), as _nearest_code_ref."""
    if z.device.type == 'cpu':
        return _nearest_code_ref(z, codebook)
    if z.device.type != 'cuda':
        raise RuntimeError(f'no kernel for device {z.device}')
    from codeformer_tpu_torch.kernels.build import library
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f'need z (T, D) and codebook (K, D), got '
                         f'{tuple(z.shape)} and {tuple(codebook.shape)}')
    for name, t in (('z', z), ('codebook', codebook)):
        if t.dtype != torch.float32 or not t.is_contiguous() \
                or t.device != z.device:
            raise ValueError(f'{name}: the kernel takes a contiguous fp32 '
                             f'tensor on {z.device}, got {t.dtype} on '
                             f'{t.device}')
    n_tok, dim = z.shape
    n_codes = codebook.shape[0]
    if n_tok == 0:
        return torch.empty(0, dtype=torch.int64, device=z.device)
    if n_codes == 0:
        raise ValueError('empty codebook')
    z, codebook = z.detach(), codebook.detach()
    e_sq = codebook.square().sum(1)
    keys = torch.empty(n_tok, dtype=torch.int64, device=z.device)
    out = torch.empty(n_tok, dtype=torch.int32, device=z.device)
    rc = library().cf_nearest_code(
        z.data_ptr(), codebook.data_ptr(), e_sq.data_ptr(), keys.data_ptr(),
        out.data_ptr(), n_tok, n_codes, dim, z.device.index or 0,
        torch.cuda.current_stream(z.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f'nearest_code kernel launch failed: cudaError '
                           f'{rc}')
    _launches['nearest_code'] += 1
    return out.long()


def codebook_lookup(indices: torch.Tensor, codebook: torch.Tensor,
                    dtype=None) -> torch.Tensor:
    """indices (...,) -> codebook rows (..., D), gathered in fp32 and then
    cast to `dtype` (default: the codebook's)."""
    out = codebook.float()[indices]
    return out.to(dtype or codebook.dtype)
