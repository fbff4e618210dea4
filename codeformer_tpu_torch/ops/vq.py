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

The kernel reads the codebook as its zero-padded transpose and |e_j|^2
(`codebook_operands`), kept for each codebook tensor until it is updated
in place, replaced, moved or cast, so a call on an unchanged codebook is
one launch. `k3_plan` chooses the kernel's grid; the C side only checks
it.
"""
from __future__ import annotations

import contextlib
import functools
import weakref
from typing import NamedTuple

import torch

from codeformer_tpu_torch.kernels.build import launch, library
from codeformer_tpu_torch.ops.conv3x3 import operand_key


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


# K3's tiling (csrc/nearest_code.cu): a block takes 64 tokens and tiles of
# 128 codes, and walks D in chunks of 64; the blocks of one token tile form
# a cluster of 1, 2, 4 or 8 (at most the portable cluster size). A block
# keeps its z rows in shared memory, which bounds D.
K3_TOKENS_PER_BLOCK = 64
K3_CODES_PER_TILE = 128
K3_D_CHUNK = 64
K3_MAX_DIM = 384


# clusters of 1, 2, 4 and 8 blocks an H100 80GB HBM3 holds at once
# (cudaOccupancyMaxActiveClusters; the kernel asks the card itself,
# `resident_clusters`): 8-block clusters leave 12 of the 132 SMs idle
H100_RESIDENT = (132, 66, 30, 15)
CLUSTER_SIZES = (1, 2, 4, 8)


class K3Plan(NamedTuple):
    tok_tiles: int     # blocks along the tokens (the grid's x)
    code_tiles: int    # tiles of K3_CODES_PER_TILE codes
    cluster: int       # blocks a token tile, dealt the code tiles in turn
    kp: int            # codes padded to whole tiles (the operands' width)
    dp: int            # D padded to whole chunks (the operands' height)


@functools.lru_cache(maxsize=None)
def k3_plan(n_tok: int, n_codes: int, dim: int,
            resident: tuple = H100_RESIDENT) -> K3Plan:
    """The kernel's grid: a cluster of `cluster` blocks per 64 tokens,
    each block walking every cluster-th tile of 128 codes. `resident`
    holds how many clusters of each size in CLUSTER_SIZES the card runs
    at once. The cluster size (at most the code tiles) takes the fewest
    tile-times: waves of clusters, ceil(tok_tiles / resident), times the
    tiles a block walks; ties go to the smaller cluster. So a small T
    spreads the codes over up to 8 blocks to fill the card, and a large T
    gives each block all of them and leaves no SM idle."""
    tok_tiles = -(-n_tok // K3_TOKENS_PER_BLOCK)
    code_tiles = -(-n_codes // K3_CODES_PER_TILE)
    cost = {cs: -(-tok_tiles // n) * -(-code_tiles // cs)
            for cs, n in zip(CLUSTER_SIZES, resident)
            if n > 0 and cs <= code_tiles}
    if not cost:
        raise RuntimeError(f'K3: no cluster size fits the card ({resident})')
    cluster = min(cost, key=lambda cs: (cost[cs], cs))
    return K3Plan(tok_tiles, code_tiles, cluster,
                  code_tiles * K3_CODES_PER_TILE,
                  -(-dim // K3_D_CHUNK) * K3_D_CHUNK)


@functools.lru_cache(maxsize=None)
def resident_clusters(device: int, z_bf16: bool, dp: int) -> tuple:
    """How many clusters of each size in CLUSTER_SIZES the card `device`
    holds at once for the kernel of this z type and padded D (0 where
    none fits)."""
    got = []
    for cs in CLUSTER_SIZES:
        n = library().cf_nearest_code_resident(cs, int(z_bf16), dp, device)
        if n < 0:
            raise RuntimeError(f'K3: the occupancy query failed: cudaError '
                               f'{-n}')
        got.append(n)
    return tuple(got)


# id(codebook) -> (weakref to it, codebook_key, (et, e_sq))
_operands: dict = {}


def codebook_key(codebook: torch.Tensor) -> tuple:
    """What the kept operands of `codebook` depend on: an in-place update
    (`_version`), new storage, device, dtype or shape makes them again."""
    return operand_key(codebook) + (tuple(codebook.shape),)


def _forget(key: int, ref) -> None:
    if _operands.get(key, (None,))[0] is ref:
        del _operands[key]


def _make_operands(codebook: torch.Tensor):
    n_codes, dim = codebook.shape
    plan = k3_plan(1, n_codes, dim)
    with torch.no_grad():
        e = codebook.detach().float()
        et = e.new_zeros(plan.dp, plan.kp)
        et[:dim, :n_codes] = e.t()
        e_sq = e.new_zeros(plan.kp)
        e_sq[:n_codes] = e.square().sum(1)      # as _nearest_code_ref
    return et, e_sq


def codebook_operands(codebook: torch.Tensor):
    """(et, e_sq) of a (K, D) codebook as the kernel reads them: et the
    fp32 transpose zero-padded to (dp, kp), e_sq = |e_j|^2 zero-padded to
    kp (k3_plan). Kept for this tensor object until `codebook_key`
    changes; an inference tensor, which has no version counter, gets them
    made anew every call. Runs on any device (plain PyTorch)."""
    if codebook.is_inference():
        return _make_operands(codebook)
    key = codebook_key(codebook)
    hit = _operands.get(id(codebook))
    if hit is not None and hit[0]() is codebook and hit[1] == key:
        return hit[2]
    ops = _make_operands(codebook)
    ref = weakref.ref(codebook, functools.partial(_forget, id(codebook)))
    _operands[id(codebook)] = (ref, key, ops)
    return ops


class K3Launch(NamedTuple):
    z: torch.Tensor
    et: torch.Tensor
    e_sq: torch.Tensor
    out: torch.Tensor
    n_codes: int
    plan: K3Plan


def prepare_nearest_code(z: torch.Tensor, codebook: torch.Tensor) -> K3Launch:
    """Check a CUDA call of K3 and gather what its launch reads: the kept
    codebook operands, the plan and the int64 output."""
    if z.dim() != 2 or codebook.dim() != 2 or z.shape[1] != codebook.shape[1]:
        raise ValueError(f'need z (T, D) and codebook (K, D), got '
                         f'{tuple(z.shape)} and {tuple(codebook.shape)}')
    if z.dtype not in (torch.float32, torch.bfloat16) \
            or not z.is_contiguous() or z.data_ptr() % 16:
        raise ValueError(f'z: the kernel takes a contiguous, 16-byte '
                         f'aligned fp32 or bf16 tensor, got {z.dtype}, '
                         f'strides {z.stride()}')
    if not codebook.is_floating_point() or codebook.device != z.device:
        raise ValueError(f'codebook: need a float tensor on {z.device}, got '
                         f'{codebook.dtype} on {codebook.device}')
    n_tok, dim = z.shape
    n_codes = codebook.shape[0]
    if dim % 8 or dim > K3_MAX_DIM:
        raise ValueError(f'the kernel takes D a multiple of 8 up to '
                         f'{K3_MAX_DIM}, got {dim}')
    if n_codes == 0:
        raise ValueError('empty codebook')
    et, e_sq = codebook_operands(codebook)
    resident = resident_clusters(z.device.index or 0,
                                 z.dtype == torch.bfloat16, et.shape[0])
    return K3Launch(z, et, e_sq,
                    torch.empty(n_tok, dtype=torch.int64, device=z.device),
                    n_codes, k3_plan(n_tok, n_codes, dim, resident))


def launch_nearest_code(c: K3Launch) -> torch.Tensor:
    """Launch K3 on a prepared call; returns its output."""
    n_tok, dim = c.z.shape
    if n_tok == 0:
        return c.out
    launch('nearest_code', c.z.data_ptr(), int(c.z.dtype == torch.bfloat16),
           c.et.data_ptr(), c.e_sq.data_ptr(), c.out.data_ptr(), n_tok,
           c.n_codes, dim, c.plan.kp, c.plan.dp, c.plan.cluster, on=c.z)
    return c.out


def nearest_code_indices(z: torch.Tensor,
                         codebook: torch.Tensor) -> torch.Tensor:
    """K3: nearest codebook row per token. z (T, D) fp32 or bf16 (bf16 is
    widened exactly), contiguous on CUDA with D a multiple of 8 up to
    K3_MAX_DIM; codebook (K, D), any float type (used in fp32, as
    _nearest_code_ref). Returns int64 (T,). Pass the codebook tensor
    itself (a Parameter is fine), not a fresh view, so its kept operands
    are found again."""
    if z.device.type == 'cpu':
        return _nearest_code_ref(z.detach(), codebook.detach())
    if z.device.type != 'cuda':
        raise RuntimeError(f'no kernel for device {z.device}')
    return launch_nearest_code(prepare_nearest_code(z, codebook))


def codebook_lookup(indices: torch.Tensor, codebook: torch.Tensor,
                    dtype=None) -> torch.Tensor:
    """indices (...,) -> codebook rows (..., D), gathered in fp32 and then
    cast to `dtype` (default: the codebook's)."""
    out = codebook.float()[indices]
    return out.to(dtype or codebook.dtype)
