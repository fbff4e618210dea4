"""Data parallelism over processes (counterpart of codeformer_tpu/parallel,
whose mesh JAX's jit fills with collectives; reference
basicsr/utils/dist_util.py).

One process a device. The launcher (`--launcher pytorch`, under torchrun)
calls `init_dist`, which reads torchrun's RANK, WORLD_SIZE and LOCAL_RANK
and starts a process group: NCCL on CUDA, gloo on the CPU. The trainers
then average their gradients, the adaptive weight's probes, the
discriminator's BatchNorm sums and their logged losses over the group
(`all_reduce_mean`, `all_reduce_sum_autograd`), so a step of n processes
at batch B each equals one process's step at batch n*B, as JAX's mesh
step does. Without a process group every helper is the single-process
identity.
"""
from __future__ import annotations

import datetime
import os
from typing import List, Tuple

import torch
import torch.distributed as dist


def initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_dist_info() -> Tuple[int, int]:
    """(rank, world size); (0, 1) without a process group."""
    if initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def backend() -> str:
    return dist.get_backend() if initialized() else 'none'


def init_dist(launcher: str, device_type: str = 'cuda',
              timeout_s: float = 1800.0) -> Tuple[int, int, int]:
    """Start the process group of `launcher` ('pytorch': torchrun's
    environment, init_method env://) on `device_type` ('cuda': NCCL, and
    the process's device is cuda:LOCAL_RANK; 'cpu': gloo). Returns (rank,
    world size, local rank)."""
    if launcher != 'pytorch':
        raise ValueError(f'launcher {launcher!r}: the port starts its '
                         f'processes with torchrun (--launcher pytorch)')
    missing = [k for k in ('RANK', 'WORLD_SIZE', 'LOCAL_RANK', 'MASTER_ADDR',
                           'MASTER_PORT') if k not in os.environ]
    if missing:
        raise RuntimeError(f'--launcher pytorch needs torchrun\'s '
                           f'environment; {missing} not set')
    rank = int(os.environ['RANK'])
    world = int(os.environ['WORLD_SIZE'])
    local_rank = int(os.environ['LOCAL_RANK'])
    if device_type == 'cuda':
        if not torch.cuda.is_available():
            raise RuntimeError('--launcher pytorch on cuda: no CUDA device '
                               'is available (set device: cpu for gloo)')
        torch.cuda.set_device(local_rank)
    dist.init_process_group(
        'nccl' if device_type == 'cuda' else 'gloo', init_method='env://',
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=timeout_s))
    return rank, world, local_rank


def all_reduce_mean(tensors: List[torch.Tensor]) -> None:
    """Average `tensors` in place over the group with one all-reduce of
    their flattened fp32 concatenation (one bucket)."""
    if not tensors or not initialized():
        return
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat /= dist.get_world_size()
    off = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[off:off + n].view_as(t))
        off += n


def all_reduce_sum_autograd(t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the group, differentiable: the backward sums
    the incoming gradients over the group in turn."""
    if not initialized():
        return t
    from torch.distributed.nn.functional import all_reduce
    return all_reduce(t)


__all__ = ['all_reduce_mean', 'all_reduce_sum_autograd', 'backend',
           'get_dist_info', 'init_dist', 'initialized']
