"""flax parameters -> the port's state dict, and `.pth` loading.

`flax_to_state_dict` inverts codeformer_tpu/utils/convert.py
`torch_state_dict_to_flax`: HWIO conv kernels -> OIHW, (I, O) dense
kernels -> (O, I), the packed attention `in_proj_weight` (E, 3E) ->
(3E, E), norm `scale` -> `weight`, `blocks_3` -> `blocks.3`, and the
flax names of the torch Sequential heads back to their indices
(`idx_pred_norm` -> `idx_pred_layer.0`, `scale_0` -> `scale.0`), and a
raw 4-d `weight` param (DCNv2Pack's, HWIO) -> OIHW. Where flax
merged a Sequential index into a name that itself ends in digits
(RetinaFace's `layer1_0`, `stage1_0_0`, `conv5X5_1_0`), the split is
ambiguous: `like=` (the target's state-dict keys) resolves each key to
the target key that reads the same with '.' taken for '_', and adds the
BatchNorm `num_batches_tracked` counters flax does not keep. The
port's modules use the reference `.pth` names, so the result loads with
`load_state_dict` and a released `.pth` needs no conversion at all.
`load_flax_trainer` carries a JAX trainer's weights into a port trainer.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Optional

import numpy as np
import torch

_HEADS = {'idx_pred_norm': 'idx_pred_layer.0',
          'idx_pred_proj': 'idx_pred_layer.1'}
_INDEXED = re.compile(r'^([A-Za-z_]*[A-Za-z])_(\d+)$')   # blocks_3 -> blocks.3
_EMBEDDINGS = {'embedding', 'embed'}                     # quantize.<name>.weight


def _module_path(parts) -> str:
    out = []
    for p in parts:
        if p in _HEADS:
            out.append(_HEADS[p])
            continue
        m = _INDEXED.match(p)
        out.append(f'{m.group(1)}.{m.group(2)}' if m else p)
    return '.'.join(out)


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def flax_to_state_dict(variables: Mapping[str, Any],
                       like: Optional[Iterable[str]] = None
                       ) -> Dict[str, torch.Tensor]:
    """flax variables {'params': ..., ['batch_stats': ...]} (leaves
    array-like) -> {reference .pth key: fp32 torch tensor}. With `like`,
    the keys are those of `like` (see the module docstring)."""
    sd: Dict[str, torch.Tensor] = {}
    for path, leaf in _flatten(variables['params']):
        arr = np.array(leaf, dtype=np.float32)      # a writable copy
        mod, leaf_name = _module_path(path[:-1]), path[-1]
        if leaf_name == 'kernel':
            if arr.ndim == 4:        # HWIO -> OIHW
                arr = arr.transpose(3, 2, 0, 1)
            elif arr.ndim == 2:      # (I, O) -> (O, I)
                arr = arr.T
            else:
                raise ValueError(f'unhandled kernel rank at {path}: '
                                 f'{arr.ndim}')
            key = f'{mod}.weight'
        elif leaf_name == 'scale':
            key = f'{mod}.weight'
        elif leaf_name == 'weight' and arr.ndim == 4:
            # a raw HWIO conv weight (nn/arch_util.py DCNv2Pack) -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
            key = f'{mod}.weight' if mod else 'weight'
        elif leaf_name == 'in_proj_weight':
            arr = arr.T              # (E, 3E) -> (3E, E)
            key = f'{mod}.in_proj_weight'
        elif leaf_name in _EMBEDDINGS:
            key = f'{mod}.{leaf_name}.weight' if mod else \
                f'{leaf_name}.weight'
        else:                        # bias, in_proj_bias, position_emb
            key = f'{mod}.{leaf_name}' if mod else leaf_name
        sd[key] = torch.from_numpy(np.ascontiguousarray(arr))
    for path, leaf in _flatten(variables.get('batch_stats', {})):
        name = {'mean': 'running_mean', 'var': 'running_var'}[path[-1]]
        sd[f'{_module_path(path[:-1])}.{name}'] = torch.from_numpy(
            np.array(leaf, dtype=np.float32))
    if like is None:
        return sd
    target = {k.replace('.', '_'): k for k in like}
    out = {}
    for key, value in sd.items():
        flat = key.replace('.', '_')
        if flat not in target:
            raise KeyError(f'{key}: no key of the target reads {flat}')
        out[target[flat]] = value
    for key in target.values():
        if key.endswith('num_batches_tracked') and key not in out:
            out[key] = torch.tensor(0, dtype=torch.long)
    return out


def load_flax_trainer(trainer, params_g: Mapping[str, Any],
                      vqgan_params: Mapping[str, Any] | None = None) -> None:
    """A JAX trainer's `params_g` (and `vqgan_params`, the frozen HQ
    VQGAN's) -> the port trainer's `net_g` (and `hq_vqgan`), strictly, on
    the trainer's device; the EMA restarts from the loaded params, as JAX
    starts params_g_ema from params_g."""
    trainer.net_g.load_state_dict(flax_to_state_dict({'params': params_g}))
    if vqgan_params is not None:
        trainer.hq_vqgan.load_state_dict(
            flax_to_state_dict({'params': vqgan_params}))
    trainer.reset_ema()


def load_pth(path: str) -> Dict[str, torch.Tensor]:
    """Reference `.pth` -> state dict: 'params_ema' preferred, then
    'params', then the file's top level; DataParallel 'module.' prefixes
    stripped (as codeformer_tpu/utils/convert.py load_torch_checkpoint)."""
    chkpt = torch.load(path, map_location='cpu', weights_only=True)
    state = chkpt
    if isinstance(chkpt, dict):
        for key in ('params_ema', 'params'):
            if key in chkpt:
                state = chkpt[key]
                break
    return {k.removeprefix('module.'): v for k, v in state.items()}
