"""Stage trainers (counterpart of codeformer_tpu/train/trainers.py).

Ported so far: stage II, `CodeFormerIdxModel` (reference
codeformer_idx_model.py). A frozen HQ VQGAN encodes the ground truth and
the nearest-code search K3 (ops/vq.py) turns its latents into the target
code indices `idx_gt`; CodeFormer's encoder and transformer learn them
with a latent-feature L2 loss and a token cross-entropy.

Semantics kept from the JAX trainers:
  - `mixed_precision: bf16`: activations in bf16, parameters, losses,
    optimizer state and EMA in fp32 (the port's Conv2d/Linear cast fp32
    parameters on use, as flax's `dtype=`; no torch.autocast, which keeps
    other ops in fp32 than flax does);
  - `accum_steps`: sequential microbatches, interleaved as JAX's
    `_split_microbatches` (microbatch i = batch[i::n]), grads averaged;
  - `fix_modules` frozen with requires_grad False and kept out of the
    optimizer (JAX `_split_params`), EMA over every parameter;
  - the decoupled weight decay of the optax chain (train/optimizers.py)
    and the 0-based schedule step (train/schedulers.py).

K1/K2 are forward-only: `net_g` always runs its textbook blocks, so
autograd records every conv; the frozen HQ VQGAN, run under no_grad,
takes the kernels when the activations are bf16 (the kernels take bf16
only) and the textbook blocks at fp32.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Dict, Optional

import torch

from codeformer_tpu_torch import models  # noqa: F401  (registers the archs)
from codeformer_tpu_torch.nn.blocks import set_kernels
from codeformer_tpu_torch.ops import vq
from codeformer_tpu_torch.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.utils.convert import load_pth
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY, MODEL_REGISTRY
from .ema import ema_update
from .losses import cross_entropy_loss, mse_loss
from .optimizers import build_optimizer
from .schedulers import build_schedule

logger = logging.getLogger('codeformer_tpu_torch')

def build_model(opt: Dict):
    """Trainer for `opt['model_type']` (basicsr/models/__init__.py:19-30)."""
    model_type = opt['model_type']
    if model_type not in MODEL_REGISTRY:
        raise NotImplementedError(
            f'model_type {model_type!r} is not ported yet: stage I '
            f'(VQGANModel) and stage III (CodeFormerJointModel, '
            f'CodeFormerModel) are ROADMAP.md Queue 1 item 4')
    return MODEL_REGISTRY.get(model_type)(opt)


def build_network(net_opt: Dict) -> torch.nn.Module:
    """An arch from its config block (`type:` plus constructor keys)."""
    net_opt = dict(net_opt)
    return ARCH_REGISTRY.get(net_opt.pop('type'))(**net_opt)


def freeze_modules(net: torch.nn.Module, fix_modules) -> list:
    """requires_grad False on the parameters of the named top-level
    modules (every shipped config: quantize and generator). Returns the
    frozen parameter names."""
    frozen = []
    for name, p in net.named_parameters():
        if name.split('.')[0] in fix_modules:
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


class BaseTrainer:
    """Options, device placement, EMA, checkpoint IO and logging.
    Subclasses define `_build()` (networks, optimizer, schedule) and
    `optimize_parameters(current_iter)`. The device is `opt['device']`
    ('cuda' by default, or e.g. 'cuda:1', 'cpu'); asking for CUDA where
    there is none raises."""

    # train: keys the trainer reads; any other key is warned about, so no
    # knob is silently ignored ('use_adaptive_weight' is carried by the
    # reference's stage-2 config and read by no reference model)
    KNOWN_TRAIN_KEYS = frozenset({
        'total_iter', 'warmup_iter', 'ema_decay', 'optim_g', 'optim_d',
        'scheduler', 'accum_steps', 'remat', 'mixed_precision',
        'use_adaptive_weight'})

    def __init__(self, opt: Dict):
        self.opt = opt
        self.train_opt = opt.get('train') or {}
        self.ema_decay = float(self.train_opt.get('ema_decay', 0.0) or 0.0)
        mp = str(opt.get('mixed_precision')
                 or self.train_opt.get('mixed_precision') or '').lower()
        if mp and mp not in ('bf16', 'bfloat16', 'none', 'fp32',
                             'float32'):
            raise ValueError(f'mixed_precision: unknown value {mp!r} '
                             f"(use 'bf16')")
        self.compute_dtype = torch.bfloat16 if mp in ('bf16', 'bfloat16') \
            else torch.float32
        raw_accum = self.train_opt.get('accum_steps', 1)
        self.accum_steps = 1 if raw_accum is None else int(raw_accum)
        if self.accum_steps < 1:
            raise ValueError(
                f'accum_steps must be >= 1, got {self.accum_steps}')
        if self.train_opt.get('remat'):
            raise NotImplementedError(
                'remat: true is not ported yet (torch.utils.checkpoint, '
                'ROADMAP.md Queue 1 item 4)')
        val = [p for p in (opt.get('datasets') or {})
               if p.split('_')[0] == 'val']
        if val:
            raise NotImplementedError(
                f'validation datasets {val} are not ported yet (ROADMAP.md '
                f'Queue 1 item 4)')
        self.device = torch.device(opt.get('device') or 'cuda')
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device}: no CUDA device is available; the "
                f"trainer does not fall back to the CPU (set `device: cpu` "
                f"in the options to train on the host)")
        if int(opt.get('num_devices') or 1) > 1 or (
                self.device.type == 'cuda' and torch.cuda.device_count() > 1):
            logger.info(f'training on one device, {self.device}: data '
                        f'parallelism (DDP) is ROADMAP.md Queue 1 item 4')
        self.step = 0            # optimizer updates so far (0-based lr step)
        self._log_metrics: Dict[str, torch.Tensor] = {}
        self._log_cache: Optional[Dict[str, float]] = None
        self._build()
        unknown = set(self.train_opt) - self.KNOWN_TRAIN_KEYS
        if unknown:
            logger.warning(f'train: keys IGNORED by {type(self).__name__}: '
                           f'{sorted(unknown)} -- check for typos or '
                           f'unsupported options')

    # ----------------------------------------------------------- EMA
    def reset_ema(self) -> None:
        """EMA := the current parameters (JAX starts params_g_ema as a
        copy of params_g)."""
        self.params_ema = {k: v.detach().float().clone()
                           for k, v in self.net_g.state_dict().items()}

    # ------------------------------------------------- checkpoint IO
    def _net_path(self, name: str, tag) -> str:
        tag = 'latest' if tag == -1 else tag
        return osp.join(self.opt['path']['models'], f'net_{name}_{tag}.pth')

    def save(self, epoch: int, current_iter: int) -> None:
        """net_g as {params, params_ema} (a `.pth` that load_pth and the
        reference read) plus a `.state` file with the optimizer state
        (the reference two-file scheme, base_model.py:170-280)."""
        os.makedirs(self.opt['path']['models'], exist_ok=True)
        state_dir = self.opt['path']['training_states']
        os.makedirs(state_dir, exist_ok=True)
        torch.save({'params': self.net_g.state_dict(),
                    'params_ema': self.params_ema},
                   self._net_path('g', current_iter))
        tag = 'latest' if current_iter == -1 else current_iter
        torch.save({'optimizer_g': self.optimizer.state_dict(),
                    'step': self.step, 'epoch': epoch, 'iter': current_iter},
                   osp.join(state_dir, f'{tag}.state'))

    def resume_training(self, state_path: str):
        """Restore net_g, its EMA, the optimizer and the step from a
        `.state` file and its network file. Returns (epoch, iter)."""
        blob = torch.load(state_path, map_location='cpu', weights_only=True)
        it = int(blob['iter'])
        g = torch.load(self._net_path('g', it), map_location=self.device,
                       weights_only=True)
        self.net_g.load_state_dict(g['params'])
        for k, v in self.params_ema.items():
            v.copy_(g['params_ema'][k])
        self.optimizer.load_state_dict(blob['optimizer_g'])
        self.step = int(blob['step'])
        return int(blob['epoch']), it

    def _load_pretrain(self, path_key: str):
        """A state dict from opt['path'][path_key], or None if unset."""
        path = (self.opt.get('path') or {}).get(path_key)
        if not path:
            return None
        sd = load_pth(path)
        logger.info(f'loaded {path_key} from {path}')
        return sd

    # ---------------------------------------------------------- data
    def feed_data(self, data: Dict) -> None:
        """A loader batch as it comes (NHWC float32 arrays under 'in' and
        'gt', lists of paths, optional 'latent_gt') -> device tensors,
        images as NCHW in channels_last memory (a free permute of NHWC)."""
        batch = {}
        for k, v in data.items():
            if isinstance(v, list):
                continue
            t = torch.as_tensor(v).to(self.device, non_blocking=True)
            batch[k] = t.permute(0, 3, 1, 2) if t.dim() == 4 else t
        self.batch = batch

    def _microbatches(self):
        """The batch as accum_steps interleaved microbatches (JAX
        _split_microbatches: microbatch i = batch[i::n])."""
        n = self.accum_steps
        b = next(iter(self.batch.values())).shape[0]
        if b % n:
            raise ValueError(f'accum_steps={n} must divide the batch size, '
                             f'got batch={b}')
        return [{k: v[i::n] for k, v in self.batch.items()}
                for i in range(n)]

    # ------------------------------------------------------- logging
    def _set_log(self, metrics: Dict[str, torch.Tensor]) -> None:
        """Keep the step's metrics on the device; log_dict fetches them in
        one transfer when read."""
        self._log_metrics = metrics
        self._log_cache = None

    @property
    def log_dict(self) -> Dict[str, float]:
        if self._log_cache is None:
            names = list(self._log_metrics)
            vals = torch.stack([self._log_metrics[k].float().reshape(())
                                for k in names]).tolist() if names else []
            self._log_cache = dict(zip(names, vals))
        return self._log_cache

    def get_current_log(self) -> Dict[str, float]:
        return dict(self.log_dict)

    def get_current_learning_rate(self):
        return [self.schedule_g(self.step)]


@MODEL_REGISTRY.register()
class CodeFormerIdxModel(BaseTrainer):
    """Stage II: code-sequence prediction (codeformer_idx_model.py; JAX
    trainers.py:889-1042): w = 0, code_only; L2 between the HQ codes'
    features (net_g's own codebook) and lq_feat, plus cross-entropy on
    the code indices; quantize and generator frozen."""

    KNOWN_TRAIN_KEYS = BaseTrainer.KNOWN_TRAIN_KEYS | {
        'use_hq_feat_loss', 'feat_loss_weight', 'cross_entropy_loss',
        'entropy_loss_weight', 'fidelity_weight'}

    def _build(self):
        opt = self.opt
        net_opt = dict(opt['network_g'])
        self.fix_modules = tuple(net_opt.pop('fix_modules',
                                             ('quantize', 'generator')))
        vqgan_path = net_opt.pop('vqgan_path', None)
        seed = int(opt.get('manual_seed') or 0)
        self.net_g = init_params_fast(build_network(net_opt), seed)

        self.hq_feat_loss = self.train_opt.get('use_hq_feat_loss', True)
        self.feat_loss_weight = self.train_opt.get('feat_loss_weight', 1.0)
        self.use_ce = self.train_opt.get('cross_entropy_loss', True)
        self.ce_weight = self.train_opt.get('entropy_loss_weight', 0.5)
        if not (self.hq_feat_loss or self.use_ce):
            raise ValueError('stage II needs use_hq_feat_loss or '
                             'cross_entropy_loss')

        vq_sd = None
        if vqgan_path:
            if osp.exists(vqgan_path):
                vq_sd = load_pth(vqgan_path)
            else:
                logger.warning(f'vqgan_path {vqgan_path} not found: '
                               f'encoder, quantize and generator keep their '
                               f'random init')
        pre = self._load_pretrain('pretrain_network_g')
        if pre is not None:
            self.net_g.load_state_dict(pre)
        if vq_sd is not None:
            sub = {k: v for k, v in vq_sd.items()
                   if k.split('.')[0] in ('encoder', 'quantize', 'generator')}
            missing = set(sub) - set(self.net_g.state_dict())
            if missing:
                raise KeyError(f'vqgan_path keys not in network_g: '
                               f'{sorted(missing)[:5]}')
            self.net_g.load_state_dict(sub, strict=False)

        # frozen HQ VQGAN for the on-the-fly latent GT
        # (codeformer_idx_model.py:46-57)
        self.generate_idx_gt = 'network_vqgan' in opt
        self.hq_vqgan = None
        if self.generate_idx_gt:
            self.hq_vqgan = init_params_fast(
                build_network(opt['network_vqgan']), seed + 1)
            vq_pre = self._load_pretrain('pretrain_network_vqgan')
            if vq_pre is None:
                vq_pre = vq_sd
            if vq_pre is not None:
                self.hq_vqgan.load_state_dict(vq_pre)
            self.hq_vqgan.requires_grad_(False).eval().to(self.device)
            hq_kernels = self.compute_dtype == torch.bfloat16
            set_kernels(self.hq_vqgan, hq_kernels)
            logger.info(
                'frozen HQ VQGAN encode: '
                + ('K1/K2 kernels (bf16, no_grad)' if hq_kernels else
                   'textbook blocks (fp32: the K1/K2 kernels take bf16)')
                + '; idx_gt through K3 (nearest_code_indices)')
        self.net_g.to(self.device)
        set_kernels(self.net_g, False)
        logger.info('net_g: textbook blocks (autograd records every conv; '
                    'K1/K2 are forward-only)')
        self.frozen = freeze_modules(self.net_g, self.fix_modules)
        self.schedule_g = build_schedule(self.train_opt,
                                         self.train_opt['optim_g']['lr'])
        self.optimizer = build_optimizer(
            self.train_opt['optim_g'],
            [p for p in self.net_g.parameters() if p.requires_grad])
        self.reset_ema()

    def _idx_gt(self, mb: Dict) -> torch.Tensor:
        """(b, h*w) target codes: the batch's latent_gt if present, else
        the frozen HQ VQGAN's encode -> K3 against ITS codebook. Tokens in
        row-major (h, w) order, as JAX's reshape of NHWC latents; K3 takes
        the latents in the compute dtype and widens bf16 exactly."""
        if 'latent_gt' in mb:
            return mb['latent_gt'].long()
        x, _ = self.hq_vqgan.encoder(mb['gt'].to(self.compute_dtype))
        b, d = x.shape[:2]
        z = x.permute(0, 2, 3, 1).reshape(-1, d).contiguous()
        idx = vq.nearest_code_indices(z,
                                      self.hq_vqgan.quantize.embedding.weight)
        return idx.reshape(b, -1)

    def _losses(self, mb: Dict, idx_gt: torch.Tensor):
        logits, lq_feat = self.net_g(mb['in'].to(self.compute_dtype), 0.0,
                                     code_only=True)
        b, d, h, w = lq_feat.shape
        total = 0.0
        metrics = {}
        if self.hq_feat_loss:
            # net_g's own codebook (JAX trainers.py:991), not the HQ VQGAN's
            quant_gt = vq.codebook_lookup(
                idx_gt.reshape(-1), self.net_g.quantize.embedding.weight,
                torch.float32).reshape(b, h, w, d)
            l_feat = mse_loss(quant_gt.detach(), lq_feat.permute(0, 2, 3, 1),
                              loss_weight=self.feat_loss_weight)
            total = total + l_feat
            metrics['l_feat_encoder'] = l_feat
        if self.use_ce:
            l_ce = cross_entropy_loss(logits, idx_gt,
                                      loss_weight=self.ce_weight)
            total = total + l_ce
            metrics['cross_entropy_loss'] = l_ce
        metrics['l_g_total'] = total
        return total, metrics

    def optimize_parameters(self, current_iter: int) -> None:
        micro = self._microbatches()
        n = len(micro)
        self.optimizer.zero_grad(set_to_none=True)
        metrics: Dict[str, torch.Tensor] = {}
        for mb in micro:
            with torch.no_grad():
                idx_gt = self._idx_gt(mb)
            total, m = self._losses(mb, idx_gt)
            (total / n).backward()
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() / n
        lr = self.schedule_g(self.step)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        ema_update(self.params_ema, self.net_g.state_dict(), self.ema_decay)
        self.step += 1
        self._set_log(metrics)
