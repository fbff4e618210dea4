"""Stage trainers (counterpart of codeformer_tpu/train/trainers.py).

  - stage I, `VQGANModel` (reference vqgan_model.py): the VQGAN
    autoencoder against a PatchGAN discriminator, with the pixel,
    perceptual (LPIPS) and codebook losses and the adaptive GAN weight;
    its VectorQuantizer runs the nearest-code search K3 (ops/vq.py);
  - stage II, `CodeFormerIdxModel` (codeformer_idx_model.py): a frozen HQ
    VQGAN encodes the ground truth and K3 turns its latents into the
    target codes `idx_gt`; CodeFormer's encoder and transformer learn
    them with a latent-feature L2 loss and a token cross-entropy;
  - stage III, `CodeFormerJointModel` and `CodeFormerModel`
    (codeformer_joint_model.py, codeformer_model.py): the code losses of
    stage II plus the image losses of stage I through the SFT fusion,
    with the same discriminator.

Semantics kept from the JAX trainers:
  - `mixed_precision: bf16`: activations in bf16, parameters, losses,
    the adaptive weight, optimizer state and EMA in fp32 (the port's
    Conv2d/Linear cast fp32 parameters on use, as flax's `dtype=`; no
    torch.autocast, which keeps other ops in fp32 than flax does);
  - `accum_steps`: sequential microbatches, interleaved as JAX's
    `_split_microbatches` (microbatch i = batch[i::n]), grads averaged;
    the adaptive GAN weight comes from the accumulated anchor gradients
    and the discriminator's BatchNorm statistics chain across the
    microbatches;
  - `fix_modules` frozen with requires_grad False and kept out of the
    optimizer (JAX `_split_params`), EMA over every parameter; every
    trainable parameter steps each update, with a zero gradient where its
    loss does not reach it, as optax updates the whole trainable tree;
  - the generator-side GAN term reads the discriminator in eval mode
    (its running statistics; JAX passes train=False) and gives the
    discriminator no gradient; the discriminator steps only past
    `net_d_start_iter`, and before that its parameters, Adam state and
    BatchNorm statistics stay as they were (JAX's lax.cond);
  - the decoupled weight decay of the optax chain (train/optimizers.py)
    and the 0-based schedule step (train/schedulers.py), counted per
    optimizer;
  - `remat: true`: the networks' ResBlocks (and the perceptual loss as a
    whole) keep only their inputs for the backward and recompute the
    rest there (torch.utils.checkpoint, JAX's nn.remat/jax.checkpoint);
    the gradients are the same;
  - data parallelism (JAX's mesh step): under an initialised process
    group (parallel/, `--launcher pytorch`) each process steps on its
    share of the global batch, and the gradients (the adaptive weight's
    anchor probes included), the discriminator's BatchNorm statistics
    and the logged losses are averaged over the processes, so the step
    equals one process's step on the whole batch. No DDP wrapper: it
    would not reduce the probes' torch.autograd.grad gradients;
  - validation (`val:` with `val_freq`): the EMA weights (net_g's when
    ema_decay is 0) in eval mode on the val set, PSNR/SSIM by the
    metric registry (metrics/), on the trainer's device.

K1/K2 are forward-only: `net_g` always runs its textbook blocks, so
autograd records every conv; the frozen HQ VQGAN, run under no_grad,
takes the kernels when the activations are bf16 (the kernels take bf16
only) and the textbook blocks at fp32.
"""
from __future__ import annotations

import inspect
import logging
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from codeformer_tpu_torch import models  # noqa: F401  (registers the archs)
from codeformer_tpu_torch import parallel
from codeformer_tpu_torch.nn.blocks import records, set_kernels
from codeformer_tpu_torch.ops import vq
from codeformer_tpu_torch.utils.checkpoint import init_params_fast
from codeformer_tpu_torch.utils.convert import load_pth
from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY, MODEL_REGISTRY
from .ema import ema_update
from .losses import (charbonnier_loss, cross_entropy_loss, gan_loss, l1_loss,
                     mse_loss)
from .optimizers import build_optimizer
from .schedulers import build_schedule

logger = logging.getLogger('codeformer_tpu_torch')

# reference fix_modules names of CodeFormer's token path: 'transformer'
# freezes all of them (JAX _expand_fix_keys, codeformer_joint_model.py:181)
TRANSFORMER_MODULES = ('ft_layers', 'feat_emb', 'position_emb',
                       'idx_pred_layer')


def build_model(opt: Dict):
    """Trainer for `opt['model_type']` (basicsr/models/__init__.py:19-30);
    an unknown type raises KeyError, naming the registered ones."""
    return MODEL_REGISTRY.get(opt['model_type'])(opt)


def build_network(net_opt: Dict, remat: bool = False) -> torch.nn.Module:
    """An arch from its config block (`type:` plus constructor keys).
    `remat` reaches the archs whose constructor takes it (VQAutoEncoder,
    CodeFormer; not the discriminator), unless the block sets it, as
    JAX's BaseTrainer._net injects it."""
    net_opt = dict(net_opt)
    cls = ARCH_REGISTRY.get(net_opt.pop('type'))
    if remat and 'remat' in inspect.signature(cls).parameters:
        net_opt.setdefault('remat', True)
    return cls(**net_opt)


def freeze_modules(net: torch.nn.Module, fix_modules) -> list:
    """requires_grad False on the parameters of the named top-level
    modules (every shipped config: quantize and generator; 'transformer'
    names the token path). Returns the frozen parameter names."""
    tops = set(fix_modules)
    if 'transformer' in tops:
        tops |= set(TRANSFORMER_MODULES)
    frozen = []
    for name, p in net.named_parameters():
        if name.split('.')[0] in tops:
            p.requires_grad_(False)
            frozen.append(name)
    return frozen


def _l2norm(x: torch.Tensor) -> torch.Tensor:
    return x.float().pow(2).sum().sqrt()


class BaseTrainer:
    """Options, device placement, optimizer steps, EMA, checkpoint IO,
    logging, and the GAN pieces stages I and III share. Subclasses define
    `_build()` (networks, optimizers, schedules) and
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
        # remat: activation rematerialization (JAX trainers.py:151-158)
        self.remat = bool(self.train_opt.get('remat', False))
        self.device = torch.device(opt.get('device') or 'cuda')
        if self.device.type == 'cuda' and not torch.cuda.is_available():
            raise RuntimeError(
                f"device {self.device}: no CUDA device is available; the "
                f"trainer does not fall back to the CPU (set `device: cpu` "
                f"in the options to train on the host)")
        # data parallelism: one process a device, set up by the launcher
        self.rank, self.world_size = parallel.get_dist_info()
        self.data_parallel = parallel.initialized()
        if self.data_parallel:
            logger.info(f'data parallel: rank {self.rank} of '
                        f'{self.world_size} ({parallel.backend()}) on '
                        f'{self.device}')
        elif int(opt.get('num_devices') or 1) > 1:
            logger.info(f'num_devices {opt["num_devices"]}: this process '
                        f'trains on {self.device} alone; for data '
                        f'parallelism start one process a device (torchrun '
                        f'--nproc_per_node N ... --launcher pytorch)')
        self.step = 0            # optimizer_g updates so far (its lr step)
        self.step_d = 0          # optimizer_d updates so far
        self.net_d = None
        self._log_metrics: Dict[str, torch.Tensor] = {}
        self._log_cache: Optional[Dict[str, float]] = None
        self._build()
        unknown = set(self.train_opt) - self.KNOWN_TRAIN_KEYS
        if unknown:
            logger.warning(f'train: keys IGNORED by {type(self).__name__}: '
                           f'{sorted(unknown)} -- check for typos or '
                           f'unsupported options')

    def _seed(self) -> int:
        return int(self.opt.get('manual_seed') or 0)

    def _net(self, net_opt: Dict, seed: int) -> torch.nn.Module:
        """build_network with the trainer's remat, seeded init."""
        return init_params_fast(build_network(net_opt, self.remat), seed)

    def _finish_g(self, fix_modules=()) -> None:
        """net_g on the device in its textbook form, `fix_modules` frozen,
        the AdamW of optim_g over the rest, its schedule and the EMA."""
        self.net_g.to(self.device)
        set_kernels(self.net_g, False)
        logger.info('net_g: textbook blocks (autograd records every conv; '
                    'K1/K2 are forward-only)'
                    + ('; remat: ResBlocks recompute in the backward'
                       if self.remat else ''))
        self.frozen = freeze_modules(self.net_g, fix_modules)
        self.params_g = [p for p in self.net_g.parameters()
                         if p.requires_grad]
        self.schedule_g = build_schedule(self.train_opt,
                                         self.train_opt['optim_g']['lr'])
        self.optimizer = build_optimizer(self.train_opt['optim_g'],
                                         self.params_g)
        self.reset_ema()

    # ------------------------------------------------ optimizer steps
    def _step_g(self) -> None:
        """One optimizer_g update at the scheduled lr. A trainable tensor
        its loss did not reach gets a zero gradient, so Adam's moments,
        its count and the weight decay move it as optax moves the whole
        trainable tree."""
        for p in self.params_g:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._mean_over_processes([p.grad for p in self.params_g])
        lr = self.schedule_g(self.step)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        self.step += 1

    def _ema(self) -> None:
        ema_update(self.params_ema, self.net_g.state_dict(), self.ema_decay)

    def _mean_over_processes(self, tensors: List[torch.Tensor]) -> None:
        """Average `tensors` in place over the data-parallel processes (one
        flattened all-reduce); nothing without a process group."""
        if self.data_parallel:
            parallel.all_reduce_mean(tensors)

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
        reference read), net_d as {params} (its BatchNorm statistics
        included), plus a `.state` file with the optimizer states (the
        reference two-file scheme, base_model.py:170-280). Under data
        parallelism only rank 0 writes (every rank holds the same state)."""
        if self.rank != 0:
            return
        os.makedirs(self.opt['path']['models'], exist_ok=True)
        state_dir = self.opt['path']['training_states']
        os.makedirs(state_dir, exist_ok=True)
        torch.save({'params': self.net_g.state_dict(),
                    'params_ema': self.params_ema},
                   self._net_path('g', current_iter))
        state = {'optimizer_g': self.optimizer.state_dict(),
                 'step': self.step, 'epoch': epoch, 'iter': current_iter}
        if self.net_d is not None:
            torch.save({'params': self.net_d.state_dict()},
                       self._net_path('d', current_iter))
            state.update(optimizer_d=self.optimizer_d.state_dict(),
                         step_d=self.step_d)
        tag = 'latest' if current_iter == -1 else current_iter
        torch.save(state, osp.join(state_dir, f'{tag}.state'))

    def resume_training(self, state_path: str):
        """Restore net_g, its EMA, the optimizers, the steps and net_d
        from a `.state` file and its network files. Returns (epoch,
        iter)."""
        blob = torch.load(state_path, map_location='cpu', weights_only=True)
        it = int(blob['iter'])
        g = torch.load(self._net_path('g', it), map_location=self.device,
                       weights_only=True)
        self.net_g.load_state_dict(g['params'])
        for k, v in self.params_ema.items():
            v.copy_(g['params_ema'][k])
        self.optimizer.load_state_dict(blob['optimizer_g'])
        self.step = int(blob['step'])
        if self.net_d is not None:
            d = torch.load(self._net_path('d', it), map_location=self.device,
                           weights_only=True)
            self.net_d.load_state_dict(d['params'])
            self.optimizer_d.load_state_dict(blob['optimizer_d'])
            self.step_d = int(blob['step_d'])
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
        """A loader batch as it comes (NHWC float32 arrays under 'in',
        'gt' and 'in_large_de', lists of paths, optional 'latent_gt') ->
        device tensors, images as NCHW in channels_last memory (a free
        permute of NHWC)."""
        batch = {}
        for k, v in data.items():
            if isinstance(v, list):
                continue
            t = torch.as_tensor(v).to(self.device, non_blocking=True)
            # a DevicePrefetcher's batch is on the device already: no copy
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
        one transfer when read. Under data parallelism they are averaged
        over the processes first (one all-reduce a step)."""
        if self.data_parallel and metrics:
            names = list(metrics)
            vals = torch.stack([torch.as_tensor(metrics[k], device=self.device)
                                .float().reshape(()) for k in names])
            self._mean_over_processes([vals])
            metrics = dict(zip(names, vals.unbind()))
        self._log_metrics = metrics
        self._log_cache = None

    @property
    def log_dict(self) -> Dict[str, float]:
        if self._log_cache is None:
            names = list(self._log_metrics)
            vals = torch.stack([torch.as_tensor(self._log_metrics[k])
                                .float().reshape(())
                                for k in names]).tolist() if names else []
            self._log_cache = dict(zip(names, vals))
        return self._log_cache

    def get_current_log(self) -> Dict[str, float]:
        return dict(self.log_dict)

    def get_current_learning_rate(self):
        return [self.schedule_g(self.step)]

    # ---------------------------------------------------- validation
    @torch.no_grad()
    def test(self, lq: torch.Tensor, w: float = 1.0) -> torch.Tensor:
        """The restored batch of `lq` (NCHW on the device): net_g in eval
        mode on the EMA weights when ema_decay > 0, else on its own
        (sr_model.py:120-129, codeformer_model.py:250-260; JAX
        trainers.py:459-473), through torch.func.functional_call, so the
        EMA state dict is read in place, not copied into a network. The
        blocks are those net_g trains with (no kernels), the output fp32."""
        net = self.net_g
        args = (lq.to(self.compute_dtype),)
        if 'w' in inspect.signature(net.forward).parameters:
            args += (w,)
        was_training = net.training
        net.eval()
        try:
            if self.ema_decay > 0:
                out = torch.func.functional_call(net, self.params_ema, args)
            else:
                out = net(*args)
        finally:
            net.train(was_training)
        out = out[0] if isinstance(out, tuple) else out
        return out.float()

    def validation(self, dataloader, current_iter: int, tb_logger=None,
                   save_img: bool = False) -> Dict[str, float]:
        """PSNR/SSIM validation with per-image dumps (sr_model.py:135-194;
        JAX trainers.py:475-530): every image of every batch, the metrics
        of `val: metrics:` on the trainer's device (metrics/ computes in
        float64 where its inputs lie), their means logged and, with a tb
        logger, written as `metrics/<name>`. Training runs save
        visualization/<img>/<img>_<iter>.png, test runs
        visualization/<img>_<suffix>.png (cv2, imported here). Returns
        {metric name: mean}."""
        from codeformer_tpu_torch.metrics import calculate_metric
        from codeformer_tpu_torch.utils.img_util import tensor_to_imgs

        val_opt = self.opt.get('val') or {}
        metrics_opt = val_opt.get('metrics') or {}
        results: Dict[str, list] = {k: [] for k in metrics_opt}
        w = float(getattr(self, 'fidelity_weight', 1.0))
        for idx, batch in enumerate(dataloader):
            lq = batch['lq'] if 'lq' in batch else batch['in']
            lq = torch.as_tensor(lq).to(self.device).permute(0, 3, 1, 2)
            paths = (batch.get('lq_path') or batch.get('gt_path')
                     or [f'{idx:08d}_{j}' for j in range(lq.shape[0])])
            sr_imgs = tensor_to_imgs(self.test(lq, w=w).permute(0, 2, 3, 1))
            gt_imgs = (tensor_to_imgs(torch.as_tensor(batch['gt'])
                                      .to(self.device))
                       if 'gt' in batch else None)
            for j, sr_img in enumerate(sr_imgs):
                img_name = osp.splitext(osp.basename(
                    paths[min(j, len(paths) - 1)]))[0]
                if save_img:
                    self._save_val_img(sr_img, img_name, current_iter,
                                       val_opt)
                if gt_imgs is not None:
                    for name, m_opt in metrics_opt.items():
                        results[name].append(calculate_metric(
                            {'img': sr_img, 'img2': gt_imgs[j]}, m_opt))
        out = {}
        for name, vals in results.items():
            if not vals:
                continue
            out[name] = float(np.mean(vals))
            logger.info(f'Validation {name}: {out[name]:.4f} '
                        f'@ iter {current_iter}')
            if tb_logger is not None:
                tb_logger.add_scalar(f'metrics/{name}', out[name],
                                     current_iter)
        return out

    def _save_val_img(self, img: torch.Tensor, img_name: str,
                      current_iter: int, val_opt: Dict) -> None:
        import cv2
        if self.opt.get('is_train'):
            save_path = osp.join(self.opt['path']['visualization'], img_name,
                                 f'{img_name}_{current_iter}.png')
        else:
            suffix = val_opt.get('suffix') or self.opt['name']
            save_path = osp.join(self.opt['path']['visualization'],
                                 f'{img_name}_{suffix}.png')
        os.makedirs(osp.dirname(save_path), exist_ok=True)
        cv2.imwrite(save_path, img.cpu().numpy())

    # ------------------------------------- GAN pieces (stages I, III)
    def _setup_pixel(self) -> None:
        """cri_pix from train: pixel_opt (sr_model.py:35-40)."""
        pix = dict(self.train_opt.get('pixel_opt')
                   or {'type': 'L1Loss', 'loss_weight': 1.0})
        self.pixel_weight = pix.get('loss_weight', 1.0)
        self.pixel_type = pix.get('type', 'L1Loss')

    def _pixel_loss(self, out, gt):
        loss = {'MSELoss': mse_loss, 'CharbonnierLoss': charbonnier_loss}.get(
            self.pixel_type, l1_loss)
        return loss(out, gt, loss_weight=self.pixel_weight)

    def _setup_gan(self) -> None:
        """cri_gan from train: gan_opt, its type and generator-side
        loss_weight (losses.py:285-387)."""
        gan = dict(self.train_opt.get('gan_opt')
                   or {'gan_type': 'hinge', 'loss_weight': 1.0})
        self.gan_type = gan.get('gan_type', 'hinge')
        self.gan_weight = float(gan.get('loss_weight', 1.0))

    def _gan_loss(self, pred, target_is_real: bool, is_disc: bool):
        return gan_loss(pred, target_is_real, self.gan_type, is_disc=is_disc,
                        loss_weight=self.gan_weight)

    def _build_perceptual(self) -> None:
        """cri_perceptual from train: perceptual_opt (None if absent), on
        the device, its VGG in the compute dtype. Under remat
        `_perceptual_loss` recomputes it whole in the backward."""
        self.cri_perceptual = None
        if 'perceptual_opt' in self.train_opt:
            from .perceptual import build_perceptual_loss
            self.cri_perceptual = build_perceptual_loss(
                self.train_opt['perceptual_opt'], dtype=self.compute_dtype
            ).to(self.device)

    def _perceptual_loss(self, out: torch.Tensor,
                         gt: torch.Tensor) -> torch.Tensor:
        """cri_perceptual(out, gt); under remat the backward keeps only
        (out, gt) and re-runs the VGG taps (JAX trainers.py:193-209)."""
        if self.remat and records(self.cri_perceptual, out, gt):
            return checkpoint(self.cri_perceptual, out, gt,
                              use_reentrant=False)
        return self.cri_perceptual(out, gt)

    def _build_discriminator(self, default: Dict) -> None:
        """net_d (network_d, else `default`; pretrain_network_d if set),
        the AdamW of optim_d and its schedule."""
        self.net_d = self._net(self.opt.get('network_d') or default,
                               self._seed() + 2)
        pre = self._load_pretrain('pretrain_network_d')
        if pre is not None:
            self.net_d.load_state_dict(pre)
        self.net_d.to(self.device)
        if self.data_parallel:   # BatchNorm over the global batch
            for m in self.net_d.modules():
                if hasattr(m, 'sync_stats'):
                    m.sync_stats = True
        self.schedule_d = build_schedule(self.train_opt,
                                         self.train_opt['optim_d']['lr'])
        self.optimizer_d = build_optimizer(self.train_opt['optim_d'],
                                           self.net_d.parameters())
        self.net_d_start_iter = int(self.train_opt.get('net_d_start_iter',
                                                       0))
        self.net_d_iters = int(self.train_opt.get('net_d_iters', 1))
        self.net_g_start_iter = int(self.train_opt.get('net_g_start_iter',
                                                       0))

    def _g_step_on(self, current_iter: int) -> bool:
        """Whole-g-step gate (vqgan_model.py:135): current_iter %
        net_d_iters == 0 and current_iter > net_g_start_iter."""
        return (current_iter % self.net_d_iters == 0
                and current_iter > self.net_g_start_iter)

    def _g_gan_loss(self, out: torch.Tensor) -> torch.Tensor:
        """The generator-side GAN loss of `out`: net_d in eval mode (its
        running statistics, JAX train=False) and without parameter
        gradients."""
        self.net_d.eval().requires_grad_(False)
        return self._gan_loss(self.net_d(out.to(self.compute_dtype)), True,
                              is_disc=False)

    def _adaptive_g_step(self, micro: List[Dict], forward, anchor, scale,
                         gan_on: bool):
        """The generator update of a GAN step (vqgan_model.py:85-96):
        `forward(mb)` -> (main, l_gan, out, metrics) for one microbatch.
        d_weight = |d main/d anchor| / (|d l_gan/d anchor| + 1e-4),
        clipped to [0, 1], times `scale`; the update descends main +
        d_weight * gan_on * l_gan. One microbatch: two anchor probes on
        the retained graph and one backward. Several: the two gradients
        of each microbatch, averaged, d_weight from the averaged anchor
        gradients (JAX trainers.py:760-769). Returns (the detached
        outputs, the averaged metrics with d_weight, l_g_gan = d_weight *
        gan_on * l_gan and l_g_total = main + l_g_gan)."""
        n = len(micro)
        self.optimizer.zero_grad(set_to_none=True)
        outs, metrics = [], {}

        def add(m):
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() / n
        if n == 1:
            main, l_gan, out, m = forward(micro[0])
            (g_main,) = torch.autograd.grad(main, anchor, retain_graph=True)
            (g_gan,) = torch.autograd.grad(l_gan, anchor, retain_graph=True)
            self._mean_over_processes([g_main, g_gan])
            d_weight = self._d_weight(g_main, g_gan, scale)
            (main + d_weight * l_gan if gan_on else main).backward()
            outs.append(out.detach())
            add(dict(m, _main=main, _l_gan=l_gan))
        else:
            params = self.params_g
            acc_main = [torch.zeros_like(p) for p in params]
            acc_gan = [torch.zeros_like(p) for p in params]
            for mb in micro:
                main, l_gan, out, m = forward(mb)
                for acc, loss, keep in ((acc_main, main, True),
                                        (acc_gan, l_gan, False)):
                    grads = torch.autograd.grad(loss, params,
                                                retain_graph=keep,
                                                allow_unused=True)
                    for a, g in zip(acc, grads):
                        if g is not None:
                            a.add_(g, alpha=1.0 / n)
                outs.append(out.detach())
                add(dict(m, _main=main, _l_gan=l_gan))
            k = next(i for i, p in enumerate(params) if p is anchor)
            probes = [acc_main[k].clone(), acc_gan[k].clone()]
            self._mean_over_processes(probes)
            d_weight = self._d_weight(*probes, scale)
            for p, a, g in zip(params, acc_main, acc_gan):
                p.grad = a + d_weight * g if gan_on else a
        self._step_g()
        main, l_gan = metrics.pop('_main'), metrics.pop('_l_gan')
        l_g_gan = d_weight * l_gan if gan_on else torch.zeros_like(l_gan)
        metrics.update(d_weight=d_weight, l_g_gan=l_g_gan,
                       l_g_total=main + l_g_gan)
        return outs, metrics

    @staticmethod
    def _d_weight(g_main, g_gan, scale) -> torch.Tensor:
        d_weight = _l2norm(g_main) / (_l2norm(g_gan) + 1e-4)
        return d_weight.clamp(0.0, 1.0).detach() * scale

    def _d_step(self, reals: List[torch.Tensor], fakes: List[torch.Tensor],
                current_iter: int) -> Dict[str, torch.Tensor]:
        """The discriminator step (vqgan_model.py:167-184): per
        microbatch, net_d in train mode on the real images, then on the
        detached fakes (the BatchNorm statistics chain through both and
        across microbatches), hinge losses, gradients averaged. Past
        net_d_start_iter one optimizer_d update; before it the losses are
        only computed and logged, and the running statistics are put back
        as they were. Returns the averaged d metrics."""
        gan_on = current_iter > self.net_d_start_iter
        net_d = self.net_d.train().requires_grad_(True)
        kept = None if gan_on else [b.clone() for b in net_d.buffers()]
        self.optimizer_d.zero_grad(set_to_none=True)
        n = len(reals)
        metrics: Dict[str, torch.Tensor] = {}
        with torch.set_grad_enabled(gan_on):
            for real, fake in zip(reals, fakes):
                real_pred = net_d(real.to(self.compute_dtype))
                fake_pred = net_d(fake.to(self.compute_dtype))
                l_real = self._gan_loss(real_pred, True, is_disc=True)
                l_fake = self._gan_loss(fake_pred, False, is_disc=True)
                if gan_on:
                    ((l_real + l_fake) / n).backward()
                for k, v in (('l_d_real', l_real), ('l_d_fake', l_fake),
                             ('out_d_real', real_pred.float().mean()),
                             ('out_d_fake', fake_pred.float().mean())):
                    metrics[k] = metrics.get(k, 0.0) + v.detach() / n
        if gan_on:
            self._mean_over_processes([p.grad for p in net_d.parameters()
                                       if p.grad is not None])
            lr = self.schedule_d(self.step_d)
            for group in self.optimizer_d.param_groups:
                group['lr'] = lr
            self.optimizer_d.step()
            self.step_d += 1
        else:
            with torch.no_grad():
                for b, v in zip(net_d.buffers(), kept):
                    b.copy_(v)
        return metrics


@MODEL_REGISTRY.register()
class SRModel(BaseTrainer):
    """Generic supervised SR trainer (basicsr/models/sr_model.py; JAX
    trainers.py:541-611): net_g on batch['lq'] with the pixel (+
    perceptual) losses against batch['gt'], one AdamW, the EMA at
    ema_decay (0.999 when unset, as JAX), PSNR/SSIM validation."""

    KNOWN_TRAIN_KEYS = BaseTrainer.KNOWN_TRAIN_KEYS | {
        'pixel_opt', 'perceptual_opt'}

    def _build(self):
        self.net_g = self._net(self.opt['network_g'], self._seed())
        pre = self._load_pretrain('pretrain_network_g')
        if pre is not None:
            self.net_g.load_state_dict(pre)
        self._build_perceptual()
        self._setup_pixel()
        self._finish_g()

    def _ema(self) -> None:
        ema_update(self.params_ema, self.net_g.state_dict(),
                   self.ema_decay or 0.999)

    def optimize_parameters(self, current_iter: int) -> None:
        micro = self._microbatches()
        n = len(micro)
        self.optimizer.zero_grad(set_to_none=True)
        metrics: Dict[str, torch.Tensor] = {}
        for mb in micro:
            out = self.net_g(mb['lq'].to(self.compute_dtype))
            out = out[0] if isinstance(out, tuple) else out
            l_pix = self._pixel_loss(out, mb['gt'])
            m = {'l_pix': l_pix}
            total = l_pix
            if self.cri_perceptual is not None:
                l_percep = self._perceptual_loss(out, mb['gt'])
                total = total + l_percep
                m['l_percep'] = l_percep
            m['l_total'] = total
            (total / n).backward()
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() / n
        self._step_g()
        self._ema()
        self._set_log(metrics)


class _CodeFormerTrainer(BaseTrainer):
    """What stages II and III share: CodeFormer as net_g with its
    pretrained VQGAN parts, the frozen HQ VQGAN that encodes the ground
    truth, `idx_gt` through K3, and the code losses."""

    def _build_codeformer(self) -> None:
        opt = self.opt
        net_opt = dict(opt['network_g'])
        self.fix_modules = tuple(net_opt.pop('fix_modules',
                                             ('quantize', 'generator')))
        vqgan_path = net_opt.pop('vqgan_path', None)
        seed = self._seed()
        self.net_g = self._net(net_opt, seed)

        self.hq_feat_loss = self.train_opt.get('use_hq_feat_loss', True)
        self.feat_loss_weight = self.train_opt.get('feat_loss_weight', 1.0)
        self.use_ce = self.train_opt.get('cross_entropy_loss', True)
        self.ce_weight = self.train_opt.get('entropy_loss_weight', 0.5)

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
            self.hq_vqgan = self._net(opt['network_vqgan'], seed + 1)
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
        self.code_losses_on = True
        self._finish_g(self.fix_modules)

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

    def _code_losses(self, logits, lq_feat, idx_gt):
        """The latent-feature L2 against net_g's own codebook at idx_gt
        (JAX trainers.py:991) and the token cross-entropy; (0, {}) when
        the code losses are off."""
        total = 0.0
        metrics = {}
        if not self.code_losses_on:
            return total, metrics
        b, d, h, w = lq_feat.shape
        if self.hq_feat_loss:
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
        return total, metrics

    def _code_step(self, input_key: str) -> Dict[str, torch.Tensor]:
        """A code-only update (w = 0, code_only forward on
        batch[input_key]): the code losses, one optimizer_g step."""
        micro = self._microbatches()
        n = len(micro)
        self.optimizer.zero_grad(set_to_none=True)
        metrics: Dict[str, torch.Tensor] = {}
        for mb in micro:
            with torch.no_grad():
                idx_gt = self._idx_gt(mb)
            logits, lq_feat = self.net_g(mb[input_key].to(self.compute_dtype),
                                         0.0, code_only=True)
            total, m = self._code_losses(logits, lq_feat, idx_gt)
            if torch.is_tensor(total):
                (total / n).backward()
            else:                 # code losses off: a zero-gradient step
                total = torch.zeros((), device=self.device)
            m['l_g_total'] = total
            for k, v in m.items():
                metrics[k] = metrics.get(k, 0.0) + v.detach() / n
        self._step_g()
        return metrics


@MODEL_REGISTRY.register()
class CodeFormerIdxModel(_CodeFormerTrainer):
    """Stage II: code-sequence prediction (codeformer_idx_model.py; JAX
    trainers.py:889-1042): w = 0, code_only; L2 between the HQ codes'
    features (net_g's own codebook) and lq_feat, plus cross-entropy on
    the code indices; quantize and generator frozen."""

    KNOWN_TRAIN_KEYS = BaseTrainer.KNOWN_TRAIN_KEYS | {
        'use_hq_feat_loss', 'feat_loss_weight', 'cross_entropy_loss',
        'entropy_loss_weight', 'fidelity_weight'}

    def _build(self):
        self._build_codeformer()
        if not (self.hq_feat_loss or self.use_ce):
            raise ValueError('stage II needs use_hq_feat_loss or '
                             'cross_entropy_loss')

    def optimize_parameters(self, current_iter: int) -> None:
        metrics = self._code_step('in')
        self._ema()
        self._set_log(metrics)


@MODEL_REGISTRY.register()
class VQGANModel(BaseTrainer):
    """Stage I: VQGAN GAN training (vqgan_model.py; JAX trainers.py:
    614-887). g-step: pixel + perceptual + codebook loss plus the
    adaptive-weighted GAN loss, gated by net_d_iters/net_g_start_iter;
    d-step: real/fake hinge, stepping past net_d_start_iter; EMA always.
    The Gumbel quantizer anneals its temperature as max(1/16, 1 -
    iter/160000) and draws its noise from a generator seeded with
    (manual_seed, current_iter)."""

    KNOWN_TRAIN_KEYS = BaseTrainer.KNOWN_TRAIN_KEYS | {
        'pixel_opt', 'perceptual_opt', 'gan_opt', 'codebook_loss_weight',
        'disc_weight', 'net_d_iters', 'net_d_start_iter',
        'net_g_start_iter'}

    def _build(self):
        seed = self._seed()
        self.net_g = self._net(self.opt['network_g'], seed)
        pre = self._load_pretrain('pretrain_network_g')
        if pre is not None:
            self.net_g.load_state_dict(pre)
        self.gumbel = self.opt['network_g'].get('quantizer') == 'gumbel'
        self.l_weight_codebook = self.train_opt.get('codebook_loss_weight',
                                                    1.0)
        self.disc_weight = self.train_opt.get('disc_weight', 0.8)
        self._setup_pixel()
        self._setup_gan()
        self._build_perceptual()
        self._build_discriminator({'type': 'VQGANDiscriminator', 'nc': 3,
                                   'ndf': 64})
        self._finish_g()
        # the adaptive weight's anchor: the generator's last conv
        # (vqgan_model.py:155, generator.blocks[-1].weight)
        self.anchor = self.net_g.generator.blocks[-1].weight

    def _g_forward(self, gt: torch.Tensor, current_iter: int):
        """One generator forward (the VQ round trip): (out, codebook loss,
        perplexity)."""
        x = gt.to(self.compute_dtype)
        if not self.gumbel:
            out, l_codebook, stats = self.net_g(x)
            return out, l_codebook, stats['perplexity']
        gen = torch.Generator(device=self.device).manual_seed(
            (self._seed() << 32) + current_iter)
        out, l_codebook, _ = self.net_g(
            x, temperature=max(1.0 / 16, 1.0 - current_iter / 160000),
            generator=gen)
        return out, l_codebook, torch.zeros((), device=self.device)

    def optimize_parameters(self, current_iter: int) -> None:
        if not self._g_step_on(current_iter):
            # the reference skips the whole g block: no g losses, no
            # backward, no optimizer_g step; the forward still feeds the
            # d step (over the whole batch, as JAX's d-only step), and
            # the EMA runs (vqgan_model.py:135-190)
            gt = self.batch['gt']
            with torch.no_grad():
                out = self._g_forward(gt, current_iter)[0]
            metrics = self._d_step([gt], [out], current_iter)
            self._ema()
            self._set_log(metrics)
            return
        micro = self._microbatches()

        def forward(mb):
            gt = mb['gt']
            out, l_codebook, perplexity = self._g_forward(gt, current_iter)
            l_codebook = l_codebook * self.l_weight_codebook
            l_pix = self._pixel_loss(out, gt)
            m = {'l_g_pix': l_pix, 'l_codebook': l_codebook,
                 'perplexity': perplexity}
            recon = l_pix
            if self.cri_perceptual is not None:
                l_percep = self._perceptual_loss(out, gt)
                recon = recon + l_percep
                m['l_g_percep'] = l_percep
            return recon + l_codebook, self._g_gan_loss(out), out, m

        outs, metrics = self._adaptive_g_step(
            micro, forward, self.anchor, self.disc_weight,
            current_iter > self.net_d_start_iter)
        metrics.update(self._d_step([mb['gt'] for mb in micro], outs,
                                    current_iter))
        self._ema()
        self._set_log(metrics)


@MODEL_REGISTRY.register()
class CodeFormerJointModel(_CodeFormerTrainer):
    """Stage III, the shipped config (codeformer_joint_model.py; JAX
    trainers.py:1046-1514): the joint schedule alternates the small and
    the large degradation (`_phase`). A small-degradation iteration takes
    the full step (code losses, image losses and the adaptive GAN term
    through the SFT fusion, then the d step); a large-degradation one the
    code step (code losses on `in_large_de`, no image loss, no d step).
    net_d_iters/net_g_start_iter gate the generator update: a gated
    small iteration runs the forward and the d step only, a gated large
    one the EMA only. The adaptive weight's anchor is the largest fuse
    block's last shift conv when the generator is frozen, else the
    generator's last conv."""

    KNOWN_TRAIN_KEYS = BaseTrainer.KNOWN_TRAIN_KEYS | {
        'use_hq_feat_loss', 'feat_loss_weight', 'cross_entropy_loss',
        'entropy_loss_weight', 'scale_adaptive_gan_weight', 'pixel_opt',
        'perceptual_opt', 'gan_opt', 'net_d_iters', 'net_d_start_iter',
        'net_g_start_iter', 'fidelity_weight'}

    def _build(self):
        self._build_codeformer()
        # the reference gates the code losses off when the transformer
        # itself is frozen (codeformer_joint_model.py:181)
        self.code_losses_on = 'transformer' not in self.fix_modules
        self.scale_adaptive_gan_weight = self.train_opt.get(
            'scale_adaptive_gan_weight', 0.8)
        self._setup_pixel()
        self._setup_gan()
        self._build_perceptual()
        self._build_discriminator({'type': 'VQGANDiscriminator'})
        net = self.net_g
        if 'generator' in self.fix_modules:
            largest = str(max(int(s) for s in net.connect_list))
            self.anchor = net.fuse_convs_dict[largest].shift[-1].weight
        else:
            self.anchor = net.generator.blocks[-1].weight

    @staticmethod
    def _phase(current_iter: int):
        """(w, small_per_n) schedule (codeformer_joint_model.py:153-164)."""
        if current_iter <= 40000:
            return 1.0, 1
        if current_iter <= 80000:
            return 1.3, 1
        if current_iter <= 120000:
            return 0.0, 120000
        return 1.3, 15

    def _full_step(self, w: float, current_iter: int):
        """Code losses + image losses + the adaptive GAN term, one
        optimizer_g update, then the d step."""
        micro = self._microbatches()

        def forward(mb):
            with torch.no_grad():
                idx_gt = self._idx_gt(mb)
            out, logits, lq_feat = self.net_g(mb['in'].to(self.compute_dtype),
                                              w, detach_16=True)
            code_total, m = self._code_losses(logits, lq_feat, idx_gt)
            l_pix = self._pixel_loss(out, mb['gt'])
            m['l_g_pix'] = l_pix
            recon = l_pix
            if self.cri_perceptual is not None:
                l_percep = self._perceptual_loss(out, mb['gt'])
                recon = recon + l_percep
                m['l_g_percep'] = l_percep
            return code_total + recon, self._g_gan_loss(out), out, m

        outs, metrics = self._adaptive_g_step(
            micro, forward, self.anchor, self.scale_adaptive_gan_weight,
            current_iter > self.net_d_start_iter)
        metrics.update(self._d_step([mb['gt'] for mb in micro], outs,
                                    current_iter))
        return metrics

    def _d_only_step(self, w: float, current_iter: int):
        """A gated small-degradation iteration: the forward feeds the d
        step, over the whole batch as in JAX; no generator update
        (codeformer_joint_model.py:179, 227-250)."""
        with torch.no_grad():
            out = self.net_g(self.batch['in'].to(self.compute_dtype), w,
                             detach_16=True)[0]
        return self._d_step([self.batch['gt']], [out], current_iter)

    def optimize_parameters(self, current_iter: int) -> None:
        w, small_per_n = self._phase(current_iter)
        g_on = self._g_step_on(current_iter)
        if current_iter % small_per_n == 0:
            metrics = (self._full_step(w, current_iter) if g_on
                       else self._d_only_step(w, current_iter))
        else:
            # large degradation: the code step, or (gated) the EMA only
            metrics = self._code_step('in_large_de') if g_on else {}
        self._ema()
        self._set_log(metrics)


@MODEL_REGISTRY.register()
class CodeFormerModel(CodeFormerJointModel):
    """Stage III, the single-degradation variant of the inpainting config
    (codeformer_model.py; JAX trainers.py:1517-1553): the joint model's
    steps at a fixed `fidelity_weight` on 'in', the code losses always
    on. fidelity_weight <= 0 takes the code step on 'in' (no image
    losses, no d step)."""

    def _build(self):
        super()._build()
        self.code_losses_on = True
        self.fidelity_weight = float(self.train_opt.get('fidelity_weight',
                                                        1.0))

    def optimize_parameters(self, current_iter: int) -> None:
        g_on = self._g_step_on(current_iter)
        if self.fidelity_weight <= 0:
            metrics = self._code_step('in') if g_on else {}
        elif g_on:
            metrics = self._full_step(self.fidelity_weight, current_iter)
        else:
            metrics = self._d_only_step(self.fidelity_weight, current_iter)
        self._ema()
        self._set_log(metrics)
