"""Training entry point (counterpart of codeformer_tpu/train/train.py):

    python -m codeformer_tpu_torch.train.train -opt options/CodeFormer_stage2.yml
    torchrun --nproc_per_node 8 -m codeformer_tpu_torch.train.train \
        -opt options/CodeFormer_stage2.yml --launcher pytorch

YAML config -> training and validation sets and loaders -> trainer ->
loop with the message logger (ETA, TensorBoard scalars), checkpoints and
`val_freq` validation. The options parser (utils/options.py), the
datasets and the loader (data/) are the port's own host-side modules;
they need yaml, cv2 and PIL and are imported inside the functions.
chip_smoke.py drives the trainer on the card without them. The trainer
runs on the yml's `device:` (default 'cuda'); `--force_yml device=cpu`
overrides it. `--launcher pytorch` starts one data-parallel process a
device from torchrun's environment (parallel/): NCCL on cuda (device
cuda:LOCAL_RANK), gloo on the CPU; the sampler strides its ranks, and
rank 0 alone writes checkpoints, the log file and TensorBoard.
"""
from __future__ import annotations

import argparse
import os
import os.path as osp
import random
import time


def parse_options(root_path: str, args=None) -> dict:
    """-opt <yml> [--force_yml key:sub=value ...] -> the
    option dict, with the experiment paths under
    root_path/experiments/<name>."""
    import yaml

    from codeformer_tpu_torch.utils.options import parse
    parser = argparse.ArgumentParser()
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--launcher', choices=['none', 'pytorch'],
                        default='none',
                        help='pytorch: one data-parallel process a device, '
                             'started by torchrun')
    parser.add_argument('--force_yml', nargs='+', default=None,
                        help='override options: key:subkey=value')
    parsed = parser.parse_args(args)
    opt = parse(parsed.opt, root_path, is_train=True)
    for entry in parsed.force_yml or []:
        keys, value = entry.split('=', 1)
        node = opt
        key_list = keys.split(':')
        for k in key_list[:-1]:
            node = node[k]
        node[key_list[-1]] = yaml.safe_load(value)
    opt['launcher'] = parsed.launcher
    return opt


def create_train_val_dataloader(opt: dict, logger, start_epoch: int = 0):
    """(train loader, val loader or None, total iterations) from
    opt['datasets'] (JAX train.py:63-87): the train set through a
    rank-strided EnlargedSampler starting at `start_epoch`, a `val*` set
    for one pass."""
    from codeformer_tpu_torch import parallel
    from codeformer_tpu_torch.data import build_dataset
    from codeformer_tpu_torch.data.loader import (EnlargedSampler,
                                                  build_dataloader)
    rank, world = parallel.get_dist_info()
    train_loader = val_loader = None
    for phase, dataset_opt in opt['datasets'].items():
        if phase == 'train':
            train_set = build_dataset(dataset_opt)
            sampler = EnlargedSampler(
                len(train_set), world, rank,
                dataset_opt.get('dataset_enlarge_ratio', 1))
            # a resumed run draws the shuffle of its epoch, not epoch 0's
            train_loader = build_dataloader(train_set, dataset_opt,
                                            sampler=sampler,
                                            start_epoch=start_epoch)
            logger.info(f'training set [{dataset_opt["name"]}]: '
                        f'{len(train_set)} images, batch '
                        f'{dataset_opt["batch_size_per_gpu"]} a process, '
                        f'{len(train_loader)} iterations an epoch')
        elif phase.split('_')[0] == 'val':
            val_set = build_dataset(dataset_opt)
            val_loader = build_dataloader(val_set, dataset_opt,
                                          is_train=False)
            logger.info(f'validation set [{dataset_opt["name"]}]: '
                        f'{len(val_set)} images')
    return train_loader, val_loader, int(opt['train']['total_iter'])


def train_pipeline(root_path: str, args=None):
    """Train the stage the options name; returns the trainer. Logs to
    the console and (rank 0) to a file in the experiment directory."""
    from codeformer_tpu_torch import parallel
    from codeformer_tpu_torch.utils.logger import (close_file_handlers,
                                                   get_root_logger)
    opt = parse_options(root_path, args)
    started = False
    if opt['launcher'] == 'pytorch' and not parallel.initialized():
        device_type = str(opt.get('device') or 'cuda').split(':')[0]
        _, _, local_rank = parallel.init_dist('pytorch', device_type)
        if device_type == 'cuda':
            opt['device'] = f'cuda:{local_rank}'
        started = True
    rank = parallel.get_dist_info()[0]
    resume_state_path = (opt.get('path') or {}).get('resume_state')
    if rank == 0 and not resume_state_path:
        from codeformer_tpu_torch.utils.misc import mkdir_and_rename
        mkdir_and_rename(opt['path']['experiments_root'])
    if parallel.initialized():    # the others wait for rank 0's directories
        import torch.distributed as dist
        dist.barrier()
    for key in ('models', 'training_states', 'visualization'):
        os.makedirs(opt['path'][key], exist_ok=True)
    logger = get_root_logger(log_file=osp.join(
        opt['path']['log'], f'train_{opt["name"]}_{int(time.time())}.log'),
        rank=rank)
    try:
        return _train(opt, logger)
    finally:
        close_file_handlers(logger)
        if started:
            import torch.distributed as dist
            dist.destroy_process_group()


def _train(opt: dict, logger):
    import numpy as np
    import torch

    from codeformer_tpu_torch import parallel
    from codeformer_tpu_torch.data.loader import DevicePrefetcher
    from codeformer_tpu_torch.train.trainers import build_model
    from codeformer_tpu_torch.utils.logger import (MessageLogger,
                                                   get_env_info,
                                                   init_tb_logger)

    rank, _ = parallel.get_dist_info()
    seed = (opt.get('manual_seed') or 0) + rank
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    resume_state_path = (opt.get('path') or {}).get('resume_state')
    logger.info(get_env_info())

    tb_logger = None
    if (opt.get('logger') or {}).get('use_tb_logger') and \
            'debug' not in opt['name'] and rank == 0:
        tb_logger = init_tb_logger(
            osp.join(opt['path']['experiments_root'], 'tb_logger'))

    model = build_model(opt)
    start_epoch, current_iter = 0, 0
    if resume_state_path:
        start_epoch, current_iter = model.resume_training(resume_state_path)
        logger.info(f'resuming from epoch {start_epoch}, iter '
                    f'{current_iter}')
    start_iter = current_iter
    train_loader, val_loader, total_iters = create_train_val_dataloader(
        opt, logger, start_epoch)
    iters_per_epoch = max(1, len(train_loader))
    msg_logger = MessageLogger(opt, current_iter + 1, tb_logger)
    logger_opt = opt.get('logger') or {}
    print_freq = logger_opt.get('print_freq', 100)
    save_freq = logger_opt.get('save_checkpoint_freq', 10 ** 9)
    val_opt = opt.get('val') or {}
    val_freq = val_opt.get('val_freq', float('inf'))
    # reference prefetch_mode 'cuda': the batch after the current one
    # crosses to the device on a side stream while the step runs
    if (opt['datasets']['train'] or {}).get('prefetch_mode') in ('cuda',
                                                                 'device'):
        train_loader = DevicePrefetcher(train_loader, model.device)
        logger.info('DevicePrefetcher: batches staged a step ahead')

    logger.info(f'start training from epoch {start_epoch}, iter '
                f'{current_iter}')
    epoch = start_epoch
    data_time = time.time()
    try:
        for batch in train_loader:
            current_iter += 1
            if current_iter > total_iters:
                break
            # the loader starts a new pass over the sampler every epoch
            epoch = start_epoch + (current_iter - start_iter - 1) \
                // iters_per_epoch
            iter_start = time.time()
            model.feed_data(batch)
            model.optimize_parameters(current_iter)
            iter_time = time.time() - iter_start
            if current_iter % print_freq == 0:
                log_vars = {'epoch': epoch, 'iter': current_iter,
                            'lrs': model.get_current_learning_rate(),
                            'time': iter_time,
                            'data_time': iter_start - data_time}
                log_vars.update(model.get_current_log())
                msg_logger(log_vars)
            if current_iter % save_freq == 0:
                logger.info('saving models and training states')
                model.save(epoch, current_iter)
            if val_loader is not None and current_iter % val_freq == 0 \
                    and rank == 0:
                model.validation(val_loader, current_iter, tb_logger,
                                 save_img=val_opt.get('save_img', False))
            data_time = time.time()
        logger.info('end of training')
        model.save(epoch, -1)
    finally:
        if tb_logger is not None:
            tb_logger.close()
    return model


if __name__ == '__main__':
    train_pipeline(osp.abspath(osp.join(__file__, osp.pardir, osp.pardir,
                                        osp.pardir)))
