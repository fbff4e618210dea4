"""Training entry point (counterpart of codeformer_tpu/train/train.py):

    python -m codeformer_tpu_torch.train.train -opt options/CodeFormer_stage2.yml

YAML config -> training set and loader -> trainer -> loop with logging
and checkpoints. The options parser (utils/options.py), the datasets and
the loader (data/) are the port's own host-side modules; they need yaml,
cv2 and PIL and are imported inside the functions. chip_smoke.py drives
the trainer on the card without them. The trainer runs on the yml's
`device:` (default 'cuda'); `--force_yml device=cpu` overrides it.
"""
from __future__ import annotations

import argparse
import logging
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
    return opt


def train_pipeline(root_path: str, args=None):
    """Train the stage the options name; returns the trainer. Logs to
    the console and to a file in the experiment directory."""
    opt = parse_options(root_path, args)
    resume_state_path = (opt.get('path') or {}).get('resume_state')
    if not resume_state_path:
        from codeformer_tpu_torch.utils.misc import mkdir_and_rename
        mkdir_and_rename(opt['path']['experiments_root'])
    for key in ('models', 'training_states'):
        os.makedirs(opt['path'][key], exist_ok=True)
    logger = logging.getLogger('codeformer_tpu_torch')
    logger.setLevel(logging.INFO)
    fmt = logging.Formatter('%(asctime)s %(levelname)s: %(message)s')
    handlers = [logging.StreamHandler(), logging.FileHandler(osp.join(
        opt['path']['log'], f'train_{opt["name"]}_{int(time.time())}.log'))]
    for handler in handlers:
        handler.setFormatter(fmt)
        logger.addHandler(handler)
    try:
        return _train(opt, logger)
    finally:
        for handler in handlers:
            logger.removeHandler(handler)
            handler.close()


def _train(opt: dict, logger: logging.Logger):
    import numpy as np
    import torch

    from codeformer_tpu_torch.data import build_dataset
    from codeformer_tpu_torch.data.loader import (EnlargedSampler,
                                                  build_dataloader)
    from codeformer_tpu_torch.train.trainers import build_model

    seed = opt.get('manual_seed') or 0
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    resume_state_path = (opt.get('path') or {}).get('resume_state')
    logger.info(f'torch {torch.__version__}, cuda available: '
                f'{torch.cuda.is_available()}')

    model = build_model(opt)
    dataset_opt = opt['datasets']['train']
    train_set = build_dataset(dataset_opt)
    sampler = EnlargedSampler(len(train_set), 1, 0,
                              dataset_opt.get('dataset_enlarge_ratio', 1))
    train_loader = build_dataloader(train_set, dataset_opt, sampler=sampler)
    iters_per_epoch = max(1, len(train_loader))
    total_iters = int(opt['train']['total_iter'])
    logger.info(f'training set [{dataset_opt["name"]}]: {len(train_set)} '
                f'images, batch {dataset_opt["batch_size_per_gpu"]}, '
                f'{iters_per_epoch} iterations an epoch')

    start_epoch, current_iter = 0, 0
    if resume_state_path:
        start_epoch, current_iter = model.resume_training(resume_state_path)
        logger.info(f'resuming from epoch {start_epoch}, iter '
                    f'{current_iter}')
    start_iter = current_iter
    logger_opt = opt.get('logger') or {}
    print_freq = logger_opt.get('print_freq', 100)
    save_freq = logger_opt.get('save_checkpoint_freq', 10 ** 9)

    epoch = start_epoch
    data_time = time.time()
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
        if current_iter % print_freq == 0:
            logs = ', '.join(f'{k}: {v:.4e}'
                             for k, v in model.get_current_log().items())
            logger.info(f'[epoch {epoch}, iter {current_iter}, lr '
                        f'{model.get_current_learning_rate()[0]:.3e}, time '
                        f'{time.time() - iter_start:.3f}, data '
                        f'{iter_start - data_time:.3f}] {logs}')
        if current_iter % save_freq == 0:
            logger.info('saving models and training states')
            model.save(epoch, current_iter)
        data_time = time.time()
    logger.info('end of training')
    model.save(epoch, -1)
    return model


if __name__ == '__main__':
    train_pipeline(osp.abspath(osp.join(__file__, osp.pardir, osp.pardir,
                                        osp.pardir)))
