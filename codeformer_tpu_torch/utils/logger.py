"""Training loggers (the port's copy of codeformer_tpu/utils/logger.py;
reference basicsr/utils/logger.py): the iteration message with its ETA,
TensorBoard scalars when tensorboard is installed, a root logger that
writes its file on rank 0 only, and the environment's versions."""
from __future__ import annotations

import datetime
import logging
import time
from typing import Dict, Optional

LOGGER_NAME = 'codeformer_tpu_torch'
_FORMAT = '%(asctime)s %(levelname)s: %(message)s'


class MessageLogger:
    """Formats iteration logs: epoch/iter/lr/time/ETA + losses
    (logger.py:10-74). Losses (`l_*`) go to TensorBoard as `losses/<k>`,
    other values under their own names, unless the experiment's name
    holds 'debug'."""

    def __init__(self, opt: Dict, start_iter: int = 1, tb_logger=None):
        self.exp_name = opt['name']
        logger_opt = opt.get('logger') or {}
        self.interval = logger_opt.get('print_freq', 100)
        self.start_iter = start_iter
        self.max_iters = opt['train']['total_iter']
        self.use_tb_logger = bool(logger_opt.get('use_tb_logger'))
        self.tb_logger = tb_logger
        self.start_time = time.time()
        self.logger = get_root_logger()

    def __call__(self, log_vars: Dict) -> str:
        log_vars = dict(log_vars)
        epoch = log_vars.pop('epoch')
        current_iter = log_vars.pop('iter')
        lrs = log_vars.pop('lrs')
        message = (f'[{self.exp_name[:5]}..][epoch:{epoch:3d}, '
                   f'iter:{current_iter:8,d}, lr:(')
        message += ', '.join(f'{lr:.3e}' for lr in lrs) + ')] '

        if 'time' in log_vars:
            iter_time = log_vars.pop('time')
            data_time = log_vars.pop('data_time', 0.0)
            total_time = time.time() - self.start_time
            time_sec_avg = total_time / (current_iter - self.start_iter + 1)
            eta_sec = time_sec_avg * (self.max_iters - current_iter - 1)
            eta_str = str(datetime.timedelta(seconds=int(eta_sec)))
            message += (f'[eta: {eta_str}, time (data): '
                        f'{iter_time:.3f} ({data_time:.3f})] ')

        for k, v in log_vars.items():
            message += f'{k}: {v:.4e} '
            if self.tb_logger and self.use_tb_logger and \
                    'debug' not in self.exp_name:
                key = f'losses/{k}' if k.startswith('l_') else k
                self.tb_logger.add_scalar(key, float(v), current_iter)
        self.logger.info(message)
        return message


def init_tb_logger(log_dir: str):
    """A torch.utils.tensorboard SummaryWriter on `log_dir`, or None with
    a warning where tensorboard is not installed."""
    try:
        from torch.utils.tensorboard import SummaryWriter
    except ImportError:
        get_root_logger().warning('tensorboard unavailable; scalars will '
                                  'only go to the console log')
        return None
    return SummaryWriter(log_dir=log_dir)


def get_root_logger(log_level: int = logging.INFO,
                    log_file: Optional[str] = None,
                    rank: int = 0) -> logging.Logger:
    """The port's logger (reference logger.py:105-142): a console handler
    once a process; `log_file` adds a file handler on rank 0 (close it
    with `close_file_handlers`); ranks other than 0 log errors only."""
    logger = logging.getLogger(LOGGER_NAME)
    if not any(getattr(h, '_root_console', False) for h in logger.handlers):
        sh = logging.StreamHandler()
        sh.setFormatter(logging.Formatter(_FORMAT))
        sh._root_console = True
        logger.addHandler(sh)
        logger.propagate = False
    if rank != 0:
        logger.setLevel(logging.ERROR)
        return logger
    logger.setLevel(log_level)
    if log_file is not None:
        fh = logging.FileHandler(log_file, 'w')
        fh.setFormatter(logging.Formatter(_FORMAT))
        logger.addHandler(fh)
    return logger


def close_file_handlers(logger: logging.Logger) -> None:
    """Remove and close the logger's file handlers (a run's log file)."""
    for h in list(logger.handlers):
        if isinstance(h, logging.FileHandler):
            logger.removeHandler(h)
            h.close()


def get_env_info() -> str:
    """torch and CUDA versions and the visible devices."""
    import torch
    devices = ([torch.cuda.get_device_name(i)
                for i in range(torch.cuda.device_count())]
               if torch.cuda.is_available() else [])
    return ('\ncodeformer_tpu_torch'
            f'\n\tPyTorch: {torch.__version__}'
            f'\n\tCUDA: {torch.version.cuda}'
            f'\n\tcuda available: {torch.cuda.is_available()}'
            f'\n\tdevices: {devices or ["cpu"]}')
