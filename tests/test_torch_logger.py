"""The port's training loggers (codeformer_tpu_torch/utils/logger.py)
against the JAX package's (codeformer_tpu/utils/logger.py): the same
iteration message for the same log values at a frozen clock, the same
TensorBoard scalars, the tensorboard-absent warning, the rank-0-only log
file, and the environment report. Exact string and call equality."""
import logging
import sys

import pytest

torch = pytest.importorskip('torch')

from codeformer_tpu.utils import logger as jlog  # noqa: E402
from codeformer_tpu_torch.utils import logger as plog  # noqa: E402


class _Board:
    def __init__(self):
        self.calls = []

    def add_scalar(self, tag, value, step):
        self.calls.append((tag, value, step))


class _Catch(logging.Handler):
    def __init__(self):
        super().__init__(logging.DEBUG)
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


OPT = {'name': 'train_stage2_run', 'train': {'total_iter': 500000},
       'logger': {'print_freq': 100, 'use_tb_logger': True}}


@pytest.mark.parametrize('name', ['train_stage2_run', 'debug_stage2'])
def test_message_and_scalars_match_jax(monkeypatch, name):
    opt = dict(OPT, name=name)
    now = [1000.0]
    monkeypatch.setattr(plog.time, 'time', lambda: now[0])
    monkeypatch.setattr(jlog.time, 'time', lambda: now[0])
    got, want = {}, {}
    for tag, mod, logger_name in (('port', plog, 'codeformer_tpu_torch'),
                                  ('jax', jlog, 'codeformer_tpu')):
        board, catch = _Board(), _Catch()
        logging.getLogger(logger_name).addHandler(catch)
        try:
            msg_logger = mod.MessageLogger(opt, start_iter=101,
                                           tb_logger=board)
            now[0] = 1000.0 + 37.5
            msg_logger({'epoch': 3, 'iter': 200, 'lrs': [1e-4, 5e-5],
                        'time': 0.3751, 'data_time': 0.0123,
                        'l_g_total': 1.25, 'l_feat_encoder': 0.5,
                        'cross_entropy_loss': 0.75, 'd_weight': 0.125})
            now[0] = 1000.0
        finally:
            logging.getLogger(logger_name).removeHandler(catch)
        (got if tag == 'port' else want).update(
            messages=catch.messages, calls=board.calls)
    assert got == want
    assert got['messages'][0].startswith(
        f'[{name[:5]}..][epoch:  3, iter:     200, lr:(1.000e-04, 5.000e-05)]'
        ' [eta: 2 days, 4:03:44, time (data): 0.375 (0.012)] l_g_total: '
        '1.2500e+00 ')
    if 'debug' in name:
        assert got['calls'] == []
    else:
        assert [c[0] for c in got['calls']] == [
            'losses/l_g_total', 'losses/l_feat_encoder',
            'cross_entropy_loss', 'd_weight']


def test_init_tb_logger(tmp_path, monkeypatch):
    writer = plog.init_tb_logger(str(tmp_path / 'tb'))
    try:
        writer.add_scalar('losses/l_pix', 0.5, 1)
        writer.flush()
    finally:
        writer.close()
    assert any((tmp_path / 'tb').iterdir())
    # without tensorboard: None and the JAX package's warning
    monkeypatch.setitem(sys.modules, 'torch.utils.tensorboard', None)
    catch = _Catch()
    logging.getLogger('codeformer_tpu_torch').addHandler(catch)
    try:
        assert plog.init_tb_logger(str(tmp_path / 'tb2')) is None
    finally:
        logging.getLogger('codeformer_tpu_torch').removeHandler(catch)
    assert catch.messages == ['tensorboard unavailable; scalars will only '
                              'go to the console log']


def test_root_logger_writes_its_file_on_rank_0_only(tmp_path):
    log = plog.get_root_logger(log_file=str(tmp_path / 'r1.log'), rank=1)
    try:
        assert log.level == logging.ERROR
        assert not (tmp_path / 'r1.log').exists()
        log = plog.get_root_logger(log_file=str(tmp_path / 'r0.log'))
        assert log.level == logging.INFO
        log.info('hello from rank 0')
        consoles = [h for h in log.handlers
                    if getattr(h, '_root_console', False)]
        assert len(consoles) == 1          # one console handler a process
    finally:
        plog.close_file_handlers(log)
    assert 'hello from rank 0' in (tmp_path / 'r0.log').read_text()
    assert not any(isinstance(h, logging.FileHandler) for h in log.handlers)


def test_env_info_names_torch_and_the_devices():
    info = plog.get_env_info()
    assert f'PyTorch: {torch.__version__}' in info
    assert "devices: ['cpu']" in info or 'cuda available: True' in info
