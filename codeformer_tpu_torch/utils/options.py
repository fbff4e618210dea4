"""YAML option parsing (the port's own copy of
codeformer_tpu/utils/options.py) — config-driven dependency injection,
mirroring the reference's options system (basicsr/utils/options.py:32-87):
phase tagging, path expansion, experiments/results dir layout. Configs
select components by `type:` through the registries.
"""
from __future__ import annotations

import os.path as osp
from collections import OrderedDict
from typing import Any, Dict, Optional

import yaml


def ordered_yaml():
    """Loader/Dumper preserving mapping order (options.py:7-29)."""
    try:
        from yaml import CDumper as Dumper, CLoader as Loader
    except ImportError:
        from yaml import Dumper, Loader

    _mapping_tag = yaml.resolver.BaseResolver.DEFAULT_MAPPING_TAG

    def dict_representer(dumper, data):
        return dumper.represent_dict(data.items())

    def dict_constructor(loader, node):
        return OrderedDict(loader.construct_pairs(node))

    Dumper.add_representer(OrderedDict, dict_representer)
    Loader.add_constructor(_mapping_tag, dict_constructor)
    return Loader, Dumper


def parse(opt_path: str, root_path: Optional[str] = None,
          is_train: bool = True) -> Dict[str, Any]:
    """Load a training/test YAML config and expand paths."""
    with open(opt_path, mode='r') as f:
        Loader, _ = ordered_yaml()
        opt = yaml.load(f, Loader=Loader)
    opt['is_train'] = is_train
    root_path = root_path or osp.abspath('.')

    # datasets: tag phase and scale
    for phase, dataset in (opt.get('datasets') or {}).items():
        phase = phase.split('_')[0]
        dataset['phase'] = phase
        if 'scale' in opt:
            dataset['scale'] = opt['scale']
        if dataset.get('dataroot_gt') is not None:
            dataset['dataroot_gt'] = osp.expanduser(dataset['dataroot_gt'])
        if dataset.get('dataroot_lq') is not None:
            dataset['dataroot_lq'] = osp.expanduser(dataset['dataroot_lq'])

    # paths
    opt.setdefault('path', {})
    for key, val in opt['path'].items():
        if val and ('resume_state' in key or 'pretrain_network' in key
                    or 'pretrain_' in key):
            opt['path'][key] = osp.expanduser(val)

    if is_train:
        experiments_root = osp.join(root_path, 'experiments', opt['name'])
        opt['path']['experiments_root'] = experiments_root
        opt['path']['models'] = osp.join(experiments_root, 'models')
        opt['path']['training_states'] = osp.join(experiments_root,
                                                  'training_states')
        opt['path']['log'] = experiments_root
        opt['path']['visualization'] = osp.join(experiments_root,
                                                'visualization')
        if 'debug' in opt['name']:
            for k in ('val_freq', 'save_checkpoint_freq'):
                if 'val' in opt and k == 'val_freq':
                    opt['val']['val_freq'] = 8
                if 'logger' in opt and k == 'save_checkpoint_freq':
                    opt['logger']['save_checkpoint_freq'] = 8
            if 'train' in opt:
                opt['train']['total_iter'] = 16
            if 'logger' in opt:
                opt['logger']['print_freq'] = 1
    else:
        results_root = osp.join(root_path, 'results', opt['name'])
        opt['path']['results_root'] = results_root
        opt['path']['log'] = results_root
        opt['path']['visualization'] = osp.join(results_root,
                                                'visualization')
    return opt

