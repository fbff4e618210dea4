"""Aligned faces: batches of uint8 RGB faces from host memory through
`CodeFormerRestorer.restore_device`, the restored faces back on the
host. The reference CLI's `--has_aligned` path at B=1; a folder of
crops served in batches at B > 1.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import generator
from benchmark.compare import CodeRecorder, face_numbers
from benchmark.reference.codeformer import CodeFormer as RefCodeFormer
from benchmark.weights import make_state_dict

DTYPES = {'bfloat16': torch.bfloat16, 'float32': torch.float32}
# the keys a traffic file of each entry gives (benchmark/run.py refuses
# any other)
TRAFFIC = {'restore_device': ('batch', 'pool', 'max_requests',
                              'warmup_requests', 'check_requests')}


def reference_model(cfg: Dict, device) -> torch.nn.Module:
    """The plain reference of the configuration, uninitialised, on
    `device` ('meta' for counting)."""
    with torch.device(device):
        return RefCodeFormer(**cfg['arch'])


def seeded_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    return make_state_dict(reference_model(cfg, 'meta'), seed, device,
                           cfg.get('tame'))


def program_restorer(cfg: Dict, sd, device, quant=None):
    """The program's restorer on the seeded weights: the port's
    CodeFormer built without initialising, loaded with `sd`, served in
    the configuration's dtype."""
    from codeformer_tpu_torch.models import CodeFormer
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    with torch.device('meta'):
        model = CodeFormer(**cfg['arch'])
    model.to_empty(device=device)
    model.load_state_dict(sd)
    return CodeFormerRestorer(device=device, model=model,
                              dtype=DTYPES[cfg['dtype']], quant=quant,
                              face_size=cfg['arch']['img_size'])


class System:
    """One cell's program and inputs. `request(i)` serves request i and
    returns (host output, faces done); `check(kept)` compares the kept
    requests with the reference."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 quant=None):
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.w, self.adain = cfg['w'], cfg['adain']
        t = time.perf_counter()
        sd = seeded_weights(cfg, seed, self.device)
        self.setup_parts = {'weights': time.perf_counter() - t}
        self.restorer = program_restorer(cfg, sd, self.device, quant)
        del sd
        self.setup_parts['program'] = time.perf_counter() - t
        self.recorder = CodeRecorder(self.restorer.model)
        top = self.restorer.batch_buckets[-1]
        self.forwards_per_request = -(-traffic['batch'] // top)
        size = cfg['arch']['img_size']
        pool = generator.face_pool(seed, traffic['pool'], size, self.device)
        self.batches = generator.batches(pool, traffic['batch'], seed)
        self.order = generator.cycle_order(seed, len(self.batches),
                                           traffic['max_requests'])
        self.setup_parts['inputs'] = time.perf_counter() - t

    def warmup(self) -> None:
        for i in range(self.traffic['warmup_requests']):
            self.request(len(self.order) - 1 - i)
        self.recorder.codes.clear()

    def request(self, i: int) -> Tuple[np.ndarray, int]:
        x = self.batches[self.order[i]]
        y = self.restorer.restore_device(x, w=self.w, adain=self.adain)
        return y.cpu().numpy(), len(x)

    def release(self) -> None:
        """Drop the program's model and buffers (the codes stay)."""
        self.codes = [c.cpu() for c in self.recorder.codes]
        del self.restorer, self.recorder
        torch.cuda.empty_cache() if self.device.type == 'cuda' else None

    def check(self, kept: List[Tuple[int, np.ndarray]]) -> Dict[str, float]:
        """Worst reading over the kept requests' faces."""
        ref = reference_model(self.cfg, 'meta')
        ref.load_state_dict(seeded_weights(self.cfg, self.seed,
                                           self.device), assign=True)
        per = self.forwards_per_request
        xs, ys, cs = [], [], []
        for i, y in kept:
            xs.append(self.batches[self.order[i]])
            ys.append(y)
            cs.append(torch.cat(self.codes[i * per:(i + 1) * per])
                      [:len(y)])
        dev = self.device
        nums = face_numbers(
            ref.eval(), torch.from_numpy(np.concatenate(xs)).to(dev),
            torch.from_numpy(np.concatenate(ys)).to(dev),
            torch.cat(cs).to(dev), self.w, self.adain)
        return {k: float(v.max()) for k, v in nums.items()}

    def trace_facts(self) -> Dict:
        """What the per-layer readers need besides the trace: FLOPs a
        face, least seconds of a forward's K1 and K2 calls."""
        from benchmark import roofline
        meta = reference_model(self.cfg, 'meta')
        size = self.cfg['arch']['img_size']
        top = self.restorer.batch_buckets[-1]
        b = min(self.traffic['batch'], top)
        fwd = roofline.forward_bounds(meta, self.restorer._bucket(b), size,
                                      self.w)
        return {'flops_per_unit': roofline.forward_flops(meta, 1, size,
                                                         self.w),
                'forwards_per_request': self.forwards_per_request,
                **fwd}
