"""The photo stream of benchmark/systems/photos.py with the background
upsampled by Real-ESRGAN x2plus (RRDBNet) on the fused path: the CLI's
`--bg_upsampler realesrgan`, each chunk's frames upscaled by the
program's `RealESRGANer` tile walk (`DeviceRestorePipeline(...,
bg_upsampler=)`), the faces pasted onto that canvas.

The RRDBNet weights are seeded (benchmark/weights.py, seed + 3) and
tamed as chip_smoke.py's `tame_rrdb` tames them: random RRDBs each
return about 1.2 times their input, so 23 of them grow the features
about 66-fold and 99% of the output saturates at 0 or 255, where a
comparison proves nothing. `conv_body` is scaled by 1.2^-num_block,
`conv_last` by 0.04 with its bias at 0.5. The warm-up refuses a run whose
background still saturates.

The comparison keeps photos.py's readings but `background_off` (exact
equality cannot hold between the program's bf16 RRDBNet and the
reference's float32 one). The reference runs its own float32 RRDBNet
(benchmark/reference/rrdbnet.py) over the same walk and pastes its
faces onto that canvas (benchmark/reference/paste_canvas.py); over the
pixels that no face's warp comes within 2 px of:
- bg_mean_off: the mean |difference| in levels, over pixels and
  channels, the worst frame;
- bg_max_off: the largest difference.
The control (`quant='int8'`) takes the reference RRDBNet in float8 e4m3
(benchmark/reference/lowp.py) in the program's place for these two.
"""
from __future__ import annotations

import inspect
from typing import Dict
from unittest import mock

import numpy as np
import torch

from benchmark.reference import paste as rp
from benchmark.reference import rrdbnet as rr
from benchmark.reference.codeformer import fp32_math
from benchmark.reference.lowp import float8_convs
from benchmark.reference.paste_canvas import paste_on
from benchmark.systems import aligned, photos
from benchmark.weights import make_state_dict

TRAFFIC = photos.TRAFFIC
# chip_smoke.py tame_rrdb: each random RRDB returns about RRDB_GAIN times
# its input; conv_last's scale and bias put the output mid-range
RRDB_GAIN = 1.2
LAST_SCALE = 0.04
LAST_BIAS = 0.5
# chip_smoke.py ESR_MAX_SATURATED: share of the upscaled background's
# values at 0 or 255 past which the comparison would compare nothing
MAX_SATURATED = 0.05


def rrdb_weights(cfg: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded, tamed float32 state dict of the configuration's
    RRDBNet (the reference's names are the program's)."""
    arch = cfg['bg_upsampler']['arch']
    with torch.device('meta'):
        ref = rr.RRDBNet(**arch)
    sd = make_state_dict(ref, seed + 3, device)
    damp = RRDB_GAIN ** -arch['num_block']
    sd['conv_body.weight'].mul_(damp)
    sd['conv_body.bias'].mul_(damp)
    sd['conv_last.weight'].mul_(LAST_SCALE)
    sd['conv_last.bias'].fill_(LAST_BIAS)
    return sd


def program_upsampler(cfg: Dict, sd, device):
    """The program's RealESRGANer on the seeded weights, in the
    configuration's dtype, tile and pad."""
    from codeformer_tpu_torch.models.rrdbnet import RRDBNet
    from codeformer_tpu_torch.pipeline.realesrgan import RealESRGANer
    up = cfg['bg_upsampler']
    with torch.device('meta'):
        model = RRDBNet(**up['arch'])
    model.to_empty(device=device)
    model.load_state_dict(sd)
    return RealESRGANer(scale=up['arch']['scale'], model=model,
                        tile=up['tile'], tile_pad=up['tile_pad'],
                        dtype=aligned.DTYPES[up['dtype']], device=device)


class System(photos.System):
    """photos.System with the pipeline built with a background upsampler
    (module docstring)."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 quant=None):
        from codeformer_tpu_torch.pipeline.device_pipeline import \
            DeviceRestorePipeline
        if 'bg_upsampler' not in inspect.signature(
                DeviceRestorePipeline).parameters:
            raise SystemExit('benchmark: this program\'s '
                             'DeviceRestorePipeline takes no bg_upsampler: '
                             'it cannot serve --bg_upsampler realesrgan on '
                             'the fused path')
        super().__init__(cfg, traffic, seed, device, quant)
        up = program_upsampler(cfg, rrdb_weights(cfg, seed, self.device),
                               self.device)
        old = self.pipe
        self.pipe = DeviceRestorePipeline(
            old.restorer, old.helper, upscale=self.up,
            frame_chunk=traffic['chunk'], detect_resize=cfg['detect_resize'],
            w=cfg['w'], parse_res=cfg['parse_res'], bg_upsampler=up)
        del old
        self._record(self.pipe)

    def warmup(self) -> None:
        super().warmup()
        frame = torch.as_tensor(self.clip[0], device=self.device)[None]
        bg = self.pipe._upsample_bg(frame)
        sat = float(((bg == 0) | (bg == 255)).float().mean())
        if sat > MAX_SATURATED:
            raise RuntimeError(f'the seeded background upscale has {sat:.3f} '
                               f'of its values at 0 or 255 (more than '
                               f'{MAX_SATURATED}): the comparison would '
                               f'compare nothing')
        self.pipe.bg_upsampler.reset_tile_counts()

    @torch.no_grad()
    def check(self, kept) -> Dict[str, float]:
        """photos.System.check with the reference's faces pasted onto its
        own float32 RRDBNet canvas, and bg_mean_off / bg_max_off in place
        of background_off (module docstring)."""
        cfg, dev = self.cfg, self.device
        up = cfg['bg_upsampler']
        with torch.device('meta'):
            ref = rr.RRDBNet(**up['arch'])
        ref.load_state_dict(rrdb_weights(cfg, self.seed, dev), assign=True)
        ref.eval()
        canvases, control = [], []
        with fp32_math():
            for i, _ in kept:
                frames = torch.from_numpy(np.stack(
                    [self.clip[j] for j in self.request_frames(i)])).to(dev)
                canvases.extend(rr.upscale(ref, frames, up['tile'],
                                           up['tile_pad']))
                if self.quant:   # the control: float8 in the program's place
                    with float8_convs(ref):
                        control.extend(rr.upscale(ref, frames, up['tile'],
                                                  up['tile_pad']))
        del ref
        order, reaches = iter(canvases), []

        def paste(frame, faces, masks, inv, scale, w_edge):
            """rp.paste as photos.System.check calls it, a frame at a
            time in the kept order, onto that frame's reference canvas."""
            out = paste_on(next(order), faces, masks, inv, scale, w_edge)
            reaches.append(out[2])
            return out

        with mock.patch.object(rp, 'paste', paste):
            numbers = super().check(kept)
        numbers.pop('background_off', None)
        got = [torch.from_numpy(np.asarray(f)).to(dev)
               for _, frames in kept for f in frames]
        if control:
            got = control
        means, maxes = [], []
        for ref_bg, g, reach in zip(canvases, got, reaches):
            near = torch.nn.functional.max_pool2d(
                reach[None, None].float(), 5, 1, 2)[0, 0] > 0
            d = (ref_bg.int() - g.int()).abs()[~near].float()
            means.append(float(d.mean()) if d.numel() else 0.0)
            maxes.append(float(d.max()) if d.numel() else 0.0)
        numbers['bg_mean_off'] = max(means)
        numbers['bg_max_off'] = max(maxes)
        return numbers

    def instrument(self):
        """photos.System's stage ranges, and `stage.upsample` around the
        background upsample (called from the chunk, beside the other
        stages, never inside one)."""
        from benchmark import trace as tr
        super().instrument()
        pipe = self.pipe
        upsample = pipe._upsample_bg

        def spanned(*a, **kw):
            with tr.span('stage.upsample'):
                return upsample(*a, **kw)
        pipe._upsample_bg = spanned

    def trace_facts(self) -> Dict:
        """photos.System's FLOPs a frame plus RRDBNet's over the walk,
        and `upsample_s`, the walk's least seconds a frame."""
        from benchmark import roofline
        facts = super().trace_facts()
        up = self.cfg['bg_upsampler']
        h, w = self.traffic['frame_hw']
        cost = rr.walk_cost(up['arch'], h, w, up['tile'], up['tile_pad'])
        facts['flops_per_unit'] += cost['flops']
        facts['upsample_s'] = roofline.bound(cost['flops'], cost['bytes'])
        return facts
