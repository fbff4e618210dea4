"""Whole photos and video frames through the program's fused pipeline,
`DeviceRestorePipeline`: RetinaFace's device graph, the align warp, the
restorer, ParseNet and the paste-back, frames in and out as uint8 BGR
host arrays.

Random weights find no faces, so the detections are the benchmark's: a
`FaceDetector` subclass runs RetinaFace's whole device graph on every
chunk and waits for it, then hands on the traffic's landmarks (the
template at the traffic's scale and offsets), as chip_smoke.py's
`wi_detector_class` does. The host decode and NMS of real detections
are therefore not measured.

Two entries: `restore_frames_stream` (a video or folder stream: a clip
made in set-up, cycled, chunks of the pipeline's frame_chunk, each
chunk's frames back on the host) and `restore_frames` (one photo a
request).
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from benchmark import generator
from benchmark.compare import (OFF_FACE, OFF_TILE, WIDE_CODE, WIDE_PARSE,
                               CodeRecorder, own_where_wide, pick_gaps,
                               token_tile, wide_numbers)
from benchmark.reference import paste as rp
from benchmark.reference.lowp import float8_convs
from benchmark.reference.parsenet import ParseNet as RefParseNet
from benchmark.reference.retinaface import RetinaFace as RefRetinaFace
from benchmark.reference.retinaface import detect_input
from benchmark.systems import aligned
from benchmark.weights import make_state_dict

# the FFHQ 5-point template of a 512 face (face_restoration_helper.py)
TEMPLATE_512 = np.array([[192.98138, 239.94708], [318.90277, 240.1936],
                         [256.63416, 314.01935], [201.26117, 371.41043],
                         [313.08905, 371.15118]], np.float32)
HEADS = (('BboxHead', 1.0), ('LandmarkHead', 1.0), ('ClassHead', 2.0))
# the keys a traffic file of each entry gives (benchmark/run.py refuses
# any other)
_KEYS = ('frame_hw', 'faces_per_frame', 'face_offsets', 'face_scale',
         'chunk', 'clip_frames', 'max_requests', 'warmup_requests',
         'check_requests')
TRAFFIC = {'restore_frames_stream': _KEYS, 'restore_frames': _KEYS}


def landmarks(traffic: Dict, face: int) -> List[np.ndarray]:
    """Each face's five points in a frame: the template at the traffic's
    scale, centred at the frame's centre plus the face's offset."""
    h, w = traffic['frame_hw']
    tpl = TEMPLATE_512 * (face / 512.0)
    return [tpl * traffic['face_scale']
            + np.array([w / 2 + ox, h / 2 + oy], np.float32)
            for ox, oy in traffic['face_offsets'][:traffic['faces_per_frame']]]


@torch.no_grad()
def detector_weights(seed: int, device, frame_hw, det_hw):
    """RetinaFace's seeded weights with its three heads scaled so that
    their largest output on a seeded frame is 1 (boxes, landmarks) or 2
    (class logits): random weights give outputs in the 1e5s, where every
    score saturates (chip_smoke.py's `tame_heads`)."""
    with torch.device('meta'):
        ref = RefRetinaFace()
    sd = make_state_dict(ref, seed + 1, device)
    ref.load_state_dict(sd, assign=True)
    ref.eval()
    g = generator.pixel_generator(seed + 1, device)
    frame = generator.smooth_images(g, 1, *frame_hw, device)
    feats = ref.features(detect_input(frame.flip(-1), det_hw))
    for name, target in HEADS:
        heads = getattr(ref, name)
        peak = max(float(h.conv1x1(f).abs().max())
                   for h, f in zip(heads, feats))
        for h in heads:
            h.conv1x1.weight.mul_(target / peak)
            h.conv1x1.bias.mul_(target / peak)
    return {k: v for k, v in ref.state_dict().items()}


def parser_weights(seed: int, device):
    with torch.device('meta'):
        ref = RefParseNet()
    return make_state_dict(ref, seed + 2, device)


def detector_class(traffic: Dict, face: int):
    """The program's FaceDetector with the traffic's detections handed
    on after its device graph ran."""
    from codeformer_tpu_torch.pipeline.detector import FaceDetector
    marks = landmarks(traffic, face)

    class BenchDetector(FaceDetector):
        def batched_detect_device_finish(self, frames_dev, det_hw, pending,
                                         *args, **kw):
            _, _, done = pending
            if done is not None:
                done.synchronize()          # the detection's work is timed
            b, h, _ = frames_dev.shape[:3]
            scale = det_hw[0] / h
            dets = np.zeros((b, self.max_faces, 15), np.float32)
            valid = np.zeros((b, self.max_faces), bool)
            for k, lm_f in enumerate(marks):
                lm = lm_f * scale
                dets[:, k, 0:4] = [lm[:, 0].min() - 30, lm[:, 1].min() - 60,
                                   lm[:, 0].max() + 30, lm[:, 1].max() + 40]
                dets[:, k, 4] = 0.99
                dets[:, k, 5:15] = lm.reshape(-1)
                valid[:, k] = True
            return dets, valid

    return BenchDetector


class System:
    """See the module docstring. Stream traffic: `stream(deadline)`
    yields (chunk index, host frames, frames); photo traffic:
    `request(i)` serves one frame."""

    def __init__(self, cfg: Dict, traffic: Dict, seed: int, device,
                 quant=None):
        """`quant='int8'` is the control: the restorer on the program's
        int8 path, and in the comparison the detector's heads and the
        parse ids computed by the reference in float8 in place of the
        program's (the program has no such path for either)."""
        from codeformer_tpu_torch.pipeline.device_pipeline import \
            DeviceRestorePipeline
        from codeformer_tpu_torch.pipeline.face_helper import \
            FaceRestoreHelper
        self.cfg, self.traffic, self.seed = cfg, traffic, seed
        self.device = torch.device(device)
        self.quant = quant
        self.streams = traffic['entry'] == 'restore_frames_stream'
        self.face = cfg['arch']['img_size']
        self.up = cfg['upscale']
        h, w = traffic['frame_hw']
        scale = cfg['detect_resize'] / min(h, w)
        self.det_hw = (int(h * scale), int(w * scale))
        dt = aligned.DTYPES
        t = time.perf_counter()
        restorer = aligned.program_restorer(
            cfg, aligned.seeded_weights(cfg, seed, self.device),
            self.device, quant)
        self.setup_parts = {'restorer': time.perf_counter() - t}
        # what the program chose, by request: its code picks and parse
        # ids (followed by the reference), its detector heads
        self.rec, self.current = {}, 0
        CodeRecorder(restorer.model,
                     lambda c: self.rec[self.current]['codes'].append(c))
        det = detector_class(traffic, self.face)(
            'retinaface_resnet50', allow_random=True,
            dtype=dt[cfg['det_dtype']], device=self.device)
        det.model.load_state_dict(detector_weights(
            seed, self.device, (h, w), self.det_hw))
        self._hook = det.model.register_forward_hook(self._keep_heads)
        self.setup_parts['detector'] = time.perf_counter() - t
        helper = FaceRestoreHelper(
            self.up, face_size=self.face, det_model='retinaface_resnet50',
            use_parse=True, device=self.device, allow_random_weights=True,
            detector=det, det_dtype=dt[cfg['det_dtype']],
            parse_dtype=dt[cfg['parse_dtype']])
        helper._parse_model.load_state_dict(parser_weights(seed,
                                                           self.device))
        self.setup_parts['helper'] = time.perf_counter() - t
        self.pipe = DeviceRestorePipeline(
            restorer, helper, upscale=self.up,
            frame_chunk=traffic['chunk'], detect_resize=cfg['detect_resize'],
            w=cfg['w'], parse_res=cfg['parse_res'])
        g = generator.pixel_generator(seed, self.device)
        clip = generator.smooth_images(g, traffic['clip_frames'], h, w,
                                       self.device)
        self.clip = list(clip.cpu().numpy())
        self.order = generator.cycle_order(seed, len(self.clip),
                                           traffic['max_requests'])
        self.calls = 0            # detector calls so far (one a request)
        self.setup_parts['inputs'] = time.perf_counter() - t
        self._record(self.pipe)

    def _keep_heads(self, module, args, out):
        self.rec.setdefault(self.calls, {'codes': [], 'pids': []})['heads'] \
            = out
        self.calls += 1

    def _record(self, pipe):
        """Wrap the pipeline's chunk entry (which request the chunk
        serves) and its parse (the ids it picked), on the instance."""
        chunk, parse = pipe._restore_chunk_device, pipe._parse_ids

        def restore_chunk(*a, **kw):
            out = chunk(*a, **kw)
            self.current += 1
            return out

        def parse_ids(*a, **kw):
            ids = parse(*a, **kw)
            self.rec[self.current]['pids'].append(ids)
            return ids
        pipe._restore_chunk_device = restore_chunk
        pipe._parse_ids = parse_ids

    # -- serving -----------------------------------------------------
    def frames_per_request(self) -> int:
        return self.traffic['chunk'] if self.streams else 1

    def warmup(self) -> None:
        n = self.traffic['warmup_requests']
        if self.streams:
            for _ in self.stream(float('inf'), chunks=n):
                pass
        else:
            for i in range(n):
                self.request(len(self.order) - 1 - i)
        self.rec.clear()
        self.calls = self.current = 0

    def request(self, i: int) -> Tuple[np.ndarray, int]:
        frame = self.clip[self.order[i]]
        out = self.pipe.restore_frames([frame])
        return out[0][None], 1

    def stream(self, deadline: float, chunks: int = None):
        """The clip, cycled in the seed's order, into
        restore_frames_stream until `deadline` (checked at chunk
        boundaries) or `chunks` chunks; yields (chunk index, the chunk's
        host frames (C, H*up, W*up, 3), C)."""
        ck = self.traffic['chunk']

        def source():
            i = 0
            while time.perf_counter() < deadline and \
                    (chunks is None or i < chunks * ck):
                for _ in range(ck):
                    yield self.clip[self.order[i % len(self.order)]]
                    i += 1

        frames, k = [], 0
        for fr in self.pipe.restore_frames_stream(source()):
            frames.append(fr)
            if len(frames) == ck:
                yield k, frames, ck
                frames, k = [], k + 1

    def drop(self, i: int) -> None:
        """Request i will not be checked: let its records go."""
        self.rec.pop(i, None)

    def release(self) -> None:
        self._hook.remove()
        self.kept = {i: {'heads': tuple(t.float().cpu()
                                        for t in r.get('heads', ())),
                         'codes': [c.cpu() for c in r['codes']],
                         'pids': [p.cpu() for p in r['pids']]}
                     for i, r in self.rec.items()}
        del self.pipe, self.rec
        if self.device.type == 'cuda':
            torch.cuda.empty_cache()

    # -- the comparison ----------------------------------------------
    def request_frames(self, i: int) -> List[int]:
        n = self.frames_per_request()
        return [self.order[(i * n + j) % len(self.order)] for j in range(n)]

    @torch.no_grad()
    def check(self, kept) -> Dict[str, float]:
        """Worst reading over the kept requests (benchmark/compare.py and
        PERF.md). The reference makes its own crops (its own similarity
        solves from the traffic's landmarks), restores them, shapes the
        blend masks and pastes on its own. At a near-tied token or pixel
        (top-two margin under compare.WIDE_CODE, WIDE_PARSE) it follows
        the program's code pick or parse id and judges it apart against
        its own logits; elsewhere it takes its own argmax, and the
        program's has to agree.
        - det_rel_rms: the detector's raw heads (boxes, scores,
          landmarks) against the reference's, relative RMS, the worst head;
        - code_gap: as the aligned cells', on the reference's crops;
        - parse_gap: over faces, the mean over a face's pixels of (the
          reference parser's best logit - its logit of the program's id)
          in units of that pixel's logit standard deviation, the parser
          run on the reference's restored faces;
        - parse_wide_miss: over faces, the share of a face's wide pixels
          (top-two margin at least compare.WIDE_PARSE) at which the
          program's id is not the reference's argmax;
        - paste_off: over frames, the share of the pasted faces' pixels
          (weighted by the faces' share of each pixel, the reference's
          blend weights) off by more than compare.OFF_FACE levels;
        - paste_tile_off: the largest such weighted share, past
          compare.OFF_TILE levels, over a tile of a token's patch
          (32 x 32) that the faces cover at least half;
        - background_off: pixels that no face's warp comes within 2 px
          of and that differ at all (exact: the upscaled frame)."""
        from benchmark.reference.codeformer import fp32_math, to_u8, to_unit
        dev = self.device
        cfg = self.cfg
        h, w = self.traffic['frame_hw']
        ref_cf = aligned.reference_model(cfg, 'meta')
        ref_cf.load_state_dict(aligned.seeded_weights(cfg, self.seed, dev),
                               assign=True)
        with torch.device('meta'):
            ref_det, ref_parse = RefRetinaFace(), RefParseNet()
        ref_det.load_state_dict(detector_weights(self.seed, dev, (h, w),
                                                 self.det_hw), assign=True)
        ref_parse.load_state_dict(parser_weights(self.seed, dev),
                                  assign=True)
        for m in (ref_cf, ref_det, ref_parse):
            m.eval()
        marks = landmarks(self.traffic, self.face)
        tpl = TEMPLATE_512 * (self.face / 512.0)
        affines = [rp.similarity(lm, tpl) for lm in marks]
        inv = [rp.inverse_for_paste(a, self.up) for a in affines]
        area = max(self.face ** 2 * abs(np.linalg.det(ia[:, :2]))
                   for ia in inv)
        w_edge = rp.edge_width(area)
        per_face = len(marks)
        n_faces = self.frames_per_request() * per_face
        out = {k: [] for k in ('det_rel_rms', 'code_gap', 'code_wide_miss',
                               'parse_gap', 'parse_wide_miss', 'paste_off',
                               'paste_tile_off', 'background_off',
                               'paste_mean_abs', 'code_gap_max',
                               'code_followed', 'code_miss_margin',
                               'parse_followed', 'parse_miss_margin')}
        pool = torch.nn.functional.avg_pool2d
        tile = token_tile(self.face, cfg['arch']['latent_size'])
        with fp32_math():
            for i, got in kept:
                rec = self.kept[i]
                idx = self.request_frames(i)
                frames = torch.from_numpy(np.stack([self.clip[j]
                                                    for j in idx])).to(dev)
                x_det = detect_input(frames, self.det_hw)
                ref_heads = ref_det(x_det)
                heads = rec['heads']
                if self.quant:   # the control: float8 in the program's place
                    with float8_convs(ref_det):
                        heads = ref_det(x_det)
                out['det_rel_rms'].append(max(
                    (rel_rms(a.to(dev), b) for a, b in zip(heads, ref_heads)),
                    default=float('inf')))
                codes = torch.cat(rec['codes'])[:n_faces].to(dev).long()
                pids = torch.cat(rec['pids'])[:n_faces].to(dev)
                crops = rp.align(frames, [f for f in range(len(idx))
                                          for _ in marks],
                                 affines * len(idx), self.face)
                restored = []
                for s in range(0, n_faces, 4):
                    logits, lq, feats = ref_cf.encode(to_unit(crops[s:s + 4]))
                    cc = codes[s:s + 4]
                    gap = pick_gaps(logits, cc)
                    out['code_gap'] += gap.mean(1).tolist()
                    out['code_gap_max'] += gap.amax(1).tolist()
                    picks, *wide = own_where_wide(logits, cc, WIDE_CODE)
                    for k, v in wide_numbers(*wide, 1).items():
                        out[f'code_{k}'] += v
                    restored.append(to_u8(ref_cf.decode(
                        picks, lq, feats, cfg['w'], cfg['adain'])))
                restored = torch.cat(restored)
                ids = []
                for s in range(0, n_faces, 8):
                    logits = rp.parse_logits(ref_parse, restored[s:s + 8],
                                             cfg['parse_res'])
                    picked = pids[s:s + 8]
                    if self.quant:   # the control: float8 in the parser's place
                        with float8_convs(ref_parse):
                            picked = rp.parse_logits(
                                ref_parse, restored[s:s + 8],
                                cfg['parse_res']).argmax(1)
                    gap = pick_gaps(logits, picked, dim=1)
                    out['parse_gap'] += gap.mean((1, 2)).tolist()
                    own, *wide = own_where_wide(logits, picked, WIDE_PARSE,
                                                dim=1)
                    for k, v in wide_numbers(*wide, (1, 2)).items():
                        out[f'parse_{k}'] += v
                    ids.append(own)
                masks = rp.soft_parse_masks(torch.cat(ids), self.face)
                for f in range(len(idx)):
                    sl = slice(f * per_face, (f + 1) * per_face)
                    ref_frame, share, reach = rp.paste(
                        frames[f], list(restored[sl]), list(masks[sl]), inv,
                        self.up, w_edge)
                    got_f = torch.from_numpy(np.asarray(got[f])).to(dev)
                    diff = (ref_frame.int() - got_f.int()).abs()
                    d = diff.amax(-1).float()     # the worst channel
                    weight = share.sum().clamp_min(1e-6)
                    out['paste_mean_abs'].append(float(
                        (share * diff.float().mean(-1)).sum() / weight))
                    out['paste_off'].append(float(
                        (share * (d > OFF_FACE)).sum() / weight))
                    num = pool((share * (d > OFF_TILE))[None, None], tile,
                               ceil_mode=True)
                    den = pool(share[None, None], tile, ceil_mode=True)
                    tiles = (num / den.clamp_min(1e-6))[den >= 0.5]
                    out['paste_tile_off'].append(
                        float(tiles.max()) if tiles.numel() else 0.0)
                    near = torch.nn.functional.max_pool2d(
                        reach[None, None].float(), 5, 1, 2)[0, 0] > 0
                    out['background_off'].append(float(
                        (d[~near] > 0).sum()))
        return {k: float(max(v)) for k, v in out.items() if v}

    def instrument(self):
        """Host ranges around the pipeline's stages for the traced run:
        the device time each launches (stage_ms) and the idle gaps while
        it runs are charged to it. The stages are the pipeline's private
        methods and the restorer's entry, wrapped on the instances."""
        from benchmark import trace as tr
        pipe = self.pipe
        stages = {'_detect_start': 'detect', '_warp': 'warp',
                  '_parse_ids': 'parse', '_composite': 'composite'}

        def wrap(fn, name):
            def spanned(*a, **kw):
                with tr.span(f'stage.{name}'):
                    return fn(*a, **kw)
            return spanned
        for attr, name in stages.items():
            setattr(pipe, attr, wrap(getattr(pipe, attr), name))
        r = pipe.restorer
        r.restore_device = wrap(r.restore_device, 'restore')

    def trace_facts(self) -> Dict:
        """FLOPs a frame: the detector on the frame, the restorer and
        ParseNet on its faces (the references' shapes)."""
        from benchmark import roofline
        cf = aligned.reference_model(self.cfg, 'meta')
        size = self.cfg['arch']['img_size']
        pr = self.cfg['parse_res']
        n_faces = len(landmarks(self.traffic, self.face))
        with torch.device('meta'):
            det, parse = RefRetinaFace(), RefParseNet()
        hb, wb = (-(-d // 64) * 64 for d in self.det_hw)
        flops = (roofline.flops(lambda: det(torch.empty(
                     1, 3, hb, wb, device='meta')))
                 + n_faces * roofline.forward_flops(cf, 1, size,
                                                     self.cfg['w'])
                 + n_faces * roofline.flops(lambda: parse(torch.empty(
                     1, 3, pr, pr, device='meta'))))
        return {'flops_per_unit': flops, 'forwards_per_request': 0,
                'k1_s': 0.0, 'k2_s': 0.0}


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    d = (got.float() - ref.float()).pow(2).mean().sqrt()
    return float(d / ref.float().pow(2).mean().sqrt().clamp_min(1e-12))
