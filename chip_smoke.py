#!/usr/bin/env python3
"""On-card smoke run of the PyTorch port (codeformer_tpu_torch).

    python3 chip_smoke.py            # one GPU; a few minutes on an H100
    python3 chip_smoke.py --profile  # plus torch.profiler breakdowns of a
                                     # serving forward, the whole-image
                                     # path and a training step

Phases, in order; any failure raises and the script exits non-zero:
  1. card and versions (needs a CUDA card of compute capability 9.0);
  2. build the hand-written kernels from codeformer_tpu_torch/csrc/;
  3. K1/K2 against their plain PyTorch versions at the serving path's
     shapes (B=2, bf16 inputs; reference in fp32 with TF32 off; K1 also
     at B=1 and B=8 on its largest and its widest map, K2 at a ragged
     map and the serving batch), K1's GroupNorm partials slot by slot
     against the exact sums of its rounded output, planted faults that
     the bounds must reject, each shape's plan and bound, and kernel
     (the launch on prepared operands), whole-call, plain and library
     times (for K1 the library call is a cuDNN conv of the same shape,
     the conv alone);
  3b. the stage-entry statistics (entry_stats: [sum, sumsq] a channel
     in one read of the map, in slots) at every entry map of a forward at
     B=16, the timed maps at B=1 and a ragged map: every slot against the
     exact sums, planted faults that must fail (a slot left unwritten, a
     thread's last pixels dropped, channels shifted by 8), kernel,
     whole-call and torch channel_stats times against the bytes bound,
     and a forward's statistics per face;
  4. K3 (nearest code) against its plain version at the token counts of
     stage II and latent-GT generation, on four codebooks (K = 1024 and
     512; exact lowest index on duplicated rows), z in fp32 and bf16, a
     call after an in-place change of the codebook, planted faults that
     must fail at every T, one device activity a call on a kept codebook
     (torch.profiler), kernel, whole-call, plain and fp32-product times;
  4b. the ops layer: K4 (fused_leaky_relu forward and backward) and the
     bare conv conv3x3_bias (the counterpart of K1', K5, K6) against
     their plain versions, planted faults that must fail, gradients and
     gradients of gradients through the K4 kernels against the plain
     path, kernel, plain and library-call times; then the ops path (conv3x3_bias ->
     fused_leaky_relu forward and backward at 16 x 512^2 x 64 bf16) with
     exact launch counts;
  4c. RRDBNet's dense conv (conv3x3_dense: a channel prefix of a
     192-channel workspace in, a channel slice out, the LeakyReLU and
     residuals in its epilogue) at the five shapes of a dense block and
     conv_body's, B=16 at 240^2 and a ragged map, against its plain
     version (the bytes outside the slice untouched, planted faults that
     must fail), each shape's plan and bound, and kernel, whole-call,
     plain and library (concatenation + cuDNN conv) times;
  5. serving: the full-width CodeFormerRestorer on the card with seeded
     random weights: a few requests, exact kernel launch counts, a
     reference forward with both ops patched to their plain versions
     (and with planted faults, which must fall outside the bounds), and
     faces/s of the kernel path and of the plain path over multi-second
     windows;
  5b. the whole-image path (DeviceRestorePipeline: RetinaFace resnet50
     and ParseNet in bf16, the serving restorer) on 32 seeded frames of
     512x683 in chunks of 16, upscale 2, as bench.py's end-to-end
     workload: the bf16 detector against fp32 on one chunk (and a shifted
     anchor level, which must fail); the pipeline with K1/K2 on their
     kernels against their plain versions (frames inside the face windows
     within a bound, bit-identical outside, the restored crops equal to
     restore_device on the same crops in runs of the restorer's top
     bucket, every K1/K2 call on the crops' own activations within the
     per-call bound, a planted K1 halo fault failing it); exact launch
     counts a chunk at 1 and 4 faces a frame (a forward a run of 16)
     (the detections handed on are injected at bench.py's offsets while
     the detector's device graph runs on every chunk); frames/s at 1 and
     4 faces a frame and in folder mode, kernel and plain paths in
     alternating windows; peak memory; with --profile the device time of
     each stage and the busy share;
  5c. the classic per-stage path's device stages (a 512x683 frame, canvas
     1024x1366, 1 and 4 faces at bench.py's offsets): the crops through
     restore_batch with exact launch counts, `_parse_masks` in fp32
     against a CPU copy, `paste_faces` with use_parse and draw_box on and
     off against the same call on CPU copies (inside the face windows
     within a bound, outside bit-identical to the canvas; an inverse
     affine shifted by one pixel must fail), ms a frame and peak memory;
  5f. Real-ESRGAN: set_realesrgan's x2 upsampler (RRDBNet x2plus, bf16,
     tiles of 400 with a pad of 40, 4 a batch; seeded weights, tamed so
     the output spans levels) on a 512x683 frame and a 512^2 face against
     the same calls in fp32 (a seam one pixel off and a dense block
     without its residual scale must fail; the bf16 calls run the trunk
     on the dense conv), tiled against whole at 320^2,
     ms a call, tiles/s, peak memory;
  5g. the classic path with both upsamplers (5c's frame, 1 and 4 faces):
     restore_batch with exact launches, each face upsampled to 1024 and
     the frame to 1024x1366, paste_faces with the upsampler's inverse
     affines on the card against CPU copies (an affine 1 px off must
     fail), ms a frame and its split between restore, upsample and
     parse + paste;
  5h. YOLOv5n and YOLOv5l (seeded, fp32) on a 512x683 frame: raw
     predictions and detect_faces against CPU copies (a BatchNorm
     epsilon and reversed anchors must fail), ms a frame;
  5i. BiSeNet (seeded, fp32) at 512^2, B=1 and 4, against a CPU copy, ms;
  5d. the colorization and inpainting models (codebook 1024 / 512,
     connect 32/64/128, w=0 with AdaIN / w=1 without) at full width:
     exact launch counts through restore_batch, inpainting's white-mask
     composite keeping every other pixel, the whole forward against the
     plain path with the codes held, every K1/K2 call of one forward on
     its own activations, a planted K1 halo fault failing both checks,
     faces/s at B=1 and 8;
  5e. VQAutoEncoder.forward at full width, B=2: exact launches (K1, K2,
     one K3), the reconstruction against the plain path with the codes
     held, one device activity for its K3 call (checked at the end);
  6. training: stage II (CodeFormerIdxModel) at the full width of
     options/CodeFormer_stage2.yml, bf16, B=4: 8 steps with exact launch
     counts (K1/K2/K3 in the frozen HQ encode only), a falling loss,
     gradients at the encoder, frozen modules unchanged; idx_gt against
     the plain-op encode (and a planted fault); training faces/s of the
     kernel and plain paths; peak memory;
  6b. training, stage I (VQGANModel) at the full width of
     options/VQGAN_512_ds32_nearest_stage1.yml, bf16, B=4, LPIPS on seeded
     VGG16/lin stand-ins written to a temporary directory: iterations
     30000-30004 either side of net_d_start_iter 30001 with exact launch
     counts (one K3 a step), the discriminator, its Adam and its BatchNorm
     statistics untouched before the gate and stepping after it, every
     step's K3 picks against the plain search, faces/s and peak memory;
     then one fp32 step at 128^2 on the card against the same step on the
     host (losses, d_weight, gradients) and a planted train-mode g step
     that must fail;
  6c. training, stage III (CodeFormerJointModel) at the full width of
     options/CodeFormer_stage3.yml, bf16, B=3 (net_d_iters 2): a code, a
     d-only and a full step with exact launch counts (K1/K2/K3 in the
     frozen HQ encode only), frozen modules unchanged, idx_gt against the
     plain-op encode (and a planted fault), faces/s of the full and code
     steps, peak memory; then one CodeFormerModel step of
     options/CodeFormer_inpainting.yml;
  6d. validation and the prefetcher, on the stage-II trainer of 6:
     BaseTrainer.validation over 4 seeded 512^2 pairs (SFT tamed, EMA
     weights), PSNR/SSIM computed on the card and held to the host copy
     of each image pair; the stage-II rate fed by a host thread of numpy
     batches directly and through DevicePrefetcher (batches equal);
  7a. remat: stage I (B=4) and stage III's full step (B=3) built with and
     without `remat: true`, launches a step unchanged, faces/s and peak
     memory; an fp32 128^2 stage-I step with and without remat, the
     gradients within 1e-6;
  7b. generate_latent_gt's core at full width: 16 seeded faces and their
     flips at batch 8 (T = 2048), fp32 and bf16, K3 picks against the
     plain search, bf16 against fp32, images/s, exact launches;
  7c. data parallelism at world size 1 over NCCL (init_dist as
     `--launcher pytorch` starts it): a stage-II and a stage-I step past
     the gate against the plain trainer's steps (gradients, d_weight,
     BatchNorm statistics within 1e-6; launches equal);
  7d. SRModel (RRDBNet at x2plus width, fp32, B=4): 3 steps, a falling
     loss, ms a step; 7e. ResNetArcFace (B=8, fp32) card vs host, ms.
After serving (5), the last serving features at full width:
  5j. --dtype fp32: the restorer serves the plain path (no K1/K2) with
     TF32 off inside the call and the caller's flags back after it; its
     forward against the same model on the host (B=2, codes held), the
     forward with TF32 left on failing the bound; faces/s at B=1 and 8;
  5k. --quant int8: every int8 conv shape of a forward (conv_in, the
     ResBlock convs, the Downsamples, the four Upsample phases, conv_out)
     with its int32 product equal to the host's on the same int8
     operands; the B=8 forward with no K1/K2 and the expected _int_mm
     calls; code agreement and generator PSNR against the bf16 kernel
     path (JAX's budgets); int8 and bf16 faces/s at B=1, 8, 16 and peak
     memory; one 512^2 int8 conv against cuDNN bf16;
  5l. CodeFormerRestorer(devices=['cuda:0']) bit-equal to the one-device
     restorer at B=8 (one card: no two-card reading);
and after 5e, inference_vqgan's core `reconstruct` at B=4 in bf16 with
exact launches (K1, K2, one K3), against the plain path with the codes
held, images/s at fp32 and bf16. Last, after training, the serving
CLIs on the repo's files (`phase_cli_files`): every inputs/ file's cv2
decode against the sha256 recorded with the tests
(tests/torch_inputs_digests.json); `main(argv)` of the aligned CLI on
inputs/cropped_faces (its faces bit-equal to restore_batch in process,
exact K1/K2 launches, its images/s split into read, restore and write),
of the whole-image CLI's fused route on each whole_imgs/ image and on
the cropped faces as whole images (about 160 faces a chunk, restored in
runs of 8; its peak memory under a bound that the same run restoring
each chunk in one call must fail), of colorization, inpainting and
inference_vqgan --dtype bf16 (K3 once a batch, exact launches); and the
documented aligned command as a subprocess, which must exit 0. Then
(`phase_files_more`) the whole-image CLI's classic route on
inputs/whole_imgs and a gray image with --fused_pipeline off, the
Real-ESRGAN upsamplers, YOLOv5n and --draw_box (restored faces
bit-equal to restore_batch on the run's own crops, exact launches,
images/s by stage); a 48-frame mp4v clip through the CLI on both routes
(the frames handed to the writer bit-equal to the same pipeline in
process, the video reopened, frames/s); crop_align_face (crops
bit-equal to align_crop_face_landmarks in process). Last
(`phase_train_files`), the three training stages from 16 seeded 512^2
PNGs at the ymls' widths and batches in bf16, each from the files the
stage before it wrote: stage I through train_pipeline in process (the
discriminator gate inside the run, saves at half of it, one K3 a step,
its net_g's K3 picks against the plain search), generate_latent_gt
--dtype bf16 with its net_g (exact K1/K2/K3), stage II as a subprocess
(training faces/s with the loader and its data wait, the datasets
held to the native degradation kernel), stage III in process from stage II's net_g and
stage I's net_d and VQGAN (exact K1/K2/K3 a step, frozen modules
bit-equal to what it loaded), a resume in process (state bit-equal, the
next step bit-equal, a planted unrestored Adam moment failing both) and
as a subprocess from the save at half the run, colorization and
inpainting through train_pipeline (a loader batch of each against its
dataset's contract), stage II under torch.distributed.run over NCCL,
the aligned CLI serving stage III's net_g (bit-equal to restore_batch of
a restorer loaded in process from the file) and the web demos (bit-equal
to the whole-image CLI's classic route with the same restorer, helper
and upsampler).
Every time is per launch: runs of back-to-back launches between two
CUDA events (`time_ms`), the median run. The last line is the JSON
result; the line before it lists the kernels, each with its launches on
the main paths, its time (the launch on prepared operands; the whole
call's time, `call_ms`, is printed on an earlier line), its plain version's,
the least time the card could take for the same work (bound_ms) and,
where one PyTorch call computes the same function, that call's time.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from unittest import mock

import numpy as np
import torch

from codeformer_tpu_torch.kernels.build import launch_counts, reset_launch_counts

ROOT = os.path.dirname(os.path.abspath(__file__))
T_START = time.perf_counter()

# Bounds, each a few times the largest sound reading on an H100 (PERF.md,
# Findings PR 1), each checked against planted faults that must FAIL it.
# Kernel vs plain version: both round act(a*x+b), the weights and y to
# bf16 and sum in fp32, so they differ only where summation order or
# __expf flips a rounding: rel RMS up to 1.92e-4 over 34 shapes. A bf16
# prologue reads >= 3.0e-3 and a halo of act(b) >= 5.7e-3. The same
# bound holds every kernel call of one forward on its own inputs.
REL_RMS_BOUND = 1e-3
# K1's statistics slot by slot against the exact sums of its own rounded
# y over the slot's tile (128 or 256 pixels), relative to sum |y| and sum
# y^2: fp32 sums of at most 256 terms stay near 1e-7, while the
# statistics of the y before its rounding (half a bf16 ulp a term, random
# signs) are off by several times the bound in the worst slot of every
# call (PERF.md, Findings)
STATS_BOUND = 1e-4
# the stage-entry statistics (entry_stats) are held slot by slot to the
# same bound: their grouped fp32 sums of up to 7,944 pixels a slot read
# 1.1e-7 to 2.1e-7 on an H100 (PERF.md, Findings); a slot left
# unwritten, a thread's last pixels dropped and channels shifted by 8 read
# 4e-3 and up
CALL_BOUNDS = {'conv3x3_dots': REL_RMS_BOUND, 'downsample_dots':
               REL_RMS_BOUND, 'channel_stats': STATS_BOUND}
# whole model, kernel path vs plain-op reference forward: lq_feat and
# logits rel RMS read 0.0089 and 0.011 (rounding flips compound over 60
# convs), code-index agreement 0.9746 (random weights give 1024 close
# logits a token, so a few argmax picks flip; trained weights are peaked),
# mean image difference 1.24 levels. A halo of act(b) reads 3.14 levels.
SLICE_REL_BOUND = 2e-2
INDEX_AGREEMENT_FLOOR = 0.95
IMAGE_DIFF_BOUND = 2.5    # uint8 levels, mean |diff| of the restored images
# random-weight SFT branches are scaled down so activations stay finite
# (see tame_sft); the restored image must then be far from constant
SFT_SCALE = 1e-2
MIN_IMAGE_STD = 5.0       # uint8 levels
# throughput windows: each at least this long, repeated per path
RATE_WINDOW_S = 3.0
RATE_REPEATS = 3

# every (resolution, Cin, Cout, act, skip) a full-width forward gives K1:
# a ResBlock(cin, cout) runs conv1 cin->cout without skip and conv2
# cout->cout with the identity or the projected (Cs = cin) skip; the
# decoder tail is 64->3 without activation
K1_SHAPES = [  # (H=W, Cin, Cout, act, skip, Cs)
    (512, 64, 64, 'silu', 'identity', 0),
    (512, 64, 64, 'silu', 'none', 0),
    (512, 64, 64, 'silu', 'proj', 128),
    (512, 128, 64, 'silu', 'none', 0),
    (512, 64, 3, 'none', 'none', 0),
    (256, 64, 128, 'silu', 'none', 0),
    (256, 128, 128, 'silu', 'identity', 0),
    (256, 128, 128, 'silu', 'none', 0),
    (256, 128, 128, 'silu', 'proj', 64),
    (256, 128, 128, 'silu', 'proj', 256),
    (256, 256, 128, 'silu', 'none', 0),
    (128, 128, 128, 'silu', 'identity', 0),
    (128, 128, 128, 'silu', 'none', 0),
    (128, 128, 128, 'silu', 'proj', 256),
    (128, 256, 128, 'silu', 'none', 0),
    (64, 128, 256, 'silu', 'none', 0),
    (64, 256, 256, 'silu', 'identity', 0),
    (64, 256, 256, 'silu', 'none', 0),
    (64, 256, 256, 'silu', 'proj', 128),
    (64, 256, 256, 'silu', 'proj', 512),
    (64, 512, 256, 'silu', 'none', 0),
    (32, 256, 256, 'silu', 'identity', 0),
    (32, 256, 256, 'silu', 'none', 0),
    (32, 256, 256, 'silu', 'proj', 512),
    (32, 512, 256, 'silu', 'none', 0),
    (16, 256, 512, 'silu', 'none', 0),
    (16, 512, 512, 'silu', 'identity', 0),
    (16, 512, 512, 'silu', 'none', 0),
    (16, 512, 512, 'silu', 'proj', 256),
]
BATCH = 2
# (B, H=W, Cin, Cout, act, skip, Cs): every shape at the forward's B=2,
# then the largest and the widest map at B = 1 and the serving batch 8
K1_CASES = [(BATCH, *c) for c in K1_SHAPES] + [
    (bsz, *c) for bsz in (1, 8) for c in (K1_SHAPES[0], K1_SHAPES[-1])]
K2_CASES = [  # (B, H=W, C): the forward's five at B=2, a map ragged
    # against the tile, and the serving batch
    (BATCH, 512, 64), (BATCH, 256, 128), (BATCH, 128, 128), (BATCH, 64, 256),
    (BATCH, 32, 256), (BATCH, 72, 128), (8, 512, 64)]
# the stage-entry statistics (ops/conv3x3.py entry_stats,
# csrc/channel_stats.cu): every entry map of a serving forward, (H=W, C,
# entries a forward; 33 in all), from 16^2 x 512 to 512^2 x 128
STATS_ENTRY_SHAPES = (
    (512, 64, 4), (512, 128, 1), (256, 64, 1), (256, 128, 3), (256, 256, 1),
    (128, 128, 3), (128, 256, 2), (64, 128, 1), (64, 256, 3), (64, 512, 1),
    (32, 256, 3), (32, 512, 2), (16, 256, 1), (16, 512, 7))
# (B, H, W, C): the timed maps at B = 16 and 1, the 512^2 x 128 first (the
# kernels line's row), every other entry map at B = 16, and one ragged
# against the slots whose threads have pixels left after their groups of
# four (the kernel's ragged tail)
STATS_TIMED = ((16, 512, 512, 128), (1, 512, 512, 128), (16, 512, 512, 64),
               (1, 512, 512, 64), (16, 256, 256, 256), (1, 256, 256, 256))
STATS_CASES = STATS_TIMED + tuple(
    (16, h, h, c) for h, c, _ in STATS_ENTRY_SHAPES
    if (16, h, h, c) not in STATS_TIMED) + ((3, 37, 53, 96),)
STATS_FAULTS = ('skipped slot', 'ragged tail dropped',
                'channels shifted by 8')


def card_line() -> str:
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


class Timing(float):
    """A per-launch time in ms (the median run), with the runs' spread."""

    def __new__(cls, runs):
        t = super().__new__(cls, statistics.median(runs))
        t.lo, t.hi = min(runs), max(runs)
        return t

    def spread(self) -> str:
        return f'[{self.lo:.4f}, {self.hi:.4f}]'


def time_ms(fn, iters: int = 20, runs: int = 5, warmup: int = 3) -> Timing:
    """Per-launch CUDA-event time of fn() in ms: `runs` runs of `iters`
    back-to-back calls, one event pair around each run, the elapsed time
    over `iters`; the median run, with the spread. One pair around a
    single small call times the host's launch work, not the card.
    Back-to-back calls at the small shapes find their inputs in L2, as
    on the main path, where the previous layer has just written them."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return Timing(times)


def rel_rms(got: torch.Tensor, ref: torch.Tensor) -> float:
    d = (got.float() - ref.float()).pow(2).mean().sqrt()
    return float(d / ref.float().pow(2).mean().sqrt().clamp_min(1e-12))


def k1_fault(kind: str):
    """A deliberately wrong plain K1 with conv3x3_dots_ref's signature, as
    a control the bounds must catch. It returns (y, stats), the stats in
    the kernel's slot layout for a tile of `th` rows (`th=None`: one slot
    an image, as the plain version):
      'bf16 prologue'       a*x+b and the activation in bf16 arithmetic;
      'halo act(b)'         the activated map padded with act(b), not 0
                            (TMA's zero fill, activated without masking);
      'chunk unrewritten'   the last 64-channel chunk's windows read as
                            staged: raw x, the prologue skipped;
      'prologue on skip'    the projected skip's raw chunks rewritten as
                            if they were x's: bf16(act(a*s+b)), with the
                            a, b of channel (k mod Cin);
      'skip dropped'        no skip added;
      'stats of unrounded y' the right y, the statistics of the fp32 sum
                            before its rounding.
    None where the fault has nothing to act on (no skip, no projection)."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv

    def run(x, a, b, act, weight, bias, skip=None, w1x1=None, th=None):
        if (kind == 'skip dropped' and skip is None) or \
                (kind == 'prologue on skip' and w1x1 is None):
            return None

        def f(t):
            return F.silu(t) if act == 'silu' else t
        a4, b4 = a[:, None, None], b[:, None, None]
        dt = x.dtype
        if kind == 'bf16 prologue':
            h = f(x * a4.to(dt) + b4.to(dt)).float()
        else:
            h = f(x.float() * a4 + b4).to(dt).float()
        if kind == 'chunk unrewritten':
            lo = (x.shape[-1] - 1) // cv.SM90_KC * cv.SM90_KC
            h[..., lo:] = x[..., lo:].float()
        h = F.pad(h.permute(0, 3, 1, 2), (1, 1, 1, 1))
        if kind == 'halo act(b)':
            inner = h[:, :, 1:-1, 1:-1].clone()
            h = f(b).to(dt).float()[:, :, None, None].expand_as(h).clone()
            h[:, :, 1:-1, 1:-1] = inner
        y = F.conv2d(h, weight.to(dt).float(), bias.float())
        y = y.permute(0, 2, 3, 1)
        if skip is not None and kind != 'skip dropped':
            s = skip.float()
            if w1x1 is not None:
                if kind == 'prologue on skip':
                    k = torch.arange(s.shape[-1], device=s.device) % a.shape[1]
                    s = f(s * a[:, None, None, k] + b[:, None, None, k]) \
                        .to(dt).float()
                s = s @ w1x1.reshape(w1x1.shape[0], -1).to(dt).float().t()
            y = y + s
        yr = y.to(dt)
        st = k1_slot_sums(y if kind == 'stats of unrounded y' else yr, th)[0]
        return yr, st.float()
    return run


def k1_slot_sums(y: torch.Tensor, th=None):
    """([sum y, sum y^2], [sum |y|, sum y^2]) in fp64 over each tile of th
    x 16 pixels (the kernel's statistics slots, ops/conv3x3.py
    stats_slots), or over each image (th None): (B, slots, 2, C) each."""
    import torch.nn.functional as F
    bsz, h, w, c = y.shape
    th, tw = (th, 16) if th else (h, w)
    ty, tx = -(-h // th), -(-w // tw)
    v = F.pad(y.double(), (0, 0, 0, tx * tw - w, 0, ty * th - h)) \
        .reshape(bsz, ty, th, tx, tw, c)
    s1, s2, s_abs = (t.sum((2, 4)).reshape(bsz, ty * tx, c)
                     for t in (v, v.square(), v.abs()))
    return torch.stack([s1, s2], 2), torch.stack([s_abs, s2], 2)


def k1_stats_err(st: torch.Tensor, y: torch.Tensor, th: int) -> float:
    """The worst statistics slot and channel: |stats - the exact (fp64)
    sums of the rounded y over the slot's tile| relative to sum |y| (for
    the sum) or sum y^2 (for the sum of squares)."""
    exact, scale = k1_slot_sums(y, th)
    return float(((st.double() - exact).abs()
                  / scale.clamp_min(1e-30)).max())


def stats_errors(st: torch.Tensor, x: torch.Tensor) -> tuple:
    """(relative, absolute) error of the worst slot and channel of
    statistics `st` (B, slots, 2, C) of the map x against the exact
    (fp64) sums over each slot: |st - exact| relative to sum |x| (for the
    sum) or sum x^2 (for the sum of squares), and its largest absolute
    value. One slot is the whole map (channel_stats); more are
    stats_slot_plan's. Another layout reads (inf, inf)."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    bsz, h, w, c = x.shape
    n = h * w if st.shape[1] == 1 else cv.stats_slot_plan(
        bsz, h * w, c, cv._num_sms(x.device.index or 0))[1]
    exact, scale = stats_slot_sums(x, n)
    if exact.shape != st.shape:
        return math.inf, math.inf
    d = (st.double() - exact).abs()
    return float((d / scale.clamp_min(1e-30)).max()), float(d.max())


def stats_slot_sums(x: torch.Tensor, n: int):
    """([sum x, sum x^2], [sum |x|, sum x^2]) in fp64 over each slot of n
    pixels of each image of x (B, H, W, C), the last slot ragged: (B,
    ceil(H W / n), 2, C) each."""
    import torch.nn.functional as F
    bsz, h, w, c = x.shape
    hw = h * w
    slots = -(-hw // n)
    sums, scales = [], []
    for img in x.reshape(bsz, hw, c):      # an image at a time: fp64 copies
        v = F.pad(img.double(), (0, 0, 0, slots * n - hw)) \
            .reshape(slots, n, c)
        sq = v.square().sum(1)
        sums.append(torch.stack([v.sum(1), sq], 1))
        scales.append(torch.stack([v.abs().sum(1), sq], 1))
    return torch.stack(sums), torch.stack(scales)


def stats_planted(kind: str):
    """A deliberately wrong entry_stats, as a control the bounds must
    catch: what the kernel would write with the fault.
      'skipped slot'           the middle slot of each image never
                               written (left zero);
      'ragged tail dropped'    the pixels each thread has left after its
                               groups of four (csrc/channel_stats.cu) not
                               read;
      'channels shifted by 8'  every thread's sums written 8 channels on
                               (the last 8 wrapped round to the first).
    None where the fault has nothing to act on (no thread has a tail)."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    kernel = cv.entry_stats      # the kernel, not a stand-in patched later

    def run(x):
        if kind == 'skipped slot':
            st = kernel(x).clone()
            st[:, st.shape[1] // 2] = 0
            return st
        if kind == 'channels shifted by 8':
            return kernel(x).roll(8, -1)
        if kind != 'ragged tail dropped':
            raise ValueError(kind)
        bsz, h, w, c = x.shape
        hw = h * w
        n = cv.stats_slot_plan(bsz, hw, c,
                               cv._num_sms(x.device.index or 0))[1]
        rows = cv.STATS_THREADS // (c // 8)      # pixels a block step
        p = torch.arange(hw, device=x.device)
        i = p % n                                # its place in its slot
        length = (hw - (p - i)).clamp(max=n)     # its slot's pixels
        r = i % rows                             # the thread row reading it
        mine = (length - r + rows - 1) // rows   # that row's pixels
        keep = i // rows < mine // 4 * 4
        if bool(keep.all()):
            return None
        return kernel(x * keep.view(1, h, w, 1).to(x.dtype))
    return run


def k2_fault(x, weight, bias):
    """A deliberately wrong plain K2: PyTorch's symmetric padding=1 in
    place of the reference's (0,1,0,1)."""
    import torch.nn.functional as F
    y = F.conv2d(x.float().permute(0, 3, 1, 2), weight.to(x.dtype).float(),
                 bias.float(), stride=2, padding=1)
    return y.permute(0, 2, 3, 1).to(x.dtype)


def k2_planted(kind: str):
    """Planted faults of K2, each with downsample_dots_ref's signature:
    'symmetric pad' (k2_fault); 'pad top-left', the zero row and column
    on the top and left instead of the bottom and right; 'tap off by one',
    the centre tap reads (2y+1, 2x+2) instead of (2y+1, 2x+1);
    'split partial dropped', the fp32 partial of the plan's last split
    left out of the sum (None where the plan does not split)."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv

    def run(x, weight, bias):
        xn = x.float().permute(0, 3, 1, 2)
        wf, bf = weight.to(x.dtype).float(), bias.float()
        if kind == 'symmetric pad':
            return k2_fault(x, weight, bias)
        if kind == 'pad top-left':
            y = F.conv2d(F.pad(xn, (1, 0, 1, 0)), wf, bf, stride=2)
        elif kind == 'tap off by one':
            centre = torch.zeros_like(wf)
            centre[:, :, 1, 1] = wf[:, :, 1, 1]
            shifted = F.pad(xn[..., 1:], (0, 2, 0, 1))
            y = F.conv2d(F.pad(xn, (0, 1, 0, 1)), wf - centre, bf, stride=2) \
                + F.conv2d(shifted, centre, stride=2)
        elif kind == 'split partial dropped':
            p = cv.conv_plan(*x.shape, x.shape[-1], 2)
            if p.split == 1:
                return None
            lo = (p.split - 1) * (p.chunks // p.split) * cv.SM90_KC
            xd = x.clone()
            xd[..., lo:] = 0
            return cv.downsample_dots_ref(xd, weight, bias)
        else:
            raise ValueError(kind)
        return y.permute(0, 2, 3, 1).to(x.dtype)
    return run


def takes_prepared(fn):
    """fn as a stand-in for cv.conv3x3_dots or cv.downsample_dots, whose
    callers may hand them kept operands (`prepared`): fn ignores them."""
    def run(*args, prepared=None, **kw):
        return fn(*args, **kw)
    return run


K1_FAULTS = ('bf16 prologue', 'halo act(b)', 'chunk unrewritten',
             'prologue on skip', 'skip dropped', 'stats of unrounded y')
# the faults the per-call check of a whole forward runs
K1_MODEL_FAULTS = ('bf16 prologue', 'halo act(b)')
K2_FAULTS = ('symmetric pad', 'pad top-left', 'tap off by one',
             'split partial dropped')

# K3 (nearest code): tokens at the stage-II shape (B*256 for B = 1, 4,
# 16), generate_latent_gt at its default batch of 8 (2048) and a large
# run; D of every shipped config; K = 1024 (restoration, colorization,
# stage II) and 512 (the inpainting codebook)
K3_TOKENS = (256, 1024, 2048, 4096, 16384)
K3_DIM, K3_CODES = 256, 1024
K3_PATH_TOKENS = 1024     # stage II at batch_size_per_gpu 4
# Kernel and plain version sum the same fp32 products in other orders, so
# they may pick different codes only where two distances are within fp32
# rounding. Every disagreement must pick a code whose exact (fp64)
# squared distance is within this relative margin of the exact minimum.
K3_MARGIN = 1e-5
K3_FAULTS = ('ties to the highest index', 'e_sq dropped',
             'a cluster rank dropped', 'stale cache')


def k3_fault(kind: str):
    """A deliberately wrong plain K3 with nearest_code_indices' signature,
    as a control the K3 checks must catch."""
    from codeformer_tpu_torch.ops import vq

    def run(z, e):
        z = z.float()
        with vq._fp32_matmul():
            dot = z @ e.t()
        d = e.square().sum(1)[None] - 2.0 * dot
        if kind == 'ties to the highest index':
            return e.shape[0] - 1 - d.flip(1).argmin(1)
        if kind == 'e_sq dropped':
            return (-2.0 * dot).argmin(1)
        if kind == 'a cluster rank dropped':
            # the codes of the last rank of the kernel's cluster never
            # reach rank 0 (with a cluster of 1, those of a second rank)
            cs = max(2, vq.prepare_nearest_code(z, e).plan.cluster)
            tile = torch.arange(e.shape[0], device=e.device) \
                // vq.K3_CODES_PER_TILE
            lost = tile % cs == cs - 1
            return d.masked_fill(lost[None], float('inf')).argmin(1)
        raise ValueError(kind)
    return run


def k3_after_change(z, e, stale: bool):
    """K3 on a copy of e, then again after the copy is negated in place
    (as an optimizer step would update it): (second result, the changed
    codebook). With `stale` the operand cache's key leaves out the
    tensor's version, so the second call reads the kept operands of the
    old codebook: a fault the check on the new one must catch."""
    from codeformer_tpu_torch.ops import vq
    e = e.clone()
    key = (lambda c: (c.data_ptr(), c.device, c.dtype, tuple(c.shape))) \
        if stale else vq.codebook_key
    with mock.patch.object(vq, 'codebook_key', key):
        vq.nearest_code_indices(z, e)
        e.mul_(-1.0)
        return vq.nearest_code_indices(z, e), e


def k3_codebooks(g):
    """{name: (K, D) fp32}: the init scale (uniform +-1/K, the random-init
    codebook of the training path), a unit-scale one, one whose 1024 rows
    are 256 distinct rows each repeated 4 times at scattered places (exact
    ties), and the inpainting config's K = 512 at unit scale."""
    k, d = K3_CODES, K3_DIM
    base = torch.randn(k // 4, d, generator=g, device='cuda')
    dup_of = torch.randperm(k, generator=g, device='cuda') % (k // 4)
    return {'init scale': (torch.rand(k, d, generator=g, device='cuda')
                           * 2 - 1) / k,
            'unit scale': torch.randn(k, d, generator=g, device='cuda'),
            'duplicated rows': base[dup_of].contiguous(),
            'K=512': torch.randn(512, d, generator=g, device='cuda')}, dup_of


def k3_verdict(got, ref, z, e, dup_of=None) -> dict:
    """Hold indices `got` against the plain version's `ref`: agreement,
    the worst relative fp64 gap of a disagreement (must be <= K3_MARGIN),
    the largest absolute fp64 distance gap, and, on a codebook with
    duplicated rows, whether every pick is the lowest index of its row."""
    z64, e64 = z.double(), e.double()
    dist = (z64.square().sum(1, keepdim=True) + e64.square().sum(1)[None]
            - 2.0 * z64 @ e64.t())
    dmin = dist.min(1).values
    d_got = dist.gather(1, got[:, None])[:, 0]
    d_ref = dist.gather(1, ref[:, None])[:, 0]
    off = got != ref
    gap = (d_got - dmin) / dmin.abs().clamp_min(1e-30)
    r = dict(agree=float((~off).float().mean()),
             worst_gap=float(gap[off].max()) if bool(off.any()) else 0.0,
             max_abs=float((d_got - d_ref).abs().max()), lowest=True)
    if dup_of is not None:
        first = torch.full((int(dup_of.max()) + 1,), e.shape[0],
                           device=e.device, dtype=torch.int64)
        first.scatter_reduce_(0, dup_of, torch.arange(
            e.shape[0], device=e.device), reduce='amin')
        r['lowest'] = bool((got == first[dup_of[got]]).all())
    r['ok'] = r['worst_gap'] <= K3_MARGIN and r['lowest']
    return r


def device_launches(fn, name: str = 'nearest_code', iters: int = 20):
    """(device activities a launch of the kernel whose name holds `name`,
    ms a launch of it) of fn() from torch.profiler over `iters` calls
    after a warm-up: kernels, copies and sets, each counted, over the
    kernel's own launches. A profiler session after an earlier one in the
    same process may miss the first few calls, so the count is taken per
    launch seen, not per call made."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type != torch.autograd.DeviceType.CPU]
    seen = sum(e.count for e in rows if name in e.key)
    if not seen:
        raise SystemExit(f'chip_smoke: the profiler saw no {name} launch')
    return (sum(e.count for e in rows) / seen,
            sum(e.device_time_total for e in rows if name in e.key)
            / seen / 1e3)


def phase_k3():
    """K3 against its plain version (fp32, TF32 off) at the token counts
    of K3_TOKENS on four codebooks, with z in fp32 and in bf16; the
    operand cache after an in-place change; planted faults that must fail
    at every T; the launch on a prepared call, the whole call, the plain
    version and the fp32 product alone (TF32 off) timed with CUDA events.
    Returns the rows of the init-scale codebook and the timed calls, whose
    device activities `phase_k3_activities` counts after the main paths
    (a profiler session leaves the host's launches slower for the rest
    of the process, and the serving and training rates are host-bound)."""
    from codeformer_tpu_torch.ops import vq
    g = torch.Generator(device='cuda').manual_seed(3)
    books, dup_of = k3_codebooks(g)
    print(f'K3 checks ({card_line()}): D={K3_DIM}, K={K3_CODES} and 512, z ~ '
          f'N(0, 1) in fp32 and bf16; ref = plain version (fp32, TF32 off) '
          f'on the same z; a disagreement must be within {K3_MARGIN} of the '
          f'exact (fp64) minimum distance; on duplicated rows every pick '
          f'must be the lowest index; after an in-place change the next '
          f'call must match the plain version on the new codebook',
          flush=True)
    rows, calls = [], []
    caught = {k: set() for k in K3_FAULTS}
    for n_tok in K3_TOKENS:
        z = torch.randn(n_tok, K3_DIM, generator=g, device='cuda')
        for name, e in books.items():
            dup = dup_of if name == 'duplicated rows' else None
            max_abs = 0.0
            for zname, zz in (('fp32', z), ('bf16', z.bfloat16())):
                got = vq.nearest_code_indices(zz, e)
                torch.cuda.synchronize()
                ref = vq._nearest_code_ref(zz, e)
                r = k3_verdict(got, ref, zz.float(), e, dup)
                max_abs = max(max_abs, r['max_abs'])
                print(f'  K3 T={n_tok:5d} K={e.shape[0]:4d} {name:15s} z '
                      f'{zname}: agreement {r["agree"]:.6f}, worst '
                      f'disagreement gap {r["worst_gap"]:.3g} (<= '
                      f'{K3_MARGIN}), max abs distance gap '
                      f'{r["max_abs"]:.3g}, lowest index on ties '
                      f'{r["lowest"]}: {"ok" if r["ok"] else "FAIL"}',
                      flush=True)
                if not r['ok']:
                    raise SystemExit(f'chip_smoke: K3 T={n_tok} {name} z '
                                     f'{zname} disagrees with its plain '
                                     f'version')
            ref = vq._nearest_code_ref(z, e)
            faults = {k: k3_verdict(k3_fault(k)(z, e), ref, z, e, dup)['ok']
                      for k in K3_FAULTS if k != 'stale cache'}
            new = {}
            for stale in (False, True):
                got, e2 = k3_after_change(z, e, stale)
                new[stale] = k3_verdict(got, vq._nearest_code_ref(z, e2), z,
                                        e2, dup)['ok']
            faults['stale cache'] = new[True]
            print(f'    after an in-place change: '
                  f'{"ok" if new[False] else "FAIL"}; planted faults: '
                  + ', '.join(f'{k} {"passes" if v else "fails"}'
                              for k, v in faults.items()), flush=True)
            if not new[False]:
                raise SystemExit(f'chip_smoke: K3 T={n_tok} {name}: a call '
                                 f'after an in-place change of the codebook '
                                 f'disagrees with the plain version on it')
            for k, v in faults.items():
                if not v:
                    caught[k].add(n_tok)
            if name not in ('init scale', 'K=512'):
                continue
            n_codes = e.shape[0]
            prep = vq.prepare_nearest_code(z, e)
            prep_bf16 = vq.prepare_nearest_code(z.bfloat16(), e)
            ms = time_ms(lambda: vq.launch_nearest_code(prep))
            bf16_ms = time_ms(lambda: vq.launch_nearest_code(prep_bf16))
            cms = time_ms(lambda: vq.nearest_code_indices(z, e))
            pms = time_ms(lambda: vq._nearest_code_ref(z, e))
            with vq._fp32_matmul():
                gms = time_ms(lambda: torch.mm(z, e.t()))
            lim = bound(2 * n_tok * n_codes * K3_DIM,
                        4 * (n_tok + n_codes) * K3_DIM + 8 * n_tok,
                        FP32_FLOPS)
            p = prep.plan
            print(f'    kernel {ms:.4f} ms {ms.spread()} '
                  f'({100 * lim["bound_ms"] / ms:.1f}% of the '
                  f'{lim["bound_ms"]:.4f} ms fp32 bound; {p.tok_tiles} x '
                  f'{p.cluster} blocks in clusters of {p.cluster}), z bf16 '
                  f'{bf16_ms:.4f}, whole call {cms:.4f}, plain {pms:.4f}, '
                  f'fp32 product alone (gemm_library_ms, not the same '
                  f'function) {gms:.4f}', flush=True)
            row = dict(tokens=n_tok, codes=n_codes, max_abs_err=max_abs,
                       ms=ms, call_ms=cms, plain_ms=pms, library_ms=None,
                       gemm_library_ms=gms, bf16_ms=bf16_ms, **lim)
            calls.append((row, z, e))
            if name == 'init scale':
                rows.append(row)
    for k in K3_FAULTS:
        if caught[k] != set(K3_TOKENS):
            raise SystemExit(f'chip_smoke: the K3 checks let the planted '
                             f'fault "{k}" pass at T = '
                             f'{sorted(set(K3_TOKENS) - caught[k])}')
    print('  K3 planted faults fail the checks at every T, as they must',
          flush=True)
    return rows, calls


def phase_k3_activities(calls) -> None:
    """Device activities a K3 call on a kept codebook takes (torch.profiler,
    per launch of the kernel; must be 1: the kernel, no memset, copy or
    second pass) and the kernel's device time, for each timed call of
    phase_k3; both go into its row."""
    from codeformer_tpu_torch.ops import vq
    for row, z, e in calls:
        acts, dev_ms = device_launches(lambda: vq.nearest_code_indices(z, e))
        row.update(launches_per_call=acts, device_ms=dev_ms)
        print(f'  K3 T={row["tokens"]:5d} K={row["codes"]:4d}: device '
              f'activities a call on a kept codebook {acts:g}, kernel '
              f'device time (profiler) {dev_ms:.4f} ms', flush=True)
        if acts != 1:
            raise SystemExit(f'chip_smoke: a K3 call on a kept codebook ran '
                             f'{acts:g} device activities, not 1')


# Published peaks of one H100 SXM at its full 700 W (NVIDIA's data sheet,
# dense): the least time for a kernel's work is the larger of its bytes
# (each input read once, each output written once) over HBM bandwidth and
# its operations over the peak rate of their type.
HBM_BYTES_S = 3.35e12
BF16_TC_FLOPS = 989e12    # tensor cores, bf16
FP32_FLOPS = 67e12        # fp32 outside the tensor cores


def bound(flops: float, nbytes: float, peak: float) -> dict:
    """{'bound_ms', 'bound_by'}: max(bytes / HBM, flops / peak) in ms."""
    t_bytes = nbytes / HBM_BYTES_S * 1e3
    t_ops = flops / peak * 1e3
    return {'bound_ms': max(t_bytes, t_ops),
            'bound_by': 'bytes' if t_bytes >= t_ops else 'operations'}


def k1_bound(b, h, cin, cout, skip, cs, slots) -> dict:
    """K1 at B x h^2: x, skip and y once in bf16, the weights, a, b and
    the statistics (`slots` an image, ops/conv3x3.py stats_slots) once;
    the 3x3 (and 1x1) products on the tensor cores."""
    pix = b * h * h
    flops = 2 * pix * 9 * cin * cout
    nbytes = 2 * pix * (cin + cout) + 2 * 9 * cin * cout + 8 * b * cin \
        + 4 * cout + 8 * b * cout * slots
    if skip == 'identity':
        nbytes += 2 * pix * cout
    elif skip == 'proj':
        nbytes += 2 * pix * cs + 2 * cs * cout
        flops += 2 * pix * cs * cout
    return bound(flops, nbytes, BF16_TC_FLOPS)


# the ops layer (the counterpart of the reference's basicsr/ops): K4 and
# the bare 3x3 conv that stands for K1', K5 and K6. The path drives one
# StyleGAN2-style layer at K6's bench shape (scripts/bench_imgpair.py):
# conv3x3_bias, then fused_leaky_relu forward and backward on its output.
OPS_PATH_SHAPE = (16, 512, 512, 64)
# K4: the path's shape, a memory-bound size a quarter of it, a numel
# that is no multiple of the vector width with C = 3, and C = 513 (more
# vector classes than a block has threads); each in bf16 and fp32
K4_SHAPES = (OPS_PATH_SHAPE, (16, 256, 256, 64), (3, 37, 41, 3),
             (2, 33, 35, 513))
# dbias against the exact (fp64) sum of the rounded dx, relative to the
# sum of |dx| of the channel: the kernel's and torch's fp32 sums both read
# 1e-8 or less on an H100 (PERF.md, Findings)
DBIAS_BOUND = 1e-5
CONV_BIAS_CASES = [  # (B, H=W, Cin, Cout)
    (16, 512, 64, 64),    # K6's bench shape (the path's)
    (2, 512, 64, 64),     # K5's thin layers
    (2, 256, 64, 64),
    (2, 256, 128, 128),   # K1'
    (3, 128, 64, 64),     # an odd batch
    (2, 512, 64, 3),      # Cout = 3
    (2, 100, 96, 64),     # a ragged map, Cin % 64 == 32
]
OPS_ITERS = 10            # timing iterations of the ops phase


def bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (8 significant bits), as fp32."""
    e = torch.floor(torch.log2(v.float().abs().clamp_min(2.0 ** -126)))
    return torch.exp2(e - 7)


def fwd_agrees(got: torch.Tensor, ref: torch.Tensor) -> bool:
    """fp32: bitwise equal; bf16: within one bf16 ulp."""
    if got.dtype != torch.bfloat16:
        return bool(torch.equal(got, ref))
    return bool(((got.float() - ref.float()).abs()
                 <= bf16_ulp(ref)).all())


def dbias_err(db: torch.Tensor, dx: torch.Tensor) -> float:
    """max over channels of |db - exact| / sum |dx|, exact = the fp64 sum
    of the rounded dx."""
    d64 = dx.double().reshape(-1, dx.shape[-1])
    exact = d64.sum(0)
    return float(((db.double() - exact).abs()
                  / d64.abs().sum(0).clamp_min(1e-30)).max())


def k4_fault_fwd(x, bias, slope=0.2, scale=2 ** 0.5):
    """Planted fault: the branch taken from x, not from x + bias."""
    y = x.float() + bias.to(x.dtype).float()
    return (torch.where(x >= 0, y, y * slope) * scale).to(x.dtype)


def k4_fault_dbias(dx: torch.Tensor) -> torch.Tensor:
    """Planted fault: dbias without the elements after the last whole
    chunk of C vectors (the kernel's scalar tail)."""
    c = dx.shape[-1]
    chunk = c * (16 // dx.element_size())
    flat = dx.reshape(-1)
    keep = flat.numel() // chunk * chunk
    return flat[:keep].float().reshape(-1, c).sum(0)


def k4_double_backward(fa, x, b, go, ggx, ggb):
    """(out, dx, dbias, d<ggx, dx> + <ggb, dbias> / d go) of
    fused_leaky_relu at (x, b) for the output gradient go."""
    x, b, go = (t.clone().requires_grad_() for t in (x, b, go))
    out = fa.fused_leaky_relu(x, b)
    dx, db = torch.autograd.grad(out, (x, b), go, create_graph=True)
    (dgo,) = torch.autograd.grad((dx * ggx).sum() + (db * ggb).sum(), go)
    return out.detach(), dx.detach(), db.detach(), dgo


def phase_k4():
    """K4 forward and backward against their plain versions at K4_SHAPES,
    bf16 and fp32; planted faults; gradients and gradients of gradients
    through the kernels against the plain path; kernel vs plain times (CUDA events, median of
    OPS_ITERS)."""
    from codeformer_tpu_torch.ops import fused_act as fa
    g = torch.Generator(device='cuda').manual_seed(4)
    print(f'K4 checks ({card_line()}): forward bitwise (fp32) / within 1 '
          f'bf16 ulp (bf16) '
          f'of the plain version, dx exact, dbias within {DBIAS_BOUND} of '
          f'the fp64 sum (relative to sum |dx|)', flush=True)
    rows = []
    for shape in K4_SHAPES:
        for dt in (torch.bfloat16, torch.float32):
            x = torch.randn(shape, generator=g, device='cuda').to(dt)
            bias = torch.randn(shape[-1], generator=g, device='cuda')
            gr = torch.randn(shape, generator=g, device='cuda').to(dt)
            out = fa.fused_lrelu_fwd(x, bias, 0.2, 2 ** 0.5)
            dx, db = fa.fused_lrelu_bwd(gr, out, 0.2, 2 ** 0.5)
            torch.cuda.synchronize()
            ref = fa.fused_leaky_relu_ref(x, bias)
            dx_r, db_r = fa.fused_leaky_relu_bwd_ref(gr, out)
            fwd_ok = fwd_agrees(out, ref)
            dx_ok = bool(torch.equal(dx, dx_r))
            db_e, db_re = dbias_err(db, dx_r), dbias_err(db_r, dx_r)
            err = float((out.float() - ref.float()).abs().max())
            ok = fwd_ok and dx_ok and db_e <= DBIAS_BOUND
            numel = x.numel()
            tail = numel % (shape[-1] * 16 // x.element_size())
            faults = {'mask from x': fwd_agrees(out, k4_fault_fwd(x, bias))}
            if tail:
                faults['dbias without the tail'] = dbias_err(
                    k4_fault_dbias(dx_r), dx_r) <= DBIAS_BOUND
            ms = time_ms(lambda: fa.fused_lrelu_fwd(x, bias, 0.2, 2 ** 0.5),
                         iters=OPS_ITERS)
            pms = time_ms(lambda: fa.fused_leaky_relu_ref(x, bias),
                          iters=OPS_ITERS)
            bms = time_ms(lambda: fa.fused_lrelu_bwd(gr, out, 0.2, 2 ** 0.5),
                          iters=OPS_ITERS)
            bpms = time_ms(lambda: fa.fused_leaky_relu_bwd_ref(gr, out),
                           iters=OPS_ITERS)
            es = x.element_size()
            fwd_lim = bound(4 * numel, 2 * numel * es + 4 * shape[-1],
                            FP32_FLOPS)
            bwd_lim = bound(3 * numel, 3 * numel * es + 4 * shape[-1],
                            FP32_FLOPS)
            name = f'K4 {tuple(shape)} {str(dt)[6:]}'
            print(f'  {name:34s} fwd max_abs {err:.3g} '
                  f'{"ok" if fwd_ok else "FAIL"}, dx '
                  f'{"exact" if dx_ok else "DIFFERS"}, dbias rel '
                  f'{db_e:.3g} (plain {db_re:.3g}; <= {DBIAS_BOUND}); tail '
                  f'{tail}; fwd kernel {ms:.4f} ms plain {pms:.4f} ms '
                  f'bound {fwd_lim["bound_ms"]:.4f} ms, bwd kernel '
                  f'{bms:.4f} ms plain {bpms:.4f} ms bound '
                  f'{bwd_lim["bound_ms"]:.4f} ms  '
                  f'{"ok" if ok else "FAIL"}; planted faults: '
                  + ', '.join(f'{k} {"passes" if v else "fails"}'
                              for k, v in faults.items()), flush=True)
            if not ok:
                raise SystemExit(f'chip_smoke: {name} disagrees with its '
                                 f'plain version')
            if any(faults.values()):
                raise SystemExit(f'chip_smoke: {name}: a planted fault '
                                 f'passes the checks')
            rows.append(dict(
                shape=name, max_abs_err=err, ms=ms, plain_ms=pms,
                bwd_max_abs_err=float((db - db_r).abs().max()), bwd_ms=bms,
                bwd_plain_ms=bpms, fwd_bound=fwd_lim, bwd_bound=bwd_lim))
            del x, gr, out, dx, ref, dx_r
    # gradients and gradients of gradients through the autograd Functions
    # on the kernels, fp32, against the same Functions on CPU copies (the
    # plain versions, whose fp64 gradcheck and gradgradcheck run in
    # tests/test_torch_fused_act.py): forward, dx and d(grad) bitwise,
    # dbias within DBIAS_BOUND
    for shape in ((2, 5, 7, 3), (2, 513)):
        x = torch.randn(shape, generator=g, device='cuda')
        b = torch.randn(shape[-1], generator=g, device='cuda')
        go, ggx = (torch.randn(shape, generator=g, device='cuda')
                   for _ in range(2))
        ggb = torch.randn(shape[-1], generator=g, device='cuda')
        before = launch_counts()
        got = k4_double_backward(fa, x, b, go, ggx, ggb)
        after = launch_counts()
        n = {k: after[k] - before[k]
             for k in ('fused_lrelu_fwd', 'fused_lrelu_bwd')}
        want = [t.to('cuda') for t in k4_double_backward(
            fa, *(t.cpu() for t in (x, b, go, ggx, ggb)))]
        same = [bool(torch.equal(got[i], want[i])) for i in (0, 1, 3)]
        db_e = dbias_err(got[2], got[1])
        ok = all(same) and db_e <= DBIAS_BOUND and all(n.values())
        print(f'  K4 fp32 {shape} autograd vs plain: out, dx, d(grad) '
              f'{"bitwise" if all(same) else "DIFFER " + str(same)}, dbias '
              f'rel {db_e:.3g}; through the kernels '
              f'({n["fused_lrelu_fwd"]} forward, {n["fused_lrelu_bwd"]} '
              f'backward launches)', flush=True)
        if not ok:
            raise SystemExit('chip_smoke: K4 autograd disagrees with the '
                             'plain path')
    torch.cuda.empty_cache()
    return rows


def conv_bias_fault(kind: str, x, weight, bias):
    """Planted faults of the bare conv: 'halo row shifted', every tile of
    the plan's TH output rows reads its top halo row one row too low (the
    tile's own first row); 'bias dropped'; 'channel tail read' (Cin % 64
    == 32), the channels past Cin of the last 64-channel chunk read from
    memory (the next pixel's first channels) against weight rows that are
    not zero (those of the chunk's first channels)."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    wf, bf = weight.to(x.dtype).float(), bias.float()
    if kind == 'bias dropped':
        return cv.conv3x3_bias_ref(x, weight, torch.zeros_like(bias))
    if kind == 'channel tail read':
        bsz, h, w, cin = x.shape
        tail = 64 - cin % 64
        flat = F.pad(x.reshape(bsz, h * w * cin), (0, tail))
        nxt = flat.unfold(1, cin + tail, cin)[:, :h * w, cin:]
        xt = torch.cat([x, nxt.reshape(bsz, h, w, tail)], -1)
        wt = torch.cat([wf, wf[:, cin - 64 + tail:cin - 64 + 2 * tail]], 1)
        return F.conv2d(xt.float().permute(0, 3, 1, 2), wt, bf, padding=1) \
            .permute(0, 2, 3, 1).to(x.dtype)
    if kind != 'halo row shifted':
        raise ValueError(kind)
    th = cv.conv_plan(x.shape[0], x.shape[1], x.shape[2], x.shape[3],
                      weight.shape[0], 1).th
    xp = F.pad(x.float().permute(0, 3, 1, 2), (1, 1, 1, 1))
    tiles = []
    for y0 in range(0, x.shape[1], th):
        win = xp[:, :, y0:y0 + th + 2].clone()
        if y0 > 0:
            win[:, :, 0] = win[:, :, 1]
        tiles.append(F.conv2d(win, wf, bf))
    return torch.cat(tiles, 2).permute(0, 2, 3, 1).to(x.dtype)


CONV_BIAS_FAULTS = ('halo row shifted', 'bias dropped', 'channel tail read')


def phase_conv_bias():
    """conv3x3_bias against its plain version (fp32 sums, TF32 off) at
    CONV_BIAS_CASES; planted faults; kernel (the launch on prepared
    operands), whole call, plain (bf16, cuDNN) and library-call (one
    F.conv2d, bf16, channels_last) times."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device='cuda').manual_seed(6)
    print(f'conv3x3_bias checks ({card_line()}): bf16 in/out; ref = plain '
          f'version in fp32, TF32 off; rel RMS <= {REL_RMS_BOUND}; kernel = '
          f'the launch on prepared operands, call = the whole '
          f'conv3x3_bias call; library = F.conv2d(NCHW channels_last view, '
          f'padding=1) in bf16; ms per launch, median of 5 runs of '
          f'{OPS_ITERS} [min, max]', flush=True)
    rows = []
    for bsz, h, cin, cout in CONV_BIAS_CASES:
        x = torch.randn(bsz, h, h, cin, generator=g, device='cuda') \
            .to(torch.bfloat16)
        wt = torch.randn(cout, cin, 3, 3, generator=g, device='cuda') \
            * (9 * cin) ** -0.5
        bias = torch.randn(cout, generator=g, device='cuda') * 0.1
        y = cv.conv3x3_bias(x, wt, bias)
        torch.cuda.synchronize()
        yr = cv.conv3x3_bias_ref(x, wt, bias)
        err = float((y.float() - yr.float()).abs().max())
        rr = rel_rms(y, yr)
        faults = {k: rel_rms(y, conv_bias_fault(k, x, wt, bias))
                  for k in CONV_BIAS_FAULTS
                  if k != 'channel tail read' or cin % 64}
        xc = x.permute(0, 3, 1, 2)            # NCHW view, channels_last
        wb, bb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last), bias.to(torch.bfloat16)
        launch = cv.prepare_conv(x, cv.conv_operands(wt, bias), 1)
        ms = time_ms(lambda: cv.launch_conv(launch), iters=OPS_ITERS)
        cms = time_ms(lambda: cv.conv3x3_bias(x, wt, bias), iters=OPS_ITERS)
        pms = time_ms(lambda: cv.conv3x3_bias_ref(
            x, wt, bias, compute_dtype=torch.bfloat16), iters=OPS_ITERS)
        lms = time_ms(lambda: F.conv2d(xc, wb, bb, padding=1),
                      iters=OPS_ITERS)
        pix = bsz * h * h
        lim = bound(2 * pix * 9 * cin * cout,
                    2 * pix * (cin + cout) + 18 * cin * cout + 4 * cout,
                    BF16_TC_FLOPS)
        name = f'conv3x3_bias B={bsz} {h}^2 {cin}->{cout}'
        ok = rr <= REL_RMS_BOUND and y.shape == (bsz, h, h, cout)
        caught = all(v > REL_RMS_BOUND for v in faults.values())
        pl = launch.plan
        print(f'  {name:36s} max_abs {err:.4g} rel_rms {rr:.3g} (<= '
              f'{REL_RMS_BOUND})  kernel {ms:.4f} {ms.spread()} ms  call '
              f'{cms:.4f} ms  plain {pms:.4f} ms  library {lms:.4f} '
              f'{lms.spread()} ms  bound {lim["bound_ms"]:.4f} ms '
              f'({lim["bound_by"]}, {lim["bound_ms"] / ms:.1%} of it)  plan '
              f'TH={pl.th} BN={pl.bn} split={pl.split} stages={pl.stages} '
              f'grid={pl.grid_x}x{pl.n_slices * pl.split}  '
              f'{"ok" if ok else "FAIL"}; planted faults: ' + ', '.join(
                  f'{k} {v:.3g}' for k, v in faults.items())
              + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if not caught:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bound')
        rows.append(dict(shape=name, max_abs_err=err, rel_rms=rr, ms=ms,
                         call_ms=cms, plain_ms=pms, library_ms=lms, **lim))
        del x, y, yr, xc, launch
    torch.cuda.empty_cache()
    return rows


# RRDBNet's dense conv (ops/conv3x3.py conv3x3_dense) at the trunk's
# shapes: a forward of 16 windows of 480^2 is B = 16 at 240^2 after the
# pixel-unshuffle; (Cin, Cout, off, epi) of conv1-5 of a dense block
# (conv5 of an RRDB's third block, with both residuals) and conv_body
DENSE_HW, DENSE_B, DENSE_W = 240, 16, 192
DENSE_CASES = ((64, 32, 64, 'lrelu'), (96, 32, 96, 'lrelu'),
               (128, 32, 128, 'lrelu'), (160, 32, 160, 'lrelu'),
               (192, 64, 0, 'rrdb'), (64, 64, 0, 'add'))
DENSE_RAGGED = (3, 37, 53)


def dense_fault(kind: str, x, wt, bias, out, epi, s1, s2):
    """A deliberately wrong plain dense conv (a control the bound must
    catch): the last 32 input channels of the prefix dropped, or the
    epilogue dropped (conv + bias alone: no LeakyReLU, no 0.2 scale, no
    skip)."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    want = out.clone()
    if kind == 'prefix tail dropped':
        w2 = wt.clone()
        w2[:, -32:] = 0
        return cv.conv3x3_dense_ref(x, w2, bias, want, epi, s1, s2)
    return cv.conv3x3_dense_ref(x, wt, bias, want, 'add',
                                torch.zeros_like(out))


def phase_rrdb_dense():
    """The dense conv against its plain version (fp32 sums, TF32 off) at
    DENSE_CASES on 192-channel workspaces (B = 16, 240^2, and a ragged
    map), the bytes outside the written slice untouched, two planted
    faults; kernel (the launch on prepared operands), call, plain (bf16,
    cuDNN) and library (the prefix concatenated from its pieces, then one
    F.conv2d, bf16, channels_last: what the module path runs but its
    epilogue's passes) times beside the bound."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    torch.backends.cudnn.allow_tf32 = False
    g = torch.Generator(device='cuda').manual_seed(22)
    print(f'conv3x3_dense checks ({card_line()}): bf16 workspaces of '
          f'{DENSE_W} channels; ref = plain version in fp32, TF32 off; rel '
          f'RMS <= {REL_RMS_BOUND}; kernel = the launch on prepared '
          f'operands, call = the whole conv3x3_dense call; library = '
          f'torch.cat of the prefix\'s pieces + F.conv2d (channels_last) in '
          f'bf16; ms per launch, median of 5 runs of {OPS_ITERS} [min, max]',
          flush=True)
    rows = []
    for cin, cout, off, epi in DENSE_CASES:
        for bsz, h, w in ((DENSE_B, DENSE_HW, DENSE_HW), DENSE_RAGGED):
            buf = torch.randn(bsz, h, w, DENSE_W, generator=g,
                              device='cuda').to(torch.bfloat16)
            skip = torch.randn(bsz, h, w, 64, generator=g,
                               device='cuda').to(torch.bfloat16)
            wt = torch.randn(cout, cin, 3, 3, generator=g, device='cuda') \
                * (9 * cin) ** -0.5
            bias = torch.randn(cout, generator=g, device='cuda') * 0.1
            # where the trunk writes: conv1-4 a slice of the workspace they
            # read, conv5 the first 64 channels of the next one (in place
            # over its s2 for an RRDB's third block), conv_body a packed map
            nxt = torch.randn(bsz, h, w, DENSE_W if epi != 'add' else cout,
                              generator=g, device='cuda').to(torch.bfloat16)

            def out_of(src, dst):
                return src[..., off:off + cout] if epi == 'lrelu' \
                    else dst[..., off:off + cout]
            x, out = buf[..., :cin], out_of(buf, nxt)
            s1 = skip[..., :cout] if epi != 'lrelu' else None
            s2 = out if epi == 'rrdb' else None
            before, nxt0 = buf.clone(), nxt.clone()
            ref = cv.conv3x3_dense_ref(
                before[..., :cin], wt, bias, out_of(before, nxt0).clone(),
                epi, s1, out_of(before, nxt0) if epi == 'rrdb' else None)
            faults = {k: rel_rms(ref, dense_fault(
                k, before[..., :cin], wt, bias, out_of(before, nxt0), epi,
                s1, out_of(before, nxt0) if s2 is not None else None))
                for k in ('prefix tail dropped', 'epilogue dropped')}
            y = cv.conv3x3_dense(x, wt, bias, out, epi, s1, s2)
            torch.cuda.synchronize()
            written = torch.zeros(DENSE_W, dtype=torch.bool, device='cuda')
            written[off:off + cout] = True
            if epi == 'lrelu':
                untouched = bool(torch.equal(buf[..., ~written],
                                             before[..., ~written]))
            else:
                kept = ~written[:nxt.shape[-1]]
                untouched = bool(torch.equal(buf, before)) and bool(
                    torch.equal(nxt[..., kept], nxt0[..., kept]))
            err = float((y.float() - ref.float()).abs().max())
            rr = rel_rms(y, ref)
            name = f'conv3x3_dense B={bsz} {h}x{w} {cin}->{cout}@{off} {epi}'
            ok = rr <= REL_RMS_BOUND and untouched
            caught = all(v > REL_RMS_BOUND for v in faults.values())
            plan = cv.conv_plan(bsz, h, w, cin, cout, 1,
                                torch.cuda.get_device_properties(0)
                                .multi_processor_count, dense=True)
            line = (f'  {name:44s} max_abs {err:.4g} rel_rms {rr:.3g} (<= '
                    f'{REL_RMS_BOUND}), outside the slice untouched '
                    f'{untouched}  plan TH={plan.th} BN={plan.bn} '
                    f'split={plan.split} stages={plan.stages} '
                    f'grid={plan.grid_x}x{plan.n_slices * plan.split}  '
                    f'{"ok" if ok else "FAIL"}; planted faults: ' + ', '.join(
                        f'{k} {v:.3g}' for k, v in faults.items())
                    + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}')
            if not ok:
                raise SystemExit(f'chip_smoke: {name} disagrees with its '
                                 f'plain version\n{line}')
            if not caught:
                raise SystemExit(f'chip_smoke: {name}: a planted fault '
                                 f'passes the bound\n{line}')
            if bsz != DENSE_B:
                print(line, flush=True)
                continue
            # timing: the rrdb epilogue's s2 is read and written in place,
            # so repeated launches compound; its values stay bf16-finite
            launch = cv.prepare_dense(x, cv.conv_operands(wt, bias), out, epi,
                                      s1, s2)
            ms = time_ms(lambda: cv.launch_dense(launch), iters=OPS_ITERS)
            cms = time_ms(lambda: cv.conv3x3_dense(x, wt, bias, out, epi, s1,
                                                   s2), iters=OPS_ITERS)
            pout = out.clone()
            pms = time_ms(lambda: cv.conv3x3_dense_ref(
                x, wt, bias, pout, epi, s1, pout if s2 is not None else None,
                compute_dtype=torch.bfloat16), iters=OPS_ITERS)
            edges = [0, 64] + list(range(96, cin + 1, 32)) if cin > 64 \
                else [0, 64]
            pieces = [buf[..., a:b].permute(0, 3, 1, 2).contiguous(
                memory_format=torch.channels_last)
                for a, b in zip(edges, edges[1:])]
            wb = wt.to(torch.bfloat16).contiguous(
                memory_format=torch.channels_last)
            bb = bias.to(torch.bfloat16)
            lms = time_ms(lambda: F.conv2d(
                torch.cat(pieces, 1) if len(pieces) > 1 else pieces[0], wb,
                bb, padding=1), iters=OPS_ITERS)
            pix = bsz * h * w
            skips = (epi != 'lrelu') + (epi == 'rrdb')
            lim = bound(2 * pix * 9 * cin * cout,
                        2 * pix * (cin + cout * (1 + skips))
                        + 18 * cin * cout + 4 * cout, BF16_TC_FLOPS)
            print(line + f'  kernel {ms:.4f} {ms.spread()} ms  call '
                  f'{cms:.4f} ms  plain {pms:.4f} ms  library {lms:.4f} '
                  f'{lms.spread()} ms  bound {lim["bound_ms"]:.4f} ms '
                  f'({lim["bound_by"]}, {lim["bound_ms"] / ms:.1%} of it)',
                  flush=True)
            rows.append(dict(shape=name, max_abs_err=err, rel_rms=rr, ms=ms,
                             call_ms=cms, plain_ms=pms, library_ms=lms,
                             plan=plan._asdict(), **lim))
            del launch, pieces, pout
        del buf, skip, nxt, before, nxt0, ref, y
    torch.cuda.empty_cache()
    return rows


def phase_ops_path() -> dict:
    """The ops layer's main path, with every count set to 0 just before
    it and read just after: conv3x3_bias at OPS_PATH_SHAPE, then
    fused_leaky_relu forward and backward on its output through autograd.
    Then each result against its plain version on the same inputs."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.ops import fused_act as fa
    from codeformer_tpu_torch.ops import conv3x3_bias, fused_leaky_relu
    g = torch.Generator(device='cuda').manual_seed(7)
    bsz, h, w, c = OPS_PATH_SHAPE
    x = torch.randn(bsz, h, w, c, generator=g, device='cuda') \
        .to(torch.bfloat16)
    wt = torch.randn(c, c, 3, 3, generator=g, device='cuda') * (9 * c) ** -0.5
    b_conv = torch.randn(c, generator=g, device='cuda') * 0.1
    b_act = (torch.randn(c, generator=g, device='cuda') * 0.1) \
        .requires_grad_()
    up = torch.randn(OPS_PATH_SHAPE, generator=g, device='cuda') \
        .to(torch.bfloat16)
    reset_launch_counts()
    y = conv3x3_bias(x, wt, b_conv).requires_grad_()
    out = fused_leaky_relu(y, b_act)
    out.backward(up)
    torch.cuda.synchronize()
    counts = launch_counts()
    # the plain versions on the same inputs
    yr = cv.conv3x3_bias_ref(x, wt, b_conv)
    out_r = fa.fused_leaky_relu_ref(y.detach(), b_act.detach())
    dx_r, db_r = fa.fused_leaky_relu_bwd_ref(up, out.detach())
    r = dict(conv=rel_rms(y.detach(), yr),
             fwd=fwd_agrees(out.detach(), out_r),
             dx=bool(torch.equal(y.grad, dx_r)),
             db=dbias_err(b_act.grad, dx_r))
    print(f'ops path: conv3x3_bias -> fused_leaky_relu fwd + bwd at '
          f'{OPS_PATH_SHAPE} bf16: launches {counts}; conv rel_rms '
          f'{r["conv"]:.3g}, forward {"ok" if r["fwd"] else "FAIL"}, dx '
          f'{"exact" if r["dx"] else "DIFFERS"}, dbias rel {r["db"]:.3g}',
          flush=True)
    if not (r['conv'] <= REL_RMS_BOUND and r['fwd'] and r['dx']
            and r['db'] <= DBIAS_BOUND):
        raise SystemExit('chip_smoke: the ops path disagrees with its plain '
                         'versions')
    if not all(torch.isfinite(t).all() for t in (out, y.grad, b_act.grad)):
        raise SystemExit('chip_smoke: non-finite values on the ops path')
    del x, y, out, up, yr, out_r, dx_r
    torch.cuda.empty_cache()
    return counts


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: no CUDA device visible')
    print(card_line(), flush=True)
    nvcc = subprocess.run(['bash', '-lc', 'nvcc --version || '
                           '/usr/local/cuda/bin/nvcc --version'],
                          capture_output=True, text=True).stdout
    print(f'python {sys.version.split()[0]}  torch {torch.__version__}  '
          f'cuda {torch.version.cuda}  nvcc: '
          f'{nvcc.strip().splitlines()[-1] if nvcc.strip() else "?"}')
    cap = torch.cuda.get_device_capability(0)
    print(f'device: {torch.cuda.get_device_name(0)} capability {cap} '
          f'count {torch.cuda.device_count()}', flush=True)
    if cap != (9, 0):
        raise SystemExit(f'chip_smoke: needs compute capability 9.0, '
                         f'got {cap}')


def phase_build():
    from codeformer_tpu_torch.kernels import build
    t0 = time.perf_counter()
    build.library()
    info = build.build_info
    print(f'build: {info["path"]} in {info["seconds"]:.1f} s '
          f'(cached={info["cached"]}), load total '
          f'{time.perf_counter() - t0:.1f} s')
    for line in info['log'].splitlines():
        if 'Function properties for' in line:     # names the lines below
            print('  ptxas:', line.strip()[:110])
        elif any(k in line for k in ('registers', 'spill', 'error',
                                     'warning', 'Performance')):
            print('  ptxas:', line.strip())
    sys.stdout.flush()


def _k1_inputs(g, bsz, h, cin, cout, skip, cs):
    dev = 'cuda'

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=g, device=dev) * scale

    x = rnd(bsz, h, h, cin).to(torch.bfloat16)
    a = (1.0 + rnd(bsz, cin, scale=0.1)).contiguous()
    b = rnd(bsz, cin, scale=0.3).contiguous()       # non-zero: halo trap
    weight = rnd(cout, cin, 3, 3, scale=(9 * cin) ** -0.5)
    bias = rnd(cout, scale=0.1)
    sk, w1 = None, None
    if skip == 'identity':
        sk = rnd(bsz, h, h, cout).to(torch.bfloat16)
    elif skip == 'proj':
        sk = rnd(bsz, h, h, cs).to(torch.bfloat16)
        w1 = rnd(cout, cs, 1, 1, scale=cs ** -0.5)
    return x, a, b, weight, bias, sk, w1


def phase_k1():
    """K1 against its plain version (fp32 sums, TF32 off) at K1_CASES: y
    within REL_RMS_BOUND, every statistics slot within STATS_BOUND of the
    exact sums of the kernel's own rounded y; planted faults that must
    fail; kernel (the launch on prepared operands), whole-call, plain
    (bf16, cuDNN) and conv-alone library (one F.conv2d) times; the plan
    and the bound of every shape."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    torch.backends.cudnn.allow_tf32 = False          # the fp32 reference
    torch.backends.cuda.matmul.allow_tf32 = False    # must be true fp32
    g = torch.Generator(device='cuda').manual_seed(0)
    rows = []
    print(f'K1 checks ({card_line()}): bf16 in/out; ref = plain version in '
          f'fp32, TF32 off; y rel RMS <= {REL_RMS_BOUND}, every statistics '
          f'slot within {STATS_BOUND} of the fp64 sums of the rounded y; '
          f'kernel = the launch on prepared operands, call = the whole '
          f'conv3x3_dots call, plain = plain version in bf16 (cuDNN), conv '
          f'library = one F.conv2d of the same shape (bf16, channels_last; '
          f'the conv alone, not the same function); ms per launch, median '
          f'of 5 runs of 20 [min, max]', flush=True)
    for bsz, h, cin, cout, act, skip, cs in K1_CASES:
        x, a, b, wt, bias, sk, w1 = _k1_inputs(g, bsz, h, cin, cout, skip,
                                               cs)
        y, st = cv.conv3x3_dots(x, a, b, act, wt, bias, sk, w1)
        torch.cuda.synchronize()
        launch = cv.prepare_dots(x, a, b, act,
                                 cv.dots_operands(wt, bias, w1), sk)
        pl = launch.plan
        yr, _ = cv.conv3x3_dots_ref(x, a, b, act, wt, bias, sk, w1)
        err = float((y.float() - yr.float()).abs().max())
        rr = rel_rms(y, yr)
        st_err = k1_stats_err(st, y, pl.th)
        ok = rr <= REL_RMS_BOUND and st_err <= STATS_BOUND \
            and y.shape == (bsz, h, h, cout) \
            and st.shape == (bsz, cv.stats_slots(pl), 2, cout)
        faults = {}
        for kind in K1_FAULTS:
            got = k1_fault(kind)(x, a, b, act, wt, bias, sk, w1, th=pl.th)
            if got is None:
                continue
            fy, fst = got
            faults[kind] = k1_stats_err(fst, fy, pl.th) \
                if kind == 'stats of unrounded y' else rel_rms(y, fy)
        caught = all(v > (STATS_BOUND if k == 'stats of unrounded y'
                          else REL_RMS_BOUND) for k, v in faults.items())
        ms = time_ms(lambda: cv.launch_dots(launch))
        cms = time_ms(lambda: cv.conv3x3_dots(x, a, b, act, wt, bias, sk,
                                              w1))
        pms = time_ms(lambda: cv.conv3x3_dots_ref(
            x, a, b, act, wt, bias, sk, w1, compute_dtype=torch.bfloat16))
        xc = x.permute(0, 3, 1, 2)            # NCHW view, channels_last
        wb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        lms = time_ms(lambda: F.conv2d(xc, wb, bb, padding=1))
        lim = k1_bound(bsz, h, cin, cout, skip, cs, cv.stats_slots(pl))
        name = f'K1 B={bsz} {h}^2 {cin}->{cout} {act} skip={skip}' + \
            (f'({cs})' if cs else '')
        print(f'  {name:44s} max_abs {err:.4g} rel_rms {rr:.3g} (<= '
              f'{REL_RMS_BOUND}) stats {st_err:.3g} (<= {STATS_BOUND})  '
              f'kernel {ms:.4f} {ms.spread()} ms  call {cms:.4f} ms  plain '
              f'{pms:.4f} ms  conv library {lms:.4f} {lms.spread()} ms  '
              f'bound {lim["bound_ms"]:.4f} ms ({lim["bound_by"]}, '
              f'{lim["bound_ms"] / ms:.1%} of it)  plan TH={pl.th} '
              f'BN={pl.bn} split={pl.split} stages={pl.stages} '
              f'grid={pl.grid_x}x{pl.n_slices * pl.split} smem={pl.smem}  '
              f'{"ok" if ok else "FAIL"}; planted faults: ' + ', '.join(
                  f'{k} {v:.3g}' for k, v in faults.items())
              + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if not caught:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bounds')
        rows.append(dict(shape=name, max_abs_err=err, rel_rms=rr,
                         stats_err=st_err, ms=ms, call_ms=cms, plain_ms=pms,
                         library_ms=None, conv_library_ms=lms, **lim))
        del x, y, yr, st, launch, xc
    torch.cuda.empty_cache()
    return rows


def phase_kernels():
    """K1 (phase_k1), then K2 against its plain version at K2_CASES, with
    planted faults and kernel, whole-call, plain and library times."""
    import torch.nn.functional as F
    from codeformer_tpu_torch.ops import conv3x3 as cv
    results = {'conv3x3_dots': phase_k1()}
    g = torch.Generator(device='cuda').manual_seed(1)
    split_faults = []
    print(f'K2 checks ({card_line()}): bf16 in/out; ref = plain version '
          f'in fp32, TF32 off; kernel = the launch on prepared operands, '
          f'call = the whole public call, plain = plain version in bf16 '
          f'(cuDNN); ms per launch, median of 5 runs of 20 [min, max]')
    for bsz, h, c in K2_CASES:
        x = (torch.randn(bsz, h, h, c, generator=g, device='cuda')
             .to(torch.bfloat16))
        wt = torch.randn(c, c, 3, 3, generator=g, device='cuda') \
            * (9 * c) ** -0.5
        bias = torch.randn(c, generator=g, device='cuda') * 0.1
        y = cv.downsample_dots(x, wt, bias)
        torch.cuda.synchronize()
        yr = cv.downsample_dots_ref(x, wt, bias)
        err = float((y.float() - yr.float()).abs().max())
        rr = rel_rms(y, yr)
        launch = cv.prepare_conv(x, cv.conv_operands(wt, bias), 2)
        ms = time_ms(lambda: cv.launch_conv(launch))
        cms = time_ms(lambda: cv.downsample_dots(x, wt, bias))
        pms = time_ms(lambda: cv.downsample_dots_ref(
            x, wt, bias, compute_dtype=torch.bfloat16))
        # the library yardstick: F.pad + one F.conv2d, bf16, channels_last
        xc = x.permute(0, 3, 1, 2)
        wb = wt.to(torch.bfloat16).contiguous(
            memory_format=torch.channels_last)
        bb = bias.to(torch.bfloat16)
        lms = time_ms(lambda: F.conv2d(F.pad(xc, (0, 1, 0, 1)), wb, bb,
                                       stride=2))
        name = f'K2 B={bsz} {h}^2 -> {h // 2}^2 C={c}'
        ok = rr <= REL_RMS_BOUND and y.shape == (bsz, h // 2, h // 2, c)
        faults = {}
        for kind in K2_FAULTS:
            wrong = k2_planted(kind)(x, wt, bias)
            if wrong is not None:
                faults[kind] = rel_rms(y, wrong)
                if kind == 'split partial dropped':
                    split_faults.append(name)
        pix = bsz * (h // 2) ** 2
        lim = bound(2 * pix * 9 * c * c,
                    2 * bsz * h * h * c + 2 * pix * c + 18 * c * c + 4 * c,
                    BF16_TC_FLOPS)
        pl = launch.plan
        caught = all(v > REL_RMS_BOUND for v in faults.values())
        print(f'  {name:38s} max_abs {err:.4g} rel_rms {rr:.3g} '
              f'(<= {REL_RMS_BOUND})  kernel {ms:.4f} {ms.spread()} ms  call '
              f'{cms:.4f} ms  plain {pms:.4f} ms  library {lms:.4f} '
              f'{lms.spread()} ms  bound {lim["bound_ms"]:.4f} ms '
              f'({lim["bound_by"]}, {lim["bound_ms"] / ms:.1%} of it)  plan '
              f'TH={pl.th} BN={pl.bn} split={pl.split} stages={pl.stages} '
              f'grid={pl.grid_x}x{pl.n_slices * pl.split}  '
              f'{"ok" if ok else "FAIL"}; planted faults: ' + ', '.join(
                  f'{k} {v:.3g}' for k, v in faults.items())
              + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with its plain '
                             f'version')
        if not caught:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bound')
        results.setdefault('downsample_dots', []).append(
            dict(shape=name, max_abs_err=err, rel_rms=rr, ms=ms,
                 call_ms=cms, plain_ms=pms, library_ms=lms, **lim))
        del x, y, yr, xc, launch
    if not split_faults:
        raise SystemExit('chip_smoke: no K2 shape splits its input chunks, '
                         'so the split is never checked')
    return results


def phase_stats():
    """The stage-entry statistics kernel (entry_stats,
    csrc/channel_stats.cu) at STATS_CASES: every slot within STATS_BOUND
    of the exact (fp64) sums of its pixels, planted faults that must fail;
    at the B=16 maps and STATS_TIMED the kernel (the launch on a prepared
    launch), the whole call and torch's channel_stats (the plain version,
    five launches, as the library yardstick) against the bytes bound; the
    statistics of a B=16 forward's 33 entries, per face."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    g = torch.Generator(device='cuda').manual_seed(2)
    per_face = {'kernel': 0.0, 'torch': 0.0, 'bound': 0.0}
    entries = {(16, h, h, c): k for h, c, k in STATS_ENTRY_SHAPES}
    rows = []
    print(f'stage-entry statistics ({card_line()}): bf16 NHWC in, fp32 '
          f'(B, slots, 2, C) out; every slot within {STATS_BOUND} of the '
          f'fp64 sums of its pixels (relative to sum |x|, sum x^2); kernel = '
          f'the launch on a prepared launch, call = entry_stats, torch = '
          f'channel_stats (the plain version, five launches); ms per launch, '
          f'median of 5 runs of 20 [min, max]', flush=True)
    for bsz, h, w, c in STATS_CASES:
        x = (torch.randn(bsz, h, w, c, generator=g, device='cuda') * 2
             + 0.5).to(torch.bfloat16)
        st = cv.entry_stats(x)
        torch.cuda.synchronize()
        launch = cv.prepare_stats(x)
        slots = launch.out.shape[1]
        err, abs_err = stats_errors(st, x)
        ok = st.shape == (bsz, slots, 2, c) and err <= STATS_BOUND
        faults = {}
        for kind in STATS_FAULTS:
            got = stats_planted(kind)(x)
            if got is not None:
                faults[kind] = stats_errors(got, x)[0]
        caught = all(v > STATS_BOUND for v in faults.values())
        name = f'stats B={bsz} {h}x{w}x{c}'
        line = (f'  {name:30s} slots {slots} x {launch.slot_pixels} px  err '
                f'{err:.3g} (<= {STATS_BOUND})')
        timed = (bsz, h, w, c) in STATS_TIMED or (bsz, h, w, c) in entries
        if timed:
            ms = time_ms(lambda: cv.launch_stats(launch))
            cms = time_ms(lambda: cv.entry_stats(x))
            lms = time_ms(lambda: cv.channel_stats(x))
            elems = bsz * h * w * c
            lim = bound(2 * elems, 2 * elems + 8 * bsz * slots * c,
                        FP32_FLOPS)
            line += (f'  kernel {ms:.4f} {ms.spread()} ms  call {cms:.4f} ms'
                     f'  torch {lms:.4f} {lms.spread()} ms  bound '
                     f'{lim["bound_ms"]:.4f} ms ({lim["bound_by"]}, '
                     f'{lim["bound_ms"] / ms:.1%} of it)')
            k = entries.get((bsz, h, w, c), 0)
            for key, t in (('kernel', ms), ('torch', lms),
                           ('bound', lim['bound_ms'])):
                per_face[key] += k * t / bsz
            rows.append(dict(shape=name, max_abs_err=abs_err, stats_err=err,
                             ms=ms, call_ms=cms, plain_ms=lms,
                             library_ms=lms, **lim))
        print(line + f'  {"ok" if ok else "FAIL"}; planted faults: '
              + ', '.join(f'{k} {v:.3g}' for k, v in faults.items())
              + f' {"FAIL as they must" if caught else "PASS (bound too loose)"}',
              flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: {name} disagrees with the exact '
                             f'sums')
        if not caught or 'ragged tail dropped' not in faults and \
                (bsz, h, w, c) == STATS_CASES[-1]:
            raise SystemExit(f'chip_smoke: {name}: a planted fault passes '
                             f'the bound, or the ragged map has no tail')
        del x, st, launch
    print(f'  a B=16 forward\'s {sum(entries.values())} entries, per face: '
          f'kernel {per_face["kernel"]:.4f} ms, torch channel_stats '
          f'{per_face["torch"]:.4f} ms, bound {per_face["bound"]:.4f} ms',
          flush=True)
    torch.cuda.empty_cache()
    return rows


def _faces(rng, n, size=512):
    """Seeded smooth uint8 BGR images (low-frequency noise, upsampled)."""
    lo = rng.uniform(0, 255, (n, 16, 16, 3))
    img = np.repeat(np.repeat(lo, size // 16, axis=1), size // 16, axis=2)
    img = img + rng.normal(0, 12, img.shape)
    return [np.clip(im, 0, 255).astype(np.uint8) for im in img]


def count_resblocks(model, enable_fuse: bool) -> int:
    """ResBlocks one forward runs: the encoder's and generator's, plus the
    one inside each SFT block when fusion is on."""
    from codeformer_tpu_torch.nn.blocks import ResBlock
    n = sum(isinstance(m, ResBlock) for m in model.modules())
    if not enable_fuse:
        n -= sum(isinstance(m, ResBlock)
                 for m in model.fuse_convs_dict.modules())
    return n


def forward_launches(n_res: int, forwards: int = 1, n_down: int = 5,
                     tail: int = 1) -> dict:
    """K1, K2 and stage-entry statistics launches of `forwards` forwards
    through n_res ResBlocks (two K1 and one entry_stats each) and n_down
    Downsamples, plus the decoder tail's K1 and entry_stats (tail 1; 0
    for an encoder alone)."""
    return {'conv3x3_dots': forwards * (2 * n_res + tail),
            'downsample_dots': forwards * n_down,
            'channel_stats': forwards * (n_res + tail)}


@torch.no_grad()
def tame_sft(model, factor: float = SFT_SCALE):
    """Scale the SFT branches' last convs (scale.2, shift.2) by `factor`.

    With random weights the SFT term dec * scale(enc') grows with the
    square of the feature magnitude: four fusions take the generator's
    activations past 1e18, the tail GroupNorm's fp32 sum of squares
    overflows and the image comes out constant, so the end-to-end check
    would compare nothing. Trained weights keep activations in range.
    """
    for blk in model.fuse_convs_dict.values():
        blk.scale[2].weight.mul_(factor)
        blk.shift[2].weight.mul_(factor)


def phase_slice():
    from codeformer_tpu_torch.nn.blocks import Downsample
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    t0 = time.perf_counter()
    restorer = CodeFormerRestorer(device='cuda', seed=0)
    tame_sft(restorer.model)
    model, size = restorer.model, restorer.face_size
    n_res_fused = count_resblocks(model, enable_fuse=True)
    n_res_plain = count_resblocks(model, enable_fuse=False)
    n_down = sum(isinstance(m, Downsample) for m in model.modules())
    print(f'restorer: full width (dim_embd 512, 9 layers, 1024 codes, '
          f'connect 32/64/128/256), bf16, seeded random init in '
          f'{time.perf_counter() - t0:.1f} s; ResBlocks per forward: '
          f'{n_res_fused} fused / {n_res_plain} at w=0, Downsamples: '
          f'{n_down}', flush=True)
    rng = np.random.default_rng(0)
    requests = [(3, 0.5, n_res_fused), (1, 0.0, n_res_plain),
                (1, 1.0, n_res_fused)]
    main_counts = dict.fromkeys(forward_launches(0), 0)
    for n, w, n_res in requests:
        faces = _faces(rng, n, size)
        reset_launch_counts()
        out = restorer.restore_batch(faces, w=w)
        torch.cuda.synchronize()
        counts = launch_counts()
        want = dict(NO_LAUNCHES, **forward_launches(n_res, n_down=n_down))
        print(f'  request: {n} face(s) w={w}: launches {counts} '
              f'(expected {want})', flush=True)
        if counts != want:
            raise SystemExit('chip_smoke: kernel launch counts differ from '
                             'the main path (a failed chunk passes through)')
        for k in main_counts:
            main_counts[k] += counts[k]
        for face, o in zip(faces, out):
            if o.shape != (size, size, 3) or o.dtype != np.uint8:
                raise SystemExit(f'chip_smoke: bad output {o.shape} '
                                 f'{o.dtype}')
            if np.array_equal(o, face):
                raise SystemExit('chip_smoke: output equals input (the '
                                 'passthrough fired)')
    # reference forward: the same model with both ops on their plain
    # versions (fp32 sums, TF32 off); then planted faults that must fail
    x = torch.from_numpy(np.stack(_faces(rng, 2, size))[..., ::-1].copy())
    xn = restorer.normalize(x.to(restorer.device))
    with torch.inference_mode():
        out_k, logits_k, lq_k = model(xn, 0.5, adain=True)
    for name, t in (('out', out_k), ('logits', logits_k), ('lq_feat', lq_k)):
        if not torch.isfinite(t.float()).all():
            raise SystemExit(f'chip_smoke: non-finite {name}')
    img_k = restorer.denormalize(out_k).float()
    img_std = float(img_k.std())

    def against(label, k1, k2):
        with torch.inference_mode(), mock.patch.multiple(
                cv, conv3x3_dots=takes_prepared(k1),
                downsample_dots=takes_prepared(k2),
                entry_stats=cv.channel_stats):
            out_r, logits_r, lq_r = model(xn, 0.5, adain=True)
        diff = (img_k - restorer.denormalize(out_r).float()).abs()
        r = dict(lq=rel_rms(lq_k, lq_r), logits=rel_rms(logits_k, logits_r),
                 agree=float((logits_k.argmax(-1) == logits_r.argmax(-1))
                             .float().mean()),
                 diff=float(diff.mean()))
        inside = (max(r['lq'], r['logits']) <= SLICE_REL_BOUND
                  and r['agree'] >= INDEX_AGREEMENT_FLOOR
                  and r['diff'] <= IMAGE_DIFF_BOUND)
        print(f'  vs {label}: lq_feat rel_rms {r["lq"]:.3g}, logits rel_rms '
              f'{r["logits"]:.3g} (<= {SLICE_REL_BOUND}); code index '
              f'agreement {r["agree"]:.4f} (>= {INDEX_AGREEMENT_FLOOR}); '
              f'image diff mean {r["diff"]:.4f} (<= {IMAGE_DIFF_BOUND}) max '
              f'{float(diff.max()):.0f} levels, '
              f'{float((diff > 2).float().mean()):.4f} of values off by > 2: '
              f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
        return inside

    print(f'  kernel-path forward, B=2, w=0.5: image std {img_std:.2f} '
          f'levels (>= {MIN_IMAGE_STD})', flush=True)
    if img_std < MIN_IMAGE_STD:
        raise SystemExit('chip_smoke: the restored image is (nearly) '
                         'constant')
    if not against('reference forward (plain ops)', cv.conv3x3_dots_ref,
                   cv.downsample_dots_ref):
        raise SystemExit('chip_smoke: kernel path disagrees with the plain '
                         'reference forward')
    # a bf16 prologue (~5e-3 a conv) hides in the whole forward's rounding
    # noise (PERF.md); the per-call check on the path's own activations
    # below resolves it
    if against('planted fault: K1 halo act(b)', k1_fault('halo act(b)'),
               cv.downsample_dots_ref):
        raise SystemExit('chip_smoke: the model bounds let the planted '
                         'fault K1 halo act(b) pass')
    if against('planted fault: K2 symmetric pad', cv.conv3x3_dots_ref,
               k2_fault):
        raise SystemExit('chip_smoke: the model bounds let the planted '
                         'fault K2 symmetric pad pass')
    worst = per_call(model, xn, 'kernels', cv.conv3x3_dots,
                     cv.downsample_dots)
    if not calls_within(worst):
        raise SystemExit('chip_smoke: a kernel call of the forward '
                         'disagrees with its plain version')
    worst = per_call(model, xn, 'planted fault: statistics channels '
                     'shifted by 8', cv.conv3x3_dots, cv.downsample_dots,
                     stats=stats_planted('channels shifted by 8'))
    if worst['channel_stats'] <= STATS_BOUND:
        raise SystemExit('chip_smoke: the per-call bound lets the planted '
                         'fault statistics channels shifted by 8 pass')
    for fault in K1_MODEL_FAULTS:
        worst = per_call(model, xn, f'planted fault: K1 {fault}',
                         k1_fault(fault), cv.downsample_dots_ref)
        if worst['conv3x3_dots'] <= REL_RMS_BOUND:
            raise SystemExit(f'chip_smoke: the per-call bound lets the '
                             f'planted fault K1 {fault} pass')
    phase_rates(restorer, [
        torch.from_numpy(np.stack(_faces(rng, bsz, size))).cuda()
        for bsz in (1, 8, 16)])
    return main_counts, restorer


def per_call(model, xn, label, k1, k2, w=0.5, adain=True,
             enable_fuse=True, stats=None) -> dict:
    """Run one eager forward (w, adain, enable_fuse) with K1/K2 served by
    (k1, k2) and the stage-entry statistics by `stats` (None: the
    kernel), and hold every call against the plain version on that
    call's own inputs: the main path's real activations, where the
    whole-forward comparison sees only compounded rounding noise. Returns
    the worst error by op: rel RMS for K1/K2, stats_errors' relative
    error for the statistics (`calls_within` holds each to its bound)."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.pipeline.restorer import eager_forwards
    errs = {'conv3x3_dots': [], 'downsample_dots': [], 'channel_stats': []}
    stats = stats or cv.entry_stats
    # the kernels take the modules' kept operands; a plain stand-in
    # ignores them
    k1 = k1 if k1 is cv.conv3x3_dots else takes_prepared(k1)
    k2 = k2 if k2 is cv.downsample_dots else takes_prepared(k2)

    def shadow1(*args, prepared=None, **kw):
        y, st = k1(*args, prepared=prepared, **kw)
        errs['conv3x3_dots'].append(
            rel_rms(y, cv.conv3x3_dots_ref(*args, **kw)[0]))
        return y, st

    def shadow2(x, weight, bias, prepared=None):
        y = k2(x, weight, bias, prepared=prepared)
        errs['downsample_dots'].append(
            rel_rms(y, cv.downsample_dots_ref(x, weight, bias)))
        return y

    def shadow3(x):
        st = stats(x)
        errs['channel_stats'].append(stats_errors(st, x)[0])
        return st

    with torch.inference_mode(), eager_forwards(), mock.patch.multiple(
            cv, conv3x3_dots=shadow1, downsample_dots=shadow2,
            entry_stats=shadow3):
        model(xn, w, adain=adain, enable_fuse=enable_fuse)
    worst = {k: max(v) for k, v in errs.items()}
    print(f'  per call, {label} vs plain on the same inputs: ' + '; '.join(
        f'{k} {len(v)} calls, {"stats" if k == "channel_stats" else "rel_rms"}'
        f' {min(v):.3g}..{max(v):.3g}, {sum(e > CALL_BOUNDS[k] for e in v)} '
        f'above {CALL_BOUNDS[k]}' for k, v in errs.items()), flush=True)
    return worst


def calls_within(worst: dict) -> bool:
    """Whether every op's worst call of per_call is within its bound."""
    return all(v <= CALL_BOUNDS[k] for k, v in worst.items())


def _rate(restorer, xb, w=0.5, adain=True) -> float:
    """Faces/s through restore_device over one window of at least
    RATE_WINDOW_S seconds (host clock, ends in a synchronize)."""
    for _ in range(2):
        restorer.restore_device(xb, w=w, adain=adain)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restorer.restore_device(xb, w=w, adain=adain)
    torch.cuda.synchronize()
    iters = max(2, int(RATE_WINDOW_S / (time.perf_counter() - t0)) + 1)
    t0 = time.perf_counter()
    for _ in range(iters):
        restorer.restore_device(xb, w=w, adain=adain)
    torch.cuda.synchronize()
    return len(xb) * iters / (time.perf_counter() - t0)


def plain_ops():
    """Patch K1/K2 to their plain versions in bf16 (cuDNN conv) and the
    stage-entry statistics to channel_stats: the port's forward as plain
    PyTorch, for timing."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.pipeline.restorer import eager_forwards
    stack = contextlib.ExitStack()
    stack.enter_context(eager_forwards())   # a graph would replay K1/K2
    stack.enter_context(mock.patch.multiple(
        cv, conv3x3_dots=takes_prepared(functools.partial(
            cv.conv3x3_dots_ref, compute_dtype=torch.bfloat16)),
        downsample_dots=takes_prepared(functools.partial(
            cv.downsample_dots_ref, compute_dtype=torch.bfloat16)),
        entry_stats=cv.channel_stats))
    return stack


def phase_rates(restorer, batches, w=0.5, adain=True, label='aligned'):
    """Faces/s of each uint8 RGB batch on the card, kernel path and plain
    path in alternating windows (kernel, plain, plain, kernel, ...);
    median and range of each."""
    print(f'  faces/s through restore_device, w={w}, adain={adain}, TF32 '
          f'off: {RATE_REPEATS} windows of >= {RATE_WINDOW_S} s per path, '
          f'alternating; median [min, max]', flush=True)
    for xb in batches:
        got = {'kernel': [], 'plain': []}
        for rep in range(RATE_REPEATS):
            for path in (('kernel', 'plain') if rep % 2 == 0
                         else ('plain', 'kernel')):
                with (plain_ops() if path == 'plain'
                      else contextlib.nullcontext()):
                    got[path].append(_rate(restorer, xb, w, adain))
        med = {k: statistics.median(v) for k, v in got.items()}
        print(f'  {label} faces/s at B={len(xb)}: kernel '
              f'{med["kernel"]:.2f} [{min(got["kernel"]):.2f}, '
              f'{max(got["kernel"]):.2f}]  plain {med["plain"]:.2f} '
              f'[{min(got["plain"]):.2f}, {max(got["plain"]):.2f}]  ratio '
              f'{med["kernel"] / med["plain"]:.3f}', flush=True)


def print_profile(label: str, prof, iters: int, wall_ms: float) -> None:
    """Device time by kernel from a torch.profiler run over `iters`
    repetitions: busy share against the host wall time and the top 20."""
    # device-side events only (kernels, copies, sets): a CPU op's or an
    # autograd node's device time is the sum of its children's kernels
    rows = [(e.key, e.device_time_total / iters / 1e3, e.count // iters)
            for e in prof.key_averages() if e.device_time_total > 0
            and e.device_type != torch.autograd.DeviceType.CPU]
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f'profile, {label}: wall {wall_ms:.2f} ms (profiler on), device '
          f'kernels {busy:.2f} ms, busy share {busy / wall_ms:.3f}, '
          f'{sum(r[2] for r in rows)} device events a repetition')
    # the top 20, then the port's own kernels that rank lower
    for i, (key, ms, n) in enumerate(rows):
        if i < 20 or 'cf::' in key:
            print(f'  {ms:8.3f} ms {100 * ms / busy:5.1f}% x{n:4d}  '
                  f'{key[:100]}')
    sys.stdout.flush()


def phase_profile(restorer, bsz: int = 8, iters: int = 3):
    """Device time of one forward by kernel (torch.profiler), kernel path
    and plain path."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(1)
    xb = torch.from_numpy(np.stack(_faces(rng, bsz, restorer.face_size))) \
        .to(restorer.device)
    for label, ctx in (('kernel', contextlib.nullcontext()),
                       ('plain', plain_ops())):
        with ctx:
            restorer.restore_device(xb)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(iters):
                    restorer.restore_device(xb)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / iters * 1e3
        print_profile(f'{label} path, B={bsz} forward', prof, iters, wall)


def phase_train_profile(trainer, iters: int = 3):
    """Device time of one stage-II training step by kernel
    (torch.profiler), kernel path and plain path."""
    from torch.profiler import ProfilerActivity, profile
    step = 1000
    for label, ctx in (('kernel', contextlib.nullcontext()),
                       ('plain', plain_train_ops())):
        with ctx:
            step += 1
            trainer.optimize_parameters(step)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(iters):
                    step += 1
                    trainer.optimize_parameters(step)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) / iters * 1e3
        print_profile(f'{label} path, stage-II step B={TRAIN_BATCH}', prof,
                      iters, wall)


# stage-II training at full width (options/CodeFormer_stage2.yml)
TRAIN_BATCH = 4           # batch_size_per_gpu of the config
TRAIN_STEPS = 8
ENCODE_LAUNCHES = {'conv3x3_dots': 28, 'downsample_dots': 5,
                   'channel_stats': 14,
                   'nearest_code': 1,   # one frozen HQ encode, per microbatch
                   'conv3x3_bias': 0, 'conv3x3_dense': 0,
                   'fused_lrelu_fwd': 0, 'fused_lrelu_bwd': 0, 'int_mm': 0}
# idx_gt of the kernel path against the same encode with K1/K2/K3 on
# their plain versions (fp32 sums, TF32 off): random-init codebooks give
# near-flat code scores, so bf16 rounding flips a share of the picks.
# Read 0.9873 on an H100 (PERF.md, Findings): the floor leaves about
# four times that margin. A K2 with symmetric padding reads 0.0039; a
# halo of act(b) in K1 (0.9795) hides in the rounding noise here, and the
# per-call checks of the serving phase catch it.
IDX_AGREEMENT_FLOOR = 0.95


def stage2_options() -> dict:
    """The networks and train block of options/CodeFormer_stage2.yml as a
    dict, bf16, one card, seeded random weights (no vqgan_path or
    pretrained file). Left out: the yml's val/logger blocks and its
    net_d_* keys, which stage II does not read."""
    return {
        'name': 'chip_smoke_stage2', 'model_type': 'CodeFormerIdxModel',
        'manual_seed': 0, 'mixed_precision': 'bf16', 'device': 'cuda',
        'network_g': {'type': 'CodeFormer', 'dim_embd': 512, 'n_head': 8,
                      'n_layers': 9, 'codebook_size': 1024,
                      'connect_list': ['32', '64', '128', '256'],
                      'fix_modules': ['quantize', 'generator']},
        'network_vqgan': {'type': 'VQAutoEncoder', 'img_size': 512,
                          'nf': 64, 'ch_mult': [1, 2, 2, 4, 4, 8],
                          'quantizer': 'nearest', 'codebook_size': 1024},
        'path': {},
        'train': {'use_hq_feat_loss': True, 'feat_loss_weight': 1.0,
                  'cross_entropy_loss': True, 'entropy_loss_weight': 0.5,
                  'fidelity_weight': 0,
                  'optim_g': {'type': 'Adam', 'lr': 1e-4, 'weight_decay': 0,
                              'betas': [0.9, 0.99]},
                  'scheduler': {'type': 'MultiStepLR',
                                'milestones': [400000, 450000],
                                'gamma': 0.5},
                  'total_iter': 500000, 'warmup_iter': -1,
                  'ema_decay': 0.995}}


def stage2_batch(rng, n: int, size: int = 512) -> dict:
    """A loader-shaped batch made on the card: gt = seeded faces in
    [-1, 1], in = gt downsampled x8, upsampled back and given seeded
    noise; both NHWC fp32, as the FFHQ loader gives them."""
    import torch.nn.functional as F
    faces = np.stack(_faces(rng, n, size))[..., ::-1].copy()
    gt = torch.from_numpy(faces).cuda().float().div(127.5).sub(1.0)
    x = gt.permute(0, 3, 1, 2)
    lq = F.interpolate(F.interpolate(x, scale_factor=1 / 8, mode='bilinear',
                                     antialias=True),
                       size=(size, size), mode='bilinear')
    g = torch.Generator(device='cuda').manual_seed(int(rng.integers(1 << 30)))
    lq = lq + 0.05 * torch.randn(lq.shape, generator=g, device='cuda')
    return {'in': lq.clamp(-1, 1).permute(0, 2, 3, 1).contiguous(),
            'gt': gt.contiguous()}


@contextlib.contextmanager
def plain_train_ops():
    """K1/K2 on their plain versions in bf16 (cuDNN) and K3 on its plain
    version: the training step as plain PyTorch, for timing."""
    from codeformer_tpu_torch.ops import vq
    with plain_ops(), mock.patch.object(vq, 'nearest_code_indices',
                                        vq._nearest_code_ref):
        yield


def idx_gt_check(trainer, label: str = 'idx_gt') -> float:
    """idx_gt of the kernel path (the frozen HQ encode on K1/K2, K3)
    against the same encode with K1/K2/K3 on their plain versions (fp32
    sums, TF32 off), on the trainer's batch, and planted faults that must
    fall under the floor. Returns the agreement."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.ops import vq
    mb = trainer.batch

    def idx_with(k1, k2, k3):
        with torch.no_grad(), mock.patch.multiple(
                cv, conv3x3_dots=takes_prepared(k1),
                downsample_dots=takes_prepared(k2)), \
                mock.patch.object(vq, 'nearest_code_indices', k3):
            return trainer._idx_gt(mb)
    with torch.no_grad():
        idx_k = trainer._idx_gt(mb)
    idx_r = idx_with(cv.conv3x3_dots_ref, cv.downsample_dots_ref,
                     vq._nearest_code_ref)
    agree = float((idx_k == idx_r).float().mean())
    faults = {
        'K2 symmetric pad': idx_with(cv.conv3x3_dots_ref, k2_fault,
                                     vq._nearest_code_ref),
        'K1 halo act(b)': idx_with(k1_fault('halo act(b)'),
                                   cv.downsample_dots_ref,
                                   vq._nearest_code_ref)}
    fault_agree = {k: float((v == idx_r).float().mean())
                   for k, v in faults.items()}
    print(f'  {label} vs the plain-op encode: agreement {agree:.4f} (>= '
          f'{IDX_AGREEMENT_FLOOR}); planted faults: ' + ', '.join(
              f'{k} {v:.4f}' for k, v in fault_agree.items()), flush=True)
    if agree < IDX_AGREEMENT_FLOOR:
        raise SystemExit(f'chip_smoke: {label} of the kernel path disagrees '
                         f'with the plain-op encode')
    if fault_agree['K2 symmetric pad'] >= IDX_AGREEMENT_FLOOR:
        raise SystemExit(f'chip_smoke: the {label} bound lets the planted '
                         f'fault K2 symmetric pad pass')
    return agree


def phase_train():
    """Stage-II training at full width: TRAIN_STEPS steps on one fixed
    batch through CodeFormerIdxModel.optimize_parameters, with exact
    launch counts per step, the checks of PERF.md, idx_gt against the
    plain-op encode (and a planted fault), faces/s of the kernel and the
    plain path, peak memory. Returns the launch counts of the steps and
    the trainer."""
    from codeformer_tpu_torch.nn.blocks import ResBlock
    from codeformer_tpu_torch.train.trainers import build_model
    t0 = time.perf_counter()
    trainer = build_model(stage2_options())
    net = trainer.net_g
    n_hq = sum(isinstance(m, ResBlock) and m.use_kernels
               for m in trainer.hq_vqgan.encoder.modules())
    n_g = sum(isinstance(m, ResBlock) and m.use_kernels
              for m in net.modules())
    print(f'stage II trainer: CodeFormer dim_embd 512, 9 layers, 1024 codes, '
          f'connect 32/64/128/256, nf 64, ch_mult 1,2,2,4,4,8; frozen HQ '
          f'VQGAN; bf16 activations, fp32 params; AdamW 1e-4 (0.9, 0.99), '
          f'MultiStepLR, EMA 0.995; B={TRAIN_BATCH}; built in '
          f'{time.perf_counter() - t0:.1f} s. ResBlocks on K1: HQ encoder '
          f'{n_hq}, net_g {n_g} (textbook, autograd)', flush=True)
    rng = np.random.default_rng(5)
    batch = stage2_batch(rng, TRAIN_BATCH)
    trainer.feed_data(batch)
    frozen = {k: v.clone() for k, v in net.state_dict().items()
              if k.split('.')[0] in ('quantize', 'generator')}
    encode_counts = []
    idx_gt = trainer._idx_gt

    def counted_idx_gt(mb):
        before = launch_counts()
        out = idx_gt(mb)
        after = launch_counts()
        encode_counts.append({k: after[k] - before[k] for k in after})
        return out
    trainer._idx_gt = counted_idx_gt
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    totals, losses = {}, []
    for step in range(1, TRAIN_STEPS + 1):
        before = launch_counts()
        trainer.optimize_parameters(step)
        torch.cuda.synchronize()
        after = launch_counts()
        step_counts = {k: after[k] - before[k] for k in after}
        log = trainer.log_dict
        losses.append(log)
        print(f'  step {step}: ' + ', '.join(f'{k} {v:.5f}'
                                            for k, v in log.items())
              + f'; launches {step_counts}', flush=True)
        if step_counts != ENCODE_LAUNCHES or encode_counts[-1] != \
                ENCODE_LAUNCHES:
            raise SystemExit(f'chip_smoke: step {step} launched '
                             f'{step_counts} ({encode_counts[-1]} in the '
                             f'frozen encode), expected {ENCODE_LAUNCHES} '
                             f'all in the encode and none in net_g')
        if not all(np.isfinite(v) for v in log.values()):
            raise SystemExit(f'chip_smoke: non-finite loss at step {step}')
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer._idx_gt = idx_gt
    grad = net.encoder.blocks[1].conv1.weight.grad
    first, last = losses[0]['l_g_total'], losses[-1]['l_g_total']
    moved = [k for k, v in frozen.items()
             if not torch.equal(v, net.state_dict()[k])]
    print(f'  l_g_total {first:.5f} -> {last:.5f}; first encoder ResBlock '
          f'conv1 grad '
          + ('None' if grad is None
             else f'RMS {float(grad.pow(2).mean().sqrt()):.3g}')
          + f'; frozen tensors moved: {len(moved)} of {len(frozen)}; peak '
          f'memory {peak:.2f} GiB; launches over {TRAIN_STEPS} steps '
          f'{counts}', flush=True)
    if not last < first:
        raise SystemExit('chip_smoke: the training loss did not fall')
    if grad is None or float(grad.abs().max()) == 0.0:
        raise SystemExit('chip_smoke: no gradient reaches the encoder')
    if moved:
        raise SystemExit(f'chip_smoke: frozen modules moved: {moved[:3]}')

    idx_gt_check(trainer)
    rate = phase_train_rates(trainer)
    return counts, trainer, rate


def _train_rate(trainer, step0: int) -> tuple:
    """(faces/s over one window of at least RATE_WINDOW_S, share of the
    step in the frozen encode, steps taken); host clock ending in a
    synchronize, encode share from CUDA events."""
    idx_gt = trainer._idx_gt
    spans = []

    def timed(mb):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = idx_gt(mb)
        b.record()
        spans.append((a, b))
        return out
    step = step0
    for _ in range(2):
        step += 1
        trainer.optimize_parameters(step)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step += 1
    trainer.optimize_parameters(step)
    torch.cuda.synchronize()
    iters = max(2, int(RATE_WINDOW_S / (time.perf_counter() - t0)) + 1)
    trainer._idx_gt = timed
    try:
        t0 = time.perf_counter()
        for _ in range(iters):
            step += 1
            trainer.optimize_parameters(step)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        trainer._idx_gt = idx_gt
    enc_ms = sum(a.elapsed_time(b) for a, b in spans)
    return TRAIN_BATCH * iters / wall, enc_ms / (wall * 1e3), step


def phase_train_rates(trainer):
    """Training faces/s, kernel path and plain path in alternating
    windows; median [min, max]; the frozen encode's share of the step."""
    print(f'  training faces/s (B={TRAIN_BATCH}, full step: HQ encode + '
          f'net_g forward/backward + AdamW + EMA), TF32 off: '
          f'{RATE_REPEATS} windows of >= {RATE_WINDOW_S} s per path, '
          f'alternating; median [min, max]', flush=True)
    got = {'kernel': [], 'plain': []}
    share = {'kernel': [], 'plain': []}
    step = 100
    for rep in range(RATE_REPEATS):
        for path in (('kernel', 'plain') if rep % 2 == 0
                     else ('plain', 'kernel')):
            if path == 'plain':
                with plain_train_ops():
                    rate, sh, step = _train_rate(trainer, step)
            else:
                rate, sh, step = _train_rate(trainer, step)
            got[path].append(rate)
            share[path].append(sh)
    med = {k: statistics.median(v) for k, v in got.items()}
    print(f'  training faces/s at B={TRAIN_BATCH}: kernel {med["kernel"]:.2f} '
          f'[{min(got["kernel"]):.2f}, {max(got["kernel"]):.2f}]  plain '
          f'{med["plain"]:.2f} [{min(got["plain"]):.2f}, '
          f'{max(got["plain"]):.2f}]  ratio '
          f'{med["kernel"] / med["plain"]:.3f}; frozen-encode share of the '
          f'step: kernel {statistics.median(share["kernel"]):.3f}, plain '
          f'{statistics.median(share["plain"]):.3f}', flush=True)
    return med['kernel']


# stage I (VQGANModel) and stage III (CodeFormerJointModel, CodeFormerModel)
# at full width; LPIPS on seeded VGG16 and lin-head stand-ins (no weights
# ship with the repository)
STAGE1_ITERS = (30000, 30001, 30002, 30003, 30004)   # net_d_start_iter 30001
STAGE3_BATCH = 3          # batch_size_per_gpu of both stage-III configs
# code step (large degradation), d-only step (small, generator gated),
# full step (small, generator on): past 120000 the joint schedule takes one
# small-degradation iteration in 15, and net_d_iters 2 gates odd ones
STAGE3_ITERS = (120002, 120015, 120030)
STAGE3_KINDS = ('code', 'd-only', 'full')
NO_LAUNCHES = {k: 0 for k in ENCODE_LAUNCHES}
# the card-vs-CPU fp32 step (TF32 off): both sum in other orders; losses
# and d_weight within 1e-4 relative, gradients within 1e-3 relative RMS.
# LPIPS weighs 0.1 there: at random init its input gradient is mostly
# high-frequency and its pull-back through the generator cancels about
# 500-fold, so at weight 1 that part of the gradient carries 3.5e-3 of
# rounding between any two summation orders (tests/test_torch_stage1.py)
CARD_CPU_LOSS_RTOL = 1e-4
CARD_CPU_GRAD_RTOL = 1e-3


@contextlib.contextmanager
def vgg_standins(seed: int = 11):
    """weights/vgg/vgg16.pth (He-scaled seeded convs) and lpips_vgg.pth
    (seeded heads in [0, 0.2)) in a temporary directory made the working
    directory, where LPIPSLoss reads them; nothing is written into the
    repository."""
    import tempfile
    g = torch.Generator().manual_seed(seed)
    old = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, 'weights', 'vgg'))
        sd, idx, cin = {}, 0, 3
        for ch, n in ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3)):
            for _ in range(n):
                sd[f'features.{idx}.weight'] = torch.randn(
                    ch, cin, 3, 3, generator=g) * (2.0 / (9 * cin)) ** 0.5
                sd[f'features.{idx}.bias'] = torch.zeros(ch)
                idx, cin = idx + 2, ch
            idx += 1
        torch.save(sd, os.path.join(tmp, 'weights', 'vgg', 'vgg16.pth'))
        torch.save({f'lin{i}.model.1.weight':
                    torch.rand(1, c, 1, 1, generator=g) * 0.2
                    for i, c in enumerate((64, 128, 256, 512, 512))},
                   os.path.join(tmp, 'weights', 'vgg', 'lpips_vgg.pth'))
        os.chdir(tmp)
        try:
            yield tmp
        finally:
            os.chdir(old)


def gan_train_block(**over) -> dict:
    """The train: block the stage-I and stage-III configs share (Adam,
    L1 pixel loss, LPIPS with the reference's double normalisation, the
    hinge GAN loss, the discriminator gates)."""
    adam = {'type': 'Adam', 'lr': 7e-5, 'weight_decay': 0,
            'betas': [0.9, 0.99]}
    block = {'optim_g': dict(adam), 'optim_d': dict(adam),
             'warmup_iter': -1,
             'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0,
                           'reduction': 'mean'},
             'perceptual_opt': {'type': 'LPIPSLoss', 'loss_weight': 1.0,
                                'use_input_norm': True, 'range_norm': True},
             'gan_opt': {'type': 'GANLoss', 'gan_type': 'hinge',
                         'loss_weight': 1.0},
             'net_g_start_iter': 0, 'net_d_iters': 1}
    block.update(over)
    return block


def stage1_options() -> dict:
    """options/VQGAN_512_ds32_nearest_stage1.yml as a dict, bf16, one
    card, seeded random weights, its val and logger blocks left out."""
    return {
        'name': 'chip_smoke_stage1', 'model_type': 'VQGANModel',
        'manual_seed': 0, 'mixed_precision': 'bf16', 'device': 'cuda',
        'network_g': {'type': 'VQAutoEncoder', 'img_size': 512, 'nf': 64,
                      'ch_mult': [1, 2, 2, 4, 4, 8], 'quantizer': 'nearest',
                      'codebook_size': 1024},
        'network_d': {'type': 'VQGANDiscriminator', 'nc': 3, 'ndf': 64},
        'path': {},
        'train': gan_train_block(
            scheduler={'type': 'CosineAnnealingRestartLR',
                       'periods': [1600000], 'restart_weights': [1],
                       'eta_min': 6e-5},
            total_iter=1600000, ema_decay=0.995, net_d_start_iter=30001)}


def stage3_options(inpainting: bool = False) -> dict:
    """options/CodeFormer_stage3.yml (or CodeFormer_inpainting.yml) as a
    dict, bf16, one card, seeded random weights, the pretrained paths (not
    in the repository) cleared. The stage-III config's net_d_iters is 2
    here, so that its d-only step runs too (the config's 1 gates nothing)."""
    codes = 512 if inpainting else 1024
    opt = {
        'name': 'chip_smoke_stage3', 'manual_seed': 0,
        'model_type': 'CodeFormerModel' if inpainting
        else 'CodeFormerJointModel',
        'mixed_precision': 'bf16', 'device': 'cuda',
        'network_g': {'type': 'CodeFormer', 'dim_embd': 512, 'n_head': 8,
                      'n_layers': 9, 'codebook_size': codes,
                      'connect_list': ['32', '64', '128'] if inpainting
                      else ['32', '64', '128', '256'],
                      'fix_modules': ['quantize', 'generator']},
        'network_vqgan': {'type': 'VQAutoEncoder', 'img_size': 512,
                          'nf': 64, 'ch_mult': [1, 2, 2, 4, 4, 8],
                          'quantizer': 'nearest', 'codebook_size': codes},
        'network_d': {'type': 'VQGANDiscriminator', 'nc': 3, 'ndf': 64,
                      'n_layers': 4},
        'path': {},
        'train': gan_train_block(
            use_hq_feat_loss=True, feat_loss_weight=1.0,
            cross_entropy_loss=True, entropy_loss_weight=0.5,
            total_iter=150000, ema_decay=0.997)}
    t = opt['train']
    if inpainting:
        adam = {'type': 'Adam', 'lr': 7e-5, 'weight_decay': 0,
                'betas': [0.9, 0.99]}
        t.update(optim_g=dict(adam), optim_d=dict(adam), total_iter=300000,
                 fidelity_weight=1.0, scale_adaptive_gan_weight=0.8,
                 use_adaptive_weight=True, net_d_start_iter=296001,
                 scheduler={'type': 'MultiStepLR',
                            'milestones': [250000, 300000], 'gamma': 0.5})
    else:
        adam = {'type': 'Adam', 'lr': 5e-5, 'weight_decay': 0,
                'betas': [0.9, 0.99]}
        t.update(optim_g=dict(adam), optim_d=dict(adam),
                 scale_adaptive_gan_weight=0.1, net_d_start_iter=0,
                 net_d_iters=2,
                 scheduler={'type': 'CosineAnnealingRestartLR',
                            'periods': [150000], 'restart_weights': [1],
                            'eta_min': 2e-5})
    return opt


def stage3_batch(rng, n: int) -> dict:
    """stage2_batch plus `in_large_de`, the joint dataset's stronger
    degradation (x16 down, more noise), made on the card."""
    import torch.nn.functional as F
    batch = stage2_batch(rng, n)
    x = batch['gt'].permute(0, 3, 1, 2)
    lq = F.interpolate(F.interpolate(x, scale_factor=1 / 16, mode='bilinear',
                                     antialias=True),
                       size=x.shape[2:], mode='bilinear')
    g = torch.Generator(device='cuda').manual_seed(int(rng.integers(1 << 30)))
    lq = lq + 0.1 * torch.randn(lq.shape, generator=g, device='cuda')
    batch['in_large_de'] = lq.clamp(-1, 1).permute(0, 2, 3, 1).contiguous()
    return batch


def counted_step(trainer, it: int) -> dict:
    """optimize_parameters(it) to the end on the card; the launches it
    made."""
    before = launch_counts()
    trainer.optimize_parameters(it)
    torch.cuda.synchronize()
    after = launch_counts()
    return {k: after[k] - before[k] for k in after}


def gan_rate(trainer, it: int, n_faces: int) -> float:
    """Training faces/s of iteration `it` taken over and over: two warm-up
    steps, then a window of at least RATE_WINDOW_S (host clock ending in a
    synchronize)."""
    for _ in range(2):
        trainer.optimize_parameters(it)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    trainer.optimize_parameters(it)
    torch.cuda.synchronize()
    iters = max(2, int(RATE_WINDOW_S / (time.perf_counter() - t0)) + 1)
    t0 = time.perf_counter()
    for _ in range(iters):
        trainer.optimize_parameters(it)
    torch.cuda.synchronize()
    return n_faces * iters / (time.perf_counter() - t0)


def phase_stage1():
    """Stage I at the full width of the stage-I config, bf16, B=4:
    iterations 30000-30004 either side of net_d_start_iter 30001 with
    exact launch counts (one K3 a step, in the quantizer; no K1/K2, net_g
    is textbook), finite losses and d_weight, the discriminator and its
    Adam and BatchNorm state untouched before the gate and stepping after
    it, each step's K3 picks on its own latents held to the plain search,
    faces/s and peak memory. Returns the launch counts."""
    from codeformer_tpu_torch.ops import vq
    from codeformer_tpu_torch.train.trainers import build_model
    t0 = time.perf_counter()
    with vgg_standins():
        trainer = build_model(stage1_options())
    print(f'stage I trainer: VQAutoEncoder nf 64, ch_mult 1,2,2,4,4,8, 1024 '
          f'codes; VQGANDiscriminator ndf 64, 4 layers; LPIPS VGG16 '
          f'(seeded stand-ins); bf16 activations, fp32 params; B='
          f'{TRAIN_BATCH}; built in {time.perf_counter() - t0:.1f} s',
          flush=True)
    batch = stage2_batch(np.random.default_rng(7), TRAIN_BATCH)
    trainer.feed_data({'gt': batch['gt']})
    d0 = {k: v.clone() for k, v in trainer.net_d.state_dict().items()}
    picks = []
    search = vq.nearest_code_indices

    def recorded(z, e):
        idx = search(z, e)
        picks.append((z.detach().clone(), e.detach().clone(), idx.clone()))
        return idx
    want = dict(NO_LAUNCHES, nearest_code=1)
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    with mock.patch.object(vq, 'nearest_code_indices', recorded):
        for it in STAGE1_ITERS:
            got = counted_step(trainer, it)
            log = trainer.log_dict
            gate = it > 30001
            print(f'  iter {it} (d {"on" if gate else "off"}): '
                  + ', '.join(f'{k} {v:.5g}' for k, v in log.items())
                  + f'; launches {got}; optimizer_d steps {trainer.step_d}',
                  flush=True)
            if got != want:
                raise SystemExit(f'chip_smoke: stage-I iteration {it} '
                                 f'launched {got}, expected {want}')
            if not all(np.isfinite(v) for v in log.values()):
                raise SystemExit(f'chip_smoke: non-finite stage-I log at '
                                 f'{it}')
            if not gate and (trainer.step_d or trainer.optimizer_d.state
                             or any(not torch.equal(v, d0[k]) for k, v in
                                    trainer.net_d.state_dict().items())):
                raise SystemExit('chip_smoke: the discriminator moved before '
                                 'net_d_start_iter')
    counts = launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    bn_moved = not torch.equal(trainer.net_d.main[3].running_mean,
                               d0['main.3.running_mean'])
    if trainer.step_d != 3 or not bn_moved or not trainer.optimizer_d.state:
        raise SystemExit(f'chip_smoke: the discriminator did not step past '
                         f'net_d_start_iter ({trainer.step_d} steps)')
    verdicts = [k3_verdict(idx, vq._nearest_code_ref(z, e), z, e)
                for z, e, idx in picks]
    print(f'  K3 picks of the {len(picks)} steps against the plain search: '
          f'agreement {min(v["agree"] for v in verdicts):.6f} (lowest), worst '
          f'relative gap {max(v["worst_gap"] for v in verdicts):.2e} (<= '
          f'{K3_MARGIN}); peak memory {peak:.2f} GiB over the 5 steps',
          flush=True)
    if not all(v['ok'] for v in verdicts):
        raise SystemExit('chip_smoke: a stage-I K3 pick is off the nearest '
                         'code')
    rate = gan_rate(trainer, STAGE1_ITERS[-1], TRAIN_BATCH)
    print(f'  stage-I training faces/s at B={TRAIN_BATCH} (g step with LPIPS '
          f'and the adaptive weight, d step, EMA): {rate:.2f}; peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB', flush=True)
    del trainer, picks
    torch.cuda.empty_cache()
    return counts


def small_stage1_options(device: str) -> dict:
    """The stage-I config cut to a width both the card and the host step
    in seconds (128^2, nf 32, ch_mult 1,2,2,4, 256 codes of 64; ndf 16, 3
    layers), fp32, LPIPS at 0.1 (CARD_CPU_GRAD_RTOL)."""
    opt = stage1_options()
    opt.update(mixed_precision='fp32', device=device)
    opt['network_g'].update(img_size=128, nf=32, ch_mult=[1, 2, 2, 4],
                            codebook_size=256, emb_dim=64)
    opt['network_d'].update(ndf=16, n_layers=3)
    opt['train']['perceptual_opt']['loss_weight'] = 0.1
    return opt


def eval_mode_fault(self, out):
    """Planted fault: the generator-side GAN term with net_d in train mode
    (batch statistics), as the reference PyTorch does and JAX does not."""
    self.net_d.train().requires_grad_(False)
    return self._gan_loss(self.net_d(out.to(self.compute_dtype)), True,
                          is_disc=False)


def phase_stage1_cpu_check():
    """One fp32 stage-I step past net_d_start_iter at a reduced width on
    the card and on the host from the same seeded weights and batch:
    losses and d_weight within CARD_CPU_LOSS_RTOL, the generator's and the
    discriminator's gradients within CARD_CPU_GRAD_RTOL relative RMS; the
    g-step with net_d in train mode (planted) must fall outside."""
    from codeformer_tpu_torch.train.trainers import VQGANModel, build_model
    gt = stage2_batch(np.random.default_rng(8), 2, size=128)['gt']
    runs = {}
    for label, device in (('cpu', 'cpu'), ('card', 'cuda'),
                          ('planted', 'cuda')):
        with vgg_standins():
            trainer = build_model(small_stage1_options(device))
        trainer.feed_data({'gt': gt.to(trainer.device)})
        if label == 'planted':
            with mock.patch.object(VQGANModel, '_g_gan_loss',
                                   eval_mode_fault):
                trainer.optimize_parameters(STAGE1_ITERS[-1])
        else:
            trainer.optimize_parameters(STAGE1_ITERS[-1])
        grads = torch.cat([p.grad.detach().float().cpu().reshape(-1)
                           for net in (trainer.net_g, trainer.net_d)
                           for p in net.parameters() if p.grad is not None])
        runs[label] = (dict(trainer.log_dict), grads)
    ref_log, ref_g = runs['cpu']

    def verdict(label):
        log, g = runs[label]
        # l_g_gan = d_weight * -mean(pred): the mean sits near 0, so it is
        # held relative to d_weight (predictions of size 1), not to itself
        scale = {k: abs(ref_log[k]) for k in ref_log}
        scale['l_g_gan'] = ref_log['d_weight']
        loss_err = max(abs(log[k] - ref_log[k]) / max(scale[k], 1e-30)
                       for k in ('l_g_total', 'l_g_pix', 'l_g_percep',
                                 'l_codebook', 'l_g_gan', 'l_d_real',
                                 'l_d_fake', 'd_weight'))
        grad_err = float((g - ref_g).norm() / ref_g.norm()) \
            if g.shape == ref_g.shape else float('inf')
        ok = loss_err <= CARD_CPU_LOSS_RTOL and grad_err <= CARD_CPU_GRAD_RTOL
        return loss_err, grad_err, ok
    got, fault = verdict('card'), verdict('planted')
    print(f'stage-I fp32 step at 128^2 (nf 32), card vs CPU: losses and '
          f'd_weight max rel {got[0]:.2e} (<= {CARD_CPU_LOSS_RTOL}), '
          f'gradients rel RMS {got[1]:.2e} (<= {CARD_CPU_GRAD_RTOL}); d_weight '
          f'{runs["card"][0]["d_weight"]:.5g} vs {ref_log["d_weight"]:.5g}; '
          f'planted fault (g step with net_d in train mode): {fault[0]:.2e} / '
          f'{fault[1]:.2e} -> {"passes (BAD)" if fault[2] else "fails"}',
          flush=True)
    if not got[2]:
        raise SystemExit('chip_smoke: the stage-I step on the card disagrees '
                         'with the host')
    if fault[2]:
        raise SystemExit('chip_smoke: the card-vs-CPU bounds let the planted '
                         'train-mode g step pass')


def phase_stage3():
    """Stage III at the full width of the stage-III config, bf16, B=3
    (SFT branches tamed, tame_sft): a code, a d-only and a full step with
    exact launch counts (K1 28, K2 5 and K3 1 from the frozen HQ encode
    of every step that takes idx_gt, none elsewhere), finite losses,
    frozen quantize/generator unchanged, idx_gt against the plain-op
    encode (and a planted fault), faces/s of the full and the code step,
    peak memory; then one CodeFormerModel step of the inpainting config.
    Returns the launch counts of the stepped iterations."""
    from codeformer_tpu_torch.train.trainers import build_model
    t0 = time.perf_counter()
    with vgg_standins():
        trainer = build_model(stage3_options())
    with torch.no_grad():
        tame_sft(trainer.net_g)
    trainer.reset_ema()
    print(f'stage III trainer: CodeFormer dim_embd 512, 9 layers, 1024 codes, '
          f'connect 32/64/128/256, frozen quantize and generator; frozen HQ '
          f'VQGAN; VQGANDiscriminator ndf 64; LPIPS VGG16 (seeded stand-ins); '
          f'bf16; B={STAGE3_BATCH}; built in {time.perf_counter() - t0:.1f} s',
          flush=True)
    trainer.feed_data(stage3_batch(np.random.default_rng(9), STAGE3_BATCH))
    net = trainer.net_g
    frozen = {k: v.clone() for k, v in net.state_dict().items()
              if k.split('.')[0] in ('quantize', 'generator')}
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    for it, kind in zip(STAGE3_ITERS, STAGE3_KINDS):
        got = counted_step(trainer, it)
        want = NO_LAUNCHES if kind == 'd-only' else ENCODE_LAUNCHES
        log = trainer.log_dict
        print(f'  iter {it} ({kind} step): ' + ', '.join(
            f'{k} {v:.5g}' for k, v in log.items()) + f'; launches {got}',
            flush=True)
        if got != want:
            raise SystemExit(f'chip_smoke: stage-III {kind} step launched '
                             f'{got}, expected {want}')
        if not log or not all(np.isfinite(v) for v in log.values()):
            raise SystemExit(f'chip_smoke: stage-III {kind} step log {log}')
    counts = launch_counts()
    moved = [k for k, v in frozen.items()
             if not torch.equal(v, net.state_dict()[k])]
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f'  frozen tensors moved: {len(moved)} of {len(frozen)}; optimizer '
          f'steps g {trainer.step}, d {trainer.step_d}; peak memory '
          f'{peak:.2f} GiB', flush=True)
    if moved or (trainer.step, trainer.step_d) != (2, 2):
        raise SystemExit('chip_smoke: stage III moved a frozen module or '
                         'stepped the wrong optimizers')
    idx_gt_check(trainer, 'stage-III idx_gt')
    rates = {kind: gan_rate(trainer, it, STAGE3_BATCH)
             for it, kind in zip(STAGE3_ITERS, STAGE3_KINDS) if kind != 'd-only'}
    print(f'  stage-III training faces/s at B={STAGE3_BATCH}: full step '
          f'{rates["full"]:.2f}, code step {rates["code"]:.2f}; peak memory '
          f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB', flush=True)
    del trainer, net, frozen
    torch.cuda.empty_cache()

    with vgg_standins():
        trainer = build_model(stage3_options(inpainting=True))
    with torch.no_grad():
        tame_sft(trainer.net_g)
    trainer.reset_ema()
    trainer.feed_data(stage2_batch(np.random.default_rng(10), STAGE3_BATCH))
    torch.cuda.reset_peak_memory_stats()
    got = counted_step(trainer, 1)
    log = trainer.log_dict
    print(f'  CodeFormerModel (inpainting config: 512 codes, connect '
          f'32/64/128, fidelity_weight 1), iteration 1: ' + ', '.join(
              f'{k} {v:.5g}' for k, v in log.items()) + f'; launches {got}; '
          f'peak memory {torch.cuda.max_memory_allocated() / 2 ** 30:.2f} '
          f'GiB', flush=True)
    if got != ENCODE_LAUNCHES or not all(np.isfinite(v)
                                         for v in log.values()) \
            or 'd_weight' not in log:
        raise SystemExit('chip_smoke: the CodeFormerModel step failed')
    for k, v in got.items():
        counts[k] += v
    del trainer
    torch.cuda.empty_cache()
    return counts


# ---------------------------------------------------------------------
# the training framework's outer ring: remat, generate_latent_gt,
# validation, the device prefetcher, data parallelism over NCCL, SRModel
# and ResNetArcFace
STAGE3_FULL_ITER = STAGE3_ITERS[2]
# remat against no remat in an fp32 step on the card: the recompute runs
# the same kernels on the same inputs (cuDNN deterministic), so the
# gradients agree to rounding at most
REMAT_GRAD_RTOL = 1e-6


def remat_options(opt: dict, remat: bool) -> dict:
    opt = dict(opt, train=dict(opt['train'], remat=remat))
    return opt


def remat_rate(make, batch: dict, it: int, want: dict, label: str):
    """Build a trainer with `make()`, one counted step at `it` on `batch`
    (launches must equal `want`), then faces/s (gan_rate) and the peak
    memory of the steps. Returns (faces/s, peak GiB, launches)."""
    with vgg_standins():
        trainer = make()
    if hasattr(trainer.net_g, 'fuse_convs_dict'):
        with torch.no_grad():
            tame_sft(trainer.net_g)
        trainer.reset_ema()
    trainer.feed_data(batch)
    n_faces = batch['gt'].shape[0]
    torch.cuda.reset_peak_memory_stats()
    got = counted_step(trainer, it)
    if got != want:
        raise SystemExit(f'chip_smoke: {label} launched {got}, expected '
                         f'{want}')
    rate = gan_rate(trainer, it, n_faces)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log = trainer.log_dict
    if not all(np.isfinite(v) for v in log.values()):
        raise SystemExit(f'chip_smoke: {label} log {log}')
    del trainer
    torch.cuda.empty_cache()
    return rate, peak, got


def remat_fp32_check():
    """One fp32 stage-I step at 128^2 (nf 32) on the card with and without
    remat from the same seeded weights and batch: the gradients of net_g
    and net_d within REMAT_GRAD_RTOL, the losses equal."""
    from codeformer_tpu_torch.train.trainers import build_model
    gt = stage2_batch(np.random.default_rng(8), 2, size=128)['gt']
    runs = {}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            with vgg_standins():
                trainer = build_model(remat_options(
                    small_stage1_options('cuda'), remat))
            trainer.feed_data({'gt': gt})
            trainer.optimize_parameters(STAGE1_ITERS[-1])
            grads = torch.cat([p.grad.detach().float().reshape(-1)
                               for net in (trainer.net_g, trainer.net_d)
                               for p in net.parameters()
                               if p.grad is not None])
            runs[remat] = (dict(trainer.log_dict), grads)
            del trainer
    finally:
        torch.backends.cudnn.deterministic = det
    (log0, g0), (log1, g1) = runs[False], runs[True]
    err = rel_rms(g1, g0) if g1.shape == g0.shape else float('inf')
    loss_err = max(abs(log1[k] - log0[k]) / max(abs(log0[k]), 1e-30)
                   for k in log0)
    print(f'  fp32 stage-I step at 128^2, remat vs none on the card: '
          f'gradients rel RMS {err:.2e} (<= {REMAT_GRAD_RTOL}), losses max '
          f'rel {loss_err:.2e}, bit-equal gradients: '
          f'{bool(torch.equal(g0, g1))}', flush=True)
    if err > REMAT_GRAD_RTOL or loss_err > REMAT_GRAD_RTOL:
        raise SystemExit('chip_smoke: remat changes the stage-I step')


def phase_remat():
    """`train: remat: true` at full width, bf16: stage I at B=4 (iteration
    30004, past the gate) and stage III's full step at B=3, each built
    with and without remat: launches a step unchanged (K3 1 in stage I;
    K1 28, K2 5, K3 1 in stage III), training faces/s and peak memory;
    then the fp32 gradient check. Returns the launch counts of the remat
    steps."""
    from codeformer_tpu_torch.train.trainers import build_model
    counts = {k: 0 for k in ENCODE_LAUNCHES}
    rng = np.random.default_rng(12)
    cases = (('stage I', stage1_options, STAGE1_ITERS[-1],
              {'gt': stage2_batch(rng, TRAIN_BATCH)['gt']},
              dict(NO_LAUNCHES, nearest_code=1)),
             ('stage III full step', stage3_options, STAGE3_FULL_ITER,
              stage3_batch(rng, STAGE3_BATCH), ENCODE_LAUNCHES))
    print('remat (train: remat: true), bf16, full width; faces/s over one '
          f'window of >= {RATE_WINDOW_S} s, peak memory of the steps:',
          flush=True)
    for label, options, it, batch, want in cases:
        row = {}
        n = batch['gt'].shape[0]
        for remat in (False, True):
            row[remat] = remat_rate(
                lambda: build_model(remat_options(options(), remat)), batch,
                it, want, f'{label} remat={remat}')
        for k, v in row[True][2].items():
            counts[k] += v
        (r0, p0, _), (r1, p1, _) = row[False], row[True]
        print(f'  {label} B={n}: no remat {r0:.2f} faces/s, peak {p0:.2f} '
              f'GiB; remat {r1:.2f} faces/s, peak {p1:.2f} GiB (rate x'
              f'{r1 / r0:.3f}, peak x{p1 / p0:.3f}); launches a step '
              f'{row[True][2]}', flush=True)
    remat_fp32_check()
    return counts


# generate_latent_gt: 16 seeded 512^2 faces at the script's batch of 8
LATENT_FACES = 16
LATENT_BATCH = 8
# bf16 (K1/K2 encode, K3 on bf16 tokens) against fp32 picks: random-init
# codebooks give near-flat code scores, so bf16 rounding flips a share
# (stage III's bf16 idx_gt reads 0.9766 against the plain-op encode,
# PERF.md)
LATENT_BF16_FLOOR = 0.97


def phase_latent_gt():
    """The generate_latent_gt core (cli/generate_latent_gt.py `encode`) on
    the card at full width: LATENT_FACES seeded faces and their h-flips,
    batch 8 (T = 2048 tokens a K3 call), fp32 and bf16. fp32 picks against
    the plain search on the same latents (apart from K3's ties,
    k3_verdict), bf16 against fp32, images/s and launches. Returns the
    launch counts of both dtypes' encodes."""
    from codeformer_tpu_torch.cli import generate_latent_gt as glg
    from codeformer_tpu_torch.ops import vq
    faces = np.stack(_faces(np.random.default_rng(13), LATENT_FACES))
    x = torch.from_numpy(faces[..., ::-1].copy()).cuda().float() \
        .div(127.5).sub(1.0).permute(0, 3, 1, 2)
    x = torch.cat([x, x.flip(-1)])       # the originals, then the h-flips
    counts = {k: 0 for k in ENCODE_LAUNCHES}
    picks, rates = {}, {}
    for name, dtype in (('fp32', torch.float32), ('bf16', torch.bfloat16)):
        model = glg.build_vqgan(None, seed=0, dtype=dtype, device='cuda')
        recorded = []
        search = vq.nearest_code_indices

        def record(z, e):
            idx = search(z, e)
            recorded.append((z.detach().clone(), e, idx.clone()))
            return idx

        def run_all():
            return torch.cat([glg.encode(model, x[i:i + LATENT_BATCH], dtype)
                              for i in range(0, len(x), LATENT_BATCH)])
        reset_launch_counts()
        with mock.patch.object(vq, 'nearest_code_indices', record):
            picks[name] = run_all()
        torch.cuda.synchronize()
        got = launch_counts()
        n_calls = len(x) // LATENT_BATCH
        want = dict(NO_LAUNCHES, nearest_code=n_calls)
        if dtype == torch.bfloat16:
            want.update(forward_launches(14, n_calls, tail=0))
        if got != want:
            raise SystemExit(f'chip_smoke: generate_latent_gt {name} '
                             f'launched {got}, expected {want}')
        for k, v in got.items():
            counts[k] += v
        verdicts = [k3_verdict(idx, vq._nearest_code_ref(z, e), z, e)
                    for z, e, idx in recorded]
        if recorded[0][0].shape[0] != LATENT_BATCH * 256:
            raise SystemExit('chip_smoke: generate_latent_gt K3 call is not '
                             'at T = 2048')
        for _ in range(2):
            run_all()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 3
        for _ in range(reps):
            run_all()
        torch.cuda.synchronize()
        rates[name] = reps * len(x) / (time.perf_counter() - t0)
        agree = min(v['agree'] for v in verdicts)
        print(f'  generate_latent_gt {name}: {len(x)} images ({LATENT_FACES} '
              f'faces and their h-flips) at batch {LATENT_BATCH}, T = '
              f'{LATENT_BATCH * 256} a K3 call; K3 picks vs the plain search '
              f'on the same latents {agree:.6f} (worst gap '
              f'{max(v["worst_gap"] for v in verdicts):.2e} <= {K3_MARGIN}); '
              f'{rates[name]:.2f} images/s; launches {got}', flush=True)
        if not all(v['ok'] for v in verdicts):
            raise SystemExit(f'chip_smoke: a generate_latent_gt {name} pick '
                             f'is off the nearest code')
        del model
    agree = float((picks['bf16'] == picks['fp32']).float().mean())
    print(f'  generate_latent_gt bf16 vs fp32 maps: agreement {agree:.4f} '
          f'(>= {LATENT_BF16_FLOOR}); maps {tuple(picks["fp32"].shape)} '
          f'{picks["fp32"].dtype}', flush=True)
    if agree < LATENT_BF16_FLOOR or picks['fp32'].shape != (
            2 * LATENT_FACES, 16, 16):
        raise SystemExit('chip_smoke: generate_latent_gt bf16 maps disagree '
                         'with fp32')
    torch.cuda.empty_cache()
    return counts, rates


VAL_PAIRS = 4
METRIC_HOST_TOL = 1e-8


def phase_validation(trainer):
    """BaseTrainer.validation of the full-width stage-II trainer (SFT
    branches tamed, EMA reset to them) over VAL_PAIRS seeded in-memory
    512^2 pairs: PSNR (crop 4) and SSIM (Y channel) computed on the card,
    each image's held to the same metric on host copies of its images
    within METRIC_HOST_TOL; the EMA forward on the card."""
    from codeformer_tpu_torch import metrics
    with torch.no_grad():
        tame_sft(trainer.net_g)
    trainer.reset_ema()
    rng = np.random.default_rng(14)
    loader = []
    for i in range(VAL_PAIRS):
        b = stage2_batch(rng, 1)
        loader.append({'lq': b['in'].cpu().numpy(),
                       'gt': b['gt'].cpu().numpy(),
                       'lq_path': [f'val_{i:02d}.png']})
    trainer.opt['val'] = {'metrics': {
        'psnr': {'type': 'calculate_psnr', 'crop_border': 4},
        'ssim': {'type': 'calculate_ssim', 'crop_border': 4,
                 'test_y_channel': True}}}
    seen = []
    calc = metrics.calculate_metric

    def record(data, opt):
        value = calc(data, opt)
        seen.append((data['img'], data['img2'], opt, value))
        return value
    t0 = time.perf_counter()
    with mock.patch.object(metrics, 'calculate_metric', record):
        res = trainer.validation(loader, current_iter=1)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    on_card = all(a.is_cuda and b.is_cuda for a, b, _, _ in seen)
    err = max(abs(v - calc({'img': a.cpu().numpy(), 'img2': b.cpu().numpy()},
                           o)) for a, b, o, v in seen)
    print(f'validation (stage-II trainer, EMA weights, {VAL_PAIRS} pairs of '
          f'512^2): {res}; metrics on the card: {on_card}; max |card - host| '
          f'{err:.2e} (<= {METRIC_HOST_TOL}); {wall:.2f} s', flush=True)
    if len(seen) != 2 * VAL_PAIRS or not on_card or err > METRIC_HOST_TOL \
            or not all(np.isfinite(v) for v in res.values()):
        raise SystemExit('chip_smoke: validation failed')


class SyntheticLoader:
    """A host loader without cv2: `n` stage-II batches (NHWC float32
    numpy, 'in' and 'gt') made by a thread into a queue of 2, as the
    port's DataLoader hands them on; each a fresh copy of one of four
    seeded batches."""

    def __init__(self, n: int, batch: int):
        rng = np.random.default_rng(15)
        self.pool = [{k: rng.uniform(-1, 1, (batch, 512, 512, 3))
                      .astype(np.float32) for k in ('in', 'gt')}
                     for _ in range(4)]
        self.n = n

    def __len__(self):
        return self.n

    def __iter__(self):
        import queue
        import threading
        q = queue.Queue(maxsize=2)

        def produce():
            for i in range(self.n):
                q.put({k: v.copy() for k, v in self.pool[i % 4].items()})
            q.put(None)
        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            batch = q.get()
            if batch is None:
                break
            yield batch
        t.join()


def loader_rate(trainer, loader, step0: int) -> float:
    """Training faces/s of the stage-II trainer fed from `loader` (host
    clock over all its batches, ending in a synchronize)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i, batch in enumerate(loader):
        trainer.feed_data(batch)
        trainer.optimize_parameters(step0 + i)
    torch.cuda.synchronize()
    return len(loader) * TRAIN_BATCH / (time.perf_counter() - t0)


def phase_prefetcher(trainer):
    """The stage-II rate fed by SyntheticLoader directly (feed_data copies
    each batch from pageable memory) and through DevicePrefetcher (pinned
    copies on a side stream by its staging thread, a step ahead),
    alternating windows; every prefetched batch equal to its host
    arrays."""
    from codeformer_tpu_torch.data.loader import DevicePrefetcher
    src = SyntheticLoader(8, TRAIN_BATCH)
    for i, (a, b) in enumerate(zip(src, DevicePrefetcher(src, 'cuda'))):
        for k in a:
            if not (b[k].is_cuda and torch.equal(b[k].cpu(),
                                                  torch.from_numpy(a[k]))):
                raise SystemExit(f'chip_smoke: prefetched batch {i} {k} '
                                 f'differs from the host batch')
    n = max(8, int(RATE_WINDOW_S * 60 / TRAIN_BATCH))
    got = {'direct': [], 'prefetch': []}
    step = 1000
    for rep in range(RATE_REPEATS):
        for path in (('direct', 'prefetch') if rep % 2 == 0
                     else ('prefetch', 'direct')):
            loader = SyntheticLoader(n, TRAIN_BATCH)
            if path == 'prefetch':
                loader = DevicePrefetcher(loader, 'cuda')
            got[path].append(loader_rate(trainer, loader, step))
            step += n
    med = {k: statistics.median(v) for k, v in got.items()}
    print(f'prefetcher: stage-II training faces/s at B={TRAIN_BATCH} fed by a '
          f'host thread ({n} batches a window, {RATE_REPEATS} windows a '
          f'path, alternating; median [min, max]): direct '
          f'{med["direct"]:.2f} [{min(got["direct"]):.2f}, '
          f'{max(got["direct"]):.2f}], DevicePrefetcher '
          f'{med["prefetch"]:.2f} [{min(got["prefetch"]):.2f}, '
          f'{max(got["prefetch"]):.2f}]; batches equal: 8 of 8', flush=True)


def _free_port() -> int:
    import socket
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def dp_grads(trainer) -> torch.Tensor:
    return torch.cat([p.grad.detach().float().reshape(-1)
                      for net in (trainer.net_g, trainer.net_d)
                      if net is not None for p in net.parameters()
                      if p.grad is not None])


def phase_dp():
    """Data parallelism at world size 1 over NCCL (the card's machine has
    one H100; world size 2 is tier-1's gloo test): the process group
    started as `--launcher pytorch` starts it (init_dist from torchrun's
    variables), then one full-width stage-II step and one stage-I step
    past the gate (iteration 30004), each against the plain trainer's
    step from the same seeded state and batch: gradients, d_weight and
    the discriminator's BatchNorm statistics bit-equal or within 1e-6,
    launches as the plain step's. Returns the data-parallel steps'
    launch counts."""
    import torch.distributed as dist

    from codeformer_tpu_torch import parallel
    from codeformer_tpu_torch.train.trainers import build_model
    # torchrun's variables for this phase only: a later subprocess must
    # not inherit them
    torchrun_env = dict(RANK='0', WORLD_SIZE='1', LOCAL_RANK='0',
                        MASTER_ADDR='127.0.0.1', MASTER_PORT=str(_free_port()))
    os.environ.update(torchrun_env)
    counts = {k: 0 for k in ENCODE_LAUNCHES}
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        cases = (('stage II', stage2_options, 1, ENCODE_LAUNCHES),
                 ('stage I', stage1_options, STAGE1_ITERS[-1],
                  dict(NO_LAUNCHES, nearest_code=1)))
        for label, options, it, want in cases:
            batch = stage2_batch(np.random.default_rng(16), TRAIN_BATCH)
            if label == 'stage I':
                batch = {'gt': batch['gt']}
            runs = {}
            for mode in ('plain', 'dp'):
                if mode == 'dp':
                    parallel.init_dist('pytorch', 'cuda', timeout_s=120)
                try:
                    with vgg_standins():
                        trainer = build_model(options())
                    if trainer.data_parallel != (mode == 'dp'):
                        raise SystemExit('chip_smoke: data_parallel flag')
                    trainer.feed_data(batch)
                    got = counted_step(trainer, it)
                    runs[mode] = (dp_grads(trainer), dict(trainer.log_dict),
                                  [b.clone() for b in trainer.net_d.buffers()]
                                  if trainer.net_d is not None else [], got)
                    del trainer
                    torch.cuda.empty_cache()
                finally:
                    if mode == 'dp':
                        dist.destroy_process_group()
            (g0, log0, bn0, c0), (g1, log1, bn1, c1) = runs['plain'], \
                runs['dp']
            err = rel_rms(g1, g0)
            bn_err = max([rel_rms(a, b) for a, b in zip(bn1, bn0)
                          if a.is_floating_point()], default=0.0)
            # losses and means of predictions, O(1) or near 0: relative to
            # max(|value|, 1)
            log_err = max(abs(log1[k] - log0[k]) / max(abs(log0[k]), 1.0)
                          for k in log0)
            print(f'data parallel, world size 1 over NCCL, {label} B='
                  f'{TRAIN_BATCH} iteration {it}: gradients rel RMS {err:.2e} '
                  f'(bit-equal {bool(torch.equal(g0, g1))}), log max rel '
                  f'{log_err:.2e}'
                  + (f', d_weight {log1["d_weight"]:.6g} vs '
                     f'{log0["d_weight"]:.6g}, BatchNorm statistics rel RMS '
                     f'{bn_err:.2e}' if 'd_weight' in log0 else '')
                  + f'; launches {c1}', flush=True)
            if err > 1e-6 or log_err > 1e-6 or bn_err > 1e-6 or c1 != c0 \
                    or c1 != want:
                raise SystemExit(f'chip_smoke: the data-parallel {label} step '
                                 f'differs from the plain step')
            for k, v in c1.items():
                counts[k] += v
    finally:
        torch.backends.cudnn.deterministic = det
        for k in torchrun_env:
            os.environ.pop(k, None)
    return counts


SR_STEPS = 3
SR_BATCH = 4
SR_LQ = 128        # lq 128^2 -> gt 256^2 at scale 2
# under Real-ESRGAN's published 2e-4: there Adam's sign-like first
# updates of the random RRDBs overshoot (l_pix 0.263 -> 0.234 -> 0.290 on
# an H100, PERF.md); at 5e-5 the loss falls step by step
SR_LR = 5e-5


def phase_srmodel():
    """SRModel with RRDBNet at Real-ESRGAN x2plus's width (64 features,
    23 RRDBs, growth 32, scale 2), fp32 (the port's RRDBNet convs take
    their parameters' dtype), B=4, L1 against a seeded 256^2 target from
    128^2 inputs, the random RRDBs tamed (tame_rrdb: untamed, the output
    saturates at 66x the input and Adam's first steps overshoot):
    SR_STEPS steps on one batch, a falling loss, ms a step."""
    import torch.nn.functional as F

    from codeformer_tpu_torch.train.trainers import build_model
    opt = {'name': 'chip_smoke_sr', 'model_type': 'SRModel',
           'manual_seed': 0, 'device': 'cuda', 'path': {},
           'network_g': {'type': 'RRDBNet', 'num_in_ch': 3, 'num_out_ch': 3,
                         'num_feat': 64, 'num_block': 23, 'num_grow_ch': 32,
                         'scale': 2},
           'train': {'ema_decay': 0.999, 'total_iter': 400000,
                     'warmup_iter': -1,
                     'optim_g': {'type': 'Adam', 'lr': SR_LR,
                                 'weight_decay': 0, 'betas': [0.9, 0.99]},
                     'scheduler': {'type': 'MultiStepLR',
                                   'milestones': [400000], 'gamma': 0.5},
                     'pixel_opt': {'type': 'L1Loss', 'loss_weight': 1.0}}}
    trainer = build_model(opt)
    with torch.no_grad():
        tame_rrdb(trainer.net_g)
    trainer.reset_ema()
    gt = torch.from_numpy(np.stack(_faces(np.random.default_rng(17),
                                          SR_BATCH, 2 * SR_LQ))[..., ::-1]
                          .copy()).cuda().float().div(255.0)
    lq = F.interpolate(gt.permute(0, 3, 1, 2), scale_factor=0.5,
                       mode='bilinear', antialias=True).permute(0, 2, 3, 1)
    trainer.feed_data({'lq': lq.contiguous(), 'gt': gt.contiguous()})
    reset_launch_counts()
    losses, times = [], []
    for it in range(1, SR_STEPS + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.optimize_parameters(it)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        losses.append(trainer.log_dict['l_pix'])
    ms = time_ms(lambda: trainer.optimize_parameters(SR_STEPS + 1), iters=3,
                 runs=3, warmup=1)
    print(f'SRModel (RRDBNet x2plus width, fp32, B={SR_BATCH}, lq {SR_LQ}^2 '
          f'-> {2 * SR_LQ}^2): l_pix {[round(v, 5) for v in losses]}; '
          f'{ms:.2f} ms a step {ms.spread()} (first steps '
          f'{[round(v, 1) for v in times]} ms); kernels launched '
          f'{sum(launch_counts().values())}', flush=True)
    if not (losses[-1] < losses[0] and all(np.isfinite(losses))):
        raise SystemExit('chip_smoke: the SRModel loss did not fall')
    del trainer
    torch.cuda.empty_cache()


ARCFACE_BATCH = 8
ARCFACE_RTOL = 1e-4     # fp32 card (TF32 off) vs host, relative RMS


def phase_arcface():
    """ResNetArcFace (seeded, eval, fp32) at B=8 on 128^2 gray faces on
    the card against the same forward on a host copy; ms a forward."""
    from codeformer_tpu_torch.models import ResNetArcFace
    from codeformer_tpu_torch.utils.checkpoint import init_params_fast
    torch.backends.cudnn.allow_tf32 = False
    model = init_params_fast(ResNetArcFace(), 18).eval()
    faces = np.stack(_faces(np.random.default_rng(18), ARCFACE_BATCH, 128))
    x = torch.from_numpy(faces.mean(-1, keepdims=True).astype(np.float32)
                         / 127.5 - 1.0).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        ref = model(x)
        model.cuda()
        xc = x.cuda()
        got = model(xc)
        ms = time_ms(lambda: model(xc), iters=10)
    err = rel_rms(got.cpu(), ref)
    print(f'ResNetArcFace (IRBlock 2,2,2,2, SE) B={ARCFACE_BATCH}, 128^2 '
          f'gray, fp32: card vs host rel RMS {err:.2e} (<= {ARCFACE_RTOL}); '
          f'embedding {tuple(got.shape)}; {ms:.4f} ms a forward '
          f'{ms.spread()}', flush=True)
    if err > ARCFACE_RTOL or got.shape != (ARCFACE_BATCH, 512):
        raise SystemExit('chip_smoke: ResNetArcFace on the card disagrees '
                         'with the host')
    del model


def phase_ops():
    """The ops layer: K4 and the bare conv against their plain versions,
    then its main path with exact launch counts."""
    k4_rows = phase_k4()
    conv_rows = phase_conv_bias()
    return k4_rows, conv_rows, phase_ops_path()


# the whole-image path (bench.py:111-216's end-to-end workload): frames of
# 512x683, chunks of 16, upscale 2, w = 0.5, RetinaFace resnet50 and
# ParseNet in bf16, the serving phase's restorer
WI_FRAMES = 32
WI_HW = (512, 683)
WI_CHUNK = 16
WI_OFFSETS = ((-140.0, -170.0), (60.0, -170.0), (-140.0, 30.0),
              (60.0, 30.0))   # bench.py:132-135: 1..4 faces a frame
# detector check, bf16 backbone vs fp32 (TF32 off) on one chunk: each
# fp32 detection is matched to the bf16 detection of largest IoU. Read on
# an H100 (PERF.md): 33 of 34 matched (a score crossing the 0.8 threshold
# in bf16), median box error 0.015 px, landmarks 0.008 px; with the
# stride-8 anchors one cell off, 0.24 matched and medians 0.25 / 0.18 px
DET_MATCH_FLOOR = 0.75     # share of fp32 rows with an IoU >= 0.5 match
DET_ERR_BOUND = 0.1        # px, median box and landmark error of matches
# pipeline check, kernel path vs plain path (fp32 sums), mean |diff| of
# the final frames inside the face windows, uint8 levels, with the plain
# path held to the kernel path's codes (codes_held). Left to pick its own,
# it flips 2-3% of them (random weights give 1024 close logits a token),
# and the flips swamp the convs' rounding: a sound run read 2.89 and a K1
# halo fault 5.30. With the codes held, read on an H100 (PERF.md): sound
# 1.10 / 1.37 and the halo fault 4.15 / 5.01 at 1 / 4 faces a frame.
WI_FRAME_DIFF_BOUND = 2.5


def wi_landmarks(template, n_faces: int, h: int, w: int):
    return [template * 0.45 + np.array([w / 2 + ox, h / 2 + oy], np.float32)
            for ox, oy in WI_OFFSETS[:n_faces]]


def wi_detector_class():
    """A FaceDetector whose device graph runs and is waited for on every
    chunk, while the landmarks handed on are `n_faces` synthetic faces a
    frame at bench.py's offsets on `template` (random weights find no
    real faces); with n_faces None it is the real detector."""
    from codeformer_tpu_torch.pipeline.detector import FaceDetector

    class BenchDetector(FaceDetector):
        n_faces = None
        template = None

        def batched_detect_device_finish(self, frames_dev, det_hw, pending,
                                         *args, **kw):
            if self.n_faces is None:
                return super().batched_detect_device_finish(
                    frames_dev, det_hw, pending, *args, **kw)
            outs, valids, done = pending
            if done is not None:
                done.synchronize()          # the detection's work is timed
            b, h, w = frames_dev.shape[:3]
            det_scale = det_hw[0] / h
            dets = np.zeros((b, self.max_faces, 15), np.float32)
            vmask = np.zeros((b, self.max_faces), bool)
            for k, lm_f in enumerate(wi_landmarks(self.template,
                                                  self.n_faces, h, w)):
                lm = lm_f * det_scale
                dets[:, k, 0:4] = [lm[:, 0].min() - 30, lm[:, 1].min() - 60,
                                   lm[:, 0].max() + 30, lm[:, 1].max() + 40]
                dets[:, k, 4] = 0.99
                dets[:, k, 5:15] = lm.reshape(-1)
                vmask[:, k] = True
            return dets, vmask

    return BenchDetector


@torch.no_grad()
def tame_heads(model, x, targets=(('BboxHead', 1.0), ('LandmarkHead', 1.0),
                                  ('ClassHead', 2.0))):
    """Scale RetinaFace's three heads so their largest output on `x` is
    `target`: random weights give outputs in the 1e5s, so every score
    saturates at 0 or 1 and every box overflows, and a detector check
    would compare nothing. Trained weights keep heads in range."""
    feats = model.fpn(model.body(x))
    feats = [model.ssh1(feats[0]), model.ssh2(feats[1]),
             model.ssh3(feats[2])]
    for name, target in targets:
        heads = getattr(model, name)
        peak = max(float(h.conv1x1(f).float().abs().max())
                   for h, f in zip(heads, feats))
        for h in heads:
            h.conv1x1.weight.mul_(target / peak)
            h.conv1x1.bias.mul_(target / peak)


def det_check(det, det32, frames, det_hw, label) -> bool:
    """`det` (bf16) against `det32` (fp32, TF32 off) on one chunk: counts,
    matched share, box and landmark error of the matched rows, keep-bucket
    steps taken. Returns whether it is within the bounds."""
    from codeformer_tpu_torch.ops.nms import iou_matrix
    steps = []
    graph = det._graph

    def spy(hw, max_faces):
        steps.append(max_faces)
        return graph(hw, max_faces)

    with mock.patch.object(det, '_graph', spy):
        outs, valids = det.batched_detect_device(frames, det_hw)
    outs32, valids32 = det32.batched_detect_device(frames, det_hw)
    n, n32, matched, box_err, lm_err = 0, 0, 0, [], []
    for o, v, o32, v32 in zip(outs, valids, outs32, valids32):
        rows, rows32 = o[v], o32[v32]
        n, n32 = n + len(rows), n32 + len(rows32)
        if not len(rows) or not len(rows32):
            continue
        iou = iou_matrix(torch.from_numpy(rows32[:, :4]),
                         torch.from_numpy(rows[:, :4])).numpy()
        best = iou.argmax(1)
        ok = iou[np.arange(len(rows32)), best] >= 0.5
        matched += int(ok.sum())
        box_err.extend(np.abs(rows32[ok, :4] - rows[best[ok], :4]).max(1))
        lm_err.extend(np.abs(rows32[ok, 5:] - rows[best[ok], 5:]).max(1))
    share = matched / max(n32, 1)
    med_box = float(np.median(box_err)) if box_err else float('inf')
    med_lm = float(np.median(lm_err)) if lm_err else float('inf')
    inside = (n32 > 0 and share >= DET_MATCH_FLOOR
              and max(med_box, med_lm) <= DET_ERR_BOUND)
    print(f'  detector {label}: {n} detections (fp32 {n32}) in '
          f'{len(outs)} frames, keep buckets {steps}; matched '
          f'{share:.4f} (>= {DET_MATCH_FLOOR}); matched box error median '
          f'{med_box:.4f} max {max(box_err, default=float("nan")):.3f} px, '
          f'landmarks median {med_lm:.4f} max '
          f'{max(lm_err, default=float("nan")):.3f} px (medians <= '
          f'{DET_ERR_BOUND}): '
          f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
    return inside


def shifted_level_priors(h, w):
    """Planted fault: the stride-8 level's anchors one cell to the right."""
    from codeformer_tpu_torch.ops.anchors import prior_boxes
    p = prior_boxes(h, w).copy()
    n0 = 2 * math.ceil(h / 8) * math.ceil(w / 8)
    p[:n0, 0] += 8.0 / w
    return p


def wi_rate(pipe, frames, collect: bool) -> float:
    """Frames/s of restore_frames_device over one window of at least
    RATE_WINDOW_S seconds (host clock, ending in a synchronize); in folder
    mode (`collect`) the per-face crops are collected and a tiny piece
    of each restored chunk is fetched, as bench.py does."""
    def run():
        faces = [] if collect else None
        out = pipe.restore_frames_device(frames, collect_faces=faces)
        for _, restored, _ in faces or ():
            restored[:1, ::64, ::64, 0].cpu()
        return out

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run()
    torch.cuda.synchronize()
    iters = max(2, int(RATE_WINDOW_S / (time.perf_counter() - t0)) + 1)
    t0 = time.perf_counter()
    for _ in range(iters):
        run()
    torch.cuda.synchronize()
    return len(frames) * iters / (time.perf_counter() - t0)


@contextlib.contextmanager
def codes_held(model, codes: list, replay: bool):
    """Record the code indices of each forward of `model` into `codes`,
    or (`replay`) look up the recorded ones in their place, printing the
    share of the forward's own picks that agree."""
    get = model.quantize.get_codebook_feat
    calls = iter(codes) if replay else None

    def feat(indices, *args, **kw):
        if not replay:
            codes.append(indices)
            return get(indices, *args, **kw)
        held = next(calls).to(indices.device)
        print(f"    codes held: the forward's own picks agree on "
              f'{float((indices == held).float().mean()):.4f}', flush=True)
        return get(held, *args, **kw)

    with mock.patch.object(model.quantize, 'get_codebook_feat', feat):
        yield


def wi_pipeline_check(pipe, chunk, n_faces: int):
    """One chunk, `n_faces` a frame, through the pipeline with K1/K2 on
    their kernels and on their plain versions (fp32 sums), the same
    frames and detections: the final frames within WI_FRAME_DIFF_BOUND
    inside the face windows and bit-identical outside, the restored
    crops equal to restore_device on the same crops, and every K1/K2
    call of the restorer on those crops within REL_RMS_BOUND of its plain
    version. A planted K1 halo fault must fail both the frames and the
    per-call check. Raises SystemExit on a failure."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.pipeline.restorer import eager_forwards
    restorer = pipe.restorer
    pipe.detector.n_faces = n_faces

    codes = []

    def run(k1, k2):
        # eager: a graph would replay the kernels it captured
        with eager_forwards(), mock.patch.multiple(
                cv, conv3x3_dots=takes_prepared(k1),
                downsample_dots=takes_prepared(k2)), \
                codes_held(restorer.model, codes, replay=True):
            return pipe.restore_frames_device(chunk)

    faces_k = []
    with codes_held(restorer.model, codes, replay=False):
        out_k = pipe.restore_frames_device(chunk, collect_faces=faces_k)
    plan = pipe.last_plan
    inside = torch.from_numpy(plan.windows_mask(out_k.shape)).cuda()
    crops, restored_k, counts = faces_k[0]
    top = restorer.batch_buckets[-1]
    same_restore = bool(torch.equal(torch.cat([
        restorer.restore_device(crops[i:i + top], w=0.5)
        for i in range(0, sum(counts), top)]), restored_k))
    print(f'  pipeline, {n_faces} face(s) a frame: {len(chunk)} frames, '
          f'{sum(counts)} faces, m={plan.m}, w_edge {plan.w_edge}, windows '
          f'{plan.roi}^2; restored crops == restore_device on the same '
          f'crops in runs of {top}: {same_restore}', flush=True)
    out_p = run(cv.conv3x3_dots_ref, cv.downsample_dots_ref)
    xn = restorer.normalize(crops)

    def check(label, out, k1, k2):
        """(frames within bounds, every call within bounds)"""
        win = (out.float() - out_p.float()).abs()[inside]
        same_out = bool(torch.equal(out[~inside], out_p[~inside]))
        print(f'  pipeline, {n_faces} face(s) a frame, {label} vs plain path '
              f'(fp32 sums): inside the windows mean |diff| '
              f'{float(win.mean()):.4f} (<= {WI_FRAME_DIFF_BOUND}) max '
              f'{float(win.max()):.0f} levels; outside bit-identical: '
              f'{same_out}', flush=True)
        # the eager per-call check at m faces needs the graphs' memory
        restorer.release_graphs()
        torch.cuda.empty_cache()
        worst = per_call(restorer.model, xn,
                         f'whole-image crops (m={plan.m}), {label}', k1, k2)
        return (same_out and float(win.mean()) <= WI_FRAME_DIFF_BOUND,
                calls_within(worst))

    if not (same_restore and all(check('kernels', out_k, cv.conv3x3_dots,
                                       cv.downsample_dots))):
        raise SystemExit(f'chip_smoke: the whole-image pipeline at '
                         f'{n_faces} face(s) a frame disagrees with its '
                         f'plain path')
    halo = k1_fault('halo act(b)')
    frames_ok, calls_ok = check('planted fault: K1 halo act(b)',
                                run(halo, cv.downsample_dots_ref), halo,
                                cv.downsample_dots_ref)
    if frames_ok or calls_ok:
        raise SystemExit(f'chip_smoke: the pipeline check at {n_faces} '
                         f'face(s) a frame lets the planted fault K1 halo '
                         f'act(b) pass ({"frames" if frames_ok else ""}'
                         f'{" per call" if calls_ok else ""})')


def phase_whole_image(restorer, profile: bool = False) -> dict:
    """The fused whole-image path (DeviceRestorePipeline) at full width:
    the detector check, the pipeline check at 1 and 4 faces a frame
    (kernel vs plain path, per-call K1/K2 on the restorer's own
    activations, planted faults), exact launch counts a chunk, frames/s
    (video 1 and 4 faces a frame, folder) of the kernel and plain paths,
    peak memory; with `profile` the device time a stage. Returns the
    launch counts of the main-path run."""
    from codeformer_tpu_torch.pipeline import detector as pdet
    from codeformer_tpu_torch.pipeline.device_pipeline import \
        DeviceRestorePipeline
    from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper
    t0 = time.perf_counter()
    h, w = WI_HW
    g = torch.Generator(device='cuda').manual_seed(0)
    frames = torch.randint(0, 256, (WI_FRAMES, h, w, 3), generator=g,
                           device='cuda', dtype=torch.uint8)
    det = wi_detector_class()('retinaface_resnet50', allow_random=True,
                              dtype=torch.bfloat16, device='cuda')
    helper = FaceRestoreHelper(
        2, face_size=512, det_model='retinaface_resnet50', use_parse=True,
        device='cuda', allow_random_weights=True, detector=det,
        det_dtype=torch.bfloat16, parse_dtype=torch.bfloat16)
    det.template = helper.face_template
    pipe = DeviceRestorePipeline(restorer, helper, upscale=2,
                                 frame_chunk=WI_CHUNK, w=0.5)
    _, det_hw = pipe._det_hw(h, w)
    det32 = pdet.FaceDetector('retinaface_resnet50', allow_random=True,
                              dtype=torch.float32, device='cuda')
    x = torch.nn.functional.pad(
        pdet.resize_linear(frames[:2].permute(0, 3, 1, 2).float(), det_hw),
        (0, det32._bucket(det_hw[1]) - det_hw[1],
         0, det32._bucket(det_hw[0]) - det_hw[0]))
    tame_heads(det32.model, x - torch.tensor(
        pdet._MEANS, device='cuda').reshape(1, 3, 1, 1))
    det.model.load_state_dict(det32.model.state_dict())
    print(f'whole-image path: {WI_FRAMES} frames of {h}x{w} (seeded, on the '
          f'card), chunks of {WI_CHUNK}, upscale 2, w=0.5, RetinaFace '
          f'resnet50 (heads tamed) and ParseNet bf16 at parse_res '
          f'{pipe.parse_res}, the serving restorer; set up in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)

    # 1. the detector: bf16 against fp32 on one chunk, and a planted fault
    chunk = frames[:WI_CHUNK]
    if not det_check(det, det32, chunk, det_hw, 'bf16 vs fp32'):
        raise SystemExit('chip_smoke: the bf16 detector disagrees with fp32')
    det._graphs.clear()
    with mock.patch.object(pdet, 'prior_boxes', shifted_level_priors):
        caught = not det_check(det, det32, chunk, det_hw,
                               'planted fault: stride-8 anchors one cell off')
    det._graphs.clear()
    if not caught:
        raise SystemExit('chip_smoke: the detector bounds let the planted '
                         'fault (shifted anchors) pass')
    del det32

    # 2. the pipeline, kernel path vs plain path, one chunk at 1 and at 4
    # faces a frame (m = 16 and 64)
    for n_faces in (1, 4):
        wi_pipeline_check(pipe, chunk, n_faces)

    # 3. the main path: exact launch counts, 1 then 4 faces a frame; a
    # chunk's faces are restored in runs of the restorer's top bucket
    n_chunks = WI_FRAMES // WI_CHUNK
    n_res = count_resblocks(restorer.model, enable_fuse=True)
    top = restorer.batch_buckets[-1]
    counts = {}
    for n_faces in (1, 4):
        det.n_faces = n_faces
        reset_launch_counts()
        out = pipe.restore_frames_device(frames)
        torch.cuda.synchronize()
        got = launch_counts()
        fwd = n_chunks * -(-n_faces * WI_CHUNK // top)
        want = forward_launches(n_res, fwd)
        print(f'  main path, {n_faces} face(s) a frame: m={pipe.last_plan.m} '
              f'faces a chunk, {fwd // n_chunks} restorer forward(s) of '
              f'<= {top} a chunk; launches {got} (expected {want})',
              flush=True)
        if {k: got[k] for k in want} != want or any(
                v for k, v in got.items() if k not in want):
            raise SystemExit('chip_smoke: whole-image launch counts differ')
        if out.shape != (WI_FRAMES, 2 * h, 2 * w, 3) or \
                out.dtype != torch.uint8:
            raise SystemExit(f'chip_smoke: bad whole-image output '
                             f'{tuple(out.shape)} {out.dtype}')
        for k in want:
            counts[k] = counts.get(k, 0) + got[k]
    del out

    # 4. frames/s, kernel and plain paths in alternating windows
    print(f'  frames/s of restore_frames_device ({WI_FRAMES} frames, '
          f'{n_chunks} chunks), TF32 off: {RATE_REPEATS} windows of >= '
          f'{RATE_WINDOW_S} s per path, alternating; median [min, max]',
          flush=True)
    for key, n_faces, collect in (('video_frames_per_sec', 1, False),
                                  ('video_frames_per_sec_4face', 4, False),
                                  ('whole_image_images_per_sec', 1, True)):
        det.n_faces = n_faces
        torch.cuda.reset_peak_memory_stats()
        got = {'kernel': [], 'plain': []}
        for rep in range(RATE_REPEATS):
            for path in (('kernel', 'plain') if rep % 2 == 0
                         else ('plain', 'kernel')):
                with (plain_ops() if path == 'plain'
                      else contextlib.nullcontext()):
                    got[path].append(wi_rate(pipe, frames, collect))
        med = {k: statistics.median(v) for k, v in got.items()}
        print(f'  {key} ({n_faces} face(s) a frame'
              f'{", folder mode" if collect else ""}): kernel '
              f'{med["kernel"]:.2f} [{min(got["kernel"]):.2f}, '
              f'{max(got["kernel"]):.2f}]  plain {med["plain"]:.2f} '
              f'[{min(got["plain"]):.2f}, {max(got["plain"]):.2f}]  ratio '
              f'{med["kernel"] / med["plain"]:.3f}; peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB',
              flush=True)
    if profile:
        phase_whole_image_profile(pipe, frames)
    return counts


class StageClock:
    """CUDA events around each stage of a chunk (the pipeline's methods
    wrapped), with a synchronize before each, so an event pair spans that
    stage's device work alone."""
    STAGES = {'_detect_start': 'detect', '_warp': 'warp',
              '_parse_ids': 'parse', '_composite': 'composite'}

    def __init__(self, pipe):
        self.ms = {}
        self.pipe = pipe

    def wrap(self, name, fn):
        def timed(*a, **kw):
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*a, **kw)
            end.record()
            end.synchronize()
            self.ms.setdefault(name, []).append(start.elapsed_time(end))
            return out
        return timed

    @contextlib.contextmanager
    def on(self):
        restorer = self.pipe.restorer
        with contextlib.ExitStack() as stack:
            for attr, name in self.STAGES.items():
                stack.enter_context(mock.patch.object(
                    self.pipe, attr, self.wrap(name, getattr(self.pipe,
                                                             attr))))
            stack.enter_context(mock.patch.object(
                restorer, 'restore_device',
                self.wrap('restore', restorer.restore_device)))
            yield


def phase_whole_image_profile(pipe, frames, iters: int = 2):
    """Device time a stage (CUDA events, stages serialized) and the busy
    share of the unserialized run (torch.profiler), 1 and 4 faces a
    frame, kernel path."""
    from torch.profiler import ProfilerActivity, profile
    det = pipe.detector
    for n_faces in (1, 4):
        det.n_faces = n_faces
        clock = StageClock(pipe)
        with clock.on():
            for _ in range(iters):
                pipe.restore_frames_device(frames)
        chunks = iters * (WI_FRAMES // WI_CHUNK)
        per = {k: sum(v) / chunks for k, v in clock.ms.items()}
        total = sum(per.values())
        print(f'profile, whole-image path, {n_faces} face(s) a frame, per '
              f'chunk of {WI_CHUNK} (stages serialized, CUDA events): ' +
              ', '.join(f'{k} {v:.2f} ms ({100 * v / total:.1f}%)'
                        for k, v in per.items()) + f'; sum {total:.2f} ms',
              flush=True)
        pipe.restore_frames_device(frames)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(iters):
                pipe.restore_frames_device(frames)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / iters * 1e3
        print_profile(f'whole-image path, {n_faces} face(s) a frame, '
                      f'{WI_FRAMES} frames', prof, iters, wall)


# the colorization and inpainting models at full width: the released
# configurations (codebook 1024 / 512, connect 32/64/128) as their CLIs
# call them (cli/inference_colorization.py, cli/inference_inpainting.py)
TASKS = {  # task: (codebook size, w, adain)
    'colorization': (1024, 0.0, True),
    'inpainting': (512, 1.0, False),
}
TASK_FACES = 8
# whole forward, kernel path vs plain path (fp32 sums) with the plain path
# held to the kernel path's codes (codes_held): mean |diff| of the
# restored images, uint8 levels. The serving bound. Read on an H100
# (PERF.md): sound 1.52 / 1.24 (colorization / inpainting), the K1 halo
# fault 11.70 / 4.49.
TASK_IMAGE_DIFF_BOUND = IMAGE_DIFF_BOUND


def task_faces(g, task: str, n: int) -> torch.Tensor:
    """Seeded uint8 RGB faces made on the card, (n, 512, 512, 3): smooth
    noise; gray (three equal channels) for colorization, with two pure
    white rectangles a face (the masked regions) for inpainting."""
    lo = torch.rand((n, 3, 16, 16), generator=g, device='cuda') * 255.0
    img = torch.nn.functional.interpolate(lo, scale_factor=32.0)
    img = img + 12.0 * torch.randn(img.shape, generator=g, device='cuda')
    img = img.clamp(0, 255).to(torch.uint8).permute(0, 2, 3, 1)
    if task == 'colorization':
        return img[..., 1:2].expand(-1, -1, -1, 3).contiguous()
    img = img.contiguous()
    corners = torch.randint(64, 384, (n, 2, 2), generator=g, device='cuda')
    for i, rects in enumerate(corners.tolist()):
        for y, x in rects:
            img[i, y:y + 64, x:x + 96] = 255
    return img


def held_forward(model, xn, fwd: dict, k1, k2, codes: list, replay: bool):
    """One forward (fwd: w, adain, enable_fuse) with K1/K2 served by (k1,
    k2), its code picks recorded into `codes` or (`replay`) replaced by
    the recorded ones. Returns (out, logits, lq_feat)."""
    from codeformer_tpu_torch.ops import conv3x3 as cv
    k1 = k1 if k1 is cv.conv3x3_dots else takes_prepared(k1)
    k2 = k2 if k2 is cv.downsample_dots else takes_prepared(k2)
    with torch.inference_mode(), mock.patch.multiple(
            cv, conv3x3_dots=k1, downsample_dots=k2), \
            codes_held(model, codes, replay):
        return model(xn, **fwd)


def task_forward_check(restorer, label, got, ref) -> bool:
    """`got` (out, logits, lq_feat) against the plain path's `ref`, both
    on the same codes: lq_feat and logits rel RMS, the restored images'
    mean |diff|. Returns whether all are within bounds."""
    img = restorer.denormalize(got[0]).float()
    diff = (img - restorer.denormalize(ref[0]).float()).abs()
    r = dict(lq=rel_rms(got[2], ref[2]), logits=rel_rms(got[1], ref[1]),
             diff=float(diff.mean()))
    inside = (max(r['lq'], r['logits']) <= SLICE_REL_BOUND
              and r['diff'] <= TASK_IMAGE_DIFF_BOUND)
    print(f'  whole forward, {label} vs plain (fp32 sums, codes held): '
          f'lq_feat rel_rms {r["lq"]:.3g}, logits rel_rms {r["logits"]:.3g} '
          f'(<= {SLICE_REL_BOUND}); image diff mean {r["diff"]:.4f} (<= '
          f'{TASK_IMAGE_DIFF_BOUND}) max {float(diff.max()):.0f} levels, '
          f'{float((diff > 2).float().mean()):.4f} of values off by > 2: '
          f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
    return inside


def phase_tasks() -> dict:
    """The colorization and inpainting restorers at full width (dim_embd
    512, 9 layers, 8 heads, nf 64), seeded random weights, SFT tamed,
    bf16: exact launch counts through restore_batch (and, for
    inpainting, the white-mask composite keeping every other pixel of
    the input), the whole forward kernel vs plain with the codes held,
    every K1/K2 call of one forward on its own activations, the planted
    K1 halo fault failing both checks, and faces/s at B=1 and 8. Returns
    the launch counts of the restore_batch runs."""
    from codeformer_tpu_torch.cli.inference_inpainting import \
        white_mask_composite
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    g = torch.Generator(device='cuda').manual_seed(2)
    counts = {}
    for task, (codebook, w, adain) in TASKS.items():
        t0 = time.perf_counter()
        restorer = CodeFormerRestorer(device='cuda', codebook_size=codebook,
                                      connect_list=('32', '64', '128'),
                                      seed=1)
        tame_sft(restorer.model)
        model = restorer.model
        fwd = dict(w=w, adain=adain, enable_fuse=w > 0)
        n_res = count_resblocks(model, enable_fuse=w > 0)
        faces = task_faces(g, task, TASK_FACES)
        print(f'{task}: full width (dim_embd 512, 9 layers, 8 heads, nf 64, '
              f'{codebook} codes, connect 32/64/128), bf16, seeded random '
              f'init, SFT tamed, in {time.perf_counter() - t0:.1f} s; w={w}, '
              f'adain={adain}: {n_res} ResBlocks a forward', flush=True)

        # 1. the CLI's call: restore_batch, exact launches
        bgr = [f[..., ::-1].copy() for f in faces[:3].cpu().numpy()]
        reset_launch_counts()
        out = restorer.restore_batch(bgr, w=w, adain=adain)
        torch.cuda.synchronize()
        got = launch_counts()
        want = forward_launches(n_res)
        print(f'  restore_batch, 3 faces: launches {got} (expected {want})',
              flush=True)
        if {k: got[k] for k in want} != want or any(
                v for k, v in got.items() if k not in want):
            raise SystemExit(f'chip_smoke: {task} launch counts differ (a '
                             f'failed chunk passes through)')
        for k in want:
            counts[k] = counts.get(k, 0) + got[k]
        for face, o in zip(bgr, out):
            if o.shape != face.shape or o.dtype != np.uint8 or \
                    np.array_equal(o, face):
                raise SystemExit(f'chip_smoke: bad {task} output')
        if task == 'inpainting':
            kept, white_px = True, 0
            for face, o in zip(bgr, out):
                white = (face == 255).all(axis=-1)
                comp = white_mask_composite(face, o)
                white_px += int(white.sum())
                kept &= bool(np.array_equal(comp[~white], face[~white])
                             and np.array_equal(comp[white], o[white]))
            print(f'  white-mask composite: {white_px} masked pixels take '
                  f'the output, every other pixel equals the input bit for '
                  f'bit: {kept}', flush=True)
            if not kept or not white_px:
                raise SystemExit('chip_smoke: the inpainting composite '
                                 'changed an unmasked pixel')

        # 2. the whole forward and every call of it, kernels vs plain
        xn = restorer.normalize(faces[:2])
        codes = []
        kern = held_forward(model, xn, fwd, cv.conv3x3_dots,
                            cv.downsample_dots, codes, replay=False)
        img_std = float(restorer.denormalize(kern[0]).float().std())
        print(f'  kernel-path forward, B=2: image std {img_std:.2f} levels '
              f'(>= {MIN_IMAGE_STD})', flush=True)
        if img_std < MIN_IMAGE_STD or not all(
                torch.isfinite(t.float()).all() for t in kern):
            raise SystemExit(f'chip_smoke: the {task} forward is constant '
                             f'or not finite')
        plain = held_forward(model, xn, fwd, cv.conv3x3_dots_ref,
                             cv.downsample_dots_ref, codes, replay=True)
        worst = per_call(model, xn, f'{task} B=2, kernels', cv.conv3x3_dots,
                         cv.downsample_dots, **fwd)
        if not task_forward_check(restorer, 'kernels', kern, plain) \
                or not calls_within(worst):
            raise SystemExit(f'chip_smoke: the {task} forward disagrees with '
                             f'its plain version')
        halo = k1_fault('halo act(b)')
        faulty = held_forward(model, xn, fwd, halo, cv.downsample_dots_ref,
                              codes, replay=True)
        whole_ok = task_forward_check(restorer,
                                      'planted fault: K1 halo act(b)',
                                      faulty, plain)
        worst = per_call(model, xn, f'{task} B=2, planted fault: K1 halo '
                         f'act(b)', halo, cv.downsample_dots_ref, **fwd)
        if whole_ok or worst['conv3x3_dots'] <= REL_RMS_BOUND:
            raise SystemExit(f'chip_smoke: the {task} checks let the planted '
                             f'fault K1 halo act(b) pass')
        del kern, plain, faulty

        # 3. faces/s
        phase_rates(restorer, [faces[:1], faces], w=w, adain=adain,
                    label=task)
        del restorer, model
        torch.cuda.empty_cache()
    return counts


# the classic per-stage path's device stages (cli/whole_image.py
# _run_classic): the whole-image phase's frame size, upscale 2, 1 and 4
# faces at bench.py's offsets; parse in fp32 (the classic path's dtype)
CLASSIC_UP = 2
# share of class ids equal to the CPU copy's; read 0.999996 on an H100
PARSE_AGREE_FLOOR = 0.999
# paste_faces on the card against the same call on CPU copies (both fp32):
# mean |diff| inside the face windows, uint8 levels (the results are
# truncated, so a sum in another order can move a pixel by one level).
# Read on an H100 (PERF.md): under 5e-5 (max 1 level) in all eight
# configurations; an inverse affine 1 px off reads 1.72 to 3.25.
PASTE_DIFF_BOUND = 0.05
PASTE_MARGIN = 8           # px around each face's box: its window


def paste_windows(inv_affines, face: int, hw) -> np.ndarray:
    """(h, w) bool: inside some face's bounding box on the canvas, plus
    PASTE_MARGIN. Outside it paste_faces returns the canvas (the soft
    edge stays inside the warped face, device_pipeline.py's argument)."""
    inside = np.zeros(hw, bool)
    corners = np.array([[0, 0, 1], [face, 0, 1], [0, face, 1],
                        [face, face, 1]], np.float64)
    for ia in inv_affines:
        c = corners @ np.asarray(ia, np.float64).T
        y0, x0 = (np.floor(c.min(0)) - PASTE_MARGIN).astype(int)[::-1]
        y1, x1 = (np.ceil(c.max(0)) + PASTE_MARGIN).astype(int)[::-1]
        inside[max(y0, 0):max(y1, 0), max(x0, 0):max(x1, 0)] = True
    return inside


def phase_classic(restorer) -> dict:
    """The classic path's device stages on the card: the crops through
    restore_batch (exact launches), `_parse_masks` in fp32 against a CPU
    copy, `paste_faces` with use_parse and draw_box on and off against
    the same call on CPU copies (inside the face windows within
    PASTE_DIFF_BOUND, outside bit-identical to the upscaled canvas; an
    inverse affine shifted by one pixel must fail), ms a frame and peak
    memory. Returns the launch counts of the restore_batch runs."""
    from codeformer_tpu_torch.ops.geometry import (estimate_similarity,
                                                   invert_affine,
                                                   resize_linear, warp_affine)
    from codeformer_tpu_torch.pipeline.compositor import paste_faces
    from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper
    t0 = time.perf_counter()
    h, w = WI_HW
    up = CLASSIC_UP
    g = torch.Generator(device='cuda').manual_seed(3)
    lo = torch.rand((1, 3, h // 16, w // 16), generator=g, device='cuda')
    frame = torch.nn.functional.interpolate(lo * 255.0, size=(h, w),
                                            mode='bilinear')
    frame = frame + 8.0 * torch.randn(frame.shape, generator=g,
                                      device='cuda')
    frame = frame.clamp(0, 255).round()
    # the classic path upscales with cv2 on the host; the canvas here is
    # the same linear upscale, made on the card
    canvas = resize_linear(frame, (h * up, w * up)).round().clamp(0, 255) \
        .to(torch.uint8)[0].permute(1, 2, 0).contiguous()
    frame = frame.to(torch.uint8).permute(0, 2, 3, 1).contiguous()
    canvas_np = canvas.cpu().numpy()
    kw = dict(use_parse=True, allow_random_weights=True, detector=object(),
              parse_dtype=torch.float32)
    helper = FaceRestoreHelper(up, device='cuda', **kw)
    helper_cpu = FaceRestoreHelper(up, device='cpu', **kw)
    helper_cpu._parse_model.load_state_dict(helper._parse_model.state_dict())
    template = helper.face_template
    n_res = count_resblocks(restorer.model, enable_fuse=True)
    print(f'classic path: a {h}x{w} frame (seeded, on the card), canvas '
          f'{h * up}x{w * up}, 1 and 4 faces at bench.py\'s offsets, the '
          f'serving restorer, ParseNet fp32; set up in '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    counts = {}
    for n_faces in (1, 4):
        lms = wi_landmarks(template, n_faces, h, w)
        affines = [estimate_similarity(lm, template) for lm in lms]
        crops = warp_affine(frame, np.stack(affines), (512, 512),
                            border_value=(135.0, 133.0, 132.0),
                            img_idx=torch.zeros(n_faces, dtype=torch.long,
                                                device='cuda'))
        crops = list(torch.round(crops).clamp(0, 255).to(torch.uint8)
                     .cpu().numpy())
        reset_launch_counts()
        restored = restorer.restore_batch(crops, w=0.5, adain=True)
        torch.cuda.synchronize()
        got = launch_counts()
        want = forward_launches(n_res)
        print(f'  {n_faces} face(s): restore_batch launches {got} (expected '
              f'{want})', flush=True)
        if {k: got[k] for k in want} != want or any(
                v for k, v in got.items() if k not in want) or any(
                np.array_equal(r, c) for r, c in zip(restored, crops)):
            raise SystemExit('chip_smoke: classic-path launch counts differ '
                             '(a failed chunk passes through)')
        for k in want:
            counts[k] = counts.get(k, 0) + got[k]

        pids = helper._parse_masks(restored)
        if n_faces == 4:
            pids_cpu = helper_cpu._parse_masks(restored)
            agree = float((pids == pids_cpu).mean())
            print(f'  _parse_masks fp32, card vs CPU copy, {n_faces} faces: '
                  f'class ids agree on {agree:.6f} (>= {PARSE_AGREE_FLOOR})',
                  flush=True)
            if agree < PARSE_AGREE_FLOOR:
                raise SystemExit('chip_smoke: _parse_masks on the card '
                                 'disagrees with its CPU copy')
        ias = []
        for a in affines:
            ia = invert_affine(a, up)
            ia[:, 2] += 0.5 * up       # the helper's extra offset
            ias.append(ia.astype(np.float32))
        inside = paste_windows(ias, 512, canvas_np.shape[:2])
        for use_parse in (False, True):
            for draw_box in (False, True):
                args = (restored, ias, pids if use_parse else None, up,
                        draw_box)
                out_c = paste_faces(canvas_np, *args, device='cpu')
                label = (f'{n_faces} face(s), use_parse {use_parse}, '
                         f'draw_box {draw_box}')
                for fault in (False, True):
                    shifted = [ia + np.float32([[0, 0, 1], [0, 0, 0]])
                               for ia in ias] if fault else ias
                    out_g = paste_faces(canvas_np, restored, shifted,
                                        *args[2:], device='cuda')
                    d = np.abs(out_g.astype(np.float32)
                               - out_c.astype(np.float32))
                    same = bool(np.array_equal(out_g[~inside],
                                               canvas_np[~inside])
                                and np.array_equal(out_c[~inside],
                                                   canvas_np[~inside]))
                    ok = same and float(d[inside].mean()) <= PASTE_DIFF_BOUND
                    print(f'  paste_faces, {label}'
                          f'{", planted fault: inverse affine 1 px off" if fault else ""}'
                          f': card vs CPU copy inside the windows mean |diff| '
                          f'{float(d[inside].mean()):.6f} (<= '
                          f'{PASTE_DIFF_BOUND}) max {d.max():.0f} levels; '
                          f'outside == the canvas: {same}', flush=True)
                    if ok == fault:
                        raise SystemExit(
                            f'chip_smoke: paste_faces ({label}) '
                            f'{"lets the planted fault pass" if fault else "disagrees with its CPU copy"}')
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: paste_faces(canvas_np, restored, ias, pids, up,
                                         device='cuda'), iters=5, runs=5)
        print(f'  paste_faces on the card, {n_faces} face(s), use_parse, '
              f'canvas {h * up}x{w * up}: {ms:.3f} ms a frame '
              f'{ms.spread()} (the whole call: faces and parse ids up, the '
              f'frame back); peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB',
              flush=True)
    return counts


# ---------------------------------------------------------------------------
# 5f-5i: the Real-ESRGAN upsampler, the classic path with both upsamplers,
# the YOLOv5-face detectors, BiSeNet
# ---------------------------------------------------------------------------
ESR_FACE = 512
# enhance in bf16 (set_realesrgan's upsampler) against the same call in
# fp32 with TF32 off, uint8 levels over the whole output. Read on an H100
# (PERF.md): mean 0.353 / 0.354, max 2 / 2 on the frame / the face; a
# seam one pixel off read mean 1.023, max 10
ESR_MEAN_BOUND = 0.9
ESR_MAX_BOUND = 6
# tiled (tile 160, pad 40) against whole at 320^2, both fp32: mean |diff|
# over the tile cores, 40 px (80 output px) clear of every seam and edge.
# Read on an H100: 0.0000 (near the seams 0.8977); a seam one pixel off
# read 1.0140 there
ESR_TILE_BOUND = 0.05
ESR_TILE_HW = (320, 320)
# random RRDB weights, tamed (tame_rrdb): conv_last's scale. Read on an
# H100 on 5f's frame: 0.18 left 33% of the output at 0 or 255, 0.08 left
# 10.5% (std 59 levels)
ESR_LAST_SCALE = 0.04
ESR_MAX_SATURATED = 0.05   # share of output values at 0 or 255


@torch.no_grad()
def tame_rrdb(model):
    """Random RRDB weights: an RRDB returns about 1.2 x its input (its
    three dense blocks are near identity and it adds 0.2 of their output
    to its input), so 23 of them grow the features about 66x and 99% of
    the output saturates at 0 or 255 (a comparison of saturated outputs
    proves nothing). conv_body is scaled by 1.2^-num_block, conv_last by
    ESR_LAST_SCALE with its bias at 0.5, so the output sits mid-range;
    trained weights keep it in range."""
    damp = 1.2 ** -len(model.body)
    model.conv_body.weight.mul_(damp)
    model.conv_body.bias.mul_(damp)
    model.conv_last.weight.mul_(ESR_LAST_SCALE)
    model.conv_last.bias.fill_(0.5)


def smooth_frame(seed: int, hw) -> np.ndarray:
    """A seeded (h, w, 3) uint8 BGR frame made on the card: smooth colour
    fields (a 1/16 noise map, bilinear) plus noise of 8 levels."""
    h, w = hw
    g = torch.Generator(device='cuda').manual_seed(seed)
    lo = torch.rand((1, 3, -(-h // 16), -(-w // 16)), generator=g,
                    device='cuda')
    frame = torch.nn.functional.interpolate(lo * 255.0, size=(h, w),
                                            mode='bilinear')
    frame = frame + 8.0 * torch.randn(frame.shape, generator=g,
                                      device='cuda')
    return frame.clamp(0, 255).round().to(torch.uint8)[0] \
        .permute(1, 2, 0).contiguous().cpu().numpy()


def level_diff(got: np.ndarray, ref: np.ndarray):
    d = np.abs(got.astype(np.float32) - ref.astype(np.float32))
    return float(d.mean()), float(d.max())


@contextlib.contextmanager
def rdb_fault(rdb):
    """A dense block without its 0.2 residual scale: a planted fault,
    made in the weights (conv5 five times larger) so that both the module
    path and the dense trunk (models/rrdbnet.py) run it."""
    with torch.no_grad():
        rdb.conv5.weight.mul_(5.0)
        rdb.conv5.bias.mul_(5.0)
    try:
        yield
    finally:
        with torch.no_grad():
            rdb.conv5.weight.div_(5.0)
            rdb.conv5.bias.div_(5.0)


def dense_launches(ups) -> int:
    """conv3x3_dense launches of the upsamplers' forwards on the dense
    trunk since their counts were reset: 15 an RRDB and conv_body's."""
    return sum((15 * len(u.model.body) + 1) * u.tile_counts()['fused_calls']
               for u in ups)


def seam_fault(up):
    """Each upscaled tile moved one pixel right before its core is cut:
    the cores land one pixel off in the assembly (a planted fault)."""
    fwd = up._fwd
    return mock.patch.object(up, '_fwd',
                             lambda t: torch.roll(fwd(t), 1, dims=3))


def phase_realesrgan():
    """5f. set_realesrgan's x2 upsampler (RRDBNet x2plus: 64 features, 23
    blocks, growth 32; bf16; tiles of 400, pad 40, 4 a batch) with seeded
    tamed weights: enhance on a 512x683 frame (2x2 tiles) and on a 512^2
    face (--face_upsample's call, 2x2 tiles) against the same calls in
    fp32 (TF32 off), a seam shifted by one pixel and a dense block
    without its residual scale that must fail; tiled (160, pad 40)
    against whole at 320^2; the output not saturated; ms a call, tiles/s
    and peak memory. Returns the upsampler for 5g."""
    from codeformer_tpu_torch.models.rrdbnet import RRDBNet
    from codeformer_tpu_torch.pipeline.realesrgan import (RealESRGANer,
                                                          set_realesrgan)
    from codeformer_tpu_torch.utils.checkpoint import init_params_fast
    torch.backends.cudnn.allow_tf32 = False      # the fp32 reference
    t0 = time.perf_counter()
    ref_model = init_params_fast(RRDBNet(scale=2), 5)
    tame_rrdb(ref_model)
    up = set_realesrgan(tile=400, allow_random=True, device='cuda')
    up.model.load_state_dict(ref_model.state_dict())
    up32 = RealESRGANer(scale=2, model=ref_model, tile=up.tile_size,
                        tile_pad=up.tile_pad, tile_batch=up.tile_batch,
                        dtype=torch.float32, device='cuda')
    frame = smooth_frame(11, WI_HW)
    face = smooth_frame(12, (ESR_FACE, ESR_FACE))
    print(f'Real-ESRGAN (set_realesrgan: RRDBNet x2plus, {up.dtype}, tile '
          f'{up.tile_size} pad {up.tile_pad}, {up.tile_batch} a batch; '
          f'seeded, tamed): set up in {time.perf_counter() - t0:.1f} s',
          flush=True)
    outs = {}
    for label, img in (('frame', frame), ('face', face)):
        got, mode = up.enhance(img, outscale=2)
        ref, _ = up32.enhance(img, outscale=2)
        want_shape = (2 * img.shape[0], 2 * img.shape[1], 3)
        mean, mx = level_diff(got, ref)
        sat = float(((got == 0) | (got == 255)).mean())
        std = float(got.std())
        ok = (got.shape == want_shape and mode == 'RGB'
              and mean <= ESR_MEAN_BOUND and mx <= ESR_MAX_BOUND)
        print(f'  enhance, {label} {img.shape[0]}x{img.shape[1]} -> '
              f'{got.shape[0]}x{got.shape[1]}: bf16 vs fp32 mean |diff| '
              f'{mean:.4f} (<= {ESR_MEAN_BOUND}) max {mx:.0f} (<= '
              f'{ESR_MAX_BOUND}) levels; output std {std:.2f} (>= '
              f'{MIN_IMAGE_STD}), saturated share {sat:.4f} (<= '
              f'{ESR_MAX_SATURATED})', flush=True)
        if not ok:
            raise SystemExit(f'chip_smoke: Real-ESRGAN bf16 disagrees with '
                             f'fp32 on the {label}')
        if std < MIN_IMAGE_STD or sat > ESR_MAX_SATURATED:
            raise SystemExit(f'chip_smoke: the Real-ESRGAN {label} output is '
                             f'saturated or flat: the check compares nothing')
        outs[label] = ref
    for fault, patch in (('a seam one pixel off', seam_fault(up)),
                         ('body.11.rdb2 without its 0.2 residual scale',
                          rdb_fault(up.model.body[11].rdb2))):
        with patch:
            got, _ = up.enhance(frame, outscale=2)
        mean, mx = level_diff(got, outs['frame'])
        caught = mean > ESR_MEAN_BOUND or mx > ESR_MAX_BOUND
        print(f'  planted fault, {fault}: frame mean |diff| {mean:.4f} max '
              f'{mx:.0f} levels: {"caught" if caught else "MISSED"}',
              flush=True)
        if not caught:
            raise SystemExit(f'chip_smoke: the Real-ESRGAN bounds let the '
                             f'planted fault ({fault}) pass')

    # tiled against whole, fp32
    tiled = RealESRGANer(scale=2, model=ref_model, tile=160, tile_pad=40,
                         tile_batch=4, dtype=torch.float32, device='cuda')
    whole = RealESRGANer(scale=2, model=ref_model, tile=0,
                         dtype=torch.float32, device='cuda')
    img = smooth_frame(13, ESR_TILE_HW)
    core = np.zeros((2 * ESR_TILE_HW[0], 2 * ESR_TILE_HW[1]), bool)
    core[80:-80, 80:-80] = True
    for seam in range(160 * 2, 2 * ESR_TILE_HW[0], 160 * 2):
        core[seam - 80:seam + 80] = False
        core[:, seam - 80:seam + 80] = False
    ref = whole.enhance(img, outscale=2)[0]
    for fault in (False, True):
        with (seam_fault(tiled) if fault else contextlib.nullcontext()):
            got = tiled.enhance(img, outscale=2)[0]
        d = np.abs(got.astype(np.float32) - ref.astype(np.float32))
        inside = float(d[core].mean())
        ok = inside <= ESR_TILE_BOUND
        print(f'  tiled (160, pad 40) vs whole at {ESR_TILE_HW[0]}^2, fp32'
              f'{", planted fault: a seam one pixel off" if fault else ""}: '
              f'mean |diff| {inside:.6f} (<= {ESR_TILE_BOUND}), max '
              f'{d[core].max():.0f} levels over the tile cores '
              f'({int(core.sum())} px); near the seams and edges mean '
              f'{float(d[~core].mean()):.4f}, max {d.max():.0f}', flush=True)
        if ok == fault:
            raise SystemExit(
                'chip_smoke: tiled Real-ESRGAN '
                f'{"lets the seam fault pass" if fault else "disagrees with the whole image"}')
    del tiled, whole, up32

    for label, img in (('frame', frame), ('face', face)):
        n_tiles = math.ceil(img.shape[0] / up.tile_size) * math.ceil(
            img.shape[1] / up.tile_size)
        torch.cuda.reset_peak_memory_stats()
        ms = time_ms(lambda: up.enhance(img, outscale=2), iters=3, runs=3,
                     warmup=1)
        print(f'  enhance on the card, {label} {img.shape[0]}x{img.shape[1]} '
              f'({n_tiles} tiles of {up.tile_size + 2 * up.tile_pad}^2): '
              f'{ms:.3f} ms a call {ms.spread()}, '
              f'{n_tiles / ms * 1e3:.1f} tiles/s (the whole call: the '
              f'image up, uint8 back); peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB',
              flush=True)
    return up


def phase_classic_upsample(restorer, up) -> dict:
    """5g. The classic path's device stages with both upsamplers: 5c's
    512x683 frame and faces (1 and 4 at bench.py's offsets) through
    restore_batch (exact K1/K2 launches, nothing else launched by the
    upsampler or the paste), each restored face upsampled to 1024
    (--face_upsample) and the frame to 1024x1366 (--bg_upsampler), the
    upsampled faces parsed on the card, then paste_faces with the
    upsampler's inverse affines on the card against the same call on CPU
    copies (a shifted affine must fail); ms a frame and its split.
    Returns the launch counts."""
    from codeformer_tpu_torch.ops.geometry import (estimate_similarity,
                                                   invert_affine, warp_affine)
    from codeformer_tpu_torch.pipeline.compositor import paste_faces
    from codeformer_tpu_torch.pipeline.face_helper import FaceRestoreHelper
    h, w = WI_HW
    s = CLASSIC_UP
    frame = smooth_frame(3, WI_HW)
    helper = FaceRestoreHelper(s, device='cuda', use_parse=True,
                               allow_random_weights=True, detector=object(),
                               parse_dtype=torch.float32)
    template = helper.face_template
    n_res = count_resblocks(restorer.model, enable_fuse=True)
    frame_dev = torch.from_numpy(frame).cuda()[None]
    counts = {}
    print(f'classic path with both upsamplers: a {h}x{w} frame, faces '
          f'restored, upsampled to 1024, the frame to {h * s}x{w * s}, '
          f'pasted at upscale {s}', flush=True)
    for n_faces in (1, 4):
        lms = wi_landmarks(template, n_faces, h, w)
        affines = [estimate_similarity(lm, template) for lm in lms]
        crops = warp_affine(frame_dev, np.stack(affines), (512, 512),
                            border_value=(135.0, 133.0, 132.0),
                            img_idx=torch.zeros(n_faces, dtype=torch.long,
                                                device='cuda'))
        crops = list(torch.round(crops).clamp(0, 255).to(torch.uint8)
                     .cpu().numpy())
        ias = []
        for a in affines:     # the helper's face-upsampler inverse affine
            ia = invert_affine(a, s) / s
            ia[:, 2] *= s
            ias.append(ia.astype(np.float32))

        def run():
            restored = restorer.restore_batch(crops, w=0.5, adain=True)
            faces = [up.enhance(f, outscale=s)[0] for f in restored]
            canvas = up.enhance(frame, outscale=s)[0]
            rgb = torch.from_numpy(np.stack(faces)[..., ::-1].copy()).cuda()
            pids = helper._parse(rgb, res=512).cpu().numpy()
            return restored, faces, canvas, pids

        reset_launch_counts()
        up.reset_tile_counts()
        restored, faces, canvas, pids = run()
        torch.cuda.synchronize()
        got = launch_counts()
        want = dict(forward_launches(n_res),
                    conv3x3_dense=dense_launches([up]))
        print(f'  {n_faces} face(s): launches {got} (expected K1/K2 from '
              f'restore_batch and the upsampler\'s dense trunk, '
              f'{up.tile_counts()["fused_calls"]} forwards: {want}); faces '
              f'{faces[0].shape}, canvas {canvas.shape}', flush=True)
        if {k: got[k] for k in want} != want or any(
                v for k, v in got.items() if k not in want) or any(
                np.array_equal(r, c) for r, c in zip(restored, crops)) or \
                faces[0].shape != (1024, 1024, 3) or \
                canvas.shape != (h * s, w * s, 3) or \
                up.tile_counts()['fused_calls'] != up.tile_counts()['calls']:
            raise SystemExit('chip_smoke: the classic path with upsamplers '
                             'launched other than expected')
        for k in want:
            counts[k] = counts.get(k, 0) + got[k]
        inside = paste_windows(ias, 1024, canvas.shape[:2])
        out_c = paste_faces(canvas, faces, ias, pids, s, device='cpu')
        for fault in (False, True):
            shifted = [ia + np.float32([[0, 0, 1], [0, 0, 0]])
                       for ia in ias] if fault else ias
            out_g = paste_faces(canvas, faces, shifted, pids, s,
                                device='cuda')
            d = np.abs(out_g.astype(np.float32) - out_c.astype(np.float32))
            same = bool(np.array_equal(out_g[~inside], canvas[~inside]))
            ok = same and float(d[inside].mean()) <= PASTE_DIFF_BOUND
            print(f'  paste_faces, {n_faces} 1024 face(s), use_parse'
                  f'{", planted fault: inverse affine 1 px off" if fault else ""}'
                  f': card vs CPU copy inside the windows mean |diff| '
                  f'{float(d[inside].mean()):.6f} (<= {PASTE_DIFF_BOUND}) max '
                  f'{d.max():.0f} levels; outside == the canvas: {same}',
                  flush=True)
            if ok == fault:
                raise SystemExit(
                    'chip_smoke: paste_faces with upsampled faces '
                    f'{"lets the planted fault pass" if fault else "disagrees with its CPU copy"}')
        torch.cuda.reset_peak_memory_stats()
        split = {
            'restore': time_ms(lambda: restorer.restore_batch(
                crops, w=0.5, adain=True), iters=3, runs=3, warmup=1),
            'upsample': time_ms(lambda: ([up.enhance(f, outscale=s)
                                          for f in restored],
                                         up.enhance(frame, outscale=s)),
                                iters=2, runs=3, warmup=1),
            'parse+paste': time_ms(lambda: paste_faces(
                canvas, faces, ias, helper._parse(
                    torch.from_numpy(np.stack(faces)[..., ::-1].copy())
                    .cuda(), res=512).cpu().numpy(), s, device='cuda'),
                iters=3, runs=3, warmup=1)}
        total = sum(split.values())
        print(f'  {n_faces} face(s) a frame: {total:.2f} ms a frame '
              f'({1e3 / total:.2f} frames/s): ' + ', '.join(
                  f'{k} {v:.2f} ms {v.spread()} ({v / total:.1%})'
                  for k, v in split.items())
              + f'; peak memory '
              f'{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB',
              flush=True)
    return counts


YOLO_VARIANTS = ('YOLOv5n', 'YOLOv5l')
# YoloFace's raw (N, 16) predictions on the card (fp32, TF32 off) against
# a CPU copy: max |diff| of each column over its largest value. Read on an
# H100 (PERF.md): 3.13e-7 (n) and 2.33e-6 (l); BatchNorm eps 1e-5 in the
# Conv blocks 1.07e-3 / 2.33e-2, the anchors reversed 0.565 / 0.568
YOLO_PRED_RTOL = 1e-5
YOLO_DET_ATOL = 0.05       # px and score, a matched detection's columns


def yolo_verdict(pred, ref) -> float:
    return float((np.abs(pred - ref).max(axis=0)
                  / np.abs(ref).max(axis=0).clip(1e-6)).max())


def detect_sorted(det, frame, thr):
    rows = det.detect_faces(frame, conf_threshold=thr)
    return rows[np.lexsort(rows[:, ::-1].T)] if len(rows) else rows


def phase_yolo():
    """5h. YOLOv5n and YOLOv5l (seeded) on the card in fp32 (the classic
    path's numerics; TF32 off) against a CPU copy on a seeded 512x683
    frame: the raw (N, 16) predictions within YOLO_PRED_RTOL; detect_faces
    at a threshold between two scores that lets some rows through, the
    same rows as sets; planted faults (BatchNorm eps 1e-5 in the Conv
    blocks, the anchors of each level reversed) that must fail; ms a
    frame."""
    import copy
    from codeformer_tpu_torch.models import yolov5face
    from codeformer_tpu_torch.pipeline.detector import YoloFaceDetector
    torch.backends.cudnn.allow_tf32 = False
    frame = smooth_frame(21, WI_HW)
    for name in YOLO_VARIANTS:
        det = YoloFaceDetector(name, allow_random=True, device='cuda')
        cpu = YoloFaceDetector(name, allow_random=True, device='cpu')
        cpu.model.load_state_dict(det.model.state_dict())
        with torch.no_grad():
            ref = cpu.model(cpu._host_batch(frame[None])[0])[0].numpy()
            pred = det.model(det._host_batch(frame[None])[0])[0] \
                .cpu().numpy()
        err = yolo_verdict(pred, ref)
        scores = np.sort(ref[:, 4] * ref[:, 15])[::-1]
        k = 20 + int(np.argmax(scores[20:60] - scores[21:61]))
        thr = float(scores[k] + scores[k + 1]) / 2
        got = detect_sorted(det, frame, thr)
        want = detect_sorted(cpu, frame, thr)
        same = got.shape == want.shape and len(got) > 0 and bool(
            np.abs(got - want).max() <= YOLO_DET_ATOL)
        print(f'{name} ({sum(p.numel() for p in det.model.parameters())} '
              f'parameters), fp32, a {WI_HW[0]}x{WI_HW[1]} frame: raw '
              f'{pred.shape} predictions, card vs CPU max rel |diff| '
              f'{err:.3g} (<= {YOLO_PRED_RTOL}); detect_faces at '
              f'{thr:.5f}: {len(got)} rows on the card, {len(want)} on the '
              f'CPU, equal as sets: {same}', flush=True)
        if err > YOLO_PRED_RTOL or not same:
            raise SystemExit(f'chip_smoke: {name} on the card disagrees with '
                             f'its CPU copy')
        bad_eps = copy.deepcopy(det.model)
        for m in bad_eps.modules():
            if isinstance(m, torch.nn.BatchNorm2d) and m.eps == 1e-3:
                m.eps = 1e-5
        head = det.model.model[-1]
        for fault, model, patch in (
                ('BatchNorm eps 1e-5 in the Conv blocks', bad_eps,
                 contextlib.nullcontext()),
                ('anchors of each level reversed', det.model,
                 mock.patch.object(head, 'anchors', tuple(
                     sum(reversed([a[i:i + 2] for i in range(0, 6, 2)]),
                         ()) for a in head.anchors)))):
            with patch, torch.no_grad():
                bad = model(det._host_batch(frame[None])[0])[0].cpu().numpy()
            e = yolo_verdict(bad, ref)
            print(f'  planted fault, {fault}: max rel |diff| {e:.3g}: '
                  f'{"caught" if e > YOLO_PRED_RTOL else "MISSED"}',
                  flush=True)
            if e <= YOLO_PRED_RTOL:
                raise SystemExit(f'chip_smoke: the {name} bound lets the '
                                 f'planted fault ({fault}) pass')
        del bad_eps
        ms = time_ms(lambda: det.detect_faces(frame), iters=5, runs=3)
        print(f'  detect_faces on the card, fp32: {ms:.3f} ms a frame '
              f'{ms.spread()} (the frame up, the rows back)', flush=True)


# each head's max |diff| over its largest value, card (fp32, TF32 off)
# against a CPU copy; read on an H100: 3.38e-6 / 3.55e-6 at B=1 / 4
BISENET_RTOL = 1.5e-5


def phase_bisenet():
    """5i. BiSeNet (seeded, fp32, TF32 off) at 512^2, B=1 and 4: the card
    against a CPU copy (all three heads), and ms a forward."""
    from codeformer_tpu_torch.models.bisenet import BiSeNet
    from codeformer_tpu_torch.utils.checkpoint import init_params_fast
    torch.backends.cudnn.allow_tf32 = False
    model = init_params_fast(BiSeNet(), 6).eval().requires_grad_(False)
    cpu = BiSeNet().eval().requires_grad_(False)
    cpu.load_state_dict(model.state_dict())
    model = model.cuda().to(memory_format=torch.channels_last)
    for bsz in (1, 4):
        x = torch.from_numpy(np.stack(
            [smooth_frame(30 + i, (512, 512)) for i in range(bsz)])) \
            .permute(0, 3, 1, 2).float() / 127.5 - 1.0
        with torch.no_grad():
            ref = cpu(x)
            got = model(x.cuda())
        err = max(float((g.cpu() - r).abs().max() / r.abs().max())
                  for g, r in zip(got, ref))
        agree = float((got[0].argmax(1).cpu() == ref[0].argmax(1)).float()
                      .mean())
        xc = x.cuda().contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            ms = time_ms(lambda: model(xc), iters=5, runs=3)
        print(f'BiSeNet fp32 512^2 B={bsz}: card vs CPU max rel |diff| '
              f'{err:.3g} (<= {BISENET_RTOL}) over the three heads, parse ids '
              f'agree on {agree:.6f}; {ms:.3f} ms a forward {ms.spread()}',
              flush=True)
        if err > BISENET_RTOL:
            raise SystemExit('chip_smoke: BiSeNet on the card disagrees with '
                             'its CPU copy')


def phase_vqgan():
    """VQAutoEncoder.forward (encode -> quantize -> decode) at full width
    (nf 64, ch_mult 1,2,2,4,4,8, 1024 codes of 256), bf16, B=2, seeded:
    exact launches (K1, K2, one K3), the reconstruction against the plain
    path's (K1/K2 plain with fp32 sums, K3 plain, the codes held to the
    kernel path's). Returns
    (launch counts, the quantizer's input and codebook, for the one
    device activity of its K3 call taken at the end)."""
    from codeformer_tpu_torch.models.vqgan import VQAutoEncoder
    from codeformer_tpu_torch.nn.blocks import ResBlock
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.ops import vq
    from codeformer_tpu_torch.utils.checkpoint import init_params_fast
    model = init_params_fast(VQAutoEncoder(), 4).cuda().eval() \
        .requires_grad_(False)
    n_res = sum(isinstance(m, ResBlock) for m in model.modules())
    x = torch.from_numpy(np.stack(_faces(np.random.default_rng(4), 2))) \
        .cuda()
    xn = (x.float() / 127.5 - 1.0).to(torch.bfloat16).permute(0, 3, 1, 2)
    reset_launch_counts()
    with torch.inference_mode():
        out_k, loss_k, stats_k = model(xn)
    torch.cuda.synchronize()
    got = launch_counts()
    want = dict(forward_launches(n_res), nearest_code=1)
    print(f'VQAutoEncoder.forward, full width, bf16, B=2: launches {got} '
          f'(expected {want}); codebook loss {float(loss_k):.5g}, '
          f'perplexity {float(stats_k["perplexity"]):.4g}', flush=True)
    if {k: got[k] for k in want} != want or any(
            v for k, v in got.items() if k not in want):
        raise SystemExit('chip_smoke: VQAutoEncoder launch counts differ')
    idx_k = stats_k['min_encoding_indices']
    agree = []

    def held(z, e):
        agree.append(float((vq._nearest_code_ref(z, e) == idx_k)
                           .float().mean()))
        return idx_k

    with torch.inference_mode(), mock.patch.multiple(
            cv, conv3x3_dots=takes_prepared(cv.conv3x3_dots_ref),
            downsample_dots=takes_prepared(cv.downsample_dots_ref)), \
            mock.patch.object(vq, 'nearest_code_indices', held):
        out_r, loss_r, _ = model(xn)
    img_k = (out_k.float().clamp(-1, 1) + 1) * 127.5
    diff = (img_k - (out_r.float().clamp(-1, 1) + 1) * 127.5).abs()
    std = float(img_k.std())
    inside = (float(diff.mean()) <= IMAGE_DIFF_BOUND and std >= MIN_IMAGE_STD
              and agree[0] >= INDEX_AGREEMENT_FLOOR
              and bool(torch.isfinite(out_k.float()).all()))
    print(f'  reconstruction vs plain (K1/K2 fp32 sums, K3 plain; codes '
          f'held): mean |diff| {float(diff.mean()):.4f} (<= '
          f'{IMAGE_DIFF_BOUND}) max {float(diff.max()):.0f} levels, image std '
          f'{std:.2f} (>= {MIN_IMAGE_STD}); the plain path\'s own picks agree '
          f'on {agree[0]:.4f} (>= {INDEX_AGREEMENT_FLOOR}); codebook loss '
          f'{float(loss_k):.5g} vs {float(loss_r):.5g}: '
          f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
    if not inside:
        raise SystemExit('chip_smoke: VQAutoEncoder disagrees with its plain '
                         'version')
    with torch.inference_mode():
        z, _ = model.encoder(xn)
    z_flat = z.float().permute(0, 2, 3, 1).reshape(-1, z.shape[1]) \
        .contiguous()
    return got, (z_flat, model.quantize.embedding.weight)


def vqgan_activities(probe) -> None:
    """One device activity a K3 call of VQAutoEncoder.forward's quantizer
    (its input and kept codebook), by torch.profiler."""
    from codeformer_tpu_torch.ops import vq
    z_flat, codebook = probe
    acts, ms = device_launches(
        lambda: vq.nearest_code_indices(z_flat, codebook))
    print(f'VQAutoEncoder quantizer, T={len(z_flat)}: {acts:.2f} device '
          f'activities a K3 call (expected 1), {ms:.4f} ms a launch '
          f'(profiler)', flush=True)
    if acts != 1.0:
        raise SystemExit('chip_smoke: the VQAutoEncoder K3 call is more than '
                         'one device activity')


# ---------------------------------------------- the last serving features
FP32_BATCH = 8
FP32_HOST_BATCH = 2
# fp32 serving on the card (cuDNN, TF32 off) against the same model on the
# host (codes held): lq_feat and logits rel RMS read 6.0e-6 and 4.5e-6, the
# images 0.0003 levels apart on average (one value off by one) on an H100;
# the same forward with TF32 left on reads 1.1e-3 and 0.042 (PERF.md)
FP32_REL_BOUND = 3e-5
FP32_DIFF_BOUND = 0.005    # uint8 levels, mean |diff|
# JAX's int8 budgets (tests/test_int8.py): code agreement with the float
# path and the generator's PSNR against it on the same codes
INT8_AGREE_FLOOR = 0.85
INT8_PSNR_FLOOR = 35.0
RATE_WINDOWS = 2           # windows a path in the phases below


def tf32_flags() -> tuple:
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def set_tf32(flags) -> None:
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = flags


def paths_rate(paths: dict, xb) -> dict:
    """Faces/s of each restorer in `paths` on the uint8 batch xb,
    RATE_WINDOWS windows of >= RATE_WINDOW_S s each, the paths in turns
    (a b b a ...); {name: (median, min, max)}."""
    got = {k: [] for k in paths}
    names = list(paths)
    for rep in range(RATE_WINDOWS):
        for name in (names if rep % 2 == 0 else names[::-1]):
            got[name].append(_rate(paths[name], xb))
    return {k: (statistics.median(v), min(v), max(v)) for k, v in got.items()}


def fmt_rate(r) -> str:
    return f'{r[0]:.2f} [{r[1]:.2f}, {r[2]:.2f}]'


def phase_fp32():
    """--dtype fp32 on the card: CodeFormerRestorer(device='cuda',
    dtype=float32) at full width serves the plain path (no K1/K2) with
    TF32 off for the call and the caller's flags back after it; its
    forward against the same model on the host (B=2, codes held), and a
    TF32 forward (the guard planted away) that must fail the bound;
    faces/s at B=1 and 8. Returns the launch counts of the requests."""
    import copy

    from codeformer_tpu_torch.pipeline import restorer as rmod
    r = rmod.CodeFormerRestorer(device='cuda', dtype=torch.float32, seed=0)
    tame_sft(r.model)
    rng = np.random.default_rng(21)
    faces = _faces(rng, FP32_BATCH)
    seen = []
    # on the encoder: a graphed forward calls the model's halves, and
    # its first call runs them eagerly, then captures them
    hook = r.model.encoder.register_forward_pre_hook(
        lambda m, a: seen.append(tf32_flags()))
    prev = tf32_flags()
    set_tf32((True, True))
    try:
        reset_launch_counts()
        out = r.restore_batch(faces, w=0.5)
        torch.cuda.synchronize()
        counts = launch_counts()
        after = tf32_flags()
    finally:
        set_tf32(prev)
        hook.remove()
    print(f'fp32 serving, full width, B={FP32_BATCH}: launches {counts} '
          f'(expected none); TF32 flags (cudnn, matmul) in the forward '
          f'{seen}, after it {after} (set (True, True) before it)',
          flush=True)
    if any(counts.values()) or not seen \
            or set(seen) != {(False, False)} or after != (True, True):
        raise SystemExit('chip_smoke: fp32 serving launched a kernel or '
                         'left TF32 on')
    for face, o in zip(faces, out):
        if o.shape != face.shape or o.dtype != np.uint8 \
                or np.array_equal(o, face):
            raise SystemExit('chip_smoke: fp32 serving output is wrong (or '
                             'the passthrough fired)')
    x = torch.from_numpy(np.stack(_faces(rng, FP32_HOST_BATCH))[..., ::-1]
                         .copy())
    host = copy.deepcopy(r.model).cpu()
    codes = []
    with torch.inference_mode(), rmod.ieee_fp32(), \
            codes_held(r.model, codes, replay=False):
        card = r.model(r.normalize(x.cuda()), 0.5, adain=True)
    t0 = time.perf_counter()
    with torch.inference_mode(), codes_held(host, codes, replay=True):
        ref = host(r.normalize(x), 0.5, adain=True)
    host_s = time.perf_counter() - t0

    def against(label, got):
        diff = (r.denormalize(got[0]).float().cpu()
                - r.denormalize(ref[0]).float()).abs()
        rr = dict(lq=rel_rms(got[2].cpu(), ref[2]),
                  logits=rel_rms(got[1].cpu(), ref[1]),
                  diff=float(diff.mean()))
        inside = (max(rr['lq'], rr['logits']) <= FP32_REL_BOUND
                  and rr['diff'] <= FP32_DIFF_BOUND)
        print(f'  {label} vs the host (fp32, codes held): lq_feat rel_rms '
              f'{rr["lq"]:.3g}, logits rel_rms {rr["logits"]:.3g} (<= '
              f'{FP32_REL_BOUND}); image diff mean {rr["diff"]:.4f} (<= '
              f'{FP32_DIFF_BOUND}) max {float(diff.max()):.0f} levels: '
              f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
        return inside

    img_std = float(r.denormalize(card[0]).float().std())
    print(f'  card forward B={FP32_HOST_BATCH}: image std {img_std:.2f} '
          f'(>= {MIN_IMAGE_STD}); the host forward took {host_s:.1f} s',
          flush=True)
    if img_std < MIN_IMAGE_STD or not against('card fp32 forward', card):
        raise SystemExit('chip_smoke: fp32 serving on the card disagrees '
                         'with the host')
    set_tf32((True, True))        # the forward without the restorer's guard
    try:
        with torch.inference_mode(), \
                codes_held(r.model, codes, replay=True):
            fault = r.model(r.normalize(x.cuda()), 0.5, adain=True)
    finally:
        set_tf32(prev)
    if against('planted fault: TF32 left on', fault):
        raise SystemExit('chip_smoke: the fp32 bounds let TF32 pass')
    del host, ref, card, fault
    print(f'  fp32 faces/s through restore_device, TF32 off, '
          f'{RATE_WINDOWS} windows of >= {RATE_WINDOW_S} s: median [min, '
          f'max]', flush=True)
    for bsz in (1, FP32_BATCH):
        xb = torch.from_numpy(np.stack(_faces(rng, bsz))).cuda()
        print(f'  fp32 faces/s at B={bsz}: '
              f'{fmt_rate(paths_rate({"fp32": r}, xb)["fp32"])}', flush=True)
    del r
    torch.cuda.empty_cache()
    return counts


def int8_calls_at(keys, bsz: int) -> int:
    """_int_mm calls of one forward at batch `bsz`, from the per-image
    shapes of its int8 convs (whole images a call, nn/quant.py)."""
    from codeformer_tpu_torch.nn import quant as pq
    n = 0
    for (h, w, c), _, kh, kw, stride, pads in keys:
        ho = (h + pads[0] + pads[1] - kh) // stride + 1
        wo = (w + pads[2] + pads[3] - kw) // stride + 1
        kp = -(-kh * kw * c // 8) * 8
        per = max(1, pq.CHUNK_BYTES // (ho * wo * kp))
        n += -(-bsz // per)
    return n


def phase_int8(bf16):
    """--quant int8 on the card: CodeFormerRestorer(device='cuda',
    quant='int8') at full width. Every int8 conv shape of a B=1 forward
    (the padded conv_in and conv_out, the ResBlock convs, the
    Downsamples, the four Upsample phases) against the host's int32
    product on the same int8 operands, exactly; the B=8 forward with no
    K1/K2 and the expected _int_mm calls; its codes against the bf16
    kernel path's and the generator's PSNR against bf16 on the same codes
    (JAX's budgets); int8 and bf16 faces/s at B=1, 8, 16 in turns and
    peak memory; the 512^2 64->64 conv's time. Returns the launches of
    the B=8 forward (all kernels 0) with `int_mm`."""
    from codeformer_tpu_torch.nn import quant as pq
    from codeformer_tpu_torch.pipeline import restorer as rmod
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    r = CodeFormerRestorer(device='cuda', quant='int8', seed=0)
    tame_sft(r.model)
    rng = np.random.default_rng(22)
    calls, first = [], {}
    real = pq.int8_conv

    def spy(xq, wt, stride=1, pads=(1, 1, 1, 1)):
        y = real(xq, wt, stride, pads)
        key = (tuple(xq.shape[1:]), wt.n, wt.kh, wt.kw, stride, tuple(pads))
        calls.append(key)
        first.setdefault(key, (xq, wt, y))
        return y

    x1 = torch.from_numpy(np.stack(_faces(rng, 1))).cuda()
    with mock.patch.object(pq, 'int8_conv', spy), \
            rmod.eager_forwards():     # one call each, none captured
        r.restore_device(x1)
    torch.cuda.synchronize()
    bad = []
    t0 = time.perf_counter()
    for key, (xq, wt, y) in first.items():
        host = real(xq.cpu(), wt._replace(mat=wt.mat.cpu()), key[4], key[5])
        if not torch.equal(host, y.cpu()):
            bad.append(key)
    print(f'int8 serving, full width: {len(calls)} int8 convs a forward, '
          f'{len(first)} distinct shapes ((H, W, Cin), N, kh, kw, stride, '
          f'pads): ' + '; '.join(str(k) for k in first), flush=True)
    print(f'  int32 products on the card vs the host on the same int8 '
          f'operands (B=1, every shape): {len(first) - len(bad)} of '
          f'{len(first)} equal ({time.perf_counter() - t0:.1f} s on the '
          f'host)', flush=True)
    if bad:
        raise SystemExit(f'chip_smoke: int8 products differ from the host '
                         f'at {bad}')
    x8 = torch.from_numpy(np.stack(_faces(rng, 8))).cuda()
    reset_launch_counts()
    r.restore_device(x8)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = int8_calls_at(calls, 8)
    print(f'  B=8 forward: launches {counts} (no kernel; int_mm expected '
          f'{want})', flush=True)
    if any(v for k, v in counts.items() if k != 'int_mm') \
            or counts['int_mm'] != want:
        raise SystemExit('chip_smoke: the int8 forward launched a kernel or '
                         'another count of _int_mm calls')
    xn = bf16.normalize(x8)
    with torch.inference_mode():
        _, logits_f, _ = bf16.model(xn, 0.5, adain=True)
        _, logits_q, _ = r.model(xn, 0.5, adain=True)
        idx = logits_f.argmax(-1)
        agree = float((logits_q.argmax(-1) == idx).float().mean())
        q = bf16.model.quantize.get_codebook_feat(
            idx, shape=(8, 16, 16, 256), dtype=torch.bfloat16)
        y_f = bf16.model.generator(q).float()
        y_q = r.model.generator(q).float()
    peak = float(y_f.abs().max())
    mse = float((y_q - y_f).pow(2).mean())
    psnr = 10.0 * math.log10(peak ** 2 / max(mse, 1e-12))
    print(f'  int8 vs the bf16 kernel path, B=8: code agreement {agree:.4f} '
          f'(>= {INT8_AGREE_FLOOR}); generator on the bf16 codes: PSNR '
          f'{psnr:.2f} dB (>= {INT8_PSNR_FLOOR}; peak {peak:.3g})',
          flush=True)
    if agree < INT8_AGREE_FLOOR or psnr < INT8_PSNR_FLOOR \
            or not torch.isfinite(y_q).all():
        raise SystemExit('chip_smoke: int8 serving outside JAX\'s budgets')
    conv = r.model.encoder.blocks[1].conv1
    xc = torch.randn(8, 64, 512, 512, device='cuda', dtype=torch.bfloat16) \
        .contiguous(memory_format=torch.channels_last)
    wc = conv.weight.to(torch.bfloat16)
    with torch.inference_mode():
        t_q = time_ms(lambda: conv(xc), iters=5, runs=3)
        t_c = time_ms(lambda: torch.nn.functional.conv2d(
            xc, wc, conv.bias.to(torch.bfloat16), padding=1), iters=5,
            runs=3)
        xh = xc.permute(0, 2, 3, 1)
        xq, sx = pq.quantize_act(xh)
        wt = conv.int8_weight(torch.bfloat16)
        y32 = pq.int8_conv(xq, wt)
        a = torch.randint(-127, 128, (7 * 512 * 512, 576), device='cuda',
                          dtype=torch.int8)
        parts = {
            'quantize_act': time_ms(lambda: pq.quantize_act(xh), 5, 3),
            'int8_conv (patch matrices + _int_mm)':
                time_ms(lambda: pq.int8_conv(xq, wt), 5, 3),
            '_int_mm alone, one 7-image chunk':
                time_ms(lambda: torch._int_mm(a, wt.mat.t()), 5, 3),
            'dequantize': time_ms(lambda: pq.dequantize(
                y32, sx, wt.scale, torch.bfloat16), 5, 3)}
    print(f'  one 512^2 64->64 conv at B=8: int8 (quantize, patch matrix, '
          f'_int_mm, dequantize, bias) {t_q:.4f} ms {t_q.spread()}, cuDNN '
          f'bf16 {t_c:.4f} ms {t_c.spread()}; int8 steps: ' + '; '.join(
              f'{k} {v:.4f} ms' for k, v in parts.items()), flush=True)
    del xc, xh, xq, y32, a
    for bsz in (1, 8, 16):
        xb = torch.from_numpy(np.stack(_faces(rng, bsz))).cuda()
        rates = paths_rate({'int8': r, 'bf16': bf16}, xb)
        peaks = {}
        for name, rr in (('int8', r), ('bf16', bf16)):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            rr.restore_device(xb)
            torch.cuda.synchronize()
            peaks[name] = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        print(f'  faces/s at B={bsz}: int8 {fmt_rate(rates["int8"])}, bf16 '
              f'{fmt_rate(rates["bf16"])}, ratio '
              f'{rates["int8"][0] / rates["bf16"][0]:.3f}; peak memory '
              f'above the weights int8 {peaks["int8"]:.2f} GiB, bf16 '
              f'{peaks["bf16"]:.2f} GiB', flush=True)
    del r
    torch.cuda.empty_cache()
    return counts


def phase_multi_device(bf16):
    """CodeFormerRestorer(devices=['cuda:0']) against the serving
    restorer (same seed, device='cuda') at B=8: restore_device and
    restore_batch bit for bit, the same launches. The machine has one
    card: a two-card reading is not made. Returns its launches."""
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    r = CodeFormerRestorer(devices=['cuda:0'], seed=0)
    tame_sft(r.model)
    faces = _faces(np.random.default_rng(23), 8)
    x8 = torch.from_numpy(np.stack(faces)).cuda()
    reset_launch_counts()
    got = r.restore_device(x8)
    torch.cuda.synchronize()
    counts = launch_counts()
    reset_launch_counts()
    want = bf16.restore_device(x8)
    torch.cuda.synchronize()
    ref_counts = launch_counts()
    same_batch = all(np.array_equal(a, b) for a, b in zip(
        r.restore_batch(faces), bf16.restore_batch(faces)))
    equal = bool(torch.equal(got, want)) and same_batch
    print(f"multi-device restorer, devices=['cuda:0'] (one card here), B=8: "
          f'restore_device {"bit-equal" if torch.equal(got, want) else "DIFFERS"}'
          f', restore_batch {"bit-equal" if same_batch else "DIFFERS"} to '
          f'the one-device restorer; launches {counts} (one device: '
          f'{ref_counts}); buckets {r.batch_buckets}', flush=True)
    if not equal or counts != ref_counts:
        raise SystemExit('chip_smoke: the multi-device restorer differs from '
                         'the one-device restorer')
    del r
    torch.cuda.empty_cache()
    return counts


VQGAN_CLI_BATCH = 4


def phase_vqgan_cli():
    """inference_vqgan's core (`reconstruct`) at full width on
    VQGAN_CLI_BATCH seeded faces: --dtype bf16 with exact launches (K1,
    K2, one K3), against the plain path (K1/K2/K3 plain, the codes held);
    images/s at fp32 and bf16. Returns the bf16 launches."""
    from codeformer_tpu_torch.cli import generate_latent_gt as glg
    from codeformer_tpu_torch.cli import inference_vqgan as ivq
    from codeformer_tpu_torch.nn.blocks import ResBlock
    from codeformer_tpu_torch.ops import conv3x3 as cv
    from codeformer_tpu_torch.ops import vq
    faces = np.stack(_faces(np.random.default_rng(24), VQGAN_CLI_BATCH))
    x = torch.from_numpy(faces[..., ::-1].copy()).cuda()
    m16 = glg.build_vqgan(None, seed=4, dtype=torch.bfloat16, device='cuda')
    n_res = sum(isinstance(m, ResBlock) for m in m16.modules())
    picks = []
    search = vq.nearest_code_indices

    def record(z, e):
        picks.append(search(z, e))
        return picks[-1]

    reset_launch_counts()
    with mock.patch.object(vq, 'nearest_code_indices', record):
        y = ivq.reconstruct(m16, x, torch.bfloat16)
    torch.cuda.synchronize()
    counts = launch_counts()
    want = dict(NO_LAUNCHES, **forward_launches(n_res), nearest_code=1)
    print(f'inference_vqgan core, full width, bf16, B={VQGAN_CLI_BATCH}: '
          f'launches {counts} (expected {want}); output '
          f'{tuple(y.shape)} {y.dtype}', flush=True)
    if counts != want or y.shape != x.shape or y.dtype != torch.uint8:
        raise SystemExit('chip_smoke: inference_vqgan launches or output '
                         'differ')
    agree = []

    def held(z, e):
        agree.append(float((vq._nearest_code_ref(z, e) == picks[0])
                           .float().mean()))
        return picks[0]

    with mock.patch.multiple(
            cv, conv3x3_dots=takes_prepared(cv.conv3x3_dots_ref),
            downsample_dots=takes_prepared(cv.downsample_dots_ref)), \
            mock.patch.object(vq, 'nearest_code_indices', held):
        y_r = ivq.reconstruct(m16, x, torch.bfloat16)
    diff = (y.float() - y_r.float()).abs()
    std = float(y.float().std())
    inside = (float(diff.mean()) <= IMAGE_DIFF_BOUND and std >= MIN_IMAGE_STD
              and agree[0] >= INDEX_AGREEMENT_FLOOR)
    print(f'  vs the plain path (K1/K2 fp32 sums, K3 plain; codes held): mean '
          f'|diff| {float(diff.mean()):.4f} (<= {IMAGE_DIFF_BOUND}) max '
          f'{float(diff.max()):.0f} levels, image std {std:.2f} (>= '
          f'{MIN_IMAGE_STD}); the plain path\'s own picks agree on '
          f'{agree[0]:.4f} (>= {INDEX_AGREEMENT_FLOOR}): '
          f'{"within bounds" if inside else "OUT of bounds"}', flush=True)
    if not inside:
        raise SystemExit('chip_smoke: inference_vqgan disagrees with its '
                         'plain path')
    m32 = glg.build_vqgan(None, seed=4, dtype=torch.float32, device='cuda')
    rates = {'fp32': [], 'bf16': []}
    models = {'fp32': (m32, torch.float32), 'bf16': (m16, torch.bfloat16)}
    for name in ('fp32', 'bf16', 'bf16', 'fp32'):
        m, dt = models[name]
        for _ in range(2):
            ivq.reconstruct(m, x, dt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reps = 5
        for _ in range(reps):
            ivq.reconstruct(m, x, dt)
        torch.cuda.synchronize()
        rates[name].append(reps * len(x) / (time.perf_counter() - t0))
    print(f'  inference_vqgan images/s at B={VQGAN_CLI_BATCH} (two windows '
          f'each, in turns): fp32 {rates["fp32"]}, bf16 {rates["bf16"]}',
          flush=True)
    del m16, m32
    torch.cuda.empty_cache()
    return counts


CLI_FACES = os.path.join('inputs', 'cropped_faces')
CLI_DIGESTS = os.path.join('tests', 'torch_inputs_digests.json')
# peak device memory of the whole-image CLI on the 20 cropped faces as
# whole images (random RetinaFace weights find 200 faces, 162 in the first
# 16-frame chunk, restored and parsed in runs of 8). Read on an H100
# (PERF.md): 11.24 GiB; the same run restoring each chunk in one call
# (--batch 256) asked for 32 GiB more with 56 GiB allocated and ran out
# of memory
CLI_PEAK_BOUND_GIB = 32.0


def run_cli(main_fn, argv) -> tuple:
    """main_fn(argv) with the launch counts set to 0 just before it and
    read just after: (counts, its stdout)."""
    import io
    out = io.StringIO()
    reset_launch_counts()
    with contextlib.redirect_stdout(out):
        main_fn(argv)
    torch.cuda.synchronize()
    return launch_counts(), out.getvalue()


def add_counts(total: dict, counts: dict) -> None:
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def restorer_launches(restorer, n_faces: int, fuse: bool) -> dict:
    """K1/K2 launches of restore_batch on n_faces: one forward a chunk of
    the largest bucket, counted as phase_slice counts a forward."""
    from codeformer_tpu_torch.nn.blocks import Downsample
    chunks = -(-n_faces // restorer.batch_buckets[-1])
    n_res = count_resblocks(restorer.model, enable_fuse=fuse)
    n_down = sum(isinstance(m, Downsample) for m in restorer.model.modules())
    return dict(NO_LAUNCHES, **forward_launches(n_res, chunks, n_down))


def shared_restorer(made: list):
    """A CodeFormerRestorer factory for mock.patch that builds one
    restorer on the first call (appending it to `made`) and hands the same
    one to every later call, so runs of a CLI share weights and warm
    state."""
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer

    def make(**kw):
        if not made:
            made.append(CodeFormerRestorer(**kw))
        return made[0]
    return make


def whole_image_cli_run(files, base: str, label: str, flags=(),
                        fused: bool = True) -> tuple:
    """The whole-image CLI's main(argv) on a folder of `files` (linked
    into `base`_in, written to `base`_out): it must take the fused route
    (`fused`) or the classic one, and write one final_results file an
    input at the min-side-512 size x2, and a cropped and a restored face
    for every face found. Returns (launch counts, its stdout, faces found
    an image)."""
    import re

    import cv2

    from codeformer_tpu_torch.cli import inference_codeformer as icf
    src, out = base + '_in', base + '_out'
    os.makedirs(src)
    for f in files:
        os.symlink(f, os.path.join(src, os.path.basename(f)))
    counts, said = run_cli(icf.main, ['-i', src, '-o', out, '--random-init',
                                      *flags])
    faces = [int(n) for n in re.findall(
        r'Processing: \S+ \((\d+) faces\)' if fused
        else r'\tdetect (\d+) faces', said)]

    def listed(sub):
        d = os.path.join(out, sub)
        return sorted(os.listdir(d)) if os.path.isdir(d) else []

    finals = listed('final_results')
    crops, rest = listed('cropped_faces'), listed('restored_faces')
    ok = len(faces) == len(files) and len(finals) == len(files) and \
        len(crops) == len(rest) == sum(faces)
    for f in files:
        img = cv2.imread(f, cv2.IMREAD_COLOR)
        up = max(1.0, 512 / min(img.shape[:2]))
        h, w = cv2.resize(img, (0, 0), fx=up, fy=up,
                          interpolation=cv2.INTER_LINEAR).shape[:2]
        name = os.path.splitext(os.path.basename(f))[0] + '.png'
        got = cv2.imread(os.path.join(out, 'final_results', name))
        ok = ok and got is not None and got.shape == (2 * h, 2 * w, 3)
    print(f'  whole-image CLI on {label} {" ".join(flags)}: exit 0, '
          f'{len(finals)} final_results at the min-side-512 size x2, faces '
          f'found {faces} (random detector weights), {len(crops)} cropped / '
          f'{len(rest)} restored faces; launches {counts}', flush=True)
    if not ok:
        raise SystemExit(f'chip_smoke: the whole-image CLI on {label} '
                         f'{" ".join(flags)} wrote the wrong outputs')
    return counts, said, faces


def cli_digest_check() -> None:
    """Every inputs/ file decodes with this machine's cv2 to the sha256
    recorded with the tests (tests/torch_inputs_digests.json), so the CLI
    runs below restore the pixels the tests hold against JAX."""
    import hashlib

    import cv2
    with open(os.path.join(ROOT, CLI_DIGESTS)) as f:
        files = json.load(f)['files']
    bad = []
    for rel, rec in files.items():
        img = cv2.imread(os.path.join(ROOT, rel), cv2.IMREAD_COLOR)
        digest = hashlib.sha256(np.ascontiguousarray(img).tobytes()) \
            .hexdigest()
        if list(img.shape) != rec['shape'] or digest != rec['sha256']:
            bad.append(rel)
    print(f'cv2 {cv2.__version__}: {len(files) - len(bad)} of {len(files)} '
          f'inputs/ files decode to the recorded sha256 ({CLI_DIGESTS})',
          flush=True)
    if bad:
        raise SystemExit(f'chip_smoke: cv2\'s decode here differs from the '
                         f'recorded one for {bad}')


def phase_cli_files() -> dict:
    """The serving CLIs' main(argv) on the repo's files, on the card
    (--random-init): (a) the aligned CLI on
    inputs/cropped_faces, its faces bit-equal to restore_batch in process
    and its K1/K2 launches exact, then its images/s split by its stage
    timer; (b) the whole-image CLI's fused route on each whole_imgs/
    image alone and on cropped_faces as whole images, that run's peak
    memory under CLI_PEAK_BOUND_GIB, which the same run restoring each
    chunk's faces in one call (--batch 256) must fail; (c) colorization
    and inpainting; (d) inference_vqgan --dtype bf16 (K3); the documented
    aligned command as a subprocess; every inputs/ decode against its
    recorded digest. Returns the launches of the CLI runs."""
    import glob
    import shutil
    import tempfile

    import cv2

    from codeformer_tpu_torch import pipeline
    from codeformer_tpu_torch.cli import generate_latent_gt as glg
    from codeformer_tpu_torch.cli import inference_codeformer as icf
    from codeformer_tpu_torch.cli import inference_colorization as icol
    from codeformer_tpu_torch.cli import inference_inpainting as iinp
    from codeformer_tpu_torch.cli import inference_vqgan as ivq
    from codeformer_tpu_torch.nn.blocks import ResBlock
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    from codeformer_tpu_torch.utils import img_util
    from codeformer_tpu_torch.utils.profiler import TIMER
    t_phase = time.perf_counter()
    cli_digest_check()
    total: dict = {}
    made = []

    class Recorded(CodeFormerRestorer):
        def __init__(self, **kw):
            super().__init__(**kw)
            made.append(self)

    faces_dir = os.path.join(ROOT, CLI_FACES)
    paths = sorted(glob.glob(os.path.join(faces_dir, '*.png')))
    tmp = tempfile.mkdtemp(prefix='cli_files_')
    try:
        # (a) the aligned CLI: checked, then timed warm by its stages
        with mock.patch.object(pipeline, 'CodeFormerRestorer', Recorded):
            for run in ('checked', 'timed'):
                out = os.path.join(tmp, f'aligned_{run}')
                TIMER.reset()
                counts, _ = run_cli(icf.main, [
                    '--has_aligned', '-i', faces_dir, '-o', out,
                    '--random-init'])
                r = made[-1]
                want = restorer_launches(r, len(paths), fuse=True)
                print(f'  aligned CLI ({run}), {len(paths)} faces, full '
                      f'width, bf16: launches {counts} (expected {want})',
                      flush=True)
                if counts != want:
                    raise SystemExit('chip_smoke: the aligned CLI\'s '
                                     'launches differ')
                add_counts(total, counts)
                if run == 'timed':
                    st = {k: TIMER.totals[k] for k in
                          ('read', 'restore', 'write')}
                    print(f'  aligned CLI images/s without start-up '
                          f'{len(paths) / sum(st.values()):.2f} (read '
                          f'{st["read"]:.3f} s, restore '
                          f'{st["restore"]:.3f} s, write {st["write"]:.3f} '
                          f's for {len(paths)} faces; utils/profiler.py '
                          f'stages) [{card_line()}]', flush=True)
                    continue
                faces = [cv2.resize(cv2.imread(p, cv2.IMREAD_COLOR),
                                    (512, 512),
                                    interpolation=cv2.INTER_LINEAR)
                         for p in paths]
                ref = r.restore_batch(faces, w=0.5, adain=True)
                n_gray = 0
                for p, face, o in zip(paths, faces, ref):
                    if img_util.is_gray(face, threshold=10):
                        n_gray += 1
                        o = img_util.adain_color_transfer(
                            img_util.bgr2gray3(o), face)
                    got = cv2.imread(os.path.join(
                        out, 'restored_faces', os.path.basename(p)))
                    if got is None or not np.array_equal(got, o):
                        raise SystemExit(f'chip_smoke: the aligned CLI\'s '
                                         f'{os.path.basename(p)} differs '
                                         f'from restore_batch in process')
                print(f'  aligned CLI: {len(paths)} restored_faces/*.png '
                      f'bit-equal to restore_batch in process ({n_gray} '
                      f'gray, with the gray adaptation)', flush=True)
            del made[:]
        # (b) the whole-image CLI on the fused route, one restorer
        shared: list = []

        # each whole image alone (the JPEGs and the two 4-channel PNGs),
        # and the 20 cropped faces as whole images: random RetinaFace
        # weights find about 10 faces a frame there, about 160 in the
        # first 16-frame chunk, which the pipeline restores and parses in
        # runs of the CLI's --batch 8; the peak memory of that run is
        # held under CLI_PEAK_BOUND_GIB
        whole = os.path.join(ROOT, 'inputs', 'whole_imgs')
        runs = [(n, [os.path.join(whole, n)]) for n in sorted(
            os.listdir(whole))]
        runs.append(('cropped_faces as whole images', paths))
        found = []
        with mock.patch.object(pipeline, 'CodeFormerRestorer',
                               shared_restorer(shared)):
            for k, (label, files) in enumerate(runs):
                crowded = files is paths
                base = os.path.join(tmp, f'whole_{k}')
                if crowded:
                    torch.cuda.empty_cache()
                    torch.cuda.reset_peak_memory_stats()
                counts, _, faces = whole_image_cli_run(
                    files, base, f'{label} (fused route)')
                add_counts(total, counts)
                found.append(sum(faces))
                if crowded:
                    crowded_in = base + '_in'
                    peak = torch.cuda.max_memory_allocated() / 2 ** 30
                    print(f'  peak memory of the {label} run ({sum(faces)} '
                          f'faces, restored and parsed in runs of '
                          f'{shared[0].batch_buckets[-1]}): {peak:.2f} '
                          f'GiB (<= {CLI_PEAK_BOUND_GIB}) [{card_line()}]',
                          flush=True)
                    if peak > CLI_PEAK_BOUND_GIB:
                        raise SystemExit('chip_smoke: the whole-image CLI\'s '
                                         'peak memory exceeds its bound')
        del shared
        torch.cuda.empty_cache()
        # planted fault: the same run with the restorer's top bucket
        # widened to 256 restores each chunk's faces in one call; the
        # bound (or the card's memory) must catch it
        torch.cuda.reset_peak_memory_stats()
        try:
            run_cli(icf.main, ['-i', crowded_in,
                               '-o', os.path.join(tmp, 'whole_fault'),
                               '--random-init', '--batch', '256'])
            peak = torch.cuda.max_memory_allocated() / 2 ** 30
            caught = peak > CLI_PEAK_BOUND_GIB
            said = f'peak {peak:.2f} GiB'
        except torch.cuda.OutOfMemoryError as e:
            caught, said = True, f'out of memory ({str(e).splitlines()[0]})'
        gc.collect()
        torch.cuda.empty_cache()
        print(f'  planted fault: the cropped faces as whole images with '
              f'--batch 256 (one restore call a chunk): {said}; caught: '
              f'{caught}', flush=True)
        if not caught:
            raise SystemExit('chip_smoke: the peak-memory bound lets a '
                             'one-call restore of a crowded chunk pass')
        # (c) colorization and inpainting
        for mod, src, n_files, fuse in (
                (icol, 'gray_faces', 13, False),
                (iinp, 'masked_faces', 5, True)):
            out = os.path.join(tmp, src)
            with mock.patch.object(pipeline, 'CodeFormerRestorer',
                                   Recorded):
                counts, _ = run_cli(mod.main, [
                    '-i', os.path.join(ROOT, 'inputs', src), '-o', out,
                    '--random-init'])
            want = restorer_launches(made.pop(), n_files, fuse)
            written = sorted(os.listdir(out))
            shapes = {cv2.imread(os.path.join(out, n)).shape
                      for n in written}
            print(f'  {mod.__name__.rsplit(".", 1)[1]} CLI on inputs/{src}: '
                  f'{len(written)} files {shapes}; launches {counts} '
                  f'(expected {want})', flush=True)
            if counts != want or len(written) != n_files or \
                    shapes != {(512, 512, 3)}:
                raise SystemExit(f'chip_smoke: the {src} CLI run differs')
            add_counts(total, counts)
        # (d) inference_vqgan --dtype bf16: K3 once a batch
        models = []

        def recorded_vqgan(*a, **kw):
            models.append(glg.build_vqgan(*a, **kw))
            return models[-1]

        out = os.path.join(tmp, 'vqgan')
        with mock.patch.object(ivq, 'build_vqgan', recorded_vqgan):
            counts, _ = run_cli(ivq.main, [
                '-i', faces_dir, '-o', out, '--dtype', 'bf16',
                '--random-init', '--ckpt_path',
                os.path.join(tmp, 'missing.pth')])
        m = models.pop()
        n_res = sum(isinstance(x, ResBlock) for x in m.modules())
        calls = -(-len(paths) // 4)
        want = dict(NO_LAUNCHES, **forward_launches(n_res, calls),
                    nearest_code=calls)
        x = torch.from_numpy(np.stack([cv2.imread(p)[..., ::-1]
                                       for p in paths[:4]])).cuda()
        ref = ivq.reconstruct(m, x, torch.bfloat16).cpu().numpy()
        same = all(np.array_equal(
            cv2.imread(os.path.join(out, os.path.basename(p))),
            y[..., ::-1]) for p, y in zip(paths[:4], ref))
        print(f'  inference_vqgan --dtype bf16 on {CLI_FACES}: '
              f'{len(os.listdir(out))} files; launches {counts} (expected '
              f'{want}); the first batch bit-equal to reconstruct in '
              f'process: {same}', flush=True)
        if counts != want or len(os.listdir(out)) != len(paths) or not same:
            raise SystemExit('chip_smoke: the inference_vqgan CLI run '
                             'differs')
        add_counts(total, counts)
        del m, models, x
        torch.cuda.empty_cache()
        # the documented command, as a user types it
        out = os.path.join(tmp, 'subprocess')
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, '-m',
             'codeformer_tpu_torch.cli.inference_codeformer', '--has_aligned',
             '-i', CLI_FACES, '--random-init', '-o', out], cwd=ROOT,
            capture_output=True, text=True, timeout=600)
        n_out = len(os.listdir(os.path.join(out, 'restored_faces'))) \
            if os.path.isdir(os.path.join(out, 'restored_faces')) else 0
        print(f'  python -m codeformer_tpu_torch.cli.inference_codeformer '
              f'--has_aligned -i {CLI_FACES} --random-init: exit '
              f'{proc.returncode} in {time.perf_counter() - t0:.1f} s, '
              f'{n_out} restored faces', flush=True)
        if proc.returncode != 0 or n_out != len(paths):
            raise SystemExit(f'chip_smoke: the documented command failed:\n'
                             f'{proc.stderr[-3000:]}')
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f'  CLI files phase: {time.perf_counter() - t_phase:.1f} s; faces '
          f'found by the whole-image runs {found}', flush=True)
    return total


# the entry points that read and write files, on the repo's inputs or on
# seeded files the phase writes: the whole-image CLI's classic route with
# its flag sets, videos through the CLI on both routes, crop_align_face,
# and stage II from PNGs on disk (generate_latent_gt, then the training
# entry point as a subprocess); the CLI's default --batch 8
FILES_CLASSIC_FLAGS = (('--fused_pipeline', 'off'),
                       ('--bg_upsampler', 'realesrgan', '--face_upsample'),
                       ('--detection_model', 'YOLOv5n'),
                       ('--draw_box',))
FILES_STAGES = ('folder_detect_align', 'folder_restore', 'folder_parse',
                'folder_bg_upsample', 'folder_paste')
VIDEO_FRAMES = 48
VIDEO_FPS = 24.0
VIDEO_SHIFT = 2            # px a frame, so that the faces move
STAGE2_FILES = 16          # seeded 512^2 PNGs
STAGE2_ITERS = 30          # training iterations from them
STAGE2_WARM = 10           # iterations left out of the rate


def restored_faces_check(r, out: str, gray: set, label: str) -> int:
    """restored_faces/*.png of a whole-image CLI run bit-equal to
    r.restore_batch on the run's own cropped_faces/*.png (in the run's
    order), a gray image's faces with the gray adaptation. Returns the
    number of faces."""
    import cv2

    from codeformer_tpu_torch.utils import img_util
    d = os.path.join(out, 'cropped_faces')
    names = sorted(os.listdir(d)) if os.path.isdir(d) else []
    crops = [cv2.imread(os.path.join(d, n)) for n in names]
    ref = r.restore_batch(crops, w=0.5, adain=True) if crops else []
    for name, crop, o in zip(names, crops, ref):
        if name.rsplit('_', 1)[0] in gray:
            o = img_util.adain_color_transfer(img_util.bgr2gray3(o), crop)
        got = cv2.imread(os.path.join(out, 'restored_faces', name))
        if got is None or not np.array_equal(got, o):
            raise SystemExit(f'chip_smoke: {label}: restored_faces/{name} '
                             f'differs from restore_batch in process')
    return len(names)


def files_classic(tmp: str, restorer_made: list) -> dict:
    """The whole-image CLI's classic route on inputs/whole_imgs and a
    gray image written from 03.jpg, with each of FILES_CLASSIC_FLAGS."""
    import cv2

    from codeformer_tpu_torch import pipeline
    from codeformer_tpu_torch.pipeline import realesrgan as pesr
    from codeformer_tpu_torch.utils import img_util
    from codeformer_tpu_torch.utils.profiler import TIMER
    whole = os.path.join(ROOT, 'inputs', 'whole_imgs')
    gray_path = os.path.join(tmp, '07_gray.png')
    cv2.imwrite(gray_path, cv2.cvtColor(cv2.imread(
        os.path.join(whole, '03.jpg')), cv2.COLOR_BGR2GRAY))
    files = sorted(os.path.join(whole, n) for n in os.listdir(whole))
    files.append(gray_path)
    gray = {os.path.splitext(os.path.basename(f))[0] for f in files
            if img_util.is_gray(cv2.imread(f, cv2.IMREAD_COLOR), 10)}
    real_esr = pesr.set_realesrgan
    ups = []

    def tamed_realesrgan(**kw):
        up = real_esr(**kw)
        tame_rrdb(up.model)
        ups.append(up)
        return up

    total = {}
    with mock.patch.object(pipeline, 'CodeFormerRestorer',
                           shared_restorer(restorer_made)), \
            mock.patch.object(pesr, 'set_realesrgan', tamed_realesrgan):
        for k, flags in enumerate(FILES_CLASSIC_FLAGS):
            TIMER.reset()
            ups.clear()
            t0 = time.perf_counter()
            counts, _, faces = whole_image_cli_run(
                files, os.path.join(tmp, f'classic_{k}'),
                f'inputs/whole_imgs + a gray image (classic route)', flags,
                fused=False)
            wall = time.perf_counter() - t0
            r = restorer_made[0]
            n = restored_faces_check(r, os.path.join(tmp, f'classic_{k}_out'),
                                     gray, ' '.join(flags))
            want = dict(restorer_launches(r, n, fuse=True),
                        conv3x3_dense=dense_launches(ups))
            st = {s: TIMER.totals[s] for s in FILES_STAGES
                  if s in TIMER.totals}
            print(f'    {n} restored_faces/*.png bit-equal to restore_batch '
                  f'in process ({len(gray)} gray image(s), with the gray '
                  f'adaptation); launches expected {want}; images/s '
                  f'{len(files) / sum(st.values()):.2f} by its stages ('
                  + ', '.join(f'{s} {v:.3f} s' for s, v in st.items()) +
                  f'), main {wall:.2f} s with start-up and writes '
                  f'[{card_line()}]', flush=True)
            if counts != want or sum(faces) != n:
                raise SystemExit(f'chip_smoke: the classic route with '
                                 f'{" ".join(flags)}: launches or faces '
                                 f'differ')
            add_counts(total, counts)
    return total


def write_clip(path: str, src: str) -> list:
    """VIDEO_FRAMES frames of `src` (cropped to even sides), shifted by
    VIDEO_SHIFT px a frame, written with cv2's mp4v writer."""
    import cv2
    img = cv2.imread(src)
    h, w = img.shape[0] // 2 * 2, img.shape[1] // 2 * 2
    img = img[:h, :w]
    vw = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*'mp4v'), VIDEO_FPS,
                         (w, h))
    if not vw.isOpened():
        raise SystemExit(f'chip_smoke: cv2 cannot write {path}')
    for i in range(VIDEO_FRAMES):
        shift = np.float32([[1, 0, VIDEO_SHIFT * i - VIDEO_FRAMES],
                            [0, 1, 0]])
        vw.write(cv2.warpAffine(img, shift, (w, h),
                                borderMode=cv2.BORDER_REFLECT))
    vw.release()


def read_clip(path: str) -> tuple:
    """(every frame cv2.VideoCapture decodes, its frame rate)."""
    import cv2
    cap = cv2.VideoCapture(path)
    frames = []
    ok, f = cap.read()
    while ok:
        frames.append(f)
        ok, f = cap.read()
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return frames, fps


def files_video(tmp: str, restorer_made: list) -> dict:
    """A seeded mp4v clip through the CLI's main on the fused route
    (restore_frames_stream to the writer) and with --fused_pipeline off
    (pipeline/video.py restore_video_frames): the frames handed to the
    writer bit-equal to the same restorer, helper and pipeline in process
    on the same decoded frames, the same restorer batches, exact K1/K2
    launches, the written video reopened; frames/s of main."""
    import cv2

    from codeformer_tpu_torch import pipeline
    from codeformer_tpu_torch.cli import inference_codeformer as icf
    from codeformer_tpu_torch.pipeline import device_pipeline as pdp
    from codeformer_tpu_torch.pipeline import face_helper as pfh
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    from codeformer_tpu_torch.pipeline.video import restore_video_frames
    from codeformer_tpu_torch.utils import video_util
    clip = os.path.join(tmp, 'clip.mp4')
    write_clip(clip, os.path.join(ROOT, 'inputs', 'whole_imgs', '00.jpg'))
    decoded, fps = read_clip(clip)
    f = 512.0 / min(decoded[0].shape[:2])
    h, w = cv2.resize(decoded[0], (0, 0), fx=f, fy=f,
                      interpolation=cv2.INTER_LINEAR).shape[:2]
    print(f'  video: {len(decoded)} frames of {decoded[0].shape[1]}x'
          f'{decoded[0].shape[0]} at {fps:g} fps (mp4v, written with cv2 '
          f'from whole_imgs/00.jpg, {VIDEO_SHIFT} px a frame)', flush=True)
    if len(decoded) != VIDEO_FRAMES:
        raise SystemExit('chip_smoke: the written clip does not decode to '
                         'its frames')
    real_writer, real_fwd = video_util.make_video_writer, \
        CodeFormerRestorer._fwd
    total = {}
    for route, flags in (('fused', ()),
                         ('classic', ('--fused_pipeline', 'off'))):
        written, made, batches = [], {}, []

        def recording_writer(*a, **kw):
            writer = real_writer(*a, **kw)
            write = writer.write_frame

            def record(frame):
                written.append(np.array(frame))
                write(frame)
            writer.write_frame = record
            return writer

        def counted_fwd(self, x, *a, **kw):
            batches.append(int(x.shape[0]))
            return real_fwd(self, x, *a, **kw)

        class Pipe(pdp.DeviceRestorePipeline):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made['pipe'] = self

        class Helper(pfh.FaceRestoreHelper):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                made['helper'] = self

        out = os.path.join(tmp, f'video_{route}')
        with mock.patch.object(pipeline, 'CodeFormerRestorer',
                               shared_restorer(restorer_made)), \
                mock.patch.object(video_util, 'make_video_writer',
                                  recording_writer), \
                mock.patch.object(pdp, 'DeviceRestorePipeline', Pipe), \
                mock.patch.object(pfh, 'FaceRestoreHelper', Helper), \
                mock.patch.object(CodeFormerRestorer, '_fwd', counted_fwd):
            t0 = time.perf_counter()
            counts, _ = run_cli(icf.main, ['-i', clip, '-o', out,
                                           '--random-init', *flags])
            wall = time.perf_counter() - t0
            cli_batches = batches[:]
            del batches[:]
            r = restorer_made[0]
            if route == 'fused':
                ref, faces = made['pipe'].restore_frames(decoded,
                                                         return_faces=True)
                n_faces = [len(x) for x in faces]
            else:
                ref = restore_video_frames(list(decoded), r, made['helper'],
                                           w=0.5, upscale=2)
                n_faces = None
        got, got_fps = read_clip(os.path.join(out, 'clip.mp4'))
        same = len(written) == len(ref) == VIDEO_FRAMES and all(
            np.array_equal(a, b) for a, b in zip(written, ref))
        top = r.batch_buckets[-1]
        per = restorer_launches(r, 1, fuse=True)
        want = {k: v * len(cli_batches) for k, v in per.items()}
        print(f'  video through the CLI ({route} route{" " if flags else ""}'
              f'{" ".join(flags)}): {VIDEO_FRAMES / wall:.2f} frames/s end '
              f'to end ({wall:.2f} s: main with decode, restore, PNG and '
              f'video writes) [{card_line()}]; faces a frame '
              f'{n_faces if n_faces else "not printed"}, restorer batches '
              f'{cli_batches} (in process {batches}); frames handed to the '
              f'writer bit-equal to the in-process run: {same}; the .mp4 '
              f'reopens with {len(got)} frames of {got[0].shape[1]}x'
              f'{got[0].shape[0]} at {got_fps:g} fps; launches {counts} '
              f'(expected {want})', flush=True)
        if not same or cli_batches != batches or max(cli_batches) > top \
                or counts != want or len(got) != VIDEO_FRAMES \
                or got[0].shape != (2 * h, 2 * w, 3) \
                or abs(got_fps - VIDEO_FPS) > 1e-3:
            raise SystemExit(f'chip_smoke: the video through the CLI '
                             f'({route} route) differs')
        add_counts(total, counts)
    return total


def files_crop_align(tmp: str) -> None:
    """crop_align_face's main on inputs/whole_imgs, RetinaFace
    landmarks on the card (--random-init): a 512^2 crop for each image
    where a face was found, each bit-equal to align_crop_face_landmarks
    in process on the same detector's landmarks; images/s of main."""
    import glob

    import cv2

    from codeformer_tpu_torch.cli import crop_align_face as cac
    from codeformer_tpu_torch.pipeline.face_utils import \
        align_crop_face_landmarks
    whole = os.path.join(ROOT, 'inputs', 'whole_imgs')
    out = os.path.join(tmp, 'crops')
    dets = []
    real = cac.init_detection_model

    def recorded(*a, **kw):
        dets.append(real(*a, **kw))
        return dets[-1]

    with mock.patch.object(cac, 'init_detection_model', recorded):
        t0 = time.perf_counter()
        counts, _ = run_cli(cac.main, ['-i', whole, '-o', out,
                                       '--landmark-source', 'retinaface',
                                       '--random-init'])
        wall = time.perf_counter() - t0
    paths = sorted(glob.glob(os.path.join(whole, '*.[jpJP][pnPN]*[gG]')))
    found = 0
    for p in paths:
        img = cv2.imread(p)
        lm = cac.get_landmarks_retinaface(dets[0], img)
        got = cv2.imread(os.path.join(out, os.path.basename(p).replace(
            '.jpg', '.png')))
        if lm is None:
            ok = got is None
        else:
            found += 1
            face, _ = align_crop_face_landmarks(img, lm, 512)
            ok = got is not None and got.shape == (512, 512, 3) and \
                np.array_equal(got, face)
        if not ok:
            raise SystemExit(f'chip_smoke: crop_align_face\'s crop of '
                             f'{os.path.basename(p)} differs from '
                             f'align_crop_face_landmarks in process')
    print(f'  crop_align_face --landmark-source retinaface --random-init on '
          f'inputs/whole_imgs: {found} of {len(paths)} images with a face, '
          f'{len(os.listdir(out))} crops of 512x512 bit-equal to '
          f'align_crop_face_landmarks in process; {len(paths) / wall:.2f} '
          f'images/s ({wall:.2f} s, main with the detector\'s build) '
          f'[{card_line()}]', flush=True)
    if any(counts.values()) or len(os.listdir(out)) != found:
        raise SystemExit('chip_smoke: crop_align_face wrote the wrong files '
                         'or launched a kernel')


def write_training_pngs(imgs: str) -> None:
    """STAGE2_FILES seeded 512^2 faces as PNGs in `imgs`."""
    import cv2
    os.makedirs(imgs)
    for i, face in enumerate(_faces(np.random.default_rng(16),
                                    STAGE2_FILES)):
        cv2.imwrite(os.path.join(imgs, f'{i:05d}.png'), face)


def latent_gt_files(imgs: str, out: str, ckpt: str) -> tuple:
    """generate_latent_gt --dtype bf16 on `imgs` with the VQGAN `ckpt`:
    K1/K2/K3 on the card with exact launches, the first batch's codes
    equal to `encode` in process. Returns (launches, the .pth)."""
    from codeformer_tpu_torch.cli import generate_latent_gt as glg
    t0 = time.perf_counter()
    counts, _ = run_cli(glg.main, ['-i', imgs, '-o', out, '--ckpt_path',
                                   ckpt, '--dtype', 'bf16'])
    wall = time.perf_counter() - t0
    pth = os.path.join(out, 'latent_gt_code1024.pth')
    encodes = 2 * -(-STAGE2_FILES // LATENT_BATCH)
    want = {k: v * encodes for k, v in ENCODE_LAUNCHES.items()}
    blob = torch.load(pth, weights_only=True)
    model = glg.build_vqgan(None, ckpt, dtype=torch.bfloat16)
    paths = sorted(os.path.join(imgs, n) for n in os.listdir(imgs))
    x = torch.from_numpy(glg.read_images(paths[:LATENT_BATCH], False))
    with torch.no_grad():
        codes = glg.encode(model, x.cuda().permute(0, 3, 1, 2),
                           torch.bfloat16).cpu()
    same = all(torch.equal(blob['orig'][os.path.basename(p)[:-4]], c)
               for p, c in zip(paths, codes))
    print(f'  generate_latent_gt --dtype bf16 on {STAGE2_FILES} seeded 512^2 '
          f'PNGs, --ckpt_path {os.path.relpath(ckpt, os.path.dirname(imgs))}'
          f': {len(blob["orig"])} + {len(blob["hflip"])} code maps; the first '
          f'batch equal to encode in process: {same}; launches {counts} '
          f'(expected {want}); {2 * STAGE2_FILES / wall:.2f} images/s with '
          f'start-up [{card_line()}]', flush=True)
    expect_launches('generate_latent_gt on files', counts, want)
    if not same or len(blob['orig']) != STAGE2_FILES or \
            len(blob['hflip']) != STAGE2_FILES:
        raise SystemExit('chip_smoke: generate_latent_gt on files differs')
    return counts, pth


def tf_paths(exp: str) -> list:
    """--force_yml entries that put an experiment's files under `exp`."""
    return [f'path:experiments_root={exp}', f'path:models={exp}/models',
            f'path:training_states={exp}/training_states',
            f'path:log={exp}', f'path:visualization={exp}/visualization']


def tf_argv(yml: str, exp: str, imgs: str, iters: int, *force) -> list:
    """The training entry point's argv for options/`yml` on the PNGs in
    `imgs`: bf16, `iters` iterations, a log line an iteration, files
    under `exp`, then `force`. The widths, batches and losses stay the
    yml's."""
    return ['-opt', os.path.join(ROOT, 'options', yml), '--force_yml',
            f'datasets:train:dataroot_gt={imgs}', 'mixed_precision=bf16',
            f'train:total_iter={iters}', 'logger:print_freq=1',
            'logger:use_tb_logger=false', *tf_paths(exp), *force]


def tf_subprocess(argv: list, cwd: str, timeout: int = 600,
                  torchrun: bool = False) -> tuple:
    """`python -m codeformer_tpu_torch.train.train argv` (under
    `python -m torch.distributed.run --standalone --nproc_per_node=1`
    with `torchrun`) from `cwd`, the repository on its path. Returns
    (the process, its output, wall s, this process's CPU s meanwhile, the
    child's CPU s)."""
    cmd = [sys.executable, '-m']
    if torchrun:
        cmd += ['torch.distributed.run', '--standalone', '--nproc_per_node=1',
                '-m']
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get('PYTHONPATH')] if p]))
    t0, c0 = time.perf_counter(), os.times()
    proc = subprocess.run(cmd + ['codeformer_tpu_torch.train.train', *argv],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=timeout)
    c1 = os.times()
    return (proc, proc.stdout + proc.stderr, time.perf_counter() - t0,
            c1.user + c1.system - c0.user - c0.system,
            c1.children_user + c1.children_system - c0.children_user
            - c0.children_system)


LOG_LINE = re.compile(r'^(\S+ [\d:]+),(\d+) INFO: \[.*\]\[epoch:\s*(\d+), '
                      r'iter:\s*([\d,]+), lr:\([^)]*\)\] (?:\[eta: [^\]]*\] )?'
                      r'(.*)$')
LOG_TIMES = re.compile(r'time \(data\): ([\d.]+) \(([\d.]+)\)')


def log_iters(text: str) -> dict:
    """{iteration: (epoch, {name: value}, clock s, step s, data wait s)}
    of a training log's iteration lines."""
    out = {}
    for line in text.splitlines():
        m = LOG_LINE.search(line)
        if not m:
            continue
        day_time, ms, epoch, it, rest = m.groups()
        t = LOG_TIMES.search(line)
        out[int(it.replace(',', ''))] = (
            int(epoch), {k: float(v) for k, v in
                         re.findall(r'(\w+): (\S+)', rest)},
            time.mktime(time.strptime(day_time, '%Y-%m-%d %H:%M:%S'))
            + int(ms) / 1e3,
            float(t.group(1)) if t else math.nan,
            float(t.group(2)) if t else math.nan)
    return out


@contextlib.contextmanager
def captured_log():
    """The port's training log, as text, while the block runs in process;
    its console handler quiet meanwhile (the phase prints its own
    lines)."""
    import io
    import logging

    from codeformer_tpu_torch.utils.logger import _FORMAT, get_root_logger
    log = get_root_logger()
    buf = io.StringIO()
    keep = logging.StreamHandler(buf)
    keep.setFormatter(logging.Formatter(_FORMAT))
    quiet = [(h, h.level) for h in log.handlers
             if getattr(h, '_root_console', False)]
    for h, _ in quiet:
        h.setLevel(logging.WARNING)
    log.addHandler(keep)
    try:
        yield buf
    finally:
        log.removeHandler(keep)
        for h, level in quiet:
            h.setLevel(level)


@contextlib.contextmanager
def counting_steps(cls, record: list, probe=None):
    """cls.optimize_parameters recording (iteration, the launches of the
    step, probe(trainer) before, probe(trainer) after) for every step of
    an in-process run."""
    real = cls.optimize_parameters

    def step(self, it):
        p0 = probe(self) if probe else None
        before = launch_counts()
        real(self, it)
        after = launch_counts()
        record.append((it, {k: after[k] - before[k] for k in after}, p0,
                       probe(self) if probe else None))
    with mock.patch.object(cls, 'optimize_parameters', step):
        yield


def expect_launches(label: str, got: dict, want: dict) -> None:
    if got != want:
        raise SystemExit(f'chip_smoke: {label} launched {got}, expected '
                         f'{want}')


def finite_log(label: str, iters: dict, first: int, last: int) -> None:
    """Every iteration first..last logged once with finite values."""
    if sorted(iters) != list(range(first, last + 1)):
        raise SystemExit(f'chip_smoke: {label} logged iterations '
                         f'{sorted(iters)}, expected {first}-{last}')
    bad = [(it, k) for it, (_, vals, *_) in iters.items()
           for k, v in vals.items() if not math.isfinite(v)]
    if bad:
        raise SystemExit(f'chip_smoke: {label}: non-finite log values {bad}')


def in_process_run(cls, label: str, argv: list, root: str, want: dict,
                   probe=None) -> tuple:
    """train_pipeline(root, argv) in this process with every step's
    launches recorded and held to `want`, and its log captured. Returns
    (the trainer, {iteration: log entry}, the step records, wall s, peak
    GiB)."""
    from codeformer_tpu_torch.train.train import train_pipeline
    steps: list = []
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with counting_steps(cls, steps, probe), captured_log() as buf:
        model = train_pipeline(root, argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    for it, got, *_ in steps:
        expect_launches(f'{label} iteration {it}', got, want)
    return model, log_iters(buf.getvalue()), steps, wall, peak


def tf_rate(iters: dict, batch: int, warm: int) -> tuple:
    """(training faces/s over the iterations after `warm` by the log's
    clock, mean step s, mean data wait s there)."""
    its = sorted(iters)
    late = [i for i in its if i > warm]
    if len(late) < 2 or warm not in iters:
        return float('nan'), float('nan'), float('nan')
    span = iters[its[-1]][2] - iters[warm][2]
    return (batch * (its[-1] - warm) / span,
            statistics.mean(iters[i][3] for i in late),
            statistics.mean(iters[i][4] for i in late))


def stage2_from_files(imgs: str, vqgan: str, latent: str, exp: str,
                      label: str, numpy_rate: float, *force) -> None:
    """options/CodeFormer_stage2.yml through the training entry point as a
    subprocess on the PNGs in `imgs`, bf16, its 2 loader workers, with
    `vqgan` as vqgan_path and pretrain_network_vqgan and `latent` as its
    latent_gt_path: exit 0, every iteration logged with finite losses,
    the datasets on the native degradation kernel (its build loads here
    and the subprocess logs no fallback to cv2), training faces/s by the
    log's clock beside the numpy-batch rate and the CPU time of both
    processes."""
    from codeformer_tpu_torch.data import native
    if native.get_lib() is None:
        raise SystemExit(f'chip_smoke: {label}: the native degradation '
                         f'kernel did not build or load')
    argv = tf_argv('CodeFormer_stage2.yml', exp, imgs, STAGE2_ITERS,
                   f'datasets:train:latent_gt_path={latent}',
                   f'network_g:vqgan_path={vqgan}',
                   f'path:pretrain_network_vqgan={vqgan}', *force)
    proc, said, wall, cpu_me, cpu_child = tf_subprocess(argv, ROOT)
    iters = log_iters(said)
    if proc.returncode != 0:
        raise SystemExit(f'chip_smoke: {label} exited {proc.returncode}:\n'
                         f'{said[-3000:]}')
    finite_log(label, iters, 1, STAGE2_ITERS)
    if torch.cuda.get_device_name(0) not in said:
        raise SystemExit(f'chip_smoke: {label} did not name the card')
    if 'native degradation kernel unavailable' in said:
        raise SystemExit(f'chip_smoke: {label}: the datasets fell back to '
                         f'the cv2 degradations')
    rate, step_s, wait_s = tf_rate(iters, 4, STAGE2_WARM)
    print(f'  {label}: python -m codeformer_tpu_torch.train.train -opt '
          f'options/CodeFormer_stage2.yml (bf16, B=4, 2 loader workers, '
          f'{STAGE2_ITERS} iterations): exit 0 in {wall:.1f} s; losses finite '
          f'(iteration {STAGE2_ITERS}: ' + ', '.join(
              f'{k} {v:.4g}' for k, v in iters[STAGE2_ITERS][1].items())
          + f'); training faces/s with the loader {rate:.2f} (iterations '
          f'{STAGE2_WARM + 1}-{STAGE2_ITERS}, the log\'s clock; mean '
          f'{step_s:.3f} s in the step, {wait_s:.3f} s waiting for the '
          f'loader) against {numpy_rate:.2f} on numpy batches (phase_train, '
          f'B=4); CPU s while it ran: this process {cpu_me:.2f}, the '
          f'subprocess {cpu_child:.2f} [{card_line()}]', flush=True)


def phase_files_more() -> dict:
    """The whole-image CLI's classic route, videos through the CLI and
    crop_align_face from files, on the card with seeded random weights;
    one restorer for the CLI runs, as the CLI builds it at its default
    --batch 8. Returns their launches."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix='files_more_')
    made: list = []
    total: dict = {}
    try:
        add_counts(total, files_classic(tmp, made))
        add_counts(total, files_video(tmp, made))
        del made[:]
        torch.cuda.empty_cache()
        files_crop_align(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f'  files phase (classic route, videos, crop_align_face): '
          f'{time.perf_counter() - t0:.1f} s', flush=True)
    return total


# the training stages from files (phase_train_files): stage I and III
# runs, their saves at half the run, stage I's discriminator gate inside
# it; colorization, inpainting and torchrun take a few iterations
TF_ITERS = 12
TF_SAVE = 6
TF_GATE = 6
TF_TASK_ITERS = 4
TF_TASK_GATE = 2          # inpainting's net_d_start_iter inside its run
TF_TORCHRUN_ITERS = 4
# the demo upsamples the image it was given, the whole-image CLI the
# helper's copy with its short side raised to 512 (read_image): the demo
# is given these images raised so, as PNGs, and the two flows agree
TF_DEMO_IMAGES = ('00.jpg', '05.jpg')
# a resumed step against the step of the trainer that saved: bit-equal
# under cudnn.deterministic (max |difference| of every parameter tensor)
RESUME_STEP_BOUND = 0.0


def tf_stage1(tmp: str, imgs: str, vgg: str) -> tuple:
    """Stage I through train_pipeline in process on the PNGs: the
    discriminator gate inside the run, a save at half the run; exact
    launches (one K3 a step), finite losses, l_g_gan 0 before the gate
    and not after it, the discriminator still before it and stepping
    after it; net_g_latest.pth into VQAutoEncoder, whose K3 picks on four
    PNGs are the plain search's. Returns (launches, the experiment)."""
    from codeformer_tpu_torch.cli import generate_latent_gt as glg
    from codeformer_tpu_torch.ops import vq
    from codeformer_tpu_torch.train import trainers
    exp = os.path.join(tmp, 'stage1')

    def d_sum(self):
        return float(torch.cat([p.detach().reshape(-1).double()
                                for p in self.net_d.parameters()]).sum())
    model, iters, steps, wall, peak = in_process_run(
        trainers.VQGANModel, 'stage I from files',
        tf_argv('VQGAN_512_ds32_nearest_stage1.yml', exp, imgs, TF_ITERS,
                f'train:net_d_start_iter={TF_GATE}',
                f'logger:save_checkpoint_freq={TF_SAVE}'),
        tmp, dict(NO_LAUNCHES, nearest_code=1), d_sum)
    finite_log('stage I from files', iters, 1, TF_ITERS)
    d_moved = [(it, a != b) for it, _, a, b in steps]
    gan = [(it, iters[it][1]['l_g_gan']) for it in sorted(iters)]
    gate_ok = all(moved == (it > TF_GATE) for it, moved in d_moved) and \
        all((v == 0) == (it <= TF_GATE) for it, v in gan) and \
        model.step_d == TF_ITERS - TF_GATE and \
        all('l_d_real' in iters[it][1] for it in iters)
    rate, step_s, wait_s = tf_rate(iters, 4, 2)
    names = sorted(os.listdir(os.path.join(exp, 'models')))
    states = sorted(os.listdir(os.path.join(exp, 'training_states')))
    print(f'  stage I (VQGAN_512_ds32_nearest_stage1.yml, bf16, B=4, '
          f'{TF_ITERS} iterations, net_d_start_iter {TF_GATE}, saves every '
          f'{TF_SAVE}) through train_pipeline in process: launches a step '
          f'{steps[0][1]} every step; l_g_gan by iteration '
          + ', '.join(f'{it} {v:.3g}' for it, v in gan)
          + f'; the discriminator moved at iterations '
          f'{[it for it, m in d_moved if m]} ({model.step_d} optimizer_d '
          f'steps; the port logs l_d_* at every iteration, as JAX\'s step '
          f'does, and steps the discriminator only past the gate); files '
          f'{names} + {states}; {wall:.1f} s, training faces/s {rate:.2f} '
          f'after iteration 2 ({step_s:.3f} s a step, {wait_s:.3f} s waiting '
          f'for the loader), peak {peak:.2f} GiB [{card_line()}]',
          flush=True)
    if not gate_ok:
        raise SystemExit('chip_smoke: stage I from files: the discriminator '
                         'gate did not hold')
    for want in ('net_g_6.pth', 'net_g_12.pth', 'net_g_latest.pth',
                 'net_d_latest.pth'):
        if want.replace('6', str(TF_SAVE)).replace(
                '12', str(TF_ITERS)) not in names:
            raise SystemExit(f'chip_smoke: stage I wrote no {want}')
    del model
    gc.collect()
    torch.cuda.empty_cache()
    g = os.path.join(exp, 'models', 'net_g_latest.pth')
    vqgan = glg.build_vqgan(None, g, dtype=torch.bfloat16)
    paths = sorted(os.path.join(imgs, n) for n in os.listdir(imgs))[:4]
    x = torch.from_numpy(glg.read_images(paths, False)).cuda()
    with torch.no_grad():
        z, _ = vqgan.encoder(x.permute(0, 3, 1, 2).to(torch.bfloat16))
        z = z.permute(0, 2, 3, 1).reshape(-1, z.shape[1]).float()
        e = vqgan.quantize.embedding.weight
        got = vq.nearest_code_indices(z, e)
        verdict = k3_verdict(got, vq._nearest_code_ref(z, e), z, e)
    print(f'  net_g_latest.pth into VQAutoEncoder in process: K3 picks of '
          f'{z.shape[0]} latents of four PNGs against the plain search: '
          f'agreement {verdict["agree"]:.6f}, worst relative gap '
          f'{verdict["worst_gap"]:.2e} (<= {K3_MARGIN})', flush=True)
    if not verdict['ok']:
        raise SystemExit('chip_smoke: stage I\'s VQGAN picks are off the '
                         'nearest code')
    del vqgan, x, z
    counts = {k: sum(s[1][k] for s in steps) for k in steps[0][1]}
    return counts, exp


def sft_tamed_copy(src: str, dst: str) -> None:
    """The CodeFormer net_g file `src` with every SFT branch's last convs
    scaled by SFT_SCALE in params and params_ema, as tame_sft scales a
    model, written to `dst`."""
    blob = torch.load(src, map_location='cpu', weights_only=True)
    for sd in blob.values():
        for k in sd:
            if re.fullmatch(r'fuse_convs_dict\.\d+\.(scale|shift)\.2\.weight',
                            k):
                sd[k] = sd[k] * SFT_SCALE
    torch.save(blob, dst)


def tf_stage3(tmp: str, imgs: str, s1: str, g2: str) -> tuple:
    """Stage III through train_pipeline in process from stage II's net_g
    `g2`, stage I's net_d and stage I's VQGAN: exact launches a step (the
    frozen encode), finite losses, the saved net_g's quantize and
    generator bit-equal to what it loaded and every other trainable
    tensor moved. Returns (launches, trainer, its argv, the experiment,
    the batch paths of each iteration)."""
    from codeformer_tpu_torch.train import trainers
    from codeformer_tpu_torch.utils.convert import load_pth
    exp = os.path.join(tmp, 'stage3')
    argv = tf_argv(
        'CodeFormer_stage3.yml', exp, imgs, TF_ITERS,
        f'path:pretrain_network_g={g2}',
        f'path:pretrain_network_d={s1}/models/net_d_latest.pth',
        f'path:pretrain_network_vqgan={s1}/models/net_g_latest.pth',
        f'logger:save_checkpoint_freq={TF_SAVE}',
        # an epoch of 5 iterations, so that a save at 6 lies in epoch 1
        'datasets:train:dataset_enlarge_ratio=1')
    seen: dict = {}
    feed = trainers.BaseTrainer.feed_data

    def recorded(self, data):
        seen[len(seen) + 1] = list(data['gt_path'])
        return feed(self, data)
    with mock.patch.object(trainers.BaseTrainer, 'feed_data', recorded):
        model, iters, steps, wall, peak = in_process_run(
            trainers.CodeFormerJointModel, 'stage III from files', argv, tmp,
            ENCODE_LAUNCHES)
    finite_log('stage III from files', iters, 1, TF_ITERS)
    loaded = load_pth(g2)
    saved = torch.load(os.path.join(exp, 'models', 'net_g_latest.pth'),
                       map_location='cpu', weights_only=True)['params']
    frozen = [k for k in saved if k.split('.')[0] in model.fix_modules]
    trainable = [n for n, p in model.net_g.named_parameters()
                 if p.requires_grad]
    held = all(torch.equal(saved[k], loaded[k]) for k in frozen)
    still = [k for k in trainable if torch.equal(saved[k], loaded[k])]
    rate, step_s, wait_s = tf_rate(iters, 3, 2)
    print(f'  stage III (CodeFormer_stage3.yml, bf16, B=3, {TF_ITERS} '
          f'iterations, saves every {TF_SAVE}) from stage II\'s net_g, stage '
          f'I\'s net_d and VQGAN, through train_pipeline in process: '
          f'launches {steps[0][1]} every step; losses finite (iteration '
          f'{TF_ITERS}: ' + ', '.join(f'{k} {v:.4g}' for k, v in
                                      iters[TF_ITERS][1].items())
          + f'); {len(frozen)} tensors of {sorted(model.fix_modules)} in '
          f'net_g_latest.pth bit-equal to stage II\'s: {held}; trainable '
          f'tensors moved: {len(trainable) - len(still)} of '
          f'{len(trainable)}; {wall:.1f} s, training faces/s {rate:.2f} '
          f'after iteration 2 ({step_s:.3f} s a step, {wait_s:.3f} s waiting '
          f'for the loader), peak {peak:.2f} GiB [{card_line()}]',
          flush=True)
    if not held or still or not frozen:
        raise SystemExit(f'chip_smoke: stage III from files: frozen modules '
                         f'changed or trainable tensors did not move '
                         f'({still[:5]})')
    counts = {k: sum(s[1][k] for s in steps) for k in steps[0][1]}
    return counts, model, argv, exp, seen


def trainer_state(t) -> dict:
    """Every tensor and counter a resumed trainer must restore: net_g,
    its EMA, net_d (BatchNorm statistics included), both optimizers'
    states, step and step_d."""
    def flat(prefix, tree, out):
        if isinstance(tree, dict):
            for k, v in tree.items():
                flat(f'{prefix}.{k}', v, out)
        elif isinstance(tree, (list, tuple)):
            for i, v in enumerate(tree):
                flat(f'{prefix}.{i}', v, out)
        else:
            out[prefix] = tree
        return out
    st = {}
    flat('net_g', t.net_g.state_dict(), st)
    flat('params_ema', t.params_ema, st)
    flat('net_d', t.net_d.state_dict(), st)
    flat('optimizer_g', t.optimizer.state_dict(), st)
    flat('optimizer_d', t.optimizer_d.state_dict(), st)
    st['step'], st['step_d'] = t.step, t.step_d
    return st


def state_diff(a: dict, b: dict) -> list:
    """The entries of two trainer_state dicts that are not bit-equal."""
    out = [k for k in sorted(set(a) ^ set(b))]
    for k in sorted(set(a) & set(b)):
        x, y = a[k], b[k]
        same = (torch.equal(x.cpu(), y.cpu()) if torch.is_tensor(x)
                and torch.is_tensor(y) else x == y)
        if not same:
            out.append(k)
    return out


def param_diff(a, b) -> float:
    """max |difference| over the parameters and buffers of two trainers'
    net_g and net_d."""
    worst = 0.0
    for net in ('net_g', 'net_d'):
        for (k, x), y in zip(getattr(a, net).state_dict().items(),
                             getattr(b, net).state_dict().values()):
            if x.is_floating_point():
                worst = max(worst, float((x.double() - y.double()).abs()
                                         .max()))
            elif not torch.equal(x, y):
                worst = math.inf
    return worst


def tf_resume(model, argv: list, root: str, exp: str, seen: dict,
              vgg: str) -> None:
    """Resume on the card. (i) In process: a fresh trainer of stage III's
    options resumes from training_states/<TF_ITERS>.state; its net_g, EMA,
    net_d, both optimizers' states, step and step_d bit-equal to the
    trainer that saved them; then one step of each on the same batch under
    cudnn.deterministic, parameters within RESUME_STEP_BOUND; a planted
    fault (one Adam moment of the fresh trainer zeroed, as if not
    restored) must fail both checks. (ii) The same command as a
    subprocess from training_states/<TF_SAVE>.state: exit 0, the log
    resuming at iteration TF_SAVE and showing iterations TF_SAVE+1 to
    TF_ITERS only, in the saved epoch; the loader built for that epoch
    gives the batch the saving run took first in it."""
    from codeformer_tpu_torch.train import train as tt
    from codeformer_tpu_torch.train.trainers import build_model
    from codeformer_tpu_torch.utils.logger import get_root_logger
    t0 = time.perf_counter()
    opt = tt.parse_options(root, argv)
    with captured_log():
        fresh = build_model(opt)
    epoch, it = fresh.resume_training(os.path.join(
        exp, 'training_states', f'{TF_ITERS}.state'))
    diff = state_diff(trainer_state(model), trainer_state(fresh))
    key = next(iter(fresh.optimizer.state))
    moment = fresh.optimizer.state[key]['exp_avg']
    kept = moment.clone()
    moment.zero_()
    planted = state_diff(trainer_state(model), trainer_state(fresh))
    moment.copy_(kept)
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        batch = dict(model.batch)
        fresh.batch = batch
        model.optimize_parameters(it + 1)
        fresh.optimize_parameters(it + 1)
        step_err = param_diff(model, fresh)
        fresh.optimizer.state[key]['exp_avg'].zero_()
        model.optimize_parameters(it + 2)
        fresh.optimize_parameters(it + 2)
        fault_err = param_diff(model, fresh)
    finally:
        torch.backends.cudnn.deterministic = det
    print(f'  resume in process: a fresh stage-III trainer from '
          f'training_states/{TF_ITERS}.state (epoch {epoch}, iteration '
          f'{it}): {len(trainer_state(fresh))} tensors and counters of net_g, '
          f'params_ema, net_d, both optimizers, step and step_d; differing '
          f'from the saving trainer: {diff or "none"}; one more step of each '
          f'on the same batch (cudnn.deterministic): max |difference| '
          f'{step_err:.3g} (<= {RESUME_STEP_BOUND}); planted fault (one '
          f'exp_avg not restored): the state check finds {planted}, the step '
          f'after it max |difference| {fault_err:.3g}', flush=True)
    if diff or step_err > RESUME_STEP_BOUND:
        raise SystemExit('chip_smoke: the resumed trainer differs from the '
                         'one that saved')
    if not planted or fault_err <= RESUME_STEP_BOUND:
        raise SystemExit('chip_smoke: the planted resume fault passed')
    del fresh, model, batch
    gc.collect()
    torch.cuda.empty_cache()
    # (ii) the documented resume command as a subprocess
    state = os.path.join(exp, 'training_states', f'{TF_SAVE}.state')
    proc, said, wall, _, _ = tf_subprocess(
        argv + [f'path:resume_state={state}'], vgg)
    iters = log_iters(said)
    saved_epoch = (TF_SAVE - 1) // (STAGE2_FILES // 3)
    resumed = f'resuming from epoch {saved_epoch}, iter {TF_SAVE}' in said
    epochs = {it: iters[it][0] for it in sorted(iters)}
    if proc.returncode != 0:
        raise SystemExit(f'chip_smoke: the resumed run exited '
                         f'{proc.returncode}:\n{said[-3000:]}')
    finite_log('the resumed stage III run', iters, TF_SAVE + 1, TF_ITERS)
    from codeformer_tpu_torch.train.train import create_train_val_dataloader
    opt = tt.parse_options(root, argv + [f'path:resume_state={state}'])
    with captured_log():
        loader, _, _ = create_train_val_dataloader(opt, get_root_logger(),
                                                   saved_epoch)
    first = list(next(iter(loader))['gt_path'])
    del loader
    in_epoch = [i for i in sorted(seen)
                if (i - 1) // (STAGE2_FILES // 3) == saved_epoch]
    print(f'  resume as a subprocess: the same command with '
          f'path:resume_state=.../{TF_SAVE}.state: exit 0 in {wall:.1f} s; '
          f'the log says "resuming from epoch {saved_epoch}, iter '
          f'{TF_SAVE}": {resumed}; iterations logged {sorted(iters)} in '
          f'epochs {sorted(set(epochs.values()))}; the loader of epoch '
          f'{saved_epoch} gives first the batch iteration {in_epoch[0]} took '
          f'in the saving run: {first == seen[in_epoch[0]]}; resume checks '
          f'{time.perf_counter() - t0:.1f} s [{card_line()}]', flush=True)
    if not resumed or epochs[TF_SAVE + 1] != saved_epoch or \
            first != seen[in_epoch[0]]:
        raise SystemExit('chip_smoke: the resumed run did not start at the '
                         'saved iteration and epoch')


def colorization_contract(argv: list, root: str) -> str:
    """One loader batch of the colorization yml's dataset (seeded), each
    sample against the same sample with the colour augments off: equal,
    shifted by one jitter of at most color_jitter_shift a channel, or
    gray; and one sample each with the jitter and the gray augment
    forced, which must read as such."""
    from codeformer_tpu_torch.data import build_dataset
    from codeformer_tpu_torch.data.loader import build_dataloader
    from codeformer_tpu_torch.train import train as tt
    opt = tt.parse_options(root, argv)['datasets']['train']
    opt = dict(opt, phase='train', seed=5)
    shift = opt.get('color_jitter_shift', 20) + 1.0    # levels, rounding

    def kind(x, plain):
        a, p = x * 127.5 + 127.5, plain * 127.5 + 127.5
        if np.abs(a[..., :1] - a).max() < 0.01 and \
                np.abs(p[..., :1] - p).max() > 1:
            return 'gray'
        d = a - p
        inside = (a > 0.5) & (a < 254.5) & (p > 0.5) & (p < 254.5)
        if np.abs(d).max() < 0.01:
            return 'plain'
        med = np.array([np.median(d[..., c][inside[..., c]])
                        for c in range(3)])
        if np.all(np.abs(med) <= shift) and \
                np.abs(d - med)[inside].max() <= 1.01:
            return 'jitter'
        return 'neither'
    plain = build_dataset(dict(opt, color_jitter_prob=None, gray_prob=0.0))
    loader = build_dataloader(build_dataset(opt), dict(
        opt, num_worker_per_gpu=2))
    batch = next(iter(loader))
    del loader
    index = {p: i for i, p in enumerate(plain.paths)}
    kinds = [kind(x, plain[index[p]]['in'])
             for x, p in zip(batch['in'], batch['gt_path'])]
    forced = {}
    for name, over in (('jitter', dict(color_jitter_prob=1.0, gray_prob=0.0)),
                       ('gray', dict(color_jitter_prob=None, gray_prob=1.0))):
        ds, base = build_dataset(dict(opt, **over)), \
            build_dataset(dict(opt, color_jitter_prob=None, gray_prob=0.0))
        forced[name] = kind(ds[0]['in'], base[0]['in'])
    if 'neither' in kinds or forced != {'jitter': 'jitter', 'gray': 'gray'}:
        raise SystemExit(f'chip_smoke: colorization inputs off their '
                         f'contract: {kinds}, forced {forced}')
    return f'batch {kinds}, forced {forced}'


def inpainting_contract(argv: list, root: str) -> str:
    """One loader batch of the inpainting yml's dataset: every pixel of
    'in' is the ground truth's (within a level) or a brush stroke's white,
    and each sample has strokes (data/masks.py)."""
    from codeformer_tpu_torch.data import build_dataset
    from codeformer_tpu_torch.data.loader import build_dataloader
    from codeformer_tpu_torch.train import train as tt
    opt = dict(tt.parse_options(root, argv)['datasets']['train'],
               phase='train', seed=6)
    loader = build_dataloader(build_dataset(opt), opt)
    batch = next(iter(loader))
    del loader
    shares = []
    for x, gt in zip(batch['in'], batch['gt']):
        a, g = x * 127.5 + 127.5, gt * 127.5 + 127.5
        white = np.all(a > 254.5, axis=-1)
        kept = np.all(np.abs(a - g) <= 1.01, axis=-1)
        if not np.all(white | kept):
            raise SystemExit('chip_smoke: an inpainting input pixel is '
                             'neither the ground truth nor a stroke')
        shares.append(float((white & ~kept).mean()))
    if min(shares) <= 0:
        raise SystemExit('chip_smoke: an inpainting sample has no stroke')
    return 'stroke shares ' + ', '.join(f'{s:.3f}' for s in shares)


def tf_tasks(tmp: str, imgs: str, s1: str, latent: str) -> dict:
    """Colorization (stage I's VQGAN, the latent codes of step 2) and
    inpainting (codebook 512, brush masks, the discriminator gate inside
    the run) through train_pipeline in process: exact launches, finite
    losses; one loader batch of each against its dataset's contract."""
    from codeformer_tpu_torch.train import trainers
    g1 = f'{s1}/models/net_g_latest.pth'
    total: dict = {}
    runs = (
        ('colorization', 'CodeFormer_colorization.yml',
         trainers.CodeFormerIdxModel, NO_LAUNCHES,
         (f'network_g:vqgan_path={g1}', f'path:pretrain_network_vqgan={g1}',
          f'datasets:train:latent_gt_path={latent}'), colorization_contract),
        ('inpainting', 'CodeFormer_inpainting.yml', trainers.CodeFormerModel,
         ENCODE_LAUNCHES, (f'train:net_d_start_iter={TF_TASK_GATE}',),
         inpainting_contract))
    for label, yml, cls, want, force, contract in runs:
        argv = tf_argv(yml, os.path.join(tmp, label), imgs, TF_TASK_ITERS,
                       *force)
        model, iters, steps, wall, peak = in_process_run(
            cls, f'{label} from files', argv, tmp, want)
        finite_log(f'{label} from files', iters, 1, TF_TASK_ITERS)
        step_d = getattr(model, 'step_d', 0)
        del model
        gc.collect()
        torch.cuda.empty_cache()
        said = contract(argv, tmp)
        print(f'  {label} ({yml}, bf16, {TF_TASK_ITERS} iterations) through '
              f'train_pipeline in process: launches {steps[0][1]} every step; '
              f'losses finite (iteration {TF_TASK_ITERS}: ' + ', '.join(
                  f'{k} {v:.4g}' for k, v in iters[TF_TASK_ITERS][1].items())
              + f'); optimizer_d steps {step_d}; a loader batch against the '
              f'dataset\'s contract: {said}; {wall:.1f} s, peak {peak:.2f} '
              f'GiB [{card_line()}]', flush=True)
        if label == 'inpainting' and step_d != TF_TASK_ITERS - TF_TASK_GATE:
            raise SystemExit('chip_smoke: inpainting\'s discriminator gate '
                             'did not hold')
        for s in steps:
            add_counts(total, s[1])
    return total


def tf_torchrun(tmp: str, imgs: str, s1: str, latent: str) -> None:
    """Stage II under `python -m torch.distributed.run --standalone
    --nproc_per_node=1 ... --launcher pytorch`: exit 0, the log naming
    the NCCL backend and world size 1, finite losses."""
    exp = os.path.join(tmp, 'torchrun')
    g1 = f'{s1}/models/net_g_latest.pth'
    argv = tf_argv('CodeFormer_stage2.yml', exp, imgs, TF_TORCHRUN_ITERS,
                   f'datasets:train:latent_gt_path={latent}',
                   f'network_g:vqgan_path={g1}',
                   f'path:pretrain_network_vqgan={g1}') + ['--launcher',
                                                          'pytorch']
    proc, said, wall, _, _ = tf_subprocess(argv, ROOT, torchrun=True)
    iters = log_iters(said)
    named = re.search(r'data parallel: rank 0 of 1 \(nccl\)', said)
    if proc.returncode != 0:
        raise SystemExit(f'chip_smoke: stage II under torchrun exited '
                         f'{proc.returncode}:\n{said[-3000:]}')
    finite_log('stage II under torchrun', iters, 1, TF_TORCHRUN_ITERS)
    print(f'  python -m torch.distributed.run --standalone '
          f'--nproc_per_node=1 -m codeformer_tpu_torch.train.train -opt '
          f'options/CodeFormer_stage2.yml --launcher pytorch ({TF_TORCHRUN_ITERS} '
          f'iterations): exit 0 in {wall:.1f} s; the log names "'
          f'{named.group(0) if named else "no process group"}"; losses '
          f'finite (iteration {TF_TORCHRUN_ITERS}: ' + ', '.join(
              f'{k} {v:.4g}' for k, v in iters[TF_TORCHRUN_ITERS][1].items())
          + f') [{card_line()}]', flush=True)
    if not named:
        raise SystemExit(f'chip_smoke: stage II under torchrun did not start '
                         f'an NCCL group of one')


def tf_serve(tmp: str, net_g: str) -> dict:
    """The aligned CLI's main with --has_aligned --checkpoint <stage III's
    net_g_latest.pth> on inputs/cropped_faces: its faces bit-equal to
    restore_batch of a restorer built in process from the same file,
    exact K1/K2 launches."""
    import glob

    import cv2

    from codeformer_tpu_torch import pipeline
    from codeformer_tpu_torch.cli import inference_codeformer as icf
    from codeformer_tpu_torch.pipeline.restorer import CodeFormerRestorer
    from codeformer_tpu_torch.utils import img_util
    made = []

    class Recorded(CodeFormerRestorer):
        def __init__(self, **kw):
            super().__init__(**kw)
            made.append((self, kw))
    faces_dir = os.path.join(ROOT, CLI_FACES)
    paths = sorted(glob.glob(os.path.join(faces_dir, '*.png')))
    out = os.path.join(tmp, 'served')
    t0 = time.perf_counter()
    with mock.patch.object(pipeline, 'CodeFormerRestorer', Recorded):
        counts, _ = run_cli(icf.main, ['--has_aligned', '-i', faces_dir,
                                       '-o', out, '--checkpoint', net_g])
    wall = time.perf_counter() - t0
    r, kw = made[0]
    want = restorer_launches(r, len(paths), fuse=True)
    expect_launches('the aligned CLI on stage III\'s checkpoint', counts,
                    want)
    ref = CodeFormerRestorer(**kw)
    faces = [cv2.resize(cv2.imread(p, cv2.IMREAD_COLOR), (512, 512),
                        interpolation=cv2.INTER_LINEAR) for p in paths]
    restored = ref.restore_batch(faces, w=0.5, adain=True)
    for p, face, o in zip(paths, faces, restored):
        if img_util.is_gray(face, threshold=10):
            o = img_util.adain_color_transfer(img_util.bgr2gray3(o), face)
        got = cv2.imread(os.path.join(out, 'restored_faces',
                                      os.path.basename(p)))
        if got is None or not np.array_equal(got, o):
            raise SystemExit(f'chip_smoke: the aligned CLI on stage III\'s '
                             f'checkpoint: {os.path.basename(p)} differs '
                             f'from restore_batch in process')
    print(f'  the aligned CLI --has_aligned --checkpoint <stage III '
          f'net_g_latest.pth> on {len(paths)} faces: restored_faces bit-equal '
          f'to restore_batch of a restorer loaded in process from the same '
          f'file; launches {counts} (expected {want}); {len(paths) / wall:.2f} '
          f'images/s with start-up [{card_line()}]', flush=True)
    return counts


def tf_demos(tmp: str) -> dict:
    """The web demos on the card with CODEFORMER_RANDOM_INIT=1:
    hugging_face.inference on TF_DEMO_IMAGES (their short side raised to
    512) with background_enhance and face_upsample off, then on; each
    image it returns bit-equal to the
    whole-image CLI's classic route run in process with the same
    restorer, helper and upsampler; exact K1/K2 launches; replicate.predict
    writes what inference returns."""
    import cv2

    from codeformer_tpu_torch import pipeline
    from codeformer_tpu_torch.cli import inference_codeformer as icf
    from codeformer_tpu_torch.demos import hugging_face as hf
    from codeformer_tpu_torch.demos import replicate
    from codeformer_tpu_torch.pipeline import face_helper as pfh
    from codeformer_tpu_torch.pipeline import realesrgan as pesr
    helpers, ups = [], []
    real_helper, real_up = hf.FaceRestoreHelper, pesr.set_realesrgan

    def helper(*a, **kw):
        helpers.append(real_helper(*a, **kw))
        return helpers[-1]

    def upsampler(**kw):
        ups.append(real_up(**kw))
        return ups[-1]
    total: dict = {}
    whole = os.path.join(ROOT, 'inputs', 'whole_imgs')
    t0 = time.perf_counter()
    lines, faces_seen = [], 0
    with mock.patch.dict(os.environ, CODEFORMER_RANDOM_INIT='1'), \
            mock.patch.object(hf, 'FaceRestoreHelper', helper), \
            mock.patch.object(pesr, 'set_realesrgan', upsampler):
        for on in (False, True):
            for name in TF_DEMO_IMAGES:
                src = os.path.join(tmp, f'demo_in_{name[:2]}')
                path = os.path.join(src, name[:-4] + '.png')
                if not os.path.exists(path):
                    img = cv2.imread(os.path.join(whole, name))
                    f = 512.0 / min(img.shape[:2])
                    os.makedirs(src)
                    cv2.imwrite(path, cv2.resize(
                        img, (0, 0), fx=f, fy=f,
                        interpolation=cv2.INTER_LINEAR))
                reset_launch_counts()
                for u in ups:
                    u.reset_tile_counts()
                got = hf.inference(path, on, on, 2, 0.5)
                torch.cuda.synchronize()
                counts = launch_counts()
                r, h = hf.get_restorer(), helpers[-1]
                n_faces = len(h.cropped_faces)
                faces_seen += n_faces
                want = dict(restorer_launches(r, n_faces, fuse=True),
                            conv3x3_dense=dense_launches(ups))
                expect_launches(f'hugging_face.inference on {name}', counts,
                                want)
                add_counts(total, counts)
                up = ups[-1] if on else None
                res = os.path.join(tmp, f'demo_out_{name[:2]}_{int(on)}')
                flags = ['--bg_upsampler', 'realesrgan', '--face_upsample'] \
                    if on else []
                with mock.patch.object(pipeline, 'CodeFormerRestorer',
                                       lambda **kw: r), \
                        mock.patch.object(pfh, 'FaceRestoreHelper',
                                          lambda *a, **kw: h), \
                        mock.patch.object(pesr, 'set_realesrgan',
                                          lambda **kw: up):
                    cli_counts, _ = run_cli(icf.main, [
                        '-i', src, '-o', res, '-s', '2', '-w', '0.5',
                        '--fused_pipeline', 'off', '--random-init',
                        *flags])
                add_counts(total, cli_counts)
                ref = cv2.imread(os.path.join(res, 'final_results',
                                              name[:-4] + '.png'))
                same = ref is not None and np.array_equal(got, ref)
                lines.append(f'{name} {"on" if on else "off"}: '
                             f'{n_faces} faces, {got.shape[1]}x'
                             f'{got.shape[0]}, bit-equal {same}')
                if not same:
                    raise SystemExit(f'chip_smoke: hugging_face.inference on '
                                     f'{name} ({"on" if on else "off"}) '
                                     f'differs from the classic route')
                if on and name == TF_DEMO_IMAGES[0]:
                    out = os.path.join(tmp, 'replicate.png')
                    reset_launch_counts()
                    wrote = replicate.predict(path, 0.5, on, on, 2, out)
                    add_counts(total, launch_counts())
                    if not np.array_equal(cv2.imread(wrote), got):
                        raise SystemExit('chip_smoke: replicate.predict wrote '
                                         'another image than inference')
    hf._restorers.clear()
    if not faces_seen:
        raise SystemExit('chip_smoke: the web demos restored no face')
    print(f'  web demos (CODEFORMER_RANDOM_INIT=1): hugging_face.inference '
          f'with background_enhance and face_upsample off / on, against the '
          f'whole-image CLI\'s classic route with the same restorer, helper '
          f'and upsampler: ' + '; '.join(lines) + f'; launches exact; '
          f'replicate.predict wrote the image inference returns; '
          f'{time.perf_counter() - t0:.1f} s [{card_line()}]', flush=True)
    return total


def phase_train_files(numpy_rate: float) -> dict:
    """The three training stages from 16 seeded 512^2 PNGs on the card,
    each from the files the stage before it wrote, at the ymls' widths
    and batches in bf16: stage I (train_pipeline in process) ->
    generate_latent_gt with its net_g -> stage II (a subprocess; the late
    reading of the loader's data wait) -> stage III from stage II's net_g
    and stage I's net_d and VQGAN -> resume (in process and as a
    subprocess) -> colorization and inpainting -> stage II under torchrun
    -> the aligned CLI serving stage III's net_g -> the web demos. LPIPS
    reads seeded stand-ins written into a temporary working directory.
    Returns the launches of the in-process runs."""
    import shutil
    import tempfile
    t0 = time.perf_counter()
    total: dict = {}
    tmp = tempfile.mkdtemp(prefix='train_files_')
    clock = {}

    def lap(name, since):
        clock[name] = time.perf_counter() - since
        return time.perf_counter()
    try:
        imgs = os.path.join(tmp, 'ffhq')
        write_training_pngs(imgs)
        with vgg_standins() as vgg:
            t = time.perf_counter()
            counts, s1 = tf_stage1(tmp, imgs, vgg)
            add_counts(total, counts)
            t = lap('stage I', t)
            g1 = os.path.join(s1, 'models', 'net_g_latest.pth')
            counts, latent = latent_gt_files(imgs, os.path.join(tmp, 'lat'),
                                             g1)
            add_counts(total, counts)
            t = lap('generate_latent_gt', t)
            s2 = os.path.join(tmp, 'stage2')
            stage2_from_files(
                imgs, g1, latent, s2, 'stage II from files, late in the run',
                numpy_rate, f'logger:save_checkpoint_freq={STAGE2_ITERS}')
            if f'net_g_{STAGE2_ITERS}.pth' not in os.listdir(
                    os.path.join(s2, 'models')):
                raise SystemExit('chip_smoke: stage II saved no net_g at its '
                                 'last iteration')
            # stage II trains no SFT branch (w = 0): at their random init
            # they take the generator's activations to 1e23, the tail
            # GroupNorm's sums overflow, the image is constant and stage
            # III's gradients never reach them; tamed as every serving
            # phase tames them
            g2 = os.path.join(s2, 'models', 'net_g_latest_sft_tamed.pth')
            sft_tamed_copy(os.path.join(s2, 'models', 'net_g_latest.pth'),
                           g2)
            print(f'  stage III starts from stage II\'s net_g_latest.pth with '
                  f'its SFT branches\' last convs scaled by {SFT_SCALE} '
                  f'(tame_sft), written as {os.path.basename(g2)}',
                  flush=True)
            t = lap('stage II', t)
            counts, model, argv, s3, seen = tf_stage3(tmp, imgs, s1, g2)
            add_counts(total, counts)
            t = lap('stage III', t)
            tf_resume(model, argv, tmp, s3, seen, vgg)
            del model
            t = lap('resume', t)
            add_counts(total, tf_tasks(tmp, imgs, s1, latent))
            t = lap('colorization and inpainting', t)
        tf_torchrun(tmp, imgs, s1, latent)
        t = lap('torchrun', t)
        add_counts(total, tf_serve(tmp, os.path.join(
            s3, 'models', 'net_g_latest.pth')))
        t = lap('serving', t)
        add_counts(total, tf_demos(tmp))
        lap('web demos', t)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    print(f'  training-from-files phase: {time.perf_counter() - t0:.1f} s ('
          + ', '.join(f'{k} {v:.1f}' for k, v in clock.items()) + ')',
          flush=True)
    return total


KERNEL_SOURCES = {  # name: (source, the TPU kernel it replaces)
    'conv3x3_dense': ('codeformer_tpu_torch/csrc/conv3x3_dense.cu',
                      'none: the JAX package runs RRDBNet on XLA convs'),
    'channel_stats': ('codeformer_tpu_torch/csrc/channel_stats.cu',
                      'none: the JAX package leaves colpack_stats '
                      '(codeformer_tpu/ops/colpack_conv.py:197) to XLA'),
    'conv3x3_dots': ('codeformer_tpu_torch/csrc/conv3x3_dots.cu',
                     'codeformer_tpu/ops/colpack_conv.py:376'),
    'downsample_dots': ('codeformer_tpu_torch/csrc/downsample_dots.cu',
                        'codeformer_tpu/ops/colpack_conv.py:586'),
    'nearest_code': ('codeformer_tpu_torch/csrc/nearest_code.cu',
                     'codeformer_tpu/ops/vq.py:40'),
    'fused_lrelu_fwd': ('codeformer_tpu_torch/csrc/fused_act.cu',
                        'codeformer_tpu/ops/fused_act.py:37'),
    'fused_lrelu_bwd': ('codeformer_tpu_torch/csrc/fused_act.cu',
                        'codeformer_tpu/ops/fused_act.py:66'),
    'conv3x3_bias': ('codeformer_tpu_torch/csrc/conv3x3_bias.cu',
                     'codeformer_tpu/ops/colpack_conv.py:137; '
                     'codeformer_tpu/ops/pallas_conv.py:101; '
                     'codeformer_tpu/ops/imgpair_conv.py:117 (:158)'),
}


def main():
    phase_card()
    sys.path.insert(0, ROOT)
    phase_build()
    results = phase_kernels()
    results['channel_stats'] = phase_stats()
    k3_rows, k3_calls = phase_k3()
    k4_rows, conv_rows, ops_counts = phase_ops()
    dense_rows = phase_rrdb_dense()
    serve_counts, restorer = phase_slice()
    if '--profile' in sys.argv[1:]:
        phase_profile(restorer)
    fp32_counts = phase_fp32()
    int8_counts = phase_int8(restorer)
    multi_counts = phase_multi_device(restorer)
    whole_counts = phase_whole_image(restorer,
                                     profile='--profile' in sys.argv[1:])
    classic_counts = phase_classic(restorer)
    upsampler = phase_realesrgan()
    upsample_counts = phase_classic_upsample(restorer, upsampler)
    del restorer, upsampler
    torch.cuda.empty_cache()
    phase_yolo()
    phase_bisenet()
    task_counts = phase_tasks()
    vq_counts, vq_probe = phase_vqgan()
    vqcli_counts = phase_vqgan_cli()
    train_counts, trainer, train_rate = phase_train()
    if '--profile' in sys.argv[1:]:
        phase_train_profile(trainer)
    phase_validation(trainer)
    phase_prefetcher(trainer)
    del trainer
    torch.cuda.empty_cache()
    stage1_counts = phase_stage1()
    phase_stage1_cpu_check()
    stage3_counts = phase_stage3()
    remat_counts = phase_remat()
    latent_counts, _ = phase_latent_gt()
    dp_counts = phase_dp()
    phase_srmodel()
    phase_arcface()
    cli_counts = phase_cli_files()
    files_counts = phase_files_more()
    train_files_counts = phase_train_files(train_rate)
    print(f'main-path launches: serving {serve_counts}; whole-image path '
          f'{whole_counts}; classic path {classic_counts}; classic path with '
          f'the upsamplers {upsample_counts}; colorization and inpainting '
          f'{task_counts}; VQAutoEncoder {vq_counts}; stage-II training '
          f'{train_counts}; stage-I training {stage1_counts}; stage-III '
          f'training {stage3_counts}; remat steps {remat_counts}; '
          f'generate_latent_gt {latent_counts}; data-parallel steps '
          f'{dp_counts}; ops path {ops_counts}; fp32 serving {fp32_counts}; '
          f'int8 serving {int8_counts}; multi-device serving '
          f'{multi_counts}; inference_vqgan {vqcli_counts}; the CLIs on '
          f'files {cli_counts}; the classic route, videos and crop_align_face '
          f'from files {files_counts}; the training stages from files, '
          f'serving their checkpoint and the web demos {train_files_counts}; '
          f'the whole run {time.perf_counter() - T_START:.1f} s')
    phase_k3_activities(k3_calls)
    vqgan_activities(vq_probe)
    del k3_calls, vq_probe
    # head row of each kernel: K1/K2 the 512^2 shape, K3 the path's T,
    # K4 and the bare conv the ops path's shape
    results['nearest_code'] = [r for r in k3_rows
                               if r['tokens'] == K3_PATH_TOKENS] + k3_rows
    results['fused_lrelu_fwd'] = [
        dict(r, library_ms=None, **r['fwd_bound']) for r in k4_rows]
    results['fused_lrelu_bwd'] = [
        dict(r, max_abs_err=r['bwd_max_abs_err'], ms=r['bwd_ms'],
             plain_ms=r['bwd_plain_ms'], library_ms=None, **r['bwd_bound'])
        for r in k4_rows]
    results['conv3x3_bias'] = conv_rows
    results['conv3x3_dense'] = dense_rows
    kernels = []
    for name, rows in results.items():
        head = rows[0]
        kernels.append({
            'name': name, 'route': 'cuda', 'source': KERNEL_SOURCES[name][0],
            'replaces': KERNEL_SOURCES[name][1],
            'launches': sum(c.get(name, 0) for c in
                            (serve_counts, whole_counts, classic_counts,
                             upsample_counts, task_counts, vq_counts,
                             train_counts, stage1_counts, stage3_counts,
                             remat_counts, latent_counts, dp_counts,
                             ops_counts, fp32_counts, int8_counts,
                             multi_counts, vqcli_counts, cli_counts,
                             files_counts, train_files_counts)),
            'max_abs_err': max(r['max_abs_err'] for r in rows),
            'ms': head['ms'], 'plain_ms': head['plain_ms'],
            'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
            'library_ms': head['library_ms']})
    print('call_ms (the whole public call; ms above is the launch on '
          'prepared operands): ' + '; '.join(
              f'{name} {rows[0]["call_ms"]:.4f} (launch {rows[0]["ms"]:.4f})'
              for name, rows in results.items() if 'call_ms' in rows[0]))
    if not all(k['launches'] > 0 for k in kernels):
        raise SystemExit('chip_smoke: a kernel of the path never launched')
    if not all(c['nearest_code'] > 0 for c in (
            train_counts, vq_counts, stage1_counts, stage3_counts,
            remat_counts, latent_counts, dp_counts, vqcli_counts,
            cli_counts, train_files_counts)) \
            or not all(c[k] > 0 for c in (serve_counts, whole_counts,
                                          classic_counts, upsample_counts,
                                          task_counts, vq_counts,
                                          stage3_counts, remat_counts,
                                          latent_counts, dp_counts,
                                          multi_counts, vqcli_counts,
                                          cli_counts, files_counts,
                                          train_files_counts)
                       for k in ('conv3x3_dots', 'downsample_dots',
                                 'channel_stats')) \
            or not all(ops_counts[k] > 0 for k in (
                'conv3x3_bias', 'fused_lrelu_fwd', 'fused_lrelu_bwd')):
        raise SystemExit('chip_smoke: a kernel never launched on its path')
    print(card_line())
    print(json.dumps({'kernels': kernels}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    main()
