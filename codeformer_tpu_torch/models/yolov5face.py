"""YOLOv5-face detector (yolov5n and yolov5l), counterpart of
codeformer_tpu/models/yolov5face.py (the reference's
facelib/detection/yolov5face/models/{yolo.py,common.py}): a graph built
from a config of [from, number, module, args] rows, with StemBlock,
ShuffleV2Block, C3, SPP and Conv blocks, and a Detect head of 16 outputs
an anchor (box 4, objectness 1, 10 landmark coordinates, class 1).

NCHW. Module names are the reference `.pth` names (`model.3.cv1.conv.
weight`, `model.{i}.{j}` for repeated ShuffleV2 blocks, `model.{i}.m.{k}`
for the Detect convs), so yolov5{n,l}-face.pth and `flax_to_state_dict`
of the JAX variables (with `like=`) load strictly. BatchNorm runs from
its running statistics, eps 1e-3 in Conv blocks and 1e-5 in the
ShuffleV2 branches, as in the JAX package. The convs are cuDNN's.
"""
from __future__ import annotations

from typing import List

import torch
import torch.nn as nn
import torch.nn.functional as F

from codeformer_tpu_torch.utils.registry import ARCH_REGISTRY

ANCHORS = ((4, 5, 8, 10, 13, 16),
           (23, 29, 43, 55, 73, 105),
           (146, 217, 231, 300, 335, 433))

# [from, number, module, args]: the graphs of the two shipped variants
# (facelib/detection/yolov5face/models/yolov5{n,l}.yaml)
YOLO5N_CFG = dict(
    nc=1,
    backbone=[
        [-1, 1, 'StemBlock', [32, 3, 2]],
        [-1, 1, 'ShuffleV2Block', [128, 2]],
        [-1, 3, 'ShuffleV2Block', [128, 1]],
        [-1, 1, 'ShuffleV2Block', [256, 2]],
        [-1, 7, 'ShuffleV2Block', [256, 1]],
        [-1, 1, 'ShuffleV2Block', [512, 2]],
        [-1, 3, 'ShuffleV2Block', [512, 1]],
    ],
    head=[
        [-1, 1, 'Conv', [128, 1, 1]],
        [-1, 1, 'Upsample', [None, 2, 'nearest']],
        [[-1, 4], 1, 'Concat', [1]],
        [-1, 1, 'C3', [128, False]],
        [-1, 1, 'Conv', [128, 1, 1]],
        [-1, 1, 'Upsample', [None, 2, 'nearest']],
        [[-1, 2], 1, 'Concat', [1]],
        [-1, 1, 'C3', [128, False]],
        [-1, 1, 'Conv', [128, 3, 2]],
        [[-1, 11], 1, 'Concat', [1]],
        [-1, 1, 'C3', [128, False]],
        [-1, 1, 'Conv', [128, 3, 2]],
        [[-1, 7], 1, 'Concat', [1]],
        [-1, 1, 'C3', [128, False]],
        [[14, 17, 20], 1, 'Detect', [1, ANCHORS]],
    ])

YOLO5L_CFG = dict(
    nc=1,
    backbone=[
        [-1, 1, 'StemBlock', [64, 3, 2]],
        [-1, 3, 'C3', [128]],
        [-1, 1, 'Conv', [256, 3, 2]],
        [-1, 9, 'C3', [256]],
        [-1, 1, 'Conv', [512, 3, 2]],
        [-1, 9, 'C3', [512]],
        [-1, 1, 'Conv', [1024, 3, 2]],
        [-1, 1, 'SPP', [1024, [3, 5, 7]]],
        [-1, 3, 'C3', [1024, False]],
    ],
    head=[
        [-1, 1, 'Conv', [512, 1, 1]],
        [-1, 1, 'Upsample', [None, 2, 'nearest']],
        [[-1, 5], 1, 'Concat', [1]],
        [-1, 3, 'C3', [512, False]],
        [-1, 1, 'Conv', [256, 1, 1]],
        [-1, 1, 'Upsample', [None, 2, 'nearest']],
        [[-1, 3], 1, 'Concat', [1]],
        [-1, 3, 'C3', [256, False]],
        [-1, 1, 'Conv', [256, 3, 2]],
        [[-1, 13], 1, 'Concat', [1]],
        [-1, 3, 'C3', [512, False]],
        [-1, 1, 'Conv', [512, 3, 2]],
        [[-1, 9], 1, 'Concat', [1]],
        [-1, 3, 'C3', [1024, False]],
        [[16, 19, 22], 1, 'Detect', [1, ANCHORS]],
    ])

CONFIGS = {'yolov5n': YOLO5N_CFG, 'yolov5l': YOLO5L_CFG}
STRIDES = (8, 16, 32)


class ConvBlock(nn.Module):
    """Conv (no bias) + BN (eps 1e-3) + SiLU (common.py Conv); padding
    k // 2."""

    def __init__(self, c1: int, c2: int, k: int = 1, s: int = 1,
                 g: int = 1, act: bool = True):
        super().__init__()
        self.conv = nn.Conv2d(c1, c2, k, s, k // 2, groups=g, bias=False)
        self.bn = nn.BatchNorm2d(c2, eps=1e-3)
        self.act = act

    def forward(self, x):
        x = self.bn(self.conv(x))
        return F.silu(x) if self.act else x


class StemBlock(nn.Module):
    def __init__(self, c1: int, c2: int, k: int = 3, s: int = 2):
        super().__init__()
        self.stem_1 = ConvBlock(c1, c2, k, s)
        self.stem_2a = ConvBlock(c2, c2 // 2, 1, 1)
        self.stem_2b = ConvBlock(c2 // 2, c2, 3, 2)
        self.stem_3 = ConvBlock(c2 * 2, c2, 1, 1)

    def forward(self, x):
        s1 = self.stem_1(x)
        s2b = self.stem_2b(self.stem_2a(s1))
        return self.stem_3(torch.cat([s2b, F.max_pool2d(s1, 2, 2)], 1))


class Bottleneck(nn.Module):
    def __init__(self, c1: int, c2: int, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBlock(c1, c_, 1, 1)
        self.cv2 = ConvBlock(c_, c2, 3, 1)
        self.add = shortcut and c1 == c2

    def forward(self, x):
        out = self.cv2(self.cv1(x))
        return x + out if self.add else out


class C3(nn.Module):
    def __init__(self, c1: int, c2: int, n: int = 1, shortcut: bool = True,
                 e: float = 0.5):
        super().__init__()
        c_ = int(c2 * e)
        self.cv1 = ConvBlock(c1, c_, 1, 1)
        self.cv2 = ConvBlock(c1, c_, 1, 1)
        self.cv3 = ConvBlock(2 * c_, c2, 1, 1)
        self.m = nn.Sequential(*[Bottleneck(c_, c_, shortcut, e=1.0)
                                 for _ in range(n)])

    def forward(self, x):
        return self.cv3(torch.cat([self.m(self.cv1(x)), self.cv2(x)], 1))


class SPP(nn.Module):
    """Max pools of stride 1, padded k // 2, beside their input."""

    def __init__(self, c1: int, c2: int, k=(5, 9, 13)):
        super().__init__()
        c_ = c1 // 2
        self.k = tuple(k)
        self.cv1 = ConvBlock(c1, c_, 1, 1)
        self.cv2 = ConvBlock(c_ * (len(self.k) + 1), c2, 1, 1)

    def forward(self, x):
        x = self.cv1(x)
        pools = [x] + [F.max_pool2d(x, k, 1, k // 2) for k in self.k]
        return self.cv2(torch.cat(pools, 1))


class ShuffleV2Block(nn.Module):
    """ShuffleNetV2 unit with SiLU (common.py:120-168): branch1 (stride >
    1 only) depthwise 3x3 -> BN -> 1x1 -> BN -> SiLU; branch2 1x1 -> BN
    -> SiLU -> depthwise 3x3 -> BN -> 1x1 -> BN -> SiLU; at stride 1 the
    input's first half passes and its second half takes branch2. The
    halves are concatenated, then shuffled in groups of 2. Sequential
    indices as the reference's (the SiLUs at branch1.4, branch2.2 and
    branch2.7)."""

    def __init__(self, inp: int, oup: int, stride: int):
        super().__init__()
        self.stride = stride
        bf = oup // 2
        if stride > 1:
            self.branch1 = nn.Sequential(
                nn.Conv2d(inp, inp, 3, stride, 1, groups=inp, bias=False),
                nn.BatchNorm2d(inp),
                nn.Conv2d(inp, bf, 1, bias=False),
                nn.BatchNorm2d(bf), nn.SiLU())
        b2_in = inp if stride > 1 else bf
        self.branch2 = nn.Sequential(
            nn.Conv2d(b2_in, bf, 1, bias=False), nn.BatchNorm2d(bf),
            nn.SiLU(),
            nn.Conv2d(bf, bf, 3, stride, 1, groups=bf, bias=False),
            nn.BatchNorm2d(bf),
            nn.Conv2d(bf, bf, 1, bias=False), nn.BatchNorm2d(bf),
            nn.SiLU())

    def forward(self, x):
        if self.stride > 1:
            out = torch.cat([self.branch1(x), self.branch2(x)], 1)
        else:
            x1, x2 = x.chunk(2, dim=1)
            out = torch.cat([x1, self.branch2(x2)], 1)
        b, c, h, w = out.shape
        return out.view(b, 2, c // 2, h, w).transpose(1, 2) \
            .reshape(b, c, h, w)


class Detect(nn.Module):
    """Per-level 1x1 convs and the decode (yolo.py:29-93), in fp32:
    sigmoid on xy, wh, objectness and class; xy = (2 sig - 0.5 + grid) *
    stride, wh = (2 sig)^2 * anchor; landmarks p * anchor + grid *
    stride, no sigmoid. Returns (B, N, 16) in input pixels, rows in
    (level, anchor, y, x) order."""

    def __init__(self, nc: int, anchors, ch):
        super().__init__()
        self.no = nc + 5 + 10
        self.na = len(anchors[0]) // 2
        self.anchors = anchors
        self.m = nn.ModuleList(nn.Conv2d(c, self.no * self.na, 1)
                               for c in ch)

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        outs = []
        for i, f in enumerate(feats):
            p = self.m[i](f).float()
            b, _, ny, nx = p.shape
            p = p.view(b, self.na, self.no, ny, nx).permute(0, 1, 3, 4, 2)
            stride = STRIDES[i]
            anchor = torch.tensor(self.anchors[i], dtype=torch.float32,
                                  device=p.device).view(self.na, 1, 1, 2)
            gy, gx = torch.meshgrid(
                torch.arange(ny, dtype=torch.float32, device=p.device),
                torch.arange(nx, dtype=torch.float32, device=p.device),
                indexing='ij')
            grid = torch.stack([gx, gy], -1)               # (ny, nx, 2)
            xy = (torch.sigmoid(p[..., 0:2]) * 2.0 - 0.5 + grid) * stride
            wh = (torch.sigmoid(p[..., 2:4]) * 2.0) ** 2 * anchor
            obj = torch.sigmoid(p[..., 4:5])
            lmk = (p[..., 5:15].reshape(b, self.na, ny, nx, 5, 2)
                   * anchor[:, :, :, None, :]
                   + grid[:, :, None, :] * stride).reshape(
                       b, self.na, ny, nx, 10)
            cls = torch.sigmoid(p[..., 15:])
            y = torch.cat([xy, wh, obj, lmk, cls], -1)
            outs.append(y.reshape(b, -1, self.no))
        return torch.cat(outs, 1)


class _Upsample(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode='nearest')


class _Concat(nn.Module):
    def forward(self, xs):
        return torch.cat(xs, 1)


@ARCH_REGISTRY.register()
class YoloFace(nn.Module):
    """The config-driven YOLOv5-face graph (yolo.py Model/parse_model).
    x: (B, 3, H, W) RGB in [0, 1], H and W multiples of 32 -> decoded
    (B, N, 16) predictions."""

    def __init__(self, variant: str = 'yolov5n'):
        super().__init__()
        cfg = CONFIGS[variant]
        self.rows = cfg['backbone'] + cfg['head']
        ch = [3]            # ch[-1]: the last layer's output channels
        layers = []
        for frm, n, mtype, args in self.rows:
            c1 = ch[-1] if frm == -1 else None
            if mtype == 'Detect':
                layers.append(Detect(cfg['nc'], args[1],
                                     [ch[j + 1] for j in frm]))
                break
            if mtype == 'Upsample':
                layer, c2 = _Upsample(), c1
            elif mtype == 'Concat':
                layer = _Concat()
                c2 = sum(ch[-1] if j == -1 else ch[j + 1] for j in frm)
            elif mtype == 'StemBlock':
                layer, c2 = StemBlock(c1, *args), args[0]
            elif mtype == 'Conv':
                layer, c2 = ConvBlock(c1, *args), args[0]
            elif mtype == 'SPP':
                layer, c2 = SPP(c1, args[0], args[1]), args[0]
            elif mtype == 'C3':
                shortcut = args[1] if len(args) > 1 else True
                layer, c2 = C3(c1, args[0], n, shortcut), args[0]
            elif mtype == 'ShuffleV2Block':
                # the reference wraps repeats in a Sequential
                blocks = [ShuffleV2Block(c1 if j == 0 else args[0], *args)
                          for j in range(n)]
                layer = blocks[0] if n == 1 else nn.Sequential(*blocks)
                c2 = args[0]
            else:
                raise NotImplementedError(mtype)
            layers.append(layer)
            ch.append(c2)
        self.model = nn.ModuleList(layers)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y: List[torch.Tensor] = []
        out = x
        for (frm, _, _, _), layer in zip(self.rows, self.model):
            if isinstance(layer, Detect):
                return layer([y[j] for j in frm])
            if frm != -1:
                out = y[frm] if isinstance(frm, int) else \
                    [out if j == -1 else y[j] for j in frm]
            out = layer(out)
            y.append(out)
        raise RuntimeError('config has no Detect layer')
