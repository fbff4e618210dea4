"""The comparison that decides `correct`: the program's restored faces
against the plain float32 reference on the same inputs and weights.

With random weights each of a face's 256 tokens has 1024 close code
logits, so rounding alone flips a few percent of the argmax picks, and a
flipped code swaps a 32 x 32 patch of the output for another codebook
row's. An image comparison would then read the flips, not the
arithmetic. So at a token whose two best logits lie within WIDE_CODE of
the logits' standard deviation the reference follows the program's
pick, and judges it apart against its own float32 logits (`code_gap`);
at every other token it decodes its own argmax, so that a program pick
that differs there swaps a patch that the image numbers read. Then it
compares the images (`image_off`, `image_tile_off`). The program's codes are read where the
program looks them up (`CodeRecorder`); everything else, the encoder
taps, AdaIN's statistics, the fusion and the output, the reference
works out on its own.

- `code_gap`: over the faces, the largest mean over a face's tokens of
  (reference's best logit - reference's logit of the program's pick),
  in units of that token's logit standard deviation. A pick that is a
  near-tie adds near 0; one wrong pick of 256 adds about 0.01 (a wrong
  pick reads 2-3 standard deviations). The widest single gap swings
  with the tail of the near-ties, so it is reported (`code_gap_max`)
  and not compared.
- For the record, not compared: `code_wide_miss`, over the faces, the
  largest share of a face's wide tokens (top-two margin at least
  WIDE_CODE) at which the program's pick is not the reference's argmax
  (0 in every sound and every control run measured, so no limit could
  lie between them); `code_followed`, the largest share of a face's
  tokens whose pick the reference followed; `code_miss_margin`, the
  widest top-two margin of a token the program picked otherwise.
- `image_off`: over the faces, the largest share of a face's pixels at
  which the program's uint8 output and the reference's (decoding the
  program's picks) differ by more than OFF_FACE levels in some channel.
- `image_tile_off`: over the faces and their tiles of a token's patch
  (32 x 32 at 512^2: 16 x 16 tokens), the largest share of a tile's
  pixels off by more than OFF_TILE levels: a fault confined to part of a
  face, which a face's share dilutes.
Mean differences would not do: seeds differ about twofold in how far
their random weights amplify rounding, in the program and in the control
alike, so the largest mean over a dozen sound seeds came within 2x of
the smallest of the control; the share of pixels past a few times the
rounding's spread grows far faster with the error than the mean.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.reference.codeformer import fp32_math, to_u8, to_unit

# levels past which a pixel counts as off: bf16 rounding moves a few in
# a thousand of a face's pixels past 16 and almost none past 24, the
# int8 path a third and a tenth (PERF.md)
OFF_FACE = 16
OFF_TILE = 24
# top-two logit margins, in units of the logits' standard deviation, at
# and past which the reference takes its own argmax: about three times
# the widest gap of a sound code pick over 48 seeds (0.097), and five
# times that of a parse id at two levels of noise in bf16 (PERF.md)
WIDE_CODE = 0.3
WIDE_PARSE = 0.5


def pick_gaps(logits: torch.Tensor, picks: torch.Tensor,
              dim: int = -1) -> torch.Tensor:
    """(best logit - logit of the pick) in units of the logits'
    standard deviation along `dim` (the classes), for each position."""
    picked = logits.gather(dim, picks.unsqueeze(dim)).squeeze(dim)
    return (logits.max(dim).values - picked) / logits.std(dim)


def own_where_wide(logits: torch.Tensor, picks: torch.Tensor, wide: float,
                   dim: int = -1):
    """(picks to go on with, wide, missed, margin): the reference's own
    argmax where its two best logits lie at least `wide` logit standard
    deviations apart, the program's pick elsewhere; which positions are
    wide; which of those the program picked otherwise; the margin."""
    top2 = logits.topk(2, dim).values
    margin = (top2.select(dim, 0) - top2.select(dim, 1)) / logits.std(dim)
    own = logits.argmax(dim)
    is_wide = margin >= wide
    return (torch.where(is_wide, own, picks), is_wide,
            is_wide & (own != picks), margin)


def wide_numbers(is_wide, missed, margin, reduce_dims) -> Dict[str, list]:
    """Per item: the share of wide positions missed, the share followed
    (not wide), the widest margin of a position picked otherwise."""
    n_wide = is_wide.float().sum(reduce_dims)
    return {'wide_miss': (missed.float().sum(reduce_dims)
                          / n_wide.clamp_min(1)).tolist(),
            'followed': (~is_wide).float().mean(reduce_dims).tolist(),
            'miss_margin': torch.where(missed, margin, 0.0)
            .amax(reduce_dims).tolist()}


def token_tile(img: int, tokens: int) -> int:
    """Pixels a token's patch spans on an img x img face."""
    return img // round(tokens ** 0.5)


class CodeRecorder:
    """Keeps the code indices of every forward of the program's model:
    a wrapper on its codebook lookup that hands the (B, tokens) index
    tensor it is given (a reference, no copy and no sync) to `sink`
    (default: appends it to `codes`) and calls through."""

    def __init__(self, model, sink=None):
        self.codes: List[torch.Tensor] = []
        sink = sink or self.codes.append
        quantize = model.quantize
        lookup = quantize.get_codebook_feat

        def recorded(indices, *args, **kw):
            sink(indices)
            return lookup(indices, *args, **kw)
        quantize.get_codebook_feat = recorded


@torch.no_grad()
def face_numbers(ref, faces_u8: torch.Tensor, program_u8: torch.Tensor,
                 codes: torch.Tensor, w: float, adain: bool,
                 block: int = 4) -> Dict[str, np.ndarray]:
    """Per face: the numbers above, and for the record the mean and
    largest pixel difference, the largest tile mean, the widest code gap
    and the share of the program's picks that differ from the
    reference's argmax. faces_u8, program_u8: (n, H, W, 3) uint8 RGB on
    the reference's device; codes (n, tokens)."""
    out = {k: [] for k in ('code_gap', 'code_wide_miss', 'image_off',
                           'image_tile_off', 'image_mean_abs',
                           'image_tile_max', 'image_max_abs',
                           'code_gap_max', 'codes_flipped',
                           'code_followed', 'code_miss_margin')}
    pool = torch.nn.functional.avg_pool2d
    with fp32_math():
        for i in range(0, len(faces_u8), block):
            x = to_unit(faces_u8[i:i + block])
            c = codes[i:i + block].reshape(len(x), -1).long()
            logits, lq_feat, feats = ref.encode(x)
            gap = pick_gaps(logits, c)
            picks, *wide = own_where_wide(logits, c, WIDE_CODE)
            for k, v in wide_numbers(*wide, 1).items():
                out[f'code_{k}'] += v
            img = to_u8(ref.decode(picks, lq_feat, feats, w, adain))
            diff = (img.int() - program_u8[i:i + block].int()).abs()
            d = diff.amax(-1)[:, None].float()    # the worst channel
            tile = token_tile(x.shape[-1], c.shape[1])
            out['code_gap'] += gap.mean(1).tolist()
            out['image_off'] += (d > OFF_FACE).float().mean((1, 2, 3)) \
                .tolist()
            out['image_tile_off'] += pool((d > OFF_TILE).float(), tile,
                                          ceil_mode=True).amax((1, 2, 3)) \
                .tolist()
            out['image_mean_abs'] += diff.float().mean((1, 2, 3)).tolist()
            out['image_tile_max'] += pool(diff.float().mean(-1)[:, None],
                                          tile, ceil_mode=True) \
                .amax((1, 2, 3)).tolist()
            out['image_max_abs'] += diff.amax((1, 2, 3)).tolist()
            out['code_gap_max'] += gap.amax(1).tolist()
            out['codes_flipped'] += (c != logits.argmax(-1)).float() \
                .mean(1).tolist()
    return {k: np.asarray(v) for k, v in out.items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {'value', 'limit'}}): each number at or under its
    limit; a number that is not finite fails."""
    checks = {k: {'value': float(numbers[k]), 'limit': float(lim)}
              for k, lim in limits.items()}
    ok = all(np.isfinite(c['value']) and c['value'] <= c['limit']
             for c in checks.values())
    return ok, checks
