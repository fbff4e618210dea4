// K1: fused GroupNorm-apply -> activation -> 3x3 SAME conv -> bias -> skip,
// emitting per-tile [sum, sumsq] partials of the bf16 output.
//
// Replaces the TPU kernel codeformer_tpu/ops/colpack_conv.py
// `conv3x3_dots` (kernel `_dots_kernel`) together with the XLA prologue
// `silu_affine` / `apply_affine` that fed it.
//
//   y = bf16(conv3x3_SAME(bf16(act(a * x + b))) + bias [+ skip | + skip @ W1])
//
// x, skip, y: NHWC bf16. a, b: (B, Cin) fp32 (the folded GroupNorm).
//
// What bounds it on the H100: at 512^2 with Cin = Cout = 64 and the
// identity skip a pixel costs 9*64*64*2 = 73.7 kFLOP against 384 bytes of
// HBM traffic (x, skip and y in bf16), about 190 FLOP/byte, under the
// card's bf16 ridge (~295): HBM bounds it. At 128 channels and up the
// tensor cores do. So the conv must run on the tensor cores at a good
// share of their rate, every input byte must come from HBM once, and the
// activated map must never exist in HBM.
//
// What the design does about it: it runs on the Hopper conv core
// (conv_sm90.cuh, FUSED): TMA-staged windows rewritten once in shared
// memory by a prologue stage (a * x + b, the activation, the halo zeroed
// AFTER it) on warps that issue no wgmma, the weights (and the 1x1
// projection's) resident for the block's life, a persistent ring, wgmma
// products with A from registers, and an epilogue in registers that adds
// the bias and the skip (loaded while the tile's products run) in fp32,
// rounds once, stores 16 bytes a lane and reduces the statistics of the
// rounded y inside the block (one slot a tile, no float atomics). Wide
// inputs split their chunks so that BN = 64 keeps its weights resident;
// a second pass then sums the splits in order and does the epilogue's
// work. Why the prologue is a stage of its own and not on the A
// registers, and what bounds each shape: see conv_sm90.cuh.
#include "conv_sm90.cuh"

// C entry. x: (B, H, W, Cin) bf16; a, b: (B, Cin) fp32; w: (ceil(Cin/64),
// 9, CoutP, 64) bf16, rows swizzled, and bias (CoutP,) fp32
// (ops/conv3x3.py conv_operands); skip: (B, H, W, Cout) (skip_mode 1) or
// (B, H, W, Cs) (skip_mode 2) bf16, else null; w1: (ceil(Cs/64), CoutP,
// 64) bf16, rows swizzled (skip_mode 2), else null; y: (B, H, W, Cout)
// bf16; stats: (B, tiles_y * tiles_x, 2, Cout) fp32; ws: (split, B*H*W,
// CoutP) fp32 partials where split > 1, else null. act: 0 none, 1 SiLU.
// The plan (bn, mb, split, stages, smem, grid_x) comes from ops/conv3x3.py
// conv_plan. Returns a cudaError_t value, or -(CUresult) when a tensor map
// cannot be encoded.
extern "C" int cf_conv3x3_dots(const void* x, const void* a, const void* b,
                               const void* w, const void* bias,
                               const void* skip, const void* w1, void* y,
                               void* stats, void* ws, int B, int H, int W,
                               int Cin, int Cout, int CoutP, int Cs, int act,
                               int skip_mode, int bn, int mb, int split,
                               int stages, int smem, int grid_x, int device,
                               void* stream) {
  return cf::sm90::run_dots(x, a, b, w, bias, skip, w1, y, stats, ws, B, H,
                            W, Cin, Cout, CoutP, Cs, act, skip_mode, bn, mb,
                            split, stages, smem, grid_x, device, stream);
}
