// The bare conv: y = conv3x3_SAME(x) + bias, stride 1, zero padding of one
// on every side, NHWC bf16 in and out, fp32 sums, the bias added in fp32
// and y rounded to bf16 once.
//
// Replaces the TPU kernels codeformer_tpu/ops/colpack_conv.py
// `conv3x3_colpack` (K1'), ops/pallas_conv.py `conv3x3_pallas` (K5) and
// ops/imgpair_conv.py `conv3x3_imgpair` / `conv3x3_pair` (K6): one
// function in three TPU packings (column pairs, phase pairs, image pairs)
// that only fill the TPU's 128-lane matrix unit.
//
// What bounds it on the H100: at B=16 512^2 64->64 the call moves 1.07 GB
// and does 309 GFLOP, 0.32 ms at either the HBM or the bf16 tensor peak;
// at 128 channels it is bound by the tensor cores.
//
// What the design does about it: it runs on the Hopper conv core
// (conv_sm90.cuh): TMA-staged input windows whose out-of-bound zero fill
// is the SAME halo, wgmma products with A from registers (ldmatrix at the
// tap's pixel offset) and the weights resident in shared memory for the
// block's life, a persistent grid with a ring of windows across tiles.
#include "conv_sm90.cuh"

// C entry. x: (B, H, W, Cin) bf16; w: (ceil(Cin/64), 9, CoutP, 64) bf16,
// rows swizzled (ops/conv3x3.py conv_operands); bias: (CoutP,) fp32;
// y: (B, H, W, Cout) bf16; ws: (split, B*H*W, CoutP) fp32 or null. The
// plan (bn, mb, split, stages, smem, grid_x) comes from
// ops/conv3x3.py conv_plan. Returns a cudaError_t value, or -(CUresult)
// when the tensor map cannot be encoded.
extern "C" int cf_conv3x3_bias(const void* x, const void* w,
                               const void* bias, void* y, void* ws, int B,
                               int H, int W, int Cin, int Cout, int CoutP,
                               int bn, int mb, int split, int stages,
                               int smem, int grid_x, int device,
                               void* stream) {
  return cf::sm90::run_conv<1>(x, w, bias, y, ws, B, H, W, Cin, Cout, CoutP,
                               bn, mb, split, stages, smem, grid_x, device,
                               stream);
}
