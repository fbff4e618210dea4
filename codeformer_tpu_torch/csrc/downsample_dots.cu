// K2: the VQGAN Downsample -- zero-pad bottom and right by one, then a
// 3x3 stride-2 conv + bias, C -> C, NHWC bf16 in and out, fp32 sums.
//
// Replaces the TPU kernel codeformer_tpu/ops/colpack_conv.py
// `downsample_dots` (kernel `_down_kernel`).
//
// What bounds it on the H100: per output pixel 9*C*C*2 FLOP against
// 4*C*2 bytes read and C*2 written, i.e. 1.8*C FLOP/byte: 115 at C = 64,
// 460 at C = 256. The 512^2 C=64 call is bound by HBM; the large-C calls
// on small maps have too few output pixels to fill 132 SMs.
//
// What the design does about it: it runs on the Hopper conv core
// (conv_sm90.cuh) at stride 2. A tile's (2TH+1) x (2TW+1) input window is
// one TMA box; coordinates past the last row or column read zero, which
// is the reference's (0,1,0,1) pad, and nothing is padded on the top or
// left. Each tap's A fragment is an ldmatrix at (2y+dy, 2x+dx) of that
// window, so every input byte comes from HBM about once. On small maps the
// plan narrows the N slice and splits the input channels over blocks; a
// second pass sums the fp32 partials in split order.
#include "conv_sm90.cuh"

// C entry. x: (B, H, W, C) bf16; w: (ceil(C/64), 9, CoutP, 64) bf16, rows
// swizzled (ops/conv3x3.py conv_operands); bias: (CoutP,) fp32;
// y: (B, H/2, W/2, C) bf16; ws: (split, B*(H/2)*(W/2), CoutP) fp32 or
// null. The plan (bn, mb, split, stages, smem, grid_x) comes from
// ops/conv3x3.py conv_plan. Returns a cudaError_t value, or -(CUresult)
// when the tensor map cannot be encoded.
extern "C" int cf_downsample_dots(const void* x, const void* w,
                                  const void* bias, void* y, void* ws, int B,
                                  int H, int W, int C, int CoutP, int bn,
                                  int mb, int split, int stages, int smem,
                                  int grid_x, int device, void* stream) {
  return cf::sm90::run_conv<2>(x, w, bias, y, ws, B, H, W, C, C, CoutP, bn,
                               mb, split, stages, smem, grid_x, device,
                               stream);
}
