// The dense conv of RRDBNet's dense blocks, without concatenation:
//
//   y[..., :Cout] = bf16(epi(conv3x3_SAME(x[..., :Cin]) + bias [, s1, s2]))
//
// x is the channel prefix of a wider NHWC bf16 buffer (ld_x channels a
// pixel), y a channel slice of one (ld_y), s1 and s2 strided 64-channel
// views; epi is one of lrelu(v, 0.2) (conv1-4), 0.2 v + s1 (conv5),
// 0.2 (0.2 v + s1) + s2 (conv5 of an RRDB's third block: the RRDB's own
// residual) and v + s1 (conv_body), in fp32 with one bf16 rounding.
//
// Replaces no TPU kernel: the JAX package runs RRDBNet on XLA's convs,
// which concatenate each dense block's growing feature map. On the card,
// cuDNN takes packed NHWC only, so a dense block built on it copies its
// map four times (64 -> 192 channels, 2,560 B a pixel) and runs its
// LeakyReLUs and residuals as passes of their own: at 240^2 and B = 16
// those copies and passes took as long as the convs.
//
// What bounds it on the H100: a dense block's five convs do 479 kFLOP a
// pixel against about 1.8 KB of HBM traffic (each conv reads its prefix
// and writes its slice), about 270 FLOP a byte, near the card's bf16
// ridge (~295).
//
// What the design does about it: it runs on the Hopper conv core
// (conv_sm90.cuh, DENSE). The input tensor map has dims (Cin, W, H, B)
// and a pixel stride of ld_x channels, so TMA stages a window of the
// prefix in place and its zero fill past Cin gives the chunk tail; the
// epilogue stores into the slice with 16-byte stores and adds the skips,
// loaded when the tile starts, in fp32. A conv reads only channels below
// the slice it writes, so no launch reads what it writes, and the map is
// never copied. The weights stay resident in shared memory for the
// block's life; conv5's 192 -> 64 at BN = 32 (ops/conv3x3.py conv_plan).
#include "conv_sm90.cuh"

namespace cf {
namespace sm90 {

// The dense conv's second pass after a split: y[pix * ld_y + n] =
// bf16(epi(the splits' fp32 partials summed in split order + bias, s1,
// s2)) with one rounding, as dense_epilogue.
static __global__ void dense_finish_kernel(
    const float* __restrict__ ws, const float* __restrict__ bias,
    const __nv_bfloat16* s1, const __nv_bfloat16* s2, __nv_bfloat16* y,
    long long pixels, int Cout, int CoutP, int split, int ld_y, int ld_s1,
    int ld_s2, int epi) {
  const long long total = pixels * Cout;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long pix = e / Cout;
    const int n = static_cast<int>(e - pix * Cout);
    float v = 0.0f;
    for (int s = 0; s < split; ++s)
      v += ws[((long long)s * pixels + pix) * CoutP + n];
    const float a1 =
        s1 != nullptr ? __bfloat162float(s1[pix * ld_s1 + n]) : 0.0f;
    const float a2 =
        s2 != nullptr ? __bfloat162float(s2[pix * ld_s2 + n]) : 0.0f;
    y[pix * ld_y + n] =
        __float2bfloat16_rn(dense_epi(v + bias[n], a1, a2, epi));
  }
}

// The dense conv's variants (ops/conv3x3.py DENSE_VARIANTS).
using DenseFn = void (*)(const CUtensorMap, const CUtensorMap, const Args);
inline DenseFn dense_variant(int bn, int mb) {
  if (bn == 32) return mb == 1 ? conv3x3_dense_kernel<32, 1>
                      : mb == 2 ? conv3x3_dense_kernel<32, 2> : nullptr;
  return bn == 64 && mb == 1 ? conv3x3_dense_kernel<64, 1> : nullptr;
}

// The dense conv: check the plan and the strides, encode the map of the
// channel prefix x[..., :Cin] (ld_x channels a pixel), launch (and a
// split's second pass). Same return values as run_conv.
inline int run_dense(const void* x, const void* w, const void* bias, void* y,
                     const void* s1, const void* s2, void* ws, int B, int H,
                     int W, int Cin, int ld_x, int Cout, int CoutP, int ld_y,
                     int ld_s1, int ld_s2, int epi, int bn, int mb, int split,
                     int stages, int smem, int grid_x, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nch = (Cin + KC - 1) / KC;
  const int th = tile_h(mb);
  const DenseFn fn = dense_variant(bn, mb);
  const auto misaligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 != 0;
  };
  const bool wants_s1 = epi != EPI_LRELU;
  if (fn == nullptr || B < 1 || H < 1 || W < 1 || Cin < 32 || Cin % 32 ||
      ld_x < Cin || ld_x % 8 || Cout < 32 || Cout % 32 || Cout != CoutP ||
      CoutP % bn || ld_y < Cout || ld_y % 8 || epi < EPI_LRELU ||
      epi > EPI_ADD || wants_s1 != (s1 != nullptr) ||
      (epi == EPI_RRDB) != (s2 != nullptr) ||
      (s1 != nullptr && (ld_s1 < Cout || ld_s1 % 8 || misaligned(s1))) ||
      (s2 != nullptr && (ld_s2 < Cout || ld_s2 % 8 || misaligned(s2))) ||
      misaligned(x) || misaligned(y) || stages < 2 || grid_x < 1 ||
      split < 1 || nch % split || (split > 1) != (ws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cps = nch / split;
  const int w_bytes = cps * 9 * bn * kRowBytes;
  const long long need = (long long)kAlignSlack + w_bytes +
                         (long long)stages * slot_bytes(1, th) +
                         kBarrierBytes;
  if (smem < need || smem > kSmemLimit || 16 * stages + 8 > kBarrierBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const CUresult cr =
      encode_box(&map, x, B, H, W, Cin, win_w(1), win_h(1, th), ld_x);
  if (cr != CUDA_SUCCESS) return -static_cast<int>(cr);
  Args a = core_args(w, bias, y, B, H, W, Cout, CoutP, cps, bn, th, stages,
                     w_bytes);
  a.ws = static_cast<float*>(ws);
  a.s1 = static_cast<const __nv_bfloat16*>(s1);
  a.s2 = static_cast<const __nv_bfloat16*>(s2);
  a.ld_y = ld_y;
  a.ld_s1 = ld_s1;
  a.ld_s2 = ld_s2;
  a.epi = epi;
  // set on every launch: the attribute belongs to the current device
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fn<<<dim3(grid_x, a.n_slices * split), kThreads, smem, s>>>(map, map, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  dense_finish_kernel<<<1024, 256, 0, s>>>(a.ws, a.bias, a.s1, a.s2, a.y,
                                           a.pixels, Cout, CoutP, split, ld_y,
                                           ld_s1, ld_s2, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace cf

// C entry. x: the channel prefix of (B, H, W, ld_x) bf16, Cin channels
// read; w: (ceil(Cin/64), 9, CoutP, 64) bf16, rows swizzled, bias:
// (CoutP,) fp32 (ops/conv3x3.py conv_operands); y: the first channel of
// the written slice, ld_y channels a pixel; s1, s2: skips, ld_s1, ld_s2
// channels a pixel, or null; ws: (split, B*H*W, CoutP) fp32 or null.
// epi: 0 lrelu, 1 residual, 2 RRDB residual, 3 add. The plan (bn, mb,
// split, stages, smem, grid_x) comes from ops/conv3x3.py conv_plan.
// Returns a cudaError_t value, or -(CUresult) when the tensor map cannot
// be encoded.
extern "C" int cf_conv3x3_dense(const void* x, const void* w,
                                const void* bias, void* y, const void* s1,
                                const void* s2, void* ws, int B, int H,
                                int W, int Cin, int ld_x, int Cout,
                                int CoutP, int ld_y, int ld_s1, int ld_s2,
                                int epi, int bn, int mb, int split,
                                int stages, int smem, int grid_x, int device,
                                void* stream) {
  return cf::sm90::run_dense(x, w, bias, y, s1, s2, ws, B, H, W, Cin, ld_x,
                             Cout, CoutP, ld_y, ld_s1, ld_s2, epi, bn, mb,
                             split, stages, smem, grid_x, device, stream);
}
