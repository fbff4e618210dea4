// K1: fused GroupNorm-apply -> activation -> 3x3 SAME conv -> bias -> skip,
// emitting per-block [sum, sumsq] partials of the bf16 output.
//
// Replaces the TPU kernel codeformer_tpu/ops/colpack_conv.py
// `conv3x3_dots` (kernel `_dots_kernel`) together with the XLA prologue
// `silu_affine` / `apply_affine` that fed it.
//
//   y = conv3x3_SAME(act(a * x + b)) + bias [+ skip | + skip @ W1x1]
//
// x, skip, y: NHWC bf16. a, b: (B, Cin) fp32 (the folded GroupNorm).
// w: (9, Cin, CoutP) bf16 [tap][in][out], bias: (CoutP,) fp32,
// w1: (Cs, CoutP) bf16, stats: (B, n_tiles, 2, Cout) fp32.
//
// What bounds it on the H100: at 512^2 with Cin = Cout = 64 a pixel costs
// 9*64*64*2 = 73.7 kFLOP against 256 bytes of HBM traffic (bf16 in + out),
// about 290 FLOP/byte, right at the card's bf16 ridge (~295). So the conv
// has to run on the tensor cores and must not add HBM passes.
//
// What the design does about it:
//  - Implicit GEMM on the tensor cores (WMMA 16x16x16 bf16, fp32
//    accumulation). The halo tile of each 32-channel chunk is staged in
//    shared memory once and read by all nine taps.
//  - The GroupNorm-apply and SiLU are folded into that staging load, so
//    the activated map never exists in HBM (the TPU version paid one
//    extra XLA pass for it). Out-of-image halo taps are written as 0
//    AFTER the activation: SAME padding pads act(a*x+b), not x.
//  - Bias, the identity skip or the 1x1 projected skip (a second K loop
//    over the raw block input), and the GroupNorm statistics of the
//    bf16-rounded output all happen in the epilogue: one write of y, no
//    reduction pass. Each block writes its own stats slot (no atomics),
//    so the result is deterministic.
// This first version does not overlap the staging loads with the MMAs
// (no cp.async, TMA or wgmma).
//
// conv_tile.cuh now serves this kernel alone: the bare conv
// (conv3x3_bias.cu) and K2 (downsample_dots.cu) run on the Hopper core in
// conv_sm90.cuh, which this kernel moves onto next (ROADMAP, Queue 2).
#include "conv_tile.cuh"

using namespace nvcuda;

namespace cf {
namespace {

enum { ACT_NONE = 0, ACT_SILU = 1 };
enum { SKIP_NONE = 0, SKIP_IDENTITY = 1, SKIP_PROJ = 2 };

constexpr int kHaloElems = (TH + 2) * (TW + 2) * CKP;

// 8 bf16 channels -> act(a*x+b) -> 8 bf16 channels, fp32 in between.
template <int ACT>
__device__ __forceinline__ uint4 affine_act8(uint4 raw, const float* ap,
                                             const float* bp) {
  const float4 a0 = *reinterpret_cast<const float4*>(ap);
  const float4 a1 = *reinterpret_cast<const float4*>(ap + 4);
  const float4 b0 = *reinterpret_cast<const float4*>(bp);
  const float4 b1 = *reinterpret_cast<const float4*>(bp + 4);
  const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
  const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
  __nv_bfloat162* pr = reinterpret_cast<__nv_bfloat162*>(&raw);
  uint4 out;
  __nv_bfloat162* po = reinterpret_cast<__nv_bfloat162*>(&out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = __bfloat1622float2(pr[i]);
    float v0 = av[2 * i] * v.x + bv[2 * i];
    float v1 = av[2 * i + 1] * v.y + bv[2 * i + 1];
    if (ACT == ACT_SILU) {
      v0 = v0 / (1.0f + __expf(-v0));
      v1 = v1 / (1.0f + __expf(-v1));
    }
    po[i] = __floats2bfloat162_rn(v0, v1);
  }
  return out;
}

template <int NF, int ACT, int SKIP>
__global__ void __launch_bounds__(kThreads)
conv3x3_dots_kernel(const __nv_bfloat16* __restrict__ x,
                    const float* __restrict__ a,
                    const float* __restrict__ b,
                    const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias,
                    const __nv_bfloat16* __restrict__ skip,
                    const __nv_bfloat16* __restrict__ w1,
                    __nv_bfloat16* __restrict__ y,
                    float* __restrict__ stats,
                    int H, int W, int Cin, int Cout, int CoutP, int Cs,
                    int tiles_x, int n_tiles) {
  constexpr int BN = 16 * NF;
  constexpr int LDB = ldb(BN);
  constexpr int LDC = ldc(BN);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* halo = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wts = halo + kHaloElems;
  float* stage = reinterpret_cast<float*>(smem);

  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int bi = blockIdx.z;
  const int y0 = (tile / tiles_x) * TH;
  const int x0 = (tile % tiles_x) * TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;

  constexpr int V = CK / 8;
  for (int c0 = 0; c0 < Cin; c0 += CK) {
    __syncthreads();  // the previous chunk's MMAs are done with smem
    for (int e = tid; e < (TH + 2) * (TW + 2) * V; e += kThreads) {
      const int cv = e % V;
      const int p = e / V;
      const int hx = p % (TW + 2);
      const int hy = p / (TW + 2);
      const int iy = y0 - 1 + hy;
      const int ix = x0 - 1 + hx;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);  // SAME halo: zero after act
      if (iy >= 0 && iy < H && ix >= 0 && ix < W) {
        const int c = c0 + cv * 8;
        val = affine_act8<ACT>(
            *reinterpret_cast<const uint4*>(
                x + ((size_t)(bi * H + iy) * W + ix) * Cin + c),
            a + (size_t)bi * Cin + c, b + (size_t)bi * Cin + c);
      }
      *reinterpret_cast<uint4*>(halo + p * CKP + cv * 8) = val;
    }
    load_weights<BN>(wts, w + (size_t)c0 * CoutP + n0, 9, CoutP,
                     (size_t)Cin * CoutP);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3;
      const int dx = t % 3;
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        wmma::load_matrix_sync(
            af, halo + ((warp + dy) * (TW + 2) + dx) * CKP + kk, CKP);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::load_matrix_sync(bf, wts + (t * CK + kk) * LDB + f * 16, LDB);
          wmma::mma_sync(acc[f], af, bf, acc[f]);
        }
      }
    }
  }

  if (SKIP == SKIP_PROJ) {
    // skip @ W1x1 over the RAW block input: a K loop on the tile centre
    for (int c0 = 0; c0 < Cs; c0 += CK) {
      __syncthreads();
      for (int e = tid; e < TH * TW * V; e += kThreads) {
        const int cv = e % V;
        const int p = e / V;
        const int px = p % TW;
        const int py = p / TW;
        const int iy = y0 + py;
        const int ix = x0 + px;
        uint4 val = make_uint4(0u, 0u, 0u, 0u);
        if (iy < H && ix < W)
          val = *reinterpret_cast<const uint4*>(
              skip + ((size_t)(bi * H + iy) * W + ix) * Cs + c0 + cv * 8);
        *reinterpret_cast<uint4*>(
            halo + ((py + 1) * (TW + 2) + px + 1) * CKP + cv * 8) = val;
      }
      load_weights<BN>(wts, w1 + (size_t)c0 * CoutP + n0, 1, CoutP, 0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        wmma::load_matrix_sync(
            af, halo + ((warp + 1) * (TW + 2) + 1) * CKP + kk, CKP);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::load_matrix_sync(bf, wts + kk * LDB + f * 16, LDB);
          wmma::mma_sync(acc[f], af, bf, acc[f]);
        }
      }
    }
  }

  __syncthreads();  // staging reuses the halo/weight memory
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(stage + (warp * TW) * LDC + f * 16, acc[f], LDC,
                            wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < TH * TW * BN; e += kThreads) {
    const int n = e % BN;
    const int p = e / BN;
    const int iy = y0 + p / TW;
    const int ix = x0 + p % TW;
    const int gn = n0 + n;
    float r = 0.0f;
    if (iy < H && ix < W && gn < Cout) {
      const size_t pix = (size_t)(bi * H + iy) * W + ix;
      float v = stage[p * LDC + n] + bias[gn];
      if (SKIP == SKIP_IDENTITY) v += __bfloat162float(skip[pix * Cout + gn]);
      const __nv_bfloat16 o = __float2bfloat16_rn(v);
      y[pix * Cout + gn] = o;
      r = __bfloat162float(o);
    }
    stage[p * LDC + n] = r;  // rounded value feeds the statistics
  }
  __syncthreads();

  if (tid < BN) {
    const int gn = n0 + tid;
    float s1 = 0.0f, s2 = 0.0f;
    for (int p = 0; p < TH * TW; ++p) {
      const float v = stage[p * LDC + tid];
      s1 += v;
      s2 += v * v;
    }
    if (gn < Cout) {
      float* st = stats + ((size_t)bi * n_tiles + tile) * 2 * Cout;
      st[gn] = s1;
      st[Cout + gn] = s2;
    }
  }
}

template <int NF, int ACT, int SKIP>
cudaError_t launch(const void* x, const void* a, const void* b, const void* w,
                   const void* bias, const void* skip, const void* w1,
                   void* y, void* stats, int B, int H, int W, int Cin,
                   int Cout, int CoutP, int Cs, cudaStream_t stream) {
  constexpr int BN = 16 * NF;
  constexpr int main_bytes = kHaloElems * 2 + weight_bytes(9, BN);
  constexpr int smem = main_bytes > stage_bytes(BN) ? main_bytes
                                                    : stage_bytes(BN);
  auto kern = conv3x3_dots_kernel<NF, ACT, SKIP>;
  // set on every launch: the attribute belongs to the current device
  const cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, CoutP / BN, B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(a),
      static_cast<const float*>(b), static_cast<const __nv_bfloat16*>(w),
      static_cast<const float*>(bias),
      static_cast<const __nv_bfloat16*>(skip),
      static_cast<const __nv_bfloat16*>(w1), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(stats), H, W, Cin, Cout, CoutP, Cs, tiles_x,
      tiles_x * tiles_y);
  return cudaGetLastError();
}

template <int NF, int ACT>
cudaError_t dispatch_skip(int skip_mode, const void* x, const void* a,
                          const void* b, const void* w, const void* bias,
                          const void* skip, const void* w1, void* y,
                          void* stats, int B, int H, int W, int Cin, int Cout,
                          int CoutP, int Cs, cudaStream_t s) {
  switch (skip_mode) {
    case SKIP_NONE:
      return launch<NF, ACT, SKIP_NONE>(x, a, b, w, bias, skip, w1, y, stats,
                                        B, H, W, Cin, Cout, CoutP, Cs, s);
    case SKIP_IDENTITY:
      return launch<NF, ACT, SKIP_IDENTITY>(x, a, b, w, bias, skip, w1, y,
                                            stats, B, H, W, Cin, Cout, CoutP,
                                            Cs, s);
    case SKIP_PROJ:
      return launch<NF, ACT, SKIP_PROJ>(x, a, b, w, bias, skip, w1, y, stats,
                                        B, H, W, Cin, Cout, CoutP, Cs, s);
  }
  return cudaErrorInvalidValue;
}

template <int NF>
cudaError_t dispatch_act(int act, int skip_mode, const void* x, const void* a,
                         const void* b, const void* w, const void* bias,
                         const void* skip, const void* w1, void* y,
                         void* stats, int B, int H, int W, int Cin, int Cout,
                         int CoutP, int Cs, cudaStream_t s) {
  if (act == ACT_SILU)
    return dispatch_skip<NF, ACT_SILU>(skip_mode, x, a, b, w, bias, skip, w1,
                                       y, stats, B, H, W, Cin, Cout, CoutP,
                                       Cs, s);
  if (act == ACT_NONE)
    return dispatch_skip<NF, ACT_NONE>(skip_mode, x, a, b, w, bias, skip, w1,
                                       y, stats, B, H, W, Cin, Cout, CoutP,
                                       Cs, s);
  return cudaErrorInvalidValue;
}

}  // namespace
}  // namespace cf

// C entry. n_frags: 16-wide output-channel fragments per block (1 or 4);
// CoutP must be a multiple of 16 * n_frags. Returns a cudaError_t value.
extern "C" int cf_conv3x3_dots(const void* x, const void* a, const void* b,
                               const void* w, const void* bias,
                               const void* skip, const void* w1, void* y,
                               void* stats, int B, int H, int W, int Cin,
                               int Cout, int CoutP, int Cs, int act,
                               int skip_mode, int n_frags, int device,
                               void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_frags == 4)
    err = cf::dispatch_act<4>(act, skip_mode, x, a, b, w, bias, skip, w1, y,
                              stats, B, H, W, Cin, Cout, CoutP, Cs, s);
  else if (n_frags == 1)
    err = cf::dispatch_act<1>(act, skip_mode, x, a, b, w, bias, skip, w1, y,
                              stats, B, H, W, Cin, Cout, CoutP, Cs, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
