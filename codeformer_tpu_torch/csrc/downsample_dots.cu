// K2: the VQGAN Downsample -- zero-pad bottom and right by one, then a
// 3x3 stride-2 conv + bias, C -> C, NHWC bf16.
//
// Replaces the TPU kernel codeformer_tpu/ops/colpack_conv.py
// `downsample_dots` (kernel `_down_kernel`).
//
// x: (B, H, W, C) bf16, w: (9, C, CoutP) bf16 [tap][in][out],
// bias: (CoutP,) fp32, y: (B, H/2, W/2, C) bf16.
//
// What bounds it on the H100: per output pixel 9*C*C*2 FLOP against
// 4*C*2 bytes read and C*2 written, i.e. 1.8*C FLOP/byte: 115 at C = 64,
// 460 at C = 256. The large-C, small-map calls are tensor-core bound; the
// 512^2 C=64 call is close to the bandwidth line.
//
// What the design does about it: implicit GEMM on the tensor cores (WMMA
// 16x16x16 bf16, fp32 accumulation). For a TH x TW output tile the block
// stages the (2TH+1) x (2TW+1) input window of each 32-channel chunk in
// shared memory once; each tap's A operand is a stride-2 view of that
// window (WMMA leading dimension 2 pixels), so every input byte is read
// from HBM about once. The padding is the reference's (0,1,0,1): taps
// past the last row or column read 0, and nothing is padded on the top or
// left. No load/MMA overlap yet (no cp.async, TMA or wgmma).
#include "conv_tile.cuh"

using namespace nvcuda;

namespace cf {
namespace {

constexpr int IH = 2 * TH + 1;  // staged input rows per tile
constexpr int IW = 2 * TW + 1;  // staged input columns per tile
constexpr int kInElems = IH * IW * CKP;

template <int NF>
__global__ void __launch_bounds__(kThreads)
downsample_dots_kernel(const __nv_bfloat16* __restrict__ x,
                       const __nv_bfloat16* __restrict__ w,
                       const float* __restrict__ bias,
                       __nv_bfloat16* __restrict__ y, int H, int W, int C,
                       int CoutP, int Ho, int Wo, int tiles_x) {
  constexpr int BN = 16 * NF;
  constexpr int LDB = ldb(BN);
  constexpr int LDC = ldc(BN);
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* wts = win + kInElems;
  float* stage = reinterpret_cast<float*>(smem);

  const int tile = blockIdx.x;
  const int n0 = blockIdx.y * BN;
  const int bi = blockIdx.z;
  const int oy0 = (tile / tiles_x) * TH;
  const int ox0 = (tile % tiles_x) * TW;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[NF];
#pragma unroll
  for (int f = 0; f < NF; ++f) wmma::fill_fragment(acc[f], 0.0f);
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af;
  wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> bf;

  constexpr int V = CK / 8;
  for (int c0 = 0; c0 < C; c0 += CK) {
    __syncthreads();
    for (int e = tid; e < IH * IW * V; e += kThreads) {
      const int cv = e % V;
      const int p = e / V;
      const int hx = p % IW;
      const int hy = p / IW;
      const int iy = 2 * oy0 + hy;
      const int ix = 2 * ox0 + hx;
      uint4 val = make_uint4(0u, 0u, 0u, 0u);  // bottom/right zero pad
      if (iy < H && ix < W)
        val = *reinterpret_cast<const uint4*>(
            x + ((size_t)(bi * H + iy) * W + ix) * C + c0 + cv * 8);
      *reinterpret_cast<uint4*>(win + p * CKP + cv * 8) = val;
    }
    load_weights<BN>(wts, w + (size_t)c0 * CoutP + n0, 9, CoutP,
                     (size_t)C * CoutP);
    __syncthreads();
#pragma unroll
    for (int t = 0; t < 9; ++t) {
      const int dy = t / 3;
      const int dx = t % 3;
#pragma unroll
      for (int kk = 0; kk < CK; kk += 16) {
        // output row `warp`, columns 0..15 read input columns dx, dx+2, ...
        wmma::load_matrix_sync(
            af, win + ((2 * warp + dy) * IW + dx) * CKP + kk, 2 * CKP);
#pragma unroll
        for (int f = 0; f < NF; ++f) {
          wmma::load_matrix_sync(bf, wts + (t * CK + kk) * LDB + f * 16, LDB);
          wmma::mma_sync(acc[f], af, bf, acc[f]);
        }
      }
    }
  }

  __syncthreads();
#pragma unroll
  for (int f = 0; f < NF; ++f)
    wmma::store_matrix_sync(stage + (warp * TW) * LDC + f * 16, acc[f], LDC,
                            wmma::mem_row_major);
  __syncthreads();

  for (int e = tid; e < TH * TW * BN; e += kThreads) {
    const int n = e % BN;
    const int p = e / BN;
    const int oy = oy0 + p / TW;
    const int ox = ox0 + p % TW;
    const int gn = n0 + n;
    if (oy < Ho && ox < Wo && gn < C)
      y[((size_t)(bi * Ho + oy) * Wo + ox) * C + gn] =
          __float2bfloat16_rn(stage[p * LDC + n] + bias[gn]);
  }
}

}  // namespace
}  // namespace cf

// C entry. CoutP: C rounded up to a multiple of 64. Returns a cudaError_t.
extern "C" int cf_downsample_dots(const void* x, const void* w,
                                  const void* bias, void* y, int B, int H,
                                  int W, int C, int CoutP, int device,
                                  void* stream) {
  using namespace cf;
  constexpr int NF = 4;
  constexpr int BN = 16 * NF;
  constexpr int main_bytes = kInElems * 2 + weight_bytes(9, BN);
  constexpr int smem = main_bytes > stage_bytes(BN) ? main_bytes
                                                    : stage_bytes(BN);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // set on every launch: the attribute belongs to the current device
  err = cudaFuncSetAttribute(downsample_dots_kernel<NF>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Ho = H / 2;
  const int Wo = W / 2;
  const int tiles_x = (Wo + TW - 1) / TW;
  const int tiles_y = (Ho + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, CoutP / BN, B);
  downsample_dots_kernel<NF><<<grid, kThreads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(y), H, W, C, CoutP, Ho, Wo, tiles_x);
  return static_cast<int>(cudaGetLastError());
}
