// Shared tiling for the implicit-GEMM conv kernels (conv3x3_dots.cu,
// downsample_dots.cu).
//
// GEMM view: M = output pixels, N = output channels, K = taps x input
// channels. A block owns a TH x TW tile of output pixels and BN = 16*NF
// output channels; warp w owns output row w of the tile (16 pixels = one
// WMMA M fragment) and all NF N fragments. The input channels are walked
// in chunks of CK: each chunk's input tile and weight slab are staged in
// shared memory once and reused by every tap.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace cf {

constexpr int kThreads = 256;     // 8 warps
constexpr int TH = 8;             // output rows per block (one per warp)
constexpr int TW = 16;            // output columns per block (WMMA M)
constexpr int CK = 32;            // input channels per staged chunk
// Channel stride of a staged pixel: CK + 16 keeps every pixel 32-byte
// aligned (WMMA pointer rule) and staggers shared-memory banks.
constexpr int CKP = CK + 16;

__host__ __device__ constexpr int ldb(int bn) { return bn + 16; }
__host__ __device__ constexpr int ldc(int bn) { return bn + 4; }

// Bytes of the weight slab for `taps` taps of one CK chunk, BN columns.
__host__ __device__ constexpr int weight_bytes(int taps, int bn) {
  return taps * CK * ldb(bn) * 2;
}
// Bytes of the fp32 epilogue staging tile (reuses the same memory).
__host__ __device__ constexpr int stage_bytes(int bn) {
  return TH * TW * ldc(bn) * 4;
}

// Copy a (taps, CK, BN) bf16 weight slab into shared memory, laid out
// [tap][k][n] with row stride ldb(BN). `src` points at (tap 0, k 0, n 0);
// rows are `ld` apart and taps `tap_stride` apart (all in elements).
template <int BN>
__device__ __forceinline__ void load_weights(__nv_bfloat16* dst,
                                             const __nv_bfloat16* src,
                                             int taps, size_t ld,
                                             size_t tap_stride) {
  constexpr int V = BN / 8;
  const int total = taps * CK * V;
  for (int e = threadIdx.x; e < total; e += kThreads) {
    const int v = e % V;
    const int k = (e / V) % CK;
    const int t = e / (V * CK);
    const uint4 val = *reinterpret_cast<const uint4*>(
        src + t * tap_stride + k * ld + v * 8);
    *reinterpret_cast<uint4*>(dst + (t * CK + k) * ldb(BN) + v * 8) = val;
  }
}

}  // namespace cf
