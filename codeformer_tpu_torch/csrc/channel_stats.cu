// The statistics of a GroupNorm stage's entry: per-channel [sum, sumsq] of
// an NHWC bf16 map, in slots, in one read of the map.
//
//   out[b, s, 0, c] = sum of x[b, p, c]   over the pixels p of slot s
//   out[b, s, 1, c] = sum of x[b, p, c]^2 over the same pixels
//
// in fp32, in the layout K1 emits its statistics in, so that gn_affine
// sums the slots of either alike.
//
// Replaces no TPU kernel: the JAX package leaves these statistics to XLA
// (codeformer_tpu/ops/colpack_conv.py `colpack_stats`). In plain PyTorch
// (ops/conv3x3.py `channel_stats`) they take five launches (an fp32 copy
// of the map, its sum, its square, that sum, a stack), about 22 bytes of
// traffic for each 2-byte element, and at B = 1 torch reduces over H and
// W into only C outputs, on few blocks.
//
// What bounds it on the H100: an add and an FMA an element against the 2
// bytes read: HBM bandwidth, far below the ridge. The output, B * S * 2 *
// C fp32, is under 1% of the map at the forward's shapes.
//
// What the design does about it: every element is read once, with 16-byte
// loads, neighbouring threads on neighbouring addresses, four loads in
// flight a thread; nothing else is stored. A block is P rows of C / 8
// threads; thread (r, k) keeps fp32 sums for channels 8k .. 8k + 7 and
// reads pixels r, r + P, r + 2P, ... of its slot: the block steps P pixels,
// a multiple of C elements, so a thread's channels never change. Four
// pixels are added pairwise, up to kGroups such groups into a partial and
// the partials into the total, so that no sum is a long chain of fp32
// additions. A shared-memory tree combines the P rows in a fixed order and
// the block writes its slot: no atomics, so the result does not depend on
// the order the blocks run in, and a CUDA graph can capture the launch.
// The grid is (S, B); slot s holds the pixels [s * n, min(HW, (s + 1) *
// n)). S follows the shape and the SM count (ops/conv3x3.py
// `stats_slot_plan`): about kBlocksPerSm blocks an SM, one wave, at any B.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cf {
namespace {

constexpr int kStatsThreads = 256;
constexpr int kBlocksPerSm = 4;     // ops/conv3x3.py STATS_BLOCKS_PER_SM
constexpr int kLanes = 8;           // channels a thread: 16 bytes of bf16
constexpr int kGroups = 16;         // groups of four pixels a partial

// the 8 bf16 of a 16-byte load, widened to fp32
__device__ __forceinline__ void widen(const uint4& v, float (&f)[kLanes]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < kLanes / 2; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

__global__ void __launch_bounds__(kStatsThreads, kBlocksPerSm)
channel_stats_kernel(const __nv_bfloat16* __restrict__ x,
                     float* __restrict__ out, int HW, int C,
                     int slot_pixels) {
  // red[i * kStatsThreads + t]: value i of thread t (0-7 the sums, 8-15
  // the sums of squares), so that a warp's accesses hit distinct banks
  __shared__ float red[2 * kLanes * kStatsThreads];
  const int L = C / kLanes;                 // threads a pixel
  const int P = kStatsThreads / L;          // pixels a block step
  const int t = threadIdx.x;
  const int r = t / L, k = t - r * L;
  const int slot = blockIdx.x, b = blockIdx.y;
  const int p0 = slot * slot_pixels;
  const int p1 = min(HW, p0 + slot_pixels);

  float s[kLanes], q[kLanes];
#pragma unroll
  for (int j = 0; j < kLanes; ++j) s[j] = q[j] = 0.0f;
  if (r < P) {
    const long long step = (long long)P * C;
    const __nv_bfloat16* src =
        x + ((long long)b * HW + p0 + r) * C + k * kLanes;
    int p = p0 + r;
    while (p + 3 * P < p1) {
      float ps[kLanes], pq[kLanes];
#pragma unroll
      for (int j = 0; j < kLanes; ++j) ps[j] = pq[j] = 0.0f;
      for (int g = 0; g < kGroups && p + 3 * P < p1; ++g) {
        uint4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = __ldg(reinterpret_cast<const uint4*>(src + u * step));
        float f0[kLanes], f1[kLanes], f2[kLanes], f3[kLanes];
        widen(v[0], f0);
        widen(v[1], f1);
        widen(v[2], f2);
        widen(v[3], f3);
#pragma unroll
        for (int j = 0; j < kLanes; ++j) {
          // squares of bf16 values are exact in fp32
          ps[j] += (f0[j] + f1[j]) + (f2[j] + f3[j]);
          pq[j] += fmaf(f0[j], f0[j], f1[j] * f1[j]) +
                   fmaf(f2[j], f2[j], f3[j] * f3[j]);
        }
        src += 4 * step;
        p += 4 * P;
      }
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        s[j] += ps[j];
        q[j] += pq[j];
      }
    }
    // the last zero to three pixels of this thread
    for (; p < p1; p += P, src += step) {
      float f[kLanes];
      widen(__ldg(reinterpret_cast<const uint4*>(src)), f);
#pragma unroll
      for (int j = 0; j < kLanes; ++j) {
        s[j] += f[j];
        q[j] = fmaf(f[j], f[j], q[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kLanes; ++j) {
    red[j * kStatsThreads + t] = s[j];
    red[(kLanes + j) * kStatsThreads + t] = q[j];
  }
  __syncthreads();
  // rows r and r + h hold the same channels (thread t + h * L); the
  // highest power of two below P first, then halving, row 0 last
  int h = 1;
  while (2 * h < P) h *= 2;
  for (; h > 0; h >>= 1) {
    if (r + h < P && r < h) {
#pragma unroll
      for (int i = 0; i < 2 * kLanes; ++i)
        red[i * kStatsThreads + t] += red[i * kStatsThreads + t + h * L];
    }
    __syncthreads();
  }
  if (r == 0) {
    float* row =
        out + ((long long)b * gridDim.x + slot) * 2 * C + k * kLanes;
    float4* o_s = reinterpret_cast<float4*>(row);
    float4* o_q = reinterpret_cast<float4*>(row + C);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      o_s[i] = make_float4(red[(4 * i) * kStatsThreads + t],
                           red[(4 * i + 1) * kStatsThreads + t],
                           red[(4 * i + 2) * kStatsThreads + t],
                           red[(4 * i + 3) * kStatsThreads + t]);
      o_q[i] = make_float4(red[(kLanes + 4 * i) * kStatsThreads + t],
                           red[(kLanes + 4 * i + 1) * kStatsThreads + t],
                           red[(kLanes + 4 * i + 2) * kStatsThreads + t],
                           red[(kLanes + 4 * i + 3) * kStatsThreads + t]);
    }
  }
}

}  // namespace
}  // namespace cf

// C entry. x: (B, HW, C) bf16, contiguous, 16-byte aligned, C a multiple
// of 8 with C / 8 <= 256; out: (B, slots, 2, C) fp32, 16-byte aligned.
// Slot s sums the pixels [s * slot_pixels, min(HW, (s + 1) *
// slot_pixels)): the slots must cover HW with none empty. Returns a
// cudaError_t value (cudaErrorInvalidValue for arguments it refuses).
extern "C" int cf_channel_stats(const void* x, void* out, int B, int HW,
                                int C, int slots, int slot_pixels,
                                int device, void* stream) {
  using namespace cf;
  if (B < 1 || HW < 1 || C < kLanes || C % kLanes ||
      C / kLanes > kStatsThreads || slots < 1 || slots > 65535 ||
      B > 65535 || slot_pixels < 1 ||
      (long long)slots * slot_pixels < HW ||
      (long long)(slots - 1) * slot_pixels >= HW ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  channel_stats_kernel<<<dim3(slots, B), kStatsThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<float*>(out), HW, C,
      slot_pixels);
  return static_cast<int>(cudaGetLastError());
}
