// K3: the VQ nearest-code search -- for each token z_t the index
// argmin_j (|e_j|^2 - 2 z_t . e_j) over a K-row codebook, all in fp32, ties
// to the lowest j (as jnp.argmin and torch.argmin). The T x K distance
// matrix never reaches device memory.
//
// Replaces the TPU kernel codeformer_tpu/ops/vq.py `_nearest_code_pallas`.
//
// z: (T, D) fp32, e: (K, D) fp32, e_sq: (K,) fp32 = sum(e^2, 1),
// keys: (T,) 64-bit scratch, out: (T,) int32.
//
// What bounds it on the H100: 2*T*K*D FLOP on (T + K)*D floats read; at the
// stage-II shape (T = 1024, K = 1024, D = 256) 537 MFLOP on 2 MB, so not
// HBM. No tensor cores and no TF32: ties and near-ties must follow fp32
// (docs/architecture.md), so the products run on the fp32 FFMA pipe
// (67 TFLOP/s), and in this first design the shared-memory reads feeding
// it (one LDS for every two FFMA) are the limit.
//
// Design: a block owns 64 tokens and a contiguous range of codes. It walks
// the range in tiles of 64 codes and D in chunks of 32, staging the z and e
// chunks in shared memory transposed ([d][row], row stride 65: conflict-free
// stores, broadcast or consecutive reads). Each of the 256 threads keeps a
// 4 x 4 register tile (tokens ty + 16i, codes tx + 16j) of fp32 FFMA dot
// products and a running (min, argmin) per token, replaced only on a strict
// < as its codes ascend, so a thread keeps the lowest index of a tie. The 16
// threads that share a token then reduce their candidates as 64-bit keys,
// the order-preserving bits of the distance above the code index: unsigned
// order of keys is the lexicographic order of (distance, index). One thread
// per token folds the block's key into keys[t] with atomicMin. A minimum does
// not depend on the order blocks finish in, so the result is deterministic
// and ties go to the lowest index across blocks too. The code range is split
// over blockIdx.y so that a small T still fills the card. A second kernel
// turns the keys into int32 indices.
#include <cuda_runtime.h>
#include <stdint.h>

namespace cf {
namespace {

constexpr int kNcThreads = 256;  // 16 x 16
constexpr int kTok = 64;         // tokens per block
constexpr int kCodes = 64;       // codes per tile
constexpr int kDk = 32;          // D per staged chunk
constexpr int kLd = kTok + 1;    // staged row stride (floats)

// (d, j) -> a key whose unsigned order is the order of d, then of j.
__device__ __forceinline__ unsigned long long pack_key(float d, int j) {
  // +0 and -0 are equal distances: give both the bits of +0
  unsigned u = __float_as_uint(d == 0.0f ? 0.0f : d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(j);
}

__global__ void __launch_bounds__(kNcThreads)
nearest_code_kernel(const float* __restrict__ z, const float* __restrict__ e,
                    const float* __restrict__ e_sq,
                    unsigned long long* __restrict__ keys, int T, int K,
                    int D, int codes_per_split) {
  __shared__ float zs[kDk][kLd];
  __shared__ float es[kDk][kLd];
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int t0 = blockIdx.x * kTok;
  const int k_begin = blockIdx.y * codes_per_split;
  const int k_end = min(K, k_begin + codes_per_split);

  float best_d[4];
  int best_j[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    best_d[i] = 0.0f;
    best_j[i] = -1;
  }

  for (int c0 = k_begin; c0 < k_end; c0 += kCodes) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

    for (int d0 = 0; d0 < D; d0 += kDk) {
      __syncthreads();
      // row-major global reads (32 consecutive floats a warp), transposed
      // stores; out-of-range tokens, codes and dims stage 0
      for (int r = tid; r < kTok * kDk; r += kNcThreads) {
        const int c = r % kDk;
        const int row = r / kDk;
        const int d = d0 + c;
        const int t = t0 + row;
        const int j = c0 + row;
        zs[c][row] = (t < T && d < D) ? z[static_cast<size_t>(t) * D + d]
                                      : 0.0f;
        es[c][row] = (j < k_end && d < D) ? e[static_cast<size_t>(j) * D + d]
                                          : 0.0f;
      }
      __syncthreads();
#pragma unroll 8
      for (int c = 0; c < kDk; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = zs[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = es[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    // this thread's codes ascend with j and with c0: a strict < keeps the
    // lowest index of a tie. 2 * dot is exact, so fmaf rounds once, as
    // e_sq - 2 * dot does in the plain version.
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int code = c0 + tx + 16 * j;
      if (code < k_end) {
        const float esq = e_sq[code];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float d = fmaf(-2.0f, acc[i][j], esq);
          if (best_j[i] < 0 || d < best_d[i]) {
            best_d[i] = d;
            best_j[i] = code;
          }
        }
      }
    }
  }

  // the 16 threads of a token are the 16 lanes of one half-warp
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned long long key =
        best_j[i] < 0 ? ~0ull : pack_key(best_d[i], best_j[i]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, key, off);
      key = other < key ? other : key;
    }
    const int t = t0 + ty + 16 * i;
    if (tx == 0 && t < T) atomicMin(keys + t, key);
  }
}

__global__ void keys_to_index(const unsigned long long* __restrict__ keys,
                              int* __restrict__ out, int T) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < T) out[t] = static_cast<int>(keys[t] & 0xffffffffull);
}

}  // namespace
}  // namespace cf

// C entry. keys: T 64-bit words of scratch, out: T int32. T, K > 0.
// Returns a cudaError_t.
extern "C" int cf_nearest_code(const void* z, const void* e, const void* e_sq,
                               void* keys, void* out, int T, int K, int D,
                               int device, void* stream) {
  using namespace cf;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // all ones: the largest key, above every candidate
  err = cudaMemsetAsync(keys, 0xff, static_cast<size_t>(T) * 8, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  // split the codes until there are about two blocks an SM
  const int tok_tiles = (T + kTok - 1) / kTok;
  const int code_tiles = (K + kCodes - 1) / kCodes;
  int splits = (2 * sms + tok_tiles - 1) / tok_tiles;
  splits = splits < 1 ? 1 : (splits > code_tiles ? code_tiles : splits);
  const int tiles_per_split = (code_tiles + splits - 1) / splits;
  splits = (code_tiles + tiles_per_split - 1) / tiles_per_split;
  const dim3 grid(tok_tiles, splits);
  nearest_code_kernel<<<grid, kNcThreads, 0, s>>>(
      static_cast<const float*>(z), static_cast<const float*>(e),
      static_cast<const float*>(e_sq),
      static_cast<unsigned long long*>(keys), T, K, D,
      tiles_per_split * kCodes);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  keys_to_index<<<(T + 255) / 256, 256, 0, s>>>(
      static_cast<const unsigned long long*>(keys), static_cast<int*>(out),
      T);
  return static_cast<int>(cudaGetLastError());
}
