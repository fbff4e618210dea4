// K3: the VQ nearest-code search -- for each token z_t the index
// argmin_j (|e_j|^2 - 2 z_t . e_j) over a K-row codebook, all in fp32, ties
// to the lowest j (as jnp.argmin and torch.argmin). The T x K distance
// matrix never reaches device memory.
//
// Replaces the TPU kernel codeformer_tpu/ops/vq.py `_nearest_code_pallas`.
//
// z: (T, D) fp32 or bf16, row-major, D a multiple of 8 (Dp at most 384:
// a block keeps its z rows in shared memory); et: the codebook transposed
// and zero-padded, (Dp, Kp) fp32 with Dp a multiple of kDk and Kp of kCodes;
// e_sq: (Kp,) fp32 = sum(e^2, 1); out: (T,) int64. The wrapper
// (ops/vq.py) keeps et and e_sq for each codebook until it changes, and
// chooses the cluster size (`k3_plan`); this file only checks it.
//
// What bounds it on the H100: 2*T*K*D FLOP on (T + K)*D floats read; at the
// stage-II shape (T = 1024, K = 1024, D = 256) 537 MFLOP on 2 MB, so the
// fp32 FFMA pipe (67 TFLOP/s), not HBM. No tensor cores and no TF32: ties
// and near-ties must follow fp32 (docs/architecture.md).
//
// Design, one launch a call:
//  * A block owns 64 tokens and one or more tiles of 128 codes. Its 256
//    threads are two groups of 128 that split each staged D chunk in two
//    halves; in a group, thread (tr, tc) keeps an 8 x 8 register tile of
//    dot products: tokens tr + 8i, codes 4tc..4tc+3 and 64+4tc..64+4tc+3.
//    Each 4-wide step of D reads 8 float4 of codes and 8 vectors of 4
//    tokens' values (LDS.128 for fp32 z, LDS.64 for bf16) for 256 FFMA:
//    one shared-memory load feeds 16 multiply-adds.
//  * D is walked in chunks of 64 through a ring of kStages slots of codes
//    in dynamic shared memory, filled with cp.async (16 bytes a copy), so
//    the next chunks load while this one is multiplied. The block's z rows
//    are staged chunk by chunk beside the first code tile's (zero fill
//    past T and D) and kept for its other tiles. z stays token-major (rows
//    padded against bank conflicts); the codebook operand is the cached
//    transpose, so both copy straight without a transposing pass. bf16 z
//    is staged as it is and widened exactly (a 16-bit shift) when read.
//  * At the end of a code tile the second group hands its partial sums to
//    the first through shared memory; the first adds them, forms
//    fmaf(-2, dot, e_sq) (2 * dot is exact, so it rounds once, as the
//    plain version's e_sq - 2 * dot) and keeps a running (min, argmin) per
//    token, replaced only on a strict < as its codes ascend, so a thread
//    keeps the lowest index of a tie. Codes past K never take part.
//  * The code tiles of one token tile are dealt round the blocks of a
//    thread-block cluster (cluster rank r takes tiles r, r + cs, ...). The
//    cluster size cs (1, 2, 4 or 8) is the wrapper's: a small T spreads
//    the codes over up to 8 blocks to fill the card, a large T gives a
//    block all of them (clusters of 8 leave 12 SMs of 132 idle). The
//    16 threads of a token fold their candidates as 64-bit keys, the
//    order-preserving bits of the distance above the code index: unsigned
//    order of keys is the lexicographic order of (distance, index). Each
//    block leaves its 64 keys in its own shared memory; after a cluster
//    barrier rank 0 reads all the ranks' keys through distributed shared
//    memory, takes the minimum and writes out[t] as int64. A minimum does
//    not depend on the order the blocks finish in, so the result is
//    deterministic and ties go to the lowest index across blocks too. A
//    second cluster barrier keeps every block's keys alive until rank 0
//    has read them. No atomics, no scratch, no second kernel.
//
// What holds it back (kernels/nearest_code_probe.py, PERF.md): the FFMA
// alone, with no loads, issues at about two thirds of the fp32 peak; the
// shared-memory loads and the staging take most of the rest.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace cf {
namespace {

constexpr int kNcThreads = 256;   // two groups of 128
constexpr int kGroup = 128;
constexpr int kTok = 64;          // tokens per block
constexpr int kCodes = 128;       // codes per tile
constexpr int kDk = 64;           // D per staged chunk
constexpr int kHalf = kDk / 2;    // D per group in a chunk
constexpr int kStages = 3;
constexpr int kMaxCluster = 8;
constexpr int kMaxSmem = 232448;  // the H100's opt-in maximum a block
constexpr int kEBytes = kDk * kCodes * 4;     // a ring slot: a code chunk
constexpr int kXchg = kTok * kCodes * 4;      // the second group's sums

// Shared memory: the block's z rows [kTok][Dp] (kept for all its code
// tiles), the ring of code chunks, the exchange and the keys. A z row has
// 16 bytes of padding, so the two token rows a warp reads at once fall
// in different banks.
template <typename Tz>
__host__ __device__ constexpr int z_row_bytes(int Dp) {
  return Dp * static_cast<int>(sizeof(Tz)) + 16;
}
template <typename Tz>
__host__ __device__ constexpr int smem_bytes(int Dp) {
  return kTok * z_row_bytes<Tz>(Dp) + kStages * kEBytes + kXchg + kTok * 8;
}

// (d, j) -> a key whose unsigned order is the order of d, then of j.
__device__ __forceinline__ unsigned long long pack_key(float d, int j) {
  // +0 and -0 are equal distances: give both the bits of +0
  unsigned u = __float_as_uint(d == 0.0f ? 0.0f : d);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(j);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(gmem), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four consecutive z values of one token row, widened to fp32
__device__ __forceinline__ void load_z4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
__device__ __forceinline__ void load_z4(const uint16_t* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

// Stage chunk `q` of this block's walk (code tile q / n_chunks of this
// rank, D chunk q % n_chunks): the codes into ring slot q % kStages and,
// on the first tile, the same D chunk of the z rows into their kept place.
template <typename Tz>
__device__ __forceinline__ void stage_chunk(
    unsigned char* zs, unsigned char* ring, int q, const Tz* __restrict__ z,
    const float* __restrict__ et, int T, int D, int Kp, int t0, int rank,
    int cs, int n_chunks, int z_row) {
  constexpr int kEpp = 16 / static_cast<int>(sizeof(Tz));  // z per copy
  constexpr int kZPieces = kTok * kDk / kEpp;
  constexpr int kEPieces = kDk * kCodes / 4;
  static_assert(kZPieces % kNcThreads == 0 && kEPieces % kNcThreads == 0,
                "every thread issues the same copies");
  const int d0 = (q % n_chunks) * kDk;
  const int c0 = (rank + (q / n_chunks) * cs) * kCodes;
  if (q < n_chunks) {
#pragma unroll
    for (int n = 0; n < kZPieces / kNcThreads; ++n) {
      const int p = threadIdx.x + n * kNcThreads;
      const int row = p / (kDk / kEpp);
      const int d = d0 + (p % (kDk / kEpp)) * kEpp;
      const int t = t0 + row;
      const bool ok = t < T && d < D;    // D % kEpp == 0: a copy is all in
      cp_async16(zs + row * z_row + d * static_cast<int>(sizeof(Tz)),
                 ok ? static_cast<const void*>(z + static_cast<size_t>(t) * D
                                               + d)
                    : static_cast<const void*>(z),
                 ok ? 16 : 0);
    }
  }
  unsigned char* es = ring + (q % kStages) * kEBytes;
#pragma unroll
  for (int n = 0; n < kEPieces / kNcThreads; ++n) {
    const int p = threadIdx.x + n * kNcThreads;
    const int row = p / (kCodes / 4);
    const int c = (p % (kCodes / 4)) * 4;
    cp_async16(es + (row * kCodes + c) * 4,
               et + static_cast<size_t>(d0 + row) * Kp + c0 + c, 16);
  }
}

template <typename Tz>
__global__ void __launch_bounds__(kNcThreads, 1)
nearest_code_kernel(const Tz* __restrict__ z, const float* __restrict__ et,
                    const float* __restrict__ e_sq,
                    long long* __restrict__ out, int T, int K, int D, int Kp,
                    int Dp) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int z_row = z_row_bytes<Tz>(Dp);
  unsigned char* ring = smem + kTok * z_row;
  float4* xchg = reinterpret_cast<float4*>(ring + kStages * kEBytes);
  unsigned long long* keys =
      reinterpret_cast<unsigned long long*>(ring + kStages * kEBytes + kXchg);

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int grp = tid / kGroup;          // which half of each chunk
  const int lt = tid % kGroup;
  const int tr = lt / 16;                // tokens tr + 8i
  const int tc = lt % 16;                // codes 4tc + j, 64 + 4tc + j
  const int t0 = blockIdx.x * kTok;
  const int n_chunks = Dp / kDk;
  const int n_tiles = Kp / kCodes;
  const int my_tiles = (n_tiles - rank + cs - 1) / cs;
  const int total = my_tiles * n_chunks;

  float acc[8][8];
  float best_d[8];
  int best_j[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    best_d[i] = 0.0f;
    best_j[i] = -1;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
  }

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < total)
      stage_chunk<Tz>(smem, ring, s, z, et, T, D, Kp, t0, rank, cs, n_chunks,
                      z_row);
    cp_async_commit();
  }
  for (int q = 0; q < total; ++q) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // chunk q is in; every thread is done with q - 1
    if (q + kStages - 1 < total)
      stage_chunk<Tz>(smem, ring, q + kStages - 1, z, et, T, D, Kp, t0, rank,
                      cs, n_chunks, z_row);
    cp_async_commit();

    const Tz* zs = reinterpret_cast<const Tz*>(smem) +
                   (q % n_chunks) * kDk + grp * kHalf;
    const float* es = reinterpret_cast<const float*>(
        ring + (q % kStages) * kEBytes) + grp * kHalf * kCodes;
    const int z_ld = z_row / static_cast<int>(sizeof(Tz));
    // unrolled twice: a little faster than rolled or fully unrolled at
    // every T (kernels/nearest_code_probe.py, PERF.md)
#pragma unroll 2
    for (int d = 0; d < kHalf; d += 4) {
      float a[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i) load_z4(zs + (tr + 8 * i) * z_ld + d, a[i]);
      float b[4][8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float4 lo =
            *reinterpret_cast<const float4*>(es + (d + k) * kCodes + 4 * tc);
        const float4 hi = *reinterpret_cast<const float4*>(
            es + (d + k) * kCodes + 64 + 4 * tc);
        b[k][0] = lo.x; b[k][1] = lo.y; b[k][2] = lo.z; b[k][3] = lo.w;
        b[k][4] = hi.x; b[k][5] = hi.y; b[k][6] = hi.z; b[k][7] = hi.w;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            acc[i][j] = fmaf(a[i][k], b[k][j], acc[i][j]);
    }

    if (q % n_chunks == n_chunks - 1) {
      // the end of a code tile: the second group's sums to the first
      if (grp == 1) {
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h)
            xchg[(i * 2 + h) * kGroup + lt] =
                make_float4(acc[i][4 * h], acc[i][4 * h + 1],
                            acc[i][4 * h + 2], acc[i][4 * h + 3]);
      }
      __syncthreads();
      if (grp == 0) {
        const int c0 = (rank + (q / n_chunks) * cs) * kCodes;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4 o = xchg[(i * 2 + h) * kGroup + lt];
            acc[i][4 * h] += o.x;
            acc[i][4 * h + 1] += o.y;
            acc[i][4 * h + 2] += o.z;
            acc[i][4 * h + 3] += o.w;
          }
        // this thread's codes ascend with j and from tile to tile: a
        // strict < keeps the lowest index of a tie
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int code = c0 + (j < 4 ? 4 * tc + j : 64 + 4 * tc + j - 4);
          if (code < K) {
            const float esq = e_sq[code];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
              const float dist = fmaf(-2.0f, acc[i][j], esq);
              if (best_j[i] < 0 || dist < best_d[i]) {
                best_d[i] = dist;
                best_j[i] = code;
              }
            }
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }
  }

  // the 16 threads of a token are the 16 lanes of one half-warp
  if (grp == 0) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      unsigned long long key =
          best_j[i] < 0 ? ~0ull : pack_key(best_d[i], best_j[i]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        const unsigned long long other =
            __shfl_xor_sync(0xffffffffu, key, off);
        key = other < key ? other : key;
      }
      if (tc == 0) keys[tr + 8 * i] = key;
    }
  }
  cluster.sync();      // every rank's keys are in its shared memory
  if (rank == 0 && tid < kTok) {
    unsigned long long key = keys[tid];
    for (int r = 1; r < cs; ++r) {
      const unsigned long long other = *cluster.map_shared_rank(keys + tid, r);
      key = other < key ? other : key;
    }
    const int t = t0 + tid;
    if (t < T) out[t] = static_cast<long long>(key & 0xffffffffull);
  }
  cluster.sync();      // rank 0 has read them: the blocks may exit
}

template <typename Tz>
cudaLaunchConfig_t launch_config(int T, int Dp, int cs, cudaStream_t s,
                                 cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((T + kTok - 1) / kTok, cs, 1);
  cfg.blockDim = dim3(kNcThreads, 1, 1);
  cfg.dynamicSmemBytes = smem_bytes<Tz>(Dp);
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = cs;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// the most clusters of cs blocks the card holds at once, into *n
template <typename Tz>
cudaError_t resident(int Dp, int cs, int* n) {
  cudaError_t err = cudaFuncSetAttribute(
      nearest_code_kernel<Tz>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<Tz>(Dp));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg =
      launch_config<Tz>(kTok * 1024, Dp, cs, 0, attr);
  return cudaOccupancyMaxActiveClusters(n, nearest_code_kernel<Tz>, &cfg);
}

template <typename Tz>
cudaError_t launch(const void* z, const void* et, const void* e_sq, void* out,
                   int T, int K, int D, int Kp, int Dp, int cs,
                   cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      nearest_code_kernel<Tz>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes<Tz>(Dp));
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = launch_config<Tz>(T, Dp, cs, s, attr);
  return cudaLaunchKernelEx(&cfg, nearest_code_kernel<Tz>,
                            static_cast<const Tz*>(z),
                            static_cast<const float*>(et),
                            static_cast<const float*>(e_sq),
                            static_cast<long long*>(out), T, K, D, Kp, Dp);
}

}  // namespace
}  // namespace cf

// C entry. z_bf16: 1 if z is bf16, 0 if fp32. cluster: the blocks that
// share a token tile (ops/vq.py k3_plan), 1..8 and at most Kp / 128.
// Returns a cudaError_t; the launch's own error included.
extern "C" int cf_nearest_code(const void* z, int z_bf16, const void* et,
                               const void* e_sq, void* out, int T, int K,
                               int D, int Kp, int Dp, int cluster, int device,
                               void* stream) {
  using namespace cf;
  if (T <= 0 || K <= 0 || D <= 0 || D % 8 != 0 || Dp % kDk != 0 || Dp < D ||
      Kp % kCodes != 0 || Kp < K || cluster < 1 || cluster > kMaxCluster ||
      cluster > Kp / kCodes ||
      (z_bf16 ? smem_bytes<uint16_t>(Dp) : smem_bytes<float>(Dp)) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = z_bf16
            ? launch<uint16_t>(z, et, e_sq, out, T, K, D, Kp, Dp, cluster, s)
            : launch<float>(z, et, e_sq, out, T, K, D, Kp, Dp, cluster, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// How many clusters of `cluster` blocks (1..8) the card holds at once for
// the kernel of this z type (ops/vq.py k3_plan weighs the waves with it);
// a negative cudaError_t if the query fails.
extern "C" int cf_nearest_code_resident(int cluster, int z_bf16, int Dp,
                                        int device) {
  using namespace cf;
  if (cluster < 1 || cluster > kMaxCluster || Dp <= 0 || Dp % kDk != 0 ||
      (z_bf16 ? smem_bytes<uint16_t>(Dp) : smem_bytes<float>(Dp)) > kMaxSmem)
    return -static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  int n = 0;
  if (err == cudaSuccess)
    err = z_bf16 ? resident<uint16_t>(Dp, cluster, &n)
                 : resident<float>(Dp, cluster, &n);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
