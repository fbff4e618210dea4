// The Hopper conv core: an implicit-GEMM 3x3 conv, NHWC bf16 in and out,
// fp32 sums, on TMA, mbarriers and wgmma. Two kernels run on it:
// conv3x3_bias.cu (stride 1, SAME zero padding) and downsample_dots.cu
// (stride 2, zero padding on the bottom and the right only).
//
// GEMM view: M = output pixels, N = output channels, K = 9 taps x input
// channels. A tile is TH x TW output pixels (TW = 16, TH = 8 * MB); a
// block owns one N slice of BN channels and one share of the input
// channels (a split), and walks tiles.
//
// What bounds it on the H100: at 512^2 with Cin = Cout = 64 a pixel costs
// 73.7 kFLOP against 256 bytes of HBM traffic, right at the card's bf16
// ridge (~295 FLOP/byte); at 128 and 256 channels the call is bound by the
// tensor cores. So the products must run at a good share of the tensor
// rate while every input byte comes from HBM about once.
//
// What the design does about it:
//  - Input windows by TMA. One tensor map over x, dims (C, W, H, B), box
//    (64 channels, BW, BH, 1): one request stages a tile's whole input
//    window for one 64-channel chunk, in the 128-byte swizzled layout.
//    Coordinates outside the tensor read zero (FLOAT_OOB_FILL_NONE): that
//    is the SAME halo (negative coordinates), K2's bottom/right pad (past
//    the last row or column) and the tail of a Cin that is no multiple
//    of 64.
//  - A from registers. Each consumer warp ldmatrix-es its 16-row A
//    fragment at the tap's pixel offset, (y+dy, x+dx) or (2y+dy, 2x+dx),
//    undoing the swizzle in the address: the window is read nine times
//    from shared memory, never again from L2. A wgmma descriptor could
//    read A from shared memory only where a tap's 64 rows are consecutive
//    window rows (a one-row tile) and at a start that is no multiple of 8
//    rows of the swizzle; ldmatrix takes any 16-byte-aligned row address,
//    so stride 2 costs nothing extra, and K1's prologue can later act on
//    these registers.
//  - B from shared memory, loaded once per block. The block's weight slab
//    (its chunks x 9 taps x BN rows x 64 channels, pre-swizzled by the
//    wrapper) is copied in by bulk copies at the start and read by wgmma
//    descriptors for the block's whole life.
//  - A persistent grid with a ring. One thread of a producer warpgroup
//    keeps up to `stages` windows in flight (full/empty mbarrier pairs,
//    the phase flipping each round), so the next tile's window loads
//    while two consumer warpgroups multiply the current one and store the
//    last. The producer warpgroup hands its registers to the consumers
//    (setmaxnreg): at 168 registers a thread, the ceiling of 384 threads,
//    the MB = 2 variants spilled; at 232 they do not.
//  - The epilogue works in registers: bias in fp32, one bf16 rounding,
//    16-byte stores after a transpose inside each quad of lanes. A split
//    over input chunks (small maps, to fill the card) writes fp32
//    partials that a second kernel sums in split order: no float
//    atomics, so the result is deterministic.
// The plan (TH, BN, split, stages, shared memory, grid) is chosen in
// Python (ops/conv3x3.py conv_plan); this file only checks it.
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cf {
namespace sm90 {

constexpr int kConsumerWarps = 8;                       // two warpgroups
constexpr int kThreads = kConsumerWarps * 32 + 128;     // + a producer warpgroup
// setmaxnreg: the producer warpgroup gives its registers to the consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int TW = 16;          // output columns per tile: one warp's A rows
constexpr int KC = 64;          // input channels per chunk: 128 B, the swizzle span
constexpr int kRowBytes = KC * 2;
constexpr int kSmemLimit = 232448;                      // opt-in maximum a block
constexpr int kAlignSlack = 1024;                       // 1024-B alignment of the base
constexpr int kBarrierBytes = 128;

__host__ __device__ constexpr int win_w(int stride) {
  return stride == 1 ? TW + 2 : 2 * TW + 1;
}
__host__ __device__ constexpr int win_h(int stride, int th) {
  return stride == 1 ? th + 2 : 2 * th + 1;
}
// bytes of one staged window (the TMA box) and of its ring slot
__host__ __device__ constexpr int box_bytes(int stride, int th) {
  return win_w(stride) * win_h(stride, th) * kRowBytes;
}
__host__ __device__ constexpr int slot_bytes(int stride, int th) {
  return (box_bytes(stride, th) + 1023) / 1024 * 1024;
}
// output rows of a tile: MB m64 blocks of 4 rows for each of the two
// consumer warpgroups
__host__ __device__ constexpr int tile_h(int mb) { return 8 * mb; }

struct Args {
  const __nv_bfloat16* w;   // (nch, 9, CoutP, 64) bf16, rows swizzled
  const float* bias;        // (CoutP,) fp32
  __nv_bfloat16* y;         // (B, Ho, Wo, Cout) bf16
  float* ws;                // (split, B*Ho*Wo, CoutP) fp32 partials, split > 1
  long long pixels;         // B * Ho * Wo
  int Ho, Wo, Cout, CoutP;
  int cps;                  // input chunks per split
  int n_slices;             // CoutP / BN
  int tiles_x, tiles_y, n_tiles;
  int stages, w_bytes;
};

// ------------------------------------------------------------------ PTX
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait that
// lasts some ten seconds (a lost arrival or a stale phase) traps, so the
// launch fails with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long t0 = 0;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (t0 == 0) {
      t0 = clock64();
    } else if (clock64() - t0 > 20000000000LL) {
      __trap();
    }
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keep a register live (and unmoved) up to this point: the registers a
// wgmma in flight reads or writes must not be reused before its wait.
__device__ __forceinline__ void reg_fence(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void reg_fence(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// wgmma descriptor of a K-major operand in the 128-byte swizzled layout:
// rows of 128 B, 8-row atoms 1024 B apart (SBO), atoms 1024-B aligned.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// D(64 x N, fp32) += A(64 x 16, bf16, registers) * B(16 x N, bf16, smem)
template <int N>
struct Wgmma;

template <>
struct Wgmma<8> {
  __device__ static __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, %8, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<16> {
  __device__ static __forceinline__ void mma(float (&d)[8], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, "
        "{%8, %9, %10, %11}, %12, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<32> {
  __device__ static __forceinline__ void mma(float (&d)[16], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15}, "
        "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ static __forceinline__ void mma(float (&d)[32], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31}, "
        "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  __device__ static __forceinline__ void mma(float (&d)[64], const uint32_t (&a)[4],
                                             uint64_t desc, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7,"
        " %8, %9, %10, %11, %12, %13, %14, %15,"
        " %16, %17, %18, %19, %20, %21, %22, %23,"
        " %24, %25, %26, %27, %28, %29, %30, %31,"
        " %32, %33, %34, %35, %36, %37, %38, %39,"
        " %40, %41, %42, %43, %44, %45, %46, %47,"
        " %48, %49, %50, %51, %52, %53, %54, %55,"
        " %56, %57, %58, %59, %60, %61, %62, %63}, "
        "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
  }
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// ------------------------------------------------------------- the kernel
template <int STRIDE, int BN, int MB>
__global__ void __launch_bounds__(kThreads, 1)
conv_sm90_kernel(const __grid_constant__ CUtensorMap xmap, const Args a) {
  constexpr int TH = tile_h(MB);
  constexpr int BW = win_w(STRIDE);
  constexpr int BOX = box_bytes(STRIDE, TH);
  constexpr int SLOT = slot_bytes(STRIDE, TH);
  constexpr int NR = BN / 2;          // accumulator registers per m64 block
  constexpr int TAP_BYTES = BN * kRowBytes;

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t w_s = base;
  const uint32_t win_s = base + a.w_bytes;
  const uint32_t bars = win_s + a.stages * SLOT;
  // full[i] at bars + 8i, empty[i] at bars + 8 (stages + i), weights last
  const uint32_t wbar = bars + 16 * a.stages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = blockIdx.y % a.n_slices;
  const int split = blockIdx.y / a.n_slices;
  const int n0 = slice * BN;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (a.stages + i), kConsumerWarps);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumerWarps * 32) {
      mbar_expect_tx(wbar, a.w_bytes);
      for (int cl = 0; cl < a.cps; ++cl)
        for (int t = 0; t < 9; ++t)
          bulk_load(w_s + (cl * 9 + t) * TAP_BYTES,
                    a.w + ((size_t)((split * a.cps + cl) * 9 + t) * a.CoutP +
                           n0) * KC,
                    TAP_BYTES, wbar);
      int stage = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
        const int tx = tile % a.tiles_x;
        const int ty = (tile / a.tiles_x) % a.tiles_y;
        const int b = tile / (a.tiles_x * a.tiles_y);
        const int wx = STRIDE == 1 ? tx * TW - 1 : 2 * tx * TW;
        const int wy = STRIDE == 1 ? ty * TH - 1 : 2 * ty * TH;
        for (int cl = 0; cl < a.cps; ++cl) {
          const uint32_t full = bars + 8 * stage;
          mbar_wait(bars + 8 * (a.stages + stage), phase ^ 1);
          mbar_expect_tx(full, BOX);
          tma_load_4d(win_s + stage * SLOT, &xmap, full,
                      (split * a.cps + cl) * KC, wx, wy, b);
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
  const int wg = warp >> 2;      // warpgroup
  const int wl = warp & 3;       // warp in the warpgroup: 16 rows of each m64
  const int q = lane & 3;
  const int rwg = wg * MB;       // the warpgroup's first m64 block
  // this lane's ldmatrix row: output column lane & 15 of output row
  // (rwg + mb) * 4 + wl; lanes 16-31 address the upper 8 channels of
  // each k16 step
  const int hi = lane >> 4;
  int row0[MB];
#pragma unroll
  for (int mb = 0; mb < MB; ++mb)
    row0[mb] = (((rwg + mb) * 4 + wl) * STRIDE) * BW + (lane & 15) * STRIDE;

  float bv[BN / 4];              // this lane's bias columns, fp32
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    bv[2 * j] = a.bias[n0 + 8 * j + 2 * q];
    bv[2 * j + 1] = a.bias[n0 + 8 * j + 2 * q + 1];
  }

  mbar_wait(wbar, 0);
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
    float acc[MB][NR];
    for (int cl = 0; cl < a.cps; ++cl) {
      mbar_wait(bars + 8 * stage, phase);
      const uint32_t win = win_s + stage * SLOT;
      const uint32_t wts = w_s + cl * 9 * TAP_BYTES;
      uint32_t af[2][4][MB][4];   // [tap parity][k16 step][m64 block][reg]
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int p = t & 1;
        const int off = (t / 3) * BW + (t % 3);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb) {
          const int r = row0[mb] + off;
          const uint32_t row = win + r * kRowBytes;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            ldsm_x4(af[p][kk][mb], row + (((2 * kk + hi) ^ (r & 7)) << 4));
        }
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t desc = desc_sw128(wts + t * TAP_BYTES + kk * 32);
          // the tile's first product overwrites the accumulator
          const int keep = (t > 0 || kk > 0 || cl > 0) ? 1 : 0;
#pragma unroll
          for (int mb = 0; mb < MB; ++mb)
            Wgmma<BN>::mma(acc[mb], af[p][kk][mb], desc, keep);
        }
        wgmma_commit();
        wgmma_wait<1>();
        // the products of tap t-1 are done: their A registers may go
        if (t > 0) {
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int mb = 0; mb < MB; ++mb)
#pragma unroll
              for (int r = 0; r < 4; ++r) reg_fence(af[p ^ 1][kk][mb][r]);
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int r = 0; r < 4; ++r) reg_fence(af[0][kk][mb][r]);
#pragma unroll
      for (int mb = 0; mb < MB; ++mb)
#pragma unroll
        for (int r = 0; r < NR; ++r) reg_fence(acc[mb][r]);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (a.stages + stage));
      if (++stage == a.stages) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: thread holds rows lane/4 and lane/4 + 8 of its warp's 16,
    // columns 8j + 2q, +1 of every n8 block j (the wgmma D layout)
    const int tx = tile % a.tiles_x;
    const int ty = (tile / a.tiles_x) % a.tiles_y;
    const int b = tile / (a.tiles_x * a.tiles_y);
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int oy = ty * TH + (rwg + mb) * 4 + wl;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ox = tx * TW + (lane >> 2) + 8 * i;
        const bool ok = oy < a.Ho && ox < a.Wo;
        const long long pix = ((long long)b * a.Ho + oy) * a.Wo + ox;
        if (a.ws != nullptr) {
          // fp32 partial of this split, every padded column
          if (ok) {
            float* dst = a.ws + ((long long)split * a.pixels + pix) * a.CoutP +
                         n0 + 2 * q;
#pragma unroll
            for (int j = 0; j < BN / 8; ++j)
              *reinterpret_cast<float2*>(dst + 8 * j) =
                  make_float2(acc[mb][4 * j + 2 * i], acc[mb][4 * j + 2 * i + 1]);
          }
        } else if constexpr (BN >= 32) {
          // 4 n8 blocks at a time: a transpose inside the quad gives lane
          // q the 8 channels of block 4g + q, stored as 16 bytes
#pragma unroll
          for (int g = 0; g < BN / 32; ++g) {
            uint32_t v[4], rot[4];
#pragma unroll
            for (int jj = 0; jj < 4; ++jj) {
              const int j = 4 * g + jj;
              v[jj] = pack_bf16x2(acc[mb][4 * j + 2 * i] + bv[2 * j],
                                  acc[mb][4 * j + 2 * i + 1] + bv[2 * j + 1]);
            }
#pragma unroll
            for (int s = 0; s < 4; ++s)
              rot[s] = __shfl_sync(0xffffffffu, pick4(v, (q - s) & 3),
                                   (lane & ~3) | ((q + s) & 3));
            // rot[s] is block 4g + q's pair of lane (q + s) & 3
            const uint4 o = make_uint4(pick4(rot, (0 - q) & 3),
                                       pick4(rot, (1 - q) & 3),
                                       pick4(rot, (2 - q) & 3),
                                       pick4(rot, (3 - q) & 3));
            const int nb = n0 + 8 * (4 * g + q);
            if (ok && nb < a.Cout)
              *reinterpret_cast<uint4*>(a.y + pix * a.Cout + nb) = o;
          }
        } else {
          if (ok) {
#pragma unroll
            for (int j = 0; j < BN / 8; ++j) {
              const int n = n0 + 8 * j + 2 * q;
              const float v0 = acc[mb][4 * j + 2 * i] + bv[2 * j];
              const float v1 = acc[mb][4 * j + 2 * i + 1] + bv[2 * j + 1];
              __nv_bfloat16* dst = a.y + pix * a.Cout + n;
              if ((a.Cout & 1) == 0 && n + 1 < a.Cout) {
                *reinterpret_cast<uint32_t*>(dst) = pack_bf16x2(v0, v1);
              } else {
                if (n < a.Cout) dst[0] = __float2bfloat16_rn(v0);
                if (n + 1 < a.Cout) dst[1] = __float2bfloat16_rn(v1);
              }
            }
          }
        }
      }
    }
  }
}

// The second pass of a split: y = bf16(sum over splits in order + bias).
static __global__ void split_sum_kernel(const float* __restrict__ ws,
                                 const float* __restrict__ bias,
                                 __nv_bfloat16* __restrict__ y,
                                 long long pixels, int Cout, int CoutP,
                                 int split) {
  const long long total = pixels * Cout;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long pix = e / Cout;
    const int n = static_cast<int>(e - pix * Cout);
    float v = 0.0f;
    for (int s = 0; s < split; ++s)
      v += ws[((long long)s * pixels + pix) * CoutP + n];
    y[e] = __float2bfloat16_rn(v + bias[n]);
  }
}

// ------------------------------------------------------------------ host
template <int STRIDE>
using KernelFn = void (*)(const CUtensorMap, const Args);

template <int STRIDE, int BN, int MB>
inline bool pick(int bn, int mb, KernelFn<STRIDE>* fn) {
  if (bn != BN || mb != MB) return false;
  *fn = conv_sm90_kernel<STRIDE, BN, MB>;
  return true;
}

// The kernel variants a plan may name: ops/conv3x3.py VARIANTS.
template <int STRIDE>
KernelFn<STRIDE> variant(int bn, int mb) {
  KernelFn<STRIDE> fn = nullptr;
  if constexpr (STRIDE == 1) {
    pick<1, 128, 1>(bn, mb, &fn) || pick<1, 64, 2>(bn, mb, &fn) ||
        pick<1, 64, 1>(bn, mb, &fn) || pick<1, 32, 1>(bn, mb, &fn) ||
        pick<1, 16, 1>(bn, mb, &fn) || pick<1, 8, 2>(bn, mb, &fn);
  } else {
    pick<2, 128, 1>(bn, mb, &fn) || pick<2, 64, 1>(bn, mb, &fn) ||
        pick<2, 32, 1>(bn, mb, &fn) || pick<2, 16, 1>(bn, mb, &fn);
  }
  return fn;
}

// Encode the tensor map of x (B, H, W, Cin) bf16 for this window's box.
inline CUresult encode_input(CUtensorMap* map, const void* x, int B, int H,
                             int W, int Cin, int stride, int th) {
  const cuuint64_t dims[4] = {(cuuint64_t)Cin, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)Cin * 2,
                                 (cuuint64_t)W * Cin * 2,
                                 (cuuint64_t)H * W * Cin * 2};
  const cuuint32_t box[4] = {(cuuint32_t)KC, (cuuint32_t)win_w(stride),
                             (cuuint32_t)win_h(stride, th), 1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(x), dims,
      strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// Check the plan, encode the map, launch (and the split's second pass).
// Returns a cudaError_t value, or -(CUresult) when the encode fails.
template <int STRIDE>
int run_conv(const void* x, const void* w, const void* bias, void* y,
             void* ws, int B, int H, int W, int Cin, int Cout, int CoutP,
             int bn, int mb, int split, int stages, int smem,
             int grid_x, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int Ho = STRIDE == 1 ? H : H / 2;
  const int Wo = STRIDE == 1 ? W : W / 2;
  const int nch = (Cin + KC - 1) / KC;
  const int th = tile_h(mb);
  const KernelFn<STRIDE> fn = variant<STRIDE>(bn, mb);
  if (fn == nullptr || B < 1 || Ho < 1 || Wo < 1 ||
      Cin < 32 || Cin % 32 || Cout < 1 || Cout > CoutP || CoutP % bn ||
      split < 1 || nch % split || (split > 1) != (ws != nullptr) ||
      stages < 2 || grid_x < 1 || (bn >= 32 && Cout % 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cps = nch / split;
  const int w_bytes = cps * 9 * bn * kRowBytes;
  const long long need = (long long)kAlignSlack + w_bytes +
                         (long long)stages * slot_bytes(STRIDE, th) +
                         kBarrierBytes;
  if (smem < need || smem > kSmemLimit || 16 * stages + 8 > kBarrierBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map;
  const CUresult cr = encode_input(&map, x, B, H, W, Cin, STRIDE, th);
  if (cr != CUDA_SUCCESS) return -static_cast<int>(cr);
  Args a;
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
  a.ws = static_cast<float*>(ws);
  a.pixels = (long long)B * Ho * Wo;
  a.Ho = Ho;
  a.Wo = Wo;
  a.Cout = Cout;
  a.CoutP = CoutP;
  a.cps = cps;
  a.n_slices = CoutP / bn;
  a.tiles_x = (Wo + TW - 1) / TW;
  a.tiles_y = (Ho + th - 1) / th;
  a.n_tiles = B * a.tiles_x * a.tiles_y;
  a.stages = stages;
  a.w_bytes = w_bytes;
  // set on every launch: the attribute belongs to the current device
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fn<<<dim3(grid_x, a.n_slices * split), kThreads, smem, s>>>(map, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  split_sum_kernel<<<1024, 256, 0, s>>>(a.ws, a.bias, a.y, a.pixels, Cout,
                                        CoutP, split);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace cf
