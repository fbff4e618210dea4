// The Hopper conv core: an implicit-GEMM 3x3 conv, NHWC bf16 in and out,
// fp32 sums, on TMA, mbarriers and wgmma. Three kernels run on it:
// conv3x3_bias.cu (stride 1, SAME zero padding), downsample_dots.cu
// (stride 2, zero padding on the bottom and the right only) and K1,
// conv3x3_dots.cu (stride 1, FUSED: a GroupNorm-apply and activation
// prologue, a skip, the GroupNorm statistics of its output).
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
//    so stride 2 costs nothing extra.
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
//
// What FUSED (K1) adds, each stage once per window, not once per tap:
//  - A prologue stage. After a window lands, the producer warpgroup's
//    three warps that issue no TMA rewrite it in place in shared memory:
//    each 16-byte group becomes bf16(act(a * x + b)) with a, b of the
//    tile's image and the group's channels (a thread keeps one channel
//    group, so its a and b stay in registers; the swizzle is undone in
//    the address), and every window position whose pixel lies outside
//    the map is stored as 0: SAME pads the activated map, and TMA's zero
//    fill gives x = 0, where act(a * 0 + b) = act(b) != 0. Channels past
//    Cin get a = b = 0, so they come out 0 too. Each rewriting thread
//    then fences its generic-proxy stores against the async proxy
//    (fence.proxy.async.shared::cta) and arrives on the slot's `ready`
//    barrier, which the consumers wait on instead of `full`: TMA refills
//    the slot later, after the consumers release it, and without the
//    fence that refill may land out of order with the rewrite.
//    Why here and not on the A registers between ldmatrix and wgmma: the
//    registers hold each window element nine times, once per tap. SiLU
//    as v / (1 + exp(-v)) is two SFU operations (ex2, rcp); the SFU
//    retires about 16 results a clock on an SM against about 4,096 bf16
//    tensor FLOP. At BN = 64 one pixel's 64-channel chunk is 73.7 kFLOP,
//    about 18 tensor clocks, while a per-tap prologue is 9 * 64 * 2 / 16
//    = 72 SFU clocks, four times the products (twice at BN = 128). Once
//    per staged element it is (TH + 2) * 18 / (16 * TH) of the tile's
//    pixels, about 11 SFU clocks a pixel-chunk, done by warps that issue
//    no wgmma, so it overlaps the products of the previous window.
//  - The projected skip (Cs -> Cout) as one more K step a tile over the
//    RAW skip: a second tensor map whose box is the tile's TH x 16 centre
//    pixels (no halo, no prologue) feeds the same ring, and its weights
//    W1 (Cs / 64 chunks x BN rows x 128 B, swizzled) stay resident beside
//    the 3x3 slab.
//  - The identity skip, added in fp32 to acc + bias before the one bf16
//    rounding, as the plain version does. Its loads are issued when the
//    tile starts (volatile, into registers) and land while the tile's
//    products run: loaded in the epilogue they stalled every tile.
//  - The statistics [sum y, sum y^2] of the ROUNDED y, per tile and
//    channel: a thread sums its pixels, a butterfly over the 8 lanes of a
//    column, then one thread a channel sums the 8 warps in order. Pixels
//    outside the map add 0; no float atomics, so two runs agree bit for
//    bit. Slot (image, tile of the image): ops/conv3x3.py stats_slots.
//  - A split where wide inputs need it. Every block of a BN slice stages
//    and rewrites the same windows, so a narrow BN repeats the prologue
//    over many slices (it then bounds the block) and runs small
//    products. So K1's plan splits the input chunks until BN = 64 fits
//    with its resident weights; the blocks write fp32 partials (the
//    projected skip's chunks dealt round the splits) and dots_finish_kernel
//    sums them in split order, adds the bias and the identity skip,
//    rounds once and takes each tile's statistics.
// What bounds K1: at 512^2 with Cin = Cout = 64 and the identity skip a
// pixel costs 73.7 kFLOP against 384 bytes (x, skip, y), below the card's
// bf16 ridge, so HBM bounds it there; at 128 channels and up the tensor
// cores do. On the card neither bound is reached: the prologue stage is
// the slowest part of the pipe where a tile has one m64 block (TH = 8),
// about as fast as the products at TH = 16, and the statistics' two
// consumer barriers a tile cost some more (kernels/conv_sm90_probe.py
// times K1 with each of them taken out).
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
// K1's prologue: the producer warpgroup's warps 1-3 (warp 0 issues TMA)
constexpr int kPrologueThreads = 96;
// setmaxnreg: the producer warpgroup gives its registers to the
// consumers. The pool is 168 a thread (the ceiling of 384 threads); K1's
// prologue warps keep more of it than a bare TMA warp needs, and its
// consumers fit their accumulators, A registers and prefetched skip in
// 216 (ptxas reports no spills).
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr int kFusedProducerRegs = 72;
constexpr int kFusedConsumerRegs = 216;
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
// K1's per-warp statistics partials: [sum, sumsq] x BN fp32 a warp
__host__ __device__ constexpr int stats_bytes(int bn) {
  return kConsumerWarps * 2 * bn * 4;
}

enum { ACT_NONE = 0, ACT_SILU = 1 };
enum { SKIP_NONE = 0, SKIP_IDENTITY = 1, SKIP_PROJ = 2 };

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
  // FUSED (K1) only
  const float* ga;          // (B, Cin) fp32: the folded GroupNorm, a * x + b
  const float* gb;
  const __nv_bfloat16* skip_id;  // (B, Ho, Wo, Cout) identity skip, or null
  const __nv_bfloat16* w1;  // (s_chunks, CoutP, 64) bf16 1x1 weights, swizzled
  float* stats;             // (B, tiles_y * tiles_x, 2, Cout) fp32
  int Cin, act, s_chunks, w1_bytes;
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

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = v;
  return __bfloat1622float2(h);
}

__device__ __forceinline__ uint32_t pick4(const uint32_t (&v)[4], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : i == 2 ? v[2] : v[3];
}

// A 4 x 4 transpose of 32-bit words inside each quad of lanes: lane q's
// v[j] becomes lane j's word q. The epilogue stores with it (pairs of
// channels per n8 block -> 16 bytes of one block) and K1 loads its skip
// with it (the inverse, which is the same exchange).
__device__ __forceinline__ uint4 quad_transpose(const uint32_t (&v)[4],
                                                int lane) {
  const int q = lane & 3;
  uint32_t rot[4];
#pragma unroll
  for (int s = 0; s < 4; ++s)
    rot[s] = __shfl_sync(0xffffffffu, pick4(v, (q - s) & 3),
                         (lane & ~3) | ((q + s) & 3));
  // rot[s] is word q of lane (q + s) & 3
  return make_uint4(pick4(rot, (0 - q) & 3), pick4(rot, (1 - q) & 3),
                    pick4(rot, (2 - q) & 3), pick4(rot, (3 - q) & 3));
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// Global loads through the non-coherent path, volatile so they stay where
// they are written: K1 issues its skip's loads when a tile starts, and
// they land while the tile's products run.
__device__ __forceinline__ uint4 ldg_v4(const void* p) {
  uint4 v;
  asm volatile("ld.global.nc.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ uint32_t ldg_u32(const void* p) {
  uint32_t v;
  asm volatile("ld.global.nc.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}

__device__ __forceinline__ float lds_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ void sts_f32(uint32_t addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;" ::"r"(addr), "f"(v) : "memory");
}

// the two consumer warpgroups alone (named barrier 1; 0 is __syncthreads)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;" ::"n"(kConsumerWarps * 32) : "memory");
}

// 8 bf16 channels -> bf16(act(a * x + b)), fp32 in between
__device__ __forceinline__ uint4 affine_act8(uint4 raw, const float (&sa)[8],
                                             const float (&sb)[8], int act) {
  const uint32_t in[4] = {raw.x, raw.y, raw.z, raw.w};
  uint32_t out[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 v = unpack_bf16x2(in[i]);
    float v0 = fmaf(sa[2 * i], v.x, sb[2 * i]);
    float v1 = fmaf(sa[2 * i + 1], v.y, sb[2 * i + 1]);
    if (act == ACT_SILU) {
      v0 = __fdividef(v0, 1.0f + __expf(-v0));
      v1 = __fdividef(v1, 1.0f + __expf(-v1));
    }
    out[i] = pack_bf16x2(v0, v1);
  }
  return make_uint4(out[0], out[1], out[2], out[3]);
}

// Channels n, n + 1 (a packed bf16 pair) of one output pixel's row: those
// below Cout.
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int n,
                                           int cout, uint32_t v) {
  if ((cout & 1) == 0 && n + 1 < cout) {
    *reinterpret_cast<uint32_t*>(row + n) = v;
    return;
  }
  __nv_bfloat162 h;
  *reinterpret_cast<uint32_t*>(&h) = v;
  if (n < cout) row[n] = h.x;
  if (n + 1 < cout) row[n + 1] = h.y;
}

// K1's identity skip of one tile, loaded when the tile starts: skr[mb][i]
// holds, for BN >= 32, the 16 bytes of n8 block 4g + q as words 4g..4g+3
// (the epilogue transposes them inside the quad), else this lane's
// channel pair of each n8 block. Zero outside the map or without a skip.
template <int BN, int MB>
__device__ __forceinline__ void load_skip(const Args& a,
                                          uint32_t (&skr)[MB][2][BN / 8],
                                          int b, int tx, int ty, int n0,
                                          int lane, int rwg, int wl) {
  constexpr int TH = tile_h(MB);
  const int q = lane & 3;
#pragma unroll
  for (int mb = 0; mb < MB; ++mb) {
    const int oy = ty * TH + (rwg + mb) * 4 + wl;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int ox = tx * TW + (lane >> 2) + 8 * i;
      const bool ok = a.skip_id != nullptr && oy < a.Ho && ox < a.Wo;
      const __nv_bfloat16* row =
          a.skip_id + (((long long)b * a.Ho + oy) * a.Wo + ox) * a.Cout + n0;
      if constexpr (BN >= 32) {
#pragma unroll
        for (int g = 0; g < BN / 32; ++g) {
          const uint4 raw = ok ? ldg_v4(row + 8 * (4 * g + q))
                               : make_uint4(0u, 0u, 0u, 0u);
          skr[mb][i][4 * g] = raw.x;
          skr[mb][i][4 * g + 1] = raw.y;
          skr[mb][i][4 * g + 2] = raw.z;
          skr[mb][i][4 * g + 3] = raw.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
          skr[mb][i][j] = ok ? ldg_u32(row + 8 * j + 2 * q) : 0u;
      }
    }
  }
}

// K1's epilogue for one tile: y = bf16(acc + bias [+ identity skip, from
// load_skip]) with one rounding, and the tile's [sum, sumsq] of the
// rounded y per channel into stats slot (image, tile of the image). Every
// consumer thread calls it (two consumer barriers).
template <int BN, int MB>
__device__ __forceinline__ void fused_epilogue(
    const Args& a, const float (&acc)[MB][BN / 2], const float (&bv)[BN / 4],
    const uint32_t (&skr)[MB][2][BN / 8], int b, int tx, int ty, int tile,
    int n0, int warp, int lane, int rwg, int wl, uint32_t st_s) {
  constexpr int TH = tile_h(MB);
  constexpr int JG = BN >= 32 ? 4 : BN / 8;   // n8 blocks a group
  const int q = lane & 3;
  const uint32_t st_w = st_s + warp * 2 * BN * 4;   // this warp's partials
#pragma unroll
  for (int g = 0; g < BN / 8 / JG; ++g) {
    float s1[JG][2], s2[JG][2];
#pragma unroll
    for (int jj = 0; jj < JG; ++jj)
      s1[jj][0] = s1[jj][1] = s2[jj][0] = s2[jj][1] = 0.0f;
#pragma unroll
    for (int mb = 0; mb < MB; ++mb) {
      const int oy = ty * TH + (rwg + mb) * 4 + wl;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int ox = tx * TW + (lane >> 2) + 8 * i;
        const bool ok = oy < a.Ho && ox < a.Wo;
        const long long pix = ((long long)b * a.Ho + oy) * a.Wo + ox;
        // sk[jj]: this lane's channel pair of n8 block g * JG + jj
        uint32_t sk[4] = {0u, 0u, 0u, 0u};
        if (a.skip_id != nullptr) {
          if constexpr (BN >= 32) {
            // 16 bytes of block 4g + q, back to the D layout in the quad
            const uint32_t words[4] = {skr[mb][i][4 * g], skr[mb][i][4 * g + 1],
                                       skr[mb][i][4 * g + 2],
                                       skr[mb][i][4 * g + 3]};
            const uint4 t = quad_transpose(words, lane);
            sk[0] = t.x;
            sk[1] = t.y;
            sk[2] = t.z;
            sk[3] = t.w;
          } else {
#pragma unroll
            for (int jj = 0; jj < JG; ++jj) sk[jj] = skr[mb][i][g * JG + jj];
          }
        }
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < JG; ++jj) {
          const int j = g * JG + jj;
          float v0 = acc[mb][4 * j + 2 * i] + bv[2 * j];
          float v1 = acc[mb][4 * j + 2 * i + 1] + bv[2 * j + 1];
          if (a.skip_id != nullptr) {
            const float2 s = unpack_bf16x2(sk[jj]);
            v0 += s.x;
            v1 += s.y;
          }
          v[jj] = pack_bf16x2(v0, v1);
          if (ok) {   // the statistics of the rounded y
            const float2 r = unpack_bf16x2(v[jj]);
            s1[jj][0] += r.x;
            s2[jj][0] += r.x * r.x;
            s1[jj][1] += r.y;
            s2[jj][1] += r.y * r.y;
          }
        }
        if constexpr (BN >= 32) {
          const uint4 o = quad_transpose(v, lane);
          const int nb = n0 + 8 * (4 * g + q);
          if (ok && nb < a.Cout)
            *reinterpret_cast<uint4*>(a.y + pix * a.Cout + nb) = o;
        } else if (ok) {
#pragma unroll
          for (int jj = 0; jj < JG; ++jj)
            store_pair(a.y + pix * a.Cout, n0 + 8 * (g * JG + jj) + 2 * q,
                       a.Cout, v[jj]);
        }
      }
    }
    // the 8 lanes of a column (lane >> 2) into one sum: every lane of the
    // butterfly ends with the same bits
#pragma unroll
    for (int jj = 0; jj < JG; ++jj)
#pragma unroll
      for (int e = 0; e < 2; ++e)
#pragma unroll
        for (int off = 4; off < 32; off *= 2) {
          s1[jj][e] += __shfl_xor_sync(0xffffffffu, s1[jj][e], off);
          s2[jj][e] += __shfl_xor_sync(0xffffffffu, s2[jj][e], off);
        }
    if (lane < 4) {
#pragma unroll
      for (int jj = 0; jj < JG; ++jj)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = 8 * (g * JG + jj) + 2 * q + e;
          sts_f32(st_w + col * 4, s1[jj][e]);
          sts_f32(st_w + (BN + col) * 4, s2[jj][e]);
        }
    }
  }
  consumer_sync();
  // the 8 warps in order: one thread a (sum or sumsq, channel)
  const int per_img = a.tiles_x * a.tiles_y;
  for (int k = threadIdx.x; k < 2 * BN; k += kConsumerWarps * 32) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < kConsumerWarps; ++w)
      s += lds_f32(st_s + (w * 2 * BN + k) * 4);
    const int col = k % BN;
    if (n0 + col < a.Cout)
      a.stats[(((long long)b * per_img + tile % per_img) * 2 + k / BN) *
                  a.Cout + n0 + col] = s;
  }
  consumer_sync();   // the partials may be overwritten by the next tile
}

// The epilogue of conv3x3_bias and K2 for one tile: y = bf16(acc + bias)
// in 16-byte stores, or a split's fp32 partials.
template <int BN, int MB>
__device__ __forceinline__ void plain_epilogue(
    const Args& a, const float (&acc)[MB][BN / 2], const float (&bv)[BN / 4],
    int b, int tx, int ty, int n0, int split, int lane, int rwg, int wl) {
  constexpr int TH = tile_h(MB);
  const int q = lane & 3;
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
          uint32_t v[4];
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int j = 4 * g + jj;
            v[jj] = pack_bf16x2(acc[mb][4 * j + 2 * i] + bv[2 * j],
                                acc[mb][4 * j + 2 * i + 1] + bv[2 * j + 1]);
          }
          const uint4 o = quad_transpose(v, lane);
          const int nb = n0 + 8 * (4 * g + q);
          if (ok && nb < a.Cout)
            *reinterpret_cast<uint4*>(a.y + pix * a.Cout + nb) = o;
        }
      } else {
        if (ok) {
#pragma unroll
          for (int j = 0; j < BN / 8; ++j)
            store_pair(a.y + pix * a.Cout, n0 + 8 * j + 2 * q, a.Cout,
                       pack_bf16x2(acc[mb][4 * j + 2 * i] + bv[2 * j],
                                   acc[mb][4 * j + 2 * i + 1] +
                                       bv[2 * j + 1]));
        }
      }
    }
  }
}

// ------------------------------------------------------------- the kernel
template <int STRIDE, int BN, int MB, bool FUSED>
__global__ void __launch_bounds__(kThreads, 1)
conv_sm90_kernel(const __grid_constant__ CUtensorMap xmap,
                 const __grid_constant__ CUtensorMap smap, const Args a) {
  constexpr int TH = tile_h(MB);
  constexpr int BW = win_w(STRIDE);
  constexpr int BOX = box_bytes(STRIDE, TH);
  constexpr int SLOT = slot_bytes(STRIDE, TH);
  constexpr int NR = BN / 2;          // accumulator registers per m64 block
  constexpr int TAP_BYTES = BN * kRowBytes;
  static_assert(!FUSED || STRIDE == 1, "K1 is a stride-1 conv");

  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t w_s = base;
  const uint32_t w1_s = w_s + a.w_bytes;           // K1's resident W1
  const uint32_t win_s = w1_s + (FUSED ? a.w1_bytes : 0);
  const uint32_t st_s = win_s + a.stages * SLOT;   // K1's stats partials
  const uint32_t bars = st_s + (FUSED ? stats_bytes(BN) : 0);
  // full[i] at bars + 8i, empty[i] at bars + 8 (stages + i), K1's ready[i]
  // at bars + 8 (2 stages + i), weights last
  const uint32_t ready = bars + 16 * a.stages;
  const uint32_t wbar = bars + 8 * (FUSED ? 3 : 2) * a.stages;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slice = blockIdx.y % a.n_slices;
  const int split = blockIdx.y / a.n_slices;
  const int n0 = slice * BN;
  // K1's projected skip: one more K step a tile and 64-channel chunk,
  // the chunks dealt round the splits (chunk split + k * nsplit is this
  // block's k-th, its W1 resident at w1_s + k * TAP_BYTES)
  const int nsplit = gridDim.y / a.n_slices;
  const int s_mine =
      FUSED && split < a.s_chunks ? (a.s_chunks - split - 1) / nsplit + 1 : 0;

  if (threadIdx.x == 0) {
    for (int i = 0; i < a.stages; ++i) {
      mbar_init(bars + 8 * i, 1);
      mbar_init(bars + 8 * (a.stages + i), kConsumerWarps);
      if (FUSED) mbar_init(ready + 8 * i, kPrologueThreads);
    }
    mbar_init(wbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---------------------------------------------------------- producer
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(
        FUSED ? kFusedProducerRegs : kProducerRegs));
    if (threadIdx.x == kConsumerWarps * 32) {
      mbar_expect_tx(wbar, a.w_bytes + s_mine * TAP_BYTES);
      for (int cl = 0; cl < a.cps; ++cl)
        for (int t = 0; t < 9; ++t)
          bulk_load(w_s + (cl * 9 + t) * TAP_BYTES,
                    a.w + ((size_t)((split * a.cps + cl) * 9 + t) * a.CoutP +
                           n0) * KC,
                    TAP_BYTES, wbar);
      for (int k = 0; k < s_mine; ++k)
        bulk_load(w1_s + k * TAP_BYTES,
                  a.w1 + ((size_t)(split + k * nsplit) * a.CoutP + n0) * KC,
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
        // K1's projected skip: the tile's TH x TW centre pixels of the raw
        // skip, one box a 64-channel chunk, after the conv's chunks
        for (int k = 0; k < s_mine; ++k) {
          const uint32_t full = bars + 8 * stage;
          mbar_wait(bars + 8 * (a.stages + stage), phase ^ 1);
          mbar_expect_tx(full, TH * TW * kRowBytes);
          tma_load_4d(win_s + stage * SLOT, &smap, full,
                      (split + k * nsplit) * KC, tx * TW, ty * TH, b);
          if (++stage == a.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    } else if constexpr (FUSED) {
      if (warp > kConsumerWarps) {
        // ------------------------------------------------ K1's prologue
        // Thread pt keeps the 16-byte channel group grp of every window
        // row it rewrites (rows pt / 8, + 12, ...), so a warp covers 4
        // whole 128-byte rows a pass and its a, b stay in registers.
        const int pt = threadIdx.x - (kConsumerWarps + 1) * 32;
        const int grp = pt & 7;
        constexpr int ROWS = win_h(1, TH) * BW;
        int stage = 0;
        uint32_t phase = 0;
        for (int tile = blockIdx.x; tile < a.n_tiles; tile += gridDim.x) {
          const int tx = tile % a.tiles_x;
          const int ty = (tile / a.tiles_x) % a.tiles_y;
          const int b = tile / (a.tiles_x * a.tiles_y);
          for (int cl = 0; cl < a.cps + s_mine; ++cl) {
            mbar_wait(bars + 8 * stage, phase);
            if (cl < a.cps) {
              const int c = (split * a.cps + cl) * KC + 8 * grp;
              float sa[8], sb[8];
              if (c < a.Cin) {
                const float4* pa = reinterpret_cast<const float4*>(
                    a.ga + (size_t)b * a.Cin + c);
                const float4* pb = reinterpret_cast<const float4*>(
                    a.gb + (size_t)b * a.Cin + c);
                const float4 a0 = pa[0], a1 = pa[1], b0 = pb[0], b1 = pb[1];
                sa[0] = a0.x; sa[1] = a0.y; sa[2] = a0.z; sa[3] = a0.w;
                sa[4] = a1.x; sa[5] = a1.y; sa[6] = a1.z; sa[7] = a1.w;
                sb[0] = b0.x; sb[1] = b0.y; sb[2] = b0.z; sb[3] = b0.w;
                sb[4] = b1.x; sb[5] = b1.y; sb[6] = b1.z; sb[7] = b1.w;
              } else {
#pragma unroll
                for (int k = 0; k < 8; ++k) sa[k] = sb[k] = 0.0f;
              }
              const uint32_t win = win_s + stage * SLOT;
              const int wx = tx * TW - 1;
              const int wy = ty * TH - 1;
              for (int r = pt >> 3; r < ROWS; r += kPrologueThreads / 8) {
                const int iy = wy + r / BW;
                const int ix = wx + r % BW;
                const uint32_t addr = win + r * kRowBytes +
                                      ((grp ^ (r & 7)) << 4);
                // the halo is 0 AFTER the activation
                uint4 v = make_uint4(0u, 0u, 0u, 0u);
                if ((unsigned)iy < (unsigned)a.Ho &&
                    (unsigned)ix < (unsigned)a.Wo)
                  v = affine_act8(lds128(addr), sa, sb, a.act);
                sts128(addr, v);
              }
              // TMA (the async proxy) refills this slot later: order the
              // generic-proxy rewrite before it
              asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            }
            mbar_arrive(ready + 8 * stage);
            if (++stage == a.stages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
    return;
  }

  // ------------------------------------------------------------ consumers
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(
      FUSED ? kFusedConsumerRegs : kConsumerRegs));
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
  // a window is the consumers' once it has landed (K1: once rewritten)
  const uint32_t landed = FUSED ? ready : bars;

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
    const int tx = tile % a.tiles_x;
    const int ty = (tile / a.tiles_x) % a.tiles_y;
    const int b = tile / (a.tiles_x * a.tiles_y);
    uint32_t skr[MB][2][FUSED ? BN / 8 : 1];
    if constexpr (FUSED)
      load_skip<BN, MB>(a, skr, b, tx, ty, n0, lane, rwg, wl);
    float acc[MB][NR];
    for (int cl = 0; cl < a.cps; ++cl) {
      mbar_wait(landed + 8 * stage, phase);
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
    // K1's projected skip: one k16 x 4 step a 64-channel chunk of the raw
    // skip box, A at the output pixel's own row (oy * TW + ox)
    for (int k = 0; k < s_mine; ++k) {
      mbar_wait(landed + 8 * stage, phase);
      const uint32_t win = win_s + stage * SLOT;
      uint32_t af[4][MB][4];
#pragma unroll
      for (int mb = 0; mb < MB; ++mb) {
        const int r = ((rwg + mb) * 4 + wl) * TW + (lane & 15);
        const uint32_t row = win + r * kRowBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          ldsm_x4(af[kk][mb], row + (((2 * kk + hi) ^ (r & 7)) << 4));
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t desc = desc_sw128(w1_s + k * TAP_BYTES + kk * 32);
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
          Wgmma<BN>::mma(acc[mb], af[kk][mb], desc, 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int mb = 0; mb < MB; ++mb)
#pragma unroll
          for (int r = 0; r < 4; ++r) reg_fence(af[kk][mb][r]);
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
    if constexpr (FUSED) {
      if (a.ws == nullptr)
        fused_epilogue<BN, MB>(a, acc, bv, skr, b, tx, ty, tile, n0, warp,
                               lane, rwg, wl, st_s);
      else   // a split's fp32 partials: dots_finish_kernel does the rest
        plain_epilogue<BN, MB>(a, acc, bv, b, tx, ty, n0, split, lane, rwg,
                               wl);
    } else {
      plain_epilogue<BN, MB>(a, acc, bv, b, tx, ty, n0, split, lane, rwg,
                             wl);
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

// K1's second pass after a split, one block a (tile, slice): y =
// bf16(the splits' fp32 partials summed in split order + bias [+ identity
// skip]) with one rounding, and the tile's [sum, sumsq] of the rounded y
// for the slice's channels into its statistics slot, as fused_epilogue
// does. Thread t takes channel t % bn of every (256 / bn)-th pixel; the
// pixel groups are summed in order, so two runs agree bit for bit.
static __global__ void __launch_bounds__(256) dots_finish_kernel(
    const float* __restrict__ ws, const float* __restrict__ bias,
    const __nv_bfloat16* __restrict__ skip, __nv_bfloat16* __restrict__ y,
    float* __restrict__ stats, long long pixels, int Ho, int Wo, int Cout,
    int CoutP, int split, int th, int tiles_x, int tiles_y, int bn) {
  __shared__ float part[2][256];
  const int per_img = tiles_x * tiles_y;
  const int tile = blockIdx.x;
  const int tx = tile % tiles_x;
  const int ty = (tile / tiles_x) % tiles_y;
  const int b = tile / per_img;
  const int c = threadIdx.x % bn;
  const int groups = 256 / bn;
  const int n0 = blockIdx.y * bn;
  const int n = n0 + c;
  float s1 = 0.0f, s2 = 0.0f;
  for (int p = threadIdx.x / bn; n < Cout && p < th * TW; p += groups) {
    const int oy = ty * th + p / TW;
    const int ox = tx * TW + p % TW;
    if (oy >= Ho || ox >= Wo) continue;
    const long long pix = ((long long)b * Ho + oy) * Wo + ox;
    float v = 0.0f;
    for (int s = 0; s < split; ++s)
      v += ws[((long long)s * pixels + pix) * CoutP + n];
    v += bias[n];
    if (skip != nullptr) v += __bfloat162float(skip[pix * Cout + n]);
    const __nv_bfloat16 r = __float2bfloat16_rn(v);
    y[pix * Cout + n] = r;
    const float f = __bfloat162float(r);
    s1 += f;
    s2 += f * f;
  }
  part[0][threadIdx.x] = s1;
  part[1][threadIdx.x] = s2;
  __syncthreads();
  if ((int)threadIdx.x < 2 * bn) {
    const int k = threadIdx.x / bn;
    const int cc = threadIdx.x % bn;
    float s = 0.0f;
    for (int j = 0; j < groups; ++j) s += part[k][j * bn + cc];
    if (n0 + cc < Cout)
      stats[(((long long)b * per_img + tile % per_img) * 2 + k) * Cout + n0 +
            cc] = s;
  }
}

// ------------------------------------------------------------------ host
template <int STRIDE, bool FUSED>
using KernelFn = void (*)(const CUtensorMap, const CUtensorMap, const Args);

template <int STRIDE, bool FUSED, int BN, int MB>
inline bool pick(int bn, int mb, KernelFn<STRIDE, FUSED>* fn) {
  if (bn != BN || mb != MB) return false;
  *fn = conv_sm90_kernel<STRIDE, BN, MB, FUSED>;
  return true;
}

// The kernel variants a plan may name: ops/conv3x3.py VARIANTS.
template <int STRIDE, bool FUSED>
KernelFn<STRIDE, FUSED> variant(int bn, int mb) {
  KernelFn<STRIDE, FUSED> fn = nullptr;
  if constexpr (STRIDE == 1) {
    pick<1, FUSED, 128, 1>(bn, mb, &fn) || pick<1, FUSED, 64, 2>(bn, mb, &fn) ||
        pick<1, FUSED, 64, 1>(bn, mb, &fn) ||
        pick<1, FUSED, 32, 1>(bn, mb, &fn) ||
        pick<1, FUSED, 16, 1>(bn, mb, &fn) || pick<1, FUSED, 8, 2>(bn, mb, &fn);
  } else {
    pick<2, FUSED, 128, 1>(bn, mb, &fn) || pick<2, FUSED, 64, 1>(bn, mb, &fn) ||
        pick<2, FUSED, 32, 1>(bn, mb, &fn) ||
        pick<2, FUSED, 16, 1>(bn, mb, &fn);
  }
  return fn;
}

// Encode the tensor map of t (B, H, W, C) bf16 with a box of 64 channels,
// bw columns and bh rows of one image.
inline CUresult encode_box(CUtensorMap* map, const void* t, int B, int H,
                           int W, int C, int bw, int bh) {
  const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H,
                              (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)C * 2, (cuuint64_t)W * C * 2,
                                 (cuuint64_t)H * W * C * 2};
  const cuuint32_t box[4] = {(cuuint32_t)KC, (cuuint32_t)bw, (cuuint32_t)bh,
                             1};
  const cuuint32_t estride[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(t), dims,
      strides, box, estride, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// The fields of Args every kernel of the core reads.
inline Args core_args(const void* w, const void* bias, void* y, int B,
                      int Ho, int Wo, int Cout, int CoutP, int cps, int bn,
                      int th, int stages, int w_bytes) {
  Args a = {};
  a.w = static_cast<const __nv_bfloat16*>(w);
  a.bias = static_cast<const float*>(bias);
  a.y = static_cast<__nv_bfloat16*>(y);
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
  return a;
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
  const KernelFn<STRIDE, false> fn = variant<STRIDE, false>(bn, mb);
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
  const CUresult cr = encode_box(&map, x, B, H, W, Cin, win_w(STRIDE),
                                 win_h(STRIDE, th));
  if (cr != CUDA_SUCCESS) return -static_cast<int>(cr);
  Args a = core_args(w, bias, y, B, Ho, Wo, Cout, CoutP, cps, bn, th, stages,
                     w_bytes);
  a.ws = static_cast<float*>(ws);
  // set on every launch: the attribute belongs to the current device
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fn<<<dim3(grid_x, a.n_slices * split), kThreads, smem, s>>>(map, map, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  split_sum_kernel<<<1024, 256, 0, s>>>(a.ws, a.bias, a.y, a.pixels, Cout,
                                        CoutP, split);
  return static_cast<int>(cudaGetLastError());
}

// K1: check the plan, encode the maps of x and (projected) skip, launch.
// Same return values as run_conv.
inline int run_dots(const void* x, const void* ga, const void* gb,
                    const void* w, const void* bias, const void* skip,
                    const void* w1, void* y, void* stats, void* ws, int B,
                    int H, int W, int Cin, int Cout, int CoutP, int Cs,
                    int act, int skip_mode, int bn, int mb, int split,
                    int stages, int smem, int grid_x, int device,
                    void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nch = (Cin + KC - 1) / KC;
  const int th = tile_h(mb);
  const bool proj = skip_mode == SKIP_PROJ;
  const int s_chunks = proj ? (Cs + KC - 1) / KC : 0;
  const KernelFn<1, true> fn = variant<1, true>(bn, mb);
  if (fn == nullptr || B < 1 || H < 1 || W < 1 || Cin < 32 || Cin % 32 ||
      Cout < 1 || Cout > CoutP || CoutP % bn || stages < 2 || grid_x < 1 ||
      (bn >= 32 && Cout % 8) || (act != ACT_NONE && act != ACT_SILU) ||
      skip_mode < SKIP_NONE || skip_mode > SKIP_PROJ ||
      (skip_mode != SKIP_NONE) != (skip != nullptr) ||
      proj != (w1 != nullptr) || (skip_mode == SKIP_IDENTITY && Cout % 8) ||
      (proj && (Cs < 32 || Cs % 32)) || ga == nullptr || gb == nullptr ||
      stats == nullptr || split < 1 || nch % split ||
      (split > 1) != (ws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const int cps = nch / split;
  const int w_bytes = cps * 9 * bn * kRowBytes;
  const int w1_bytes = (s_chunks + split - 1) / split * bn * kRowBytes;
  const long long need = (long long)kAlignSlack + w_bytes + w1_bytes +
                         (long long)stages * slot_bytes(1, th) +
                         stats_bytes(bn) + kBarrierBytes;
  if (smem < need || smem > kSmemLimit || 24 * stages + 8 > kBarrierBytes)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xmap, smap;
  CUresult cr = encode_box(&xmap, x, B, H, W, Cin, win_w(1), win_h(1, th));
  if (cr != CUDA_SUCCESS) return -static_cast<int>(cr);
  smap = xmap;   // read only with a projected skip
  if (proj) {
    cr = encode_box(&smap, skip, B, H, W, Cs, TW, th);
    if (cr != CUDA_SUCCESS) return -static_cast<int>(cr);
  }
  Args a = core_args(w, bias, y, B, H, W, Cout, CoutP, cps, bn, th, stages,
                     w_bytes);
  a.ws = static_cast<float*>(ws);
  a.ga = static_cast<const float*>(ga);
  a.gb = static_cast<const float*>(gb);
  // after a split the second pass adds the identity skip
  const __nv_bfloat16* skip_id = skip_mode == SKIP_IDENTITY
                                     ? static_cast<const __nv_bfloat16*>(skip)
                                     : nullptr;
  a.skip_id = split == 1 ? skip_id : nullptr;
  a.w1 = static_cast<const __nv_bfloat16*>(w1);
  a.stats = static_cast<float*>(stats);
  a.Cin = Cin;
  a.act = act;
  a.s_chunks = s_chunks;
  a.w1_bytes = w1_bytes;
  // set on every launch: the attribute belongs to the current device
  err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  fn<<<dim3(grid_x, a.n_slices * split), kThreads, smem, s>>>(xmap, smap, a);
  err = cudaGetLastError();
  if (err != cudaSuccess || split == 1) return static_cast<int>(err);
  dots_finish_kernel<<<dim3(a.n_tiles, a.n_slices), 256, 0, s>>>(
      a.ws, a.bias, skip_id, a.y, a.stats, a.pixels, H, W, Cout, CoutP, split,
      th, a.tiles_x, a.tiles_y, bn);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace sm90
}  // namespace cf
