// K4: the fused bias + leaky ReLU + scale of StyleGAN2 (fused_act), and
// its gradient.
//
//   forward   out = where(y >= 0, y, y * slope) * scale,  y = x + bias[c]
//   backward  dx = where(out >= 0, g, g * slope) * scale,
//             dbias = sum of dx over every element of channel c
//
// Replaces the TPU kernel codeformer_tpu/ops/fused_act.py `_fused_pallas`
// (forward) and its custom VJP `_fused_bwd`.
//
// x, out, g, dx: channel-last (..., C), flattened to E elements, element i
// in channel i % C; bf16 or fp32. The bias arrives already rounded to x's
// type and widened to fp32, so the sums run in fp32 from what x's type can
// hold, as the Pallas kernel's bias.astype(x.dtype) and the reference's
// CUDA kernel do. Results are rounded to x's type once.
//
// What bounds it on the H100: a few FLOP an element against 2 (forward) or
// 3 (backward) element transfers: HBM bandwidth, far below the ridge. So
// each element is read and written exactly once, with 16-byte vector
// accesses (8 bf16 or 4 fp32 a thread), and nothing else is stored.
//
// dbias without float atomics, so the result does not depend on the order
// the blocks run in. View the elements as chunks of C vectors (C * V
// elements, V the vector width). Vector k of every chunk holds the same
// channels, (k * V + j) % C for lane j, because a chunk is a whole number
// of rows. A thread keeps one vector class k and walks the chunks, so it
// sums each lane into a register of one fixed channel. Each block then
// folds its threads' V registers per channel in a fixed order and writes
// one row of fp32 partials; the elements after the last whole chunk
// (fewer than C * V) go scalar into one more row. The wrapper sums the
// rows in a fixed order.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cf {
namespace {

constexpr int kActThreads = 256;

template <typename T>
struct Act;
template <>
struct Act<float> {
  using Acc = float;
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};
template <>
struct Act<__nv_bfloat16> {
  using Acc = float;
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// leaky(v) * scale, the branch chosen by `pos`, in the compute type
template <typename A>
__device__ __forceinline__ A masked_scale(A v, bool pos, A slope, A scale) {
  const A m = pos ? v : v * slope;
  return m * scale;
}

template <typename T>
__global__ void __launch_bounds__(kActThreads)
fused_lrelu_fwd_kernel(const T* __restrict__ x,
                       const typename Act<T>::Acc* __restrict__ bias,
                       T* __restrict__ out, long long E, int C,
                       typename Act<T>::Acc slope,
                       typename Act<T>::Acc scale) {
  using A = typename Act<T>::Acc;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char act_smem[];
  A* sb = reinterpret_cast<A*>(act_smem);
  for (int c = threadIdx.x; c < C; c += blockDim.x) sb[c] = bias[c];
  __syncthreads();

  const long long n_vec = E / V;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long v0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // channel of a vector's first lane, advanced by the stride's remainder
  // (no 64-bit modulo in the loop)
  const int step_c = (int)((stride * V) % C);
  int c_base = (int)((v0 * V) % C);
  for (long long v = v0; v < n_vec; v += stride) {
    const long long base = v * V;
    int c = c_base;
    c_base += step_c;
    if (c_base >= C) c_base -= C;
    const uint4 raw = *reinterpret_cast<const uint4*>(x + base);
    const T* xe = reinterpret_cast<const T*>(&raw);
    uint4 res;
    T* oe = reinterpret_cast<T*>(&res);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const A y = Act<T>::load(xe[j]) + sb[c];
      oe[j] = Act<T>::store(masked_scale<A>(y, y >= A(0), slope, scale));
      c = (c + 1 == C) ? 0 : c + 1;
    }
    *reinterpret_cast<uint4*>(out + base) = res;
  }
  // scalar tail: the last E % V elements
  if (blockIdx.x == 0) {
    for (long long i = n_vec * V + threadIdx.x; i < E; i += blockDim.x) {
      const A y = Act<T>::load(x[i]) + sb[i % C];
      out[i] = Act<T>::store(masked_scale<A>(y, y >= A(0), slope, scale));
    }
  }
}

template <typename T>
__device__ __forceinline__ T dx_of(T g, T out, typename Act<T>::Acc slope,
                                   typename Act<T>::Acc scale) {
  using A = typename Act<T>::Acc;
  return Act<T>::store(masked_scale<A>(Act<T>::load(g),
                                       Act<T>::load(out) >= A(0), slope,
                                       scale));
}

// Grid (gx, gy). Block (bx, by) owns the vector classes
// [by * KC, by * KC + KC) with Q = kActThreads / KC threads a class, and the
// chunks bx * Q + q, stepping by gx * Q. partial: (gy * gx + 1, C), row
// by * gx + bx for this block, the last row for the scalar tail.
template <typename T>
__global__ void __launch_bounds__(kActThreads)
fused_lrelu_bwd_kernel(const T* __restrict__ g, const T* __restrict__ out,
                       T* __restrict__ dx,
                       typename Act<T>::Acc* __restrict__ partial,
                       long long E, int C, int KC,
                       typename Act<T>::Acc slope,
                       typename Act<T>::Acc scale) {
  using A = typename Act<T>::Acc;
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char act_smem[];
  A* red = reinterpret_cast<A*>(act_smem);   // [kActThreads][V]

  const int tid = threadIdx.x;
  const int Q = kActThreads / KC;
  const int q = tid / KC;
  const int k0 = blockIdx.y * KC;
  const int k = k0 + tid % KC;
  const long long chunk = (long long)C * V;
  const long long n_chunks = E / chunk;

  A acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = A(0);
  if (q < Q && k < C) {
    for (long long ch = (long long)blockIdx.x * Q + q; ch < n_chunks;
         ch += (long long)gridDim.x * Q) {
      const long long base = ch * chunk + (long long)k * V;
      const uint4 graw = *reinterpret_cast<const uint4*>(g + base);
      const uint4 oraw = *reinterpret_cast<const uint4*>(out + base);
      const T* ge = reinterpret_cast<const T*>(&graw);
      const T* oe = reinterpret_cast<const T*>(&oraw);
      uint4 res;
      T* de = reinterpret_cast<T*>(&res);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        de[j] = dx_of<T>(ge[j], oe[j], slope, scale);
        acc[j] += Act<T>::load(de[j]);   // the rounded dx, as written
      }
      *reinterpret_cast<uint4*>(dx + base) = res;
    }
  }
#pragma unroll
  for (int j = 0; j < V; ++j) red[tid * V + j] = acc[j];
  __syncthreads();

  // channel c collects lane j of class k wherever (k * V + j) % C == c,
  // i.e. at e = k * V + j = c + m * C, m = 0 .. V - 1; fixed order
  A* row = partial + ((long long)blockIdx.y * gridDim.x + blockIdx.x) * C;
  for (int c = tid; c < C; c += kActThreads) {
    A s = A(0);
    for (int m = 0; m < V; ++m) {
      const int e = c + m * C;
      const int kl = e / V - k0;
      if (kl < 0 || kl >= KC) continue;
      for (int qq = 0; qq < Q; ++qq) s += red[(qq * KC + kl) * V + e % V];
    }
    row[c] = s;
  }

  // scalar tail: the elements after the last whole chunk, block (0, 0)
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    const long long t0 = n_chunks * chunk;
    for (long long i = t0 + tid; i < E; i += kActThreads)
      dx[i] = dx_of<T>(g[i], out[i], slope, scale);
    A* trow = partial + (long long)gridDim.y * gridDim.x * C;
    for (int c = tid; c < C; c += kActThreads) {
      A s = A(0);
      // t0 is a multiple of C: channel c sits at t0 + c, t0 + c + C, ...
      for (long long i = t0 + c; i < E; i += C)
        s += Act<T>::load(dx_of<T>(g[i], out[i], slope, scale));
      trow[c] = s;
    }
  }
}

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                             device) != cudaSuccess || sms < 1)
    sms = 132;
  return sms;
}

template <typename T>
cudaError_t launch_fwd(const void* x, const void* bias, void* out,
                       long long E, int C, double slope, double scale,
                       int device, cudaStream_t s) {
  using A = typename Act<T>::Acc;
  constexpr int V = 16 / sizeof(T);
  const size_t smem = (size_t)C * sizeof(A);
  auto kern = fused_lrelu_fwd_kernel<T>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const long long n_vec = E / V;
  long long blocks = (n_vec + kActThreads - 1) / kActThreads;
  const long long cap = 8LL * sm_count(device);
  blocks = blocks < 1 ? 1 : (blocks > cap ? cap : blocks);
  kern<<<(unsigned)blocks, kActThreads, smem, s>>>(
      static_cast<const T*>(x), static_cast<const A*>(bias),
      static_cast<T*>(out), E, C, (A)slope, (A)scale);
  return cudaGetLastError();
}

// The backward's grid: gy blocks over the vector classes (C of them, KC a
// block), gx over the chunks of C vectors, about four blocks an SM in all.
// V: the vector width of the element type.
struct BwdGrid {
  int KC, gx, gy;
  long long rows() const { return (long long)gx * gy + 1; }
};
BwdGrid bwd_grid(long long E, int C, int V, int device) {
  BwdGrid b;
  b.KC = C < kActThreads ? C : kActThreads;
  b.gy = (C + b.KC - 1) / b.KC;
  const long long per_block = kActThreads / b.KC;
  const long long n_chunks = E / ((long long)C * V);
  const long long want = (n_chunks + per_block - 1) / per_block;
  const long long cap = (4LL * sm_count(device) + b.gy - 1) / b.gy;
  const long long gx = want < cap ? want : cap;
  b.gx = gx < 1 ? 1 : (int)gx;
  return b;
}

template <typename T>
cudaError_t launch_bwd(const void* g, const void* out, void* dx,
                       void* partial, long long rows, long long E, int C,
                       double slope, double scale, int device,
                       cudaStream_t s) {
  using A = typename Act<T>::Acc;
  constexpr int V = 16 / sizeof(T);
  const BwdGrid b = bwd_grid(E, C, V, device);
  if (rows != b.rows()) return cudaErrorInvalidValue;
  const int KC = b.KC;
  const int gx = b.gx, gy = b.gy;
  const size_t smem = (size_t)kActThreads * V * sizeof(A);
  fused_lrelu_bwd_kernel<T><<<dim3(gx, gy), kActThreads, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(out),
      static_cast<T*>(dx), static_cast<A*>(partial), E, C, KC, (A)slope,
      (A)scale);
  return cudaGetLastError();
}

}  // namespace
}  // namespace cf

// C entries. dtype: 0 fp32, 1 bf16. E: elements, C: channels (at most
// 12288: the forward keeps the bias in shared memory). Data pointers
// 16-byte aligned. The bias and the partials are fp32. Return a
// cudaError_t, or for cf_fused_lrelu_bwd_rows a count.
extern "C" int cf_fused_lrelu_fwd(const void* x, const void* bias, void* out,
                                  int dtype, long long E, int C,
                                  double slope, double scale, int device,
                                  void* stream) {
  using namespace cf;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_fwd<float>(x, bias, out, E, C, slope, scale, device, s);
  else if (dtype == 1)
    err = launch_fwd<__nv_bfloat16>(x, bias, out, E, C, slope, scale,
                                    device, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// The rows of C partials the backward writes for (dtype, E, C) on the
// device, or -1 for an unknown dtype or a device that cannot be read.
extern "C" int cf_fused_lrelu_bwd_rows(int dtype, long long E, int C,
                                       int device) {
  using namespace cf;
  if ((dtype != 0 && dtype != 1) || C < 1 ||
      cudaSetDevice(device) != cudaSuccess)
    return -1;
  const long long rows = bwd_grid(E, C, dtype == 1 ? 8 : 4, device).rows();
  return rows > 0x7fffffff ? -1 : static_cast<int>(rows);
}

// partial: (rows, C), rows as cf_fused_lrelu_bwd_rows gives them; another
// count is refused with cudaErrorInvalidValue.
extern "C" int cf_fused_lrelu_bwd(const void* g, const void* out, void* dx,
                                  void* partial, int dtype, long long E,
                                  int C, int rows, double slope, double scale,
                                  int device, void* stream) {
  using namespace cf;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch_bwd<float>(g, out, dx, partial, rows, E, C, slope, scale,
                            device, s);
  else if (dtype == 1)
    err = launch_bwd<__nv_bfloat16>(g, out, dx, partial, rows, E, C, slope,
                                    scale, device, s);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}
