// RMSNorm for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/rmsnorm/kernel.py::_rmsnorm_kernel (rmsnorm_pallas):
//   for each row of x [N, d] (float32 or bf16) and scale [d] float32,
//     y = x * rsqrt(mean(x^2) + eps) * (1 + scale)
//   in float32, written in x's dtype. One addition for the op's vmap rule:
//   rows are cut into groups of `rows_per_group`, and group g reads scale
//   row g (scale [G, d] at a row stride), so G clients' norms take one
//   launch.
//
// Bound on an H100 SXM (3.35 TB/s; ~4 float32 operations an element, far
// below the card's rate): x read once, y written once, scale read once,
// 2*N*d*sizeof(x) + G*d*4 bytes. At [2048, 5120] float32 that is 84 MB,
// about 25 us, so the kernel is bound by bytes.
//
// Design. The Pallas kernel tiles 256 rows a grid step with d whole in
// VMEM. Here a row belongs to one warp when d <= 1024 (8 rows a 256-thread
// block) and to one block up to d = 8192. The row is read once into
// registers, in 16-byte vectors (float4, or 8 bf16) where d, the row
// stride and the pointer allow it and element by element otherwise. The
// sum of squares runs in a fixed order: each thread's elements in turn, an
// xor-butterfly warp shuffle (every lane ends with the same bits), and for
// a block the warps' sums from shared memory in warp order; two launches
// on one input give the same bits. The row is then scaled from registers
// and written: nothing is read twice from device memory. Rows may carry a
// stride (the last dim must be contiguous); the output is contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;
constexpr int kWarpRowMaxD = 1024;  // up to here a warp owns a row

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

__device__ __forceinline__ float warp_allsum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// WPR warps own a row, kWarps / WPR rows a block; a thread holds up to NV
// packs of VEC elements of its row.
template <typename T, int VEC, int WPR, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, long long x_stride, const float* __restrict__ scale,
               long long s_stride, long long rows_per_group, T* __restrict__ y,
               long long n_rows, int d, float eps) {
  constexpr int kRowThreads = 32 * WPR;
  constexpr int kRowsPerBlock = kWarps / WPR;
  using P = Pack<T, VEC>;
  __shared__ float part[kWarps];

  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x % kRowThreads;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + warp / WPR;
  const bool live = row < n_rows;  // uniform over the row's warps
  const int nvec = d / VEC;

  P buf[NV];
  float ss = 0.f;
  if (live) {
    const P* xr = reinterpret_cast<const P*>(x + row * x_stride);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int j = t + i * kRowThreads;
      if (j < nvec) {
        buf[i] = xr[j];
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float f = to_f(buf[i].v[k]);
          ss += f * f;
        }
      }
    }
  }
  ss = warp_allsum(ss);
  if constexpr (WPR > 1) {
    const int first = (warp / WPR) * WPR;
    if ((threadIdx.x & 31) == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < WPR; ++w) ss += part[first + w];
  }
  if (!live) return;

  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  const float* sr = scale + (row / rows_per_group) * s_stride;
  P* yr = reinterpret_cast<P*>(y + row * static_cast<long long>(d));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int j = t + i * kRowThreads;
    if (j < nvec) {
      P o;
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        o.v[k] = from_f<T>(to_f(buf[i].v[k]) * r * (1.f + sr[j * VEC + k]));
      yr[j] = o;
    }
  }
}

template <typename T, int VEC, int WPR, int NV>
cudaError_t launch_cfg(const void* x, long long x_stride, const float* scale,
                       long long s_stride, long long rows_per_group, void* y,
                       long long n_rows, int d, float eps, cudaStream_t s) {
  constexpr int kRowsPerBlock = kWarps / WPR;
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, VEC, WPR, NV><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), x_stride, scale, s_stride, rows_per_group,
      static_cast<T*>(y), n_rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, long long n_rows, int d, long long x_stride,
                   const float* scale, long long s_stride, long long rows_per_group, void* y,
                   float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  // kVec * NV * 32 * WPR covers kWarpRowMaxD (one warp) and kMaxD (a block)
  // for both types; element by element, NV = 32 covers them at VEC = 1.
  const bool vec = d % kVec == 0 && x_stride % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const bool warp_row = d <= kWarpRowMaxD;
  if (vec)
    return warp_row ? launch_cfg<T, kVec, 1, 8>(x, x_stride, scale, s_stride, rows_per_group,
                                                 y, n_rows, d, eps, s)
                    : launch_cfg<T, kVec, kWarps, 8>(x, x_stride, scale, s_stride,
                                                      rows_per_group, y, n_rows, d, eps, s);
  return warp_row ? launch_cfg<T, 1, 1, 32>(x, x_stride, scale, s_stride, rows_per_group, y,
                                            n_rows, d, eps, s)
                  : launch_cfg<T, 1, kWarps, 32>(x, x_stride, scale, s_stride, rows_per_group,
                                                 y, n_rows, d, eps, s);
}

}  // namespace

extern "C" {

// The largest row the kernel takes.
int rmsnorm_max_d() { return kMaxD; }

// dtype: 0 = float32, 1 = bfloat16. x: n_rows rows of d elements, row r at
// x + r * x_stride (elements), last dim contiguous; scale: float32, group
// g's row at scale + g * s_stride; row r takes group r / rows_per_group;
// y: contiguous [n_rows, d] in x's dtype. 1 <= d <= 8192, n_rows >= 1.
// Returns a cudaError_t.
int rmsnorm_launch(int dtype, const void* x, long long n_rows, int d, long long x_stride,
                   const float* scale, long long s_stride, long long rows_per_group, void* y,
                   float eps, void* stream) {
  if (d < 1 || d > kMaxD || n_rows < 1 || rows_per_group < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(x, n_rows, d, x_stride, scale, s_stride, rows_per_group, y, eps, s);
    case 1:
      return launch<__nv_bfloat16>(x, n_rows, d, x_stride, scale, s_stride, rows_per_group, y,
                                   eps, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
