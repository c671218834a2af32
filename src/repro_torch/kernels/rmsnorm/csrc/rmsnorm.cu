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
// 2*N*d*sizeof(x) + G*d*4 bytes. At [8192, 5120] bf16 that is 168 MB,
// about 50 us; at the LM step's [1024, 1024] float32, 8.4 MB or 2.5 us, so
// there a row's latency (one trip to memory for x and scale, the
// reduction, the store) and the launch bound it, not the bytes.
//
// Design. The Pallas kernel tiles 256 rows a grid step with d whole in
// VMEM. Here RT threads of a 256-thread block own a row (32, 64, 128 or
// 256: 256 / RT rows a block), and each holds NP whole 16-byte packs of it
// (4 float32 or 8 bf16) in registers. The host picks (RT, NP) from d and
// the type so that RT * NP packs are exactly the row at the repo's widths
// (1024, 5120, 7168, 8192): d 5120 in bf16 is 640 packs, 128 threads x 5,
// where one 256-thread row would leave its threads 2.5 packs each and the
// last pass half empty. Other widths take a guarded instance. The scale
// row is read with 16-byte loads in the same pass as x, before the
// reduction, so no row waits for a second trip to memory after its sum of
// squares. The sum runs in a fixed order: each thread's elements in turn,
// an xor-butterfly warp shuffle (every lane ends with the same bits), and
// across a row's warps their sums from shared memory in warp order; two
// launches on one input give the same bits. The row is then scaled from
// registers and written with 16-byte stores: nothing is read twice from
// device memory. Rows may carry a stride (the last dim must be
// contiguous); x, d or a stride that does not allow 16-byte packs takes an
// element-by-element instance, and a scale row that is not 16-byte aligned
// is read by scalar loads. The output is contiguous.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 8192;
constexpr int kWarpRowMaxD = 1024;  // up to here a warp owns a row in the guarded instances

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

// RT threads own a row, kThreads / RT rows a block; a thread holds NP
// packs of VEC elements of its row: pack t + i * RT for i < NP. EXACT: the
// row is exactly RT * NP packs, so no pack is guarded by j < d / VEC (on
// an H100 2-4% faster than the guarded loop at the same RT and NP;
// PERF.md).
template <typename T, int VEC, int RT, int NP, bool EXACT>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, long long x_stride, const float* __restrict__ scale,
               long long s_stride, long long rows_per_group, T* __restrict__ y,
               long long n_rows, int d, float eps) {
  constexpr int kRowsPerBlock = kThreads / RT;
  constexpr int kWPR = RT / 32;  // warps a row
  using P = Pack<T, VEC>;
  __shared__ float part[kWarps];

  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x % RT;
  const long long row = static_cast<long long>(blockIdx.x) * kRowsPerBlock + threadIdx.x / RT;
  const bool live = row < n_rows;  // uniform over the row's warps
  const int nvec = EXACT ? RT * NP : d / VEC;

  P buf[NP];
  float one_plus_s[NP][VEC];  // 1 + scale, loaded beside x
  float ss = 0.f;
  if (live) {
    const P* xr = reinterpret_cast<const P*>(x + row * x_stride);
    const float* sr = scale + (row / rows_per_group) * s_stride;
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int j = t + i * RT;
      if (EXACT || j < nvec) buf[i] = xr[j];
    }
    if (VEC % 4 == 0 && reinterpret_cast<uintptr_t>(sr) % 16 == 0) {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int j = t + i * RT;
        if (EXACT || j < nvec) {
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q) {
            const float4 f = __ldg(reinterpret_cast<const float4*>(sr + j * VEC) + q);
            one_plus_s[i][4 * q] = 1.f + f.x;
            one_plus_s[i][4 * q + 1] = 1.f + f.y;
            one_plus_s[i][4 * q + 2] = 1.f + f.z;
            one_plus_s[i][4 * q + 3] = 1.f + f.w;
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < NP; ++i) {
        const int j = t + i * RT;
        if (EXACT || j < nvec) {
#pragma unroll
          for (int k = 0; k < VEC; ++k) one_plus_s[i][k] = 1.f + __ldg(sr + j * VEC + k);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < NP; ++i) {
      const int j = t + i * RT;
      if (EXACT || j < nvec) {
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float f = to_f(buf[i].v[k]);
          ss += f * f;
        }
      }
    }
  }
  ss = warp_allsum(ss);
  if constexpr (kWPR > 1) {
    const int first = (warp / kWPR) * kWPR;
    if ((threadIdx.x & 31) == 0) part[warp] = ss;
    __syncthreads();
    ss = 0.f;
#pragma unroll
    for (int w = 0; w < kWPR; ++w) ss += part[first + w];
  }
  if (!live) return;

  const float r = rsqrtf(ss / static_cast<float>(d) + eps);
  P* yr = reinterpret_cast<P*>(y + row * static_cast<long long>(d));
#pragma unroll
  for (int i = 0; i < NP; ++i) {
    const int j = t + i * RT;
    if (EXACT || j < nvec) {
      P o;
#pragma unroll
      for (int k = 0; k < VEC; ++k) o.v[k] = from_f<T>(to_f(buf[i].v[k]) * r * one_plus_s[i][k]);
      yr[j] = o;
    }
  }
}

template <typename T, int VEC, int RT, int NP, bool EXACT>
cudaError_t launch_cfg(const void* x, long long x_stride, const float* scale,
                       long long s_stride, long long rows_per_group, void* y,
                       long long n_rows, int d, float eps, cudaStream_t s) {
  constexpr int kRowsPerBlock = kThreads / RT;
  const long long blocks = (n_rows + kRowsPerBlock - 1) / kRowsPerBlock;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, VEC, RT, NP, EXACT><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const T*>(x), x_stride, scale, s_stride, rows_per_group,
      static_cast<T*>(y), n_rows, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, long long n_rows, int d, long long x_stride,
                   const float* scale, long long s_stride, long long rows_per_group, void* y,
                   float eps, cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(T);
  const bool vec = d % kVec == 0 && x_stride % kVec == 0 &&
                   reinterpret_cast<uintptr_t>(x) % 16 == 0;
#define RMSNORM_LAUNCH(V, RT, NP, EXACT)                                                     \
  return launch_cfg<T, V, RT, NP, EXACT>(x, x_stride, scale, s_stride, rows_per_group, y, \
                                         n_rows, d, eps, s)
  if (vec) {
    // the repo's widths: RT threads a row, NP whole packs a thread
    if constexpr (sizeof(T) == 4) {
      switch (d) {
        case 1024: RMSNORM_LAUNCH(kVec, 64, 4, true);   // 256 packs
        case 5120: RMSNORM_LAUNCH(kVec, 256, 5, true);  // 1280
        case 7168: RMSNORM_LAUNCH(kVec, 256, 7, true);  // 1792
        case 8192: RMSNORM_LAUNCH(kVec, 256, 8, true);  // 2048
        default: break;
      }
    } else {
      switch (d) {
        case 1024: RMSNORM_LAUNCH(kVec, 32, 4, true);   // 128 packs
        case 5120: RMSNORM_LAUNCH(kVec, 128, 5, true);  // 640
        case 7168: RMSNORM_LAUNCH(kVec, 128, 7, true);  // 896
        case 8192: RMSNORM_LAUNCH(kVec, 256, 4, true);  // 1024
        default: break;
      }
    }
    // any other width: kVec * 8 * RT covers kWarpRowMaxD (a warp) and kMaxD
    // (a block) for both types
    if (d <= kWarpRowMaxD) RMSNORM_LAUNCH(kVec, 32, 8, false);
    RMSNORM_LAUNCH(kVec, kThreads, 8, false);
  }
  // element by element: 32 elements a thread cover both limits
  if (d <= kWarpRowMaxD) RMSNORM_LAUNCH(1, 32, 32, false);
  RMSNORM_LAUNCH(1, kThreads, 32, false);
#undef RMSNORM_LAUNCH
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
