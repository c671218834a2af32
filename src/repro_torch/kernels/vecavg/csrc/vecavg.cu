// FedVeca vectorized averaging for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/vecavg/kernel.py::_vecavg_kernel (vecavg_pallas):
//   for the stacked client matrix U [C, D] (float32 or bf16), weights p [C]
//   and a scalar scale, one pass over U gives
//     delta_w[d] = -scale * sum_c p[c] * U[c, d]     ([D], U's dtype)
//     sqn[c]     = sum_d U[c, d]^2                    ([C], float32)
//   with float32 accumulation.
//
// Bound on an H100 SXM (3.35 TB/s; 4*C*D float32 operations, far below the
// card's rate): U read once plus delta_w written once, C*D + D elements. At
// the paper's CNN on CIFAR-10 ([5, 555178] float32) that is 13.3 MB, about
// 4.0 us, so the kernel is bound by bytes.
//
// Design. The Pallas kernel keeps the per-client norms in one output block
// that every grid step adds into (`sqn_ref +=`), which relies on the TPU
// running the grid in order. Blocks of a GPU grid run in no order, so here:
//   pass 1: each block owns a tile of kTile columns and walks the C rows of
//     its tile once (coalesced loads, a column's weighted sum in registers),
//     writes its columns of delta_w, and writes its per-client partial sums
//     of squares to partial[tile, c] (warp shuffles, then the block's warps
//     summed in a fixed order);
//   pass 2: one block per client sums partial[:, c] over the tiles in a
//     fixed order.
// No atomics: two launches on the same input give the same bits. The
// ragged edge of D is masked here, not padded by a copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 4;  // columns a thread owns in its tile
constexpr int kTile = kThreads * kCols;

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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;  // lane 0 holds the sum
}

// pass 1: grid (n_tiles); dynamic shared memory C * kWarps floats
template <typename T>
__global__ void __launch_bounds__(kThreads)
vecavg_tile_kernel(const T* __restrict__ u, const float* __restrict__ p,
                   const float* __restrict__ scale, T* __restrict__ out,
                   float* __restrict__ partial, int C, long long D) {
  extern __shared__ float warp_sq[];  // [C][kWarps]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long base = static_cast<long long>(blockIdx.x) * kTile + tid;
  float acc[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) acc[i] = 0.f;
  for (int c = 0; c < C; ++c) {
    const float pc = p[c];
    const T* row = u + static_cast<long long>(c) * D;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kCols; ++i) {
      const long long d = base + i * kThreads;
      if (d < D) {
        const float v = to_f(row[d]);
        acc[i] += pc * v;
        sq += v * v;
      }
    }
    sq = warp_sum(sq);
    if (lane == 0) warp_sq[c * kWarps + warp] = sq;
  }
  const float s = -scale[0];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const long long d = base + i * kThreads;
    if (d < D) out[d] = from_f<T>(s * acc[i]);
  }
  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float t = 0.f;
    for (int w = 0; w < kWarps; ++w) t += warp_sq[c * kWarps + w];
    partial[static_cast<long long>(blockIdx.x) * C + c] = t;
  }
}

// pass 2: grid (C); block c sums partial[:, c] over the tiles
__global__ void __launch_bounds__(kThreads)
vecavg_sqnorm_kernel(const float* __restrict__ partial, float* __restrict__ sqn, int C,
                     int n_tiles) {
  __shared__ float ws[kWarps];
  const int c = blockIdx.x, tid = threadIdx.x;
  float t = 0.f;
  for (int j = tid; j < n_tiles; j += kThreads) t += partial[static_cast<long long>(j) * C + c];
  t = warp_sum(t);
  if ((tid & 31) == 0) ws[tid >> 5] = t;
  __syncthreads();
  if (tid == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += ws[w];
    sqn[c] = s;
  }
}

template <typename T>
int launch(const void* u, const float* p, const float* scale, void* out, float* partial,
           float* sqn, int C, long long D, cudaStream_t s) {
  const long long n_tiles = (D + kTile - 1) / kTile;
  const size_t smem = static_cast<size_t>(C) * kWarps * sizeof(float);
  vecavg_tile_kernel<T><<<static_cast<unsigned>(n_tiles), kThreads, smem, s>>>(
      static_cast<const T*>(u), p, scale, static_cast<T*>(out), partial, C, D);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  vecavg_sqnorm_kernel<<<C, kThreads, 0, s>>>(partial, sqn, C, static_cast<int>(n_tiles));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Columns a block of pass 1 owns: the wrapper sizes `partial` as
// ceil(D / vecavg_tile()) * C floats.
int vecavg_tile() { return kTile; }

// dtype: 0 = float32, 1 = bfloat16. C in [1, 1536] (pass 1's shared
// memory), D >= 1. Returns a cudaError_t.
int vecavg_launch(int dtype, const void* u, const float* p, const float* scale, void* out,
                  float* partial, float* sqn, int C, long long D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch<float>(u, p, scale, out, partial, sqn, C, D, s);
    case 1:
      return launch<__nv_bfloat16>(u, p, scale, out, partial, sqn, C, D, s);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // extern "C"
