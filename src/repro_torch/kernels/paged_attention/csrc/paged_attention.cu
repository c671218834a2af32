// Paged-attention decode and paged insert for Hopper (sm_90a), plain C ABI.
//
// paged_decode_kernel replaces the Pallas TPU kernel
//   src/repro/kernels/paged_attention/kernel.py::_decode_kernel
//   (paged_decode_attention_pallas): one decode tick against the shared
//   KV page pool, with the new token's K/V row written into the pool in
//   the same launch.
// paged_insert_kernel replaces
//   src/repro/kernels/paged_attention/kernel.py::_insert_kernel
//   (paged_insert_pallas): a layer-stacked copy of one prefill cache onto
//   its allocated pool pages.
//
// Bound on an H100 SXM (3.35 TB/s; no tensor-core work worth counting):
//   decode moves q, k_new, v_new, o and, per slot, the K and V rows of its
//   valid entries: ~2 * rows * Hkv * hd * bytes. At StarCoder2-3B widths
//   (Hkv 2, hd 128, bf16) that is 1 KiB per cached token per layer, so the
//   kernel is bound by bytes. Design against that bound: each (slot, kv
//   head) block loads every page row once with 16-byte vector loads and
//   reuses it for all G = Hq/Hkv query rows of the group; pages marked -1
//   and pages holding no valid entry are skipped without a load; scores,
//   the online softmax and the output accumulator stay in shared memory.
//   What it does not do yet: with B*Hkv blocks (16 at B = 8) most of the
//   132 SMs idle; splitting the page walk across blocks (flash decoding)
//   is queued in ROADMAP.md.
//   insert moves 2 * (allocated pages) * L * page bytes, read once and
//   written once, in 16-byte vectors: bound by bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Entry i of a slot is valid iff its page is allocated (checked by the
// caller) and, for full attention, i <= pos; for an SWA ring of modulus W,
// i < W and pos - ((pos - i) mod W) >= 0, with a FLOOR modulo: C++ `%`
// truncates toward zero and goes negative for pos < i.
__device__ __forceinline__ bool entry_valid(int i, int pos, int window) {
  if (window) {
    const int m = ((pos - i) % window + window) % window;
    return i < window && pos - m >= 0;
  }
  return i <= pos;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

// 16 bytes of T -> floats.
template <typename T>
__device__ __forceinline__ void unpack16(const void* src, float* dst) {
  constexpr int E = 16 / sizeof(T);
  const uint4 u = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int j = 0; j < E; ++j) dst[j] = to_f<T>(e[j]);
}

// Grid (B, Hkv); one block holds the G query rows of one (slot, kv head)
// and walks the slot's page table.
//
// The new token's row: active slots whose target page is allocated write
// it into the pool (a predicated store; pages are write-exclusive to their
// slot, so no other block reads that row in this launch), and the page
// walk reads it from k_new/v_new instead of the pool ("injection", as the
// Pallas kernel does), so the block never reads a row it is writing and
// needs no barrier between the store and the walk.
template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, T* k_pool, T* v_pool,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    const int* __restrict__ page_table, const int* __restrict__ pos_arr,
                    const int* __restrict__ active_arr, T* __restrict__ out,
                    int Hkv, int G, int hd, int ps, int P, int window, float scale) {
  const int b = blockIdx.x, h = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  constexpr int nwarps = kThreads / 32;

  extern __shared__ float smem[];
  float* q_s = smem;            // [G][hd]
  float* o_s = q_s + G * hd;    // [G][hd] unnormalised output
  float* k_s = o_s + G * hd;    // [ps][hd]
  float* v_s = k_s + ps * hd;   // [ps][hd]
  float* p_s = v_s + ps * hd;   // [G][ps] scores, then probabilities
  float* m_s = p_s + G * ps;    // [G] running max
  float* l_s = m_s + G;         // [G] running denominator
  float* c_s = l_s + G;         // [G] this page's rescale factor

  const int pos = pos_arr[b];
  const bool act = active_arr[b] != 0;
  const int idx = window ? ((pos % window) + window) % window : pos;
  const int wpage = idx / ps, wrow = idx % ps;
  const int wphys = wpage < P ? page_table[(size_t)b * P + wpage] : -1;
  const size_t new_off = ((size_t)b * Hkv + h) * hd;

  if (act && wphys >= 0) {
    const size_t off = (((size_t)wphys * ps + wrow) * Hkv + h) * hd;
    for (int d = tid; d < hd; d += kThreads) {
      k_pool[off + d] = k_new[new_off + d];
      v_pool[off + d] = v_new[new_off + d];
    }
  }

  const int Hq = Hkv * G;
  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd, d = e % hd;
    q_s[e] = to_f<T>(q[((size_t)b * Hq + h * G + g) * hd + d]);
    o_s[e] = 0.f;
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  __syncthreads();

  constexpr int vec = 16 / sizeof(T);
  const int nv = hd / vec;  // 16-byte vectors per row (wrapper checks hd % vec == 0)
  for (int p = 0; p < P; ++p) {
    const int phys = page_table[(size_t)b * P + p];
    // The valid entries of a slot are the prefix i <= min(pos, W - 1), so
    // a page whose first entry is invalid holds none. Skipping such a page
    // (or an unallocated one) is exact: with every score masked it leaves
    // m, l and o unchanged (probabilities masked to 0, rescale exp(0) = 1).
    if (phys < 0 || !entry_valid(p * ps, pos, window)) continue;  // block-uniform
    const bool inject = act && p == wpage;

    for (int e = tid; e < ps * nv; e += kThreads) {
      const int r = e / nv, c = (e % nv) * vec;
      const T* ks;
      const T* vs;
      if (inject && r == wrow) {
        ks = k_new + new_off + c;
        vs = v_new + new_off + c;
      } else {
        const size_t off = (((size_t)phys * ps + r) * Hkv + h) * hd + c;
        ks = k_pool + off;
        vs = v_pool + off;
      }
      unpack16<T>(ks, k_s + r * hd + c);
      unpack16<T>(vs, v_s + r * hd + c);
    }
    __syncthreads();

    // scores: one warp per (g, r) dot product of length hd
    for (int s = warp; s < G * ps; s += nwarps) {
      const int g = s / ps, r = s % ps;
      float acc = 0.f;
      for (int d = lane; d < hd; d += 32) acc += q_s[g * hd + d] * k_s[r * hd + d];
      acc = warp_sum(acc);
      if (lane == 0) p_s[s] = entry_valid(p * ps + r, pos, window) ? acc * scale : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per query row; mask applied after the exp
    for (int g = warp; g < G; g += nwarps) {
      const float m_prev = m_s[g], l_prev = l_s[g];
      float mx = kNegInf;
      for (int r = lane; r < ps; r += 32) mx = fmaxf(mx, p_s[g * ps + r]);
      const float m_new = fmaxf(m_prev, warp_max(mx));
      float sum = 0.f;
      for (int r = lane; r < ps; r += 32) {
        const float e = entry_valid(p * ps + r, pos, window) ? expf(p_s[g * ps + r] - m_new) : 0.f;
        p_s[g * ps + r] = e;
        sum += e;
      }
      sum = warp_sum(sum);
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        c_s[g] = corr;
        m_s[g] = m_new;
        l_s[g] = l_prev * corr + sum;
      }
    }
    __syncthreads();

    for (int e = tid; e < G * hd; e += kThreads) {
      const int g = e / hd, d = e % hd;
      float pv = 0.f;
      for (int r = 0; r < ps; ++r) pv += p_s[g * ps + r] * v_s[r * hd + d];
      o_s[e] = o_s[e] * c_s[g] + pv;
    }
    __syncthreads();
  }

  for (int e = tid; e < G * hd; e += kThreads) {
    const int g = e / hd, d = e % hd;
    out[((size_t)b * Hq + h * G + g) * hd + d] = from_f<T>(o_s[e] / fmaxf(l_s[g], 1e-30f));
  }
}

// Grid (P, L, 2): block (j, l, z) copies logical page j of layer l of the
// K (z = 0) or V (z = 1) source onto pool page page_ids[j]; -1 is skipped.
// A byte copy, so it is exact for any dtype.
__global__ void __launch_bounds__(kThreads)
paged_insert_kernel(char* k_pool, char* v_pool, const char* __restrict__ k_src,
                    const char* __restrict__ v_src, const int* __restrict__ page_ids,
                    int N, int P, long long page_bytes) {
  const int j = blockIdx.x, l = blockIdx.y;
  const int dst = page_ids[j];
  if (dst < 0) return;
  char* pool = blockIdx.z ? v_pool : k_pool;
  const char* src = blockIdx.z ? v_src : k_src;
  char* d = pool + ((long long)l * N + dst) * page_bytes;
  const char* s = src + ((long long)l * P + j) * page_bytes;
  if (page_bytes % 16 == 0) {
    uint4* d4 = reinterpret_cast<uint4*>(d);
    const uint4* s4 = reinterpret_cast<const uint4*>(s);
    for (long long e = threadIdx.x; e < page_bytes / 16; e += kThreads) d4[e] = s4[e];
  } else {
    for (long long e = threadIdx.x; e < page_bytes; e += kThreads) d[e] = s[e];
  }
}

template <typename T>
cudaError_t launch_decode(const void* q, void* k_pool, void* v_pool, const void* k_new,
                          const void* v_new, const int* page_table, const int* pos,
                          const int* active, void* out, int B, int Hkv, int G, int hd,
                          int ps, int P, int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (2 * (size_t)G * hd + 2 * (size_t)ps * hd +
                                       (size_t)G * ps + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(paged_decode_kernel<T>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return err;
  }
  paged_decode_kernel<T><<<dim3(B, Hkv), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<T*>(k_pool), static_cast<T*>(v_pool),
      static_cast<const T*>(k_new), static_cast<const T*>(v_new), page_table, pos, active,
      static_cast<T*>(out), Hkv, G, hd, ps, P, window, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t.
int paged_decode_attention_launch(int dtype, const void* q, void* k_pool, void* v_pool,
                                  const void* k_new, const void* v_new,
                                  const int* page_table, const int* pos, const int* active,
                                  void* out, int B, int Hkv, int G, int hd, int ps, int P,
                                  int window, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0:
      return launch_decode<float>(q, k_pool, v_pool, k_new, v_new, page_table, pos, active,
                                  out, B, Hkv, G, hd, ps, P, window, scale, s);
    case 1:
      return launch_decode<__nv_bfloat16>(q, k_pool, v_pool, k_new, v_new, page_table, pos,
                                          active, out, B, Hkv, G, hd, ps, P, window, scale, s);
    default:
      return cudaErrorInvalidValue;
  }
}

int paged_insert_launch(void* k_pool, void* v_pool, const void* k_src, const void* v_src,
                        const int* page_ids, int L, int N, int P, long long page_bytes,
                        void* stream) {
  paged_insert_kernel<<<dim3(P, L, 2), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<char*>(k_pool), static_cast<char*>(v_pool),
      static_cast<const char*>(k_src), static_cast<const char*>(v_src), page_ids, N, P,
      page_bytes);
  return cudaGetLastError();
}

}  // extern "C"
