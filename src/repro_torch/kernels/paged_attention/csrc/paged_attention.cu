// Paged-attention decode and paged insert for Hopper (sm_90a), plain C ABI.
//
// paged_decode_kernel and paged_decode_merge_kernel replace the Pallas TPU
// kernel
//   src/repro/kernels/paged_attention/kernel.py::_decode_kernel
//   (paged_decode_attention_pallas): one decode tick against the shared
//   KV page pool, with the new token's K/V row written into the pool in
//   the same call.
// paged_insert_kernel replaces
//   src/repro/kernels/paged_attention/kernel.py::_insert_kernel
//   (paged_insert_pallas): a layer-stacked copy of one prefill cache onto
//   its allocated pool pages.
//
// Bound on an H100 SXM (3.35 TB/s; no tensor-core work worth counting):
//   decode moves q, k_new, v_new, o and, per slot, the K and V rows of its
//   valid entries: ~2 * rows * Hkv * hd * bytes. At StarCoder2-3B widths
//   (Hkv 2, hd 128, bf16) that is 1 KiB per cached token per layer: ~6.6 MB
//   and ~2 us at the serving trace's mid-point (8 slots, ~800 live (slot,
//   kv head, page) items of 8 KiB). One block per (slot, kv head) would
//   put 16 blocks on 132 SMs, so the decode is split ("flash decoding"):
//   - Grid (S, Hkv, B): split s of a (slot, kv head) owns the logical pages
//     s, s + S, s + 2S, ... of its page table, and warp w of the split's
//     kDecodeWarps warps the k-th of those for k = w mod kDecodeWarps. The
//     live pages of a slot are a prefix of its table, so every split gets
//     a fair share of them whatever pos is; a split whose first page holds
//     no valid entry has no live key and exits at once. The wrapper
//     (ops.py) picks S from B, Hkv, P, the SM count and the blocks of the
//     instance an SM holds (paged_decode_occupancy: the occupancy API on
//     the instance's registers and shared memory), never from pos, which
//     lives on the card, so the grid runs in one wave; at the serving
//     state (bf16, 2 blocks an SM) S = 16, 256 blocks.
//   - A warp owns whole pages: it stages each page's valid K and V rows in
//     its own shared memory with 16-byte cp.async, double-buffered so that
//     its next page is in flight while it computes the current one (the
//     copies take no registers, and a row lands once for all G query rows
//     of its kv head). There is no block barrier a page; only __syncwarp.
//   - q stays in registers: lane (gg, ds) holds query rows gg + 4j (j <
//     GPL = ceil(G / 4)) at the 1/8 of hd that d-slice ds owns, and the
//     same slice of their float32 output. A score is a slice dot product
//     and three shuffles across the 8 d-slices; softmax runs online over
//     steps of kRows rows; P V is a multiply-add per owned element. CUDA
//     cores in both types (G x ps x hd is too small a product to pay for
//     the tensor cores' layout here; ROADMAP B12). A step is straight-line
//     code: rows past the page's valid ones repeat its last valid row and
//     are masked, so shared memory never holds a row that is read unset.
//   - The warps of a block merge once at the end, in warp order, through
//     shared memory, into one float32 partial (m, l, o[G, hd]) per split in
//     the workspace the wrapper allocates (B * Hkv * S * G * (hd + 2)
//     floats: 1.60 MB at the serving state). A split with no live
//     key writes m = -1e30, l = 0 and no o.
//   - paged_decode_merge_kernel, grid (G, Hkv, B), combines the S partials
//     of each query row in split order (M = max m, c = exp(m - M), l = sum
//     c l, o = sum c o; o / max(l, 1e-30), so a slot with no live key gives
//     0) and rounds to the output type. No float atomics: two calls on the
//     same inputs give the same bits.
//   What it leaves open (ROADMAP B12): the bf16 G x page products on
//   mma.sync, and the merge in the same launch.
//
//   insert moves 2 * (allocated pages) * L * page bytes, read once and
//   written once, in 16-byte vectors: bound by bytes.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kThreads = 256;      // paged_insert_kernel
constexpr int kDecodeWarps = 4;    // warps of a decode block (ref.py's DECODE_WARPS)
constexpr int kSlices = 8;         // lanes that share a query row, each 1/8 of hd
constexpr int kGroups = 32 / kSlices;  // query-row groups of a warp
constexpr int kRows = 8;           // key rows a step of the online softmax

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
// truncates toward zero and goes negative for pos < i. Either way the
// valid entries are a prefix of the slot (i <= pos, or i <= min(pos, W - 1)).
__device__ __forceinline__ bool entry_valid(int i, int pos, int window) {
  if (window) {
    const int m = ((pos - i) % window + window) % window;
    return i < window && pos - m >= 0;
  }
  return i <= pos;
}

// The valid rows of logical page p, counted by the whole warp: rows
// [0, n) by the prefix property.
__device__ __forceinline__ int valid_rows(int p, int ps, int pos, int window, int lane) {
  int n = 0;
  for (int r0 = 0; r0 < ps; r0 += 32) {
    const int r = r0 + lane;
    n += __popc(__ballot_sync(0xffffffffu, r < ps && entry_valid(p * ps + r, pos, window)));
  }
  return n;
}

// A lane's slice of a row of HD elements: NV vectors of VE elements, 16
// bytes where they divide the slice's D * sizeof(T) bytes and 8 otherwise
// (bf16 at hd 96: a 24-byte slice, three 8-byte vectors), vector c of
// d-slice ds at column c * kSlices * VE + ds * VE, so the 8 slices of one
// vector index read 8 neighbouring vectors (no bank conflict in shared
// memory; the 4 query-row groups read the same ones).
template <typename T, int HD>
struct Slice {
  static constexpr int D = HD / kSlices;
  static constexpr int VE = (D * sizeof(T)) % 16 == 0 ? 16 / sizeof(T) : 8 / sizeof(T);
  static constexpr int NV = D / VE;
  static_assert(HD % kSlices == 0 && NV * VE == D, "a slice is whole vectors");
  static_assert(VE * sizeof(T) == 16 || VE * sizeof(T) == 8, "8- or 16-byte vectors");
  __device__ static int col(int c, int ds) { return c * kSlices * VE + ds * VE; }
};

template <typename T, int N>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  if constexpr (N * sizeof(T) == 16) {
    const uint4 u = *reinterpret_cast<const uint4*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = to_f<T>(e[j]);
  } else {
    const uint2 u = *reinterpret_cast<const uint2*>(src);
    const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
    for (int j = 0; j < N; ++j) dst[j] = to_f<T>(e[j]);
  }
}

template <typename T, int HD>
__device__ __forceinline__ void load_slice(const T* row, int ds, float* dst) {
  using S = Slice<T, HD>;
#pragma unroll
  for (int c = 0; c < S::NV; ++c) load_vec<T, S::VE>(row + S::col(c, ds), dst + c * S::VE);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp's next page to walk: logical page p = s + S * (w + kDecodeWarps
// * k) for the smallest k >= the walk's k that is allocated; false once p
// is past the table or past the slot's valid prefix. Warp-uniform.
__device__ __forceinline__ bool next_page(const int* pt_row, int s, int S, int w, int P,
                                          int ps, int pos, int window, int& k, int& p,
                                          int& phys) {
  for (;; ++k) {
    p = s + S * (w + kDecodeWarps * k);
    if (p >= P || !entry_valid(p * ps, pos, window)) return false;
    phys = pt_row[p];
    if (phys >= 0) {
      ++k;
      return true;
    }
  }
}

// Stages rows [0, n) of page `phys` (kv head h) into kb / vb with 16-byte
// cp.async; row `inject` (or -1) comes from k_new / v_new instead: the new
// token's row, which split 0 writes into the pool in this launch, is never
// read from the pool.
template <typename T, int HD>
__device__ __forceinline__ void stage_page(T* kb, T* vb, const T* k_pool, const T* v_pool,
                                           const T* kn, const T* vn, int phys, int n,
                                           int inject, int ps, int Hkv, int h, int lane) {
  constexpr int VEC = 16 / sizeof(T), CPR = HD / VEC;  // 16-byte chunks a row
  for (int e = lane; e < n * CPR; e += 32) {
    const int r = e / CPR, c = (e % CPR) * VEC;
    const size_t off = (((size_t)phys * ps + r) * Hkv + h) * HD + c;
    cp_async16(kb + r * HD + c, r == inject ? kn + c : k_pool + off);
    cp_async16(vb + r * HD + c, r == inject ? vn + c : v_pool + off);
  }
}

// Grid (S, Hkv, B), kDecodeWarps warps; see the header. part holds
// [B][Hkv][S][G][HD] partial outputs, then [B][Hkv][S][G][2] (m, l).
template <typename T, int HD, int GPL>
__global__ void __launch_bounds__(kDecodeWarps * 32, 1)
paged_decode_kernel(const T* __restrict__ q, T* k_pool, T* v_pool,
                    const T* __restrict__ k_new, const T* __restrict__ v_new,
                    const int* __restrict__ page_table, const int* __restrict__ pos_arr,
                    const uint8_t* __restrict__ active_arr, float* __restrict__ part, int B,
                    int Hkv, int G, int ps, int P, int window, float scale) {
  using SL = Slice<T, HD>;
  constexpr int D = SL::D;
  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z, S = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gg = lane / kSlices, ds = lane % kSlices;

  const int pos = pos_arr[b];
  const bool act = active_arr[b] != 0;
  const int* pt_row = page_table + (size_t)b * P;
  const int idx = window ? ((pos % window) + window) % window : pos;
  const int wpage = idx / ps, wrow = idx % ps;
  const size_t new_off = ((size_t)b * Hkv + h) * HD;

  // The new token's row: written once per (slot, kv head), by split 0, for
  // active slots whose target page is allocated.
  if (s == 0 && act && wpage < P) {
    const int wphys = pt_row[wpage];
    if (wphys >= 0) {
      const size_t off = (((size_t)wphys * ps + wrow) * Hkv + h) * HD;
      for (int c = tid; c < HD * (int)sizeof(T) / 16; c += blockDim.x) {
        reinterpret_cast<uint4*>(k_pool + off)[c] =
            reinterpret_cast<const uint4*>(k_new + new_off)[c];
        reinterpret_cast<uint4*>(v_pool + off)[c] =
            reinterpret_cast<const uint4*>(v_new + new_off)[c];
      }
    }
  }

  const size_t split = ((size_t)b * Hkv + h) * S + s;
  float* part_o = part + split * G * HD;
  float* part_ml = part + (size_t)B * Hkv * S * G * HD + split * G * 2;
  if (!entry_valid(s * ps, pos, window)) {  // past the valid prefix: no live key
    for (int g = tid; g < G; g += blockDim.x) {
      part_ml[2 * g] = kNegInf;
      part_ml[2 * g + 1] = 0.f;
    }
    return;
  }

  float qr[GPL][D], o[GPL][D], m[GPL], l[GPL];
#pragma unroll
  for (int j = 0; j < GPL; ++j) {
    const int g = gg + kGroups * j;
    if (g < G) {
      load_slice<T, HD>(q + ((size_t)b * Hkv * G + h * G + g) * HD, ds, qr[j]);
    } else {
#pragma unroll
      for (int d = 0; d < D; ++d) qr[j][d] = 0.f;
    }
#pragma unroll
    for (int d = 0; d < D; ++d) o[j][d] = 0.f;
    m[j] = kNegInf;
    l[j] = 0.f;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  // this warp's two page buffers, each K rows then V rows: [2][2][ps][HD]
  T* wbuf = reinterpret_cast<T*>(smem_raw) + (size_t)warp * 4 * ps * HD;
  const T* kn = k_new + new_off;
  const T* vn = v_new + new_off;

  int k = 0, p, phys;
  bool have = next_page(pt_row, s, S, warp, P, ps, pos, window, k, p, phys);
  int n = have ? valid_rows(p, ps, pos, window, lane) : 0;
  if (have) {
    stage_page<T, HD>(wbuf, wbuf + ps * HD, k_pool, v_pool, kn, vn, phys, n,
                      act && p == wpage ? wrow : -1, ps, Hkv, h, lane);
  }
  cp_async_commit();
  int buf = 0;
  while (have) {
    int p2, phys2;
    const bool more = next_page(pt_row, s, S, warp, P, ps, pos, window, k, p2, phys2);
    const int n2 = more ? valid_rows(p2, ps, pos, window, lane) : 0;
    if (more) {
      T* nb = wbuf + (size_t)(buf ^ 1) * 2 * ps * HD;
      stage_page<T, HD>(nb, nb + ps * HD, k_pool, v_pool, kn, vn, phys2, n2,
                        act && p2 == wpage ? wrow : -1, ps, Hkv, h, lane);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this page's copies have landed (the next may fly)
    __syncwarp();

    const T* kb = wbuf + (size_t)buf * 2 * ps * HD;
    const T* vb = kb + ps * HD;
#pragma unroll 1
    for (int r0 = 0; r0 < n; r0 += kRows) {
      // A step is straight-line code over kRows rows: rows past n repeat
      // row n - 1 and are masked out (score -1e30, probability 0).
      float sc[GPL][kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float kf[D];
        load_slice<T, HD>(kb + min(r0 + i, n - 1) * HD, ds, kf);
#pragma unroll
        for (int j = 0; j < GPL; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < D; ++d) acc = fmaf(qr[j][d], kf[d], acc);
#pragma unroll
          for (int off = 1; off < kSlices; off <<= 1)
            acc += __shfl_xor_sync(0xffffffffu, acc, off);
          sc[j][i] = r0 + i < n ? acc * scale : kNegInf;
        }
      }
#pragma unroll
      for (int j = 0; j < GPL; ++j) {
        float mx = sc[j][0];
#pragma unroll
        for (int i = 1; i < kRows; ++i) mx = fmaxf(mx, sc[j][i]);
        const float m_new = fmaxf(m[j], mx);
        const float corr = expf(m[j] - m_new);
        float sum = 0.f;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          const float e = r0 + i < n ? expf(sc[j][i] - m_new) : 0.f;
          sc[j][i] = e;
          sum += e;
        }
        l[j] = l[j] * corr + sum;
        m[j] = m_new;
#pragma unroll
        for (int d = 0; d < D; ++d) o[j][d] *= corr;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float vf[D];
        load_slice<T, HD>(vb + min(r0 + i, n - 1) * HD, ds, vf);
#pragma unroll
        for (int j = 0; j < GPL; ++j) {
#pragma unroll
          for (int d = 0; d < D; ++d) o[j][d] = fmaf(sc[j][i], vf[d], o[j][d]);
        }
      }
    }
    __syncwarp();  // every lane is done with this buffer before it is refilled
    buf ^= 1;
    have = more;
    p = p2;
    phys = phys2;
    n = n2;
  }
  cp_async_wait<0>();

  // Merge the warps in warp order through shared memory (the page buffers
  // are free once every warp is past this barrier).
  __syncthreads();
  float* mo = reinterpret_cast<float*>(smem_raw);  // [warps][G][HD]
  float* mm = mo + kDecodeWarps * G * HD;          // [warps][G] m
  float* mlr = mm + kDecodeWarps * G;              // [warps][G] l
#pragma unroll
  for (int j = 0; j < GPL; ++j) {
    const int g = gg + kGroups * j;
    if (g < G) {
#pragma unroll
      for (int c = 0; c < SL::NV; ++c) {
#pragma unroll
        for (int e = 0; e < SL::VE; ++e)
          mo[(warp * G + g) * HD + SL::col(c, ds) + e] = o[j][c * SL::VE + e];
      }
      if (ds == 0) {
        mm[warp * G + g] = m[j];
        mlr[warp * G + g] = l[j];
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < G * HD; e += blockDim.x) {
    const int g = e / HD, d = e % HD;
    float M = kNegInf;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) M = fmaxf(M, mm[w * G + g]);
    float acc = 0.f, lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float c = expf(mm[w * G + g] - M);
      acc = fmaf(c, mo[(w * G + g) * HD + d], acc);
      lsum = fmaf(c, mlr[w * G + g], lsum);
    }
    part_o[e] = acc;
    if (d == 0) {
      part_ml[2 * g] = M;
      part_ml[2 * g + 1] = lsum;
    }
  }
}

// Grid (G, Hkv, B), HD / 4 threads: the S partials of one query row, in
// split order, each thread 4 columns.
template <typename T, int HD>
__global__ void __launch_bounds__(HD / 4)
paged_decode_merge_kernel(const float* __restrict__ part, T* __restrict__ out, int B, int Hkv,
                          int G, int S) {
  const int g = blockIdx.x, h = blockIdx.y, b = blockIdx.z, d0 = threadIdx.x * 4;
  const size_t first = ((size_t)b * Hkv + h) * S;
  const float* ml = part + (size_t)B * Hkv * S * G * HD;
  float M = kNegInf;
  for (int s = 0; s < S; ++s) M = fmaxf(M, ml[((first + s) * G + g) * 2]);
  float acc[4] = {0.f, 0.f, 0.f, 0.f}, l = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t i = (first + s) * G + g;
    const float ls = ml[2 * i + 1];
    const float c = expf(ml[2 * i] - M);
    l = fmaf(c, ls, l);
    if (ls > 0.f) {  // a split with no live key wrote no o
      const float4 v = *reinterpret_cast<const float4*>(part + i * HD + d0);
      acc[0] = fmaf(c, v.x, acc[0]);
      acc[1] = fmaf(c, v.y, acc[1]);
      acc[2] = fmaf(c, v.z, acc[2]);
      acc[3] = fmaf(c, v.w, acc[3]);
    }
  }
  const float den = fmaxf(l, 1e-30f);
  T* dst = out + (((size_t)b * Hkv + h) * G + g) * HD + d0;
#pragma unroll
  for (int e = 0; e < 4; ++e) dst[e] = from_f<T>(acc[e] / den);
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

struct DecodeArgs {
  const void* q;
  void* k_pool;
  void* v_pool;
  const void* k_new;
  const void* v_new;
  const int* page_table;
  const int* pos;
  const uint8_t* active;
  float* part;
  void* out;
  int B, Hkv, G, ps, P, S, window;
  float scale;
};

// Shared memory of a decode block: the warps' double page buffers, or the
// end-of-block merge, whichever is larger.
template <typename T, int HD>
size_t decode_smem(int G, int ps) {
  const size_t pages = (size_t)kDecodeWarps * 4 * ps * HD * sizeof(T);
  const size_t merge = (size_t)kDecodeWarps * G * (HD + 2) * sizeof(float);
  return pages > merge ? pages : merge;
}

template <typename T, int HD, int GPL>
cudaError_t allow_decode_smem(size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(paged_decode_kernel<T, HD, GPL>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

template <typename T, int HD, int GPL>
cudaError_t launch_decode(const DecodeArgs& a, cudaStream_t stream) {
  const size_t smem = decode_smem<T, HD>(a.G, a.ps);
  cudaError_t err = allow_decode_smem<T, HD, GPL>(smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, HD, GPL><<<dim3(a.S, a.Hkv, a.B), kDecodeWarps * 32, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<T*>(a.k_pool), static_cast<T*>(a.v_pool),
      static_cast<const T*>(a.k_new), static_cast<const T*>(a.v_new), a.page_table, a.pos,
      a.active, a.part, a.B, a.Hkv, a.G, a.ps, a.P, a.window, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_merge_kernel<T, HD><<<dim3(a.G, a.Hkv, a.B), HD / 4, 0, stream>>>(
      a.part, static_cast<T*>(a.out), a.B, a.Hkv, a.G, a.S);
  return cudaGetLastError();
}

// The shared memory a decode block of this instance takes and how many such
// blocks an SM holds at once (0: one does not fit), on the current device.
template <typename T, int HD, int GPL>
cudaError_t decode_occupancy(int G, int ps, int* smem_out, int* blocks_out) {
  const size_t smem = decode_smem<T, HD>(G, ps);
  *smem_out = (int)smem;
  *blocks_out = 0;
  int dev = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess || smem > (size_t)optin) return err;
  err = allow_decode_smem<T, HD, GPL>(smem);
  if (err != cudaSuccess) return err;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_out, paged_decode_kernel<T, HD, GPL>, kDecodeWarps * 32, smem);
}

template <typename T_, int HD_, int GPL_>
struct Instance {
  using T = T_;
  static constexpr int HD = HD_, GPL = GPL_;
};

// Calls f(Instance<T, HD, GPL>{}) for the decode instance of (dtype, hd, G):
// float32 (0) or bf16 (1), hd 32, 64, 96 or 128, GPL = ceil(G / 4) query
// rows a lane, G <= 16. Every row is a whole number of 16-byte chunks at
// these head dims (hd 96: 12 in bf16, 24 in float32), which stage_page, the
// new-row write and the merge's float4 columns (HD / 4 = 24 threads) need.
template <typename T, int HD, typename F>
cudaError_t with_rows(int G, F&& f) {
  switch ((G + kGroups - 1) / kGroups) {
    case 1: return f(Instance<T, HD, 1>{});
    case 2: return f(Instance<T, HD, 2>{});
    case 3: return f(Instance<T, HD, 3>{});
    case 4: return f(Instance<T, HD, 4>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, typename F>
cudaError_t with_hd(int hd, int G, F&& f) {
  switch (hd) {
    case 32: return with_rows<T, 32>(G, f);
    case 64: return with_rows<T, 64>(G, f);
    case 96: return with_rows<T, 96>(G, f);
    case 128: return with_rows<T, 128>(G, f);
    default: return cudaErrorInvalidValue;
  }
}

template <typename F>
cudaError_t with_instance(int dtype, int hd, int G, F&& f) {
  switch (dtype) {
    case 0: return with_hd<float>(hd, G, f);
    case 1: return with_hd<__nv_bfloat16>(hd, G, f);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; active is bool bytes; part is the
// float32 workspace of B * Hkv * splits * G * (hd + 2) floats. Head dims
// 32, 64, 96 and 128 and G <= 16 only. Returns a cudaError_t.
int paged_decode_attention_launch(int dtype, const void* q, void* k_pool, void* v_pool,
                                  const void* k_new, const void* v_new,
                                  const int* page_table, const int* pos,
                                  const uint8_t* active, float* part, void* out, int B,
                                  int Hkv, int G, int hd, int ps, int P, int splits,
                                  int window, float scale, void* stream) {
  if (splits < 1 || splits > P) return cudaErrorInvalidValue;
  const DecodeArgs a{q, k_pool, v_pool, k_new, v_new, page_table, pos, active, part, out,
                     B, Hkv, G, ps, P, splits, window, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return with_instance(dtype, hd, G, [&](auto inst) {
    using I = decltype(inst);
    return launch_decode<typename I::T, I::HD, I::GPL>(a, s);
  });
}

// The dynamic shared memory (bytes) of the decode instance for (dtype, hd,
// G, ps) and the blocks of it that an SM of the current device holds at
// once, 0 if one does not fit. ops.py takes its split count from these.
// Returns a cudaError_t.
int paged_decode_occupancy(int dtype, int hd, int G, int ps, int* smem, int* blocks) {
  return with_instance(dtype, hd, G, [&](auto inst) {
    using I = decltype(inst);
    return decode_occupancy<typename I::T, I::HD, I::GPL>(G, ps, smem, blocks);
  });
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
