// FedVeca vectorized averaging for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/vecavg/kernel.py::_vecavg_kernel (vecavg_pallas),
// and the two copies the JAX package makes before it: FedVeca's
// G = cum_g / tau (src/repro/core/strategy.py, server_delta) and the tree
// form's float32 [C, D] concatenation of every leaf
// (src/repro/kernels/vecavg/ops.py, vecavg_tree). Over a table of leaves
// U_l [C, n_l] (float32 or bf16, each where it lies), weights p [C], a
// scalar scale and an optional divisor div [C], one launch computes
//   v_l[c, j] = U_l[c, j] / div[c]   (IEEE division; U_l[c, j] without div)
//   delta_l[j] = -scale * sum_c p[c] * v_l[c, j]   (each leaf's own output,
//                                                    float32 or bf16)
//   sqn[c]     = sum_l sum_j v_l[c, j]^2           (float32)
// with float32 accumulation.
//
// Bound on an H100 SXM (3.35 TB/s; ~4 float32 operations an element, far
// below the card's rate): every leaf read once and every output written
// once. At the paper's CNN on CIFAR-10 ([5, 555178] float32) that is 13.3
// MB, about 4.0 us; at Qwen1.5-0.5B's widths (2 clients, 464 M float32
// parameters) 5.6 GB, about 1.66 ms. Bound by bytes.
//
// Design.
//  - One launch a call, and no copy: the wrapper passes a table of leaf
//    records by value, as a __grid_constant__ parameter (40 B a leaf, up to
//    kMaxLeaves; tables of 32 and 256 leaves, the smaller that holds the
//    call), so each leaf is read where it lies and each output written
//    where it lives.
//  - The concatenated column space is cut into chunks of kChunk columns
//    that never cross a leaf. A persistent grid of G blocks (the wrapper:
//    SMs x the blocks an SM holds, never more than the chunks) walks them,
//    chunk k going to block k mod G.
//  - Thread t of a block owns columns [8t, 8t + 8) of a chunk. It loads
//    them for a group of kGroup clients (4 or 8, from C) before it sums
//    any: 16-byte loads where a client's row is 16-byte aligned there,
//    scalar loads elsewhere (a ragged leaf tail; a misaligned row, such as
//    the CNN's 10-float bf2). Then it multiply-adds each into its 8 column
//    sums and each client's sum of squares. p and div come through L1.
//  - Norms without a second launch and without float atomics: each
//    client's square sum is reduced over the warp and added into shared
//    memory [C][warps]; at the end a block sums its warps into its column
//    of a [C][G] workspace, fences, and bumps an int counter. The last block
//    to arrive sums the G partials of each client with all its threads (a
//    client's partials cut into segments, 8 loads in flight a thread),
//    writes sqn and sets the counter back to 0 for the next launch.
//  - The order of every sum depends only on G and the shapes: not on the
//    dtype, the load width or the blocks' timing. Two launches on one input
//    give the same bits, and dividing here gives the bits of dividing first
//    (torch's a / b is the same IEEE division; build with no fast math; the
//    wrapper gives the instances with and without div the same G).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kCols = 8;                  // columns a thread owns in a chunk
constexpr int kChunk = kThreads * kCols;  // columns a chunk
constexpr int kMaxClients = 1536;         // shared memory: C x kWarps floats
constexpr int kMaxLeaves = 256;
constexpr int kF32 = 0;  // dtype codes: 0 float32, 1 bf16

// One leaf: rows of n columns, row c at in + c * n; the wrapper packs
// these records (struct "<QQqqii").
struct Leaf {
  const void* in;
  void* out;        // [n]
  long long n;      // columns: the leaf's numel over C
  long long chunk0; // its first chunk in the concatenated column space
  int in_dtype;     // a dtype code
  int out_dtype;
};
static_assert(sizeof(Leaf) == 40, "the wrapper packs 40-byte leaf records");

template <int kCap>
struct Table {
  Leaf leaf[kCap];
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
  return x;  // lane 0 holds the sum
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

__device__ __forceinline__ float bf16_bits(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
}

// v[k] = element k of the nv columns at src (the rest 0)
__device__ __forceinline__ void load_cols(const Leaf& L, long long at, int nv,
                                          float (&v)[kCols]) {
  if (L.in_dtype == kF32) {
    const float* src = static_cast<const float*>(L.in) + at;
    if (nv == kCols && aligned16(src)) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src));
      const float4 b = __ldg(reinterpret_cast<const float4*>(src) + 1);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
      v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) v[k] = k < nv ? __ldg(src + k) : 0.f;
    }
  } else {
    const unsigned short* src = static_cast<const unsigned short*>(L.in) + at;
    if (nv == kCols && aligned16(src)) {
      const uint4 r = __ldg(reinterpret_cast<const uint4*>(src));
      const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        v[2 * i] = __uint_as_float(w[i] << 16);
        v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) v[k] = k < nv ? bf16_bits(__ldg(src + k)) : 0.f;
    }
  }
}

// out[j0 + k] = s * acc[k] for k < nv, in the leaf's output dtype
__device__ __forceinline__ void store_cols(const Leaf& L, long long j0, int nv, float s,
                                           const float (&acc)[kCols]) {
  if (nv <= 0) return;
  if (L.out_dtype == kF32) {
    float* dst = static_cast<float*>(L.out) + j0;
    if (nv == kCols && aligned16(dst)) {
      reinterpret_cast<float4*>(dst)[0] = make_float4(s * acc[0], s * acc[1], s * acc[2], s * acc[3]);
      reinterpret_cast<float4*>(dst)[1] = make_float4(s * acc[4], s * acc[5], s * acc[6], s * acc[7]);
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (k < nv) dst[k] = s * acc[k];
    }
  } else {
    // round to nearest even, as torch's .to(bfloat16)
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(L.out) + j0;
    if (nv == kCols && aligned16(dst)) {
      unsigned w[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        w[i] = static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(s * acc[2 * i]))) |
               static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16(s * acc[2 * i + 1])))
                   << 16;
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (k < nv) dst[k] = __float2bfloat16(s * acc[k]);
    }
  }
}

// kGroup client rows loaded before any is summed: 4 up to C 4, else 8
// (every chunk's rows in one trip to memory for the repo's 2, 4 and 5
// clients).
constexpr int group_for(int C) { return C <= 4 ? 4 : 8; }

// The last block's sums: segment j < S of client c (S = max(1, kThreads /
// C) segments a client) adds partials g = j, j + S, ... in order, kBatch
// loads in flight at a time (past the end a load gives 0, which adds
// nothing); then each client adds its S segments in order.
constexpr int kBatch = 8;

__device__ __forceinline__ float segment_sum(const float* __restrict__ row, int j, int S,
                                             int G) {
  float t = 0.f;
  for (int g = j; g < G; g += kBatch * S) {
    float x[kBatch];
#pragma unroll
    for (int i = 0; i < kBatch; ++i) x[i] = g + i * S < G ? __ldcg(row + g + i * S) : 0.f;
#pragma unroll
    for (int i = 0; i < kBatch; ++i) t += x[i];
  }
  return t;
}

// grid (G); dynamic shared memory C * kWarps floats (at least kThreads).
// workspace: an unsigned counter (0 between launches), then C * G float
// partials from word 4. At 5 blocks an SM (at most 102 registers a thread,
// no spill) the CNN's 547 chunks run in one wave on the H100's 132 SMs.
template <int kCap, int kGroup, bool kDiv>
__global__ void __launch_bounds__(kThreads, 5)
vecavg_kernel(const __grid_constant__ Table<kCap> T, long long n_chunks,
              const float* __restrict__ p, const float* __restrict__ div,
              const float* __restrict__ scale, float scale_value, float* __restrict__ sqn,
              unsigned* __restrict__ counter, float* __restrict__ partial, int C) {
  extern __shared__ float warp_sq[];  // [C][kWarps]; the last block: [kThreads] segments
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int G = gridDim.x;
  // a warp's column of warp_sq is written by its lane 0 only
  for (int c = lane; c < C; c += 32) warp_sq[c * kWarps + warp] = 0.f;
  __syncwarp();
  const float s = -(scale ? scale[0] : scale_value);

  int l = 0;
  for (long long k = blockIdx.x; k < n_chunks; k += G) {
    while (k >= T.leaf[l].chunk0 + (T.leaf[l].n + kChunk - 1) / kChunk) ++l;
    const Leaf& L = T.leaf[l];
    const long long j0 = (k - L.chunk0) * kChunk + tid * kCols;
    const long long left = L.n - j0;
    const int nv = left >= kCols ? kCols : (left > 0 ? static_cast<int>(left) : 0);
    float acc[kCols];
#pragma unroll
    for (int kk = 0; kk < kCols; ++kk) acc[kk] = 0.f;
    for (int c0 = 0; c0 < C; c0 += kGroup) {
      float v[kGroup][kCols];
#pragma unroll
      for (int i = 0; i < kGroup; ++i)
        if (c0 + i < C) load_cols(L, static_cast<long long>(c0 + i) * L.n + j0, nv, v[i]);
#pragma unroll
      for (int i = 0; i < kGroup; ++i) {
        const int c = c0 + i;
        if (c < C) {  // uniform over the block
          const float pc = __ldg(p + c);
          const float dc = kDiv ? __ldg(div + c) : 1.f;
          float sq = 0.f;
#pragma unroll
          for (int kk = 0; kk < kCols; ++kk) {
            if (kk < nv) {
              float x = v[i][kk];
              if (kDiv) x = x / dc;
              acc[kk] = fmaf(pc, x, acc[kk]);
              sq = fmaf(x, x, sq);
            }
          }
          sq = warp_sum(sq);
          if (lane == 0) warp_sq[c * kWarps + warp] += sq;
        }
      }
    }
    store_cols(L, j0, nv, s, acc);
  }

  __syncthreads();
  for (int c = tid; c < C; c += kThreads) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) t += warp_sq[c * kWarps + w];
    partial[static_cast<long long>(c) * G + blockIdx.x] = t;
  }
  // the barrier orders the block's partials before thread 0's fence, whose
  // release covers them (as a grid-wide sync does)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(counter, 1u) == static_cast<unsigned>(G - 1);
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int S = C >= kThreads ? 1 : kThreads / C;
  if (S == 1) {
    for (int c = tid; c < C; c += kThreads)
      sqn[c] = segment_sum(partial + static_cast<long long>(c) * G, 0, 1, G);
  } else {
    float* seg = warp_sq;  // C * S <= kThreads floats; every warp is past its last use
    if (tid < C * S)
      seg[tid] = segment_sum(partial + static_cast<long long>(tid / S) * G, tid % S, S, G);
    __syncthreads();
    if (tid < C) {
      float t = 0.f;
      for (int j = 0; j < S; ++j) t += seg[tid * S + j];
      sqn[tid] = t;
    }
  }
  if (tid == 0) *counter = 0u;
}

size_t smem_bytes(int C) {
  return static_cast<size_t>(C > kThreads / kWarps ? C * kWarps : kThreads) * sizeof(float);
}

template <int kCap, int kGroup, bool kDiv>
cudaError_t occupancy(int C, int* blocks) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, vecavg_kernel<kCap, kGroup, kDiv>, kThreads, smem_bytes(C));
}

template <int kCap, int kGroup, bool kDiv>
cudaError_t launch(const void* leaves, int n_leaves, long long n_chunks, const float* p,
                   const float* div, const float* scale, float scale_value, float* sqn,
                   void* workspace, int C, int G, cudaStream_t st) {
  Table<kCap> t;
  memcpy(t.leaf, leaves, static_cast<size_t>(n_leaves) * sizeof(Leaf));
  vecavg_kernel<kCap, kGroup, kDiv><<<G, kThreads, smem_bytes(C), st>>>(
      t, n_chunks, p, div, scale, scale_value, sqn, static_cast<unsigned*>(workspace),
      static_cast<float*>(workspace) + 4, C);
  return cudaGetLastError();
}

// Calls F::template run<kCap, kGroup, kDiv>(args...) for the instance of
// (n_leaves, C, has_div): tables of 32 or 256 leaves.
template <typename F, typename... A>
cudaError_t dispatch(int n_leaves, int C, bool has_div, A... args) {
  if (n_leaves < 1 || n_leaves > kMaxLeaves || C < 1 || C > kMaxClients)
    return cudaErrorInvalidValue;
  const int g = group_for(C);
#define VECAVG_PICK(CAP, GROUP)                                                       \
  if (n_leaves <= CAP && g == GROUP)                                                  \
    return has_div ? F::template run<CAP, GROUP, true>(args...)                       \
                   : F::template run<CAP, GROUP, false>(args...);
  VECAVG_PICK(32, 4) VECAVG_PICK(32, 8) VECAVG_PICK(256, 4) VECAVG_PICK(256, 8)
#undef VECAVG_PICK
  return cudaErrorInvalidValue;
}

struct Occupancy {
  template <int kCap, int kGroup, bool kDiv>
  static cudaError_t run(int C, int* blocks) { return occupancy<kCap, kGroup, kDiv>(C, blocks); }
};

struct Launch {
  template <int kCap, int kGroup, bool kDiv, typename... A>
  static cudaError_t run(A... args) { return launch<kCap, kGroup, kDiv>(args...); }
};

}  // namespace

extern "C" {

// Columns a chunk holds, and the most leaves a call takes: the wrapper
// numbers chunks with the first and checks the second.
int vecavg_chunk() { return kChunk; }
int vecavg_max_leaves() { return kMaxLeaves; }

// Blocks an SM holds of the instance for (n_leaves, has_div, C). Returns a
// cudaError_t.
int vecavg_occupancy(int n_leaves, int has_div, int C, int* blocks) {
  *blocks = 0;
  return dispatch<Occupancy>(n_leaves, C, has_div != 0, C, blocks);
}

// leaves: n_leaves packed Leaf records, chunk0 numbering kChunk-column
// chunks, n_chunks in all. div may be null (no division); scale may be
// null, and then scale_value is the scale. C in [1, 1536], G in [1,
// n_chunks]. workspace: 16 bytes holding an unsigned 0, then C * G floats;
// one workspace serves one stream at a time. Returns a cudaError_t.
int vecavg_launch(const void* leaves, int n_leaves, long long n_chunks, const float* p,
                  const float* div, const float* scale, float scale_value, float* sqn,
                  void* workspace, int C, int G, void* stream) {
  if (G < 1 || G > n_chunks) return cudaErrorInvalidValue;
  return dispatch<Launch>(n_leaves, C, div != nullptr, leaves, n_leaves, n_chunks, p, div,
                          scale, scale_value, sqn, workspace, C, G,
                          static_cast<cudaStream_t>(stream));
}

}  // extern "C"
