// Flash attention (forward) for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_fa_kernel
//   (flash_attention_pallas): blockwise online-softmax attention of
//   q [B, Sq, Hq, hd] over k, v [B, Sk, Hkv, hd] (float32 or bf16), with
//   GQA (query head h reads KV head h / G), causal and sliding-window masks
//   and a query offset (query i sits at position q_offset + i, keys at
//   0..Sk-1). Semantics are the Pallas kernel's: scale 1/sqrt(hd), masked
//   logits out of the softmax (p = 0), an fp32 online softmax with fp32
//   running max m, sum l and accumulator, the final divide by
//   max(l, 1e-30) (so a row with no live key is 0), the output contiguous
//   in q's dtype.
//
// Bound on an H100 SXM: 4 * hd operations per live (query, key) pair (two
// products of hd multiply-adds each) at 989 TFLOP/s dense bf16, or q, k, v
// read once and o written once at 3.35 TB/s, whichever is larger. At
// StarCoder2-3B widths ([1, 8192, 24/2, 128] bf16, causal, window 4096:
// 37% of the pairs live) that is the operations, ~0.31 ms: the tensor
// cores, not memory, bound it.
//
// bf16: only the tensor cores reach that bound (float32 products on the
// CUDA cores cap at 67 TFLOP/s), so the products are wgmma, the
// probabilities stay in registers, and the copies are TMA, in flight
// ahead of the products with no block barrier a tile. A warp-specialised
// kernel:
//   - One block owns 128 query rows of one (b, q head): two consumer
//     warpgroups of 64 rows each, and one producer warp, one thread of
//     which issues every copy.
//   - Copies are TMA: the Q tile once, then K and V tiles of 128 keys into
//     a ring of kStages stages, each with a "full" mbarrier for K, one for
//     V and an "empty" one that the consumers' 8 warps arrive on when the
//     stage's products are done. The tensor maps cover the strided 4-D
//     tensors (hd, H, S, B) in place and are built on the host at each
//     launch by cuTensorMapEncodeTiled, looked up at run time
//     (cudaGetDriverEntryPoint), so the library needs no -lcuda. Rows are
//     swizzled by their bytes (hd 16/32/64/128: 32/64/128/128 B; hd 128 as
//     two 64-element column blocks). hd 96's 192-byte rows fit no swizzle
//     span, so its tiles are three 32-element column blocks swizzled by 64
//     B, each copied by its own TMA box: Q K^T is six k16 steps across the
//     blocks, and P V one m64n96k16 a step whose B descriptor steps 8 KB
//     from block to block. Q and 3 stages of K and V take 168 KB: one block
//     an SM, as at hd 128. TMA fills zeros past Sq and Sk.
//   - S = Q K^T is wgmma m64n128k16 with both operands in shared memory.
//     P goes from the S accumulator to bf16 registers, which are the A
//     operand of O += P V (m64n{hd}k16; V read from shared memory with the
//     transpose bit, as it is stored keys x hd). The accumulator layout
//     puts a row on a quad of threads: its max and sum take two shuffles,
//     and the sum only once, at the end. exp2 with log2(e) * scale folded
//     into one multiply-add.
//   - Within a warpgroup a tile runs Q K^T, softmax, P V in turn; the two
//     consumer warpgroups interleave, one's softmax beside the other's
//     products on the tensor cores. Issuing tile i's Q K^T beside tile
//     i-1's P V would keep S, O and P (64 + hd/2 + 32 registers a thread)
//     live across the wait, past the 168 registers that ptxas allots a
//     thread of this block (setmaxnreg 24 / 240 for a producer warpgroup
//     did not lift it): at hd 128 that build spilled and ptxas serialized
//     its wgmma (C7512), and it ran slower on the card.
//   - KV tiles with no live key for the block's rows are not visited (a
//     fully masked tile changes no row); the mask compares run only on
//     tiles that straddle the causal diagonal, the window's edge or Sk.
//   - Blocks are handed out longest q tile first under a causal mask, so
//     short tiles fill the tail. Output: divided by max(l, 1e-30), rounded
//     to bf16, staged in the warpgroup's Q rows (swizzled) and written by
//     a TMA store, which drops rows past Sq.
//
// float32: tensor cores, three TF32 products a product (3xTF32), the
// products that SDPA's float32 kernel (CUTLASS's memory-efficient
// attention, OpMultiplyAddFastF32) uses as well.
//   - Why three: an operand x splits into big = tf32(x) and small =
//     tf32(x - big), each rounded to nearest with ties away from zero
//     (cvt.rna's rounding, done on the integer bits; CUTLASS truncates big
//     instead), so big + small holds x to ~2^-22 of |x|. a b is a_small b_big + a_big
//     b_small + a_big b_big on mma.sync m16n8k8 TF32 with float32
//     accumulators, small terms first; the dropped a_small b_small is
//     ~2^-22 of |a b|. S and P V then err by ~1e-6 of their scale, inside
//     the 2e-5 bar. One TF32 product errs by ~2^-11 of |v| in P V (~5e-4),
//     past it.
//   - Bound: 3 TF32 products of 4 hd operations a live pair at 494.7
//     TFLOP/s (dense TF32), or the bytes, whichever is larger: 0.261 ms at
//     Qwen1.5-32B's [1, 2048, 40/40, 128] causal, 1.88 ms at StarCoder2-3B's
//     [1, 8192, 24/2, 128] causal window 4096 (the CUDA cores' 67 TFLOP/s
//     would give 0.641 and 4.62 ms).
//   - A block of 4 warps owns 64 query rows of one (b, q head); a warp owns
//     16 rows. Its S (16 x the KV tile) and O (16 x hd) accumulators, and m
//     and l of its rows, live in registers; the row max and sum are quad
//     shuffles, l's only once, at the end.
//   - The tensor cores' float32 accumulation truncates. S starts from zero
//     each tile, but O summed in one accumulator over every key of a row
//     (hundreds of mma steps) shrank by far more than the 2e-5 bar, and the
//     float32 forward of StarCoder2-3B missed its 2e-4 logits bar. So each
//     tile's P V goes into zeroed accumulators, a column group at a time,
//     and O = O corr + that tile's part on the CUDA cores, rounded to
//     nearest.
//   - Copies are cp.async: the Q tile once, then K and V tiles of kBK keys
//     (32 at hd 96 and 128, 64 below) into two stages, so that tile i + 1 is in
//     flight while tile i is computed. The host picks the copy width at
//     each launch (a template parameter): 16 bytes where q, k and v's bases
//     and batch, sequence and head strides allow it, 4 bytes otherwise
//     (the kernel takes any float32 layout with a contiguous hd axis).
//     Rows past Sq and Sk are zero-filled. A thread walks its rows of a
//     tile with one running address, so that the unrolled copies hold no
//     address each across the tile (they made ptxas spill).
//   - Both products sum over an index that A and B may permute alike, and
//     the fragments use that so that each thread loads 16 bytes at a time
//     and P never leaves registers. In Q K^T a thread's 4 adjacent hd
//     columns serve k = t, t + 4 of two k-steps. In P V the S accumulator
//     holds keys 2t, 2t + 1 of each 8-key step where the A fragment wants
//     k = t, t + 4: so P is the A operand as it stands, and V's rows are
//     read in that order (2t, 2t + 1) instead of P being shuffled across
//     the quad (4 shuffles a k-step, and the same registers). Likewise the
//     4 n-tiles of a 32-column group of O take column n = 4 c + j of n-tile
//     j, so that one 16-byte load of V feeds all 4, and the store puts the
//     columns back (each thread then writes 8 adjacent floats a row).
//   - Row strides put the 8 lanes of each 16-byte phase on distinct banks:
//     Q and K rows hd + 16 floats apart (16 banks between rows g and g +
//     1), V rows hd + 4 (8 banks between rows 2t and 2t + 2).
//   - Shared memory at hd 128: Q 36 KB and two stages of (K, V) 69 KB, 105
//     KB a block, so 2 blocks (8 warps) fit an SM; hd 96: 83 KB, hd 64: 94
//     KB, 2 blocks each. hd 96's rows (24 16-byte chunks, which do not
//     divide 128 threads) are copied as 64 columns, then 32, each in whole
//     passes of the block.
//   - As before: the strided layout is read in place; only KV tiles with a
//     live key for the block's rows are visited; the mask compares run
//     only on tiles that straddle the diagonal, the window's edge or Sk
//     for the warp's rows; rows past Sq are computed and never written; a
//     row with no live key is 0 (max(l, 1e-30)); blocks go longest q tile
//     first under a causal mask; no atomics, so two launches give the same
//     bits.
//   - Left open: wgmma TF32. It takes its B operand only K-major, so P V
//     would need V transposed in shared memory each tile and the split
//     operands staged twice. And each of the 4 warps splits the whole K
//     and V tile again; splitting once a block needs big and small copies
//     of both in shared memory, past what 2 blocks an SM leave.
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ===========================================================================
// float32: mma.sync TF32, three products a product
// ===========================================================================

constexpr int kBQ = 64;        // query rows a block owns: 4 warps of 16
constexpr int kThreads = 128;

template <int HD>
struct F32Tiles {
  // keys a KV tile holds; at hd 96 and 128, 64-key stages would leave room
  // for one block an SM, not two
  static constexpr int kBK = HD >= 96 ? 32 : 64;
  // row strides in floats (see the header): Q and K 16 mod 32, V 4 mod 32
  static constexpr int kQKStride = HD % 32 == 16 ? HD : HD + 16;
  static constexpr int kVStride = HD + 4;
  // V columns a thread loads at once = n-tiles of O that one load feeds
  static constexpr int kVW = HD >= 32 ? 4 : 2;
  static constexpr int kQFloats = kBQ * kQKStride;
  static constexpr int kKFloats = kBK * kQKStride;
  static constexpr int kStageFloats = kKFloats + kBK * kVStride;  // K, then V
  static constexpr int kSmem = 4 * (kQFloats + 2 * kStageFloats);
};

// x rounded to TF32, to nearest with ties away from zero, as the b32 bits
// that mma.sync takes: the bits of cvt.rna.tf32.f32 for every finite x,
// computed on the integer bits (an add and a mask; ptxas expands cvt.rna
// into a finiteness test, a select and the same add)
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = to_tf32(x);
  small = to_tf32(x - __uint_as_float(big));
}

// D (16 x 8) += A (16 x 8) B (8 x 8), TF32 in, float32 accumulators. A
// fragment: a0 (row g, k t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
// B: b0 (k t, column g), b1 (t + 4, g); D: d0, d1 (row g, columns 2t, 2t
// + 1), d2, d3 (row g + 8); g = lane / 4, t = lane % 4.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// D += A B from split operands: a_small b_big, a_big b_small, a_big b_big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&b_big)[2],
                                           const uint32_t (&b_small)[2]) {
  mma_tf32(d, a_small, b_big);
  mma_tf32(d, a_big, b_small);
  mma_tf32(d, a_big, b_big);
}

// cp.async of CB bytes (16 or 4) from src to the shared address dst; with
// in false nothing is read and CB zero bytes are written
template <int CB>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool in) {
  const uint32_t n = in ? CB : 0;
  if constexpr (CB == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
                 : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// NC columns of rows [row0, row0 + ROWS) of one head's [S, hd] slice at
// src (row stride `stride` elements) by cp.async into shared memory at
// dst, DST floats a row; rows at or past n_rows are zero-filled. A thread
// keeps one column and walks its rows with one running address: with an
// address computed for each copy of the unrolled loop, ptxas held them all
// across the tile and spilled at hd 64 and 128. The 4-byte loop (4 times
// the copies) is not unrolled.
template <int NC, int CB, int ROWS, int DST>
__device__ __forceinline__ void copy_cols(uint32_t dst, const float* src, long long stride,
                                          int row0, int n_rows) {
  constexpr int kPer = CB / 4, kChunks = NC / kPer, kStep = kThreads / kChunks;  // rows a pass
  static_assert(kThreads % kChunks == 0 && ROWS % kStep == 0, "whole passes");
  const int r = static_cast<int>(threadIdx.x) / kChunks;
  const int c = (static_cast<int>(threadIdx.x) % kChunks) * kPer;
  const float* p = src + (row0 + r) * stride + c;
  const long long step = kStep * stride;
  dst += 4 * (r * DST + c);
  if constexpr (CB == 16) {
#pragma unroll
    for (int i = 0; i < ROWS; i += kStep, p += step)
      cp_async<CB>(dst + 4 * i * DST, row0 + r + i < n_rows ? p : src, row0 + r + i < n_rows);
  } else {
#pragma unroll 1
    for (int i = 0; i < ROWS; i += kStep, p += step)
      cp_async<CB>(dst + 4 * i * DST, row0 + r + i < n_rows ? p : src, row0 + r + i < n_rows);
  }
}

// Rows [row0, row0 + ROWS) of one head's [S, HD] slice (see copy_cols).
// hd 96 goes as columns [0, 64), then [64, 96): its 24 or 96 chunks a row
// do not divide the 128 threads, 16 and 8 (or 64 and 32) do.
template <int HD, int CB, int ROWS, int DST>
__device__ __forceinline__ void copy_rows(uint32_t dst, const float* src, long long stride,
                                          int row0, int n_rows) {
  constexpr int kLo = HD == 96 ? 64 : HD;
  copy_cols<kLo, CB, ROWS, DST>(dst, src, stride, row0, n_rows);
  if constexpr (kLo < HD)
    copy_cols<HD - kLo, CB, ROWS, DST>(dst + 4 * kLo, src + kLo, stride, row0, n_rows);
}

// One KV tile, keys [row0, row0 + kBK), into the stage at dst: K, then V
template <int HD, int CB>
__device__ __forceinline__ void copy_kv(uint32_t dst, const float* k, long long kss,
                                        const float* v, long long vss, int row0, int Sk) {
  using T = F32Tiles<HD>;
  copy_rows<HD, CB, T::kBK, T::kQKStride>(dst, k, kss, row0, Sk);
  copy_rows<HD, CB, T::kBK, T::kVStride>(dst + 4 * T::kKFloats, v, vss, row0, Sk);
}

template <int N>
struct Vec;
template <>
struct Vec<2> {
  using T = float2;
};
template <>
struct Vec<4> {
  using T = float4;
};

template <int N>
__device__ __forceinline__ void load_vec(float (&x)[N], const float* p) {
  const typename Vec<N>::T v = *reinterpret_cast<const typename Vec<N>::T*>(p);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) x[i] = f[i];
}
template <int N>
__device__ __forceinline__ void store_vec(float* p, const float* x) {
  typename Vec<N>::T v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = x[i];
  *reinterpret_cast<typename Vec<N>::T*>(p) = v;
}

// S (16 x kBK) = Q K^T for one warp: q at the thread's row g and column
// 4t of the Q tile, k at row g and column 4t of the K tile. Each 16-byte
// load covers hd columns 4t..4t+3 of a 16-column chunk, which serve k = t,
// t + 4 of the chunk's two k-steps, alike in A and B.
template <int HD>
__device__ __forceinline__ void qk_tile(float (&s)[F32Tiles<HD>::kBK / 8][4], const float* q,
                                        const float* k) {
  using T = F32Tiles<HD>;
#pragma unroll
  for (int c = 0; c < HD; c += 16) {
    float qa[4], qc[4];  // rows g, g + 8
    load_vec<4>(qa, q + c);
    load_vec<4>(qc, q + 8 * T::kQKStride + c);
    uint32_t ab[2][4], as[2][4];
#pragma unroll
    for (int st = 0; st < 2; ++st) {
      split_tf32(qa[2 * st], ab[st][0], as[st][0]);
      split_tf32(qc[2 * st], ab[st][1], as[st][1]);
      split_tf32(qa[2 * st + 1], ab[st][2], as[st][2]);
      split_tf32(qc[2 * st + 1], ab[st][3], as[st][3]);
    }
#pragma unroll
    for (int j = 0; j < T::kBK / 8; ++j) {
      float kv[4];  // key 8j + g
      load_vec<4>(kv, k + 8 * j * T::kQKStride + c);
#pragma unroll
      for (int st = 0; st < 2; ++st) {
        uint32_t bb[2], bs[2];
        split_tf32(kv[2 * st], bb[0], bs[0]);
        split_tf32(kv[2 * st + 1], bb[1], bs[1]);
        mma_3xtf32(s[j], ab[st], as[st], bb, bs);
      }
    }
  }
}

// O (16 x HD) = O corr + P V for one warp over one KV tile. P is the S
// accumulator (keys 2t, 2t + 1 of each 8-key step serve k = t, t + 4); v
// at row 2t and column kVW g of the V tile; n-tile j of column group c
// holds O's columns c 8 kVW + kVW n + j (n = 0..7). The tile's P V goes
// into zeroed accumulators, a column group at a time, and is added to O
// on the CUDA cores (see the header: the tensor cores truncate).
template <int HD>
__device__ __forceinline__ void pv_tile(float (&o)[HD / 8][4],
                                        const float (&p)[F32Tiles<HD>::kBK / 8][4],
                                        const float (&corr)[2], const float* v) {
  using T = F32Tiles<HD>;
  constexpr int kVW = T::kVW;
#pragma unroll
  for (int c = 0; c < HD / (8 * kVW); ++c) {
    float part[kVW][4];
#pragma unroll
    for (int j = 0; j < kVW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < T::kBK / 8; ++ks) {
      uint32_t pb[4], ps[4];
      split_tf32(p[ks][0], pb[0], ps[0]);
      split_tf32(p[ks][2], pb[1], ps[1]);
      split_tf32(p[ks][1], pb[2], ps[2]);
      split_tf32(p[ks][3], pb[3], ps[3]);
      const float* v0 = v + 8 * ks * T::kVStride + c * 8 * kVW;
      float x0[kVW], x1[kVW];  // keys 2t, 2t + 1
      load_vec<kVW>(x0, v0);
      load_vec<kVW>(x1, v0 + T::kVStride);
#pragma unroll
      for (int j = 0; j < kVW; ++j) {
        uint32_t bb[2], bs[2];
        split_tf32(x0[j], bb[0], bs[0]);
        split_tf32(x1[j], bb[1], bs[1]);
        mma_3xtf32(part[j], pb, ps, bb, bs);
      }
    }
#pragma unroll
    for (int j = 0; j < kVW; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[c * kVW + j][e] = fmaf(o[c * kVW + j][e], corr[e >> 1], part[j][e]);
  }
}

// grid (Hq, ceil(Sq / kBQ), B), kThreads threads, F32Tiles<HD>::kSmem
// bytes of dynamic shared memory; CB the copy width in bytes (16 or 4).
// scale_log2 = log2(e) / sqrt(hd). The launch bound asks for 2 blocks an
// SM, what the shared memory holds at hd 64 and 128: without it ptxas
// held the instances to 168-180 registers (room for 3) and spilled at hd
// 64.
template <int HD, int CB>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                           int Hq, int G, long long qsb, long long qss, long long qsh,
                           long long ksb, long long kss, long long ksh, long long vsb,
                           long long vss, long long vsh, int causal, int window, int q_offset,
                           float scale_log2) {
  using T = F32Tiles<HD>;
  constexpr int kBK = T::kBK, kVW = T::kVW;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sKV = sQ + T::kQFloats;  // stage st: K at sKV + st kStageFloats, V after it
  const uint32_t aQ = smem_addr(sQ), aKV = smem_addr(sKV);

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // longest first
  const int q0 = qt * kBQ;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / G) * ksh;
  const float* vb = v + b * vsb + (h / G) * vsh;

  // keys [k_lo, k_hi) hold every live key of the block's rows
  const int qa_lo = q_offset + q0, qa_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(k_hi, qa_hi + 1);
  if (window) k_lo = max(k_lo, qa_lo - window + 1);
  const int t_lo = k_lo / kBK;
  const int n_tiles = k_hi > k_lo ? (k_hi + kBK - 1) / kBK - t_lo : 0;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
  const int wq_lo = qa_lo + 16 * warp, wq_hi = wq_lo + 15;  // the warp's rows
  const int qpos = wq_lo + g;                                // the thread's: qpos, qpos + 8

  float acc[HD / 8][4];
#pragma unroll
  for (int n = 0; n < HD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    copy_rows<HD, CB, kBQ, T::kQKStride>(aQ, qb, qss, q0, Sq);
    copy_kv<HD, CB>(aKV, kb, kss, vb, vss, t_lo * kBK, Sk);
    cp_async_commit();
    const float* sQw = sQ + (16 * warp + g) * T::kQKStride + 4 * t;
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i & 1;
      if (i + 1 < n_tiles) {  // tile i + 1 flies while tile i is computed
        copy_kv<HD, CB>(aKV + 4 * (st ^ 1) * T::kStageFloats, kb, kss, vb, vss,
                        (t_lo + i + 1) * kBK, Sk);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // tile i (and the Q tile) visible to every warp
      const float* sK = sKV + st * T::kStageFloats;
      const float* sV = sK + T::kKFloats;
      const int k0 = (t_lo + i) * kBK;

      float s[kBK / 8][4];
#pragma unroll
      for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      qk_tile<HD>(s, sQw, sK + g * T::kQKStride + 4 * t);

      // the compares only where the tile straddles Sk, the diagonal or the
      // window's edge for the warp's rows
      if (k0 + kBK > Sk || (causal && k0 + kBK - 1 > wq_lo) || (window && k0 <= wq_hi - window)) {
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * j + 2 * t + (e & 1), qp = qpos + 8 * (e >> 1);
            const bool live = key < Sk && (!causal || key <= qp) && (!window || key > qp - window);
            if (!live) s[j][e] = -INFINITY;
          }
      }

      // the online softmax step of the thread's two rows (m in log2 units)
      float corr[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j) mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
        const float m_new = fmaxf(m[r], quad_max(mx) * scale_log2);
        corr[r] = exp2f(m[r] - m_new);
        m[r] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int j = 0; j < kBK / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& x = s[j][2 * r + e];
            x = exp2f(fmaf(x, scale_log2, -m_new));
            sum += x;
          }
        l[r] = l[r] * corr[r] + sum;
      }

      pv_tile<HD>(acc, s, corr, sV + 2 * t * T::kVStride + kVW * g);
      __syncthreads();  // every warp is done with stage st before tile i + 2 lands there
    }
  }

  // o / max(l, 1e-30); the thread's columns of group c are c 8 kVW + 2t kVW
  // + [0, 2 kVW): n-tile j's column 2t, then its column 2t + 1
  float denom[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) denom[r] = fmaxf(quad_sum(l[r]), 1e-30f);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = q0 + 16 * warp + g + 8 * r;
    if (qi >= Sq) continue;
    float* orow = o + ((static_cast<long long>(b) * Sq + qi) * Hq + h) * HD + 2 * t * kVW;
#pragma unroll
    for (int c = 0; c < HD / (8 * kVW); ++c) {
      float y[2 * kVW];
#pragma unroll
      for (int j = 0; j < kVW; ++j) {
        y[j] = acc[c * kVW + j][2 * r] / denom[r];
        y[kVW + j] = acc[c * kVW + j][2 * r + 1] / denom[r];
      }
      store_vec<kVW>(orow + c * 8 * kVW, y);
      store_vec<kVW>(orow + c * 8 * kVW + kVW, y + kVW);
    }
  }
}

// ===========================================================================
// bf16: wgmma + TMA, warp-specialised
// ===========================================================================

constexpr int kBQ2 = 128;           // query rows a block owns (two consumer warpgroups)
constexpr int kBK2 = 128;           // keys a KV tile holds
constexpr int kStages = 3;          // K/V stages in the ring
constexpr int kConsumerWarps = 8;   // two warpgroups; their arrivals free a stage
constexpr int kThreads2 = 32 * kConsumerWarps + 32;  // and one producer warp
constexpr int kBarrierBytes = 128;  // the mbarriers, before the 1024-aligned tiles

template <int HD>
struct Tiles {
  // bytes of one swizzled row: the swizzle span (a 64-element column block
  // at hd 128, a 32-element one at hd 96, whose 192 bytes 128 does not divide)
  static constexpr int kRowBytes = HD * 2 <= 128 ? HD * 2 : HD * 2 % 128 == 0 ? 128 : 64;
  static constexpr int kColBlocks = HD * 2 / kRowBytes;
  static constexpr int kStepsPerBlock = kRowBytes / 32;  // k16 steps in one column block
  // wgmma descriptor swizzle mode: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr int kDescSwizzle = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kSwizzleMask = kRowBytes / 16 - 1;  // of the 16-byte chunk index
  static constexpr int kQBytes = kBQ2 * HD * 2;
  static constexpr int kKVBytes = kBK2 * HD * 2;  // one K or one V tile
  static constexpr int kSmem = kBarrierBytes + 1024 + kQBytes + 2 * kStages * kKVBytes;
};

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done;
}

// Spins until the phase of `bar` with this parity has completed. A wait
// past 10 s traps: a lost phase fails the launch instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
    if (now - t0 > 10000000000ull) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_store(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                          int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group [%0, {%2, %3, %4, %5}], [%1];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// A wgmma matrix descriptor: start address, leading and stride byte
// offsets (16-byte units), swizzle mode.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                              uint32_t swizzle) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(swizzle) << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving accesses of registers that an in-flight
// wgmma reads or writes across the wait (and from reusing them before it).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// S [64 x 128] (+)= A [64 x 16] B^T [16 x 128], both from shared memory,
// K-major; a warpgroup's accumulator: thread t holds rows 16 (t / 32) +
// (t % 32) / 4 + {0, 8}, columns 8 n + 2 (t % 4) + {0, 1} at d[4 n + 2 i + j].
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// O [64 x N] += A [64 x 16] B [16 x N]: A from registers (a0..a3 as
// mma.m16n8k16's A fragment, per warp), B from shared memory stored N-major
// (the transpose bit).
template <int N>
__device__ __forceinline__ void wgmma_m64k16_rs(float (&d)[N / 2], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t db);

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<16>(float (&d)[8], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<32>(float (&d)[16], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<64>(float (&d)[32], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<96>(float (&d)[48], uint32_t a0, uint32_t a1,
                                                   uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_m64k16_rs<128>(float (&d)[64], uint32_t a0, uint32_t a1,
                                                    uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// S = Q K^T for one warpgroup's 64 rows: q and k are the (1024-aligned)
// tile bases, the warpgroup's rows start at row q_row of the Q tile.
template <int HD>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q, int q_row, uint32_t k) {
  using T = Tiles<HD>;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    const int c = kk / T::kStepsPerBlock, off = (kk % T::kStepsPerBlock) * 32;
    const uint64_t da = make_desc(q + (c * kBQ2 + q_row) * T::kRowBytes + off, 16,
                                  8 * T::kRowBytes, T::kDescSwizzle);
    const uint64_t db = make_desc(k + c * kBK2 * T::kRowBytes + off, 16, 8 * T::kRowBytes,
                                  T::kDescSwizzle);
    wgmma_m64n128k16_ss(s, da, db, kk > 0);
  }
}

// O += P V over one KV tile: P [64 x 128] bf16 in registers, V [128 keys x
// HD] in shared memory (hd contiguous, so N-major: 8-key groups 8 rows
// apart, column blocks kBK2 rows apart: the descriptor's leading offset).
template <int HD>
__device__ __forceinline__ void issue_pv(float (&o)[HD / 2], const uint32_t (&p)[32], uint32_t v) {
  using T = Tiles<HD>;
#pragma unroll
  for (int kk = 0; kk < kBK2 / 16; ++kk) {
    const uint64_t db = make_desc(v + kk * 16 * T::kRowBytes, kBK2 * T::kRowBytes,
                                  8 * T::kRowBytes, T::kDescSwizzle);
    wgmma_m64k16_rs<HD>(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3], db);
  }
}

// Masks the logits of one tile: -inf where key k0 + column is not live for
// the thread's rows at absolute positions qpos and qpos + 8.
__device__ __forceinline__ void mask_tile(float (&s)[64], int k0, int qpos, int quad, int Sk,
                                          int causal, int window) {
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = k0 + 8 * n + 2 * quad + j;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int qp = qpos + 8 * i;
        const bool live = key < Sk && (!causal || key <= qp) && (!window || key > qp - window);
        if (!live) s[4 * n + 2 * i + j] = -INFINITY;
      }
    }
}

// The online softmax step of one tile for the thread's two rows: m (log2
// units) moves to the new max, s becomes exp2(s * scale_log2 - m), corr
// is exp2(m_old - m_new), sum the thread's share of the row sums.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2], float (&corr)[2],
                                             float (&sum)[2], float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int n = 0; n < 16; ++n) mx = fmaxf(mx, fmaxf(s[4 * n + 2 * i], s[4 * n + 2 * i + 1]));
    const float m_new = fmaxf(m[i], quad_max(mx) * scale_log2);
    corr[i] = exp2f(m[i] - m_new);
    m[i] = m_new;
    float acc = 0.f;
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float& x = s[4 * n + 2 * i + j];
        x = exp2f(fmaf(x, scale_log2, -m_new));
        acc += x;
      }
    sum[i] = acc;
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// grid (Hq, ceil(Sq / kBQ2), B), kThreads2 threads, Tiles<HD>::kSmem bytes
// of dynamic shared memory. scale_log2 = log2(e) / sqrt(hd).
template <int HD>
__global__ void __launch_bounds__(kThreads2, 1)
flash_attention_bf16_kernel(const __grid_constant__ CUtensorMap map_q,
                            const __grid_constant__ CUtensorMap map_k,
                            const __grid_constant__ CUtensorMap map_v,
                            const __grid_constant__ CUtensorMap map_o, int Sq, int Sk, int G,
                            int causal, int window, int q_offset, float scale_log2) {
  using T = Tiles<HD>;
  extern __shared__ __align__(1024) uint8_t smem[];
  const uint32_t base = smem_addr(smem);
  // barriers: full_k[kStages], full_v[kStages], empty[kStages], q
  const uint32_t bar_full_k = base, bar_full_v = base + 8 * kStages;
  const uint32_t bar_empty = base + 16 * kStages, bar_q = base + 24 * kStages;
  const uint32_t sQ = (base + kBarrierBytes + 1023) & ~1023u;
  const uint32_t sKV = sQ + T::kQBytes;  // stage st: K at sKV + 2 st kKVBytes, V after it

  const int h = blockIdx.x, b = blockIdx.z;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;  // longest first
  const int q0 = qt * kBQ2;
  // keys [k_lo, k_hi) hold every live key of the block's rows
  const int qa_lo = q_offset + q0, qa_hi = q_offset + min(q0 + kBQ2, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(k_hi, qa_hi + 1);
  if (window) k_lo = max(k_lo, qa_lo - window + 1);
  const int t_lo = k_lo / kBK2;
  const int n_tiles = k_hi > k_lo ? (k_hi + kBK2 - 1) / kBK2 - t_lo : 0;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kStages; ++st) {
      mbar_init(bar_full_k + 8 * st, 1);
      mbar_init(bar_full_v + 8 * st, 1);
      mbar_init(bar_empty + 8 * st, kConsumerWarps);
    }
    mbar_init(bar_q, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, broadcast from lane 0 so that the compiler sees it uniform
  // over the warp: from threadIdx.x alone ptxas took 168 registers at hd
  // 128, spilled and serialized the wgmma (C7512)
  const int w = __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) / 128, 0);
  if (w == 2) {
    // producer: one thread issues every copy
    if (threadIdx.x == 2 * 128 && n_tiles > 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
      for (int c = 0; c < T::kColBlocks; ++c)
        tma_load(sQ + c * kBQ2 * T::kRowBytes, &map_q, bar_q, c * T::kRowBytes / 2, h, q0, b);
      const int hk = h / G;
      for (int i = 0; i < n_tiles; ++i) {
        const int st = i % kStages;
        mbar_wait(bar_empty + 8 * st, ((i / kStages) & 1) ^ 1);
        const int k0 = (t_lo + i) * kBK2;
        const uint32_t sK = sKV + 2 * st * T::kKVBytes, sV = sK + T::kKVBytes;
        mbar_expect_tx(bar_full_k + 8 * st, T::kKVBytes);
        for (int c = 0; c < T::kColBlocks; ++c)
          tma_load(sK + c * kBK2 * T::kRowBytes, &map_k, bar_full_k + 8 * st,
                   c * T::kRowBytes / 2, hk, k0, b);
        mbar_expect_tx(bar_full_v + 8 * st, T::kKVBytes);
        for (int c = 0; c < T::kColBlocks; ++c)
          tma_load(sV + c * kBK2 * T::kRowBytes, &map_v, bar_full_v + 8 * st,
                   c * T::kRowBytes / 2, hk, k0, b);
      }
    }
    return;
  }

  // consumers: warpgroup w owns rows [64 w, 64 w + 64) of the block's tile
  const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
  const int quad = lane % 4;
  const int row = 16 * warp + lane / 4;  // the thread's rows row, row + 8 of the warpgroup's 64
  const int qpos = q_offset + q0 + 64 * w + row;
  const int wq_lo = q_offset + q0 + 64 * w, wq_hi = wq_lo + 63;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  if (n_tiles > 0) {
    float s[64], corr[2], sum[2];
    uint32_t p[32];
    mbar_wait(bar_q, 0);
    for (int i = 0; i < n_tiles; ++i) {
      const int st = i % kStages;
      const uint32_t ph = (i / kStages) & 1, sK = sKV + 2 * st * T::kKVBytes;
      mbar_wait(bar_full_k + 8 * st, ph);
      wgmma_fence();
      issue_qk<HD>(s, sQ, 64 * w, sK);
      wgmma_commit();
      wgmma_wait();
      fence_regs(s);
      const int k0 = (t_lo + i) * kBK2;
      // the compares only where the tile straddles Sk, the diagonal or the window's edge
      if (k0 + kBK2 > Sk || (causal && k0 + kBK2 - 1 > wq_lo) || (window && k0 <= wq_hi - window))
        mask_tile(s, k0, qpos, quad, Sk, causal, window);
      softmax_tile(s, m, corr, sum, scale_log2);
      // o and l to the new max; P from the exponentiated logits
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          o[4 * n + 2 * r] *= corr[r];
          o[4 * n + 2 * r + 1] *= corr[r];
        }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + sum[r];
#pragma unroll
      for (int j = 0; j < 32; ++j) p[j] = pack_bf16(s[2 * j], s[2 * j + 1]);
      mbar_wait(bar_full_v + 8 * st, ph);
      wgmma_fence();
      issue_pv<HD>(o, p, sK + T::kKVBytes);
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      fence_regs(p);
      if (lane == 0) mbar_arrive(bar_empty + 8 * st);  // this warp is done with the stage
    }
  }

  // epilogue: o / max(l, 1e-30) as bf16 into the warpgroup's Q rows (the
  // TMA store's swizzled layout), then one TMA store of 64 rows
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) inv[i] = __frcp_rn(fmaxf(quad_sum(l[i]), 1e-30f));
  const uint32_t stage_o = sQ + 64 * w * T::kRowBytes;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    const int col = 8 * n + 2 * quad;
    const int c = col / (T::kRowBytes / 2), cc = col % (T::kRowBytes / 2);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const uint32_t off = (row + 8 * i) * T::kRowBytes + cc * 2;
      const uint32_t swz = off ^ (((off >> 7) & T::kSwizzleMask) << 4);
      const uint32_t val = pack_bf16(o[4 * n + 2 * i] * inv[i], o[4 * n + 2 * i + 1] * inv[i]);
      asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(stage_o + c * kBQ2 * T::kRowBytes + swz),
                   "r"(val)
                   : "memory");
    }
  }
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + w) : "memory");
  if (tid == 0 && q0 + 64 * w < Sq) {
    for (int c = 0; c < T::kColBlocks; ++c)
      tma_store(&map_o, stage_o + c * kBQ2 * T::kRowBytes, c * T::kRowBytes / 2, h,
                q0 + 64 * w, b);
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Sq, Sk, Hq, Hkv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, q_offset;
  float scale;
  cudaStream_t stream;
};

// Lets the float32 kernel take its shared memory above 48 KB and asks for
// the largest carveout, so that two blocks fit on an SM at hd 128.
template <int HD, int CB>
cudaError_t set_smem_f32() {
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<HD, CB>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         F32Tiles<HD>::kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_attention_f32_kernel<HD, CB>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <int HD>
cudaError_t set_smem_bf16() {
  return cudaFuncSetAttribute(flash_attention_bf16_kernel<HD>,
                              cudaFuncAttributeMaxDynamicSharedMemorySize, Tiles<HD>::kSmem);
}

template <int HD>
int blocks_per_sm(bool f32) {
  int n = -1;
  cudaError_t err;
  if (f32) {
    if (set_smem_f32<HD, 16>() != cudaSuccess) return -1;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_attention_f32_kernel<HD, 16>,
                                                        kThreads, F32Tiles<HD>::kSmem);
  } else {
    if (set_smem_bf16<HD>() != cudaSuccess) return -1;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_attention_bf16_kernel<HD>,
                                                        kThreads2, Tiles<HD>::kSmem);
  }
  return err == cudaSuccess ? n : -1;
}

template <int HD, int CB>
int launch_f32_copies(const Args& a) {
  const int n_qt = (a.Sq + kBQ - 1) / kBQ;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  cudaError_t err = set_smem_f32<HD, CB>();
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hq, n_qt, a.B);
  flash_attention_f32_kernel<HD, CB><<<grid, kThreads, F32Tiles<HD>::kSmem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.Sq, a.Sk, a.Hq, a.Hq / a.Hkv,
      a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.causal, a.window,
      a.q_offset, a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// Every row of a float32 [B, S, H, hd] tensor starts on 16 bytes: its base,
// and the strides of its axes longer than 1, in whole 4-float units.
bool rows_16b_aligned(const void* p, int B, int S, int H, long long sb, long long ss,
                      long long sh) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 && (B == 1 || sb % 4 == 0) &&
         (S <= 1 || ss % 4 == 0) && (H == 1 || sh % 4 == 0);
}

// 16-byte copies where q, k and v allow them, 4-byte copies otherwise
template <int HD>
int launch_f32(const Args& a) {
  const bool wide = rows_16b_aligned(a.q, a.B, a.Sq, a.Hq, a.qsb, a.qss, a.qsh) &&
                    rows_16b_aligned(a.k, a.B, a.Sk, a.Hkv, a.ksb, a.kss, a.ksh) &&
                    rows_16b_aligned(a.v, a.B, a.Sk, a.Hkv, a.vsb, a.vss, a.vsh);
  return wide ? launch_f32_copies<HD, 16>(a) : launch_f32_copies<HD, 4>(a);
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no -lcuda.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [B, S, H, hd] tensor at element strides (sb, ss, sh) as a 4-D map
// (hd, H, S, B) with boxes of (row_bytes / 2, 1, rows, 1), swizzled by
// row_bytes. A stride of a size-1 axis is never used and is replaced by a
// valid one.
bool make_map(CUtensorMap* map, const void* ptr, int B, int S, int H, int hd, long long sb,
              long long ss, long long sh, int rows, int row_bytes) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  if (H == 1) sh = hd;
  if (S == 1) ss = sh * H;
  if (B == 1) sb = ss * S;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(sh) * 2, static_cast<cuuint64_t>(ss) * 2,
                                 static_cast<cuuint64_t>(sb) * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(row_bytes / 2), 1,
                             static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD>
int launch_bf16(const Args& a) {
  using T = Tiles<HD>;
  const int n_qt = (a.Sq + kBQ2 - 1) / kBQ2;
  if (n_qt > 65535) return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mo;
  const int rb = T::kRowBytes;
  if (!make_map(&mq, a.q, a.B, a.Sq, a.Hq, HD, a.qsb, a.qss, a.qsh, kBQ2, rb) ||
      !make_map(&mo, a.o, a.B, a.Sq, a.Hq, HD, static_cast<long long>(a.Sq) * a.Hq * HD,
                static_cast<long long>(a.Hq) * HD, HD, 64, rb))
    return cudaErrorInvalidValue;
  if (a.Sk > 0) {
    if (!make_map(&mk, a.k, a.B, a.Sk, a.Hkv, HD, a.ksb, a.kss, a.ksh, kBK2, rb) ||
        !make_map(&mv, a.v, a.B, a.Sk, a.Hkv, HD, a.vsb, a.vss, a.vsh, kBK2, rb))
      return cudaErrorInvalidValue;
  } else {
    mk = mv = mq;  // no KV tile is visited
  }
  cudaError_t err = set_smem_bf16<HD>();
  if (err != cudaSuccess) return err;
  const dim3 grid(a.Hq, n_qt, a.B);
  flash_attention_bf16_kernel<HD><<<grid, kThreads2, T::kSmem, a.stream>>>(
      mq, mk, mv, mo, a.Sq, a.Sk, a.Hq / a.Hkv, a.causal, a.window, a.q_offset,
      a.scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <int HD>
int launch(int dtype, const Args& a) {
  return dtype == 0 ? launch_f32<HD>(a) : launch_bf16<HD>(a);
}

}  // namespace

extern "C" {

// Blocks of the kernel that fit on one SM at the same time (-1 on error).
int flash_attention_blocks_per_sm(int dtype, int hd) {
  const bool f = dtype == 0;
  switch (hd) {
    case 16: return blocks_per_sm<16>(f);
    case 32: return blocks_per_sm<32>(f);
    case 64: return blocks_per_sm<64>(f);
    case 96: return blocks_per_sm<96>(f);
    case 128: return blocks_per_sm<128>(f);
    default: return -1;
  }
}

// Dynamic shared memory a block of the kernel takes, in bytes (-1 on error).
int flash_attention_smem_bytes(int dtype, int hd) {
  const bool f = dtype == 0;
  switch (hd) {
    case 16: return f ? F32Tiles<16>::kSmem : Tiles<16>::kSmem;
    case 32: return f ? F32Tiles<32>::kSmem : Tiles<32>::kSmem;
    case 64: return f ? F32Tiles<64>::kSmem : Tiles<64>::kSmem;
    case 96: return f ? F32Tiles<96>::kSmem : Tiles<96>::kSmem;
    case 128: return f ? F32Tiles<128>::kSmem : Tiles<128>::kSmem;
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 96, 128}. Strides are
// in elements, for the batch, sequence and head axes (the head_dim axis is
// contiguous); o is a contiguous [B, Sq, Hq, hd]. bf16 takes TMA: q, k, v
// and o 16-byte aligned, and the strides of axes longer than 1 multiples
// of 8 elements; float32 takes any of them (4-byte copies where 16-byte
// ones do not fit). Sq >= 1, Hq % Hkv == 0, B <= 65535; float32:
// ceil(Sq / 64) <= 65535; bf16: ceil(Sq / 128) <= 65535. Returns a
// cudaError_t.
int flash_attention_launch(int dtype, int hd, const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Sk, int Hq, int Hkv, long long qsb,
                           long long qss, long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss, long long vsh,
                           int causal, int window, int q_offset, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 0 || Hkv < 1 || Hq % Hkv || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, Sq, Sk, Hq, Hkv, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
               causal, window, q_offset, scale, static_cast<cudaStream_t>(stream)};
  switch (hd) {
    case 16: return launch<16>(dtype, a);
    case 32: return launch<32>(dtype, a);
    case 64: return launch<64>(dtype, a);
    case 96: return launch<96>(dtype, a);
    case 128: return launch<128>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
