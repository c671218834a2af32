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
//     two 64-element column blocks). TMA fills zeros past Sq and Sk.
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
// float32: the CUDA-core design (its bar is 2e-5 under strict float32; the
// tensor cores would give TF32). One block of 256 threads owns one (b, q
// head, 64-row q tile); each KV step stages a 64-row K and V tile in shared
// memory as float32; every thread owns 4 query rows x 4 key columns of the
// logits and 4 rows x hd/16 columns of the accumulator, so m, l and the
// accumulator live in registers and the row max and sum are half-warp
// shuffles; probabilities go through shared memory to the PV product. It
// reads the strided layout in place, masks the ragged edges itself and
// visits only KV tiles that hold a live key.
#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF

// ===========================================================================
// float32: CUDA cores
// ===========================================================================

constexpr int kBQ = 64;        // query rows a block owns
constexpr int kBK = 64;        // keys a KV tile holds
constexpr int kThreads = 256;  // 16 row groups x 16 column groups
constexpr int kKPad = 4;       // K rows stay 16-byte aligned, 4 banks apart

// Reductions over the 16 lanes of a half-warp (one row group); every lane
// ends with the same bits.
__device__ __forceinline__ float half_warp_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return reinterpret_cast<const float*>(&v)[i];
}

template <int HD>
struct Layout {
  // sQ [kBQ][HD] (read as broadcasts), sK [kBK][kKStride], sV [kBK][HD],
  // sP [kBQ][kBK] (written as scalars, read as broadcasts)
  static constexpr int kKStride = HD + kKPad;
  static constexpr int kFloats = kBQ * HD + kBK * kKStride + kBK * HD + kBQ * kBK;
  // accumulator columns a thread owns: kGroups runs of kVec adjacent columns
  static constexpr int kCols = HD / 16;
  static constexpr int kVec = kCols < 4 ? kCols : 4;
  static constexpr int kGroups = kCols / kVec;
};

// grid (ceil(Sq / kBQ), Hq, B); dynamic shared memory Layout<HD>::kFloats floats
template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                           const float* __restrict__ v, float* __restrict__ o, int Sq, int Sk,
                           int Hq, int G, long long qsb, long long qss, long long qsh,
                           long long ksb, long long kss, long long ksh, long long vsb,
                           long long vss, long long vsh, int causal, int window, int q_offset,
                           float scale) {
  using L = Layout<HD>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * HD;
  float* sV = sK + kBK * L::kKStride;
  float* sP = sV + kBK * HD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const float* qb = q + b * qsb + h * qsh;
  const float* kb = k + b * ksb + (h / G) * ksh;
  const float* vb = v + b * vsb + (h / G) * vsh;

  // the q tile; rows past Sq are zero (computed, never written)
  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    sQ[r * HD + d] = q0 + r < Sq ? qb[(q0 + r) * qss + d] : 0.f;
  }

  // keys [k_lo, k_hi) hold every live key of this q tile
  const int qa_lo = q_offset + q0;
  const int qa_hi = q_offset + min(q0 + kBQ, Sq) - 1;
  int k_lo = 0, k_hi = Sk;
  if (causal) k_hi = min(k_hi, qa_hi + 1);
  if (window) k_lo = max(k_lo, qa_lo - window + 1);

  float m[4], l[4], acc[4][L::kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < L::kCols; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the last tile's reads are done; sQ is visible
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int r = idx / HD, d = idx % HD;
      const bool in = k0 + r < Sk;  // rows past Sk are zero: p is 0 there, never NaN
      sK[r * L::kKStride + d] = in ? kb[(k0 + r) * kss + d] : 0.f;
      sV[r * HD + d] = in ? vb[(k0 + r) * vss + d] : 0.f;
    }
    __syncthreads();

    // logits of rows ty*4+i, keys tx+16j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(&sQ[(ty * 4 + i) * HD + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(&sK[(tx + 16 * j) * L::kKStride + d]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          s[i][j] += qv[i].x * kv.x + qv[i].y * kv.y + qv[i].z * kv.z + qv[i].w * kv.w;
      }
    }

    // the online softmax step of each row
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty * 4 + i;
      bool live[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        live[j] = kpos < Sk && (!causal || kpos <= qpos) && (!window || kpos > qpos - window);
        s[i][j] = live[j] ? s[i][j] * scale : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], half_warp_max(mx));
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = live[j] ? expf(s[i][j] - m_new) : 0.f;
        sum += s[i][j];
      }
      sum = half_warp_sum(sum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < L::kCols; ++c) acc[i][c] *= corr;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * kBK + tx + 16 * j] = s[i][j];
    }
    __syncthreads();

    // acc += P V over this tile's keys
#pragma unroll 2
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(&sP[(ty * 4 + i) * kBK + kk]);
#pragma unroll
      for (int kd = 0; kd < 4; ++kd) {
        const float* vrow = sV + (kk + kd) * HD;
        float vals[L::kCols];
#pragma unroll
        for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
          for (int e = 0; e < L::kVec; ++e)
            vals[g * L::kVec + e] = vrow[g * 16 * L::kVec + tx * L::kVec + e];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane(pv[i], kd);
#pragma unroll
          for (int c = 0; c < L::kCols; ++c) acc[i][c] += p * vals[c];
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= Sq) continue;
    float* orow = o + ((static_cast<long long>(b) * Sq + qi) * Hq + h) * HD;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e)
        orow[g * 16 * L::kVec + tx * L::kVec + e] = acc[i][g * L::kVec + e] / denom;
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
  // bytes of one swizzled row: the swizzle span (a 64-element column block at hd 128)
  static constexpr int kRowBytes = HD * 2 < 128 ? HD * 2 : 128;
  static constexpr int kColBlocks = HD * 2 / kRowBytes;
  static constexpr int kStepsPerBlock = kRowBytes / 32;  // k16 steps in one column block
  // wgmma descriptor swizzle mode: 1 = 128 B, 2 = 64 B, 3 = 32 B
  static constexpr int kDescSwizzle = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kSwizzleMask = kRowBytes / 16 - 1;  // of the 16-byte chunk index
  static constexpr int kQBytes = kBQ2 * HD * 2;
  static constexpr int kKVBytes = kBK2 * HD * 2;  // one K or one V tile
  static constexpr int kSmem = kBarrierBytes + 1024 + kQBytes + 2 * kStages * kKVBytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
// apart, column blocks kBK2 rows apart).
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

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
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
template <int HD>
cudaError_t set_smem_f32() {
  const int smem = Layout<HD>::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_f32_kernel<HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_attention_f32_kernel<HD>,
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
    if (set_smem_f32<HD>() != cudaSuccess) return -1;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, flash_attention_f32_kernel<HD>, kThreads,
        Layout<HD>::kFloats * static_cast<int>(sizeof(float)));
  } else {
    if (set_smem_bf16<HD>() != cudaSuccess) return -1;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_attention_bf16_kernel<HD>,
                                                        kThreads2, Tiles<HD>::kSmem);
  }
  return err == cudaSuccess ? n : -1;
}

template <int HD>
int launch_f32(const Args& a) {
  const int smem = Layout<HD>::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = set_smem_f32<HD>();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_attention_f32_kernel<HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o), a.Sq, a.Sk, a.Hq, a.Hq / a.Hkv,
      a.qsb, a.qss, a.qsh, a.ksb, a.kss, a.ksh, a.vsb, a.vss, a.vsh, a.causal, a.window,
      a.q_offset, a.scale);
  return cudaGetLastError();
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
    case 128: return blocks_per_sm<128>(f);
    default: return -1;
  }
}

// Dynamic shared memory a block of the kernel takes, in bytes (-1 on error).
int flash_attention_smem_bytes(int dtype, int hd) {
  const bool f = dtype == 0;
  switch (hd) {
    case 16: return f ? Layout<16>::kFloats * 4 : Tiles<16>::kSmem;
    case 32: return f ? Layout<32>::kFloats * 4 : Tiles<32>::kSmem;
    case 64: return f ? Layout<64>::kFloats * 4 : Tiles<64>::kSmem;
    case 128: return f ? Layout<128>::kFloats * 4 : Tiles<128>::kSmem;
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 128}. Strides are
// in elements, for the batch, sequence and head axes (the head_dim axis is
// contiguous); o is a contiguous [B, Sq, Hq, hd]. bf16 takes TMA: q, k, v
// and o 16-byte aligned, and the strides of axes longer than 1 multiples
// of 8 elements. Sq >= 1, Hq % Hkv == 0, B <= 65535; float32: Hq <= 65535;
// bf16: ceil(Sq / 128) <= 65535. Returns a cudaError_t.
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
    case 128: return launch<128>(dtype, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
