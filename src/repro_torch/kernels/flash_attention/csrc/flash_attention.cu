// Flash attention (forward) for Hopper (sm_90a), plain C ABI.
//
// Replaces the Pallas TPU kernel
//   src/repro/kernels/flash_attention/kernel.py::_fa_kernel
//   (flash_attention_pallas): blockwise online-softmax attention of
//   q [B, Sq, Hq, hd] over k, v [B, Sk, Hkv, hd] (float32 or bf16), with
//   GQA (query head h reads KV head h / G), causal and sliding-window masks
//   and a query offset (query i sits at position q_offset + i, keys at
//   0..Sk-1). Semantics are the Pallas kernel's: scale 1/sqrt(hd), masked
//   logits set to NEG_INF = -1e30, an fp32 online softmax with fp32 running
//   max m, sum l and accumulator, the final divide by max(l, 1e-30) (so a
//   row with no live key is 0), the output cast to q's dtype.
//
// Bound on an H100 SXM: 4 * hd operations per live (query, key) pair (two
// products of hd multiply-adds each) at 989 TFLOP/s dense bf16, or q, k, v
// read once and o written once at 3.35 TB/s, whichever is larger. At
// StarCoder2-3B widths ([1, 8192, 24/2, 128] bf16, causal, window 4096:
// 37% of the pairs live) that is the operations, ~0.31 ms.
//
// Design. The TPU grid (B, Hq, nQ, nK) runs its KV axis in order, with the
// output tile, m and l resident in VMEM across it. Here one block of 256
// threads owns one (b, q head, 64-row q tile); the KV sweep is a loop
// inside the block. Each step stages a 64-row K tile and V tile in shared
// memory as float32; every thread owns 4 query rows x 4 key columns of the
// logits (keys tx + 16 j, so a quarter-warp's 16-byte K reads fall on
// distinct banks) and 4 query rows x hd/16 columns of the accumulator, so
// m, l, the row's correction and the accumulator live in registers, and
// the row max and sum are half-warp shuffles. Probabilities go through
// shared memory to the PV product. At hd 128 a block holds 113 KB of
// shared memory, so two blocks (16 warps) share an SM.
//   - The kernel reads the strided [B, S, H, hd] layout in place (no
//     transposed or padded copy) and masks the ragged q and KV edges itself.
//   - It visits only the KV tiles that hold a live key for its q tile under
//     causal, window and q_offset; the Pallas kernel sweeps all of them. A
//     fully masked tile changes no row (m unchanged, correction exp(0) = 1,
//     p = 0), so skipping it changes no result.
//   - All products run on the CUDA cores in float32 (the f32 parity bar is
//     2e-5). That caps it near 67 TFLOP/s, far under the bf16 tensor-core
//     bound: mma.sync / wgmma tiles, TMA and a pipelined KV ring are later
//     work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;  // the Pallas kernel's NEG_INF
constexpr int kBQ = 64;            // query rows a block owns
constexpr int kBK = 64;            // keys a KV tile holds
constexpr int kThreads = 256;      // 16 row groups x 16 column groups
constexpr int kKPad = 4;           // K rows stay 16-byte aligned, 4 banks apart

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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Sq, int Sk, int Hq,
                       int G, long long qsb, long long qss, long long qsh, long long ksb,
                       long long kss, long long ksh, long long vsb, long long vss,
                       long long vsh, int causal, int window, int q_offset, float scale) {
  using L = Layout<HD>;
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);
  float* sK = sQ + kBQ * HD;
  float* sV = sK + kBK * L::kKStride;
  float* sP = sV + kBK * HD;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const T* qb = q + b * qsb + h * qsh;
  const T* kb = k + b * ksb + (h / G) * ksh;
  const T* vb = v + b * vsb + (h / G) * vsh;

  // the q tile; rows past Sq are zero (computed, never written)
  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    sQ[r * HD + d] = q0 + r < Sq ? to_f(qb[(q0 + r) * qss + d]) : 0.f;
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
      sK[r * L::kKStride + d] = in ? to_f(kb[(k0 + r) * kss + d]) : 0.f;
      sV[r * HD + d] = in ? to_f(vb[(k0 + r) * vss + d]) : 0.f;
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
    T* orow = o + ((static_cast<long long>(b) * Sq + qi) * Hq + h) * HD;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int g = 0; g < L::kGroups; ++g)
#pragma unroll
      for (int e = 0; e < L::kVec; ++e)
        orow[g * 16 * L::kVec + tx * L::kVec + e] = from_f<T>(acc[i][g * L::kVec + e] / denom);
  }
}

struct Args {
  const void *q, *k, *v;
  void* o;
  int B, Sq, Sk, Hq, Hkv;
  long long qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh;
  int causal, window, q_offset;
  float scale;
  cudaStream_t stream;
};

// Lets the kernel take its shared memory above 48 KB and asks for the
// largest carveout, so that two blocks fit on an SM at hd 128.
template <typename T, int HD>
cudaError_t set_smem() {
  const int smem = Layout<HD>::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(flash_attention_kernel<T, HD>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

template <typename T, int HD>
int blocks_per_sm() {
  int n = -1;
  if (set_smem<T, HD>() != cudaSuccess) return -1;
  const int smem = Layout<HD>::kFloats * static_cast<int>(sizeof(float));
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, flash_attention_kernel<T, HD>, kThreads,
                                                    smem) != cudaSuccess)
    return -1;
  return n;
}

template <typename T, int HD>
int launch(const Args& a) {
  const int smem = Layout<HD>::kFloats * static_cast<int>(sizeof(float));
  cudaError_t err = set_smem<T, HD>();
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kBQ - 1) / kBQ, a.Hq, a.B);
  flash_attention_kernel<T, HD><<<grid, kThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<T*>(a.o), a.Sq, a.Sk, a.Hq, a.Hq / a.Hkv, a.qsb, a.qss, a.qsh, a.ksb, a.kss,
      a.ksh, a.vsb, a.vss, a.vsh, a.causal, a.window, a.q_offset, a.scale);
  return cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const Args& a) {
  switch (hd) {
    case 16: return launch<T, 16>(a);
    case 32: return launch<T, 32>(a);
    case 64: return launch<T, 64>(a);
    case 128: return launch<T, 128>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Blocks of the kernel that fit on one SM at the same time (-1 on error).
int flash_attention_blocks_per_sm(int dtype, int hd) {
  const bool f = dtype == 0;
  switch (hd) {
    case 16: return f ? blocks_per_sm<float, 16>() : blocks_per_sm<__nv_bfloat16, 16>();
    case 32: return f ? blocks_per_sm<float, 32>() : blocks_per_sm<__nv_bfloat16, 32>();
    case 64: return f ? blocks_per_sm<float, 64>() : blocks_per_sm<__nv_bfloat16, 64>();
    case 128: return f ? blocks_per_sm<float, 128>() : blocks_per_sm<__nv_bfloat16, 128>();
    default: return -1;
  }
}

// dtype: 0 = float32, 1 = bfloat16; hd in {16, 32, 64, 128}. Strides are
// in elements, for the batch, sequence and head axes (the head_dim axis is
// contiguous); o is a contiguous [B, Sq, Hq, hd]. Sq >= 1, Hq % Hkv == 0,
// B and Hq <= 65535. Returns a cudaError_t.
int flash_attention_launch(int dtype, int hd, const void* q, const void* k, const void* v,
                           void* o, int B, int Sq, int Sk, int Hq, int Hkv, long long qsb,
                           long long qss, long long qsh, long long ksb, long long kss,
                           long long ksh, long long vsb, long long vss, long long vsh,
                           int causal, int window, int q_offset, float scale, void* stream) {
  if (B < 1 || Sq < 1 || Sk < 0 || Hkv < 1 || Hq % Hkv) return cudaErrorInvalidValue;
  const Args a{q, k, v, o, B, Sq, Sk, Hq, Hkv, qsb, qss, qsh, ksb, kss, ksh, vsb, vss, vsh,
               causal, window, q_offset, scale, static_cast<cudaStream_t>(stream)};
  switch (dtype) {
    case 0: return launch_hd<float>(hd, a);
    case 1: return launch_hd<__nv_bfloat16>(hd, a);
    default: return cudaErrorInvalidValue;
  }
}

}  // extern "C"
