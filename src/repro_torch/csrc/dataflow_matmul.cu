// The template's tile pipeline as a matmul, hand-written for Hopper
// (sm_90a): out = x @ w with fp32 accumulation, cast to the output type.
//
// Replaces the Pallas TPU kernel `dataflow_matmul`
// (src/repro/kernels/dataflow_matmul.py:51, body `_matmul_kernel`).  There
// the grid (M/bm, N/bn, K/bk) walks K last and in order; Pallas's pipeliner
// double-buffers the x and w tiles in VMEM (the access stage and its FIFO),
// the MXU contracts the resident tiles into an fp32 scratch accumulator
// (the execute stage), and the last k step casts it out.  Here the same
// three roles sit inside one block, because blocks run in no order:
//
//  * access stage: the block's threads copy tile k+1 of x (BM x BK) and of
//    w (BK x BN) into the free slot of a two-slot shared-memory ring with
//    cp.async, before they multiply tile k — the pipeliner's two VMEM slots
//    as an explicit FIFO, cp.async.wait_group as the pop;
//  * execute stage: each of 256 threads owns an 8 x 8 patch of the
//    128 x 128 output tile, in fp32 registers, and multiplies the resident
//    tiles with FMAs on the CUDA cores (bf16 is widened to fp32 on read);
//  * the cast: the accumulator is rounded once to the output type and
//    written under bounds checks, so ragged M, N and K need no padding
//    copy (ops.matmul pads nothing).  Tile entries past K, M or N are
//    zero-filled by the copy itself (cp.async's source size).
//
// cp.async moves 16-byte chunks, so the ring is filled that way when the
// rows of x and w are 16-byte multiples on 16-byte-aligned bases (the model
// widths are).  Otherwise the tile k+1 is loaded element by element into
// registers before tile k is multiplied and stored into the free slot
// after: the same two-slot overlap, for any shape and alignment.
//
// Types: f32 x f32 and bf16 x bf16 in, f32 or bf16 out.
//
// What bounds it on the card: operations.  At the model's widths, (4096,
// 576) x (576, 1536) in bf16 is 7.25 GFLOP, 7.3 us on the tensor cores at
// 989 TFLOP/s, against 19.1 MB, 5.7 us at 3.35 TB/s.  This first design
// runs its FMAs on the CUDA cores (67 TFLOP/s fp32 at best), so it is
// bound by instruction issue far above that; mma/wgmma on bf16 tiles fed
// by TMA is later work.
//
// Every entry point takes device pointers and a stream, launches on that
// stream without synchronising, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int BM = 128, BN = 128, BK = 16;  // output tile and k step
constexpr int NT = 256;                     // threads: 16 x 16, 8 x 8 each
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch rounds
}

// Four consecutive values from shared memory (16 bytes f32, 8 bytes bf16).
__device__ __forceinline__ void load4(const float* p, float* o) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  o[0] = a.x; o[1] = a.y; o[2] = a.z; o[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* o) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  o[0] = f0.x; o[1] = f0.y; o[2] = f1.x; o[3] = f1.y;
}

// 16 bytes global -> shared; `bytes` < 16 zero-fills the rest (0: all).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename T>
struct Tiles {
  static constexpr int CE = 16 / sizeof(T);  // elements per 16-byte chunk
  static constexpr int PAD = CE;             // keeps rows 16-byte aligned
  T a[2][BM][BK + PAD];                      // x tiles, row-major as in x
  T b[2][BK][BN + PAD];                      // w tiles, row-major as in w
};

template <typename T, typename TO, bool ASYNC>
__global__ void __launch_bounds__(NT)
matmul_kernel(const T* __restrict__ x, const T* __restrict__ w,
              TO* __restrict__ out, int M, int N, int K) {
  using S = Tiles<T>;
  constexpr int CE = S::CE;
  __shared__ __align__(16) unsigned char raw[sizeof(S)];
  S& sm = *reinterpret_cast<S*>(raw);
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  // -- access stage ---------------------------------------------------------
  // x tile: BM rows of BK/CE chunks; w tile: BK rows of BN/CE chunks.
  auto issue = [&](int slot, int kt) {
    const int k0 = kt * BK;
    for (int c = tid; c < BM * BK / CE; c += NT) {
      const int r = c / (BK / CE), kc = (c % (BK / CE)) * CE;
      const int gm = m0 + r, gk = k0 + kc;
      const bool in = gm < M && gk < K;  // K % CE == 0 on this path
      cp_async16(&sm.a[slot][r][kc],
                 in ? x + static_cast<size_t>(gm) * K + gk : x,
                 in ? 16 : 0);
    }
    for (int c = tid; c < BK * BN / CE; c += NT) {
      const int r = c / (BN / CE), nc = (c % (BN / CE)) * CE;
      const int gk = k0 + r, gn = n0 + nc;
      const bool in = gk < K && gn < N;  // N % CE == 0 on this path
      cp_async16(&sm.b[slot][r][nc],
                 in ? w + static_cast<size_t>(gk) * N + gn : w,
                 in ? 16 : 0);
    }
  };
  // the register-staged form, for shapes cp.async cannot take
  constexpr int EA = BM * BK / NT, EB = BK * BN / NT;
  T ra[EA], rb[EB];
  auto fetch = [&](int kt) {
    const int k0 = kt * BK;
#pragma unroll
    for (int t = 0; t < EA; ++t) {
      const int e = tid + NT * t, r = e / BK, kk = e % BK;
      const int gm = m0 + r, gk = k0 + kk;
      ra[t] = gm < M && gk < K ? x[static_cast<size_t>(gm) * K + gk]
                               : from_float<T>(0.f);
    }
#pragma unroll
    for (int t = 0; t < EB; ++t) {
      const int e = tid + NT * t, r = e / BN, nn = e % BN;
      const int gk = k0 + r, gn = n0 + nn;
      rb[t] = gk < K && gn < N ? w[static_cast<size_t>(gk) * N + gn]
                               : from_float<T>(0.f);
    }
  };
  auto store = [&](int slot) {
#pragma unroll
    for (int t = 0; t < EA; ++t) {
      const int e = tid + NT * t;
      sm.a[slot][e / BK][e % BK] = ra[t];
    }
#pragma unroll
    for (int t = 0; t < EB; ++t) {
      const int e = tid + NT * t;
      sm.b[slot][e / BN][e % BN] = rb[t];
    }
  };

  // -- execute stage --------------------------------------------------------
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  if (nk > 0) {
    if constexpr (ASYNC) {
      issue(0, 0);
      cp_async_commit();
    } else {
      fetch(0);
      store(0);
    }
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if constexpr (ASYNC) {
      if (kt + 1 < nk) issue(cur ^ 1, kt + 1);  // runs ahead of the FMAs
      cp_async_commit();                       // (an empty group at the end)
      cp_async_wait_one();                     // tile kt has landed
    } else if (kt + 1 < nk) {
      fetch(kt + 1);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], b[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        a[i] = to_float(sm.a[cur][ty * 4 + i][k]);
        a[4 + i] = to_float(sm.a[cur][64 + ty * 4 + i][k]);
      }
      load4(&sm.b[cur][k][tx * 4], b);
      load4(&sm.b[cur][k][64 + tx * 4], b + 4);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();  // slot cur is free for tile kt+2
    if constexpr (!ASYNC) {
      if (kt + 1 < nk) store(cur ^ 1);
    }
  }

  // -- the cast at the last k -------------------------------------------------
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int gm = m0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
    if (gm >= M) continue;
    TO* orow = out + static_cast<size_t>(gm) * N;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int gn = n0 + (j < 4 ? tx * 4 + j : 64 + tx * 4 + j - 4);
      if (gn < N) orow[gn] = from_float<TO>(acc[i][j]);
    }
  }
}

template <typename T, typename TO>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           void* stream) {
  if (M <= 0 || N <= 0) return 0;
  const int gy = (M + BM - 1) / BM;
  if (gy > kMaxGridY) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((N + BN - 1) / BN, gy);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool aligned =
      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(w) % 16 == 0 &&
      (static_cast<size_t>(K) * sizeof(T)) % 16 == 0 &&
      (static_cast<size_t>(N) * sizeof(T)) % 16 == 0;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  TO* op = static_cast<TO*>(out);
  if (aligned) {
    matmul_kernel<T, TO, true><<<grid, NT, 0, s>>>(xp, wp, op, M, N, K);
  } else {
    matmul_kernel<T, TO, false><<<grid, NT, 0, s>>>(xp, wp, op, M, N, K);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) and w (K, N) of one type, out (M, N); all contiguous.
#define MATMUL_ENTRY(NAME, T, TO)                                         \
  extern "C" int NAME(const void* x, const void* w, void* out, int M,    \
                      int N, int K, void* stream) {                      \
    return launch<T, TO>(x, w, out, M, N, K, stream);                    \
  }

MATMUL_ENTRY(dataflow_matmul_f32_f32, float, float)
MATMUL_ENTRY(dataflow_matmul_f32_bf16, float, __nv_bfloat16)
MATMUL_ENTRY(dataflow_matmul_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
MATMUL_ENTRY(dataflow_matmul_bf16_f32, __nv_bfloat16, float)
