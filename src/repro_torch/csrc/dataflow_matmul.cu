// The template's tile pipeline as a matmul, hand-written for Hopper
// (sm_90a): out = x @ w with fp32 accumulation, cast to the output type.
//
// Replaces the Pallas TPU kernel `dataflow_matmul`
// (src/repro/kernels/dataflow_matmul.py:51, body `_matmul_kernel`).  There
// the grid (M/bm, N/bn, K/bk) walks K last and in order; Pallas's pipeliner
// double-buffers the x and w tiles in VMEM (the access stage and its FIFO),
// the MXU contracts the resident tiles into an fp32 scratch accumulator
// (the execute stage), and the last k step casts it out.  Blocks on the
// card run in no order, so the three roles sit inside one block.  Two
// designs, and the wrapper (kernels/dataflow_matmul.py, `route`) picks one
// from the shapes, the types and the alignment before the launch:
//
// wgmma+tma: bf16 x bf16 with K and N multiples of 8 on 16-byte-aligned
// bases (what TMA takes).  Warp-specialised, 384 threads:
//
//  * access stage: one thread of the producer warpgroup (warpgroup 2)
//    issues TMA loads of the x tile (128 x 64) and of the w tile (64 x BN,
//    as BN/64 boxes of 64 x 64) into a ring of four stages in dynamic
//    shared memory, 128-byte swizzled.  TMA zero-fills entries past M, N
//    or K, so ragged edges need no padding copy;
//  * the FIFO: each stage has a "full" mbarrier, completed by the TMA
//    transaction count, and an "empty" one, on which the eight consumer
//    warps arrive — Pallas's two VMEM slots made explicit;
//  * execute stage: two consumer warpgroups, 64 rows each, run
//    wgmma.m64n64k16 (bf16 in, fp32 accumulate in registers) over the
//    resident stage: A (x, K-major) and B (w, N-major: the transpose bit)
//    both from shared memory.  A stage is released when wgmma.wait_group
//    says the products that read it are done, one stage behind the issue.
//    setmaxnreg gives the consumers the producer's registers;
//  * the cast: the fragments are rounded once to the output type and
//    stored under bounds checks; in bf16 one shuffle between lane pairs
//    lets each quad of lanes write whole 32-byte sectors (half-sector
//    stores cost more than the fp32 output's twice the bytes).
//
// BN (64 to 256) is chosen by the wrapper so that the tiles fill whole
// waves of the card's SMs at the caller's shapes.
//
// cuda-core fp32: every other call (f32 x f32, or bf16 rows that TMA
// cannot take).  Each of 256 threads owns an 8 x 8 patch of a 128 x 128
// output tile in fp32 registers and multiplies with FMAs on the CUDA cores
// (bf16 widened on read); tiles k+1 of x and w are copied into the free
// slot of a two-slot shared-memory ring with cp.async (zero-filling past
// the edges) while tile k is multiplied.  Rows that are not 16-byte
// multiples are staged through registers instead: the same two-slot
// overlap, for any shape and alignment.  fp32 keeps this route: TF32 would
// not meet the fp32 tolerance.
//
// What bounds it on the card: operations.  At the model's widths, (4096,
// 576) x (576, 1536) in bf16 is 7.25 GFLOP, 7.3 us on the tensor cores at
// 989 TFLOP/s, against 19.1 MB, 5.7 us at 3.35 TB/s.  The wgmma route
// feeds the tensor cores from a four-deep TMA ring; the cuda-core route
// is bound by FMA issue, far above the bound.
//
// Every entry point takes device pointers and a stream, launches on that
// stream without synchronising, and returns cudaGetLastError() (or
// cudaErrorInvalidValue for arguments it does not take).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up at
                   // run time (`encoder`), so nothing links libcuda
#include <cudaTypedefs.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

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

// ---------------------------------------------------------------------------
// The wgmma+tma route (bf16 in)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int BM = 128;              // two consumer warpgroups of 64 rows
constexpr int BK = 64;               // 64 bf16 = 128 bytes: one swizzle row
constexpr int STAGES = 4;            // depth of the TMA ring
constexpr int NT = 384;              // warpgroups 0-1 consume, 2 produces
constexpr int A_BYTES = BM * BK * 2;          // x tile, 16 KB
constexpr int A_HALF = 64 * BK * 2;           // one warpgroup's 64 rows
constexpr int B_BLOCK = BK * 64 * 2;          // 64 k-rows x 64 n-cols, 8 KB
constexpr int ROW = 128;                      // bytes per swizzled row
constexpr int ATOM = 8 * ROW;                 // 8 rows: one swizzle atom

template <int BN>
struct Cfg {
  static constexpr int NB = BN / 64;                  // 64-wide n blocks
  static constexpr int STAGE = A_BYTES + NB * B_BLOCK;
  static constexpr int SMEM = STAGES * STAGE + 1024;  // + 1024-B alignment
};

// One 2-D TMA box of `map` at (c0 innermost, c1) into shared memory; the
// bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile in shared memory:
// start address, leading and stride byte offsets (all in 16-byte units).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lead,
                                         uint32_t stride) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>((stride >> 4) & 0x3FFF) << 32 |
         static_cast<uint64_t>(1) << 62;  // 128-byte swizzle
}

__device__ __forceinline__ void fence_acc(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 64 per warpgroup, fp32) += A (64 x 16, K-major) * B (16 x 64,
// N-major: imm-trans-b = 1), both read from shared memory.
__device__ __forceinline__ void wgmma_64x64x16(float (&d)[32], uint64_t da,
                                               uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Store one row's part of two adjacent 8-column fragments, chunk c at
// `col0` and chunk c + 1 after it; lane t of each quad holds columns 2t,
// 2t + 1 of both (a0, a1 and b0, b1).  fp32: two 8-byte stores, a quad
// writes 32 contiguous bytes of each chunk.  bf16: one shuffle between
// lane pairs gives each lane four consecutive columns, so the quad writes
// the row's 32 contiguous bytes (a whole sector), not two halves.  All
// lanes call it; `in` masks the store only.
__device__ __forceinline__ void store_pair(float* row, int col0, int lane,
                                           float a0, float a1, float b0,
                                           float b1, bool in, int N) {
  const int col = col0 + 2 * (lane % 4);
  // N % 8 == 0: each chunk is in or out as a whole
  if (in && col < N)
    *reinterpret_cast<float2*>(row + col) = make_float2(a0, a1);
  if (in && col + 8 < N)
    *reinterpret_cast<float2*>(row + col + 8) = make_float2(b0, b1);
}
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col0,
                                           int lane, float a0, float a1,
                                           float b0, float b1, bool in,
                                           int N) {
  const uint32_t lo = pack_bf16(a0, a1), hi = pack_bf16(b0, b1);
  const bool odd = lane & 1;
  const uint32_t got = __shfl_xor_sync(0xffffffffu, odd ? lo : hi, 1);
  const int t = lane % 4, col = col0 + 4 * (t / 2) + 8 * (t & 1);
  if (in && col < N)
    *reinterpret_cast<uint2*>(row + col) =
        odd ? make_uint2(got, hi) : make_uint2(lo, got);
}

template <int BN, typename TO>
__global__ void __launch_bounds__(NT, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
             const __grid_constant__ CUtensorMap wmap, TO* __restrict__ out,
             int M, int N, int K) {
  constexpr int NB = Cfg<BN>::NB, STAGE = Cfg<BN>::STAGE;
  extern __shared__ unsigned char dyn[];
  __shared__ __align__(8) uint64_t full[STAGES], empty[STAGES];
  // 128-byte swizzle repeats every 1024 bytes: align the ring to that
  const uint32_t ring = (smem_u32(dyn) + 1023u) & ~1023u;
  const int role = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int nk = (K + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full[s]), 1);   // the producer's expect_tx
      mbar_init(smem_u32(&empty[s]), 8);  // lane 0 of each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (role == 2) {
    // -- access stage: one thread keeps the ring full ----------------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(smem_u32(&empty[s]), ((kt / STAGES) & 1) ^ 1);
        const uint32_t a = ring + s * STAGE, bar = smem_u32(&full[s]);
        mbar_arrive_expect_tx(bar, STAGE);
        tma_load(a, &xmap, bar, kt * BK, m0);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          tma_load(a + A_BYTES + j * B_BLOCK, &wmap, bar, n0 + 64 * j,
                   kt * BK);
      }
    }
  } else {
    // -- execute stage: two warpgroups of 64 rows --------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    float acc[NB][32];
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[j][i] = 0.f;
    const bool lead = tid % 32 == 0;
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % STAGES;
      mbar_wait(smem_u32(&full[s]), (kt / STAGES) & 1);
      const uint32_t a = ring + s * STAGE + role * A_HALF;
      const uint32_t b = ring + s * STAGE + A_BYTES;
#pragma unroll
      for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int ks = 0; ks < BK / 16; ++ks) {
        // A: K-major, the k16 slice 32 bytes along each 128-byte row;
        // B: N-major, the k16 slice 16 rows (two swizzle atoms) down
        const uint64_t da = desc(a + ks * 32, 16, ATOM);
#pragma unroll
        for (int j = 0; j < NB; ++j)
          wgmma_64x64x16(acc[j],
                         da, desc(b + j * B_BLOCK + ks * 16 * ROW, B_BLOCK,
                                  ATOM));
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // the products of tile kt-1 are done: its stage is free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
#pragma unroll
      for (int j = 0; j < NB; ++j) fence_acc(acc[j]);
      if (kt > 0 && lead) mbar_arrive(smem_u32(&empty[(kt - 1) % STAGES]));
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
#pragma unroll
    for (int j = 0; j < NB; ++j) fence_acc(acc[j]);

    // -- the cast at the last k: fragment i of n block j holds row
    // 16*warp + lane/4 + 8*((i/2)%2), column 64j + 8*(i/4) + 2*(lane%4) +
    // i%2 of the warpgroup's 64 x BN tile
    const int warp = tid / 32, lane = tid % 32;
    const int r0 = m0 + role * 64 + warp * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = r0 + 8 * h;
      TO* orow = out + static_cast<size_t>(row) * N;
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int c = 0; c < 8; c += 2)
          store_pair(orow, n0 + 64 * j + 8 * c, lane, acc[j][4 * c + 2 * h],
                     acc[j][4 * c + 2 * h + 1], acc[j][4 * c + 4 + 2 * h],
                     acc[j][4 * c + 5 + 2 * h], row < M, N);
    }
  }
}

// cuTensorMapEncodeTiled, looked up once through the CUDA runtime.
PFN_cuTensorMapEncodeTiled encoder() {
  static PFN_cuTensorMapEncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                         cudaEnableDefault, &q) !=
            cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      p = nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) != cudaSuccess)
      p = nullptr;
#endif
    fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major (rows, cols) bf16 matrix in boxes of
// (box_rows, 64 columns), 128-byte swizzled; entries past the matrix read
// as zeros.
bool make_map(CUtensorMap* map, const void* base, int rows, int cols,
              int box_rows) {
  PFN_cuTensorMapEncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(base), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BN, typename TO>
int launch_bn(const CUtensorMap& xm, const CUtensorMap& wm, TO* out, int M,
              int N, int K, cudaStream_t s) {
  auto kernel = wgmma_kernel<BN, TO>;
  // the opt-in to more than 48 KB of shared memory, once per device
  static unsigned ready = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && !(ready >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg<BN>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready |= 1u << dev;
  }
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  kernel<<<grid, NT, Cfg<BN>::SMEM, s>>>(xm, wm, out, M, N, K);
  return static_cast<int>(cudaGetLastError());
}

template <typename TO>
int launch(const void* x, const void* w, void* out, int M, int N, int K,
           int block_n, void* stream) {
  if (M <= 0 || N <= 0) return 0;
  if (K <= 0 || K % 8 != 0 || N % 8 != 0 ||
      reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(w) % 16 != 0 ||
      (M + BM - 1) / BM > kMaxGridY)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap xm, wm;
  if (!make_map(&xm, x, M, K, BM) || !make_map(&wm, w, K, N, BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  TO* o = static_cast<TO*>(out);
  switch (block_n) {
    case 64: return launch_bn<64>(xm, wm, o, M, N, K, s);
    case 128: return launch_bn<128>(xm, wm, o, M, N, K, s);
    case 192: return launch_bn<192>(xm, wm, o, M, N, K, s);
    case 256: return launch_bn<256>(xm, wm, o, M, N, K, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace wg

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

// The wgmma+tma route: x (M, K) and w (K, N) bf16, out (M, N); all
// contiguous, K and N multiples of 8, x and w 16-byte aligned; block_n is
// the output tile's width, one of 64, 128, 192, 256.
#define WGMMA_ENTRY(NAME, TO)                                             \
  extern "C" int NAME(const void* x, const void* w, void* out, int M,    \
                      int N, int K, int block_n, void* stream) {         \
    return wg::launch<TO>(x, w, out, M, N, K, block_n, stream);          \
  }

WGMMA_ENTRY(dataflow_matmul_wgmma_bf16_bf16, __nv_bfloat16)
WGMMA_ENTRY(dataflow_matmul_wgmma_bf16_f32, float)
