// Streaming attention with an online softmax, hand-written for Hopper
// (sm_90a): GQA prefill (flash_attention) and one-token decode over a
// ragged KV cache (decode_attention).
//
// Replaces the Pallas kernels `_prefill_kernel` and `_decode_kernel` of
// src/repro/kernels/flash_attention.py (`flash_attention`, :85, and
// `decode_attention`, :178).  Same function: fp32 running state (m, l,
// acc), kv head h / (Hq/Hkv), scale 1/sqrt(d) unless given, mask value
// -0.7*FLT_MAX, l clamped to at least 1e-20, output in the input type.
// The causal mask aligns query and key positions from 0, as the Pallas
// kernel's does.
//
// What bounds it on the card.  At the serving path's shapes (smollm-135m:
// 9 query heads over 3 kv heads, d = 64, 512-token prompts) prefill reads
// ~12.6 MB and does ~2.4 GFLOP, so the least time is set by the bytes and
// is a few microseconds; a one-token decode step reads the valid cache
// prefix (~3.2 MB at batch 8), under a microsecond.
//
// The TPU kernel walks the KV axis as the last, sequential grid dimension
// and carries (m, l, acc) in VMEM scratch from one step to the next.
// Blocks on the card run in no order, so the KV walk becomes a loop inside
// the block, and the tiles past the last query row of the block are never
// loaded (the Pallas kernel's skip of fully masked KV blocks).  Two
// prefill designs; the wrapper (kernels/flash_attention.py,
// `prefill_route`) picks one from the dtype:
//
// Prefill, bf16 (mma.sync): the FlashAttention-2 structure on the tensor
// cores.  One block per (64 query rows, query head, batch), four warps of
// 16 rows.  Q's fragments are loaded once with ldmatrix and stay in
// registers; K and V tiles of 64 keys stream through a two-stage cp.async
// ring in shared memory (rows padded by 16 bytes, so ldmatrix is free of
// bank conflicts; head dims padded to a multiple of 16 with zeros by the
// copies' source size).  S = Q K^T and O += P V run on
// mma.m16n8k16 (bf16 in, fp32 accumulate); the online softmax keeps m, l
// and O in fp32 registers, its row max over each quad of lanes by two
// shuffles.  P is rounded to bf16 as P V's A operand — straight from S's
// accumulator registers — while l sums the fp32 P: the one departure from
// the Pallas kernel, which multiplies P V in fp32 (SDPA rounds P the same
// way).  Keys past Sk and the causal future are masked before the row max,
// only on the tiles that reach them.  A quad of lanes writes whole 32-byte
// sectors of the output (one shuffle between lane pairs).
//
// Prefill, fp32 (CUDA cores): G = DMAX/16 threads per query row, each
// owning 16 of the (zero-padded) head dims in registers, their partial dot
// products summed with G-lane shuffles; 32-key K and V tiles staged
// through shared memory; fp32 FMAs for both products.  It carries the
// serving path's fp32 exactness check.  A thread's dims are four-wide
// chunks strided by 4G floats, so the G threads of a row read one
// contiguous span of a tile row and the shared-memory loads are free of
// bank conflicts.
//
// Decode design.  Scalar prefetch of the lengths becomes a plain load of
// lengths[b] by the block.  One block per (query head, batch), sixteen
// warps; warp w takes the 32-key tiles w, w+16, ... below the length
// (tiles at or past it are never touched), one key per lane for the dot
// product, then the warp's online-softmax update and its P·V with each
// lane owning DMAX/32 output dims, its V loads batched so they are in
// flight together.  The warps' (m, l, acc) are combined in shared memory
// at the end.  A length of 0 gives zeros, as the Pallas kernel does.
//
// Every entry point takes device pointers and a stream, launches on that
// stream without synchronising, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

namespace {

constexpr float kMask = -0.7f * FLT_MAX;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch rounds
}

// Eight consecutive values from 16-byte-aligned device memory.
__device__ __forceinline__ void load8(const float* p, float* out) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
}
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* out) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

// Four consecutive floats from 16-byte-aligned device memory.
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}

// ---------------------------------------------------------------------------
// Prefill, fp32: the products on the CUDA cores
// ---------------------------------------------------------------------------

template <int DMAX>
struct Prefill {
  static constexpr int G = DMAX / 16;                  // threads per row
  static constexpr int BQ = 64;                        // query rows / block
  static constexpr int BK = 32;                        // keys per tile
  static constexpr int NT = BQ * G;                    // threads / block
  // two blocks per SM where the register file allows it (<= 128 each)
  static constexpr int MIN_BLOCKS = NT <= 256 ? 2 : 1;
};

template <typename T, int DMAX>
__global__ void __launch_bounds__(Prefill<DMAX>::NT, Prefill<DMAX>::MIN_BLOCKS)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int Hq, int Hkv,
               int Sq, int Sk, int d, float scale, int causal) {
  constexpr int G = Prefill<DMAX>::G, BQ = Prefill<DMAX>::BQ;
  constexpr int BK = Prefill<DMAX>::BK, NT = Prefill<DMAX>::NT;
  constexpr int C8 = DMAX / 8;  // 8-wide chunks of a tile row
  __shared__ __align__(16) float ks[BK][DMAX];
  __shared__ __align__(16) float vs[BK][DMAX];

  const int tid = threadIdx.x, row = tid / G, g = tid % G;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ, qi = q0 + row;
  const int hk = h / (Hq / Hkv);
  const T* qp = q + static_cast<size_t>(b * Hq + h) * Sq * d;
  const T* kp = k + static_cast<size_t>(b * Hkv + hk) * Sk * d;
  const T* vp = v + static_cast<size_t>(b * Hkv + hk) * Sk * d;

  // this thread's dims: 4g + 4G*t + e, t < 4, e < 4 (zero past d)
  float qr[16], acc[16];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int c = 4 * g + 4 * G * t;
    if (qi < Sq && c < d) {
      load4(qp + static_cast<size_t>(qi) * d + c, qr + 4 * t);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qr[4 * t + e] = 0.f;
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  float m = kMask, l = 0.f;

  // causal: keys past the block's last query row are masked for every row
  const int kend = causal ? min(Sk, q0 + BQ) : Sk;
  for (int k0 = 0; k0 < kend; k0 += BK) {
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < BK * C8; c += NT) {
      const int kr = c / C8, cc = (c % C8) * 8;
      float kt[8], vt[8];
      if (k0 + kr < Sk && cc < d) {
        load8(kp + static_cast<size_t>(k0 + kr) * d + cc, kt);
        load8(vp + static_cast<size_t>(k0 + kr) * d + cc, vt);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e) kt[e] = vt[e] = 0.f;
      }
      float4* kd = reinterpret_cast<float4*>(&ks[kr][cc]);
      float4* vd = reinterpret_cast<float4*>(&vs[kr][cc]);
      kd[0] = make_float4(kt[0], kt[1], kt[2], kt[3]);
      kd[1] = make_float4(kt[4], kt[5], kt[6], kt[7]);
      vd[0] = make_float4(vt[0], vt[1], vt[2], vt[3]);
      vd[1] = make_float4(vt[4], vt[5], vt[6], vt[7]);
    }
    __syncthreads();

    float s[BK];
    float mt = kMask;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      float part = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 kk =
            *reinterpret_cast<const float4*>(&ks[j][4 * g + 4 * G * t]);
        part = fmaf(qr[4 * t], kk.x, part);
        part = fmaf(qr[4 * t + 1], kk.y, part);
        part = fmaf(qr[4 * t + 2], kk.z, part);
        part = fmaf(qr[4 * t + 3], kk.w, part);
      }
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        part += __shfl_xor_sync(kFull, part, off);
      const int kj = k0 + j;
      const bool visible = kj < Sk && (!causal || kj <= qi);
      s[j] = visible ? part * scale : kMask;
      mt = fmaxf(mt, s[j]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[i] *= alpha;
#pragma unroll
    for (int j = 0; j < BK; ++j) {
      const float p = expf(s[j] - m_new);
      l += p;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[j][4 * g + 4 * G * t]);
        acc[4 * t] = fmaf(p, vv.x, acc[4 * t]);
        acc[4 * t + 1] = fmaf(p, vv.y, acc[4 * t + 1]);
        acc[4 * t + 2] = fmaf(p, vv.z, acc[4 * t + 2]);
        acc[4 * t + 3] = fmaf(p, vv.w, acc[4 * t + 3]);
      }
    }
    m = m_new;
  }

  if (qi < Sq) {
    const float lc = fmaxf(l, 1e-20f);
    T* op = o + (static_cast<size_t>(b * Hq + h) * Sq + qi) * d;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int c = 4 * g + 4 * G * t;
      if (c < d) {
#pragma unroll
        for (int e = 0; e < 4; ++e) op[c + e] = from_float<T>(acc[4 * t + e] / lc);
      }
    }
  }
}

template <typename T>
int launch_prefill(const void* q, const void* k, const void* v, void* o,
                   int B, int Hq, int Hkv, int Sq, int Sk, int d, float scale,
                   int causal, void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((Sq + 63) / 64, Hq, B);
  if (d <= 32) {
    prefill_kernel<T, 32><<<grid, Prefill<32>::NT, 0, st>>>(
        qt, kt, vt, ot, Hq, Hkv, Sq, Sk, d, scale, causal);
  } else if (d <= 64) {
    prefill_kernel<T, 64><<<grid, Prefill<64>::NT, 0, st>>>(
        qt, kt, vt, ot, Hq, Hkv, Sq, Sk, d, scale, causal);
  } else {
    prefill_kernel<T, 128><<<grid, Prefill<128>::NT, 0, st>>>(
        qt, kt, vt, ot, Hq, Hkv, Sq, Sk, d, scale, causal);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Prefill, bf16: the products on the tensor cores (mma.sync m16n8k16)
// ---------------------------------------------------------------------------

template <int D>  // head dim rounded up to 16 (zero-padded in shared memory)
struct MmaPrefill {
  static constexpr int BQ = 64;       // query rows per block: 16 per warp
  static constexpr int BKV = 64;      // keys per tile
  static constexpr int NT = 128;      // four warps
  static constexpr int LD = D + 8;    // padded row: ldmatrix without bank
                                      // conflicts (D/8 + 1 chunks, odd)
  static constexpr int TILE = 64 * LD;                 // elements
  static constexpr int SMEM = 5 * TILE * 2;            // Q, K[2], V[2]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `bytes` 0 zero-fills the chunk.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr,
                                              uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_16816(float (&c)[4],
                                          const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Store one row's part of two adjacent 8-column accumulator tiles, tile j
// at `col0` and tile j + 1 after it (lane t of each quad holds columns
// 2t, 2t + 1 of both): one shuffle between lane pairs gives each lane
// four consecutive columns, so the quad writes 32 contiguous bytes of the
// row (a whole sector), not two 16-byte halves.  All lanes call it; `in`
// masks the store only.
__device__ __forceinline__ void store_pair(__nv_bfloat16* row, int col0,
                                           int lane, float a0, float a1,
                                           float b0, float b1, bool in,
                                           int d) {
  const uint32_t lo = pack_bf16(a0, a1), hi = pack_bf16(b0, b1);
  const bool odd = lane & 1;
  const uint32_t got = __shfl_xor_sync(kFull, odd ? lo : hi, 1);
  const int t = lane % 4, col = col0 + 4 * (t / 2) + 8 * (t & 1);
  if (in && col < d)  // d % 8 == 0: four columns are in or out together
    *reinterpret_cast<uint2*>(row + col) =
        odd ? make_uint2(got, hi) : make_uint2(lo, got);
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4*g + t.  An fp32
// accumulator c of a 16 x 8 tile holds rows g (c0, c1) and g + 8 (c2, c3)
// at columns 2t, 2t + 1.  The A operand of a k16 step is the pair of
// accumulator tiles of its two 8-column halves, so P goes from S's
// accumulators into P.V's A operand without leaving the registers.
template <int D>
__global__ void __launch_bounds__(MmaPrefill<D>::NT)
prefill_mma_kernel(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v,
                   __nv_bfloat16* __restrict__ o, int Hq, int Hkv, int Sq,
                   int Sk, int d, float scale_log2, int causal) {
  using C = MmaPrefill<D>;
  constexpr int LD = C::LD, TILE = C::TILE;
  constexpr int KD = D / 16;   // k16 steps over the head dim (S = Q K^T)
  constexpr int ND = D / 8;    // n8 tiles over the head dim (O = P V)
  constexpr int CH = D / 8;    // 16-byte chunks of a tile row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + TILE;       // two stages
  __nv_bfloat16* vs = ks + 2 * TILE;   // two stages

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.y, b = blockIdx.z;
  // the longest causal rows first: blocks start in index order
  const int q0 = (gridDim.x - 1 - blockIdx.x) * C::BQ;
  const int hk = h / (Hq / Hkv);
  const __nv_bfloat16* qp = q + static_cast<size_t>(b * Hq + h) * Sq * d;
  const __nv_bfloat16* kp = k + static_cast<size_t>(b * Hkv + hk) * Sk * d;
  const __nv_bfloat16* vp = v + static_cast<size_t>(b * Hkv + hk) * Sk * d;

  // rows [r0, r0 + 64) of a (rows, d) matrix; zeros past `rows` and d
  auto load_tile = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                       int rows) {
    for (int c = tid; c < 64 * CH; c += C::NT) {
      const int r = c / CH, cc = (c % CH) * 8;
      const bool in = r0 + r < rows && cc < d;
      cp_async16(dst + r * LD + cc,
                 in ? src + static_cast<size_t>(r0 + r) * d + cc : src,
                 in ? 16 : 0);
    }
  };

  // causal: keys past the block's last query row are masked for every row
  const int kend = causal ? min(Sk, q0 + C::BQ) : Sk;
  const int ntiles = (kend + C::BKV - 1) / C::BKV;
  load_tile(qs, qp, q0, Sq);
  if (ntiles > 0) {
    load_tile(ks, kp, 0, Sk);
    load_tile(vs, vp, 0, Sk);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // this lane's two rows, g and g + 8 of the warp's 16
  const int row0 = q0 + 16 * warp + lane / 4, row1 = row0 + 8;
  uint32_t qf[KD][4];
  float oacc[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[j][e] = 0.f;
  float m0 = kMask, m1 = kMask, l0 = 0.f, l1 = 0.f;  // log2 domain

  for (int t = 0; t < ntiles; ++t) {
    const int cur = t & 1, k0 = t * C::BKV;
    if (t + 1 < ntiles) {  // the access stage runs one tile ahead
      load_tile(ks + (cur ^ 1) * TILE, kp, k0 + C::BKV, Sk);
      load_tile(vs + (cur ^ 1) * TILE, vp, k0 + C::BKV, Sk);
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    if (t == 0) {
      // Q's A fragments: matrices (rows 0-7 | 8-15) x (cols 0-7 | 8-15)
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(smem_addr(qs + (16 * warp + lane % 8 + 8 * (lane / 8 % 2)) *
                                   LD +
                          16 * kk + 8 * (lane / 16)),
                qf[kk]);
    }
    const __nv_bfloat16* kt = ks + cur * TILE;
    const __nv_bfloat16* vt = vs + cur * TILE;

    // S = Q K^T: K rows (keys) are the B operand's columns, d its k
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk)
#pragma unroll
      for (int j2 = 0; j2 < 4; ++j2) {
        uint32_t r[4];  // keys 16j2 + (0-7 | 8-15) x d (lo | hi)
        ldsm_x4(smem_addr(kt + (16 * j2 + lane % 8 + 8 * (lane / 16)) * LD +
                          16 * kk + 8 * (lane / 8 % 2)),
                r);
        mma_16816(s[2 * j2], qf[kk], r[0], r[1]);
        mma_16816(s[2 * j2 + 1], qf[kk], r[2], r[3]);
      }

    // scale into the log2 domain; mask keys past Sk and, on the tiles that
    // reach past the block's first row, the causal future — before the max
    const bool edge = k0 + C::BKV > Sk || (causal && k0 + C::BKV - 1 > q0);
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (edge) {
          const int key = k0 + 8 * j + 2 * (lane % 4) + (e & 1);
          const int row = e < 2 ? row0 : row1;
          if (key >= Sk || (causal && key > row)) x = kMask;
        }
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    // the row max over the quad of lanes that hold the row
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(kFull, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(kFull, mx1, 2));
    const float alpha0 = exp2f(m0 - mx0), alpha1 = exp2f(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    l0 *= alpha0;
    l1 *= alpha1;
#pragma unroll
    for (int j = 0; j < ND; ++j) {
      oacc[j][0] *= alpha0;
      oacc[j][1] *= alpha0;
      oacc[j][2] *= alpha1;
      oacc[j][3] *= alpha1;
    }
    // P in fp32 for l; rounded to bf16 as P.V's A operand
    uint32_t pa[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float p0 = exp2f(s[j][0] - m0), p1 = exp2f(s[j][1] - m0);
      const float p2 = exp2f(s[j][2] - m1), p3 = exp2f(s[j][3] - m1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[j][0] = pack_bf16(p0, p1);
      pa[j][1] = pack_bf16(p2, p3);
    }

    // O += P V: V rows (keys) are the B operand's k, read transposed
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t a[4] = {pa[2 * kk][0], pa[2 * kk][1], pa[2 * kk + 1][0],
                             pa[2 * kk + 1][1]};
#pragma unroll
      for (int j2 = 0; j2 < ND / 2; ++j2) {
        uint32_t r[4];  // keys 16kk + (0-7 | 8-15) x d 16j2 + (lo | hi)
        ldsm_x4_trans(smem_addr(vt + (16 * kk + lane % 8 +
                                      8 * (lane / 8 % 2)) * LD +
                                16 * j2 + 8 * (lane / 16)),
                      r);
        mma_16816(oacc[2 * j2], a, r[0], r[1]);
        mma_16816(oacc[2 * j2 + 1], a, r[2], r[3]);
      }
    }
    __syncthreads();  // this stage is consumed: tile t+2 may overwrite it
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // l over the quad, then the cast; rows past Sq are not stored
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float lc0 = fmaxf(l0, 1e-20f), lc1 = fmaxf(l1, 1e-20f);
  __nv_bfloat16* op = o + static_cast<size_t>(b * Hq + h) * Sq * d;
#pragma unroll
  for (int j = 0; j < ND; j += 2) {
    store_pair(op + static_cast<size_t>(row0) * d, 8 * j, lane,
               oacc[j][0] / lc0, oacc[j][1] / lc0, oacc[j + 1][0] / lc0,
               oacc[j + 1][1] / lc0, row0 < Sq, d);
    store_pair(op + static_cast<size_t>(row1) * d, 8 * j, lane,
               oacc[j][2] / lc1, oacc[j][3] / lc1, oacc[j + 1][2] / lc1,
               oacc[j + 1][3] / lc1, row1 < Sq, d);
  }
}

template <int D>
int launch_prefill_mma_d(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o, int B,
                         int Hq, int Hkv, int Sq, int Sk, int d,
                         float scale_log2, int causal, cudaStream_t st) {
  auto kernel = prefill_mma_kernel<D>;
  // the opt-in to more than 48 KB of shared memory, once per device
  static unsigned ready = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && !(ready >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MmaPrefill<D>::SMEM);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready |= 1u << dev;
  }
  const dim3 grid((Sq + 63) / 64, Hq, B);
  kernel<<<grid, MmaPrefill<D>::NT, MmaPrefill<D>::SMEM, st>>>(
      q, k, v, o, Hq, Hkv, Sq, Sk, d, scale_log2, causal);
  return static_cast<int>(cudaGetLastError());
}

int launch_prefill_mma(const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Sk, int d,
                       float scale, int causal, void* stream) {
  const auto* qt = static_cast<const __nv_bfloat16*>(q);
  const auto* kt = static_cast<const __nv_bfloat16*>(k);
  const auto* vt = static_cast<const __nv_bfloat16*>(v);
  auto* ot = static_cast<__nv_bfloat16*>(o);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float sl = scale * 1.4426950408889634f;  // exp(x) = exp2(x log2 e)
  switch ((d + 15) / 16) {
#define PREFILL_MMA_CASE(N)                                                \
  case N:                                                                  \
    return launch_prefill_mma_d<16 * N>(qt, kt, vt, ot, B, Hq, Hkv, Sq, Sk, \
                                        d, sl, causal, st);
    PREFILL_MMA_CASE(1)
    PREFILL_MMA_CASE(2)
    PREFILL_MMA_CASE(3)
    PREFILL_MMA_CASE(4)
    PREFILL_MMA_CASE(5)
    PREFILL_MMA_CASE(6)
    PREFILL_MMA_CASE(7)
    PREFILL_MMA_CASE(8)
#undef PREFILL_MMA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// Decode
// ---------------------------------------------------------------------------

constexpr int kDecodeWarps = 16;
constexpr int kVRows = 16;  // V rows a lane holds in registers at once

template <typename T, int DMAX>
__global__ void __launch_bounds__(kDecodeWarps * 32)
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, int Hq, int Hkv, int S, int d, float scale) {
  constexpr int NW = kDecodeWarps, DPL = DMAX / 32;  // output dims per lane
  __shared__ __align__(16) float qs[DMAX];
  __shared__ float wm[NW], wl[NW];
  __shared__ float wacc[NW][DMAX];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (Hq / Hkv);
  const int len = min(max(lengths[b], 0), S);
  const T* qp = q + static_cast<size_t>(b * Hq + h) * d;
  const T* kp = kc + static_cast<size_t>(b * Hkv + hk) * S * d;
  const T* vp = vc + static_cast<size_t>(b * Hkv + hk) * S * d;
  for (int i = tid; i < DMAX; i += NW * 32)
    qs[i] = i < d ? to_float(qp[i]) : 0.f;
  __syncthreads();

  float m = kMask, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  const int dim0 = lane * DPL;

  for (int t0 = warp * 32; t0 < len; t0 += NW * 32) {
    const int j = t0 + lane;
    float s = kMask;
    if (j < len) {
      const T* kr = kp + static_cast<size_t>(j) * d;
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DMAX; c += 8) {
        if (c < d) {
          float kt[8];
          load8(kr + c, kt);
#pragma unroll
          for (int e = 0; e < 8; ++e) dot = fmaf(qs[c + e], kt[e], dot);
        }
      }
      s = dot * scale;
    }
    float mt = s;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
    const float m_new = fmaxf(m, mt);  // real: key t0 < len is in the tile
    const float p = expf(s - m_new);   // 0 for positions at or past len
    float ps = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ps += __shfl_xor_sync(kFull, ps, off);
    const float alpha = expf(m - m_new);
    l = l * alpha + ps;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
    // P·V in two halves of kVRows keys: each half's V loads are issued
    // together, ahead of its FMAs, so their latencies overlap
#pragma unroll
    for (int j0 = 0; j0 < 32; j0 += kVRows) {
      float vv[kVRows][DPL];
#pragma unroll
      for (int jj = 0; jj < kVRows; ++jj) {
        const bool ok = t0 + j0 + jj < len && dim0 < d;
        const T* vr = vp + static_cast<size_t>(t0 + j0 + jj) * d + dim0;
#pragma unroll
        for (int i = 0; i < DPL; ++i) vv[jj][i] = ok ? to_float(vr[i]) : 0.f;
      }
#pragma unroll
      for (int jj = 0; jj < kVRows; ++jj) {
        const float pj = __shfl_sync(kFull, p, j0 + jj);  // 0 past len
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[i] = fmaf(pj, vv[jj][i], acc[i]);
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    wm[warp] = m;
    wl[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) wacc[warp][dim0 + i] = acc[i];
  __syncthreads();
  if (tid < d) {
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm[w]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm[w] - mx);  // 0 for a warp that saw no key
      lsum += wl[w] * f;
      a += wacc[w][tid] * f;
    }
    o[static_cast<size_t>(b * Hq + h) * d + tid] =
        from_float<T>(a / fmaxf(lsum, 1e-20f));
  }
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* lengths, void* o, int B, int Hq, int Hkv, int S,
                  int d, float scale, void* stream) {
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lt = static_cast<const int*>(lengths);
  T* ot = static_cast<T*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(Hq, B);
  const int threads = kDecodeWarps * 32;
  if (d <= 32) {
    decode_kernel<T, 32><<<grid, threads, 0, st>>>(qt, kt, vt, lt, ot, Hq,
                                                   Hkv, S, d, scale);
  } else if (d <= 64) {
    decode_kernel<T, 64><<<grid, threads, 0, st>>>(qt, kt, vt, lt, ot, Hq,
                                                   Hkv, S, d, scale);
  } else {
    decode_kernel<T, 128><<<grid, threads, 0, st>>>(qt, kt, vt, lt, ot, Hq,
                                                    Hkv, S, d, scale);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shapes are validated by the Python wrappers (kernels/flash_attention.py):
// contiguous (B, H, S, d) tensors, 16-byte aligned, d a multiple of 8 in
// [8, 128], Hq a multiple of Hkv, lengths int32 in [0, S].

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int Hq,
                                    int Hkv, int Sq, int Sk, int d,
                                    float scale, int causal, void* stream) {
  return launch_prefill_mma(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, scale, causal,
                            stream);
}

extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int B, int Hq,
                                   int Hkv, int Sq, int Sk, int d,
                                   float scale, int causal, void* stream) {
  return launch_prefill<float>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d, scale,
                               causal, stream);
}

extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* o, int B, int Hq, int Hkv, int S,
                                     int d, float scale, void* stream) {
  return launch_decode<__nv_bfloat16>(q, k, v, lengths, o, B, Hq, Hkv, S, d,
                                      scale, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int B, int Hq, int Hkv, int S,
                                    int d, float scale, void* stream) {
  return launch_decode<float>(q, k, v, lengths, o, B, Hq, Hkv, S, d, scale,
                              stream);
}
