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
// prefix (~3.2 MB at batch 8), under a microsecond at the HBM rate.
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
// Decode design.  A one-token step is bound by the bytes of the valid
// cache prefix, and at serving sizes by the latency of reading them: few
// blocks, or reads repeated per query head, leave the card waiting.  One
// thread-block cluster of C <= 8 CTAs serves one (kv head, sequence) and
// the query heads of its group (the whole group up to 4, else 8 at a
// time: the head count is a template parameter, so the per-head loops
// unroll without branches), so each cache byte is read once per group
// and B*Hkv*C CTAs fill the card (C from the wrapper's `decode_split`).
// Scalar prefetch of the lengths becomes a load of lengths[b] by each
// CTA; rank r takes the contiguous keys [r*chunk, min((r+1)*chunk, len)),
// chunk = ceil(len / C) rounded up to 8 keys, and never touches a key at
// or past the length.  A producer warp streams the range's K and V tiles
// of up to 64 keys (contiguous in the (B, Hkv, S, d) caches) through a
// ring of 2-4 stages in shared memory by 1-D bulk copies (cp.async.bulk)
// on full/empty mbarriers, its first copies issued before anything else,
// so every load of a short range is in flight at once.  The arithmetic
// stays fp32 on the CUDA cores: each of eight compute warps takes 8 keys
// of every tile (four lanes a key for the scores, the K row read once for
// all heads), keeps its own online-softmax (m, l, acc) per head in
// registers, and needs no block barrier inside the key loop.  The warps
// are combined in shared memory; each rank pushes its (m, l, acc) into
// rank 0's shared memory (distributed shared memory) and arrives at a
// cluster barrier; rank 0 waits, combines the ranks and writes the
// output.  One launch, no workspace in device memory, no atomics; an
// empty range leaves (mask, 0, 0), and a length of 0 gives zeros, as the
// Pallas kernel does.
//
// Every entry point takes device pointers and a stream, launches on that
// stream without synchronising, and returns cudaGetLastError().

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cstdint>

#include "hopper.cuh"

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

// 16 bytes global -> shared; `bytes` 0 zero-fills the chunk.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(smem)),
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
        ldsm_x4(smem_u32(qs + (16 * warp + lane % 8 + 8 * (lane / 8 % 2)) *
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
        ldsm_x4(smem_u32(kt + (16 * j2 + lane % 8 + 8 * (lane / 16)) * LD +
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
        ldsm_x4_trans(smem_u32(vt + (16 * kk + lane % 8 +
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
// Decode: one thread-block cluster per (kv head, sequence), split over S
// ---------------------------------------------------------------------------

constexpr int kDecodeWarps = 8;  // compute warps; one more fills the ring
constexpr int kDecodeThreads = 32 * (kDecodeWarps + 1);
constexpr int kDecodeTile = 64;  // keys per ring stage
constexpr int kWarpKeys = kDecodeTile / kDecodeWarps;  // 8: four lanes a key
constexpr int kMaxCluster = 8;
constexpr int kKeyGranule = 8;   // a CTA's key range starts on 8 keys
constexpr int kDecodeRing = 64 * 1024;  // ring bytes aimed at
constexpr int kMaxStages = 4;

__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Shared memory of one decode CTA, in bytes from its base: the full and
// empty barriers, the K/V ring, fp32 q of the cluster's GM heads, each
// compute warp's probabilities and (m, l, acc), and — used in rank 0 —
// every rank's (m, l, acc).
struct DecodeSmem {
  int stages, stage, ring, q, p, wm, wl, wacc, cm, cl, cacc, bytes;
};

__host__ __device__ inline DecodeSmem decode_smem(int GM, int d, int esize) {
  constexpr int NW = kDecodeWarps, KW = kWarpKeys, CM = kMaxCluster;
  DecodeSmem L;
  L.stage = 2 * kDecodeTile * d * esize;  // K and V tiles
  L.stages = kDecodeRing / L.stage;
  L.stages = L.stages < 2 ? 2 : (L.stages > kMaxStages ? kMaxStages
                                                       : L.stages);
  L.ring = 128;  // after 2 * kMaxStages barriers
  L.q = L.ring + L.stages * L.stage;
  L.p = L.q + 4 * GM * d;
  L.wm = L.p + 4 * NW * KW * GM;
  L.wl = L.wm + 4 * NW * GM;
  L.wacc = L.wl + 4 * NW * GM;
  L.cm = L.wacc + 4 * NW * GM * d;
  L.cl = L.cm + 4 * CM * GM;
  L.cacc = L.cl + 4 * CM * GM;
  L.bytes = L.cacc + 4 * CM * GM * d;
  return L;
}

// grid (C, Hkv * ceil(G / GM), B), clusters of (C, 1, 1): the cluster of
// (kv head hk, head chunk, sequence b) carries GM query heads of hk's group
// (those past the group compute on zeros and are not written); its rank r
// takes the keys [r*chunk, min((r+1)*chunk, len)), chunk = ceil(len / C)
// rounded up to kKeyGranule.
template <typename T, int DMAX, int GM>
__global__ void __launch_bounds__(kDecodeThreads, 1)  // no spills at GM = 8
decode_kernel(const T* __restrict__ q, const T* __restrict__ kc,
              const T* __restrict__ vc, const int* __restrict__ lengths,
              T* __restrict__ o, int Hq, int Hkv, int S, int d, float scale) {
  constexpr int NW = kDecodeWarps, NT = kDecodeThreads, TK = kDecodeTile;
  constexpr int KW = kWarpKeys;
  constexpr int DQ = DMAX / 4;    // score pass: dims of a lane (4 a key)
  constexpr int DPL = DMAX / 32;  // P.V: output dims a lane owns
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(128) unsigned char smem[];

  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int G = Hq / Hkv, chunks = (G + GM - 1) / GM;
  const int hk = blockIdx.y / chunks, h0 = blockIdx.y % chunks * GM;
  const int Gc = min(GM, G - h0), b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const DecodeSmem L = decode_smem(GM, d, sizeof(T));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  float* q_s = reinterpret_cast<float*>(smem + L.q);
  float* p_s = reinterpret_cast<float*>(smem + L.p);
  float* wm_s = reinterpret_cast<float*>(smem + L.wm);
  float* wl_s = reinterpret_cast<float*>(smem + L.wl);
  float* wacc_s = reinterpret_cast<float*>(smem + L.wacc);
  float* cm_s = reinterpret_cast<float*>(smem + L.cm);
  float* cl_s = reinterpret_cast<float*>(smem + L.cl);
  float* cacc_s = reinterpret_cast<float*>(smem + L.cacc);
  // paired with the wait before the push into rank 0: every CTA of the
  // cluster has started before any writes into another's shared memory
  cluster_arrive_relaxed();

  // this CTA's keys: the length stays on the device
  const int len = min(max(lengths[b], 0), S);
  const int chunk =
      ((len + C - 1) / C + kKeyGranule - 1) / kKeyGranule * kKeyGranule;
  const int k0 = min(rank * chunk, len), k1 = min(k0 + chunk, len);
  const int ntiles = (k1 - k0 + TK - 1) / TK;
  const size_t slab = static_cast<size_t>(b * Hkv + hk) * S * d;
  const uint32_t row_bytes = d * sizeof(T);
  // the access stage: tile t, keys [k0 + t*TK, ...) of both caches, by 1-D
  // bulk copies into stage t % stages
  const auto issue = [&](int t) {
    const int st = t % L.stages, first = k0 + t * TK;
    const uint32_t bytes = min(TK, k1 - first) * row_bytes;
    const uint32_t bar = smem_u32(&full[st]);
    const uint32_t dst = smem_u32(smem + L.ring + st * L.stage);
    mbar_arrive_expect_tx(bar, 2 * bytes);
    bulk_copy(dst, kc + slab + static_cast<size_t>(first) * d, bytes, bar);
    bulk_copy(dst + L.stage / 2, vc + slab + static_cast<size_t>(first) * d,
              bytes, bar);
  };

  if (warp == NW) {
    if (lane == 0) {  // the first loads go out before anything else
      for (int st = 0; st < L.stages; ++st) {
        mbar_init(smem_u32(&full[st]), 1);    // the producer
        mbar_init(smem_u32(&empty[st]), NW);  // lane 0 of each warp
      }
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int t = 0; t < min(ntiles, L.stages); ++t) issue(t);
    }
  } else {
    const T* qp = q + (static_cast<size_t>(b) * Hq + hk * G + h0) * d;
    for (int i = tid; i < GM * d; i += NW * 32)
      q_s[i] = i < Gc * d ? to_float(qp[i]) : 0.f;
  }
  __syncthreads();

  if (warp == NW) {
    if (lane == 0) {
      for (int t = L.stages; t < ntiles; ++t) {
        mbar_wait(smem_u32(&empty[t % L.stages]), ((t / L.stages) & 1) ^ 1);
        issue(t);
      }
    }
  } else {
    // -- execute stage: warp w takes keys [8w, 8w+8) of every tile, four
    // lanes a key in the score pass, and keeps its own (m, l, acc) for
    // every head in registers: no block barrier inside the key loop
    const int kk = lane / 4, dq = lane % 4 * DQ;
    float* pw = p_s + warp * KW * GM;  // the warp's probabilities [key][g]
    float m[GM], l[GM], acc[GM][DPL];
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      m[g] = kMask;
      l[g] = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[g][i] = 0.f;
    }
    for (int t = 0; t < ntiles; ++t) {
      const int st = t % L.stages, j0 = warp * KW;
      const int n = min(TK, k1 - k0 - t * TK);
      mbar_wait(smem_u32(&full[st]), (t / L.stages) & 1);
      if (j0 < n) {
        const T* kt =
            reinterpret_cast<const T*>(smem + L.ring + st * L.stage);
        const T* vt = kt + TK * d;
        const int j = j0 + kk;
        float dot[GM];
#pragma unroll
        for (int g = 0; g < GM; ++g) dot[g] = 0.f;
#pragma unroll
        for (int c = 0; c < DQ; c += 8) {
          if (dq + c < d) {
            float kv[8];
            load8(kt + j * d + dq + c, kv);  // rows past n are masked below
#pragma unroll
            for (int g = 0; g < GM; ++g) {
              float qv[8];
              load8(q_s + g * d + dq + c, qv);
#pragma unroll
              for (int e = 0; e < 8; ++e) dot[g] = fmaf(qv[e], kv[e], dot[g]);
            }
          }
        }
#pragma unroll
        for (int g = 0; g < GM; ++g) {
          float s = dot[g];
          s += __shfl_xor_sync(kFull, s, 1);
          s += __shfl_xor_sync(kFull, s, 2);
          s = j < n ? s * scale : kMask;
          float mt = s;
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            mt = fmaxf(mt, __shfl_xor_sync(kFull, mt, off));
          const float m_new = fmaxf(m[g], mt);  // key j0 < n is real
          const float p = expf(s - m_new);      // 0 past n
          float ps = p;
#pragma unroll
          for (int off = 4; off < 32; off <<= 1)
            ps += __shfl_xor_sync(kFull, ps, off);
          const float alpha = expf(m[g] - m_new);
          l[g] = l[g] * alpha + ps;
          m[g] = m_new;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[g][i] *= alpha;
          if (lane % 4 == 0) pw[kk * GM + g] = p;
        }
        __syncwarp();
#pragma unroll
        for (int x = 0; x < KW; ++x) {  // all eight rows' loads at once
          float v[DPL];  // rows past n: p is 0, and their bytes are unused
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int dim = lane * DPL + i;
            const float vx = to_float(vt[(j0 + x) * d + min(dim, d - 1)]);
            v[i] = j0 + x < n && dim < d ? vx : 0.f;
          }
#pragma unroll
          for (int g = 0; g < GM; ++g) {
            const float pk = pw[x * GM + g];
#pragma unroll
            for (int i = 0; i < DPL; ++i)
              acc[g][i] = fmaf(pk, v[i], acc[g][i]);
          }
        }
      }
      __syncwarp();  // the stage and pw are read: both may be rewritten
      if (lane == 0) mbar_arrive(smem_u32(&empty[st]));
    }
#pragma unroll
    for (int g = 0; g < GM; ++g) {
      if (lane == 0) {
        wm_s[warp * GM + g] = m[g];  // a warp that saw no key: mask, 0, 0
        wl_s[warp * GM + g] = l[g];
      }
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int dim = lane * DPL + i;
        if (dim < d) wacc_s[(warp * GM + g) * d + dim] = acc[g][i];
      }
    }
  }
  __syncthreads();

  // the CTA's (m, l, acc) — its warps' combined — pushed into rank 0's
  // shared memory (distributed shared memory); the barrier's release and
  // acquire make the pushes visible to rank 0, and only rank 0 reads
  cluster_wait();
  float* cm0 = cluster.map_shared_rank(cm_s, 0);
  float* cl0 = cluster.map_shared_rank(cl_s, 0);
  float* cacc0 = cluster.map_shared_rank(cacc_s, 0);
  for (int e = tid; e < Gc * d; e += NT) {
    const int g = e / d, i = e - g * d;
    float mx = kMask;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, wm_s[w * GM + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = expf(wm_s[w * GM + g] - mx);
      lsum += wl_s[w * GM + g] * f;
      a += wacc_s[(w * GM + g) * d + i] * f;
    }
    cacc0[rank * GM * d + e] = a;
    if (i == 0) {
      cm0[rank * GM + g] = mx;
      cl0[rank * GM + g] = lsum;
    }
  }
  cluster_arrive();
  if (rank != 0) return;  // nothing reads this CTA's shared memory
  cluster_wait();
  for (int e = tid; e < Gc * d; e += NT) {
    const int g = e / d;
    float mx = kMask;
    for (int r = 0; r < C; ++r) mx = fmaxf(mx, cm_s[r * GM + g]);
    float lsum = 0.f, a = 0.f;
    for (int r = 0; r < C; ++r) {
      const float f = expf(cm_s[r * GM + g] - mx);  // 0 for an empty range
      lsum += cl_s[r * GM + g] * f;
      a += cacc_s[r * GM * d + e] * f;
    }
    o[(static_cast<size_t>(b) * Hq + hk * G + h0) * d + e] =
        from_float<T>(a / fmaxf(lsum, 1e-20f));
  }
}

template <typename T, int DMAX, int GM>
int launch_decode_g(const T* q, const T* k, const T* v, const int* lengths,
                    T* o, int B, int Hq, int Hkv, int S, int d, float scale,
                    int C, cudaStream_t st) {
  auto kernel = decode_kernel<T, DMAX, GM>;
  const DecodeSmem L = decode_smem(GM, d, sizeof(T));
  // the opt-in to more than 48 KB of shared memory (as much as d = DMAX
  // takes), once per device
  static unsigned ready = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 32 && !(ready >> dev & 1u)) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        decode_smem(GM, DMAX, sizeof(T)).bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    ready |= 1u << dev;
  }
  const int chunks = (Hq / Hkv + GM - 1) / GM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, Hkv * chunks, B);
  cfg.blockDim = dim3(kDecodeThreads);
  cfg.dynamicSmemBytes = L.bytes;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e =
      cudaLaunchKernelEx(&cfg, kernel, q, k, v, lengths, o, Hq, Hkv, S, d,
                         scale);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// the group's heads per cluster: the whole group up to 4 (the serving
// path's 3 exactly), else clusters of 8
template <typename T, int DMAX>
int launch_decode_d(const T* q, const T* k, const T* v, const int* lengths,
                    T* o, int B, int Hq, int Hkv, int S, int d, float scale,
                    int C, cudaStream_t st) {
  switch (Hq / Hkv) {
#define DECODE_GROUP_CASE(N)                                                \
  case N:                                                                   \
    return launch_decode_g<T, DMAX, N>(q, k, v, lengths, o, B, Hq, Hkv, S, \
                                       d, scale, C, st);
    DECODE_GROUP_CASE(1)
    DECODE_GROUP_CASE(2)
    DECODE_GROUP_CASE(3)
    DECODE_GROUP_CASE(4)
#undef DECODE_GROUP_CASE
    default:
      return launch_decode_g<T, DMAX, 8>(q, k, v, lengths, o, B, Hq, Hkv, S,
                                         d, scale, C, st);
  }
}

template <typename T>
int launch_decode(const void* q, const void* k, const void* v,
                  const void* lengths, void* o, int B, int Hq, int Hkv, int S,
                  int d, float scale, int C, void* stream) {
  if (C < 1 || C > 8) return static_cast<int>(cudaErrorInvalidValue);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const int* lt = static_cast<const int*>(lengths);
  T* ot = static_cast<T*>(o);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 32)
    return launch_decode_d<T, 32>(qt, kt, vt, lt, ot, B, Hq, Hkv, S, d,
                                  scale, C, st);
  if (d <= 64)
    return launch_decode_d<T, 64>(qt, kt, vt, lt, ot, B, Hq, Hkv, S, d,
                                  scale, C, st);
  return launch_decode_d<T, 128>(qt, kt, vt, lt, ot, B, Hq, Hkv, S, d, scale,
                                 C, st);
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

// Decode in clusters of C in [1, 8] CTAs per (kv head, sequence), C chosen
// by the wrapper (`decode_split`).
extern "C" int decode_attention_bf16(const void* q, const void* k,
                                     const void* v, const void* lengths,
                                     void* o, int B, int Hq, int Hkv, int S,
                                     int d, float scale, int C,
                                     void* stream) {
  return launch_decode<__nv_bfloat16>(q, k, v, lengths, o, B, Hq, Hkv, S, d,
                                      scale, C, stream);
}

extern "C" int decode_attention_f32(const void* q, const void* k,
                                    const void* v, const void* lengths,
                                    void* o, int B, int Hq, int Hkv, int S,
                                    int d, float scale, int C, void* stream) {
  return launch_decode<float>(q, k, v, lengths, o, B, Hq, Hkv, S, d, scale,
                              C, stream);
}
