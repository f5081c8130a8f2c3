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
// prefix (~3.2 MB at batch 8), under a microsecond.  This first design is
// simple, not fast: its products run in fp32 on the CUDA cores, not on the
// tensor cores, so prefill is bound by instruction issue far above its
// bound, and decode by its launch and fixed latency.  The wgmma/TMA
// design is later work.
//
// Prefill design.  The TPU kernel walks the KV axis as the last,
// sequential grid dimension and carries (m, l, acc) in VMEM scratch from
// one step to the next.  Blocks on the card run in no order, so the KV
// walk becomes a loop inside the block: one block per (q-tile of 64 rows,
// query head, batch) walking 32-key tiles; G = DMAX/16 threads per query
// row, each owning 16 of the (zero-padded) head dims in registers, their
// partial dot products summed with G-lane shuffles.  K and V tiles are staged through shared
// memory as fp32 (the access stage), and the tiles past the last query
// row of the block are never loaded (the Pallas kernel's skip of fully
// masked KV blocks).  A thread's dims are four-wide chunks strided by 4G
// floats, so the G threads of a row read one contiguous span of a tile
// row and the shared-memory loads are free of bank conflicts.
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

// Four consecutive values from 8-byte-aligned device memory.
__device__ __forceinline__ void load4(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
  const float2 f0 = __bfloat1622float2(h[0]);
  const float2 f1 = __bfloat1622float2(h[1]);
  out[0] = f0.x; out[1] = f0.y; out[2] = f1.x; out[3] = f1.y;
}

// ---------------------------------------------------------------------------
// Prefill
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
  return launch_prefill<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Sk, d,
                                       scale, causal, stream);
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
