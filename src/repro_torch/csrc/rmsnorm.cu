// RMSNorm over the last axis, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `rmsnorm` (src/repro/kernels/rmsnorm.py:28,
// body `_rmsnorm_kernel`): y = x * rsqrt(mean(x^2) + eps) * w, computed in
// fp32 and written in x's type.  There a tile of `block_rows` rows sits in
// VMEM, so every element is read once and written once.  Here:
//
//  * D <= 1024: one warp per row, eight rows per 256-thread block.  Lane l
//    holds the row's values l, l+32, ... in registers (read once), sums
//    their squares in fp32, the warp folds the sum with shuffles, and each
//    lane writes its own values scaled (written once);
//  * D > 1024: one 256-thread block per row.  The sum of squares is folded
//    across the eight warps in shared memory, and the row is read a second
//    time for the scale, from L1/L2 rather than device memory at such row
//    sizes.
//
// x is f32 or bf16 and w is f32 or bf16, in any pairing; y has x's type.
// The arithmetic follows the reference: mean = sum / D, then
// (x * rsqrt(mean + eps)) * w, rounded once to y's type.
//
// What bounds it on the card: bytes.  It reads x and w once and writes y
// once, for three flops per element: at (4096, 576) bf16, 9.4 MB, 2.8 us at
// 3.35 TB/s.  The design keeps the row in registers so device memory sees
// one read and one write; it does not vectorise its loads (a later PR).
//
// Every entry point takes device pointers and a stream, launches on that
// stream without synchronising, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kWarpRowMax = 1024;  // rows up to this width: one warp each

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                    TX* __restrict__ y, int R, int D, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  if (row >= R) return;
  const TX* xr = x + static_cast<size_t>(row) * D;
  TX* yr = y + static_cast<size_t>(row) * D;
  float v[kWarpRowMax / 32];
  float ss = 0.f;
#pragma unroll
  for (int j = 0; j < kWarpRowMax / 32; ++j) {
    const int c = lane + 32 * j;
    v[j] = c < D ? to_float(xr[c]) : 0.f;
    ss = fmaf(v[j], v[j], ss);
  }
  const float inv = rsqrtf(warp_sum(ss) / static_cast<float>(D) + eps);
#pragma unroll
  for (int j = 0; j < kWarpRowMax / 32; ++j) {
    const int c = lane + 32 * j;
    if (c < D) yr[c] = from_float<TX>((v[j] * inv) * to_float(w[c]));
  }
}

template <typename TX, typename TW>
__global__ void __launch_bounds__(kThreads)
rmsnorm_block_kernel(const TX* __restrict__ x, const TW* __restrict__ w,
                     TX* __restrict__ y, int D, float eps) {
  __shared__ float part[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const TX* xr = x + static_cast<size_t>(blockIdx.x) * D;
  TX* yr = y + static_cast<size_t>(blockIdx.x) * D;
  float ss = 0.f;
  for (int c = threadIdx.x; c < D; c += kThreads) {
    const float f = to_float(xr[c]);
    ss = fmaf(f, f, ss);
  }
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(part[0] / static_cast<float>(D) + eps);
  for (int c = threadIdx.x; c < D; c += kThreads) {
    yr[c] = from_float<TX>((to_float(xr[c]) * inv) * to_float(w[c]));
  }
}

template <typename TX, typename TW>
int launch(const void* x, const void* w, void* y, int R, int D, float eps,
           void* stream) {
  if (R <= 0 || D <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const TX* xp = static_cast<const TX*>(x);
  const TW* wp = static_cast<const TW*>(w);
  TX* yp = static_cast<TX*>(y);
  if (D <= kWarpRowMax) {
    const int rows_per_block = kThreads / 32;
    rmsnorm_warp_kernel<TX, TW>
        <<<(R + rows_per_block - 1) / rows_per_block, kThreads, 0, s>>>(
            xp, wp, yp, R, D, eps);
  } else {
    rmsnorm_block_kernel<TX, TW><<<R, kThreads, 0, s>>>(xp, wp, yp, D, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (R, D) and y (R, D) of one type, w (D,); all contiguous.
#define RMSNORM_ENTRY(NAME, TX, TW)                                         \
  extern "C" int NAME(const void* x, const void* w, void* y, int R, int D, \
                      float eps, void* stream) {                            \
    return launch<TX, TW>(x, w, y, R, D, eps, stream);                      \
  }

RMSNORM_ENTRY(rmsnorm_f32_f32, float, float)
RMSNORM_ENTRY(rmsnorm_f32_bf16, float, __nv_bfloat16)
RMSNORM_ENTRY(rmsnorm_bf16_f32, __nv_bfloat16, float)
RMSNORM_ENTRY(rmsnorm_bf16_bf16, __nv_bfloat16, __nv_bfloat16)
