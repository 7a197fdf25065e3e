// Helpers of the flash-attention kernels (flash_fwd.cu, flash_bwd.cu): bf16
// packing, the base-2 exponential, the row addressing of strided operands,
// swizzled tile loads, and the band geometry.  The geometry is ONE
// definition for forward and backward, as `_band_mask`, `_stream_k_range`
// and `_stream_q_range` are in tpu_parallel/ops/flash_attention.py (:113,
// :142, :166): a forward and a backward that disagreed on which (query, key)
// pairs are visible would give gradients of another function.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

#include "hopper.cuh"

namespace flash {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Element strides of batch, head and sequence of a [B, H, S, D] bf16 operand
// whose head_dim has stride 1 ([B, H, S, D] or [B, S, H, D] in memory, or a
// view of a fused projection); every row starts on a 16-byte boundary.
struct RowStrides {
  long long b, h, s;
};

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x, one MUFU.EX2 (flushes denormal results to 0, as __expf does).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Whether bf16(scale) is a power of two: q's pre-scaling by it then commutes
// with rounding, so a kernel may apply it to fp32 products instead of to q.
inline bool scale_folds(float scale) {
  int exponent;
  return std::frexp(__bfloat162float(__float2bfloat16(scale)), &exponent) == 0.5f;
}

// Allows kernel `kKernel` `bytes` of dynamic shared memory and reads the
// SM count and how many blocks of `threads` fit on an SM, once per device:
// these host calls take microseconds, which every launch would otherwise pay.
template <auto kKernel>
cudaError_t launch_limits(int threads, int bytes, int& sms, int& per_sm) {
  constexpr int kDevices = 64;
  static int cache[kDevices][2];  // (SMs, blocks per SM) by device; 0 = not read yet
  int device;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kDevices && cache[device][0] > 0) {
    sms = cache[device][0];
    per_sm = cache[device][1];
    return cudaSuccess;
  }
  if ((err = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  bytes)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) !=
          cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kKernel, threads, bytes)) !=
          cudaSuccess) {
    return err;
  }
  if (device < kDevices) {
    cache[device][1] = per_sm;
    cache[device][0] = sms;
  }
  return cudaSuccess;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

// Rows [row0, row0 + kRows) of a bf16 matrix with D contiguous columns and
// `row_stride` elements between rows -> swizzled [kRows, D] tile at shared
// address `dst` (hopper.cuh's layout), by cp.async, zero-filling rows at or
// past `rows`.  Thread i copies chunks i, i + kThreads, ...
template <int kRows, int D, int kThreads>
__device__ __forceinline__ void load_tile_async(uint32_t dst, const __nv_bfloat16* src,
                                                long long row_stride, int row0, int rows) {
  constexpr int kChunks = D / 8;
  static_assert(kRows * kChunks % kThreads == 0, "load_tile_async: chunks per thread");
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    const int r = c / kChunks;
    const int ch = c % kChunks;
    const bool ok = row0 + r < rows;
    hopper::cp_async_16(dst + hopper::sw128_offset<kRows>(r, ch),
                        src + (ok ? row0 + r : 0) * row_stride + ch * 8, ok);
  }
}

// The chunks this thread copied with load_tile_async (same kRows, D,
// kThreads), times bf16 `scale`, rounded to bf16 (the JAX kernels'
// pre-scaled q).
template <int kRows, int D, int kThreads>
__device__ __forceinline__ void rescale_tile(uint8_t* tile, float scale) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int i = 0; i < kRows * kChunks / kThreads; ++i) {
    const int c = threadIdx.x + i * kThreads;
    uint4* w =
        reinterpret_cast<uint4*>(tile + hopper::sw128_offset<kRows>(c / kChunks, c % kChunks));
    uint4 val = *w;
    uint32_t* x = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 y = *reinterpret_cast<const __nv_bfloat162*>(&x[j]);
      x[j] = pack_bf16x2(__bfloat162float(y.x) * scale, __bfloat162float(y.y) * scale);
    }
    *w = val;
  }
}

// Whether query position `qpos` (q_offset + row) may see key `kcol`: inside
// the K/V length, the causal band and the sliding window (one-sided when
// causal, |q - k| < window otherwise).  Segment ids are checked apart.
__device__ __forceinline__ bool in_band(int qpos, int kcol, int Skv, bool causal, int window) {
  bool vis = kcol < Skv;
  if (causal) vis = vis && qpos >= kcol;
  if (window) {
    vis = vis && qpos - kcol < window;
    if (!causal) vis = vis && kcol - qpos < window;
  }
  return vis;
}

// Whether every pair of query rows [q0, q0 + nq) and keys [k0, k0 + nk) is
// visible, so a tile needs no mask at all.
__device__ __forceinline__ bool tile_all_visible(int q0, int nq, int k0, int nk, int S, int Skv,
                                                 bool causal, int window, int q_offset,
                                                 bool has_seg) {
  const int qlo = q_offset + q0;
  return !has_seg && q0 + nq <= S && k0 + nk <= Skv && (!causal || qlo >= k0 + nk - 1) &&
         (!window || (qlo + nq - 1 - k0 < window && (causal || k0 + nk - 1 - qlo < window)));
}

// [first, last] key tiles that query tile `qt` needs (`_stream_k_range`).
// May be empty (first > last) for offset chunks whose window misses every
// key tile.
__device__ __forceinline__ void k_tile_range(int qt, int bq, int bk, int num_kt, bool causal,
                                             int window, int q_offset, int& first, int& last) {
  last = num_kt - 1;
  if (causal) {
    last = min(last, ((qt + 1) * bq - 1) / bk);
  } else if (window) {
    last = min(last, floor_div(q_offset + (qt + 1) * bq - 1 + window - 1, bk));
  }
  first = window ? max(0, q_offset + qt * bq - window + 1) / bk : 0;
}

// [first, last] query tiles that see key tile `kt` (`_stream_q_range`, the
// mirror of k_tile_range).  May be empty: a negative q_offset can push
// `first` past the last tile, a positive one `last` below 0.
__device__ __forceinline__ void q_tile_range(int kt, int bq, int bk, int num_qt, bool causal,
                                             int window, int q_offset, int& first, int& last) {
  if (causal) {
    first = kt * bk / bq;
  } else if (window) {
    first = max(0, kt * bk - window + 1 - q_offset) / bq;
  } else {
    first = 0;
  }
  last = num_qt - 1;
  if (window) last = min(last, ceil_div((kt + 1) * bk + window - q_offset - 1, bq) - 1);
}

}  // namespace flash
