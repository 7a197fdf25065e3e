// Helpers of the flash-attention kernels: bf16 packing and the band geometry
// (flash_fwd.cu and flash_bwd.cu), the m16n8k16 tensor-core product and
// tile loads (flash_fwd.cu).  The geometry is ONE definition for forward and
// backward, as
// `_band_mask`, `_stream_k_range` and `_stream_q_range` are in
// tpu_parallel/ops/flash_attention.py (:113, :142, :166): a forward and a
// backward that disagreed on which (query, key) pairs are visible would give
// gradients of another function.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

constexpr int kPad = 8;  // bf16 padding per shared row: conflict-free fragment reads
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16_pair(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

__device__ __forceinline__ int ceil_div(int a, int b) { return -floor_div(-a, b); }

// Copy rows [row0, row0 + kRows) of a [rows, D] bf16 matrix into shared
// memory (row stride D + kPad), zero-filling rows at or past `rows`.  Each
// element is multiplied by `scale` and rounded to bf16 when `scale` != 1
// (the pre-scaled q of the JAX kernels: bf16 * bf16 rounded once).
template <int D, int kRows, int kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          int row0, int rows, float scale = 1.f) {
  constexpr int kChunksPerRow = D / 8;  // 16-byte chunks
  for (int c = threadIdx.x; c < kRows * kChunksPerRow; c += kThreads) {
    const int r = c / kChunksPerRow;
    const int col = (c % kChunksPerRow) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(row0 + r) * D + col);
      if (scale != 1.f) {
        uint32_t* w = reinterpret_cast<uint32_t*>(&val);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&w[j]);
          w[j] = pack_bf16x2(__bfloat162float(x.x) * scale, __bfloat162float(x.y) * scale);
        }
      }
    }
    *reinterpret_cast<uint4*>(dst + r * (D + kPad) + col) = val;
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
