// Flash-attention backward for Hopper (sm_90a): ONE pass that computes dk,
// dv and dq together, on wgmma, with the query-side operands streamed
// through a two-stage cp.async ring.
//
// Replaces the Pallas TPU kernels of tpu_parallel/ops/flash_attention.py:
//   `_bwd_dq_kernel` (:464), `_bwd_dq_kernel_stream` (:512),
//   `_bwd_dkv_kernel` (:563), `_bwd_dkv_kernel_stream` (:635).
// The TPU runs dq and dk/dv as two kernels that each recompute S = q.k^T
// and dP = do.v^T (a core carries a sum across its sequential grid, not
// across cores).  Here blocks run in parallel and dq is summed across them
// with atomics, so S and dP are formed once per visible (q tile, key tile):
// 10 * D products per visible pair instead of 14 * D.
//
// What it computes (the JAX contract):
//   q is pre-scaled by 1/sqrt(D) in bf16, s = q.k^T in fp32, masked as in the
//   forward; p = exp(s - lse), and p = 0 on masked pairs and on rows with
//   lse <= -1e30 / 2 (rows that see no key); dp = do.v^T in fp32;
//   delta = rowsum(out * do) - dlse; ds = p * (dp - delta) rounded to bf16;
//   dq = scale * sum_k ds.k                  (bf16 out; exactly 0 on empty rows)
//   dv = sum_q bf16(p)^T . do,  dk = sum_q ds^T . q_scaled   (bf16 out).
// GQA is index math: a key block walks its K/V head's whole query group, so
// every dk/dv row has one writer (deterministic, no atomics) and K/V are
// never expanded.
// The bf16 operands (q, k, v, out, do, dq, dk, dv) are addressed by row,
// through their strides of batch, head and sequence, so the model's
// [B, S, H, D] views are read and written in place; lse, delta and the dq
// scratch are contiguous [B, H, S(, D)].
//
// Three launches on the caller's stream, from one entry point:
//   1. prep:   delta = rowsum(out * do) - dlse and dq_acc = 0, one read of
//              out and do (D/8 threads per row, 16-byte loads).
//   2. main:   one block of kWG warpgroups per (b * h_kv, block of 64 * kWG
//              keys); warpgroup w owns keys [64w, 64w + 64) of the block.  K
//              and V stay in shared memory; the q tiles (64 * kWG rows) of
//              `q_tile_range`, for every query head of the group, stream
//              through a two-stage ring (q, do, lse, delta, segment ids by
//              cp.async; tile i + 1 loads while tile i computes).  Per tile,
//              with each warpgroup's 64 keys as wgmma's M:
//                S^T  = K . q^T,  dP^T = V . do^T         (A, B from shared)
//                P^T, dS^T in the accumulator layout, which is the A-fragment
//                layout: dv += P^T . do, dk += dS^T . q   (A from registers,
//                q and do read MN-major from the same tiles)
//                dS^T -> shared once; warpgroup w: dQ rows [64w, 64w + 64) =
//                dS . K over all the block's keys         (A and B MN-major)
//              dQ's fp32 rows are added into dq_acc with 16-byte atomics
//              (red.global.add.v4.f32).  dk, dv accumulate in fp32 registers
//              and are written once, in bf16.
//   3. finish: dq = bf16(dq_acc * scale).
// Why 2 warpgroups (128 keys, 128-row q tiles) at D = 64: the q/do tiles a
// block reads and the dq atomics it sends both scale with (key blocks) x
// (query rows), so 128 keys per block halve them; on an H100 this was
// faster than one warpgroup at S = 1024 and more so at S = 8192.  At D = 128
// the two warpgroups' accumulators (S^T and dP^T over 128 queries, dk and dv
// over 128 columns) exceed the register file, so a block is one warpgroup.
// Block order: key blocks of a chunk of heads at a time, heaviest causal
// key blocks first within the chunk; a chunk holds about one wave of
// resident blocks, so the dq_acc rows being summed stay in L2.
// The probabilities are formed without branches per element (the
// exponential is taken everywhere and selected away), and tiles inside the
// band take a loop with no mask at all.
// q's pre-scaling: when bf16(1/sqrt(D)) is a power of two (D = 64), scaling
// commutes with rounding, so S and dk take the scale in fp32 and q is used as
// loaded; otherwise (D = 128) each thread rescales, in shared memory, the q
// chunks it loaded, before the tile is read.
//
// Bound at GPT-2 125M's training pass (B=16, H=12, S=1024, D=64, causal;
// visible pairs P = B*H*S*(S+1)/2 = 100.76M) on an H100 SXM (989 TFLOP/s
// bf16 dense, 3.35 TB/s): operations 10*D*P = 64.49 GFLOP -> 65.2 us; bytes
// q, k, v, out, do, dq, dk, dv in bf16 + lse in fp32 = 202.1 MB -> 60.3 us.
// Bound by operations.  The dq_acc round trip (zero, atomics in L2, read)
// adds 100 MB of memory traffic and 215 MB of L2 atomics that the bound does
// not count.

#include <algorithm>
#include <cmath>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kStages = 2;

// Block shape: kWG warpgroups, 64 * kWG keys, q tiles of 64 * kWG rows.
template <int D>
constexpr int kWarpgroups = D == 64 ? 2 : 1;

// Dynamic shared memory of the main kernel, in bytes from a 1024-aligned
// base: K, V, the q/do ring, dS^T, then lse, delta and segment ids per stage.
template <int D>
struct Layout {
  static constexpr int kWG = kWarpgroups<D>;
  static constexpr int kRows = 64 * kWG;       // keys per block = q rows per tile
  static constexpr int kThreads = 128 * kWG;
  static constexpr int kPanel = kRows * 128;   // one [kRows, 64] bf16 panel
  static constexpr int kTile = kRows * D * 2;  // one [kRows, D] bf16 tile
  static constexpr int kK = 0;
  static constexpr int kV = kTile;
  static constexpr int kRing = 2 * kTile;  // stage s: q at kRing + 2*s*kTile, do after it
  static constexpr int kDs = kRing + kStages * 2 * kTile;  // dS^T: kWG panels [keys, 64 q]
  static constexpr int kLse = kDs + kWG * kPanel;          // float [kStages][kRows]
  static constexpr int kDelta = kLse + kStages * kRows * 4;
  static constexpr int kSegq = kDelta + kStages * kRows * 4;  // int [kStages][kRows]
  static constexpr int kBytes = kSegq + kStages * kRows * 4 + 1024;  // + alignment slack
};

// Row strides of what the main kernel reads (q, k, v, do) and writes (dk, dv).
struct MainStrides {
  RowStrides q, k, v, dout, dk, dv;
};

template <int D>
__global__ void __launch_bounds__(Layout<D>::kThreads, 1)
    flash_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                     float* __restrict__ dq_acc, __nv_bfloat16* __restrict__ dk,
                     __nv_bfloat16* __restrict__ dv, const MainStrides rs, int H, int Hkv, int S,
                     int Skv, int causal, int window, int q_offset, float scale, int fold,
                     int chunk) {
  using L = Layout<D>;
  constexpr int kRows = L::kRows;
  constexpr int kN = kRows;           // S^T / dP^T columns (queries) per warpgroup
  constexpr int kSteps = kRows / 16;  // k-steps over queries (dv, dk) and keys (dQ)
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  // align by offsetting the shared array itself: the compiler keeps
  // addressing it as shared memory (LDS/STS, not generic loads)
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  float* lse_s = reinterpret_cast<float*>(smem + L::kLse);
  float* delta_s = reinterpret_cast<float*>(smem + L::kDelta);
  int* segq_s = reinterpret_cast<int*>(smem + L::kSegq);

  // block -> (K/V head, key block): chunks of `chunk` heads, key blocks in
  // order within a chunk (the low ones see the most causal q tiles)
  const int nkb = (Skv + kRows - 1) / kRows;
  const int heads = static_cast<int>(gridDim.x) / nkb;
  const int c0 = blockIdx.x / (chunk * nkb) * chunk;
  const int in_chunk = min(chunk, heads - c0);
  const int rem = blockIdx.x - c0 * nkb;
  const int kb = rem / in_chunk;
  const int bkv = c0 + rem % in_chunk;

  const int b = bkv / Hkv;
  const int group = H / Hkv;
  const int h0 = (bkv % Hkv) * group;  // first query head of this K/V head's group
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = (tid >> 5) * 16 + g;  // block rows of this thread: r0 and r0 + 8
  const int k0 = kb * kRows;
  const bool has_seg = seg_q != nullptr;
  const float qscale = __bfloat162float(__float2bfloat16(scale));
  const float sscale = fold ? qscale : 1.f;  // S = sscale * (K . q^T)
  const float sl2 = sscale * kLog2e;            // p = 2^(S^T * sl2 - lse * log2 e)
  const int hkv = bkv % Hkv;

  int first, last;
  q_tile_range(kb, kRows, kRows, (S + kRows - 1) / kRows, causal, window, q_offset, first, last);
  const int nq = max(0, last - first + 1);
  const int n = group * nq;  // (query head, q tile) pairs of this block

  if (n == 0) {  // no query sees these keys
    __nv_bfloat16* dk_bh = dk + b * rs.dk.b + hkv * rs.dk.h;
    __nv_bfloat16* dv_bh = dv + b * rs.dv.b + hkv * rs.dv.h;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = k0 + r0 + 8 * h;
      if (kr >= Skv) continue;
#pragma unroll
      for (int c = 0; c < D; c += 8) {
        *reinterpret_cast<uint32_t*>(&dk_bh[kr * rs.dk.s + c + 2 * t]) = 0u;
        *reinterpret_cast<uint32_t*>(&dv_bh[kr * rs.dv.s + c + 2 * t]) = 0u;
      }
    }
    return;
  }

  auto load_q_tile = [&](int it, int stage) {
    const int q0 = (first + it % nq) * kRows;
    const int hq = h0 + it / nq;
    const size_t row_base = static_cast<size_t>(b * H + hq) * S;
    const uint32_t q_st = base + L::kRing + stage * 2 * L::kTile;
    load_tile_async<kRows, D, L::kThreads>(q_st, q + b * rs.q.b + hq * rs.q.h, rs.q.s, q0, S);
    load_tile_async<kRows, D, L::kThreads>(q_st + L::kTile, dout + b * rs.dout.b + hq * rs.dout.h,
                                           rs.dout.s, q0, S);
    const int i = tid % kRows;
    const int row = q0 + i;
    const bool ok = row < S;
    if (tid < kRows) {
      cp_async_4(smem_u32(&lse_s[stage * kRows + i]), lse + row_base + (ok ? row : 0), ok);
      if (has_seg) {
        cp_async_4(smem_u32(&segq_s[stage * kRows + i]), seg_q + b * S + (ok ? row : 0), ok);
      }
    } else {
      cp_async_4(smem_u32(&delta_s[stage * kRows + i]), delta + row_base + (ok ? row : 0), ok);
    }
  };

  load_tile_async<kRows, D, L::kThreads>(base + L::kK, k + b * rs.k.b + hkv * rs.k.h, rs.k.s, k0,
                                         Skv);
  load_tile_async<kRows, D, L::kThreads>(base + L::kV, v + b * rs.v.b + hkv * rs.v.h, rs.v.s, k0,
                                         Skv);
  load_q_tile(0, 0);
  cp_async_commit();

  int segk[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kr = k0 + r0 + 8 * h;
      segk[h] = kr < Skv ? seg_k[b * Skv + kr] : 0;
    }
  }

  float dk_acc[kPanels][32], dv_acc[kPanels][32];
#pragma unroll
  for (int p = 0; p < kPanels; ++p) {
#pragma unroll
    for (int i = 0; i < 32; ++i) dk_acc[p][i] = dv_acc[p][i] = 0.f;
  }
  // this warpgroup's 64 rows of K and V (A operands of S^T and dP^T)
  const uint32_t k_wg = base + L::kK + wg * 64 * 128;
  const uint32_t v_wg = base + L::kV + wg * 64 * 128;

  for (int it = 0; it < n; ++it) {
    const int stage = it & 1;
    const uint32_t q_st = base + L::kRing + stage * 2 * L::kTile;
    const uint32_t do_st = q_st + L::kTile;
    cp_async_wait_all();  // tile `it` (and, at it = 0, K and V) landed
    if (!fold) rescale_tile<kRows, D, L::kThreads>(smem + L::kRing + stage * 2 * L::kTile, qscale);
    fence_proxy_async();
    __syncthreads();  // tile `it` visible to every warp; tile it - 1's reads all done
    if (it + 1 < n) {
      load_q_tile(it + 1, stage ^ 1);
      cp_async_commit();
    }

    const int q0 = (first + it % nq) * kRows;
    const size_t row_base = static_cast<size_t>(b * H + h0 + it / nq) * S;

    // S^T = K . q^T and dP^T = V . do^T: this warpgroup's 64 keys x kN queries
    float st[kN / 2], dpt[kN / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks >> 2) * L::kPanel + (ks & 3) * 32;
      wgmma_ss<kN, 0, 0>(st, desc_k_major(k_wg + off), desc_k_major(q_st + off), ks > 0);
    }
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks >> 2) * L::kPanel + (ks & 3) * 32;
      wgmma_ss<kN, 0, 0>(dpt, desc_k_major(v_wg + off), desc_k_major(do_st + off), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(st);
    fence_operands(dpt);

    // P^T over S^T and dS^T over dP^T; columns are query rows
    const float* lse_t = lse_s + stage * kRows;
    const float* delta_t = delta_s + stage * kRows;
    const int* segq_t = segq_s + stage * kRows;
    auto probabilities = [&](auto masked) {
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        const int qc0 = nt * 8 + 2 * t;
        const float2 lse2 = *reinterpret_cast<const float2*>(lse_t + qc0);
        const float2 delta2 = *reinterpret_cast<const float2*>(delta_t + qc0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qc = qc0 + (i & 1);
          const float l = (i & 1) ? lse2.y : lse2.x;
          bool vis = l > kNegInf / 2;
          if constexpr (decltype(masked)::value) {
            vis = vis & (q0 + qc < S) &
                  in_band(q_offset + q0 + qc, k0 + r0 + 8 * (i >> 1), Skv, causal, window) &
                  ((!has_seg) | (segq_t[qc] == segk[i >> 1]));
          }
          const float e = exp2_approx(st[nt * 4 + i] * sl2 - l * kLog2e);
          const float p = vis ? e : 0.f;
          st[nt * 4 + i] = p;
          dpt[nt * 4 + i] = p * (dpt[nt * 4 + i] - ((i & 1) ? delta2.y : delta2.x));
        }
      }
    };
    if (tile_all_visible(q0, kRows, k0 + wg * 64, 64, S, Skv, causal, window, q_offset,
                         has_seg)) {
      probabilities(std::false_type{});
    } else {
      probabilities(std::true_type{});
    }

    // bf16 A fragments of P^T and dS^T for k-steps of 16 queries; dS^T also
    // goes to shared memory (panel = 64 queries; row = key, 128 B, swizzled)
    uint32_t pa[kSteps][4], sa[kSteps][4];
    uint8_t* ds_s = smem + L::kDs;
#pragma unroll
    for (int kk = 0; kk < kSteps; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int e = 8 * kk + 2 * j;  // j: (row g, nt 2kk), (g + 8, 2kk), (g, 2kk + 1), (g + 8, 2kk + 1)
        pa[kk][j] = pack_bf16x2(st[e], st[e + 1]);
        sa[kk][j] = pack_bf16x2(dpt[e], dpt[e + 1]);
        const int kr = r0 + 8 * (j & 1);
        const int nt = 2 * kk + (j >> 1);
        *reinterpret_cast<uint32_t*>(ds_s + (nt >> 3) * L::kPanel + kr * 128 +
                                     (((nt & 7) ^ (kr & 7)) << 4) + 4 * t) = sa[kk][j];
      }
    }

    // dv += P^T . do, dk += dS^T . q: q and do read MN-major (rows are K)
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        wgmma_rs<1>(dv_acc[p], pa[kk], desc_mn_major(do_st + p * L::kPanel + kk * 2048));
      }
    }
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        wgmma_rs<1>(dk_acc[p], sa[kk], desc_mn_major(q_st + p * L::kPanel + kk * 2048));
      }
    }
    wgmma_commit();
    fence_proxy_async();
    __syncthreads();  // dS^T of every warpgroup complete in shared memory

    // dQ rows [64 wg, 64 wg + 64) of the tile = dS . K over the block's keys,
    // 64 columns of D per panel, added into dq_acc
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
      float dqa[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSteps; ++kk) {
        wgmma_ss<64, 1, 1>(dqa, desc_mn_major(base + L::kDs + wg * L::kPanel + kk * 2048),
                           desc_mn_major(base + L::kK + p * L::kPanel + kk * 2048), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(dqa);
      // 16-byte atomics: lanes t and t ^ 1 swap halves so that even t holds
      // row g, columns 2t .. 2t + 3 and odd t row g + 8, columns 2t - 2 .. 2t + 1
      const bool even = (t & 1) == 0;
      const int row = q0 + (r0 & 63) + wg * 64 + (even ? 0 : 8);
      float* dst = dq_acc + (row_base + row) * D + p * 64 + 2 * (t & ~1);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const float a0 = dqa[nt * 4], a1 = dqa[nt * 4 + 1];
        const float b0 = dqa[nt * 4 + 2], b1 = dqa[nt * 4 + 3];
        const float x0 = __shfl_xor_sync(0xffffffffu, even ? b0 : a0, 1);
        const float x1 = __shfl_xor_sync(0xffffffffu, even ? b1 : a1, 1);
        if (row < S) {
          atomicAdd(reinterpret_cast<float4*>(dst + nt * 8),
                    even ? make_float4(a0, a1, x0, x1) : make_float4(x0, x1, b0, b1));
        }
      }
    }
  }

#pragma unroll
  for (int p = 0; p < kPanels; ++p) {
    fence_operands(dk_acc[p]);
    fence_operands(dv_acc[p]);
  }
  const float dk_scale = fold ? qscale : 1.f;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kr = k0 + r0 + 8 * h;
    if (kr >= Skv) continue;
    __nv_bfloat16* dk_row = dk + b * rs.dk.b + hkv * rs.dk.h + kr * rs.dk.s;
    __nv_bfloat16* dv_row = dv + b * rs.dv.b + hkv * rs.dv.h + kr * rs.dv.s;
#pragma unroll
    for (int p = 0; p < kPanels; ++p) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int off = p * 64 + nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(&dk_row[off]) = pack_bf16x2(
            dk_acc[p][nt * 4 + 2 * h] * dk_scale, dk_acc[p][nt * 4 + 2 * h + 1] * dk_scale);
        *reinterpret_cast<uint32_t*>(&dv_row[off]) =
            pack_bf16x2(dv_acc[p][nt * 4 + 2 * h], dv_acc[p][nt * 4 + 2 * h + 1]);
      }
    }
  }
}

constexpr int kPrepThreads = 256;

// Element offset of row `row` = (b * H + h) * S + s of a strided [B, H, S, D]
// operand.
__device__ __forceinline__ long long row_offset(long row, int H, int S, const RowStrides& st) {
  const long bh = row / S;
  return (bh / H) * st.b + (bh % H) * st.h + (row % S) * st.s;
}

// delta = rowsum(out * do) - dlse and dq_acc = 0, D / 8 threads per row.
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_prep_kernel(const __nv_bfloat16* __restrict__ out,
                          const __nv_bfloat16* __restrict__ dout, const float* __restrict__ dlse,
                          float* __restrict__ delta, float* __restrict__ dq_acc, long rows, int H,
                          int S, const RowStrides so, const RowStrides sdo) {
  constexpr int kLanes = D / 8;
  const long idx = static_cast<long>(blockIdx.x) * kPrepThreads + threadIdx.x;
  const long row = idx / kLanes;
  const int lane = idx % kLanes;
  float sum = 0.f;
  if (row < rows) {
    const uint4 o = *reinterpret_cast<const uint4*>(out + row_offset(row, H, S, so) + lane * 8);
    const uint4 d = *reinterpret_cast<const uint4*>(dout + row_offset(row, H, S, sdo) + lane * 8);
    const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&o);
    const __nv_bfloat162* dp = reinterpret_cast<const __nv_bfloat162*>(&d);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      sum += __bfloat162float(op[j].x) * __bfloat162float(dp[j].x);
      sum += __bfloat162float(op[j].y) * __bfloat162float(dp[j].y);
    }
    float4* acc = reinterpret_cast<float4*>(dq_acc + row * D + lane * 8);
    acc[0] = make_float4(0.f, 0.f, 0.f, 0.f);
    acc[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
#pragma unroll
  for (int m = kLanes / 2; m > 0; m >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, m);
  if (row < rows && lane == 0) delta[row] = dlse != nullptr ? sum - dlse[row] : sum;
}

// dq = bf16(dq_acc * scale), 8 elements per thread.
template <int D>
__global__ void __launch_bounds__(kPrepThreads)
    flash_bwd_finish_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                            long n8, float scale, int H, int S, const RowStrides sdq) {
  constexpr int kLanes = D / 8;
  for (long i = static_cast<long>(blockIdx.x) * kPrepThreads + threadIdx.x; i < n8;
       i += static_cast<long>(gridDim.x) * kPrepThreads) {
    const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
    const float4 c = reinterpret_cast<const float4*>(acc)[2 * i + 1];
    *reinterpret_cast<uint4*>(dq + row_offset(i / kLanes, H, S, sdq) + (i % kLanes) * 8) =
        make_uint4(pack_bf16x2(a.x * scale, a.y * scale), pack_bf16x2(a.z * scale, a.w * scale),
                   pack_bf16x2(c.x * scale, c.y * scale), pack_bf16x2(c.z * scale, c.w * scale));
  }
}

struct Args {
  const void *q, *k, *v, *out, *dout, *lse, *dlse, *seg_q, *seg_k;
  void *delta, *dq_acc, *dq, *dk, *dv;
  RowStrides sq, sk, sv, so, sdo, sdq, sdk, sdv;
  int B, H, Hkv, S, Skv, causal, window, q_offset;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch(const Args& a) {
  using L = Layout<D>;
  const long rows = static_cast<long>(a.B) * a.H * a.S;
  const long prep_threads = rows * (D / 8);
  flash_bwd_prep_kernel<D><<<(prep_threads + kPrepThreads - 1) / kPrepThreads, kPrepThreads, 0,
                             a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.out), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.dlse), static_cast<float*>(a.delta),
      static_cast<float*>(a.dq_acc), rows, a.H, a.S, a.so, a.sdo);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  int sms, per_sm;
  err = launch_limits<flash_bwd_kernel<D>>(L::kThreads, L::kBytes, sms, per_sm);
  if (err != cudaSuccess) return err;
  const int heads = a.B * a.Hkv;
  const int nkb = (a.Skv + L::kRows - 1) / L::kRows;
  // heads per chunk: about one wave of resident blocks
  const int chunk = std::min(heads, std::max(1, sms * std::max(per_sm, 1) / nkb));
  // q's scale folds into fp32 when bf16(scale) is a power of two
  const int fold = scale_folds(a.scale) ? 1 : 0;
  flash_bwd_kernel<D><<<heads * nkb, L::kThreads, L::kBytes, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.seg_q), static_cast<const int*>(a.seg_k),
      static_cast<float*>(a.dq_acc), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), MainStrides{a.sq, a.sk, a.sv, a.sdo, a.sdk, a.sdv}, a.H,
      a.Hkv, a.S, a.Skv, a.causal, a.window, a.q_offset, a.scale, fold, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  const long n8 = rows * D / 8;
  const long blocks = std::min<long>((n8 + kPrepThreads - 1) / kPrepThreads, 132L * 16);
  flash_bwd_finish_kernel<D><<<blocks, kPrepThreads, 0, a.stream>>>(
      static_cast<const float*>(a.dq_acc), static_cast<__nv_bfloat16*>(a.dq), n8, a.scale, a.H,
      a.S, a.sdq);
  return cudaGetLastError();
}

}  // namespace

// q, out, do, dq [B, H, S, D] and k, v, dk, dv [B, Hkv, Skv, D] bf16,
// addressed through `strides`: (batch, head, seq) element strides of q, k,
// v, out, do, dq, dk and dv in that order (24 values; head_dim has stride 1,
// rows 16-byte aligned).  lse and dlse (or null) [B, H, S] fp32 contiguous;
// seg_q [B, S] and seg_k [B, Skv] int32 contiguous, or both null.  Scratch
// the caller allocates: delta [B, H, S] and dq_acc [B, H, S, D] fp32
// contiguous.  Launches prep, main and finish on `stream`; returns the first
// cudaGetLastError() that is not cudaSuccess.
extern "C" int flash_bwd(const void* q, const void* k, const void* v, const void* out,
                         const void* dout, const void* lse, const void* dlse, const void* seg_q,
                         const void* seg_k, void* delta, void* dq_acc, void* dq, void* dk,
                         void* dv, const long long* strides, int B, int H, int Hkv, int S,
                         int Skv, int D, int causal, int window, int q_offset, float scale,
                         void* stream) {
  auto rows = [&](int i) {
    return RowStrides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  const Args a{q, k, v, out, dout, lse, dlse, seg_q, seg_k, delta, dq_acc, dq, dk, dv,
               rows(0), rows(1), rows(2), rows(3), rows(4), rows(5), rows(6), rows(7),
               B, H, Hkv, S, Skv, causal, window, q_offset, scale,
               static_cast<cudaStream_t>(stream)};
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || Skv <= 0 ||
      static_cast<long>(B) * Hkv * ((Skv + 63) / 64) > 0x7fffffffL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  switch (D) {
    case 64: return static_cast<int>(launch<64>(a));
    case 128: return static_cast<int>(launch<128>(a));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
