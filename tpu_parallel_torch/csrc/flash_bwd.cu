// Flash-attention backward for Hopper (sm_90a): two kernels, dq and dk/dv,
// bf16 operands with fp32 accumulators, one of each for every sequence length.
//
// Replaces the Pallas TPU kernels of tpu_parallel/ops/flash_attention.py:
//   flash_bwd_dq_kernel  <- `_bwd_dq_kernel` (:464) and `_bwd_dq_kernel_stream` (:512)
//   flash_bwd_dkv_kernel <- `_bwd_dkv_kernel` (:563) and `_bwd_dkv_kernel_stream` (:635)
// As with the forward, resident and streamed differ on the TPU only in where
// the operands live (VMEM residency vs a grid axis with scratch carried
// across grid steps); here every tile streams through shared memory and the
// sum stays in registers, so one kernel per gradient covers both forms.
//
// What they compute (the JAX contract), with delta = rowsum(out * do) - dlse
// computed by the caller:
//   q is pre-scaled by 1/sqrt(D) in bf16, s = q.k^T in fp32, masked as in the
//   forward; p = exp(s - lse), and p = 0 on masked pairs and on rows with
//   lse <= -1e30 / 2 (rows that see no key); dp = do.v^T in fp32;
//   ds = p * (dp - delta) rounded to bf16;
//   dq = scale * sum_k ds.k                  (bf16 out)
//   dv = sum_q bf16(p)^T . do,  dk = sum_q ds^T . q_scaled   (bf16 out; dk
//   carries the scale through the pre-scaled q).
// GQA is index math, as in the forward: dq reads the K/V head of its query
// head; dk/dv sums the whole query group of its K/V head inside one block
// (`_bwd_dkv_kernel` unrolls the group the same way), so there are no
// atomics and no expanded K/V.
//
// Design (a first, simple version, the forward's):
//   dq:  one block of 4 warps per (b*h, 64-row q tile).  Each warp keeps its
//        16 rows of scaled q and of do in registers as m16n8k16 A fragments;
//        64-key K and V tiles stream through shared memory over the key range
//        of `k_tile_range`.  S and dP accumulate in registers, dS is formed
//        in place and fed back as the A operand of dS.K (the accumulator
//        layout is the A-fragment layout), dq accumulates in fp32 registers.
//   dkv: one block of 4 warps per (b*h_kv, 64-key tile).  Each warp keeps its
//        16 keys of K and V in registers as A fragments and walks the query
//        group and the q tiles of `q_tile_range`; q (scaled on load) and do
//        tiles, with their lse and delta, stream through shared memory.  The
//        block computes S^T = K.q^T and dP^T = V.do^T, so P^T and dS^T come
//        out in A-fragment layout for dv += P^T.do and dk += dS^T.q.
//        The q tile is 64 rows at D=64 and 32 rows at D=128, which keeps the
//        four fp32 fragment sets (K, V, dk, dv) within the register file.
//   No cp.async pipelining, TMA or wgmma yet.
//
// Bound at the slice's main shape (GPT-2 125M training pass: B=16, H=12,
// S=1024, D=64, causal; visible pairs P = B*H*S*(S+1)/2), per launch on an
// H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   dq:  operations 6*D*P (S, dP, dS.K) = 38.7 GFLOP -> 39.1 us;
//        bytes q, k, v, do, dq in bf16 + lse, delta in fp32 = 127.4 MB -> 38.0 us.
//   dkv: operations 8*D*P (S, dP, P.do, dS.q) = 51.6 GFLOP -> 52.2 us;
//        bytes q, k, v, do, dk, dv + lse, delta = 152.6 MB -> 45.6 us.
// Both sit near the ridge, bound by operations by a few percent.  Each q tile
// re-reads its K/V band (dq) and each key tile its q/do band (dkv) from L2.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = 64;    // dq: query rows per block (16 per warp)
constexpr int kBlockK = 64;    // keys per K/V tile; dkv: keys per block (16 per warp)
constexpr int kThreads = 128;  // 4 warps

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        const int* __restrict__ seg_q, const int* __restrict__ seg_k,
                        __nv_bfloat16* __restrict__ dq, int H, int Hkv, int S, int Skv,
                        int causal, int window, int q_offset, float scale) {
  constexpr int kLd = D + kPad;
  constexpr int kSteps = D / 16;            // k-steps of the D contractions
  constexpr int kOutTiles = D / 8;          // n-tiles of dq
  constexpr int kScoreTiles = kBlockK / 8;  // n-tiles of S and dP
  __shared__ __align__(16) __nv_bfloat16 k_s[kBlockK * kLd];
  __shared__ __align__(16) __nv_bfloat16 v_s[kBlockK * kLd];
  __shared__ int segk_s[kBlockK];

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int bh_kv = b * Hkv + (bh % H) / (H / Hkv);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;   // row within the 8-row half of an m16 fragment
  const int tig = lane & 3;  // lane within the quad
  const int q0 = qt * kBlockQ;
  const bool has_seg = seg_q != nullptr;

  const size_t row_base = static_cast<size_t>(bh) * S;
  const __nv_bfloat16* k_bh = k + static_cast<size_t>(bh_kv) * Skv * D;
  const __nv_bfloat16* v_bh = v + static_cast<size_t>(bh_kv) * Skv * D;

  // scaled q and do -> A fragments, through k_s and v_s
  load_tile<D, kBlockQ, kThreads>(k_s, q + row_base * D, q0, S,
                                  __bfloat162float(__float2bfloat16(scale)));
  load_tile<D, kBlockQ, kThreads>(v_s, dout + row_base * D, q0, S);
  __syncthreads();
  const int r0 = warp * 16 + g;  // tile rows of this thread: r0 and r0 + 8
  uint32_t qa[kSteps][4], da[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int off = (r0 + (i & 1) * 8) * kLd + ks * 16 + tig * 2 + (i >> 1) * 8;
      qa[ks][i] = *reinterpret_cast<const uint32_t*>(&k_s[off]);
      da[ks][i] = *reinterpret_cast<const uint32_t*>(&v_s[off]);
    }
  }

  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const int qpos[2] = {q_offset + qrow[0], q_offset + qrow[1]};
  int segq[2] = {0, 0};
  float row_lse[2] = {kNegInf, kNegInf};
  float row_delta[2] = {0.f, 0.f};
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] < S) {
      row_lse[h] = lse[row_base + qrow[h]];
      row_delta[h] = delta[row_base + qrow[h]];
      if (has_seg) segq[h] = seg_q[b * S + qrow[h]];
    }
  }
  // rows that see no key (and rows past S) contribute nothing
  const bool live[2] = {row_lse[0] > kNegInf / 2, row_lse[1] > kNegInf / 2};
  float acc[kOutTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOutTiles; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  int first, last;
  k_tile_range(qt, kBlockQ, kBlockK, (Skv + kBlockK - 1) / kBlockK, causal, window, q_offset,
               first, last);

  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile (or with q, do)
    load_tile<D, kBlockK, kThreads>(k_s, k_bh, k0, Skv);
    load_tile<D, kBlockK, kThreads>(v_s, v_bh, k0, Skv);
    if (has_seg && threadIdx.x < kBlockK) {
      segk_s[threadIdx.x] = k0 + threadIdx.x < Skv ? seg_k[b * Skv + k0 + threadIdx.x] : 0;
    }
    __syncthreads();

    float s[kScoreTiles][4], dp[kScoreTiles][4];
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
    }
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kScoreTiles; ++nt) {
        const int off = (nt * 8 + g) * kLd + ks * 16 + tig * 2;
        mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(&k_s[off]),
                 *reinterpret_cast<const uint32_t*>(&k_s[off + 8]));
        mma_bf16(dp[nt], da[ks], *reinterpret_cast<const uint32_t*>(&v_s[off]),
                 *reinterpret_cast<const uint32_t*>(&v_s[off + 8]));
      }
    }

    // dS = P * (dP - delta), written over S
    const bool full =
        tile_all_visible(q0, kBlockQ, k0, kBlockK, S, Skv, causal, window, q_offset, has_seg);
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int h = i >> 1;
        const int kcol = k0 + nt * 8 + tig * 2 + (i & 1);
        bool vis = live[h];
        if (!full) {
          vis = vis && in_band(qpos[h], kcol, Skv, causal, window);
          if (has_seg) vis = vis && segk_s[kcol - k0] == segq[h];
        }
        const float p = vis ? __expf(s[nt][i] - row_lse[h]) : 0.f;
        s[nt][i] = p * (dp[nt][i] - row_delta[h]);
      }
    }

    // dq += dS.K: dS's accumulators are its A fragments; K rows are B's k axis
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * ks][0], s[2 * ks][1]), pack_bf16x2(s[2 * ks][2], s[2 * ks][3]),
          pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int nt = 0; nt < kOutTiles; ++nt) {
        const __nv_bfloat16* kp = &k_s[(ks * 16 + tig * 2) * kLd + nt * 8 + g];
        mma_bf16(acc[nt], pa, pack_bf16_pair(kp[0], kp[kLd]),
                 pack_bf16_pair(kp[8 * kLd], kp[9 * kLd]));
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= S) continue;
    __nv_bfloat16* row = dq + (row_base + qrow[h]) * D;
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(&row[nt * 8 + tig * 2]) =
          pack_bf16x2(acc[nt][2 * h] * scale, acc[nt][2 * h + 1] * scale);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, const int* __restrict__ seg_q,
                         const int* __restrict__ seg_k, __nv_bfloat16* __restrict__ dk,
                         __nv_bfloat16* __restrict__ dv, int H, int Hkv, int S, int Skv,
                         int causal, int window, int q_offset, float scale) {
  constexpr int kBQ = D == 64 ? 64 : 32;  // query rows per streamed q tile
  constexpr int kLd = D + kPad;
  constexpr int kSteps = D / 16;        // k-steps of the D contractions
  constexpr int kOutTiles = D / 8;      // n-tiles of dk, dv
  constexpr int kQTiles = kBQ / 8;      // n-tiles of S^T and dP^T
  __shared__ __align__(16) __nv_bfloat16 q_s[kBQ * kLd];
  __shared__ __align__(16) __nv_bfloat16 do_s[kBQ * kLd];
  __shared__ float lse_s[kBQ];
  __shared__ float delta_s[kBQ];
  __shared__ int segq_s[kBQ];

  const int kt = blockIdx.x;  // low key tiles see the most causal q tiles: first
  const int bkv = blockIdx.y;
  const int b = bkv / Hkv;
  const int group = H / Hkv;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int k0 = kt * kBlockK;
  const bool has_seg = seg_q != nullptr;
  const float qscale = __bfloat162float(__float2bfloat16(scale));

  // this warp's 16 keys of K and V -> A fragments, straight from memory
  const __nv_bfloat16* k_bkv = k + static_cast<size_t>(bkv) * Skv * D;
  const __nv_bfloat16* v_bkv = v + static_cast<size_t>(bkv) * Skv * D;
  const int r0 = warp * 16 + g;
  uint32_t ka[kSteps][4], va[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = k0 + r0 + (i & 1) * 8;
      const size_t off = static_cast<size_t>(row) * D + ks * 16 + tig * 2 + (i >> 1) * 8;
      ka[ks][i] = row < Skv ? *reinterpret_cast<const uint32_t*>(&k_bkv[off]) : 0u;
      va[ks][i] = row < Skv ? *reinterpret_cast<const uint32_t*>(&v_bkv[off]) : 0u;
    }
  }
  const int krow[2] = {k0 + r0, k0 + r0 + 8};
  int segk[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) segk[h] = krow[h] < Skv ? seg_k[b * Skv + krow[h]] : 0;
  }

  float dk_acc[kOutTiles][4], dv_acc[kOutTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOutTiles; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[nt][i] = dv_acc[nt][i] = 0.f;
  }

  int first, last;
  q_tile_range(kt, kBQ, kBlockK, (S + kBQ - 1) / kBQ, causal, window, q_offset, first, last);

  for (int gi = 0; gi < group; ++gi) {
    // query head gi of this K/V head's group: row (b, (bkv % Hkv) * group + gi)
    const size_t row_base = static_cast<size_t>(b * H + (bkv % Hkv) * group + gi) * S;
    for (int qt = first; qt <= last; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // every warp is done with the previous q tile
      load_tile<D, kBQ, kThreads>(q_s, q + row_base * D, q0, S, qscale);
      load_tile<D, kBQ, kThreads>(do_s, dout + row_base * D, q0, S);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        lse_s[threadIdx.x] = row < S ? lse[row_base + row] : kNegInf;
        delta_s[threadIdx.x] = row < S ? delta[row_base + row] : 0.f;
        if (has_seg) segq_s[threadIdx.x] = row < S ? seg_q[b * S + row] : 0;
      }
      __syncthreads();

      float st[kQTiles][4], dpt[kQTiles][4];
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) st[nt][i] = dpt[nt][i] = 0.f;
      }
#pragma unroll
      for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
        for (int nt = 0; nt < kQTiles; ++nt) {
          const int off = (nt * 8 + g) * kLd + ks * 16 + tig * 2;
          mma_bf16(st[nt], ka[ks], *reinterpret_cast<const uint32_t*>(&q_s[off]),
                   *reinterpret_cast<const uint32_t*>(&q_s[off + 8]));
          mma_bf16(dpt[nt], va[ks], *reinterpret_cast<const uint32_t*>(&do_s[off]),
                   *reinterpret_cast<const uint32_t*>(&do_s[off + 8]));
        }
      }

      // P^T over S^T and dS^T over dP^T; columns are query rows
      const bool full =
          tile_all_visible(q0, kBQ, k0, kBlockK, S, Skv, causal, window, q_offset, has_seg);
#pragma unroll
      for (int nt = 0; nt < kQTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int qc = nt * 8 + tig * 2 + (i & 1);
          const float row_lse = lse_s[qc];
          bool vis = row_lse > kNegInf / 2;
          if (!full) {
            vis = vis && q0 + qc < S && in_band(q_offset + q0 + qc, krow[h], Skv, causal, window);
            if (has_seg) vis = vis && segq_s[qc] == segk[h];
          }
          const float p = vis ? __expf(st[nt][i] - row_lse) : 0.f;
          st[nt][i] = p;
          dpt[nt][i] = p * (dpt[nt][i] - delta_s[qc]);
        }
      }

      // dv += P^T.do and dk += dS^T.q: the q tile's rows are B's k axis
#pragma unroll
      for (int ks = 0; ks < kBQ / 16; ++ks) {
        const uint32_t pa[4] = {
            pack_bf16x2(st[2 * ks][0], st[2 * ks][1]), pack_bf16x2(st[2 * ks][2], st[2 * ks][3]),
            pack_bf16x2(st[2 * ks + 1][0], st[2 * ks + 1][1]),
            pack_bf16x2(st[2 * ks + 1][2], st[2 * ks + 1][3])};
        const uint32_t sa[4] = {
            pack_bf16x2(dpt[2 * ks][0], dpt[2 * ks][1]),
            pack_bf16x2(dpt[2 * ks][2], dpt[2 * ks][3]),
            pack_bf16x2(dpt[2 * ks + 1][0], dpt[2 * ks + 1][1]),
            pack_bf16x2(dpt[2 * ks + 1][2], dpt[2 * ks + 1][3])};
#pragma unroll
        for (int nt = 0; nt < kOutTiles; ++nt) {
          const int off = (ks * 16 + tig * 2) * kLd + nt * 8 + g;
          mma_bf16(dv_acc[nt], pa, pack_bf16_pair(do_s[off], do_s[off + kLd]),
                   pack_bf16_pair(do_s[off + 8 * kLd], do_s[off + 9 * kLd]));
          mma_bf16(dk_acc[nt], sa, pack_bf16_pair(q_s[off], q_s[off + kLd]),
                   pack_bf16_pair(q_s[off + 8 * kLd], q_s[off + 9 * kLd]));
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (krow[h] >= Skv) continue;
    const size_t off = (static_cast<size_t>(bkv) * Skv + krow[h]) * D;
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) {
      *reinterpret_cast<uint32_t*>(&dk[off + nt * 8 + tig * 2]) =
          pack_bf16x2(dk_acc[nt][2 * h], dk_acc[nt][2 * h + 1]);
      *reinterpret_cast<uint32_t*>(&dv[off + nt * 8 + tig * 2]) =
          pack_bf16x2(dv_acc[nt][2 * h], dv_acc[nt][2 * h + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta, *seg_q, *seg_k;
  int B, H, Hkv, S, Skv, causal, window, q_offset;
  float scale;
  cudaStream_t stream;
};

template <int D>
cudaError_t launch_dq(const Args& a, void* dq) {
  const dim3 grid((a.S + kBlockQ - 1) / kBlockQ, a.B * a.H);
  flash_bwd_dq_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.seg_q), static_cast<const int*>(a.seg_k),
      static_cast<__nv_bfloat16*>(dq), a.H, a.Hkv, a.S, a.Skv, a.causal, a.window, a.q_offset,
      a.scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  const dim3 grid((a.Skv + kBlockK - 1) / kBlockK, a.B * a.Hkv);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, 0, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q), static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v), static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<const int*>(a.seg_q), static_cast<const int*>(a.seg_k),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), a.H, a.Hkv, a.S, a.Skv,
      a.causal, a.window, a.q_offset, a.scale);
  return cudaGetLastError();
}

bool bad_shape(const Args& a) {
  return a.B <= 0 || a.H <= 0 || a.Hkv <= 0 || a.H % a.Hkv != 0 || a.S <= 0 || a.Skv <= 0 ||
         a.B * a.H > 65535;
}

}  // namespace

// Common arguments of both entry points: q, do [B*H, S, D] and k, v
// [B*Hkv, Skv, D] bf16 contiguous; lse, delta [B*H, S] fp32; seg_q [B, S] and
// seg_k [B, Skv] int32, or both null.  Each launches on `stream` and returns
// cudaGetLastError() of the launch.

// dq [B*H, S, D] bf16.
extern "C" int flash_bwd_dq(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, const void* seg_q,
                            const void* seg_k, void* dq, int B, int H, int Hkv, int S, int Skv,
                            int D, int causal, int window, int q_offset, float scale,
                            void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg_q, seg_k, B, H, Hkv, S, Skv, causal, window,
               q_offset, scale, static_cast<cudaStream_t>(stream)};
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return static_cast<int>(launch_dq<64>(a, dq));
    case 128: return static_cast<int>(launch_dq<128>(a, dq));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// dk, dv [B*Hkv, Skv, D] bf16.
extern "C" int flash_bwd_dkv(const void* q, const void* k, const void* v, const void* dout,
                             const void* lse, const void* delta, const void* seg_q,
                             const void* seg_k, void* dk, void* dv, int B, int H, int Hkv, int S,
                             int Skv, int D, int causal, int window, int q_offset, float scale,
                             void* stream) {
  const Args a{q, k, v, dout, lse, delta, seg_q, seg_k, B, H, Hkv, S, Skv, causal, window,
               q_offset, scale, static_cast<cudaStream_t>(stream)};
  if (bad_shape(a)) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: return static_cast<int>(launch_dkv<64>(a, dk, dv));
    case 128: return static_cast<int>(launch_dkv<128>(a, dk, dv));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
