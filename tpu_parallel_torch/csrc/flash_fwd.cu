// Flash-attention forward for Hopper (sm_90a): bf16 operands, fp32 online
// softmax, one kernel for every sequence length.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` and `_fwd_kernel_stream` in
// tpu_parallel/ops/flash_attention.py (:240 and :296).  On the TPU the two
// differ only in where K/V live (whole row resident in VMEM, or walked as a
// grid axis above 4096 keys); here every K/V tile streams through shared
// memory, so this one kernel covers both and `stream=` changes nothing.
//
// What it computes, per query row (the JAX contract):
//   q is pre-scaled by 1/sqrt(D) in bf16; s = q.k^T accumulated in fp32;
//   keys outside the causal / sliding-window band, past the ragged K/V edge,
//   or in another packed segment are masked; out = softmax(s).v with P rounded
//   to bf16 before the P.V product; lse = m + log(l).  A row with no visible
//   key gives out = 0 and lse = -1e30.  Whole K tiles outside the band are
//   skipped (the `_stream_k_range` geometry); partial tiles are masked.
//   GQA is index math: query head row bh reads K/V row
//   (bh / H) * Hkv + (bh % H) / (H / Hkv); K/V are never expanded.
//
// Design (a first, simple version): one block of 4 warps for each
// (b*h, 64-row q tile).  Each warp holds 16 query rows of Q in registers for
// the whole loop, as m16n8k16 A fragments.  64-row K and V tiles are copied
// into shared memory with 16-byte loads; Q.K^T and P.V run on `mma.sync`
// m16n8k16 bf16 with fp32 accumulators; the running max m and sum l of each
// row stay in registers (a row's 64 columns are spread over the 4 lanes of a
// quad, reduced with two shuffles).  The score accumulator's layout is the
// A-fragment layout of P, so P never leaves registers.  Causal q tiles are
// launched heaviest first.  No cp.async pipelining, TMA or wgmma yet.  The
// band geometry, masks and tile loads are flash_common.cuh's, shared with
// the backward kernels (flash_bwd.cu).
//
// Bound at the slice's main shape (GPT-2 125M: B=8, H=12, S=1024, D=64,
// causal), per launch on an H100 SXM:
//   operations: 2 * B*H * S^2 * D (QK^T and PV over the causal half)
//               = 12.9 GFLOP -> 13.0 us at 989 TFLOP/s (bf16 dense);
//   bytes:      q, k, v, out in bf16 (4 * 12.6 MB) + lse in fp32 (0.4 MB)
//               = 50.7 MB -> 15.1 us at 3.35 TB/s.
// So the launch is bound by bytes, at about 15 us.  The tiles are 64 keys
// wide, so each q tile re-reads its K/V band from L2: the design does nothing
// yet to keep that out of device memory beyond the 50 MB L2 itself.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int kBlockQ = 64;   // query rows per block (16 per warp)
constexpr int kBlockK = 64;   // keys per K/V tile
constexpr int kThreads = 128; // 4 warps

template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const int* __restrict__ seg_q,
                     const int* __restrict__ seg_k, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ lse, int H, int Hkv, int S, int Skv, int causal,
                     int window, int q_offset, float scale) {
  constexpr int kLd = D + kPad;
  constexpr int kSteps = D / 16;  // k-steps of Q.K^T
  constexpr int kOutTiles = D / 8;  // n-tiles of the output
  constexpr int kScoreTiles = kBlockK / 8;  // n-tiles of the scores
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

  const __nv_bfloat16* q_bh = q + static_cast<size_t>(bh) * S * D;
  const __nv_bfloat16* k_bh = k + static_cast<size_t>(bh_kv) * Skv * D;
  const __nv_bfloat16* v_bh = v + static_cast<size_t>(bh_kv) * Skv * D;

  // Q tile -> registers, through k_s, scaled in bf16 like the JAX kernel.
  load_tile<D, kBlockQ, kThreads>(k_s, q_bh, q0, S);
  __syncthreads();
  const float sc = __bfloat162float(__float2bfloat16(scale));
  const int r0 = warp * 16 + g;  // tile rows of this thread: r0 and r0 + 8
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + (i & 1) * 8;
      const int col = ks * 16 + tig * 2 + (i >> 1) * 8;
      const __nv_bfloat162 x = *reinterpret_cast<const __nv_bfloat162*>(&k_s[row * kLd + col]);
      qa[ks][i] = pack_bf16x2(__bfloat162float(x.x) * sc, __bfloat162float(x.y) * sc);
    }
  }

  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const int qpos[2] = {q_offset + qrow[0], q_offset + qrow[1]};
  int segq[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int h = 0; h < 2; ++h) segq[h] = qrow[h] < S ? seg_q[b * S + qrow[h]] : 0;
  }
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // per-lane partial sums; reduced over the quad at the end
  float o[kOutTiles][4];
#pragma unroll
  for (int nt = 0; nt < kOutTiles; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;

  // K-tile range of this q tile: _stream_k_range with 64x64 tiles.
  int first, last;
  k_tile_range(qt, kBlockQ, kBlockK, (Skv + kBlockK - 1) / kBlockK, causal, window, q_offset,
               first, last);

  for (int kt = first; kt <= last; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous tile (or with Q)
    load_tile<D, kBlockK, kThreads>(k_s, k_bh, k0, Skv);
    load_tile<D, kBlockK, kThreads>(v_s, v_bh, k0, Skv);
    if (has_seg && threadIdx.x < kBlockK) {
      segk_s[threadIdx.x] = k0 + threadIdx.x < Skv ? seg_k[b * Skv + k0 + threadIdx.x] : 0;
    }
    __syncthreads();

    float s[kScoreTiles][4];
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kSteps; ++ks) {
#pragma unroll
      for (int nt = 0; nt < kScoreTiles; ++nt) {
        const __nv_bfloat16* kp = &k_s[(nt * 8 + g) * kLd + ks * 16 + tig * 2];
        mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kp),
                 *reinterpret_cast<const uint32_t*>(kp + 8));
      }
    }

    // Mask unless the whole 64x64 tile is visible to every row.
    if (!tile_all_visible(q0, kBlockQ, k0, kBlockK, S, Skv, causal, window, q_offset, has_seg)) {
#pragma unroll
      for (int nt = 0; nt < kScoreTiles; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = i >> 1;
          const int kcol = k0 + nt * 8 + tig * 2 + (i & 1);
          bool vis = in_band(qpos[h], kcol, Skv, causal, window);
          if (has_seg) vis = vis && segk_s[kcol - k0] == segq[h];
          if (!vis) s[nt][i] = -INFINITY;
        }
      }
    }

    // Online softmax: new row max over the quad, rescale, exponentiate.
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
      mx[0] = fmaxf(mx[0], fmaxf(s[nt][0], s[nt][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
    }
    // m stays finite (it starts at -1e30), so masked scores give exp(-inf) = 0
    const float alpha[2] = {__expf(m[0] - mx[0]), __expf(m[1] - mx[1])};
    m[0] = mx[0];
    m[1] = mx[1];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < kScoreTiles; ++nt) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[nt][i] = __expf(s[nt][i] - m[i >> 1]);
        rs[i >> 1] += s[nt][i];
      }
    }
    l[0] = l[0] * alpha[0] + rs[0];
    l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P.V; the score accumulators are P's A fragments as they stand.
#pragma unroll
    for (int ks = 0; ks < kBlockK / 16; ++ks) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * ks][0], s[2 * ks][1]), pack_bf16x2(s[2 * ks][2], s[2 * ks][3]),
          pack_bf16x2(s[2 * ks + 1][0], s[2 * ks + 1][1]),
          pack_bf16x2(s[2 * ks + 1][2], s[2 * ks + 1][3])};
#pragma unroll
      for (int nt = 0; nt < kOutTiles; ++nt) {
        const __nv_bfloat16* vp = &v_s[(ks * 16 + tig * 2) * kLd + nt * 8 + g];
        mma_bf16(o[nt], pa, pack_bf16_pair(vp[0], vp[kLd]),
                 pack_bf16_pair(vp[8 * kLd], vp[9 * kLd]));
      }
    }
  }

  // Finalize: quad-reduce l, normalise, write out and lse.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (qrow[h] >= S) continue;
    const bool empty = l[h] <= 0.f;
    const float denom = empty ? 1.f : l[h];
    __nv_bfloat16* orow = out + (static_cast<size_t>(bh) * S + qrow[h]) * D;
#pragma unroll
    for (int nt = 0; nt < kOutTiles; ++nt) {
      const float x0 = empty ? 0.f : o[nt][2 * h] / denom;
      const float x1 = empty ? 0.f : o[nt][2 * h + 1] / denom;
      *reinterpret_cast<uint32_t*>(&orow[nt * 8 + tig * 2]) = pack_bf16x2(x0, x1);
    }
    if (tig == 0) {
      lse[static_cast<size_t>(bh) * S + qrow[h]] = empty ? kNegInf : m[h] + logf(l[h]);
    }
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* seg_q,
                   const void* seg_k, void* out, void* lse, int B, int H, int Hkv, int S,
                   int Skv, int causal, int window, int q_offset, float scale,
                   cudaStream_t stream) {
  const dim3 grid((S + kBlockQ - 1) / kBlockQ, B * H);
  flash_fwd_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg_q),
      static_cast<const int*>(seg_k), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(lse), H, Hkv, S, Skv, causal, window, q_offset, scale);
  return cudaGetLastError();
}

}  // namespace

// q [B*H, S, D], k/v [B*Hkv, Skv, D] bf16 contiguous; seg_q [B, S] and
// seg_k [B, Skv] int32, or both null; out [B*H, S, D] bf16; lse [B*H, S]
// fp32.  Launches on `stream` and returns cudaGetLastError() of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* seg_q,
                         const void* seg_k, void* out, void* lse, int B, int H, int Hkv,
                         int S, int Skv, int D, int causal, int window, int q_offset,
                         float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || Skv <= 0 || B * H > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64:
      return static_cast<int>(launch<64>(q, k, v, seg_q, seg_k, out, lse, B, H, Hkv, S, Skv,
                                         causal, window, q_offset, scale, st));
    case 128:
      return static_cast<int>(launch<128>(q, k, v, seg_q, seg_k, out, lse, B, H, Hkv, S, Skv,
                                          causal, window, q_offset, scale, st));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
