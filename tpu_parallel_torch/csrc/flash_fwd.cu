// Flash-attention forward for Hopper (sm_90a): bf16 operands, fp32 online
// softmax, on wgmma, with K/V tiles streamed through a cp.async ring; one
// kernel for every sequence length.
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
//   to bf16 before the P.V product (summed in fp32); lse = m + log(l).  A row
//   with no visible key gives out = 0 and lse = -1e30.  Whole K tiles outside
//   the band are skipped (the `_stream_k_range` geometry); partial tiles are
//   masked.  GQA is index math: query head h of batch b reads K/V head
//   h / (H / Hkv); K/V are never expanded.
//
// Operands are addressed by row: q, k, v and out take any strides of batch,
// head and sequence (head_dim has stride 1), so the model's [B, S, H, D]
// views of its fused qkv projection are read in place and out is written
// wherever the caller allocated it.
//
// Design.  A block owns 128 query rows of one (batch, head) and is two
// warpgroups (256 threads), 64 rows each, sharing every K/V tile:
//   - Q is copied once (cp.async) into shared memory in the 128-byte swizzled
//     layout of hopper.cuh and stays there.  Its 1/sqrt(D) pre-scaling: at
//     D = 64, bf16(1/8) is a power of two, so scaling commutes with rounding
//     and folds into the fp32 scores; at D = 128 each thread rescales, in
//     shared memory, the chunks it loaded.
//   - K/V tiles of 64 keys and their segment ids come through a two-stage
//     cp.async ring: tile j + 1 is in flight while tile j is computed, with
//     one barrier per tile.
//   - S = Q.K^T on wgmma m64n64k16 (A and B from shared memory, both
//     K-major); the online softmax runs in the base-2 domain on the
//     accumulators in registers (one ex2.approx per score; the row max and
//     sum over the four lanes of a quad); P = bf16(p) in the accumulator
//     layout is the register-A layout, so O += P.V runs on wgmma m64n64k16
//     with A from registers and V read MN-major from the same tile (two n64
//     products per k-step at D = 128, one per 64-column panel of V).
//   - Tiles wholly inside the band take a loop with no mask; band-edge,
//     ragged-edge and segmented tiles take the masked one.
//   - At D = 64 the registers are held to 128 a thread so that two blocks
//     share an SM: the two warpgroups of a block move in step (one barrier
//     per tile), so while one block's warpgroups run the softmax, the other
//     block's products can use the tensor cores.  On an H100 this was
//     faster than one block per SM with 128-key tiles; a three-stage ring,
//     P.V left running across the next barrier, and tree-shaped row
//     reductions each changed nothing measurable.  At D = 128 the output
//     accumulators double and a block has an SM to itself.
//   - Blocks walk chunks of about one wave of heads, heaviest causal q tiles
//     first within a chunk, so a chunk's K/V stays in L2.
// Not here yet: TMA, a producer warp, ping-pong between the warpgroups, and
// persistent blocks.
//
// Bound at GPT-2 125M's shapes (H=12, S=1024, D=64, causal; visible pairs
// P = B*H*S*(S+1)/2) on an H100 SXM (989 TFLOP/s bf16 dense, 3.35 TB/s):
//   (a) B = 8: operations 4*D*P = 12.9 GFLOP -> 13.0 us; bytes q, k, v, out
//       in bf16 + lse in fp32 = 50.7 MB -> 15.1 us.  Bound by bytes.
//   training pass B = 16: 25.8 GFLOP -> 26.1 us; 101.4 MB -> 30.3 us.
// The design's answer to the byte bound: each K/V tile read from L2 serves
// 128 query rows (twice PR 1's 64), Q is read once, out and lse are written
// once, and a chunk of heads keeps its K/V in the 50 MB L2.  What holds it
// above the bound on the card is the work per tile, not bytes: the ex2 of
// every score and the barrier and waits of each tile (PERF.md).

#include <algorithm>
#include <cmath>
#include <type_traits>

#include "flash_common.cuh"
#include "hopper.cuh"

namespace {

using namespace flash;
using namespace hopper;

constexpr int kStages = 2;     // K/V tiles in the ring
constexpr int kRowsQ = 128;    // query rows per block, 64 per warpgroup
constexpr int kThreads = 256;  // two warpgroups

// Dynamic shared memory, in bytes from a 1024-aligned base: Q, then the ring
// (stage s: K, V), then the segment ids of each stage's keys.
template <int D>
struct Layout {
  static constexpr int kKeys = 64;                    // keys per K/V tile
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;  // blocks per SM the registers must allow
  static constexpr int kQPanel = kRowsQ * 128;        // one [128, 64] bf16 panel of Q
  static constexpr int kKPanel = kKeys * 128;         // one [kKeys, 64] panel of K or V
  static constexpr int kTile = kKeys * D * 2;         // one K or V tile
  static constexpr int kQ = 0;
  static constexpr int kRing = kRowsQ * D * 2;
  static constexpr int kSegk = kRing + kStages * 2 * kTile;  // int [kStages][kKeys]
  static constexpr int kBytes = kSegk + kStages * kKeys * 4 + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "a block may use 227 KB of shared memory");
};

struct Params {
  const __nv_bfloat16 *q, *k, *v;
  const int *seg_q, *seg_k;
  __nv_bfloat16* out;
  float* lse;
  RowStrides sq, sk, sv, so;
  int H, Hkv, S, Skv, causal, window, q_offset;
  float scale;
  int fold, chunk;
};

template <int D>
__global__ void __launch_bounds__(kThreads, Layout<D>::kMinBlocks)
    flash_fwd_kernel(const Params p) {
  using L = Layout<D>;
  constexpr int kKeys = L::kKeys;
  constexpr int kPanels = D / 64;
  extern __shared__ uint8_t smem_raw[];
  // align by offsetting the shared array itself: the compiler keeps
  // addressing it as shared memory
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t base = smem_u32(smem);
  int* segk_s = reinterpret_cast<int*>(smem + L::kSegk);

  // block -> (batch * head, q tile): chunks of `chunk` heads, q tiles from
  // the last (the heaviest under a causal mask) within a chunk
  const int nqt = (p.S + kRowsQ - 1) / kRowsQ;
  const int heads = static_cast<int>(gridDim.x) / nqt;
  const int c0 = blockIdx.x / (p.chunk * nqt) * p.chunk;
  const int in_chunk = min(p.chunk, heads - c0);
  const int rem = blockIdx.x - c0 * nqt;
  const int qt = nqt - 1 - rem / in_chunk;
  const int bh = c0 + rem % in_chunk;

  const int b = bh / p.H;
  const int h = bh % p.H;
  const int hkv = h / (p.H / p.Hkv);
  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int g = (tid & 31) >> 2;
  const int t = tid & 3;
  const int r0 = (tid >> 5) * 16 + g;  // block rows of this thread: r0 and r0 + 8
  const int q0 = qt * kRowsQ;
  const int qrow[2] = {q0 + r0, q0 + r0 + 8};
  const bool has_seg = p.seg_q != nullptr;
  const float qscale = __bfloat162float(__float2bfloat16(p.scale));
  const float sl2 = (p.fold ? qscale : 1.f) * kLog2e;  // base-2 score = S * sl2

  int first, last;
  k_tile_range(qt, kRowsQ, kKeys, (p.Skv + kKeys - 1) / kKeys, p.causal, p.window, p.q_offset,
               first, last);
  const int n = max(0, last - first + 1);

  const __nv_bfloat16* k_bh = p.k + b * p.sk.b + hkv * p.sk.h;
  const __nv_bfloat16* v_bh = p.v + b * p.sv.b + hkv * p.sv.h;
  auto load_kv_tile = [&](int it, int stage) {
    const int k0 = (first + it) * kKeys;
    const uint32_t st = base + L::kRing + stage * 2 * L::kTile;
    load_tile_async<kKeys, D, kThreads>(st, k_bh, p.sk.s, k0, p.Skv);
    load_tile_async<kKeys, D, kThreads>(st + L::kTile, v_bh, p.sv.s, k0, p.Skv);
    if (has_seg && tid < kKeys) {
      const bool ok = k0 + tid < p.Skv;
      cp_async_4(smem_u32(&segk_s[stage * kKeys + tid]),
                 p.seg_k + static_cast<long long>(b) * p.Skv + (ok ? k0 + tid : 0), ok);
    }
  };

  // prologue: Q and the first kStages - 1 tiles, one commit group per tile
  if (n > 0) {
    load_tile_async<kRowsQ, D, kThreads>(base + L::kQ, p.q + b * p.sq.b + h * p.sq.h, p.sq.s, q0,
                                         p.S);
  }
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    if (i < n) load_kv_tile(i, i);
    cp_async_commit();
  }

  int segq[2] = {0, 0};
  if (has_seg) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      segq[i] = qrow[i] < p.S ? p.seg_q[static_cast<long long>(b) * p.S + qrow[i]] : 0;
    }
  }
  float m[2] = {kNegInf, kNegInf};  // running row max, base-2 units
  float l[2] = {0.f, 0.f};          // per-lane partial row sums; reduced over the quad at the end
  float o[kPanels][32];
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) {
#pragma unroll
    for (int i = 0; i < 32; ++i) o[pn][i] = 0.f;
  }
  const uint32_t q_wg = base + L::kQ + wg * 64 * 128;  // this warpgroup's 64 rows of Q

  for (int it = 0; it < n; ++it) {
    const int stage = it % kStages;
    const uint32_t k_st = base + L::kRing + stage * 2 * L::kTile;
    const uint32_t v_st = k_st + L::kTile;
    cp_async_wait<kStages - 2>();  // tile `it` (and, at it = 0, Q) landed
    wgmma_wait<0>();               // tile it - 1's P.V done reading its stage
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) fence_operands(o[pn]);
    if (it == 0 && !p.fold) rescale_tile<kRowsQ, D, kThreads>(smem + L::kQ, qscale);
    fence_proxy_async();
    __syncthreads();  // tile `it` visible to every warp; tile it - 1's reads all done
    // refill the stage tile it - 1 used; an empty group past the last tile
    // keeps the count of groups in flight uniform
    if (it + kStages - 1 < n) load_kv_tile(it + kStages - 1, (it + kStages - 1) % kStages);
    cp_async_commit();
    const int k0 = (first + it) * kKeys;

    // S = Q.K^T: this warpgroup's 64 rows x kKeys keys
    float s[kKeys / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      wgmma_ss<kKeys, 0, 0>(s, desc_k_major(q_wg + (ks >> 2) * L::kQPanel + (ks & 3) * 32),
                            desc_k_major(k_st + (ks >> 2) * L::kKPanel + (ks & 3) * 32), ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_operands(s);

    // online softmax over the tile, base 2: p = 2^(S * sl2 - m)
    auto softmax = [&](auto masked) {
      if constexpr (decltype(masked)::value) {
        const int* segk_t = segk_s + stage * kKeys;
#pragma unroll
        for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int kc = nt * 8 + 2 * t + (i & 1);
            const int hr = i >> 1;
            const bool vis = in_band(p.q_offset + qrow[hr], k0 + kc, p.Skv, p.causal, p.window) &
                             ((!has_seg) | (segk_t[kc] == segq[hr]));
            s[nt * 4 + i] = vis ? s[nt * 4 + i] : -INFINITY;
          }
        }
      }
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
        mx[0] = fmaxf(mx[0], fmaxf(s[nt * 4], s[nt * 4 + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[nt * 4 + 2], s[nt * 4 + 3]));
      }
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
        // m stays finite (it starts at -1e30), so masked scores give 2^-inf = 0
        const float mnew = fmaxf(m[i], mx[i] * sl2);
        alpha[i] = exp2_approx(m[i] - mnew);
        m[i] = mnew;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int nt = 0; nt < kKeys / 8; ++nt) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[nt * 4 + i] = exp2_approx(fmaf(s[nt * 4 + i], sl2, -m[i >> 1]));
          rs[i >> 1] += s[nt * 4 + i];
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rs[i];
#pragma unroll
      for (int pn = 0; pn < kPanels; ++pn) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          o[pn][nt * 4] *= alpha[0];
          o[pn][nt * 4 + 1] *= alpha[0];
          o[pn][nt * 4 + 2] *= alpha[1];
          o[pn][nt * 4 + 3] *= alpha[1];
        }
      }
    };
    if (tile_all_visible(q0 + wg * 64, 64, k0, kKeys, p.S, p.Skv, p.causal, p.window, p.q_offset,
                         has_seg)) {
      softmax(std::false_type{});
    } else {
      softmax(std::true_type{});
    }

    // O += P.V: P's bf16 A fragments for k-steps of 16 keys, V read MN-major
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) pa[kk][j] = pack_bf16x2(s[8 * kk + 2 * j], s[8 * kk + 2 * j + 1]);
    }
    wgmma_fence();
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
#pragma unroll
      for (int kk = 0; kk < kKeys / 16; ++kk) {
        wgmma_rs<1>(o[pn], pa[kk], desc_mn_major(v_st + pn * L::kKPanel + kk * 2048));
      }
    }
    wgmma_commit();
  }
  wgmma_wait<0>();
#pragma unroll
  for (int pn = 0; pn < kPanels; ++pn) fence_operands(o[pn]);

  // finalize: quad-reduce l, normalise, write out and lse
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  const size_t lse_row = static_cast<size_t>(bh) * p.S;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= p.S) continue;
    const bool empty = l[i] <= 0.f;
    const float inv = empty ? 0.f : 1.f / l[i];
    __nv_bfloat16* orow = p.out + b * p.so.b + h * p.so.h + qrow[i] * p.so.s;
#pragma unroll
    for (int pn = 0; pn < kPanels; ++pn) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<uint32_t*>(&orow[pn * 64 + nt * 8 + 2 * t]) =
            pack_bf16x2(o[pn][nt * 4 + 2 * i] * inv, o[pn][nt * 4 + 2 * i + 1] * inv);
      }
    }
    if (t == 0) p.lse[lse_row + qrow[i]] = empty ? kNegInf : m[i] * kLn2 + logf(l[i]);
  }
}

template <int D>
cudaError_t launch(Params p, int B, cudaStream_t stream) {
  using L = Layout<D>;
  int sms, per_sm;
  const cudaError_t err = launch_limits<flash_fwd_kernel<D>>(kThreads, L::kBytes, sms, per_sm);
  if (err != cudaSuccess) return err;
  const int heads = B * p.H;
  const int nqt = (p.S + kRowsQ - 1) / kRowsQ;
  // heads per chunk: about one wave of resident blocks
  p.chunk = std::min(heads, std::max(1, sms * std::max(per_sm, 1) / nqt));
  p.fold = scale_folds(p.scale) ? 1 : 0;
  flash_fwd_kernel<D><<<heads * nqt, kThreads, L::kBytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// q [B, H, S, D], k/v [B, Hkv, Skv, D], out [B, H, S, D] bf16, addressed
// through `strides`: (batch, head, seq) element strides of q, k, v and out
// in that order (12 values; head_dim has stride 1, rows 16-byte aligned).
// seg_q [B, S] and seg_k [B, Skv] int32 contiguous, or both null; lse
// [B, H, S] fp32 contiguous.  Launches on `stream` and returns
// cudaGetLastError() of the launch.
extern "C" int flash_fwd(const void* q, const void* k, const void* v, const void* seg_q,
                         const void* seg_k, void* out, void* lse, const long long* strides,
                         int B, int H, int Hkv, int S, int Skv, int D, int causal, int window,
                         int q_offset, float scale, void* stream) {
  if (B <= 0 || H <= 0 || Hkv <= 0 || H % Hkv != 0 || S <= 0 || Skv <= 0 ||
      static_cast<long long>(B) * H * ((S + kRowsQ - 1) / kRowsQ) > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto rows = [&](int i) {
    return RowStrides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  };
  const Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(seg_q),
                 static_cast<const int*>(seg_k), static_cast<__nv_bfloat16*>(out),
                 static_cast<float*>(lse), rows(0), rows(1), rows(2), rows(3),
                 H, Hkv, S, Skv, causal, window, q_offset, scale, 0, 1};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 64: return static_cast<int>(launch<64>(p, B, st));
    case 128: return static_cast<int>(launch<128>(p, B, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
