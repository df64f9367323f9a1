// Flash attention backward in bf16 and f16 for NVIDIA Hopper (sm_90a),
// with the tensor memory accelerator (TMA) and warpgroup MMAs (wgmma).
//
// Replaces the TPU kernels in mxnet_tpu/ops/flash_attention.py on their
// native-rate path (16-bit operands, `_prec` None, f32 accumulation):
//   K7a _dkv_kernel   (flash_dkv_sm90_kernel: dK, dV and the per-head bias
//                      gradient of one 64-key tile)
//   K7b _dq_kernel    (flash_dq_sm90_kernel: dQ of one 64-query tile)
// They read the lse of the 16-bit forward (csrc/flash_fwd_lp_sm90.cu) and
// share its building blocks (csrc/sm90.cuh).
//
// What they compute (q/k/v/dout [B*H, T, D] row-major in T, one of
// __nv_bfloat16 or __half; bias (B, Tk), lse and delta (B*H, Tq), dbias
// (B*H, Tk) f32):
//   s   = q k^T * scale + bias[b, key] in f32
//   p   = exp(s - lse[query]); 0 for a query past Tq and, under causal,
//         where query < key (absolute positions; key tiles wholly above
//         the diagonal are skipped)
//   dv  = T(p)^T dout, ds = p * (dout v^T - delta[query]),
//   dk  = scale * T(ds)^T q, dq = scale * T(ds) k (the TPU kernels'
//         `lp(pT)`, `lp(dsT)`, :274-276, :311-312), dbias = colsum(ds)
//         of the unrounded f32 ds; delta = rowsum(dout * out) comes from
//         the wrapper, as `_flash_backward` computes it outside the kernels
// Keys past Tk and queries past Tq take no part: the tensor maps are 3-D
// (D, T, B*H), so a tile past a head's T is zero-filled by the hardware,
// and those rows are masked through what the producer stages for them
// (below); nothing needs a padded copy.
//
// What bounds them on the card: operations. At BERT-base shapes (B=8,
// H=12, T=512, D=64) the dK/dV kernel does ~12.9 GFLOP (four products per
// (query, key) pair: S^T, dP^T, dV, dK) and the dQ kernel ~9.7 (S, dP,
// dQ), against ~32-38 MB of 16-bit q/k/v/dout: ~13 and ~10 us at the 989
// TFLOP/s dense bf16/f16 rate, ~10-11 us of bytes. The mma.sync design
// before this one (4 warps a CTA, each reading every streamed tile from
// shared memory through ldmatrix for every product, every thread issuing
// cp.async copies, two __syncthreads a tile, the masks and expf on every
// element) ran at about twice the time of one PyTorch SDPA backward.
//
// Design (the forward's, turned around for each kernel):
// - Two kernels, no atomics: dQ keeps its own kernel, as on the TPU, so
//   that every output element is written by one thread, once, and two
//   launches give the same bits. The price is 7 products per (query,
//   key) tile pair instead of the 5 a fused dQ with atomics would take.
// - A CTA is one or two consumer warpgroups (warp w of a warpgroup owns
//   rows 16w .. 16w + 15 of the CTA's 64) and one producer warp; the role
//   comes from a __shfl_sync, so ptxas sees it warp-uniform and no wgmma
//   sits under a divergent branch (with the role taken from threadIdx.x
//   ptxas serializes the wgmmas: C7520). One lane of the producer issues
//   every copy by TMA: the CTA's own two tiles once, then each streamed
//   tile pair into a ring of kStages stages, each guarded by a `full`
//   mbarrier (TMA transaction bytes) and an `empty` one (one arrival per
//   consumer warp once its products have read the stage). The producer's
//   lanes stage each tile's per-row f32 values with plain loads (lse and
//   delta are (B*H, Tq) rows, whose stride is a multiple of 16 bytes only
//   when Tq % 4 == 0, so no 2-D tensor map reads them).
// - K7a (dK/dV): the CTA owns 64 keys. K and V are loaded once; Q and dO
//   stream in tiles of kN queries. S^T = K Q^T and dP^T = V dO^T are
//   wgmma with both operands in shared memory (K-major, the copy's
//   swizzle); dV += T(P^T) dO and dK += T(dS^T) Q are wgmma with A from
//   registers and B (dO, Q) read MN-major (16-bit wgmma transposes B
//   itself). The accumulator fragments of two 8-column chunks of P^T are
//   exactly the A fragment of one 16-query step, so P^T and dS^T pass to
//   A by rounding pairs into 16-bit registers, where the TPU kernel rounds
//   them; the bias gradient sums the f32 dS^T before that rounding.
// - K7b (dQ): the CTA owns 64 queries, the latest query tiles first (the
//   longest causal walks). Q and dO are loaded once; K and V stream.
//   S = Q K^T and dP = dO V^T from shared memory, dQ += T(dS) K with dS
//   from registers and K read MN-major.
// - Overlap: each tile issues its two score products at once and works
//   on the first (the exponentials) while the second runs; in K7a the
//   dV product runs under dS^T's arithmetic, and the dK (K7b: dQ)
//   product under the next tile's wait and score products.
// - Exponentials in log2 units: log2(e) is folded into the scale, into
//   the bias (per key: K7a keeps its rows' in registers, K7b's producer
//   stages each key tile's) and into lse (natural-log units from the
//   forward, scaled once a row), so each probability is one FMA, one
//   subtraction and one ex2, in the reference's order: (s * scale + bias)
//   - lse. A masked bias (-1e30) and the lse of a row whose every key is
//   masked (-1e30 + log(l), which is -1e30 in f32) scale to the same
//   value, so such a row weighs its keys exactly as the twin does. A
//   query past Tq stages lse = +inf and a key past Tk (K7b) a bias of
//   -inf: their probabilities are 0 with no test. The causal mask runs
//   only on the tiles that the diagonal cuts (per warp).
// - Head dims (other D are zero-padded by the wrapper):
//     D = 16, 32, 64: one consumer warpgroup, kN = 64 (dK and dV are
//       D / 2 f32 registers a thread each, S^T and dP^T 32 each); two
//       dK/dV CTAs an SM, three dQ CTAs (dQ, S, dP: 128 registers).
//     D = 128: K7a streams 32-query tiles (dK, dV 64 registers each; S^T
//       and dP^T 16 each), K7b 64-key tiles (dQ 64); two CTAs an SM.
//     D = 256: dK and dV of 64 keys are 256 f32 registers a thread in
//       one warpgroup, which do not fit, so K7a runs two consumer
//       warpgroups that each own half of dK's and dV's columns (128
//       registers) and each compute the whole S^T and dP^T (the score
//       products run twice: 6 products per pair instead of 4) over
//       32-query tiles; K7b keeps one warpgroup (dQ 128 registers) over
//       32-key tiles. One CTA an SM.
//   The stream tile N is 64 (wgmma m64n64) where registers allow it, else
//   32 (m64n32); S^T and dP^T take N / 2 registers each. ptxas keeps K7a
//   at 146-168 registers, spills 16 bytes at D = 64 and 160 at D >= 128,
//   and notes (C7512) that it serializes wgmmas for register resources
//   in K7a at D >= 64 and K7b at D = 64 and 128: the launch bounds and
//   tile sizes above measured fastest on the card all the same (PERF.md
//   §6).
#include "sm90.cuh"

namespace {

constexpr int kM = 64;   // rows a CTA owns: keys (K7a) or queries (K7b)

// the column blocks of a tile row at head dim D, as the forward cuts them:
// kSw bytes a block row (the swizzle span), kCols elements
template <int D>
struct Cols {
  static constexpr int kSw = D >= 64 ? 128 : 2 * D;
  static constexpr int kCols = kSw / 2;
  static constexpr int kBlocks = D / kCols;
  static constexpr uint64_t kLayout = kSw == 128 ? 1 : kSw == 64 ? 2 : 3;
};

// K7a's tiles: the CTA's K and V (kM rows, "fixed"), then a ring of
// (Q tile, dO tile) of kN queries each, each stage's lse (log2 units)
// and delta, then the mbarriers (K/V, kStages full, kStages empty); 1024
// bytes to align the tiles to the swizzle atom
template <int D>
struct Dkv : Cols<D> {
  static constexpr int kN = D >= 128 ? 32 : 64;
  static constexpr int kWG = D == 256 ? 2 : 1;
  static constexpr int kThreads = 128 * kWG + 32;
  static constexpr int kStages = 3;
  static constexpr int kMinBlocks = D == 256 ? 1 : 2;
  static constexpr int kFixBytes = kM * D * 2;
  static constexpr int kTileBytes = kN * D * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmem = 1024 + 2 * kFixBytes + kStages * kStageBytes +
                               kStages * 2 * kN * 4 + 8 * (1 + 2 * kStages);
};

// K7b's tiles: the CTA's Q and dO, then a ring of (K tile, V tile) of kN
// keys each, each stage's bias (log2 units), then the mbarriers
template <int D>
struct Dq : Cols<D> {
  static constexpr int kN = D == 256 ? 32 : 64;
  static constexpr int kThreads = 128 + 32;
  static constexpr int kStages = D == 128 ? 2 : 3;
  static constexpr int kMinBlocks = D <= 64 ? 3 : D == 128 ? 2 : 1;
  static constexpr int kFixBytes = kM * D * 2;
  static constexpr int kTileBytes = kN * D * 2;
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kSmem = 1024 + 2 * kFixBytes + kStages * kStageBytes +
                               kStages * kN * 4 + 8 * (1 + 2 * kStages);
};

// acc (64 x N) = A B^T over the head dim, issued (not waited for): A the
// 64-row tile at sa, B the N-row tile at sb, both K-major as TMA copied
// them (kBlocks column blocks of rows x kSw bytes): D / 16 steps of 16
// head elements, step ks in column block ks / (kSw / 32), 32 bytes into
// it per step
template <typename T, int D, int N>
__device__ __forceinline__ void issue_ss(float (&acc)[N / 2], uint32_t sa,
                                         uint32_t sb) {
  using C = Cols<D>;
  constexpr int kSw = C::kSw;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / (kSw / 32);
    const uint32_t off = (ks % (kSw / 32)) * 32;
    wgmma_ss<T, N>(
        acc, smem_desc(sa + c * kM * kSw + off, 16, 8 * kSw, C::kLayout),
        smem_desc(sb + c * N * kSw + off, 16, 8 * kSw, C::kLayout), ks > 0);
  }
}

// acc[b] (64 x kCols: column block b0 + b of the output) += A B, issued:
// A (64 x N) the N / 16 steps' register fragments pa, B the N-row tile at
// sb read MN-major (its rows, kSw bytes apart, are the contracted index)
template <typename T, int D, int N, int NB>
__device__ __forceinline__ void issue_rs(
    float (&acc)[NB][Cols<D>::kCols / 2], const uint32_t (&pa)[N / 16][4],
    uint32_t sb, int b0) {
  using C = Cols<D>;
  constexpr int kSw = C::kSw;
#pragma unroll
  for (int kc = 0; kc < N / 16; ++kc)
#pragma unroll
    for (int b = 0; b < NB; ++b)
      wgmma_rs<T, C::kCols>(
          acc[b], pa[kc],
          smem_desc(sb + (b0 + b) * N * kSw + kc * 16 * kSw, N * kSw,
                    8 * kSw, C::kLayout));
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) r[i] = 0.f;
}

// ---------------------------------------------------------- backward dKV --
// grid (B*H, key tiles), Dkv<D>::kThreads threads: kWG consumer
// warpgroups (warpgroup wg owns column blocks wg * kNB .. of dK and dV),
// then the producer warp. A thread holds, of its warp's 16 keys, rows g
// and g + 8, and of each 8-query chunk j of a tile the queries 8j + 2t
// and 8j + 2t + 1.
//
// In the step of query tile i a warpgroup issues S^T_i and dP^T_i, waits
// for S^T_i (and the last tile's dK product), releases tile i - 1's
// stage, turns S^T_i into P^T_i while dP^T_i runs, issues dV += P^T_i dO,
// turns dP^T_i into dS^T_i (and the bias gradient) while that runs, waits
// for it (its A fragments are reused) and issues dK += dS^T_i Q.
template <typename T, int D>
__global__ void __launch_bounds__(Dkv<D>::kThreads, Dkv<D>::kMinBlocks)
flash_dkv_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const __grid_constant__ CUtensorMap tm_do,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const float* __restrict__ bias, T* __restrict__ dk,
                      T* __restrict__ dv, float* __restrict__ dbias, int H,
                      int Tq, int Tk, int causal, float scale) {
  using P = Dkv<D>;
  constexpr int kN = P::kN, kSw = P::kSw, kStages = P::kStages;
  constexpr int kWG = P::kWG, kCols = P::kCols;
  constexpr int kNB = P::kBlocks / kWG;   // column blocks a warpgroup
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem0 = smem_u32(smem_raw);
  const uint32_t s_k = (smem0 + 1023) & ~1023u;
  const uint32_t s_v = s_k + P::kFixBytes;
  const uint32_t s_ring = s_v + P::kFixBytes;  // stage i: Q, then dO
  const uint32_t s_rows = s_ring + kStages * P::kStageBytes;
  float* rows_smem = reinterpret_cast<float*>(smem_raw + (s_rows - smem0));
  const uint32_t bars = s_rows + kStages * 2 * kN * 4;
  const uint32_t kv_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto stage_q = [&](int st) { return s_ring + st * P::kStageBytes; };

  const int bh = blockIdx.x;
  const int k0 = blockIdx.y * kM;
  // causal: query tiles wholly before this key tile see none of it
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < Tq ? (Tq - q_begin + kN - 1) / kN : 0;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const size_t koff = static_cast<size_t>(bh) * Tk;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 32);        // the producer warp's lanes
      mbar_init(empty(st), 4 * kWG);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the role, warp-uniform as the compiler sees it: 0 .. kWG - 1 the
  // consumer warpgroups, kWG the producer warp
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  if (role == kWG) {
    // ---- producer warp: lane 0 issues every copy by TMA; the lanes
    // stage each query tile's lse (times log2(e); +inf past Tq, so those
    // queries weigh 0) and delta (0 past Tq)
    if (tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(kv_full, 2 * P::kFixBytes);
#pragma unroll
      for (int c = 0; c < P::kBlocks; ++c) {
        tma_load(s_k + c * kM * kSw, &tm_k, kv_full, c * kCols, k0, bh);
        tma_load(s_v + c * kM * kSw, &tm_v, kv_full, c * kCols, k0, bh);
      }
    }
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      const int q0 = q_begin + it * kN;
      mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
      float* rs = rows_smem + st * 2 * kN;
      for (int j = lane; j < kN; j += 32) {
        const int q = q0 + j;
        rs[j] = q < Tq ? lse[qoff + q] * kLog2e : INFINITY;
        rs[kN + j] = q < Tq ? delta[qoff + q] : 0.f;
      }
      if (lane == 0) {
        const uint32_t sq = stage_q(st), sd = sq + P::kTileBytes;
        mbar_expect_tx(full(st), P::kStageBytes);
#pragma unroll
        for (int c = 0; c < P::kBlocks; ++c) {
          tma_load(sq + c * kN * kSw, &tm_q, full(st), c * kCols, q0, bh);
          tma_load(sd + c * kN * kSw, &tm_do, full(st), c * kCols, q0, bh);
        }
      } else {
        mbar_arrive(full(st));
      }
    }
    return;
  }

  // ---- consumers
  const int wg = role;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2, t = lane & 3;
  const int key_w = k0 + 16 * warp;   // the warp's first key
  int key[2];
  float bk[2];   // the bias of this thread's keys, times log2(e)
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = key_w + g + 8 * r;
    bk[r] = bias != nullptr && key[r] < Tk
                ? bias[static_cast<size_t>(bh / H) * Tk + key[r]] * kLog2e
                : 0.f;
  }
  float s[kN / 2], dp[kN / 2];
  uint32_t pa[kN / 16][4];
  float dka[kNB][kCols / 2], dva[kNB][kCols / 2];
  zero(s);
  zero(dp);
#pragma unroll
  for (int b = 0; b < kNB; ++b) {
    zero(dka[b]);
    zero(dva[b]);
  }
  float dbs[2] = {0.f, 0.f};
  const float scale_log2 = scale * kLog2e;

  if (tiles > 0) {
    mbar_wait(kv_full, 0);
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      const int q0 = q_begin + it * kN;
      const uint32_t sq = stage_q(st), sd = sq + P::kTileBytes;
      mbar_wait(full(st), (it / kStages) & 1);
      reg_fence(s);
      reg_fence(dp);
      wg_fence();
      issue_ss<T, D, kN>(s, s_k, sq);
      wg_commit();
      issue_ss<T, D, kN>(dp, s_v, sd);
      wg_commit();
      wg_wait<1>();   // S^T has landed, and the last tile's dK product
      reg_fence(s);
#pragma unroll
      for (int b = 0; b < kNB; ++b) reg_fence(dka[b]);
#pragma unroll
      for (int kc = 0; kc < kN / 16; ++kc) reg_fence(pa[kc]);
      // every product of tile i - 1 has read its stage
      if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));

      // P^T = 2^((s * scale + bias) log2(e) - lse log2(e)); causal: 0
      // where query < key, tested only where the diagonal cuts the tile
      const float* rs = rows_smem + st * 2 * kN;
      const bool cut = causal && q0 < key_w + 15;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float2 l = *reinterpret_cast<const float2*>(rs + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float x = fmaf(s[i], scale_log2, bk[r]) - (e ? l.y : l.x);
            if (cut && q0 + 8 * j + 2 * t + e < key[r]) x = -INFINITY;
            s[i] = ex2(x);
          }
      }
      pack_p<T>(s, pa);
#pragma unroll
      for (int b = 0; b < kNB; ++b) reg_fence(dva[b]);
      wg_fence();
      issue_rs<T, D, kN, kNB>(dva, pa, sd, wg * kNB);   // dV += T(P^T) dO
      wg_commit();
      wg_wait<1>();   // dP^T has landed; the dV product may still run
      reg_fence(dp);

      // dS^T = P^T (dP^T - delta[query]); the bias gradient sums it over
      // the queries of each key row, unrounded
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float2 dl =
            *reinterpret_cast<const float2*>(rs + kN + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            dp[i] = s[i] * (dp[i] - (e ? dl.y : dl.x));
            dbs[r] += dp[i];
          }
      }
      wg_wait<0>();   // the dV product has read P^T's fragments
#pragma unroll
      for (int b = 0; b < kNB; ++b) reg_fence(dva[b]);
#pragma unroll
      for (int kc = 0; kc < kN / 16; ++kc) reg_fence(pa[kc]);
      pack_p<T>(dp, pa);
#pragma unroll
      for (int b = 0; b < kNB; ++b) reg_fence(dka[b]);
      wg_fence();
      issue_rs<T, D, kN, kNB>(dka, pa, sq, wg * kNB);   // dK += T(dS^T) Q
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int b = 0; b < kNB; ++b) {
      reg_fence(dka[b]);
      reg_fence(dva[b]);
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // over the quad that shares a key row
    dbs[r] += __shfl_xor_sync(0xffffffffu, dbs[r], 1);
    dbs[r] += __shfl_xor_sync(0xffffffffu, dbs[r], 2);
  }
  // dK = scale * (the sum), dV, rounded to T; each element by one thread
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Tk) continue;
    const size_t off = (koff + key[r]) * D + wg * kNB * kCols;
#pragma unroll
    for (int b = 0; b < kNB; ++b)
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j) {
        const size_t o = off + b * kCols + 8 * j + 2 * t;
        *reinterpret_cast<uint32_t*>(dk + o) =
            pack2<T>(scale * dka[b][4 * j + 2 * r],
                     scale * dka[b][4 * j + 2 * r + 1]);
        *reinterpret_cast<uint32_t*>(dv + o) =
            pack2<T>(dva[b][4 * j + 2 * r], dva[b][4 * j + 2 * r + 1]);
      }
    if (dbias != nullptr && t == 0 && wg == 0) dbias[koff + key[r]] = dbs[r];
  }
}

// ----------------------------------------------------------- backward dQ --
// grid (B*H, query tiles), Dq<D>::kThreads threads: one consumer
// warpgroup, then the producer warp. A thread holds, of its warp's 16
// queries, rows g and g + 8, and of each 8-key chunk j of a tile the keys
// 8j + 2t and 8j + 2t + 1.
//
// In the step of key tile i the warpgroup issues S_i and dP_i, waits for
// S_i (and the last tile's dQ product), releases tile i - 1's stage,
// turns S_i into P_i while dP_i runs, waits for dP_i, forms dS_i and
// issues dQ += dS_i K_i.
template <typename T, int D>
__global__ void __launch_bounds__(Dq<D>::kThreads, Dq<D>::kMinBlocks)
flash_dq_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ bias, T* __restrict__ dq,
                     int H, int Tq, int Tk, int causal, float scale) {
  using P = Dq<D>;
  constexpr int kN = P::kN, kSw = P::kSw, kStages = P::kStages;
  constexpr int kCols = P::kCols, kNB = P::kBlocks;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem0 = smem_u32(smem_raw);
  const uint32_t s_q = (smem0 + 1023) & ~1023u;
  const uint32_t s_do = s_q + P::kFixBytes;
  const uint32_t s_ring = s_do + P::kFixBytes;  // stage i: K, then V
  const uint32_t s_bias = s_ring + kStages * P::kStageBytes;
  float* bias_smem = reinterpret_cast<float*>(smem_raw + (s_bias - smem0));
  const uint32_t bars = s_bias + kStages * kN * 4;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto stage_k = [&](int st) { return s_ring + st * P::kStageBytes; };

  const int bh = blockIdx.x;
  // the latest query tiles (the longest causal walks) first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kM;
  // causal: key tiles at or past the last query row + 1 are fully masked
  const int k_end = causal ? min(Tk, q0 + kM) : Tk;
  const int tiles = (k_end + kN - 1) / kN;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const float* brow =
      bias == nullptr ? nullptr : bias + static_cast<size_t>(bh / H) * Tk;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < kStages; ++st) {
      mbar_init(full(st), 32);    // the producer warp's lanes
      mbar_init(empty(st), 4);    // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  if (role == 1) {
    // ---- producer warp: lane 0 issues every copy by TMA; the lanes
    // stage each key tile's bias, times log2(e) (0 without one; -inf
    // past Tk, so those keys weigh 0)
    if (tiles == 0) return;
    if (lane == 0) {
      mbar_expect_tx(q_full, 2 * P::kFixBytes);
#pragma unroll
      for (int c = 0; c < P::kBlocks; ++c) {
        tma_load(s_q + c * kM * kSw, &tm_q, q_full, c * kCols, q0, bh);
        tma_load(s_do + c * kM * kSw, &tm_do, q_full, c * kCols, q0, bh);
      }
    }
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      const int k0 = it * kN;
      mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
      float* sb = bias_smem + st * kN;
      for (int j = lane; j < kN; j += 32) {
        const int col = k0 + j;
        sb[j] = col >= Tk ? -INFINITY
                          : brow != nullptr ? brow[col] * kLog2e : 0.f;
      }
      if (lane == 0) {
        const uint32_t sk = stage_k(st), sv = sk + P::kTileBytes;
        mbar_expect_tx(full(st), P::kStageBytes);
#pragma unroll
        for (int c = 0; c < P::kBlocks; ++c) {
          tma_load(sk + c * kN * kSw, &tm_k, full(st), c * kCols, k0, bh);
          tma_load(sv + c * kN * kSw, &tm_v, full(st), c * kCols, k0, bh);
        }
      } else {
        mbar_arrive(full(st));
      }
    }
    return;
  }

  // ---- consumers
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = q0 + 16 * warp;   // the warp's first query row
  int row[2];
  float lr[2], dr[2];   // lse (times log2(e); +inf past Tq) and delta
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = row_w + g + 8 * r;
    lr[r] = row[r] < Tq ? lse[qoff + row[r]] * kLog2e : INFINITY;
    dr[r] = row[r] < Tq ? delta[qoff + row[r]] : 0.f;
  }
  float s[kN / 2], dp[kN / 2];
  uint32_t da[kN / 16][4];
  float dqa[kNB][kCols / 2];
  zero(s);
  zero(dp);
#pragma unroll
  for (int b = 0; b < kNB; ++b) zero(dqa[b]);
  const float scale_log2 = scale * kLog2e;

  if (tiles > 0) {
    mbar_wait(q_full, 0);
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      const int k0 = it * kN;
      const uint32_t sk = stage_k(st), sv = sk + P::kTileBytes;
      mbar_wait(full(st), (it / kStages) & 1);
      reg_fence(s);
      reg_fence(dp);
      wg_fence();
      issue_ss<T, D, kN>(s, s_q, sk);
      wg_commit();
      issue_ss<T, D, kN>(dp, s_do, sv);
      wg_commit();
      wg_wait<1>();   // S has landed, and the last tile's dQ product
      reg_fence(s);
#pragma unroll
      for (int b = 0; b < kNB; ++b) reg_fence(dqa[b]);
#pragma unroll
      for (int kc = 0; kc < kN / 16; ++kc) reg_fence(da[kc]);
      // every product of tile i - 1 has read its stage
      if (it > 0 && lane == 0) mbar_arrive(empty((it - 1) % kStages));

      // P = 2^((s * scale + bias) log2(e) - lse log2(e)); causal: 0 where
      // query < key, tested only where the diagonal cuts the tile
      const float* sb = bias_smem + st * kN;
      const bool cut = causal && k0 + kN - 1 > row_w;
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        const float2 bj = *reinterpret_cast<const float2*>(sb + 8 * j + 2 * t);
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int i = 4 * j + 2 * r + e;
            float x = fmaf(s[i], scale_log2, e ? bj.y : bj.x) - lr[r];
            if (cut && k0 + 8 * j + 2 * t + e > row[r]) x = -INFINITY;
            s[i] = ex2(x);
          }
      }
      wg_wait<0>();   // dP has landed
      reg_fence(dp);
      // dS = P (dP - delta[query])
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) dp[i] = s[i] * (dp[i] - dr[(i >> 1) & 1]);
      pack_p<T>(dp, da);
      wg_fence();
      issue_rs<T, D, kN, kNB>(dqa, da, sk, 0);   // dQ += T(dS) K
      wg_commit();
    }
    wg_wait<0>();
#pragma unroll
    for (int b = 0; b < kNB; ++b) reg_fence(dqa[b]);
  }

  // dQ = scale * (the sum) rounded to T; each element by one thread
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Tq) continue;
    T* orow = dq + (qoff + row[r]) * D;
#pragma unroll
    for (int b = 0; b < kNB; ++b)
#pragma unroll
      for (int j = 0; j < kCols / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + b * kCols + 8 * j + 2 * t) =
            pack2<T>(scale * dqa[b][4 * j + 2 * r],
                     scale * dqa[b][4 * j + 2 * r + 1]);
  }
}

// ----------------------------------------------------------------- host --
// sets the kernel's dynamic shared-memory limit (above the 48 KB default)
// once per process
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (rc == cudaSuccess) *done = true;
  return static_cast<int>(rc);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* bias, void* dk, void* dv, void* dbias, int BH,
               int H, int Tq, int Tk, int causal, float scale,
               cudaStream_t st) {
  using P = Dkv<D>;
  static bool ready = false;
  if (int rc = allow_smem(flash_dkv_sm90_kernel<T, D>, P::kSmem, &ready))
    return rc;
  const int key_tiles = (Tk + kM - 1) / kM;
  if (BH <= 0 || H <= 0 || Tq < 0 || Tk <= 0 || key_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q, k, v, dout, dk, dv))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mk, mv, mdo;
  int rc = tensor_map<T>(&mk, k, D, Tk, BH, P::kCols, kM, P::kSw);
  if (rc == 0) rc = tensor_map<T>(&mv, v, D, Tk, BH, P::kCols, kM, P::kSw);
  // with no query (Tq = 0) no query tile is loaded: q and dout keep k's map
  mq = mdo = mk;
  if (rc == 0 && Tq > 0)
    rc = tensor_map<T>(&mq, q, D, Tq, BH, P::kCols, P::kN, P::kSw);
  if (rc == 0 && Tq > 0)
    rc = tensor_map<T>(&mdo, dout, D, Tq, BH, P::kCols, P::kN, P::kSw);
  if (rc != 0) return rc;
  // b*h fastest: every CTA of key tile 0 (the longest causal walk) first
  const dim3 grid(BH, key_tiles);
  flash_dkv_sm90_kernel<T, D><<<grid, P::kThreads, P::kSmem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<T*>(dk), static_cast<T*>(dv), static_cast<float*>(dbias),
      H, Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta,
              const void* bias, void* dq, int BH, int H, int Tq, int Tk,
              int causal, float scale, cudaStream_t st) {
  using P = Dq<D>;
  static bool ready = false;
  if (int rc = allow_smem(flash_dq_sm90_kernel<T, D>, P::kSmem, &ready))
    return rc;
  const int query_tiles = (Tq + kM - 1) / kM;
  if (BH <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || query_tiles > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q, k, v, dout, dq))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mk, mv, mdo;
  int rc = tensor_map<T>(&mq, q, D, Tq, BH, P::kCols, kM, P::kSw);
  if (rc == 0)
    rc = tensor_map<T>(&mdo, dout, D, Tq, BH, P::kCols, kM, P::kSw);
  // with no key (Tk = 0) no key tile is loaded: k and v keep q's map
  mk = mv = mq;
  if (rc == 0 && Tk > 0)
    rc = tensor_map<T>(&mk, k, D, Tk, BH, P::kCols, P::kN, P::kSw);
  if (rc == 0 && Tk > 0)
    rc = tensor_map<T>(&mv, v, D, Tk, BH, P::kCols, P::kN, P::kSw);
  if (rc != 0) return rc;
  const dim3 grid(BH, query_tiles);
  flash_dq_sm90_kernel<T, D><<<grid, P::kThreads, P::kSmem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const float*>(bias),
      static_cast<T*>(dq), H, Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

#define MXT_HEAD_DIM_SWITCH(D, CALL)                         \
  switch (D) {                                               \
    case 16: return CALL(16);                                \
    case 32: return CALL(32);                                \
    case 64: return CALL(64);                                \
    case 128: return CALL(128);                              \
    case 256: return CALL(256);                              \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

template <typename T>
int flash_dkv(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, const void* bias,
              void* dk, void* dv, void* dbias, int BH, int H, int Tq,
              int Tk, int D, int causal, float scale, void* stream) {
#define MXT_CALL(DD)                                                       \
  launch_dkv<T, DD>(q, k, v, dout, lse, delta, bias, dk, dv, dbias, BH, H, \
                    Tq, Tk, causal, scale,                                 \
                    static_cast<cudaStream_t>(stream))
  MXT_HEAD_DIM_SWITCH(D, MXT_CALL)
#undef MXT_CALL
}

template <typename T>
int flash_dq(const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, const void* bias, void* dq,
             int BH, int H, int Tq, int Tk, int D, int causal, float scale,
             void* stream) {
#define MXT_CALL(DD)                                                    \
  launch_dq<T, DD>(q, k, v, dout, lse, delta, bias, dq, BH, H, Tq, Tk,  \
                   causal, scale, static_cast<cudaStream_t>(stream))
  MXT_HEAD_DIM_SWITCH(D, MXT_CALL)
#undef MXT_CALL
}

}  // namespace

// The C entry points, one per kernel and element type, with the f32
// source's arguments: bias, lse, delta and dbias are f32 in both.
extern "C" {

#define MXT_ENTRIES(SUFFIX, TYPE)                                           \
  int mxt_flash_dkv_##SUFFIX(const void* q, const void* k, const void* v,   \
                             const void* dout, const void* lse,             \
                             const void* delta, const void* bias,           \
                             void* dk, void* dv, void* dbias, int BH,       \
                             int H, int Tq, int Tk, int D, int causal,      \
                             float scale, void* stream) {                   \
    return flash_dkv<TYPE>(q, k, v, dout, lse, delta, bias, dk, dv, dbias,  \
                           BH, H, Tq, Tk, D, causal, scale, stream);        \
  }                                                                         \
  int mxt_flash_dq_##SUFFIX(const void* q, const void* k, const void* v,    \
                            const void* dout, const void* lse,              \
                            const void* delta, const void* bias, void* dq,  \
                            int BH, int H, int Tq, int Tk, int D,           \
                            int causal, float scale, void* stream) {        \
    return flash_dq<TYPE>(q, k, v, dout, lse, delta, bias, dq, BH, H, Tq,   \
                          Tk, D, causal, scale, stream);                    \
  }

MXT_ENTRIES(bf16, __nv_bfloat16)
MXT_ENTRIES(f16, __half)

#undef MXT_ENTRIES

}  // extern "C"
