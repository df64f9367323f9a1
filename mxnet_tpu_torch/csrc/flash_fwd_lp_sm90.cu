// Flash attention forward in bf16 and f16 for NVIDIA Hopper (sm_90a),
// with the tensor memory accelerator (TMA) and warpgroup MMAs (wgmma).
//
// Replaces the TPU kernel K6 on its native-rate path (16-bit operands,
// f32 accumulation): mxnet_tpu/ops/flash_attention.py:89 _fwd_kernel.
// The backward kernels (K7a, K7b) are csrc/flash_bwd_lp_sm90.cu and read
// this kernel's lse; both include csrc/sm90.cuh (mbarriers, TMA, wgmma).
//
// What it computes (q/k/v/out [B*H, T, D] row-major in T, one of
// __nv_bfloat16 or __half; bias (B, Tk) and lse (B*H, Tq) f32):
//   s = q k^T * scale + bias[b, key] in f32; causal: s = -1e30 where query
//   row < key col (absolute positions, also when Tq != Tk); online softmax
//   over key tiles from m = -1e30 (never -inf); P rounded to T before P V
//   (the TPU kernel's `p.astype(v_blk.dtype)`, :123), f32 accumulation;
//   out = acc / max(l, 1e-30) rounded to T; lse = m + log(max(l, 1e-30))
//   in natural-log units. Keys past Tk weigh exactly 0; queries past Tq
//   are computed from zero-filled rows and never stored.
//
// What bounds it on the card: at BERT-base shapes (B=8, H=12, T=512,
// D=64) ~6.4 GFLOP against ~25 MB of 16-bit q/k/v/out: ~6.5 us at the
// 989 TFLOP/s dense bf16/f16 rate, ~7.6 us of bytes at 3.35 TB/s. The
// mma.sync design before this one (one m16n8k16 pass per warp, every
// warp re-reading each K and V tile from shared memory through ldmatrix,
// every thread issuing cp.async copies, the mask tested on every element)
// ran at about twice the time of one PyTorch SDPA call. What holds this
// one back (PERF.md): the softmax's exponentials (MUFU) and the few warps
// an SM holds to overlap them with the tensor cores.
//
// Design:
// - A CTA is one consumer warpgroup (4 warps, 64 query rows; warp w owns
//   rows 16w .. 16w + 15) and one producer warp. One lane of the producer
//   issues every copy by TMA: the Q tile once, then each key tile's K and
//   V into a ring of kStages stages, each stage guarded by a `full`
//   mbarrier (TMA transaction bytes) and an `empty` one (one arrival per
//   consumer warp once its products have read the stage). Copies take no
//   registers or instructions from the consumers.
// - Tensor maps are 3-D (D, T, B*H), so a tile past a head's T is
//   zero-filled by the hardware instead of reading the next head's rows.
//   Rows of 128 bytes (D = 64 columns) use the 128-byte swizzle, D = 32
//   and 16 the 64- and 32-byte swizzles; D = 128 and 256 are loaded as
//   two and four 64-column blocks. The maps are encoded in the C entry
//   point (cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so
//   nothing links libcuda) and passed by value as __grid_constant__.
// - S = Q K^T is wgmma m64n64k16 with both operands read from shared
//   memory by descriptor (K-major, the swizzle of the copy), D/16 steps
//   per 64 keys. O += P V is wgmma with P from registers and V read from
//   shared memory MN-major (16-bit wgmma transposes B itself): the
//   accumulator fragments of two 8-column chunks of S are exactly the A
//   fragment of one 16-key step, so P passes from S to A by rounding
//   pairs into 16-bit registers, where the TPU kernel rounds it.
// - Softmax in f32 on the S fragments, a row reduced over its quad by
//   shuffles, in log2 units: log2(e) is folded into the scale (and into
//   the bias as the producer stages it), so each probability is one ex2 of
//   (x - m). A masked score is -1e30 log2(e), the value a bias of -1e30
//   takes: a row whose every key is masked attends uniformly, as the
//   reference gives, and its lse is the reference's -1e30 exactly, so the
//   backward weighs its keys alike. The causal and ragged-edge masks run
//   only on the key tiles that the diagonal or the edge cuts (per warp).
// - The consumer warpgroup overlaps its softmax with the tensor cores
//   (below, at the kernel).
// - Each output element and each lse is written by one thread, once: the
//   same bits on every launch.
// - Key tiles of 64 keys at every D. At D <= 64 a CTA takes ~128
//   registers a thread and ~58 KB, so three CTAs share an SM, each with a
//   3-stage ring; at D = 128 two (2 stages), at D = 256 one (O alone is
//   128 registers a thread). Three one-warpgroup CTAs an SM measured
//   faster on the card than 128-key tiles, than two consumer warpgroups
//   sharing each K/V stage (also when they take turns at the tensor
//   cores, with setmaxnreg), and than keeping two S tiles in flight
//   (each costs registers and so CTAs an SM): PERF.md, PR 11.
#include "sm90.cuh"

namespace {

constexpr int kThreads = 128 + 32;  // one consumer warpgroup, one producer
constexpr int kM = 64;               // query rows of a CTA
constexpr int kN = 64;               // keys of a tile

// The tiles of head dim D
template <int D>
struct Fwd {
  // three stages where three CTAs share an SM (D <= 64: registers allow
  // it), else two
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kMinBlocks = D <= 64 ? 3 : D == 128 ? 2 : 1;
  // a column block: kSw bytes a row (the swizzle span), kCols elements
  static constexpr int kSw = D >= 64 ? 128 : 2 * D;
  static constexpr int kCols = kSw / 2;
  static constexpr int kBlocks = D / kCols;
  // the wgmma width of O's column blocks
  static constexpr int kON = D >= 64 ? 64 : D;
  static constexpr uint64_t kLayout = kSw == 128 ? 1 : kSw == 64 ? 2 : 3;
  static constexpr int kQBytes = kM * D * 2;
  static constexpr int kTileBytes = kN * D * 2;   // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // 1024 bytes to align the tiles to the swizzle atom, the tiles, each
  // stage's bias, then the mbarriers: Q, kStages full, kStages empty
  static constexpr int kSmem = 1024 + kQBytes + kStages * kStageBytes +
                               kStages * kN * 4 + 8 * (1 + 2 * kStages);
};

// ------------------------------------------------------------- the kernel --
// S = Q K^T of one 64-key tile, issued (not waited for): D/16 steps of 16
// head elements, step ks in column block ks / (kSw / 32), 32 bytes into it
// per step
template <typename T, int D>
__device__ __forceinline__ void issue_scores(float (&s)[32], uint32_t s_q,
                                             uint32_t sk) {
  using F = Fwd<D>;
  constexpr int kSw = F::kSw;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks / (kSw / 32);
    const uint32_t off = (ks % (kSw / 32)) * 32;
    wgmma_ss_n64<T>(
        s, smem_desc(s_q + c * kM * kSw + off, 16, 8 * kSw, F::kLayout),
        smem_desc(sk + c * kN * kSw + off, 16, 8 * kSw, F::kLayout), ks > 0);
  }
}

// O += T(P) V of one key tile, issued: 16-key step kc's A fragment is
// pa[kc]; V's rows (keys) lie kSw bytes apart, read MN-major
template <typename T, int D>
__device__ __forceinline__ void issue_values(
    float (&o)[D / Fwd<D>::kON][Fwd<D>::kON / 2], const uint32_t (&pa)[4][4],
    uint32_t sv) {
  using F = Fwd<D>;
  constexpr int kSw = F::kSw, kON = F::kON;
#pragma unroll
  for (int kc = 0; kc < kN / 16; ++kc)
#pragma unroll
    for (int b = 0; b < D / kON; ++b) {
      const uint64_t desc = smem_desc(sv + b * kN * kSw + kc * 16 * kSw,
                                      kN * kSw, 8 * kSw, F::kLayout);
      if constexpr (kON == 64) wgmma_rs_n64<T>(o[b], pa[kc], desc);
      else if constexpr (kON == 32) wgmma_rs_n32<T>(o[b], pa[kc], desc);
      else wgmma_rs_n16<T>(o[b], pa[kc], desc);
    }
}

// The online softmax of one key tile on this thread's S fragments (rows
// g and g + 8 of the warp's 16; of each 8-key chunk j the keys 8j + 2t and
// 8j + 2t + 1: registers 4j .. 4j + 3 are (g, 2t), (g, 2t + 1), (g + 8,
// 2t), (g + 8, 2t + 1)), in log2 units: x = s * scale * log2(e) + bias *
// log2(e) (the stage holds the bias so scaled), p = 2^(x - m). s becomes
// P, (m, l) move on, alpha is the factor of the old accumulator. The masks
// run only where `cut`; a row's maximum and sum are pairwise trees, so no
// chain of dependent steps is long.
__device__ __forceinline__ void online_softmax(
    float (&s)[32], float (&m)[2], float (&l)[2], float (&alpha)[2],
    const float* sbias, int k0, int row_g, int t, int Tk, int causal,
    bool cut, float scale_log2) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_g + 8 * r;
    float v[16];   // keys 8j + 2t + e at v[2j + e]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 b = *reinterpret_cast<const float2*>(sbias + 8 * j + 2 * t);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x = fmaf(s[4 * j + 2 * r + e], scale_log2, e ? b.y : b.x);
        if (cut) {
          const int col = k0 + 8 * j + 2 * t + e;
          if (causal && row < col) x = kNegInfLog2;
          if (col >= Tk) x = -INFINITY;  // absent key: weighs exactly 0
        }
        v[2 * j + e] = x;
      }
    }
    float mx[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) mx[i] = fmaxf(v[2 * i], v[2 * i + 1]);
#pragma unroll
    for (int w = 4; w >= 1; w /= 2)
#pragma unroll
      for (int i = 0; i < w; ++i) mx[i] = fmaxf(mx[i], mx[i + w]);
    float mrow = fmaxf(mx[0], kNegInfLog2);
    mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, 1));
    mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, 2));
    const float m_new = fmaxf(m[r], mrow);
    alpha[r] = ex2(m[r] - m_new);
#pragma unroll
    for (int i = 0; i < 16; ++i) v[i] = ex2(v[i] - m_new);
    float ps[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) ps[i] = v[2 * i] + v[2 * i + 1];
#pragma unroll
    for (int w = 4; w >= 1; w /= 2)
#pragma unroll
      for (int i = 0; i < w; ++i) ps[i] += ps[i + w];
    float sum = ps[0];
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l[r] = l[r] * alpha[r] + sum;
    m[r] = m_new;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) s[4 * j + 2 * r + e] = v[2 * j + e];
  }
}

// grid (query tiles, B*H), kThreads threads. Shared memory (aligned to
// 1024 bytes): the Q tile, kStages x (K tile, V tile), each tile as
// kBlocks column blocks of rows x kSw bytes in the copy's swizzle, each
// stage's kN bias values, then the mbarriers.
//
// The consumer warpgroup overlaps its softmax with the tensor cores: in
// the step of key tile i it issues S_i = Q K_i^T, then O += P_{i-1}
// V_{i-1}, waits for S_i alone and runs the softmax of tile i while the
// P V product runs, then waits for it, releases tile i - 1's stage and
// rescales O.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, Fwd<D>::kMinBlocks)
flash_fwd_sm90_kernel(const __grid_constant__ CUtensorMap tm_q,
                      const __grid_constant__ CUtensorMap tm_k,
                      const __grid_constant__ CUtensorMap tm_v,
                      const float* __restrict__ bias, T* __restrict__ out,
                      float* __restrict__ lse, int H, int Tq, int Tk,
                      int causal, float scale) {
  using F = Fwd<D>;
  constexpr int kSw = F::kSw, kStages = F::kStages, kOB = D / F::kON;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t smem0 = smem_u32(smem_raw);
  const uint32_t s_q = (smem0 + 1023) & ~1023u;
  const uint32_t s_kv = s_q + F::kQBytes;         // stage i: + i kStageBytes
  const uint32_t s_bias = s_kv + kStages * F::kStageBytes;
  float* bias_smem = reinterpret_cast<float*>(smem_raw + (s_bias - smem0));
  const uint32_t bars = s_bias + kStages * kN * 4;
  const uint32_t q_full = bars;
  auto full = [&](int st) { return bars + 8 * (1 + st); };
  auto empty = [&](int st) { return bars + 8 * (1 + kStages + st); };
  auto stage_k = [&](int st) { return s_kv + st * F::kStageBytes; };

  // the latest query tiles (the longest causal walks) first
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int bh = blockIdx.y;
  const int q0 = qt * kM;
  // causal: key tiles at or past the last query row + 1 are fully masked
  const int k_end = causal ? min(Tk, q0 + kM) : Tk;
  const int tiles = (k_end + kN - 1) / kN;
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

  // the role, warp-uniform as the compiler sees it (a shuffle of one
  // lane's value): with the condition on threadIdx.x itself, ptxas takes
  // the consumers' path for a divergent one and serializes its wgmmas
  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const int lane = threadIdx.x & 31;
  if (role == 1) {
    // ---- producer warp: lane 0 issues every copy by TMA; the lanes copy
    // each key tile's bias, times log2(e) (0 without one, and past Tk),
    // into its stage
    if (lane == 0) {
      mbar_expect_tx(q_full, F::kQBytes);
#pragma unroll
      for (int c = 0; c < F::kBlocks; ++c)
        tma_load(s_q + c * kM * kSw, &tm_q, q_full, c * F::kCols, q0, bh);
    }
    for (int it = 0; it < tiles; ++it) {
      const int st = it % kStages;
      mbar_wait(empty(st), ((it / kStages) & 1) ^ 1);
      float* sb = bias_smem + st * kN;
      for (int j = lane; j < kN; j += 32) {
        const int col = it * kN + j;
        sb[j] = brow != nullptr && col < Tk ? brow[col] * kLog2e : 0.f;
      }
      if (lane == 0) {
        const uint32_t sk = stage_k(st), sv = sk + F::kTileBytes;
        mbar_expect_tx(full(st), F::kStageBytes);
#pragma unroll
        for (int c = 0; c < F::kBlocks; ++c) {
          tma_load(sk + c * kN * kSw, &tm_k, full(st), c * F::kCols,
                   it * kN, bh);
          tma_load(sv + c * kN * kSw, &tm_v, full(st), c * F::kCols,
                   it * kN, bh);
        }
      } else {
        mbar_arrive(full(st));
      }
    }
    return;
  }

  // ---- consumers: warp w owns query rows 16w .. 16w + 15 of the tile
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row_w = q0 + 16 * warp;   // the warp's first query row
  float s[32];
  float o[kOB][F::kON / 2];
  uint32_t pa[4][4];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
#pragma unroll
  for (int b = 0; b < kOB; ++b)
#pragma unroll
    for (int i = 0; i < F::kON / 2; ++i) o[b][i] = 0.f;
  float m[2] = {kNegInfLog2, kNegInfLog2}, l[2] = {0.f, 0.f}, alpha[2];
  const float scale_log2 = scale * kLog2e;
  // the masks where the causal diagonal or the ragged edge cuts this
  // warp's part of the tile at k0
  auto cut = [&](int k0) {
    return (causal && k0 + kN - 1 > row_w) || k0 + kN > Tk;
  };

  mbar_wait(q_full, 0);
  if (tiles > 0) {
    // key tile 0: S_0 alone
    mbar_wait(full(0), 0);
    reg_fence(s);
    wg_fence();
    issue_scores<T, D>(s, s_q, stage_k(0));
    wg_commit();
    wg_wait<0>();
    reg_fence(s);
    online_softmax(s, m, l, alpha, bias_smem, 0, row_w + g, t, Tk, causal,
                   cut(0), scale_log2);
    pack_p<T>(s, pa);
    for (int it = 1; it < tiles; ++it) {
      const int st = it % kStages, prev = (it - 1) % kStages;
      const int k0 = it * kN;
      mbar_wait(full(st), (it / kStages) & 1);
      reg_fence(s);
#pragma unroll
      for (int b = 0; b < kOB; ++b) reg_fence(o[b]);
#pragma unroll
      for (int kc = 0; kc < 4; ++kc) reg_fence(pa[kc]);
      wg_fence();
      issue_scores<T, D>(s, s_q, stage_k(st));
      wg_commit();
      issue_values<T, D>(o, pa, stage_k(prev) + F::kTileBytes);
      wg_commit();
      wg_wait<1>();     // S_i has landed; P_{i-1} V_{i-1} may still run
      reg_fence(s);
      online_softmax(s, m, l, alpha, bias_smem + st * kN, k0, row_w + g, t,
                     Tk, causal, cut(k0), scale_log2);
      wg_wait<0>();
#pragma unroll
      for (int b = 0; b < kOB; ++b) reg_fence(o[b]);
      // this warp's products have read tile i - 1's stage
      if (lane == 0) mbar_arrive(empty(prev));
#pragma unroll
      for (int b = 0; b < kOB; ++b)
#pragma unroll
        for (int i = 0; i < F::kON / 2; ++i) o[b][i] *= alpha[(i >> 1) & 1];
      pack_p<T>(s, pa);
    }
#pragma unroll
    for (int b = 0; b < kOB; ++b) reg_fence(o[b]);
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) reg_fence(pa[kc]);
    wg_fence();
    issue_values<T, D>(o, pa,
                       stage_k((tiles - 1) % kStages) + F::kTileBytes);
    wg_commit();
    wg_wait<0>();
#pragma unroll
    for (int b = 0; b < kOB; ++b) reg_fence(o[b]);
  }

  // out = O / max(l, 1e-30) rounded to T, lse = m + log(max(l, 1e-30))
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_w + g + 8 * r;
    if (row >= Tq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    T* orow = out + (static_cast<size_t>(bh) * Tq + row) * D;
#pragma unroll
    for (int b = 0; b < kOB; ++b)
#pragma unroll
      for (int j = 0; j < F::kON / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + b * F::kON + 8 * j + 2 * t) =
            pack2<T>(o[b][4 * j + 2 * r] / l_safe,
                     o[b][4 * j + 2 * r + 1] / l_safe);
    // in natural-log units; a row that saw no unmasked key keeps the
    // reference's m = -1e30 exactly, so that the backward's exp(s - lse)
    // weighs its keys as the reference's does
    if (t == 0)
      lse[static_cast<size_t>(bh) * Tq + row] =
          (m[r] == kNegInfLog2 ? kNegInf : m[r] * kLn2) + logf(l_safe);
  }
}

template <typename T, int D>
int launch_fwd(const void* q, const void* k, const void* v, const void* bias,
               void* out, void* lse, int BH, int H, int Tq, int Tk,
               int causal, float scale, cudaStream_t st) {
  using F = Fwd<D>;
  auto kernel = flash_fwd_sm90_kernel<T, D>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, F::kSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ready = true;
  }
  if (BH <= 0 || H <= 0 || Tq <= 0 || Tk < 0 || BH > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!aligned16(q, k, v, out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  CUtensorMap mq, mk, mv;
  int rc = tensor_map<T>(&mq, q, D, Tq, BH, F::kCols, kM, F::kSw);
  // with no key (Tk = 0) no key tile is loaded: k and v keep q's map
  mk = mv = mq;
  if (rc == 0 && Tk > 0)
    rc = tensor_map<T>(&mk, k, D, Tk, BH, F::kCols, kN, F::kSw);
  if (rc == 0 && Tk > 0)
    rc = tensor_map<T>(&mv, v, D, Tk, BH, F::kCols, kN, F::kSw);
  if (rc != 0) return rc;
  const dim3 grid((Tq + kM - 1) / kM, BH);
  kernel<<<grid, kThreads, F::kSmem, st>>>(
      mq, mk, mv, static_cast<const float*>(bias), static_cast<T*>(out),
      static_cast<float*>(lse), H, Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int flash_fwd(const void* q, const void* k, const void* v, const void* bias,
              void* out, void* lse, int BH, int H, int Tq, int Tk, int D,
              int causal, float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 16: return launch_fwd<T, 16>(q, k, v, bias, out, lse, BH, H, Tq,
                                      Tk, causal, scale, st);
    case 32: return launch_fwd<T, 32>(q, k, v, bias, out, lse, BH, H, Tq,
                                      Tk, causal, scale, st);
    case 64: return launch_fwd<T, 64>(q, k, v, bias, out, lse, BH, H, Tq,
                                      Tk, causal, scale, st);
    case 128: return launch_fwd<T, 128>(q, k, v, bias, out, lse, BH, H, Tq,
                                        Tk, causal, scale, st);
    case 256: return launch_fwd<T, 256>(q, k, v, bias, out, lse, BH, H, Tq,
                                        Tk, causal, scale, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// The C entry points, one per element type, with the other flash sources'
// arguments (q, k, v, bias, out, lse, B*H, H, Tq, Tk, D, causal, scale,
// stream); bias and lse are f32.
extern "C" {

int mxt_flash_fwd_bf16(const void* q, const void* k, const void* v,
                       const void* bias, void* out, void* lse, int BH, int H,
                       int Tq, int Tk, int D, int causal, float scale,
                       void* stream) {
  return flash_fwd<__nv_bfloat16>(q, k, v, bias, out, lse, BH, H, Tq, Tk, D,
                                  causal, scale, stream);
}

int mxt_flash_fwd_f16(const void* q, const void* k, const void* v,
                      const void* bias, void* out, void* lse, int BH, int H,
                      int Tq, int Tk, int D, int causal, float scale,
                      void* stream) {
  return flash_fwd<__half>(q, k, v, bias, out, lse, BH, H, Tq, Tk, D, causal,
                           scale, stream);
}

}  // extern "C"
