// Flash attention forward and backward in f32, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels in mxnet_tpu/ops/flash_attention.py:
//   K6  _fwd_kernel   (flash_fwd_kernel: out and logsumexp)
//   K7a _dkv_kernel   (flash_dkv_kernel: dK, dV and the per-head bias
//                      gradient of one key tile)
//   K7b _dq_kernel    (flash_dq_kernel: dQ of one query tile)
//
// What they compute (q/k/v/out/dout [B*H, T, D] row-major, f32):
//   s   = q k^T * scale + bias[b, key]          (bias optional, (B, Tk))
//   causal: s = -1e30 where query row < key col (absolute positions, as
//           the TPU kernel masks them; key tiles wholly above the diagonal
//           are skipped)
//   forward: online softmax over key tiles; out = acc / max(l, 1e-30),
//            lse = m + log(max(l, 1e-30)); m starts at -1e30, never -inf
//   backward, from the saved lse and delta = rowsum(dout * out):
//            p = exp(s - lse) (0 where causal drops the pair),
//            dv = p^T dout, ds = p * (dout v^T - delta),
//            dk = scale * ds^T q, dq = scale * ds k, dbias = colsum(ds)
// Keys past Tk and queries past Tq take no part: the kernels mask the
// ragged edge themselves (zero-filled tiles, absent keys at -inf in the
// forward, p = 0 in the backward) and need no padded copy.
//
// What bounds them on the card: operations. At BERT-base shapes (B=8,
// H=12, T=512, D=64) the forward does ~6.4 GFLOP, the dK/dV kernel ~12.9
// (four products per (query, key) pair: S^T, dV, dP^T, dK) and the dQ
// kernel ~9.7 (S, dP, dQ), against ~50-75 MB of q/k/v/dout/out (~0.02 ms
// of bytes).
//
// All three run every product on the tensor cores at f32 accuracy:
// split-TF32 mma.sync m16n8k8. Each f32 operand is split into hi =
// rna_tf32(x) and lo = rna_tf32(x - hi) (11 significant bits each, x =
// hi + lo to ~2^-22 relative), and each tile product is three MMAs, hi*hi
// + hi*lo + lo*hi (warp_mma3): only lo*lo, ~2^-22 of each product, is
// dropped, so the result keeps f32 numerics (the same as the TPU kernel's
// Precision.HIGHEST, a multi-pass emulation on its matrix unit) at 3
// passes of the 495 TFLOP/s TF32 rate. The tensor cores truncate each sum
// into their accumulator, so the large and small terms go to separate
// accumulators, started afresh for each tile of the walked operand and
// folded into the running sums by f32 adds: no accumulator chains more
// than 16 (score products: D/8, in two chains at D = 256) or 8 (output
// products) large MMAs.
//
// One CTA of 4 warps per (row tile, b*h). A tile is 64 rows, or 32 at D
// = 256, where 64 rows would need ~333 KB of shared memory in the
// forward and 256 registers a thread for dK and dV. Warp w owns rows
// 16(w % R)..16(w % R)+15 of the CTA's tile (R = rows / 16 row warps),
// the A operand of its products, and columns of part w / R of the head
// dim in the output products: at 64 rows each warp takes all of D; at
// 32 rows two warps share each 16 rows, both form the same score tile
// (the same instructions, so the same bits) and each accumulates half of
// D. Each walks the other operand's tiles through a 2-stage cp.async
// ring, carrying its accumulators in registers (the TPU kernels walk the
// sequential innermost grid axis with carried scratch instead):
//   forward and dQ: a query tile; Q (and dO) stay in shared memory, the
//     ring carries K and V; dQ walks the key tiles up to the diagonal
//     when causal, the latest query tiles (the longest walks) first.
//   dK/dV: a key tile; K and V stay in shared memory, the ring carries
//     Q, dO and the tile's lse and delta; it walks the query tiles from
//     the diagonal on when causal, the first key tiles (the longest
//     walks) first. Scores are transposed (rows = keys), as in the TPU
//     kernel, so the per-key bias and bias gradient are per row, in
//     registers, and lse/delta per column, from the ring.
// Every row is padded to D + 4 floats, so both fragment reads of a tile,
// as it lies ("B = rows": S = A B^T) and across ("B = columns": O = P B),
// hit 32 distinct banks: no tile is ever transposed in shared memory. P
// and dS never leave registers: they pass from the C layout of a score
// product to the A layout of the next product by permuting the
// contracted index (out_mma). The splits cost about as many instructions
// as the MMAs they feed (each warp splits the whole walked tile), which
// with the softmax's expf keeps the kernels well above their bound.
// Each output element is written by one thread, once, with no atomics,
// so the results are deterministic.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // _NEG_INF of ops/flash_attention.py
constexpr int kThreads = 128;       // 4 warps
constexpr int kWarps = kThreads / 32;

// The tiles of head dim D: kRows query or key rows, each padded to D + 4
// floats; warp w owns rows 16 (w % kRowWarps) .. + 15 and output columns
// kCols (w / kRowWarps) .. + kCols - 1. Each kernel's shared bytes:
// forward: Q + 2 x (K, V); dK/dV: K, V + 2 x (Q, dO, lse, delta); dQ: Q,
// dO + 2 x (K, V). At D = 256 (32 rows): 166 KB, 200 KB, 200 KB.
template <int D>
struct Tiles {
  static constexpr int kRows = D > 128 ? 32 : 64;
  static constexpr int kRowWarps = kRows / 16;
  static constexpr int kCols = D / (kWarps / kRowWarps);
  static constexpr int kLd = D + 4;
  static constexpr int kFloats = kRows * kLd;
  static constexpr int kDkvStage = 2 * kFloats + 2 * kRows;
  static constexpr size_t kFwdSmem = sizeof(float) * 5 * kFloats;
  static constexpr size_t kDkvSmem =
      sizeof(float) * (2 * kFloats + 2 * kDkvStage);
  static constexpr size_t kDqSmem = sizeof(float) * 6 * kFloats;
};

// Output products (P V, P^T dO, dS^T Q, dS K) run in this many parts of
// kCols / parts columns, each from its own fresh accumulators (warp_mma3):
// at 128 columns a warp whole products would leave too few registers for
// the running sums (dK and dV alone are 128 a thread). Score products run
// whole: at D = 64 the dK/dV kernel then takes all 255 registers a thread
// may have with no spill, where halving its score products made ptxas
// spill.
template <int D>
constexpr int kOutParts = Tiles<D>::kCols >= 128 ? 4 : 1;

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

// one float; rows of lse and delta need no 16-byte alignment
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// x = hi + lo, each rounded to TF32 to nearest (ties away, as
// cvt.rna.tf32.f32): hi by adding half a TF32 ulp to the bits and
// clearing the 13 low bits; lo = x - hi exactly, plus half a TF32 ulp,
// for the tensor cores, which read an operand's top 19 bits, to round.
// |lo| <= 2^-11 |x|, and x - hi - lo is ~2^-22 |x| without bias (a lo
// left for the tensor cores to truncate would shrink every product).
// Finite x only.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) + 0x1000u;
}

// c += a * b, one m16n8k8 TF32 MMA with f32 accumulation. Fragments
// (g = lane / 4, t = lane % 4): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3
// (g+8, t+4) of A (16 x 8); b0 (t, g), b1 (t+4, g) of B (8 x 8, k x n);
// c0 (g, 2t), c1 (g, 2t+1), c2 (g+8, 2t), c3 (g+8, 2t+1) of C (16 x 8).
// Not volatile, so the compiler may interleave independent MMAs.
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
}

// The split-TF32 tile product of one warp: A (16 x 8KS) * B (8KS x 8NT)
// at f32 accuracy, a 16 x 8NT tile of C fragments. With a = ah + al and b
// = bh + bl split to TF32, a*b = ah*bh + ah*bl + al*bh + al*bl; the last
// term is ~2^-22 of the product and is dropped. The tensor cores
// truncate each sum into their f32 accumulator, and that error grows
// with the number of MMAs chained into one accumulator and with its
// magnitude, so the large terms (ah*bh, KS MMAs per fragment) go to
// `big` and the small ones (ah*bl + al*bh, ~2^-11 of them) to `small`,
// both fresh for this product, and each element x = big + small (an f32
// round-to-nearest add) of n-chunk j, C element i, goes to fold(j, i, x)
// once: the caller folds it into its running sums. The n-chunks run in
// PARTS parts, each with its own accumulators. Each pass runs over a
// part's accumulators before the next (independent MMAs back to back).
// `a(ks, ah, al)` gives k-chunk ks's split A fragment; `b(ks, nt, bh,
// bl)` the split B fragment of k-chunk ks, n-chunk nt.
template <int KS, int NT, int PARTS, typename AFrag, typename BFrag,
          typename Fold>
__device__ __forceinline__ void warp_mma3(AFrag a, BFrag b, Fold fold) {
  constexpr int NP = NT / PARTS;
#pragma unroll
  for (int part = 0; part < PARTS; ++part) {
    float big[NP][4], small[NP][4];
    zero(big);
    zero(small);
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t ah[4], al[4], bh[NP][2], bl[NP][2];
      a(ks, ah, al);
#pragma unroll
      for (int nt = 0; nt < NP; ++nt) b(ks, part * NP + nt, bh[nt], bl[nt]);
#pragma unroll
      for (int nt = 0; nt < NP; ++nt)
        mma_tf32(small[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NP; ++nt)
        mma_tf32(small[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
      for (int nt = 0; nt < NP; ++nt)
        mma_tf32(big[nt], ah, bh[nt][0], bh[nt][1]);
    }
#pragma unroll
    for (int j = 0; j < NP; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        fold(part * NP + j, i, big[j][i] + small[j][i]);
  }
}

// split A fragment of the 16 x 8 block at p (row-major, stride ld)
__device__ __forceinline__ void a_frag(const float* p, int ld, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(p[g * ld + t], hi[0], lo[0]);
  split_tf32(p[(g + 8) * ld + t], hi[1], lo[1]);
  split_tf32(p[g * ld + t + 4], hi[2], lo[2]);
  split_tf32(p[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

// A score tile S = A B^T of one warp (16 x kRows), each element to
// fold(j, i, x) as warp_mma3 gives it: A the warp's 16 rows at `a`, B the
// kRows rows at `b`, both padded tiles read as they lie (B(d, n) =
// b[n][d]); each operand is split at the read. C fragment j holds rows g
// and g+8, columns 8j + 2t and 8j + 2t + 1.
template <int D, typename Fold>
__device__ __forceinline__ void score_mma(const float* a, const float* b,
                                          int g, int t, Fold fold) {
  constexpr int kLd = Tiles<D>::kLd, NK = Tiles<D>::kRows / 8;
  // k-chunks per accumulator chain
  constexpr int KS = D / 8, KP = KS > 16 ? 16 : KS;
  auto chain = [&](int k0, auto part_fold) {
    warp_mma3<KP, NK, 1>(
        [&](int kc, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
          a_frag(a + 8 * (k0 + kc), kLd, g, t, hi, lo);
        },
        [&](int kc, int nt, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
          const float* p = b + (8 * nt + g) * kLd + 8 * (k0 + kc) + t;
          split_tf32(p[0], hi[0], lo[0]);
          split_tf32(p[4], hi[1], lo[1]);
        },
        part_fold);
  };
  if constexpr (KP == KS) {
    chain(0, fold);
  } else {
    // each chain from fresh accumulators, the chains summed in f32
    float sum[NK][4];
#pragma unroll
    for (int k0 = 0; k0 < KS; k0 += KP)
      chain(k0, [&](int j, int i, float x) {
        sum[j][i] = k0 == 0 ? x : sum[j][i] + x;
      });
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) fold(j, i, sum[j][i]);
  }
}

// The product P B of one warp, each element to fold(j, i, x): P (16 x
// kRows) in the C layout of score_mma and B the kCols columns at `b` of a
// padded kRows x D tile, read across (B(n, d) = b[n][d]); fold's j counts
// 8-column chunks from `b`. P's C fragment holds positions 2t and
// 2t+1 of each 8-wide chunk, where an A fragment wants t and t+4; a
// product may take its contracted index in any order, so A's column t is
// position 2t and column t+4 is 2t+1, and B's rows follow: b0 = b[2t],
// b1 = b[2t+1]. P passes from the C to the A layout in registers.
template <int D, typename Fold>
__device__ __forceinline__ void out_mma(
    const float (&p)[Tiles<D>::kRows / 8][4], const float* b, int g, int t,
    Fold fold) {
  constexpr int kLd = Tiles<D>::kLd;
  warp_mma3<Tiles<D>::kRows / 8, Tiles<D>::kCols / 8, kOutParts<D>>(
      [&](int kc, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        split_tf32(p[kc][0], hi[0], lo[0]);
        split_tf32(p[kc][2], hi[1], lo[1]);
        split_tf32(p[kc][1], hi[2], lo[2]);
        split_tf32(p[kc][3], hi[3], lo[3]);
      },
      [&](int kc, int nt, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
        const float* q = b + (8 * kc + 2 * t) * kLd + 8 * nt + g;
        split_tf32(q[0], hi[0], lo[0]);
        split_tf32(q[kLd], hi[1], lo[1]);
      },
      fold);
}

// rows row0 .. row0 + kRows - 1 of a [rows, D] f32 matrix into a padded
// tile by 16-byte cp.async; rows past nrows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_async(float* dst,
                                                const float* __restrict__ src,
                                                int row0, int nrows) {
  constexpr int V = D / 4;
  for (int f = threadIdx.x; f < Tiles<D>::kRows * V; f += kThreads) {
    const int r = f / V, c = f % V;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + r * Tiles<D>::kLd + 4 * c,
               ok ? src + static_cast<size_t>(row0 + r) * D + 4 * c : src,
               ok ? 16 : 0);
  }
}

// the bias of this thread's score columns k0 + 8j + 2t (+1) of row
// `bias` (0 without one and past Tk); read before the score product, so
// the loads are in flight during its MMAs
template <int NK>
__device__ __forceinline__ void key_bias(const float* __restrict__ bias,
                                         int Tk, int k0, int t,
                                         float (&bj)[NK][2]) {
#pragma unroll
  for (int j = 0; j < NK; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = k0 + 8 * j + 2 * t + e;
      bj[j][e] = (bias != nullptr && col < Tk) ? bias[col] : 0.f;
    }
}

// The first of warp w's 16 rows in its tile, and the first of its output
// columns (0 where each warp takes all of D, as below D = 256)
template <int D>
__device__ __forceinline__ int warp_row0(int warp) {
  return 16 * (Tiles<D>::kRowWarps == kWarps ? warp
                                             : warp % Tiles<D>::kRowWarps);
}
template <int D>
__device__ __forceinline__ int warp_col0(int warp) {
  return Tiles<D>::kRowWarps == kWarps
             ? 0 : (warp / Tiles<D>::kRowWarps) * Tiles<D>::kCols;
}

// ------------------------------------------------------------- forward --
// K6: warp w owns query rows warp_row0 .. + 15 and walks the key tiles
// with its S (16 x kRows) and O (16 x kCols) accumulators in registers.
// Shared: the Q tile, then a 2-stage ring of (K tile, V tile).
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int H,
                 int Tq, int Tk, int causal, float scale) {
  constexpr int kLd = Tiles<D>::kLd, kTf = Tiles<D>::kFloats;
  constexpr int kRows = Tiles<D>::kRows, NK = kRows / 8;
  constexpr int NC = Tiles<D>::kCols / 8;  // 8-wide chunks of the columns
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp_row0<D>(warp), c0 = warp_col0<D>(warp);
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* brow =
      bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Tk;
  // causal: key tiles at or past the last query row + 1 are fully masked
  const int k_end = causal ? min(Tk, q0 + kRows) : Tk;
  const int tiles = (k_end + kRows - 1) / kRows;

  load_tile_async<D>(smem, q + static_cast<size_t>(bh) * Tq * D, q0, Tq);
  if (tiles > 0) {
    load_tile_async<D>(smem + kTf, kb, 0, Tk);
    load_tile_async<D>(smem + 2 * kTf, vb, 0, Tk);
  }
  cp_commit();
  // this warp's 16 query rows, split at each read (split fragments held
  // in registers for the whole walk would leave too few for the
  // accumulators below)
  const float* qw = smem + r0 * kLd;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[NC][4];
  zero(o);

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kRows;
    if (it + 1 < tiles) {
      float* nk = smem + (1 + 2 * ((it + 1) & 1)) * kTf;
      load_tile_async<D>(nk, kb, k0 + kRows, Tk);
      load_tile_async<D>(nk + kTf, vb, k0 + kRows, Tk);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // key tile `it` (and at it = 0 the Q tile) landed
    const float* ks_ = smem + (1 + 2 * (it & 1)) * kTf;
    const float* vs = ks_ + kTf;

    // S = Q K^T, then the online softmax on the C fragments: this thread
    // holds rows g and g+8, keys k0 + 8j + 2t (+1); the quad of a row
    // reduces by shuffles
    float s[NK][4], alpha[2], bj[NK][2];
    key_bias(brow, Tk, k0, t, bj);
    score_mma<D>(qw, ks_, g, t, [&](int j, int i, float x) { s[j][i] = x; });
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + r0 + g + 8 * r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e;
          float x = s[j][2 * r + e] * scale + bj[j][e];
          if (causal && row < col) x = kNegInf;
          if (col >= Tk) x = -INFINITY;  // absent key: weighs exactly 0
          s[j][2 * r + e] = x;
          mx = fmaxf(mx, x);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = expf(s[j][2 * r + e] - m_new);
          s[j][2 * r + e] = p;
          ps += p;
        }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      l[r] = l[r] * alpha[r] + ps;
      m[r] = m_new;
    }
    // O = alpha O + P V, the tile's product from fresh accumulators
    out_mma<D>(s, vs + c0, g, t, [&](int j, int i, float x) {
      o[j][i] = fmaf(o[j][i], alpha[i >> 1], x);
    });
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + 8 * r;
    if (row >= Tq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * Tq + row) * D + c0;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(o[j][2 * r] / l_safe, o[j][2 * r + 1] / l_safe);
    if (t == 0 && c0 == 0) lse[static_cast<size_t>(bh) * Tq + row] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------- backward dKV --
// K7a: one CTA per (b*h, key tile); warp w owns keys warp_row0 .. + 15
// and walks the query tiles that can see them, with its columns of dK and
// dV (16 x kCols each) and the bias gradient of its rows in registers. Shared: the K and V tiles (the
// A operands of S^T = K Q^T and dP^T = V dO^T), then a 2-stage ring of
// (Q tile, dO tile, lse and delta of the tile's queries); Q and dO are
// read as they lie as the B operands of the score products, and across
// as those of dV += P^T dO and dK += dS^T Q.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ bias, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ dbias, int H,
                 int Tq, int Tk, int causal, float scale) {
  constexpr int kLd = Tiles<D>::kLd, kTf = Tiles<D>::kFloats;
  constexpr int kStage = Tiles<D>::kDkvStage, kRows = Tiles<D>::kRows;
  constexpr int NK = kRows / 8, NC = Tiles<D>::kCols / 8;
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp_row0<D>(warp), c0 = warp_col0<D>(warp);
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const size_t koff = static_cast<size_t>(bh) * Tk;
  const float* qb = q + qoff * D;
  const float* dob = dout + qoff * D;
  float* ring = smem + 2 * kTf;
  // causal: query tiles wholly before this key tile see none of it
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < Tq ? (Tq - q_begin + kRows - 1) / kRows : 0;

  // stage s <- the query tile at q0: Q, dO, then lse and delta (one float
  // per thread: threads 0..kRows-1 lse, kRows..2kRows-1 delta)
  auto load_stage = [&](int s, int q0) {
    float* st = ring + s * kStage;
    load_tile_async<D>(st, qb, q0, Tq);
    load_tile_async<D>(st + kTf, dob, q0, Tq);
    if (2 * kRows >= kThreads || threadIdx.x < 2 * kRows) {
      const int i = threadIdx.x % kRows, row = q0 + i;
      const int which = threadIdx.x / kRows;
      const float* src = (which == 0 ? lse : delta) + qoff;
      cp_async4(st + 2 * kTf + which * kRows + i,
                row < Tq ? src + row : src, row < Tq ? 4 : 0);
    }
  };
  load_tile_async<D>(smem, k + koff * D, k0, Tk);
  load_tile_async<D>(smem + kTf, v + koff * D, k0, Tk);
  if (tiles > 0) load_stage(0, q_begin);
  cp_commit();
  // this warp's 16 keys in the K and V tiles, split at each read
  const float* kw = smem + r0 * kLd;
  const float* vw = kw + kTf;
  int key[2];
  float bk[2], dbs[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key[r] = k0 + r0 + g + 8 * r;
    bk[r] = (bias != nullptr && key[r] < Tk) ? bias[b * Tk + key[r]] : 0.f;
  }
  float dka[NC][4], dva[NC][4];
  zero(dka);
  zero(dva);

  for (int it = 0; it < tiles; ++it) {
    const int q0 = q_begin + it * kRows;
    if (it + 1 < tiles) load_stage((it + 1) & 1, q0 + kRows);
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // query tile `it` (and at it = 0 K and V) landed
    const float* qs = ring + (it & 1) * kStage;
    const float* dos = qs + kTf;
    const float* ls = dos + kTf;
    const float* dls = ls + kRows;

    // P^T = exp(S^T * scale + bias[key] - lse[query]), S^T = K Q^T: this
    // thread holds keys (rows) g and g+8, queries q0 + 8j + 2t (+1)
    float p[NK][4];
    score_mma<D>(kw, qs, g, t, [&](int j, int i, float x) {
      const int r = i >> 1, e = i & 1, row = q0 + 8 * j + 2 * t + e;
      const bool ok = row < Tq && key[r] < Tk && (!causal || row >= key[r]);
      p[j][i] = ok ? expf(x * scale + bk[r] - ls[8 * j + 2 * t + e]) : 0.f;
    });
    // dV += P^T dO
    out_mma<D>(p, dos + c0, g, t,
               [&](int j, int i, float x) { dva[j][i] += x; });
    // dS^T = P^T * (dP^T - delta[query]), dP^T = V dO^T; the bias
    // gradient sums dS^T over the queries of each key row
    float ds[NK][4];
    score_mma<D>(vw, dos, g, t, [&](int j, int i, float x) {
      ds[j][i] = p[j][i] * (x - dls[8 * j + 2 * t + (i & 1)]);
      dbs[i >> 1] += ds[j][i];
    });
    // dK += dS^T Q (scaled once, at the end)
    out_mma<D>(ds, qs + c0, g, t,
               [&](int j, int i, float x) { dka[j][i] += x; });
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {  // over the quad that shares a key row
    dbs[r] += __shfl_xor_sync(0xffffffffu, dbs[r], 1);
    dbs[r] += __shfl_xor_sync(0xffffffffu, dbs[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= Tk) continue;
    const size_t off = (koff + key[r]) * D + c0;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      *reinterpret_cast<float2*>(dk + off + 8 * j + 2 * t) = make_float2(
          scale * dka[j][2 * r], scale * dka[j][2 * r + 1]);
      *reinterpret_cast<float2*>(dv + off + 8 * j + 2 * t) =
          make_float2(dva[j][2 * r], dva[j][2 * r + 1]);
    }
    if (dbias != nullptr && t == 0 && c0 == 0) dbias[koff + key[r]] = dbs[r];
  }
}

// ----------------------------------------------------------- backward dQ --
// K7b: one CTA per (b*h, query tile); warp w owns queries warp_row0 ..
// + 15 and walks the key tiles it sees, with its columns of dQ (16 x
// kCols) in registers and lse and delta of its rows. Shared: the Q and dO tiles (the A operands of S = Q
// K^T and dP = dO V^T), then a 2-stage ring of (K tile, V tile); K is
// read as it lies as the B operand of S and across as that of dQ += dS K.
template <int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ bias, float* __restrict__ dq, int H,
                int Tq, int Tk, int causal, float scale) {
  constexpr int kLd = Tiles<D>::kLd, kTf = Tiles<D>::kFloats;
  constexpr int kRows = Tiles<D>::kRows, NK = kRows / 8;
  constexpr int NC = Tiles<D>::kCols / 8;
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.x, b = bh / H;
  // the last query tiles first: under the causal mask they walk the most
  // key tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp_row0<D>(warp), c0 = warp_col0<D>(warp);
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* brow =
      bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Tk;
  float* ring = smem + 2 * kTf;
  // causal: key tiles at or past the last query row + 1 are fully masked
  const int k_end = causal ? min(Tk, q0 + kRows) : Tk;
  const int tiles = (k_end + kRows - 1) / kRows;

  load_tile_async<D>(smem, q + qoff * D, q0, Tq);
  load_tile_async<D>(smem + kTf, dout + qoff * D, q0, Tq);
  if (tiles > 0) {
    load_tile_async<D>(ring, kb, 0, Tk);
    load_tile_async<D>(ring + kTf, vb, 0, Tk);
  }
  cp_commit();
  // this warp's 16 query rows of Q and dO, split at each read
  const float* qw = smem + r0 * kLd;
  const float* dow = qw + kTf;
  int row[2];
  float lr[2], dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row[r] = q0 + r0 + g + 8 * r;
    lr[r] = row[r] < Tq ? lse[qoff + row[r]] : 0.f;
    dr[r] = row[r] < Tq ? delta[qoff + row[r]] : 0.f;
  }
  float dqa[NC][4];
  zero(dqa);

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kRows;
    if (it + 1 < tiles) {
      float* nk = ring + 2 * ((it + 1) & 1) * kTf;
      load_tile_async<D>(nk, kb, k0 + kRows, Tk);
      load_tile_async<D>(nk + kTf, vb, k0 + kRows, Tk);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // key tile `it` (and at it = 0 Q and dO) landed
    const float* ks_ = ring + 2 * (it & 1) * kTf;
    const float* vs = ks_ + kTf;

    // P = exp(S * scale + bias[key] - lse[row]), S = Q K^T: this thread
    // holds rows g and g+8, keys k0 + 8j + 2t (+1)
    float p[NK][4], bj[NK][2];
    key_bias(brow, Tk, k0, t, bj);
    score_mma<D>(qw, ks_, g, t, [&](int j, int i, float x) {
      const int r = i >> 1, e = i & 1, col = k0 + 8 * j + 2 * t + e;
      const bool ok = col < Tk && (!causal || row[r] >= col);
      p[j][i] = ok ? expf(x * scale + bj[j][e] - lr[r]) : 0.f;
    });
    // dS = P * (dP - delta[row]), dP = dO V^T
    float ds[NK][4];
    score_mma<D>(dow, vs, g, t, [&](int j, int i, float x) {
      ds[j][i] = p[j][i] * (x - dr[i >> 1]);
    });
    // dQ += dS K (scaled once, at the end)
    out_mma<D>(ds, ks_ + c0, g, t,
               [&](int j, int i, float x) { dqa[j][i] += x; });
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Tq) continue;
    float* orow = dq + (qoff + row[r]) * D + c0;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) = make_float2(
          scale * dqa[j][2 * r], scale * dqa[j][2 * r + 1]);
  }
}

// sets the kernel's dynamic shared-memory limit (above the 48 KB
// default) once per process
template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool* done) {
  if (*done) return 0;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc == cudaSuccess) *done = true;
  return static_cast<int>(rc);
}

// the tiles are copied in 16-byte pieces and written in 8-byte ones
template <typename... Ptr>
bool aligned16(const Ptr*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

template <int D>
int launch_fwd(const float* q, const float* k, const float* v,
               const float* bias, float* out, float* lse, int BH, int H,
               int Tq, int Tk, int causal, float scale, cudaStream_t st) {
  static bool ready = false;
  const size_t smem = Tiles<D>::kFwdSmem;
  if (int rc = allow_smem(flash_fwd_kernel<D>, smem, &ready)) return rc;
  if (!aligned16(q, k, v, out))
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int kRows = Tiles<D>::kRows;
  const dim3 grid((Tq + kRows - 1) / kRows, BH);
  flash_fwd_kernel<D><<<grid, kThreads, smem, st>>>(
      q, k, v, bias, out, lse, H, Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               const float* bias, float* dk, float* dv, float* dbias, int BH,
               int H, int Tq, int Tk, int causal, float scale,
               cudaStream_t st) {
  static bool ready = false;
  const size_t smem = Tiles<D>::kDkvSmem;
  if (int rc = allow_smem(flash_dkv_kernel<D>, smem, &ready)) return rc;
  if (!aligned16(q, k, v, dout, dk, dv))
    return static_cast<int>(cudaErrorMisalignedAddress);
  // b*h fastest: every CTA of key tile 0 (the longest causal walk) first
  constexpr int kRows = Tiles<D>::kRows;
  const dim3 grid(BH, (Tk + kRows - 1) / kRows);
  flash_dkv_kernel<D><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, bias, dk, dv, dbias, H, Tq, Tk, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              const float* bias, float* dq, int BH, int H, int Tq, int Tk,
              int causal, float scale, cudaStream_t st) {
  static bool ready = false;
  const size_t smem = Tiles<D>::kDqSmem;
  if (int rc = allow_smem(flash_dq_kernel<D>, smem, &ready)) return rc;
  if (!aligned16(q, k, v, dout, dq))
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int kRows = Tiles<D>::kRows;
  const dim3 grid(BH, (Tq + kRows - 1) / kRows);
  flash_dq_kernel<D><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, bias, dq, H, Tq, Tk, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

#define MXT_HEAD_DIM_SWITCH(D, CALL)               \
  switch (D) {                                     \
    case 16: return CALL(16);                      \
    case 32: return CALL(32);                      \
    case 64: return CALL(64);                      \
    case 128: return CALL(128);                    \
    case 256: return CALL(256);                    \
    default: return static_cast<int>(cudaErrorInvalidValue); \
  }

}  // namespace

extern "C" {

int mxt_flash_fwd_f32(const void* q, const void* k, const void* v,
                      const void* bias, void* out, void* lse, int BH, int H,
                      int Tq, int Tk, int D, int causal, float scale,
                      void* stream) {
#define MXT_CALL(DD)                                                        \
  launch_fwd<DD>(static_cast<const float*>(q), static_cast<const float*>(k), \
                 static_cast<const float*>(v),                              \
                 static_cast<const float*>(bias), static_cast<float*>(out), \
                 static_cast<float*>(lse), BH, H, Tq, Tk, causal, scale,    \
                 static_cast<cudaStream_t>(stream))
  MXT_HEAD_DIM_SWITCH(D, MXT_CALL)
#undef MXT_CALL
}

int mxt_flash_dkv_f32(const void* q, const void* k, const void* v,
                      const void* dout, const void* lse, const void* delta,
                      const void* bias, void* dk, void* dv, void* dbias,
                      int BH, int H, int Tq, int Tk, int D, int causal,
                      float scale, void* stream) {
#define MXT_CALL(DD)                                                        \
  launch_dkv<DD>(static_cast<const float*>(q), static_cast<const float*>(k), \
                 static_cast<const float*>(v),                              \
                 static_cast<const float*>(dout),                           \
                 static_cast<const float*>(lse),                            \
                 static_cast<const float*>(delta),                          \
                 static_cast<const float*>(bias), static_cast<float*>(dk),  \
                 static_cast<float*>(dv), static_cast<float*>(dbias), BH, H, \
                 Tq, Tk, causal, scale, static_cast<cudaStream_t>(stream))
  MXT_HEAD_DIM_SWITCH(D, MXT_CALL)
#undef MXT_CALL
}

int mxt_flash_dq_f32(const void* q, const void* k, const void* v,
                     const void* dout, const void* lse, const void* delta,
                     const void* bias, void* dq, int BH, int H, int Tq,
                     int Tk, int D, int causal, float scale, void* stream) {
#define MXT_CALL(DD)                                                       \
  launch_dq<DD>(static_cast<const float*>(q), static_cast<const float*>(k), \
                static_cast<const float*>(v),                              \
                static_cast<const float*>(dout),                           \
                static_cast<const float*>(lse),                            \
                static_cast<const float*>(delta),                          \
                static_cast<const float*>(bias), static_cast<float*>(dq),  \
                BH, H, Tq, Tk, causal, scale,                              \
                static_cast<cudaStream_t>(stream))
  MXT_HEAD_DIM_SWITCH(D, MXT_CALL)
#undef MXT_CALL
}

}  // extern "C"
