// Flash attention forward and backward in f32, for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels in mxnet_tpu/ops/flash_attention.py:
//   K6  _fwd_kernel   (flash_fwd_kernel: out and logsumexp)
//   K7  _dkv_kernel   (flash_dkv_kernel: dK, dV and the per-head bias
//                      gradient of one key tile)
//       _dq_kernel    (flash_dq_kernel: dQ of one query tile)
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
// H=12, T=512, D=64) the forward does ~6.4 GFLOP and the backward ~16
// GFLOP (its two kernels recompute the scores twice: ~22 GFLOP in all)
// against ~50 MB of q/k/v/out (~0.015 ms of bytes).
//
// K6 (flash_fwd_kernel) runs on the tensor cores at f32 accuracy:
// split-TF32 mma.sync m16n8k8. Each f32 operand is split into hi =
// rna_tf32(x) and lo = rna_tf32(x - hi) (11 significant bits each, x =
// hi + lo to ~2^-22 relative), and each tile
// product is three MMAs, hi*hi + hi*lo + lo*hi (warp_mma3): only lo*lo,
// ~2^-22 of each product, is dropped, so the result keeps f32 numerics
// (the same as the TPU kernel's Precision.HIGHEST, a multi-pass emulation
// on its matrix unit) at 3 passes of the 495 TFLOP/s TF32 rate: ~0.039 ms
// at BERT-base shapes against ~0.096 ms for f32 on the CUDA cores. The
// tensor cores truncate each sum into their accumulator, so the large
// and small terms go to separate accumulators, started afresh for each
// key tile and folded into the running sums by f32 adds: no accumulator
// chains more than D/8 (S) or 8 (P V) large MMAs. One CTA of 4 warps per
// (64-query tile, b*h), 768 CTAs at BERT-base shapes; a warp owns 16
// query rows (read from the shared Q tile and split at each use) and
// carries its S and O accumulators in registers over a 2-stage cp.async
// ring of K and V tiles; the online softmax works on the S fragments
// (row max and sum over the quad that shares a row), and P passes to the
// A layout of P V in registers by permuting keys.
//
// K7 (dK/dV and dQ) still runs every product as a 64x64 (or 64xD) tile
// product out of shared memory on the CUDA cores (f32, 67 TFLOP/s). A
// CTA has 256 threads in a 16x16 grid; thread (ty, tx) owns rows
// 4ty..4ty+3 of every tile and columns 4tx..4tx+3 of a 64x64 score tile
// (or D/16 columns of a 64xD accumulator), so each step of the inner
// loop reads one float4 of each operand from shared memory for 16 (or
// 4*D/16) fused multiply-adds. Operands are staged "k-major" (the
// contracted index outermost), so both reads are conflict-free float4s;
// q/k/v rows are loaded from device memory as float4s, either as they
// lie or transposed into shared memory. The 16 threads that share a row
// are one half-warp, so a row sum is four shuffles.
//
// The TPU kernels walk the sequential innermost grid axis with carried
// scratch; here a loop inside the CTA walks the other operand's tiles and
// carries the accumulators in registers: the forward and dQ CTAs own one
// query tile and loop over key tiles, the dK/dV CTA owns one key tile and
// loops over query tiles. Each output element is written by one thread,
// once, with no atomics, so the results are deterministic. A grid of
// (T/64) x (B*H) CTAs (768 at BERT-base shapes) fills the 132 SMs.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // _NEG_INF of ops/flash_attention.py
constexpr int kTile = 64;           // query and key tile
constexpr int kThreads = 256;       // 16 x 16 threads (K7)

__device__ __forceinline__ float half_warp_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// N consecutive floats from shared memory (N*4-byte aligned)
template <int N>
__device__ __forceinline__ void lds(float (&r)[N], const float* p) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const float4 x = reinterpret_cast<const float4*>(p)[i];
      r[4 * i] = x.x;
      r[4 * i + 1] = x.y;
      r[4 * i + 2] = x.z;
      r[4 * i + 3] = x.w;
    }
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    r[0] = x.x;
    r[1] = x.y;
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) r[i] = p[i];
  }
}

// c[i][j] += sum_kk at[kk][4ty + i] * b[kk][NC*tx + j], kk < K: a 64 x
// (16*NC) tile product with both operands k-major in shared memory
template <int NC, int K, int LDB>
__device__ __forceinline__ void tile_mma(float (&c)[4][NC],
                                         const float* __restrict__ at,
                                         const float* __restrict__ b, int ty,
                                         int tx) {
#pragma unroll 8
  for (int kk = 0; kk < K; ++kk) {
    float a[4], bv[NC];
    lds<4>(a, at + kk * kTile + 4 * ty);
    lds<NC>(bv, b + kk * LDB + NC * tx);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NC; ++j) c[i][j] = fmaf(a[i], bv[j], c[i][j]);
  }
}

// dst[r][c] = src[row0 + r][c] (rows past nrows read as zero): a 64 x D
// tile as it lies
template <int D>
__device__ __forceinline__ void load_rows(float* dst,
                                          const float* __restrict__ src,
                                          int row0, int nrows) {
  constexpr int V = D / 4;
  for (int f = threadIdx.x; f < kTile * V; f += kThreads) {
    const int r = f / V, c = f % V;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows)
      x = reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * D)[c];
    reinterpret_cast<float4*>(dst + r * D)[c] = x;
  }
}

// dst[c][r] = src[row0 + r][c]: a 64 x D tile transposed to D x 64, so
// the head dimension is the contracted (outer) index of a score product.
// Consecutive threads take consecutive rows, so the shared-memory stores
// are conflict-free.
template <int D>
__device__ __forceinline__ void load_rows_t(float* dst,
                                            const float* __restrict__ src,
                                            int row0, int nrows) {
  constexpr int V = D / 4;
  for (int f = threadIdx.x; f < kTile * V; f += kThreads) {
    const int r = f % kTile, c = f / kTile;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < nrows)
      x = reinterpret_cast<const float4*>(
          src + static_cast<size_t>(row0 + r) * D)[c];
    dst[(4 * c) * kTile + r] = x.x;
    dst[(4 * c + 1) * kTile + r] = x.y;
    dst[(4 * c + 2) * kTile + r] = x.z;
    dst[(4 * c + 3) * kTile + r] = x.w;
  }
}

// stores a thread's 4x4 score block transposed: dst[col][row]
__device__ __forceinline__ void store_t(float* dst, const float (&s)[4][4],
                                        int ty, int tx) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(dst + (4 * tx + j) * kTile + 4 * ty) =
        make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
}

// ------------------------------------------------------------- forward --
// K6 on the tensor cores at f32 accuracy. One CTA of 4 warps per (64-query
// tile, b*h); warp w owns query rows 16w..16w+15 and walks the key tiles
// with its S (16 x 64) and O (16 x D) accumulators in registers. Shared:
// the Q tile, then a 2-stage cp.async ring of (K tile, V tile), every row
// padded to D + 4 floats so that each fragment read below hits 32
// distinct banks.
constexpr int kFwdThreads = 128;

template <int D>
struct FwdPlan {
  static constexpr int kLd = D + 4;
  static constexpr int kTileFloats = kTile * kLd;
  static constexpr size_t kSmem = sizeof(float) * 5 * kTileFloats;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
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

// The split-TF32 tile product of one warp: A (16 x 8KS) * B (8KS x 8NT)
// at f32 accuracy, as NT C fragments (a 16 x 8NT tile). With a = ah + al
// and b = bh + bl split to TF32, a*b = ah*bh + ah*bl + al*bh + al*bl; the
// last term is ~2^-22 of the product and is dropped. The tensor cores
// truncate each sum into their f32 accumulator, and that error grows
// with the number of MMAs chained into one accumulator and with its
// magnitude, so the large terms (ah*bh, KS MMAs per fragment) go to
// `big` and the small ones (ah*bl + al*bh, ~2^-11 of them) to `small`;
// the caller adds the two with f32 round-to-nearest adds, and starts
// them from zero often enough (per key tile) to keep the chains short.
// Each pass runs over all NT accumulators before the next (independent
// MMAs back to back). `a(ks, ah, al)` gives k-chunk ks's split A
// fragment; `b(ks, nt, bh, bl)` the split B fragment of k-chunk ks,
// n-chunk nt.
template <int KS, int NT, typename AFrag, typename BFrag>
__device__ __forceinline__ void warp_mma3(float (&big)[NT][4],
                                          float (&small)[NT][4], AFrag a,
                                          BFrag b) {
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    a(ks, ah, al);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) b(ks, nt, bh[nt], bl[nt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_tf32(small[nt], al, bh[nt][0], bh[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_tf32(small[nt], ah, bl[nt][0], bl[nt][1]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      mma_tf32(big[nt], ah, bh[nt][0], bh[nt][1]);
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
}

// split A fragment of the 16 x 8 block at p (row-major, stride ld)
__device__ __forceinline__ void a_frag(const float* p, int ld, int g, int t,
                                       uint32_t (&hi)[4], uint32_t (&lo)[4]) {
  split_tf32(p[g * ld + t], hi[0], lo[0]);
  split_tf32(p[(g + 8) * ld + t], hi[1], lo[1]);
  split_tf32(p[g * ld + t + 4], hi[2], lo[2]);
  split_tf32(p[(g + 8) * ld + t + 4], hi[3], lo[3]);
}

// rows row0 .. row0+63 of a [rows, D] f32 matrix into a padded tile by
// 16-byte cp.async; rows past nrows are zero-filled
template <int D>
__device__ __forceinline__ void load_tile_async(float* dst,
                                                const float* __restrict__ src,
                                                int row0, int nrows) {
  constexpr int V = D / 4;
  for (int f = threadIdx.x; f < kTile * V; f += kFwdThreads) {
    const int r = f / V, c = f % V;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + r * FwdPlan<D>::kLd + 4 * c,
               ok ? src + static_cast<size_t>(row0 + r) * D + 4 * c : src,
               ok ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 2)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ bias,
                 float* __restrict__ out, float* __restrict__ lse, int H,
                 int Tq, int Tk, int causal, float scale) {
  using P = FwdPlan<D>;
  constexpr int kLd = P::kLd;
  constexpr int ND = D / 8;  // 8-wide chunks of the head dim
  extern __shared__ __align__(16) float smem[];
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kTile;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;
  // causal: key tiles at or past the last query row + 1 are fully masked
  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  const int tiles = (k_end + kTile - 1) / kTile;

  load_tile_async<D>(smem, q + static_cast<size_t>(bh) * Tq * D, q0, Tq);
  if (tiles > 0) {
    load_tile_async<D>(smem + P::kTileFloats, kb, 0, Tk);
    load_tile_async<D>(smem + 2 * P::kTileFloats, vb, 0, Tk);
  }
  cp_commit();
  // this warp's 16 query rows, split at each read (split fragments held
  // in registers for the whole walk would leave too few for the
  // accumulators below)
  const float* qw = smem + 16 * warp * kLd;

  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
  zero(o);

  for (int it = 0; it < tiles; ++it) {
    const int k0 = it * kTile;
    if (it + 1 < tiles) {
      float* nk = smem + (1 + 2 * ((it + 1) & 1)) * P::kTileFloats;
      load_tile_async<D>(nk, kb, k0 + kTile, Tk);
      load_tile_async<D>(nk + P::kTileFloats, vb, k0 + kTile, Tk);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // key tile `it` (and at it = 0 the Q tile) landed
    const float* ks_ = smem + (1 + 2 * (it & 1)) * P::kTileFloats;
    const float* vs = ks_ + P::kTileFloats;

    // S = Q K^T: B(d, key) = K[key][d]
    float s[8][4], s_small[8][4];
    zero(s);
    zero(s_small);
    warp_mma3<ND, 8>(
        s, s_small,
        [&](int kc, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
          a_frag(qw + 8 * kc, kLd, g, t, hi, lo);
        },
        [&](int kc, int nt, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
          const float* p = ks_ + (8 * nt + g) * kLd + 8 * kc + t;
          split_tf32(p[0], hi[0], lo[0]);
          split_tf32(p[4], hi[1], lo[1]);
        });

    // online softmax on the C fragments: this thread holds rows g and
    // g+8, keys k0 + 8j + 2t (+1); the quad of a row reduces by shuffles
    float bj[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t + e;
        bj[j][e] = (bias != nullptr && col < Tk) ? bias[b * Tk + col] : 0.f;
      }
    float alpha[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + 16 * warp + g + 8 * r;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e;
          float x = (s[j][2 * r + e] + s_small[j][2 * r + e]) * scale +
                    bj[j][e];
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
      for (int j = 0; j < 8; ++j)
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

    // O = alpha O + P V, the tile's product from fresh accumulators. P's
    // C fragment holds keys 2t and 2t+1 of each 8-key chunk, where an A
    // fragment wants keys t and t+4; a product over keys may take them in
    // any order, so A's column t is key 2t and column t+4 is key 2t+1,
    // and B's rows follow: b0 = V[2t], b1 = V[2t+1]. P passes from the C
    // to the A layout in registers.
    float pv[ND][4], pv_small[ND][4];
    zero(pv);
    zero(pv_small);
    warp_mma3<8, ND>(
        pv, pv_small,
        [&](int kc, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
          split_tf32(s[kc][0], hi[0], lo[0]);
          split_tf32(s[kc][2], hi[1], lo[1]);
          split_tf32(s[kc][1], hi[2], lo[2]);
          split_tf32(s[kc][3], hi[3], lo[3]);
        },
        [&](int kc, int nt, uint32_t (&hi)[2], uint32_t (&lo)[2]) {
          const float* p = vs + (8 * kc + 2 * t) * kLd + 8 * nt + g;
          split_tf32(p[0], hi[0], lo[0]);
          split_tf32(p[kLd], hi[1], lo[1]);
        });
#pragma unroll
    for (int j = 0; j < ND; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[j][i] = fmaf(o[j][i], alpha[i >> 1], pv[j][i] + pv_small[j][i]);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + 16 * warp + g + 8 * r;
    if (row >= Tq) continue;
    const float l_safe = fmaxf(l[r], 1e-30f);
    float* orow = out + (static_cast<size_t>(bh) * Tq + row) * D;
#pragma unroll
    for (int j = 0; j < ND; ++j)
      *reinterpret_cast<float2*>(orow + 8 * j + 2 * t) =
          make_float2(o[j][2 * r] / l_safe, o[j][2 * r + 1] / l_safe);
    if (t == 0) lse[static_cast<size_t>(bh) * Tq + row] = m[r] + logf(l_safe);
  }
}

// ---------------------------------------------------------- backward dKV --
// One CTA per (key tile, b*h), looping over the query tiles that can see
// it. Score tiles are transposed (rows = keys, columns = queries), as in
// the TPU kernel, so the per-query lse/delta index columns and the
// per-key bias and bias gradient index rows. Shared: Kt, Vt [D][64] (the
// CTA's key tile), Qt, dOt [D][64] and Q, dO [64][D] (the query tile), Ps
// [64][64] (p, then ds, query-major), lse and delta of the query tile.
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 const float* __restrict__ bias, float* __restrict__ dk,
                 float* __restrict__ dv, float* __restrict__ dbias, int H,
                 int Tq, int Tk, int causal, float scale) {
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;
  float* vt = kt + D * kTile;
  float* qt = vt + D * kTile;
  float* dot = qt + D * kTile;
  float* qs = dot + D * kTile;
  float* dos = qs + kTile * D;
  float* ps = dos + kTile * D;
  float* ls = ps + kTile * kTile;
  float* dl = ls + kTile;
  const int bh = blockIdx.y, b = bh / H;
  const int k0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const float* qb = q + qoff * D;
  const float* dob = dout + qoff * D;

  load_rows_t<D>(kt, k + static_cast<size_t>(bh) * Tk * D, k0, Tk);
  load_rows_t<D>(vt, v + static_cast<size_t>(bh) * Tk * D, k0, Tk);
  float bi[4], dk_acc[4][NC], dv_acc[4][NC], db_acc[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    bi[i] = (bias != nullptr && key < Tk) ? bias[b * Tk + key] : 0.f;
    db_acc[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }
  // causal: query tiles wholly before this key tile see none of it
  for (int q0 = causal ? k0 : 0; q0 < Tq; q0 += kTile) {
    __syncthreads();  // the previous query tile is consumed
    load_rows_t<D>(qt, qb, q0, Tq);
    load_rows_t<D>(dot, dob, q0, Tq);
    load_rows<D>(qs, qb, q0, Tq);
    load_rows<D>(dos, dob, q0, Tq);
    if (threadIdx.x < kTile) {
      const int row = q0 + threadIdx.x;
      ls[threadIdx.x] = row < Tq ? lse[qoff + row] : 0.f;
      dl[threadIdx.x] = row < Tq ? delta[qoff + row] : 0.f;
    }
    __syncthreads();
    float p[4][4] = {}, dp[4][4] = {};
    tile_mma<4, D, kTile>(p, kt, qt, ty, tx);   // s^T
    tile_mma<4, D, kTile>(dp, vt, dot, ty, tx);  // (dout v^T)^T
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int row = q0 + 4 * tx + j;
        const bool valid =
            row < Tq && key < Tk && (!causal || row >= key);
        p[i][j] = valid ? expf(p[i][j] * scale + bi[i] - ls[4 * tx + j])
                        : 0.f;
        dp[i][j] = p[i][j] * (dp[i][j] - dl[4 * tx + j]);  // ds^T
        db_acc[i] += dp[i][j];
      }
    }
    store_t(ps, p, ty, tx);
    __syncthreads();
    tile_mma<NC, kTile, D>(dv_acc, ps, dos, ty, tx);  // dv += p^T dout
    __syncthreads();
    store_t(ps, dp, ty, tx);
    __syncthreads();
    tile_mma<NC, kTile, D>(dk_acc, ps, qs, ty, tx);   // dk += ds^T q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + 4 * ty + i;
    const float db = half_warp_sum(db_acc[i]);
    if (key >= Tk) continue;
    const size_t off = (static_cast<size_t>(bh) * Tk + key) * D + NC * tx;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      dk[off + j] = scale * dk_acc[i][j];
      dv[off + j] = dv_acc[i][j];
    }
    if (dbias != nullptr && tx == 0)
      dbias[static_cast<size_t>(bh) * Tk + key] = db;
  }
}

// ----------------------------------------------------------- backward dQ --
// One CTA per (query tile, b*h), looping over the key tiles it sees.
// Shared: Qt, dOt [D][64] (the CTA's query tile), Kt, Vt [D][64] and
// K [64][D] (the key tile), dSt [64][64] (key-major).
template <int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ dout,
                const float* __restrict__ lse,
                const float* __restrict__ delta,
                const float* __restrict__ bias, float* __restrict__ dq, int H,
                int Tq, int Tk, int causal, float scale) {
  constexpr int NC = D / 16;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;
  float* dot = qt + D * kTile;
  float* kt = dot + D * kTile;
  float* vt = kt + D * kTile;
  float* ks = vt + D * kTile;
  float* dst = ks + kTile * D;
  const int bh = blockIdx.y, b = bh / H;
  const int q0 = blockIdx.x * kTile;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const float* kb = k + static_cast<size_t>(bh) * Tk * D;
  const float* vb = v + static_cast<size_t>(bh) * Tk * D;

  load_rows_t<D>(qt, q + qoff * D, q0, Tq);
  load_rows_t<D>(dot, dout + qoff * D, q0, Tq);
  float li[4], di[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    li[i] = row < Tq ? lse[qoff + row] : 0.f;
    di[i] = row < Tq ? delta[qoff + row] : 0.f;
#pragma unroll
    for (int j = 0; j < NC; ++j) acc[i][j] = 0.f;
  }
  const int k_end = causal ? min(Tk, q0 + kTile) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += kTile) {
    __syncthreads();  // the previous key tile is consumed
    load_rows_t<D>(kt, kb, k0, Tk);
    load_rows_t<D>(vt, vb, k0, Tk);
    load_rows<D>(ks, kb, k0, Tk);
    __syncthreads();
    float p[4][4] = {}, dp[4][4] = {};
    tile_mma<4, D, kTile>(p, qt, kt, ty, tx);   // s
    tile_mma<4, D, kTile>(dp, dot, vt, ty, tx);  // dout v^T
    float bj[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = k0 + 4 * tx + j;
      bj[j] = (bias != nullptr && col < Tk) ? bias[b * Tk + col] : 0.f;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + 4 * tx + j;
        const bool valid =
            row < Tq && col < Tk && (!causal || row >= col);
        const float pij =
            valid ? expf(p[i][j] * scale + bj[j] - li[i]) : 0.f;
        p[i][j] = pij * (dp[i][j] - di[i]);  // ds
      }
    }
    store_t(dst, p, ty, tx);
    __syncthreads();
    tile_mma<NC, kTile, D>(acc, dst, ks, ty, tx);  // dq += ds k
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= Tq) continue;
    float* orow = dq + (qoff + row) * D + NC * tx;
#pragma unroll
    for (int j = 0; j < NC; ++j) orow[j] = scale * acc[i][j];
  }
}

// shared bytes of each kernel at head dim D
constexpr size_t dkv_smem(int D) {
  return sizeof(float) * (6 * D * kTile + kTile * kTile + 2 * kTile);
}
constexpr size_t dq_smem(int D) {
  return sizeof(float) * (5 * D * kTile + kTile * kTile);
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

template <int D>
int launch_fwd(const float* q, const float* k, const float* v,
               const float* bias, float* out, float* lse, int BH, int H,
               int Tq, int Tk, int causal, float scale, cudaStream_t st) {
  static bool ready = false;
  const size_t smem = FwdPlan<D>::kSmem;
  if (int rc = allow_smem(flash_fwd_kernel<D>, smem, &ready)) return rc;
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) |
                         reinterpret_cast<uintptr_t>(out);
  if (ptrs % 16 != 0) return static_cast<int>(cudaErrorMisalignedAddress);
  const dim3 grid((Tq + kTile - 1) / kTile, BH);
  flash_fwd_kernel<D><<<grid, kFwdThreads, smem, st>>>(
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
  const size_t smem = dkv_smem(D);
  if (int rc = allow_smem(flash_dkv_kernel<D>, smem, &ready)) return rc;
  const dim3 grid((Tk + kTile - 1) / kTile, BH);
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
  const size_t smem = dq_smem(D);
  if (int rc = allow_smem(flash_dq_kernel<D>, smem, &ready)) return rc;
  const dim3 grid((Tq + kTile - 1) / kTile, BH);
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
