// Flash attention backward in bf16 and f16, for NVIDIA Hopper (sm_90a):
// the 16-bit twins of csrc/flash_attention.cu's backward. The 16-bit
// forward (K6, mxnet_tpu/ops/flash_attention.py:89 _fwd_kernel) is
// csrc/flash_fwd_lp_sm90.cu (TMA and wgmma); these kernels read its lse.
//
// Replaces the TPU kernels in mxnet_tpu/ops/flash_attention.py on their
// native-rate path (16-bit operands, `_prec` None, f32 accumulation):
//   K7a _dkv_kernel   (flash_dkv_lp_kernel: dK, dV and the per-head bias
//                      gradient of one key tile)
//   K7b _dq_kernel    (flash_dq_lp_kernel: dQ of one query tile)
//
// What they compute (q/k/v/out/dout [B*H, T, D] row-major in T, one of
// __nv_bfloat16 or __half; bias, lse, delta and dbias f32):
//   s   = q k^T * scale + bias[b, key], f32   (bias optional, (B, Tk))
//   causal: s = -1e30 where query row < key col (absolute positions, as
//           the TPU kernel masks them; key tiles wholly above the diagonal
//           are skipped)
//   backward, from the saved lse and delta = rowsum(dout * out):
//            p = exp(s - lse) (0 where causal drops the pair),
//            dv = T(p)^T dout, ds = p * (dout v^T - delta),
//            dk = scale * T(ds)^T q, dq = scale * T(ds) k (the TPU
//            kernels' `lp(pT)`, `lp(dsT)`, :274-276, :311-312), dbias =
//            colsum(ds) from the unrounded f32 ds
// Keys past Tk and queries past Tq take no part: the kernels mask the
// ragged edge themselves (zero-filled tiles, p = 0) and need no padded
// copy.
//
// What bounds them on the card: operations. At BERT-base shapes (B=8,
// H=12, T=512, D=64) the dK/dV kernel does ~12.9 GFLOP (four products
// per (query, key) pair: S^T, dV, dP^T, dK) and the dQ kernel ~9.7 (S,
// dP, dQ), against ~32-38 MB of 16-bit q/k/v/dout: ~10-13 us at the 989
// TFLOP/s dense bf16/f16 rate, ~10-11 us of bytes.
//
// Every product is one pass of mma.sync.aligned.m16n8k16 with f32
// accumulators: the operands are already 16-bit, as on the TPU's
// native-rate path, so there is no split (the f32 kernels' split-TF32
// runs three passes). The structure is the f32 kernels': one CTA of 4
// warps per (row tile, b*h); a tile is 64 rows, or 32 at D = 256, where
// two warps share each 16 rows and split the head dim of the output
// products: registers would not take 64-row tiles at D = 256, where dK
// and dV of 16 rows x 256 columns are 256 f32 accumulators a thread. Each
// warp walks the other operand's tiles through a 2-stage cp.async ring,
// carrying its accumulators in registers:
//   dQ: a query tile; Q and dO stay in shared memory, the ring carries K
//     and V; it walks the latest query tiles (the longest causal walks)
//     first.
//   dK/dV: a key tile; K and V stay in shared memory, the ring carries
//     Q, dO and the tile's lse and delta; scores are transposed (rows =
//     keys), as in the TPU kernel, so the per-key bias and bias gradient
//     are per row and lse/delta per column.
// Every tile row is padded to D + 8 elements (16 bytes), so the 8 row
// addresses of each ldmatrix hit distinct banks. Operands are read with
// ldmatrix: as they lie for the B operand of a score product (S = A B^T,
// B's rows are the tile's rows) and with .trans for that of an output
// product (O = P B, B's rows are the contracted index). P and dS never
// leave registers: m16n8k16's C fragments of two neighbouring 8-column
// chunks are exactly the A fragment of one 16-wide k chunk, so each
// passes from C to A by rounding pairs into 16-bit registers, where the
// TPU kernel rounds them. Each output element is written by one thread,
// once, with no atomics, so the results are deterministic.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;       // 4 warps
constexpr int kWarps = kThreads / 32;

// The 16-bit element types: rounding a pair of f32 values (to nearest
// even, as torch's and JAX's casts) into one 32-bit register, low half
// first, and c += a * b, one m16n8k16 MMA with f32 accumulation.
// Fragments (g = lane / 4, t = lane % 4): a0 (g, 2t..2t+1), a1 (g+8,
// 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..) of A (16 x 16); b0 (2t..2t+1,
// g), b1 (2t+8.., g) of B (16 x 8, k x n); c0 (g, 2t), c1 (g, 2t+1), c2
// (g+8, 2t), c3 (g+8, 2t+1) of C (16 x 8). Not volatile, so the compiler
// may interleave independent MMAs.
template <typename T>
struct Lp;

template <>
struct Lp<__nv_bfloat16> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

template <>
struct Lp<__half> {
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    __half2 h = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&h);
  }
  static __device__ __forceinline__ void mma(float (&c)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
};

// The tiles of head dim D: kRows query or key rows of 16-bit elements,
// each padded to D + 8; warp w owns rows 16 (w % kRowWarps) .. + 15 and
// output columns kCols (w / kRowWarps) .. + kCols - 1. Each kernel's
// shared bytes: dK/dV: K, V + 2 x (Q, dO, lse, delta); dQ: Q, dO + 2 x
// (K, V). At D = 64: 55, 54 KB; at D = 256 (32 rows): 99, 99 KB; two CTAs
// an SM at every D.
template <int D>
struct Tiles {
  static constexpr int kRows = D > 128 ? 32 : 64;
  static constexpr int kRowWarps = kRows / 16;
  static constexpr int kCols = D / (kWarps / kRowWarps);
  static constexpr int kLd = D + 8;
  static constexpr int kElems = kRows * kLd;
  static constexpr int kTileBytes = 2 * kElems;
  static constexpr int kDkvStageBytes = 2 * kTileBytes + 8 * kRows;
  static constexpr size_t kDkvSmem = 2 * kTileBytes + 2 * kDkvStageBytes;
  static constexpr size_t kDqSmem = 6 * kTileBytes;
};

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

// four 8 x 8 matrices of 16-bit elements from shared memory, lanes 8i ..
// 8i + 7 giving the row addresses of matrix i: register i of lane l
// holds row l / 4, columns 2 (l % 4) and 2 (l % 4) + 1 of matrix i, or
// with .trans rows 2 (l % 4) and 2 (l % 4) + 1 of column l / 4
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) c[j][i] = 0.f;
}

// A score tile S = A B^T of one warp (16 x kRows, NK = kRows / 8 C
// fragments, from zero): A the warp's 16 rows at `a`, B the kRows rows at
// `b`, both padded tiles read as they lie (B(d, n) = b[n][d]). The A
// fragment of the 16 x 16 block at column 16 kc is one ldmatrix (lanes 0
// .. 15 rows 0 .. 15 at column 0, lanes 16 .. 31 the same rows at column
// 8); B's for two 8-row chunks is another (matrices: rows 0-7 at columns
// 0 and 8, rows 8-15 at columns 0 and 8). C fragment j holds rows g and
// g+8, columns 8j + 2t and 8j + 2t + 1.
template <typename T, int D>
__device__ __forceinline__ void score_mma(
    const T* a, const T* b, int lane, float (&s)[Tiles<D>::kRows / 8][4]) {
  constexpr int kLd = Tiles<D>::kLd, NK = Tiles<D>::kRows / 8;
  const T* ap = a + (lane & 15) * kLd + (lane >> 4) * 8;
  const T* bp = b + ((lane & 7) + ((lane >> 4) << 3)) * kLd +
                ((lane >> 3) & 1) * 8;
  zero(s);
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, ap + 16 * kc);
#pragma unroll
    for (int np = 0; np < NK / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4(bf, bp + 16 * np * kLd + 16 * kc);
      Lp<T>::mma(s[2 * np], af, bf[0], bf[1]);
      Lp<T>::mma(s[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// o += T(P) B of one warp: P (16 x kRows) in the C layout of score_mma,
// rounded to T pair by pair as it becomes the A fragment (chunks 2kc and
// 2kc + 1 of C are A's 16-wide k chunk kc), and B the kCols columns at
// `b` of a padded kRows x D tile, whose rows are the contracted index:
// read with ldmatrix.trans (matrices: rows 0-7 and 8-15 at column 0,
// then the same at column 8). o holds NC = kCols / 8 C fragments.
template <typename T, int D>
__device__ __forceinline__ void out_mma(
    const float (&p)[Tiles<D>::kRows / 8][4], const T* b, int lane,
    float (&o)[Tiles<D>::kCols / 8][4]) {
  constexpr int kLd = Tiles<D>::kLd, NK = Tiles<D>::kRows / 8;
  constexpr int NC = Tiles<D>::kCols / 8;
  const T* bp = b + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kLd +
                (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < NK / 2; ++kc) {
    uint32_t af[4];
    af[0] = Lp<T>::pack(p[2 * kc][0], p[2 * kc][1]);
    af[1] = Lp<T>::pack(p[2 * kc][2], p[2 * kc][3]);
    af[2] = Lp<T>::pack(p[2 * kc + 1][0], p[2 * kc + 1][1]);
    af[3] = Lp<T>::pack(p[2 * kc + 1][2], p[2 * kc + 1][3]);
#pragma unroll
    for (int np = 0; np < NC / 2; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, bp + 16 * kc * kLd + 16 * np);
      Lp<T>::mma(o[2 * np], af, bf[0], bf[1]);
      Lp<T>::mma(o[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// rows row0 .. row0 + kRows - 1 of a [rows, D] matrix of T into a
// padded tile by 16-byte cp.async; rows past nrows are zero-filled
template <typename T, int D>
__device__ __forceinline__ void load_tile_async(T* dst,
                                                const T* __restrict__ src,
                                                int row0, int nrows) {
  constexpr int V = D / 8;
  for (int f = threadIdx.x; f < Tiles<D>::kRows * V; f += kThreads) {
    const int r = f / V, c = f % V;
    const bool ok = row0 + r < nrows;
    cp_async16(dst + r * Tiles<D>::kLd + 8 * c,
               ok ? src + static_cast<size_t>(row0 + r) * D + 8 * c : src,
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

// two f32 values rounded into T at p (4-byte aligned: an even column)
template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = Lp<T>::pack(a, b);
}

// ---------------------------------------------------------- backward dKV --
// K7a: one CTA per (b*h, key tile); warp w owns keys warp_row0 .. + 15
// and walks the query tiles that can see them, with its columns of dK and
// dV (16 x kCols each) and the bias gradient of its rows in registers.
// Shared: the K and V tiles (the A operands of S^T = K Q^T and dP^T = V
// dO^T), then a 2-stage ring of (Q tile, dO tile, lse and delta of the
// tile's queries); Q and dO are read as they lie as the B operands of the
// score products, and with .trans as those of dV += T(P^T) dO and dK +=
// T(dS^T) Q.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dkv_lp_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ bias, T* __restrict__ dk,
                    T* __restrict__ dv, float* __restrict__ dbias, int H,
                    int Tq, int Tk, int causal, float scale) {
  constexpr int kLd = Tiles<D>::kLd, kTe = Tiles<D>::kElems;
  constexpr int kStage = Tiles<D>::kDkvStageBytes, kRows = Tiles<D>::kRows;
  constexpr int NK = kRows / 8, NC = Tiles<D>::kCols / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  unsigned char* ring = smem_raw + 2 * Tiles<D>::kTileBytes;
  const int bh = blockIdx.x, b = bh / H;
  const int k0 = blockIdx.y * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp_row0<D>(warp), c0 = warp_col0<D>(warp);
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const size_t koff = static_cast<size_t>(bh) * Tk;
  const T* qb = q + qoff * D;
  const T* dob = dout + qoff * D;
  // causal: query tiles wholly before this key tile see none of it
  const int q_begin = causal ? k0 : 0;
  const int tiles = q_begin < Tq ? (Tq - q_begin + kRows - 1) / kRows : 0;

  // stage s: the Q tile, the dO tile, then kRows floats of lse and of
  // delta (one float per thread: threads 0..kRows-1 lse, kRows..2kRows-1
  // delta)
  auto stage_q = [&](int s) {
    return reinterpret_cast<T*>(ring + s * kStage);
  };
  auto stage_rows = [&](int s) {
    return reinterpret_cast<float*>(ring + s * kStage +
                                    2 * Tiles<D>::kTileBytes);
  };
  auto load_stage = [&](int s, int q0) {
    T* st = stage_q(s);
    load_tile_async<T, D>(st, qb, q0, Tq);
    load_tile_async<T, D>(st + kTe, dob, q0, Tq);
    if (2 * kRows >= kThreads || threadIdx.x < 2 * kRows) {
      const int i = threadIdx.x % kRows, row = q0 + i;
      const int which = threadIdx.x / kRows;
      const float* src = (which == 0 ? lse : delta) + qoff;
      cp_async4(stage_rows(s) + which * kRows + i,
                row < Tq ? src + row : src, row < Tq ? 4 : 0);
    }
  };
  load_tile_async<T, D>(smem, k + koff * D, k0, Tk);
  load_tile_async<T, D>(smem + kTe, v + koff * D, k0, Tk);
  if (tiles > 0) load_stage(0, q_begin);
  cp_commit();
  const T* kw = smem + r0 * kLd;  // this warp's 16 keys in K and V
  const T* vw = kw + kTe;
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
    const T* qs = stage_q(it & 1);
    const T* dos = qs + kTe;
    const float* ls = stage_rows(it & 1);
    const float* dls = ls + kRows;

    // P^T = exp(S^T * scale + bias[key] - lse[query]), S^T = K Q^T: this
    // thread holds keys (rows) g and g+8, queries q0 + 8j + 2t (+1)
    float p[NK][4];
    score_mma<T, D>(kw, qs, lane, p);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, c = 8 * j + 2 * t + (i & 1), row = q0 + c;
        const bool ok =
            row < Tq && key[r] < Tk && (!causal || row >= key[r]);
        p[j][i] = ok ? expf(p[j][i] * scale + bk[r] - ls[c]) : 0.f;
      }
    // dV += T(P^T) dO
    out_mma<T, D>(p, dos + c0, lane, dva);
    // dS^T = P^T * (dP^T - delta[query]), dP^T = V dO^T; the bias
    // gradient sums the f32 dS^T over the queries of each key row
    float ds[NK][4];
    score_mma<T, D>(vw, dos, lane, ds);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        ds[j][i] = p[j][i] * (ds[j][i] - dls[8 * j + 2 * t + (i & 1)]);
        dbs[i >> 1] += ds[j][i];
      }
    // dK += T(dS^T) Q (scaled once, at the end)
    out_mma<T, D>(ds, qs + c0, lane, dka);
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
      store2(dk + off + 8 * j + 2 * t, scale * dka[j][2 * r],
             scale * dka[j][2 * r + 1]);
      store2(dv + off + 8 * j + 2 * t, dva[j][2 * r], dva[j][2 * r + 1]);
    }
    if (dbias != nullptr && t == 0 && c0 == 0) dbias[koff + key[r]] = dbs[r];
  }
}

// ----------------------------------------------------------- backward dQ --
// K7b: one CTA per (b*h, query tile); warp w owns queries warp_row0 ..
// + 15 and walks the key tiles it sees, with its columns of dQ (16 x
// kCols) in registers and lse and delta of its rows. Shared: the Q and dO
// tiles (the A operands of S = Q K^T and dP = dO V^T), then a 2-stage
// ring of (K tile, V tile); K is read as it lies as the B operand of S
// and with .trans as that of dQ += T(dS) K.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 2)
flash_dq_lp_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const float* __restrict__ bias, T* __restrict__ dq,
                   int H, int Tq, int Tk, int causal, float scale) {
  constexpr int kLd = Tiles<D>::kLd, kTe = Tiles<D>::kElems;
  constexpr int kRows = Tiles<D>::kRows, NK = kRows / 8;
  constexpr int NC = Tiles<D>::kCols / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int bh = blockIdx.x, b = bh / H;
  // the last query tiles first: under the causal mask they walk the most
  // key tiles
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = warp_row0<D>(warp), c0 = warp_col0<D>(warp);
  const size_t qoff = static_cast<size_t>(bh) * Tq;
  const T* kb = k + static_cast<size_t>(bh) * Tk * D;
  const T* vb = v + static_cast<size_t>(bh) * Tk * D;
  const float* brow =
      bias == nullptr ? nullptr : bias + static_cast<size_t>(b) * Tk;
  T* ring = smem + 2 * kTe;
  // causal: key tiles at or past the last query row + 1 are fully masked
  const int k_end = causal ? min(Tk, q0 + kRows) : Tk;
  const int tiles = (k_end + kRows - 1) / kRows;

  load_tile_async<T, D>(smem, q + qoff * D, q0, Tq);
  load_tile_async<T, D>(smem + kTe, dout + qoff * D, q0, Tq);
  if (tiles > 0) {
    load_tile_async<T, D>(ring, kb, 0, Tk);
    load_tile_async<T, D>(ring + kTe, vb, 0, Tk);
  }
  cp_commit();
  const T* qw = smem + r0 * kLd;  // this warp's 16 query rows of Q, dO
  const T* dow = qw + kTe;
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
      T* nk = ring + 2 * ((it + 1) & 1) * kTe;
      load_tile_async<T, D>(nk, kb, k0 + kRows, Tk);
      load_tile_async<T, D>(nk + kTe, vb, k0 + kRows, Tk);
    }
    cp_commit();
    cp_wait<1>();
    __syncthreads();  // key tile `it` (and at it = 0 Q and dO) landed
    const T* ks_ = ring + 2 * (it & 1) * kTe;
    const T* vs = ks_ + kTe;

    // P = exp(S * scale + bias[key] - lse[row]), S = Q K^T: this thread
    // holds rows g and g+8, keys k0 + 8j + 2t (+1)
    float p[NK][4], bj[NK][2];
    key_bias(brow, Tk, k0, t, bj);
    score_mma<T, D>(qw, ks_, lane, p);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = i >> 1, e = i & 1, col = k0 + 8 * j + 2 * t + e;
        const bool ok = col < Tk && (!causal || row[r] >= col);
        p[j][i] = ok ? expf(p[j][i] * scale + bj[j][e] - lr[r]) : 0.f;
      }
    // dS = P * (dP - delta[row]), dP = dO V^T
    float ds[NK][4];
    score_mma<T, D>(dow, vs, lane, ds);
#pragma unroll
    for (int j = 0; j < NK; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ds[j][i] = p[j][i] * (ds[j][i] - dr[i >> 1]);
    // dQ += T(dS) K (scaled once, at the end)
    out_mma<T, D>(ds, ks_ + c0, lane, dqa);
    __syncthreads();  // this stage is consumed before it is refilled
  }
  cp_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= Tq) continue;
    T* orow = dq + (qoff + row[r]) * D + c0;
#pragma unroll
    for (int j = 0; j < NC; ++j)
      store2(orow + 8 * j + 2 * t, scale * dqa[j][2 * r],
             scale * dqa[j][2 * r + 1]);
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

// the tiles are copied in 16-byte pieces and written in 4-byte ones
template <typename... Ptr>
bool aligned16(const Ptr*... p) {
  return ((reinterpret_cast<uintptr_t>(p) % 16 == 0) && ...);
}

template <typename T, int D>
int launch_dkv(const void* q, const void* k, const void* v,
               const void* dout, const void* lse, const void* delta,
               const void* bias, void* dk, void* dv, void* dbias, int BH,
               int H, int Tq, int Tk, int causal, float scale,
               cudaStream_t st) {
  static bool ready = false;
  const size_t smem = Tiles<D>::kDkvSmem;
  if (int rc = allow_smem(flash_dkv_lp_kernel<T, D>, smem, &ready))
    return rc;
  if (!aligned16(q, k, v, dout, dk, dv))
    return static_cast<int>(cudaErrorMisalignedAddress);
  // b*h fastest: every CTA of key tile 0 (the longest causal walk) first
  constexpr int kRows = Tiles<D>::kRows;
  const dim3 grid(BH, (Tk + kRows - 1) / kRows);
  flash_dkv_lp_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<T*>(dk),
      static_cast<T*>(dv), static_cast<float*>(dbias), H, Tq, Tk, causal,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dq(const void* q, const void* k, const void* v,
              const void* dout, const void* lse, const void* delta,
              const void* bias, void* dq, int BH, int H, int Tq, int Tk,
              int causal, float scale, cudaStream_t st) {
  static bool ready = false;
  const size_t smem = Tiles<D>::kDqSmem;
  if (int rc = allow_smem(flash_dq_lp_kernel<T, D>, smem, &ready))
    return rc;
  if (!aligned16(q, k, v, dout, dq))
    return static_cast<int>(cudaErrorMisalignedAddress);
  constexpr int kRows = Tiles<D>::kRows;
  const dim3 grid(BH, (Tq + kRows - 1) / kRows);
  flash_dq_lp_kernel<T, D><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const float*>(bias), static_cast<T*>(dq), H, Tq, Tk,
      causal, scale);
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
