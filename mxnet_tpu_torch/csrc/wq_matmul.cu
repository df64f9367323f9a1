// Weight-only quantised matmul for NVIDIA Hopper (sm_90a):
//   out[t, c] = (sum_k x[t, k] * qw[k, c]) * s[c]
// x f32, bf16 or f16 [T, K] (x_dtype 0, 1, 2); qw int8 or fp8-e4m3 [K,
// N]; s f32 [N] (one scale per output column); out f32 [T, N]. The TPU
// kernel widens any float x to f32 (`x_ref[...].astype(jnp.float32)`);
// so does this one, where it reads x's fragments.
//
// Replaces the TPU kernel K3, _wq_matmul_kernel in
// mxnet_tpu/ops/quantization.py, whose point is that the f32 weight
// matrix never exists in device memory: only the 1-byte weights are read.
//
// What bounds it on the card. K*N weight bytes against 2*T*K*N products,
// each product done as two TF32 tensor-core passes (below): up to T ~ 10
// the bytes (3.35 TB/s), past that the split-TF32 operations (495
// TFLOP/s over 2 passes).
//
// Why the weights need no split. TF32 keeps 11 significant bits. An int8
// weight needs at most 7 and an e4m3 weight 4, so each weight widens to
// f32 and passes to the tensor cores exactly. Only x is split, once per
// fragment, into hi = rna_tf32(x) and lo = rna_tf32(x - hi) (x = hi + lo
// to ~2^-22 relative), and each fragment pair is two MMAs, lo*w then
// hi*w. A bf16 or f16 x is exact in TF32 (8 and 11 significant bits), so
// it needs no split: its fragments are the widened values, one pass. The
// tensor cores truncate each sum into their f32 accumulator,
// so each 32-deep step's MMAs go to a fresh accumulator that f32 adds
// fold into the running one: f32 accuracy (the tolerance is 1e-5 of the
// output's magnitude) at the tensor cores' rate.
//
// Design (one template for every T):
// - A CTA of 4 warps owns a kBM x kBN output tile and one K slice: kBM =
//   16 when T <= 16 (a decode batch wastes few rows), else 64; kBN = 64,
//   or 256 at T <= 16 when N gives every SM such a tile (the LM head), so
//   that a CTA reads 256 contiguous bytes of each weight row. It walks
//   the slice in 32-deep steps through a ring of shared-memory stages (6
//   at 16 x 64, 4 otherwise) filled by cp.async: each stage holds the x
//   tile (f32, rows padded for conflict-free fragment reads) and the 32 x
//   kBN weight bytes, neighbouring threads copying neighbouring 16-byte
//   chunks, so 3 to 5 steps of weights are in flight per CTA while one
//   is multiplied. A 16-bit x tile is staged as it lies (rows of kBK + 8
//   elements, 16-byte copies where K and x allow, else plain loads).
// - mma.sync m16n8k8 TF32. The weight columns are permuted so that the
//   eight bytes a thread needs for the B fragments of all eight 8-column
//   MMA tiles of its warp's 64 columns lie together: one 8-byte shared
//   load per row feeds eight MMAs. The 4 warps split the tile along M (16
//   rows each at kBM = 64), along N (64 columns each at kBN = 256), or
//   else along K (each takes one of a step's four 8-deep slices).
// - Split-K in one launch. Where the tiles are too few for the 132 SMs
//   (every 768-wide N), the `cluster` CTAs that share a tile each take a
//   K slice and form a thread-block cluster (<= 8). Each writes its warp
//   partials to its own shared memory; after a cluster barrier each CTA
//   sums its share of the tile over every CTA's partials through
//   distributed shared memory, in rank order, applies the scale and
//   stores: deterministic, no atomics, no scratch tensor, no second
//   kernel. The plan (kBM, kBN, cluster, slice depth) comes from the
//   caller (ops/quantization.py wq_plan).
// - Ragged edges: rows past T and K past the slice are zero-filled by
//   cp.async's source size; columns past N are computed from whatever
//   bytes lie there and never stored. When N is not a multiple of 16 (the
//   LM head's 50257) weight rows are not 16-byte aligned: each row of a
//   stage then holds the aligned window 16 bytes wider than the tile's,
//   and the fragment reads shift the bytes into place.
#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kBK = 32;        // K rows per ring stage; K slices are whole
                               // steps (ops/quantization.py wq_plan)
constexpr int kXLd = kBK + 4;  // x stage row stride (floats)
// the same for a 16-bit x (elements): 80-byte rows, so the fragment
// reads of a warp's 8 rows fall in distinct banks
constexpr int kXLd16 = kBK + 8;
constexpr int kXF32 = 0, kXBf16 = 1, kXF16 = 2;  // x_dtype

// A CTA's tile is kBM x 64*kWN: kBM/16 warps along M, kWN along N (64
// columns each) and the rest along K (each takes some of a step's four
// 8-deep slices; their partials are summed in the epilogue).
template <int kBM, int kWN, bool kAligned>
struct Plan {
  static constexpr int kBN = 64 * kWN;
  static constexpr int kWarpsM = kBM / 16;
  static constexpr int kWarpsK = 4 / (kWarpsM * kWN);
  static_assert(kWarpsK >= 1 && kWarpsM * kWN * kWarpsK == 4, "4 warps");
  static constexpr int kStages = kBM == 16 && kWN == 1 ? 6 : 4;
  // weight bytes per stage row: the tile's columns, or (N not a multiple
  // of 16) the 16-byte-aligned window around them
  static constexpr int kWLd = kAligned ? kBN : kBN + 16;
  static constexpr int kXBytes = kBM * kXLd * 4;
  static constexpr int kStageBytes = kXBytes + kBK * kWLd;
  static constexpr int kRedLd = kBN + 4;  // partial-tile row stride
  static constexpr int kRedBytes = kWarpsK * kBM * kRedLd * 4;
  static constexpr int kSmem = kStages * kStageBytes > kRedBytes
                                   ? kStages * kStageBytes : kRedBytes;
  static_assert(kXBytes % 16 == 0 && kStageBytes % 16 == 0, "alignment");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(bytes) : "memory");
}

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

// c += a * b, one m16n8k8 TF32 MMA with f32 accumulation (not volatile,
// so the compiler may interleave independent MMAs)
__device__ __forceinline__ void mma_tf32(float (&c)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the 8 weight bytes of columns c0 + 8g .. c0 + 8g + 7 of the tile (c0 =
// 64 * the warp's N index) in stage row r, global row gk; rows are kWLd
// bytes apart
template <bool kAligned, int kWLd>
__device__ __forceinline__ uint2 row_bytes(const unsigned char* w, int r,
                                           int gk, int N, int n0, int c0,
                                           int g) {
  if (kAligned)
    return *reinterpret_cast<const uint2*>(w + r * kWLd + c0 + 8 * g);
  const unsigned o = ((static_cast<unsigned>(gk) * static_cast<unsigned>(N)
                       + static_cast<unsigned>(n0)) & 15u) + c0 + 8u * g;
  const uint32_t* p =
      reinterpret_cast<const uint32_t*>(w + r * kWLd) + (o >> 2);
  const unsigned sh = (o & 3u) * 8u;
  const uint32_t w0 = p[0], w1 = p[1], w2 = p[2];
  return make_uint2(__funnelshift_r(w0, w1, sh), __funnelshift_r(w1, w2, sh));
}

// widen 8 weight bytes exactly to f32 (TF32-exact) bit patterns
__device__ __forceinline__ void widen(uint2 v, uint32_t (&f)[8], int8_t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    f[j] = __float_as_uint(static_cast<float>(
        static_cast<int8_t>(v.x >> (8 * j))));
    f[4 + j] = __float_as_uint(static_cast<float>(
        static_cast<int8_t>(v.y >> (8 * j))));
  }
}

__device__ __forceinline__ void widen(uint2 v, uint32_t (&f)[8],
                                      __nv_fp8_e4m3) {
#pragma unroll
  for (int h = 0; h < 4; ++h) {
    const uint32_t word = h < 2 ? v.x : v.y;
    const __nv_fp8x2_storage_t pair =
        static_cast<__nv_fp8x2_storage_t>(word >> (16 * (h & 1)));
    const float2 p = __half22float2(
        __half2(__nv_cvt_fp8x2_to_halfraw2(pair, __NV_E4M3)));
    f[2 * h] = __float_as_uint(p.x);
    f[2 * h + 1] = __float_as_uint(p.y);
  }
}

// element i of a 16-bit x tile, widened exactly
__device__ __forceinline__ float widen_x(const uint16_t* x, int i,
                                         int x_dtype) {
  const uint16_t b = x[i];
  return x_dtype == kXBf16 ? __uint_as_float(static_cast<uint32_t>(b) << 16)
                           : __half2float(__ushort_as_half(b));
}

template <typename WT, int kBM, int kWN, bool kAligned>
__global__ void __launch_bounds__(kThreads)
wq_mma_kernel(const void* __restrict__ x_arg,
              const unsigned char* __restrict__ qw,
              const float* __restrict__ s, float* __restrict__ out, int T,
              int K, int N, int k_per_slice, int x_vec, int x_dtype) {
  using P = Plan<kBM, kWN, kAligned>;
  constexpr int kBN = P::kBN, kRedLd = P::kRedLd;
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_per_slice;
  const int k_end = min(K, k_begin + k_per_slice);
  const int steps = (k_end - k_begin + kBK - 1) / kBK;
  const size_t w_total = static_cast<size_t>(K) * N;

  const float* x = static_cast<const float*>(x_arg);
  const uint16_t* x16 = static_cast<const uint16_t*>(x_arg);
  auto load = [&](int slot, int step) {
    const int k0 = k_begin + step * kBK;
    unsigned char* st = smem + slot * P::kStageBytes;
    float* xd = reinterpret_cast<float*>(st);
    uint16_t* xd16 = reinterpret_cast<uint16_t*>(st);
    if (x_dtype != kXF32 && x_vec) {
      for (int c = tid; c < kBM * (kBK / 8); c += kThreads) {
        const int r = c / (kBK / 8), kc = 8 * (c % (kBK / 8));
        const int gm = m0 + r, gk = k0 + kc;
        const int n = gm < T ? min(8, max(0, k_end - gk)) : 0;
        cp_async16(xd16 + r * kXLd16 + kc,
                   n ? x16 + static_cast<size_t>(gm) * K + gk : x16, 2 * n);
      }
    } else if (x_dtype != kXF32) {
      // odd K or an unaligned x: plain loads, seen by every thread after
      // the barrier that precedes this stage's use
      for (int c = tid; c < kBM * kBK; c += kThreads) {
        const int r = c / kBK, kc = c % kBK;
        const int gm = m0 + r, gk = k0 + kc;
        xd16[r * kXLd16 + kc] =
            gm < T && gk < k_end ? x16[static_cast<size_t>(gm) * K + gk]
                                 : static_cast<uint16_t>(0);
      }
    } else if (x_vec) {
      for (int c = tid; c < kBM * (kBK / 4); c += kThreads) {
        const int r = c / (kBK / 4), kc = 4 * (c % (kBK / 4));
        const int gm = m0 + r, gk = k0 + kc;
        const int n = gm < T ? min(4, max(0, k_end - gk)) : 0;
        cp_async16(xd + r * kXLd + kc,
                   n ? x + static_cast<size_t>(gm) * K + gk : x, 4 * n);
      }
    } else {
      for (int c = tid; c < kBM * kBK; c += kThreads) {
        const int r = c / kBK, kc = c % kBK;
        const int gm = m0 + r, gk = k0 + kc;
        const bool ok = gm < T && gk < k_end;
        cp_async4(xd + r * kXLd + kc,
                  ok ? x + static_cast<size_t>(gm) * K + gk : x, ok ? 4 : 0);
      }
    }
    unsigned char* wd = st + P::kXBytes;
    constexpr int kChunks = P::kWLd / 16;
    for (int c = tid; c < kBK * kChunks; c += kThreads) {
      const int r = c / kChunks, i = c % kChunks;
      const int gk = k0 + r;
      size_t off = 0;
      int n = 0;
      if (gk < k_end) {
        const size_t row = static_cast<size_t>(gk) * N + n0;
        off = (kAligned ? row : row & ~static_cast<size_t>(15)) + 16 * i;
        const size_t left = off < w_total ? w_total - off : 0;
        n = left < 16 ? static_cast<int>(left) : 16;
      }
      cp_async16(wd + r * P::kWLd + 16 * i, n ? qw + off : qw, n);
    }
  };

  float acc[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
  const int wm = warp % P::kWarpsM, wn = (warp / P::kWarpsM) % kWN,
            wk = warp / (P::kWarpsM * kWN);

#pragma unroll
  for (int st = 0; st < P::kStages - 1; ++st) {
    if (st < steps) load(st, st);
    cp_commit();
  }
  for (int step = 0; step < steps; ++step) {
    cp_wait<P::kStages - 2>();
    __syncthreads();  // this step's stage landed; the last one is consumed
    const int nxt = step + P::kStages - 1;
    if (nxt < steps) load(nxt % P::kStages, nxt);
    cp_commit();
    const unsigned char* st = smem + (step % P::kStages) * P::kStageBytes;
    const float* xa = reinterpret_cast<const float*>(st) + 16 * wm * kXLd;
    const uint16_t* xa16 =
        reinterpret_cast<const uint16_t*>(st) + 16 * wm * kXLd16;
    const unsigned char* wb = st + P::kXBytes;
    const int k0 = k_begin + step * kBK;
    // this step's products go to a fresh accumulator, folded into acc by
    // f32 adds below: the tensor cores truncate each sum into their
    // accumulator, so no chain runs longer than one step's 2-8 MMAs
    float part[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[j][e] = 0.f;
#pragma unroll
    for (int i = 0; i < kBK / 8 / P::kWarpsK; ++i) {
      const int kk = 8 * (wk + i * P::kWarpsK);
      uint32_t ah[4], al[4];
      if (x_dtype == kXF32) {
        split_tf32(xa[gid * kXLd + kk + tig], ah[0], al[0]);
        split_tf32(xa[(gid + 8) * kXLd + kk + tig], ah[1], al[1]);
        split_tf32(xa[gid * kXLd + kk + tig + 4], ah[2], al[2]);
        split_tf32(xa[(gid + 8) * kXLd + kk + tig + 4], ah[3], al[3]);
      } else {
        // exact in TF32: hi is the value, lo is zero
#pragma unroll
        for (int e = 0; e < 4; ++e)
          ah[e] = __float_as_uint(widen_x(
              xa16, (gid + 8 * (e & 1)) * kXLd16 + kk + tig + 4 * (e >> 1),
              x_dtype));
      }
      uint32_t b0[8], b1[8];
      widen(row_bytes<kAligned, P::kWLd>(wb, kk + tig, k0 + kk + tig, N, n0,
                                         64 * wn, gid),
            b0, WT());
      widen(row_bytes<kAligned, P::kWLd>(wb, kk + tig + 4, k0 + kk + tig + 4,
                                         N, n0, 64 * wn, gid),
            b1, WT());
      // pass-major (the eight accumulators' MMAs are independent), the
      // small terms first
      if (x_dtype == kXF32) {
#pragma unroll
        for (int j = 0; j < 8; ++j) mma_tf32(part[j], al, b0[j], b1[j]);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) mma_tf32(part[j], ah, b0[j], b1[j]);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] += part[j][e];
  }
  cp_wait<0>();
  __syncthreads();  // the ring is consumed: reuse it for the partials

  // MMA tile j, fragment column c is output column n0 + 64wn + 8c + j,
  // so a thread's acc[0..7][i] are 8 consecutive columns of one row
  float* red = reinterpret_cast<float*>(smem) + wk * kBM * kRedLd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* rp = red + (16 * wm + gid + 8 * h) * kRedLd + 64 * wn + 16 * tig;
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int q = 0; q < 2; ++q)
        *reinterpret_cast<float4*>(rp + 8 * e + 4 * q) = make_float4(
            acc[4 * q][2 * h + e], acc[4 * q + 1][2 * h + e],
            acc[4 * q + 2][2 * h + e], acc[4 * q + 3][2 * h + e]);
  }

  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();  // every CTA's partials are written
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr int kGroups = kBM * kBN / 4;  // float4s of the tile
  const int per = kGroups / ranks;
  for (int g = rank * per + tid; g < (rank + 1) * per; g += kThreads) {
    const int r = g / (kBN / 4), col = 4 * (g % (kBN / 4));
    float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int q = 0; q < ranks; ++q) {  // K slices in order
      const float* base =
          cluster.map_shared_rank(reinterpret_cast<float*>(smem), q);
#pragma unroll
      for (int w = 0; w < P::kWarpsK; ++w) {
        const float4 v = *reinterpret_cast<const float4*>(
            base + (w * kBM + r) * kRedLd + col);
        sum.x += v.x;
        sum.y += v.y;
        sum.z += v.z;
        sum.w += v.w;
      }
    }
    const int gm = m0 + r;
    if (gm >= T) continue;
    float* orow = out + static_cast<size_t>(gm) * N;
    const float v[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int gn = n0 + col + e;
      if (gn < N) orow[gn] = v[e] * s[gn];
    }
  }
  cluster.sync();  // no CTA leaves while another reads its partials
}

template <typename WT, int kBM, int kWN, bool kAligned>
int launch(const void* x, const unsigned char* qw, const float* s,
           float* out, int T, int K, int N, int cluster, int k_per_slice,
           int x_vec, int x_dtype, cudaStream_t st) {
  using P = Plan<kBM, kWN, kAligned>;
  auto kernel = wq_mma_kernel<WT, kBM, kWN, kAligned>;
  static bool ready = false;
  if (!ready) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kSmem);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    ready = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((N + P::kBN - 1) / P::kBN, (T + kBM - 1) / kBM,
                     cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = P::kSmem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = cluster;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, x, qw, s, out, T,
                                            K, N, k_per_slice, x_vec,
                                            x_dtype);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}

template <typename WT, int kBM, int kWN>
int launch_aligned(const void* x, const unsigned char* qw, const float* s,
                   float* out, int T, int K, int N, int cluster,
                   int k_per_slice, int x_vec, int x_dtype,
                   cudaStream_t st) {
  return N % 16 == 0
             ? launch<WT, kBM, kWN, true>(x, qw, s, out, T, K, N, cluster,
                                          k_per_slice, x_vec, x_dtype, st)
             : launch<WT, kBM, kWN, false>(x, qw, s, out, T, K, N, cluster,
                                           k_per_slice, x_vec, x_dtype, st);
}

template <typename WT>
int run(const void* x, const void* qw, const void* s, void* out, int T,
        int K, int N, int m_tile, int n_tile, int cluster, int k_per_slice,
        int x_dtype, void* stream) {
  const long long depth = static_cast<long long>(k_per_slice);
  const bool tile_ok = (m_tile == 16 && (n_tile == 64 || n_tile == 256)) ||
                       (m_tile == 64 && n_tile == 64);
  if (T <= 0 || K <= 0 || N <= 0 || !tile_ok ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != 8) ||
      depth <= 0 || depth % kBK != 0 || cluster * depth < K ||
      (cluster - 1) * depth >= K || x_dtype < kXF32 || x_dtype > kXF16)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(qw) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const unsigned char* w = static_cast<const unsigned char*>(qw);
  const float* sf = static_cast<const float*>(s);
  float* o = static_cast<float*>(out);
  // 16-byte copies of x: 4 f32 or 8 16-bit elements
  const int x_vec = K % (x_dtype == kXF32 ? 4 : 8) == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (m_tile == 64)
    return launch_aligned<WT, 64, 1>(x, w, sf, o, T, K, N, cluster,
                                     k_per_slice, x_vec, x_dtype, st);
  if (n_tile == 256)
    return launch_aligned<WT, 16, 4>(x, w, sf, o, T, K, N, cluster,
                                     k_per_slice, x_vec, x_dtype, st);
  return launch_aligned<WT, 16, 1>(x, w, sf, o, T, K, N, cluster,
                                   k_per_slice, x_vec, x_dtype, st);
}

}  // namespace

extern "C" {

// x_dtype: 0 f32, 1 bf16, 2 f16
int mxt_wq_matmul_int8(const void* x, const void* qw, const void* s,
                       void* out, int T, int K, int N, int m_tile,
                       int n_tile, int cluster, int k_per_slice, int x_dtype,
                       void* stream) {
  return run<int8_t>(x, qw, s, out, T, K, N, m_tile, n_tile, cluster,
                     k_per_slice, x_dtype, stream);
}

int mxt_wq_matmul_fp8(const void* x, const void* qw, const void* s,
                      void* out, int T, int K, int N, int m_tile, int n_tile,
                      int cluster, int k_per_slice, int x_dtype,
                      void* stream) {
  return run<__nv_fp8_e4m3>(x, qw, s, out, T, K, N, m_tile, n_tile, cluster,
                            k_per_slice, x_dtype, stream);
}

}  // extern "C"
