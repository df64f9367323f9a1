// Ragged paged attention over a block-table-indirected KV pool, for
// NVIDIA Hopper (sm_90a): the kernel template that csrc/ragged_flat.cu
// (f32, int8 and fp8 pages) and csrc/ragged_flat_lp.cu (bf16 and f16
// pages) instantiate, each source built by nvcc on its own, in parallel.
//
// Replaces the TPU kernels in mxnet_tpu/ops/ragged_attention.py:
//   K1  _flat_kernel        (f32, bf16 or f16 pages)
//   K2  _flat_quant_kernel  (int8 / fp8-e4m3 pages with per-(block, slot,
//                            head) f32 scales, dequantised in-tile)
//   K4  _chunk_kernel       (Q query tokens per sequence, f32, bf16 or
//                            f16 pages)
//   K5  _decode_kernel      (one query token per sequence, f32, bf16 or
//                            f16 pages)
// with one kernel template, paged_ring_kernel, and two query-tile types:
// FlatTiles (K1, K2) and ChunkTiles (K4, and K5 as a chunk of one token
// a row). The TPU kernels cast whatever float q and page they are given
// to f32 in the kernel and write the output in q's dtype; so do these:
// q is f32, bf16 or f16 over any page dtype (q_dtype: 0, 1, 2, a runtime
// argument, not a template parameter, which would triple the build),
// widened into the f32 q tile where it is loaded; a 16-bit page element
// becomes f32 where the ring's consumers read it (load_run); the output
// is f32, or q's 16-bit dtype rounded to nearest even from the f32
// result. K and V pages of two float dtypes are widened by the caller
// (ops/ragged_attention.py) to their common dtype, f32, before the
// launch: exact, since the kernel widens every page element to f32
// anyway, at the cost of one copy of a pool, on the op path only.
//
// What they compute: query token t belongs to row `row` of block_tables
// and attends over the positions 0..horizon of that row's paged history;
// page j of the row lives at pool block block_tables[row, j].
//   K1/K2: row = seq_ids[t], horizon = positions[t] (packed tokens);
//   K4:    q [S, Q, H, D], token t of row s at horizon kv_lens[s] -
//          q_lens[s] + t (causal inside the chunk);
//   K5:    q [S, H, D], row = t, horizon = kv_lens[row] - 1.
// Online softmax in f32, masked scores at -1e30 (never -inf), a masked
// slot weighs exactly 0, denominator floored at 1e-30, table entries
// clamped into the pool and seq_ids into the table, exactly as the TPU
// kernels do. A row with no position to see (K5 with kv_len 0, a K4 row
// with q_len 0) gives 0; padded chunk tokens (t >= q_len) give
// unspecified values, as on the TPU; nothing past a row's MB table
// entries is read. Quantised pages move 1 byte per element instead of 4,
// which is the whole point of K2: the scale multiplies the reduced score
// (K) and the softmax weight (V), so the dequantised page never exists.
// bf16 and f16 pages move 2 bytes per element through the same ring.
//
// Every head dim from 1 to 256, instantiated by kEpl = ceil(D / 32)
// elements a lane; only instantiations with D % 32 != 0 (kPred) test an
// element against D, so D = 32, 64, 128, 256 compile as they would with
// D fixed.
//
// What bounds them on the card: bytes. Every K/V byte of the live pages
// is used for 2 flops per query token (one multiply-add in the score, one
// in the value sum): far below the ~20 flops/byte an H100 needs before
// its f32 units, not its HBM (3.35 TB/s), are the limit, even for a
// chunk of 16 tokens per page. The least traffic reads each live page
// once. What keeps the kernels from it at a decode step's few tokens is
// latency: a page walk is a chain of dependent steps (load a page, reduce
// its scores across the warp, rescale, accumulate), so the card needs
// many short walks in flight and each step short.
//
// paged_ring_kernel: the work unit is (query tile, head group, kv
// split), from the plan of ops/ragged_attention.py paged_plan (flat_plan
// for K1/K2).
// - Query tile: up to 16 tokens of one table row at consecutive
//   horizons, so every token of the tile reads each staged page from
//   shared memory, not once per token through L2 (the TPU kernel stages
//   a page in VMEM for the whole chunk the same way). K4: up to 16
//   tokens of one chunk row; K5: the same with one token a row, at
//   horizon kv_len - 1. K1/K2: a piece of a run of the pack, consecutive
//   packed tokens of one seq_id, each at its own position (a serving
//   step packs each row's tokens so, and its padding tokens repeat one
//   stale entry: a prefill chunk is one run, the padding another). The
//   host cannot see the pack without a sync, so the kernel finds the
//   runs itself: CTA x takes slot x of the pack, qt tokens (qt from
//   flat_plan: the pack's mean tokens per row, at most 16), and a tile
//   starts at the slot's first token and at every token of the slot
//   whose seq_id differs from the one before it. The tile stages the
//   pages up to its largest position, and each token masks by its own:
//   any pack comes out right, and a CTA walks its slot's tiles in turn.
// - Head group: `heads` consecutive heads. A page [bs, H, D] is one
//   contiguous block of the pool, so a group's slot row is one run of
//   heads * D elements.
// - Pages staged through a ring of 2 to 4 shared-memory stages filled by
//   cp.async (16 bytes a copy where the run and the pool allow, 8 or 4
//   else, plain loads for runs of odd bytes): one stage holds one page's
//   K and V for the group and, for K2, both [bs, heads] scale tiles, all
//   in flight together, while the CTA works on an earlier stage: no load
//   waits on a softmax. The share's page ids are read into shared memory
//   once, so no copy waits on a table load.
// - The kv split, merged in one launch: the `splits` CTAs of a (tile,
//   group) form a thread-block cluster and share the row's own live
//   pages (horizon / bs + 1, computed here), so a long and a short row
//   both finish in about one share's time. By default each rank takes a
//   contiguous share of ceil(live / splits) pages. K1/K2 launched with
//   `dealt` deal the pages out in turn instead: rank r takes pages r,
//   r + splits, r + 2 splits, ... Then which CTA reads a page, and in
//   what order, depends on the page alone: a token's arithmetic is the
//   same whatever other tokens share its tile (a page past its own
//   horizon leaves its state as it was), so a row gets the same bits
//   alone and in any pack as long as the plan keeps `splits` and `subs`
//   (flat_plan's pack-independent plan fixes both for a page geometry).
//   Dealt pages slow 16-token tiles of int8/fp8 pages on an H100
//   (PERF.md), so only the launches whose rows must not move with the
//   pack deal them. Each CTA keeps its (m, l, acc) per (token, head) in
//   shared memory; after a cluster barrier one warp per (token, head)
//   merges every CTA's state through distributed shared memory in rank
//   order (as csrc/wq_matmul.cu's split-K), all ranks' loads issued
//   together: deterministic, no second launch, no scratch tensor.
// - Sub-walks: in a small launch of few (token, head) pairs per CTA (a
//   decode step of int8/fp8 pages), each pair gets `subs` warps, each
//   walking every subs-th page of the CTA's share with its own state,
//   folded in order before the cluster merge; a ring stage holds `subs` pages.
// - Lanes own runs of head elements read by vector loads from shared
//   memory; the 16 partial scores of a slot group are reduced by a
//   transposing butterfly (16 shuffles for 16 slots, after which lanes 2g
//   and 2g + 1 hold slot g's score), so the max, the exponent and the sum
//   take one value a lane, and each weight reaches the value sum by one
//   shuffle. The values that decide the warp's branches are broadcast
//   from lane 0 (warp_uniform), so the compiler keeps each shuffle one
//   instruction. Scores stay on the CUDA cores in f32: bytes, not
//   operations, bound the main path's shapes.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cooperative_groups.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float kNegInf = -1e30f;   // _NEG_INF of ops/flash_attention.py
constexpr unsigned kFull = 0xffffffffu;
constexpr int kQTile = 16;          // most query tokens per CTA
constexpr int kRingWarps = 8;       // most warps per CTA
constexpr int kMaxSmem = 232448;    // an H100 block's shared memory
constexpr int kMaxCluster = 8;      // the portable cluster size

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ float to_float(__half v) {
  return __half2float(v);
}

// v rounded to nearest even, as astype does on the TPU
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
__device__ __forceinline__ void store_as(__half* p, float v) {
  *p = __float2half_rn(v);
}

// The head-dim instantiation: kEpl = ceil(D / 32) elements per lane,
// kPred when D % 32 != 0. by_head_dim calls fn(HeadDim<...>{}) for D.
template <int E, bool P>
struct HeadDim {
  static constexpr int kEpl = E;
  static constexpr bool kPred = P;
};

template <typename Fn>
int by_head_dim(int D, Fn&& fn) {
  const bool p = D % 32 != 0;
  switch ((D + 31) / 32) {
    case 1: return p ? fn(HeadDim<1, true>{}) : fn(HeadDim<1, false>{});
    case 2: return p ? fn(HeadDim<2, true>{}) : fn(HeadDim<2, false>{});
    case 3: return p ? fn(HeadDim<3, true>{}) : fn(HeadDim<3, false>{});
    case 4: return p ? fn(HeadDim<4, true>{}) : fn(HeadDim<4, false>{});
    case 5: return p ? fn(HeadDim<5, true>{}) : fn(HeadDim<5, false>{});
    case 6: return p ? fn(HeadDim<6, true>{}) : fn(HeadDim<6, false>{});
    case 7: return p ? fn(HeadDim<7, true>{}) : fn(HeadDim<7, false>{});
    case 8: return p ? fn(HeadDim<8, true>{}) : fn(HeadDim<8, false>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ----------------------------------------------- paged_ring_kernel --
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wait until at most n (0..2) committed groups are still in flight
__device__ __forceinline__ void cp_wait_most(int n) {
  if (n <= 0)
    cp_wait<0>();
  else if (n == 1)
    cp_wait<1>();
  else
    cp_wait<2>();
}

// x from lane 0: a value the compiler then knows to be the same in every
// lane, so the branches it decides keep the warp converged and each
// __shfl_sync below compiles to one shuffle (the whole warp holds x
// already; as CUTLASS's canonical_warp_idx_sync)
__device__ __forceinline__ int warp_uniform(int x) {
  return __shfl_sync(kFull, x, 0);
}

__host__ __device__ __forceinline__ int align16(int x) {
  return (x + 15) & ~15;
}

// Shared memory of one CTA (mirrored by ops/ragged_attention.py
// ring_smem_bytes): the state, then `stages` ring stages.
// state: q tile [pairs, D] f32 (pairs = qt * heads, pair p = token *
//        heads + head), acc [subs, pairs, D] f32, m and l [subs, pairs]
//        f32, the page ids of the CTA's share [MB] int32;
// stage: `subs` pages, each K [bs, heads * D] elements, V the same (each
//        16-byte aligned), then for scaled pages the K and V scales [bs,
//        heads] f32.
struct RingLayout {
  int kv, sc, page, stage, state;
  __host__ __device__ RingLayout(int bs, int heads, int D, int elem,
                                 bool scaled, int qt, int subs, int MB)
      : kv(align16(bs * heads * D * elem)),
        sc(scaled ? align16(bs * heads * 4) : 0),
        page(2 * kv + 2 * sc),
        stage(subs * page),
        state(align16(4 * (qt * heads * D * (1 + subs) +
                           2 * subs * qt * heads + MB))) {}
  __host__ __device__ int smem(int stages) const {
    return state + stages * stage;
  }
};

// What a CTA's query tile is: tokens tok0 .. tok0 + nout - 1 of q/out
// seen as [tokens, H, D], of table row `row`; the first nq of them have a
// contract, hz_max the largest causal horizon among them. A tile type
// gives tile `it` of CTA x (locate), token i's horizon (horizon) and,
// unless each CTA has one tile (kOneTile), the number of CTA x's tiles
// (count); all are called by whole warps and give every lane the same
// values.
struct Tile {
  int row, tok0, nout, nq, hz0, hz_max;
};

struct FlatTiles {      // K1, K2: pieces of the pack's runs
  const int32_t* seq_ids;     // [T]
  const int32_t* positions;   // [T]
  int S, T, cap;              // cap: tokens per slot, 1 .. kQTile
  int dealt;                  // 1: pages dealt to the ranks in turn
  static constexpr bool kOneTile = false;
  __host__ __device__ int qt() const { return cap; }
  // bit i: token x * cap + i starts a tile (it is the slot's first, or
  // its seq_id differs from the token's before it)
  __device__ __forceinline__ unsigned starts(int x, int lane) const {
    const int y = x * cap + lane;
    bool start = lane == 0;
    if (lane > 0 && lane < cap && y < T)
      start = seq_ids[y - 1] != seq_ids[y];
    return __ballot_sync(kFull, start);
  }
  __device__ __forceinline__ int count(int x, int lane) const {
    return __popc(starts(x, lane));
  }
  __device__ __forceinline__ void locate(int x, int it, int lane,
                                         Tile& t) const {
    unsigned m = starts(x, lane);
    for (int i = 0; i < it; ++i) m &= m - 1;
    const int first = __ffs(m) - 1;
    const unsigned rest = m & (m - 1);
    const int end = rest ? __ffs(rest) - 1 : min(cap, T - x * cap);
    t.tok0 = x * cap + first;
    t.row = min(max(seq_ids[t.tok0], 0), S - 1);
    t.nout = end - first;
    t.nq = t.nout;
    t.hz0 = positions[t.tok0];
    t.hz_max = __reduce_max_sync(
        kFull, lane < t.nout ? positions[t.tok0 + lane] : t.hz0);
  }
  __device__ __forceinline__ int horizon(const Tile& t, int i) const {
    return warp_uniform(positions[t.tok0 + i]);
  }
};

struct ChunkTiles {     // K4, K5: up to kQTile tokens of one chunk row
  const int32_t* kv_lens;     // [S], this chunk's tokens included
  const int32_t* q_lens;      // [S], or null: Q tokens in every row (K5)
  int Q, tiles;               // tiles = ceil(Q / kQTile) per row
  static constexpr int dealt = 0;      // contiguous shares
  static constexpr bool kOneTile = true;
  __host__ __device__ int qt() const { return Q < kQTile ? Q : kQTile; }
  __device__ __forceinline__ void locate(int x, int, int, Tile& t) const {
    const int s = x / tiles;
    const int q0 = (x - s * tiles) * kQTile;
    const int ql = q_lens != nullptr ? q_lens[s] : Q;
    t.row = s;
    t.tok0 = s * Q + q0;
    t.nout = min(kQTile, Q - q0);
    t.nq = max(0, min(t.nout, ql - q0));
    t.hz0 = kv_lens[s] - ql + q0;
    t.hz_max = t.hz0 + t.nq - 1;
  }
  __device__ __forceinline__ int horizon(const Tile& t, int i) const {
    return t.hz0 + i;
  }
};

// Stage page `pid`'s K, V (and scales) of heads h0 .. h0 + heads - 1:
// bs runs of heads * D elements, one per slot, H * D elements apart in
// the pool; `vec` bytes a copy (vec divides the run and both pools'
// addresses).
template <typename PageT, bool kScaled>
__device__ __forceinline__ void stage_page(
    unsigned char* st, const RingLayout& L, const PageT* k_pages,
    const PageT* v_pages, const float* k_scales, const float* v_scales,
    int pid, int h0, int heads, int H, int D, int bs, int vec, int tid,
    int nthreads) {
  const int run = heads * D * static_cast<int>(sizeof(PageT));
  const size_t stride = static_cast<size_t>(H) * D * sizeof(PageT);
  const size_t base = (static_cast<size_t>(pid) * bs * H + h0) * D *
                      sizeof(PageT);
  const char* kb = reinterpret_cast<const char*>(k_pages) + base;
  const char* vb = reinterpret_cast<const char*>(v_pages) + base;
  const int per = run / vec;
  for (int c = tid; c < bs * per; c += nthreads) {
    const int s = c / per;
    const int o = (c - s * per) * vec;
    const size_t src = s * stride + o;
    unsigned char* dk = st + s * run + o;
    unsigned char* dv = dk + L.kv;
    if (vec == 16) {
      cp_async16(dk, kb + src);
      cp_async16(dv, vb + src);
    } else if (vec == 8) {
      cp_async8(dk, kb + src);
      cp_async8(dv, vb + src);
    } else if (vec == 4) {
      cp_async4(dk, kb + src);
      cp_async4(dv, vb + src);
    } else if (vec == 2) {
      *reinterpret_cast<uint16_t*>(dk) =
          *reinterpret_cast<const uint16_t*>(kb + src);
      *reinterpret_cast<uint16_t*>(dv) =
          *reinterpret_cast<const uint16_t*>(vb + src);
    } else {
      *dk = *reinterpret_cast<const unsigned char*>(kb + src);
      *dv = *reinterpret_cast<const unsigned char*>(vb + src);
    }
  }
  if (kScaled) {
    float* ks = reinterpret_cast<float*>(st + 2 * L.kv);
    float* vs = reinterpret_cast<float*>(st + 2 * L.kv + L.sc);
    for (int c = tid; c < bs * heads; c += nthreads) {
      const int s = c / heads;
      const size_t i =
          (static_cast<size_t>(pid) * bs + s) * H + h0 + (c - s * heads);
      cp_async4(ks + c, k_scales + i);
      cp_async4(vs + c, v_scales + i);
    }
  }
}

// Which head elements lane l owns in the ring kernel: kC chunks of kV
// consecutive elements, chunk c at element (l + 32c) * kV, so a warp
// reads a K or V row with kC vector loads of kV elements, conflict-free.
// kV is 1 where D % 32 != 0 or kEpl is not a power of two (elements l +
// 32e), else kEpl up to 16 bytes a load.
template <typename PageT, int kEpl, bool kPred>
struct Own {
  static constexpr bool kPow2 = (kEpl & (kEpl - 1)) == 0;
  static constexpr int kMaxV = 16 / static_cast<int>(sizeof(PageT));
  static constexpr int kV =
      kPred || !kPow2 ? 1 : (kEpl < kMaxV ? kEpl : kMaxV);
  static constexpr int kC = kEpl / kV;
  __device__ __forceinline__ static int elem(int lane, int e) {
    return (lane + 32 * (e / kV)) * kV + e % kV;
  }
};

__device__ __forceinline__ float byte_to_float(int8_t, unsigned b) {
  return static_cast<float>(static_cast<int8_t>(b & 0xffu));
}
__device__ __forceinline__ float byte_to_float(__nv_fp8_e4m3, unsigned b) {
  __nv_fp8_e4m3 v;
  v.__x = static_cast<__nv_fp8_storage_t>(b & 0xffu);
  return static_cast<float>(v);
}

// the two 16-bit elements of word w (the lower one first), as f32
__device__ __forceinline__ void halves_to_float(__nv_bfloat16, unsigned w,
                                                float* x) {
  x[0] = __uint_as_float(w << 16);
  x[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void halves_to_float(__half, unsigned w,
                                                float* x) {
  x[0] = __half2float(__ushort_as_half(static_cast<unsigned short>(w)));
  x[1] = __half2float(
      __ushort_as_half(static_cast<unsigned short>(w >> 16)));
}

// x[0..kV) = the kV elements at p (aligned to their bytes), as f32
template <typename PageT, int kV>
__device__ __forceinline__ void load_run(const PageT* p, float* x) {
  if constexpr (sizeof(PageT) == 2 && kV == 8) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    halves_to_float(PageT(), w.x, x);
    halves_to_float(PageT(), w.y, x + 2);
    halves_to_float(PageT(), w.z, x + 4);
    halves_to_float(PageT(), w.w, x + 6);
  } else if constexpr (sizeof(PageT) == 2 && kV == 4) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
    halves_to_float(PageT(), w.x, x);
    halves_to_float(PageT(), w.y, x + 2);
  } else if constexpr (sizeof(PageT) == 2 && kV == 2) {
    halves_to_float(PageT(), *reinterpret_cast<const unsigned*>(p), x);
  } else if constexpr (sizeof(PageT) == 4 && kV == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else if constexpr (sizeof(PageT) == 4 && kV == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    x[0] = v.x; x[1] = v.y;
  } else if constexpr (sizeof(PageT) == 1 && kV == 16) {
    const uint4 w = *reinterpret_cast<const uint4*>(p);
    const unsigned ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int e = 0; e < 16; ++e)
      x[e] = byte_to_float(PageT(), ws[e / 4] >> (8 * (e % 4)));
  } else if constexpr (sizeof(PageT) == 1 && kV == 8) {
    const uint2 w = *reinterpret_cast<const uint2*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = byte_to_float(PageT(), w.x >> (8 * e));
      x[4 + e] = byte_to_float(PageT(), w.y >> (8 * e));
    }
  } else if constexpr (sizeof(PageT) == 1 && kV == 4) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p);
#pragma unroll
    for (int e = 0; e < 4; ++e) x[e] = byte_to_float(PageT(), w >> (8 * e));
  } else if constexpr (sizeof(PageT) == 1 && kV == 2) {
    const unsigned w = *reinterpret_cast<const unsigned short*>(p);
    x[0] = byte_to_float(PageT(), w);
    x[1] = byte_to_float(PageT(), w >> 8);
  } else {
#pragma unroll
    for (int e = 0; e < kV; ++e) x[e] = to_float(p[e]);
  }
}

// a K or V row of the stage (D elements at `row`) in lane's elements;
// elements past D read as 0
template <typename PageT, int kEpl, bool kPred>
__device__ __forceinline__ void load_row(const PageT* row, int lane, int D,
                                         float (&x)[kEpl]) {
  using O = Own<PageT, kEpl, kPred>;
  if (kPred) {
#pragma unroll
    for (int e = 0; e < kEpl; ++e)
      x[e] = lane + 32 * e < D ? to_float(row[lane + 32 * e]) : 0.f;
  } else {
#pragma unroll
    for (int c = 0; c < O::kC; ++c)
      load_run<PageT, O::kV>(row + (lane + 32 * c) * O::kV, x + c * O::kV);
  }
}

// Sum each of v[0..15] over the warp; returns, in lane l, the sum of
// v[(l >> 1) & 15] (16 shuffles in place of 16 x 5)
__device__ __forceinline__ float reduce16(float (&v)[16], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float keep = b4 ? v[i + 8] : v[i];
    const float send = b4 ? v[i] : v[i + 8];
    v[i] = keep + __shfl_xor_sync(kFull, send, 16);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b3 ? v[i + 4] : v[i];
    const float send = b3 ? v[i] : v[i + 4];
    v[i] = keep + __shfl_xor_sync(kFull, send, 8);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b2 ? v[i + 2] : v[i];
    const float send = b2 ? v[i] : v[i + 2];
    v[i] = keep + __shfl_xor_sync(kFull, send, 4);
  }
  float x = (b1 ? v[1] : v[0]) + __shfl_xor_sync(kFull, b1 ? v[0] : v[1], 2);
  x += __shfl_xor_sync(kFull, x, 1);
  return x;
}

// the max / sum of a value held per slot (lanes 2g and 2g + 1 hold slot
// g) over the 16 slots
__device__ __forceinline__ float slot_max(float x) {
#pragma unroll
  for (int o = 2; o < 32; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float slot_sum(float x) {
#pragma unroll
  for (int o = 2; o < 32; o <<= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// One warp: pair `pair` (token pair / heads, head pair % heads of the
// group) over the staged page `st`, whose slot s is position pos0 + s;
// the token sees positions <= hz. Slots go 16 at a time: each lane
// forms its elements' part of all 16 scores, reduce16 leaves slot g's
// score in lanes 2g and 2g + 1, the max, exponent and sum take one value
// a lane, and each weight reaches the value sum by one shuffle. State in
// shared memory.
template <typename PageT, bool kScaled, int kEpl, bool kPred>
__device__ __forceinline__ void attend_page(
    const unsigned char* st, const RingLayout& L, const float* s_q,
    float* s_acc, float* s_m, float* s_l, int pair, int heads, int D,
    int bs, int pos0, int hz, float scale, int lane) {
  using O = Own<PageT, kEpl, kPred>;
  const int h = pair % heads;
  const int ld = heads * D;   // elements between slots of a stage
  const PageT* kt = reinterpret_cast<const PageT*>(st) + h * D;
  const PageT* vt = reinterpret_cast<const PageT*>(st + L.kv) + h * D;
  const float* ks = reinterpret_cast<const float*>(st + 2 * L.kv) + h;
  const float* vs = reinterpret_cast<const float*>(st + 2 * L.kv + L.sc) + h;
  const float* qrow = s_q + pair * D;
  float* arow = s_acc + pair * D;
  float qv[kEpl], acc[kEpl];
#pragma unroll
  for (int e = 0; e < kEpl; ++e) {
    const int d = O::elem(lane, e);
    const bool in = !kPred || d < D;
    qv[e] = in ? qrow[d] : 0.f;
    acc[e] = in ? arow[d] : 0.f;
  }
  float m = s_m[pair];
  float l = s_l[pair];
  const int mine = (lane >> 1) & 15;   // the slot of the group lane holds
  for (int s0 = 0; s0 < bs && pos0 + s0 <= hz; s0 += 16) {
    // slots s0 .. s0 + live - 1 are visible (the loop test makes live >= 1)
    const int live = min(min(16, bs - s0), hz - pos0 - s0 + 1);
    float part[16];
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      float sum = 0.f;
      if (g < live) {
        float kx[kEpl];
        load_row<PageT, kEpl, kPred>(kt + (s0 + g) * ld, lane, D, kx);
#pragma unroll
        for (int e = 0; e < kEpl; ++e) sum += qv[e] * kx[e];
      }
      part[g] = sum;
    }
    float sc = reduce16(part, lane);
    const bool on = mine < live;
    if (kScaled) sc *= on ? ks[(s0 + mine) * heads] : 1.f;
    sc = on ? sc * scale : kNegInf;
    const float m_new = fmaxf(m, slot_max(sc));
    const float alpha = expf(m - m_new);
    // a masked slot weighs exactly 0, even while the running max is
    // still -1e30 (exp(-1e30 - -1e30) is 1)
    float p = expf(sc - m_new) * (on ? 1.f : 0.f);
    l = l * alpha + slot_sum(p);
    m = m_new;
#pragma unroll
    for (int e = 0; e < kEpl; ++e) acc[e] *= alpha;
    if (kScaled && on) p *= vs[(s0 + mine) * heads];
#pragma unroll
    for (int g = 0; g < 16; ++g) {
      const float pg = __shfl_sync(kFull, p, 2 * g);
      // masked slots (stale values, possibly not finite) are skipped:
      // the condition is the same in every lane
      if (g < live) {
        float vx[kEpl];
        load_row<PageT, kEpl, kPred>(vt + (s0 + g) * ld, lane, D, vx);
#pragma unroll
        for (int e = 0; e < kEpl; ++e) acc[e] += pg * vx[e];
      }
    }
  }
#pragma unroll
  for (int e = 0; e < kEpl; ++e) {
    const int d = O::elem(lane, e);
    if (!kPred || d < D) arow[d] = acc[e];
  }
  if (lane == 0) {
    s_m[pair] = m;
    s_l[pair] = l;
  }
}

// q's dtype (the q_dtype argument of every entry point): q and the
// output are f32, bf16 or f16, whatever the pages' dtype
constexpr int kQF32 = 0, kQBf16 = 1, kQF16 = 2;

// element i of q, in q_dtype, as f32
__device__ __forceinline__ float q_elem(const void* q, size_t i,
                                        int q_dtype) {
  if (q_dtype == kQBf16)
    return to_float(static_cast<const __nv_bfloat16*>(q)[i]);
  if (q_dtype == kQF16) return to_float(static_cast<const __half*>(q)[i]);
  return static_cast<const float*>(q)[i];
}

// out[i] = v, in q_dtype
__device__ __forceinline__ void store_out(void* out, size_t i, float v,
                                          int q_dtype) {
  if (q_dtype == kQBf16)
    store_as(static_cast<__nv_bfloat16*>(out) + i, v);
  else if (q_dtype == kQF16)
    store_as(static_cast<__half*>(out) + i, v);
  else
    static_cast<float*>(out)[i] = v;
}

// grid (query tiles, H / heads, splits), cluster (1, 1, splits). Two
// CTAs an SM bound the registers (128 a thread). With the block size
// alone, ptxas may cut a kernel to 64 or 80 registers, spilling, to fit
// more CTAs; with three, the int8/fp8 kernels spill at D = 64.
template <typename PageT, bool kScaled, int kEpl, bool kPred,
          typename Tiles>
__global__ void __launch_bounds__(kRingWarps * 32, 2)
paged_ring_kernel(const void* __restrict__ q,   // q_dtype
                  const PageT* __restrict__ k_pages,    // [N, bs, H, D]
                  const PageT* __restrict__ v_pages,    // [N, bs, H, D]
                  const float* __restrict__ k_scales,   // [N, bs, H]
                  const float* __restrict__ v_scales,   // [N, bs, H]
                  const int32_t* __restrict__ block_tables,  // [S, MB]
                  Tiles tiles, void* __restrict__ out,  // q's dtype
                  int H, int D_arg, int bs, int N, int MB, int heads,
                  int stages, int subs, int vec, int q_dtype, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = kPred ? D_arg : kEpl * 32;
  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = warp_uniform(tid >> 5), lane = tid & 31;
  const int warps = nthreads >> 5;
  const int qt = tiles.qt();
  const int pairs = qt * heads;
  const int states = subs * pairs;     // (sub, pair) online-softmax states
  const int h0 = blockIdx.y * heads;
  const RingLayout L(bs, heads, D, static_cast<int>(sizeof(PageT)),
                     kScaled, qt, subs, MB);
  float* s_q = reinterpret_cast<float*>(smem);
  float* s_acc = s_q + pairs * D;
  float* s_m = s_acc + states * D;
  float* s_l = s_m + states;
  int* s_pid = reinterpret_cast<int*>(s_l + states);
  unsigned char* ring = smem + L.state;

  cg::cluster_group cluster = cg::this_cluster();
  const int ranks = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  // one query tile, the it-th of this CTA
  auto run_tile = [&](int it) {
    Tile t;
    tiles.locate(blockIdx.x, it, lane, t);
    t.row = warp_uniform(t.row);
    t.tok0 = warp_uniform(t.tok0);
    t.nout = warp_uniform(t.nout);
    t.nq = warp_uniform(t.nq);
    t.hz0 = warp_uniform(t.hz0);
    t.hz_max = warp_uniform(t.hz_max);
    // this CTA's share of the row's live pages (those holding a position
    // some token of the tile may see): pages p0, p0 + stride, ..., n of
    // them (dealt: p0 = rank, stride = ranks; else a contiguous share)
    const int live =
        t.nq > 0 && t.hz_max >= 0 ? min(MB, t.hz_max / bs + 1) : 0;
    int p0, stride, n;
    if (tiles.dealt) {
      p0 = rank;
      stride = ranks;
      n = live > rank ? (live - rank + ranks - 1) / ranks : 0;
    } else {
      const int share = (live + ranks - 1) / ranks;
      p0 = min(live, rank * share);
      stride = 1;
      n = min(live, p0 + share) - p0;
    }
    const int32_t* table = block_tables + static_cast<size_t>(t.row) * MB;

    for (int i = tid; i < pairs * D; i += nthreads) {
      const int pr = i / D;
      const int qi = pr / heads;
      s_q[i] = qi < t.nq
                   ? q_elem(q,
                            (static_cast<size_t>(t.tok0 + qi) * H + h0 +
                             (pr - qi * heads)) * D + (i - pr * D),
                            q_dtype)
                   : 0.f;
    }
    for (int i = tid; i < states * D; i += nthreads) s_acc[i] = 0.f;
    for (int i = tid; i < states; i += nthreads) {
      s_m[i] = kNegInf;
      s_l[i] = 0.f;
    }
    // the share's page ids, read once; a corrupt table entry must not
    // read outside the pool (the TPU path clamps out-of-range indices the
    // same way)
    for (int i = tid; i < n; i += nthreads)
      s_pid[i] = min(max(table[p0 + stride * i], 0), N - 1);
    __syncthreads();

    // stage k holds pages k * subs .. k * subs + subs - 1 of the share
    const int groups = (n + subs - 1) / subs;
    auto load = [&](int k) {
      for (int s = 0; s < subs && k * subs + s < n; ++s)
        stage_page<PageT, kScaled>(
            ring + (k % stages) * L.stage + s * L.page, L, k_pages,
            v_pages, k_scales, v_scales, s_pid[k * subs + s], h0, heads, H,
            D, bs, vec, tid, nthreads);
    };
    for (int k = 0; k < stages - 1; ++k) {
      if (k < groups) load(k);
      cp_commit();
    }
    for (int k = 0; k < groups; ++k) {
      cp_wait_most(stages - 2);  // stage k has landed
      __syncthreads();           // ... for every thread; stage k - 1 is free
      if (k + stages - 1 < groups) load(k + stages - 1);
      cp_commit();
      const unsigned char* st = ring + (k % stages) * L.stage;
      for (int w = warp; w < states; w += warps) {   // (sub-walk, pair)
        const int sub = w / pairs, pr = w - sub * pairs;
        const int i = k * subs + sub;
        const int qi = pr / heads;
        if (i < n && qi < t.nq)
          attend_page<PageT, kScaled, kEpl, kPred>(
              st + sub * L.page, L, s_q, s_acc + sub * pairs * D,
              s_m + sub * pairs, s_l + sub * pairs, pr, heads, D, bs,
              (p0 + stride * i) * bs, tiles.horizon(t, qi), scale, lane);
      }
    }
    cp_wait<0>();
    __syncthreads();

    // fold the sub-walks' states into sub-walk 0's, in sub-walk order: a
    // state that saw no page holds (m, l, acc) = (-1e30, 0, 0) and weighs
    // nothing once any has a real maximum. A thread per pair turns the
    // l's into the weights exp(m - m_all) and parks (m_all, l_all) in
    // sub-walk 1's m; then a thread per element folds acc; then l_all
    // goes home.
    if (subs > 1) {
      for (int pr = tid; pr < pairs; pr += nthreads) {
        float m_all = kNegInf;
        for (int s = 0; s < subs; ++s)
          m_all = fmaxf(m_all, s_m[s * pairs + pr]);
        float l_all = 0.f;
        for (int s = 0; s < subs; ++s) {
          const float w = expf(s_m[s * pairs + pr] - m_all);
          l_all += s_l[s * pairs + pr] * w;
          s_l[s * pairs + pr] = w;
        }
        s_m[pr] = m_all;
        s_m[pairs + pr] = l_all;
      }
      __syncthreads();
      for (int i = tid; i < pairs * D; i += nthreads) {
        const int pr = i / D;
        float o = 0.f;
        for (int s = 0; s < subs; ++s)
          o += s_acc[s * pairs * D + i] * s_l[s * pairs + pr];
        s_acc[i] = o;
      }
      __syncthreads();
      for (int pr = tid; pr < pairs; pr += nthreads)
        s_l[pr] = s_m[pairs + pr];
    }

    // merge the CTAs' states in rank order, a warp per output (token,
    // head) with every rank's loads issued together; with no state that
    // saw a page, the output is 0
    cluster.sync();
    for (int pr = rank + ranks * warp; pr < t.nout * heads;
         pr += ranks * warps) {
      float mr[kMaxCluster], w[kMaxCluster];
      float m_all = kNegInf;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        mr[r] = r < ranks ? cluster.map_shared_rank(s_m, r)[pr] : kNegInf;
        m_all = fmaxf(m_all, mr[r]);
      }
      float l_all = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        w[r] = r < ranks ? expf(mr[r] - m_all) : 0.f;
        if (r < ranks) l_all += cluster.map_shared_rank(s_l, r)[pr] * w[r];
      }
      const float l_safe = fmaxf(l_all, 1e-30f);
      const int qi = pr / heads;
      const size_t orow = (static_cast<size_t>(t.tok0 + qi) * H + h0 +
                           (pr - qi * heads)) * D;
      for (int d = lane; d < D; d += 32) {
        float o = 0.f;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r)
          if (r < ranks)
            o += cluster.map_shared_rank(s_acc, r)[pr * D + d] * w[r];
        store_out(out, orow + d, o / l_safe, q_dtype);
      }
    }
    // no CTA leaves, or takes its next tile, while another reads its state
    cluster.sync();
  };
  if constexpr (Tiles::kOneTile) {
    run_tile(0);
  } else {
    // the CTAs of a cluster share blockIdx.x, so they walk the same tiles
    const int ntiles = warp_uniform(tiles.count(blockIdx.x, lane));
    for (int it = 0; it < ntiles; ++it) run_tile(it);
  }
}

// ctas query tiles (or slots) by H / heads head groups by `splits`, one
// cluster per (tile, group); the plan (heads, splits, stages, subs) from
// paged_plan
template <typename PageT, bool kScaled, typename Tiles>
int launch_ring(const void* q, const void* k_pages, const void* v_pages,
                const void* k_scales, const void* v_scales,
                const void* block_tables, Tiles tiles, void* out, int ctas,
                int H, int D, int bs, int N, int MB, int heads, int splits,
                int stages, int subs, int q_dtype, float scale,
                void* stream) {
  const int qt = tiles.qt();
  if (ctas <= 0 || H <= 0 || D < 1 || D > 256 || bs <= 0 || N <= 0 ||
      MB <= 0 || heads < 1 || H % heads != 0 || splits < 1 || splits > 8 ||
      stages < 2 || stages > 4 || subs < 1 || subs * qt * heads > 64 ||
      q_dtype < kQF32 || q_dtype > kQF16)
    return static_cast<int>(cudaErrorInvalidValue);
  const RingLayout L(bs, heads, D, static_cast<int>(sizeof(PageT)),
                     kScaled, qt, subs, MB);
  const int smem = L.smem(stages);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int run = heads * D * static_cast<int>(sizeof(PageT));
  const uintptr_t addr = reinterpret_cast<uintptr_t>(k_pages) |
                         reinterpret_cast<uintptr_t>(v_pages);
  int vec = 16;
  while (vec > 1 && (run % vec != 0 || addr % vec != 0)) vec >>= 1;
  const int states = subs * qt * heads;
  const int warps = states < kRingWarps ? states : kRingWarps;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return by_head_dim(D, [&](auto hd) {
    using HD = decltype(hd);
    auto kernel = paged_ring_kernel<PageT, kScaled, HD::kEpl, HD::kPred,
                                    Tiles>;
    static bool ready = false;
    if (!ready) {
      const cudaError_t rc = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
      if (rc != cudaSuccess) return static_cast<int>(rc);
      ready = true;
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(ctas, H / heads, splits);
    cfg.blockDim = dim3(32 * warps);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = st;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = splits;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t rc = cudaLaunchKernelEx(
        &cfg, kernel, q, static_cast<const PageT*>(k_pages),
        static_cast<const PageT*>(v_pages),
        static_cast<const float*>(k_scales),
        static_cast<const float*>(v_scales),
        static_cast<const int32_t*>(block_tables), tiles, out, H, D, bs, N,
        MB, heads, stages, subs, vec, q_dtype, scale);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    return static_cast<int>(cudaGetLastError());
  });
}

// K1 / K2: ceil(T / qt) slots of the pack (FlatTiles); dealt: 1 deals
// the live pages to the ranks in turn, 0 gives them contiguous shares
template <typename PageT, bool kScaled>
int launch_flat(const void* q, const void* k_pages, const void* v_pages,
                const void* k_scales, const void* v_scales,
                const void* block_tables, const void* seq_ids,
                const void* positions, void* out, int T, int H, int D,
                int bs, int N, int S, int MB, int qt, int heads, int splits,
                int stages, int subs, int dealt, int q_dtype, float scale,
                void* stream) {
  if (T <= 0 || S <= 0 || qt < 1 || qt > kQTile || dealt < 0 || dealt > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const FlatTiles tiles{static_cast<const int32_t*>(seq_ids),
                        static_cast<const int32_t*>(positions), S, T, qt,
                        dealt};
  return launch_ring<PageT, kScaled>(
      q, k_pages, v_pages, k_scales, v_scales, block_tables, tiles, out,
      (T + qt - 1) / qt, H, D, bs, N, MB, heads, splits, stages, subs,
      q_dtype, scale, stream);
}

// K4: q/out [S, Q, H, D], kv_lens/q_lens [S] (ChunkTiles)
template <typename PageT>
int launch_chunk(const void* q, const void* k_pages, const void* v_pages,
                 const void* block_tables, const void* kv_lens,
                 const void* q_lens, void* out, int S, int Q, int H, int D,
                 int bs, int N, int MB, int heads, int splits, int stages,
                 int subs, int q_dtype, float scale, void* stream) {
  if (Q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (Q + kQTile - 1) / kQTile;
  const ChunkTiles chunk{static_cast<const int32_t*>(kv_lens),
                         static_cast<const int32_t*>(q_lens), Q, tiles};
  return launch_ring<PageT, false>(q, k_pages, v_pages, nullptr, nullptr,
                                   block_tables, chunk, out, S * tiles, H, D,
                                   bs, N, MB, heads, splits, stages, subs,
                                   q_dtype, scale, stream);
}

// K5: q/out [S, H, D], kv_lens [S]: a chunk of one token a row (a row
// with kv_len 0 sees no position and gives 0)
template <typename PageT>
int launch_decode(const void* q, const void* k_pages, const void* v_pages,
                  const void* block_tables, const void* kv_lens, void* out,
                  int S, int H, int D, int bs, int N, int MB, int heads,
                  int splits, int stages, int subs, int q_dtype, float scale,
                  void* stream) {
  const ChunkTiles decode{static_cast<const int32_t*>(kv_lens), nullptr, 1,
                          1};
  return launch_ring<PageT, false>(q, k_pages, v_pages, nullptr, nullptr,
                                   block_tables, decode, out, S, H, D, bs, N,
                                   MB, heads, splits, stages, subs, q_dtype,
                                   scale, stream);
}

}  // namespace
