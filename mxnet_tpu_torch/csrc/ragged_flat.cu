// Ragged paged attention over a block-table-indirected KV pool, for
// NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels in mxnet_tpu/ops/ragged_attention.py:
//   K1  _flat_kernel        (f32 pages)
//   K2  _flat_quant_kernel  (int8 / fp8-e4m3 pages with per-(block, slot,
//                            head) f32 scales, dequantised in-tile)
//   K4  _chunk_kernel       (Q query tokens per sequence, f32 pages)
//   K5  _decode_kernel      (one query token per sequence, f32 pages)
// One kernel template, instantiated per page type and per way a query
// token finds its sequence and its causal horizon (the Flat/Chunk/Decode
// query structs below).
//
// What it computes: query token t belongs to row `row` of block_tables
// and attends over the positions 0..horizon of that row's paged history;
// page j of the row lives at pool block block_tables[row, j].
//   K1/K2: row = seq_ids[t], horizon = positions[t] (packed tokens);
//   K4:    q [S, Q, H, D] seen as S*Q tokens, row = t / Q, horizon =
//          kv_lens[row] - q_lens[row] + t % Q (causal inside the chunk);
//   K5:    q [S, H, D], row = t, horizon = kv_lens[row] - 1.
// Online softmax in f32, masked scores at -1e30 (never -inf), denominator
// floored at 1e-30, exactly as the TPU kernels do. A row with no position
// to see (K5 with kv_len 0) gives 0; padded chunk tokens (t >= q_len)
// give unspecified values, as on the TPU, and never read past the row's
// MB table entries.
//
// What bounds it on the card: bytes. Every K/V byte of the live pages is
// read once per query token and used for 2 flops (one multiply-add in the
// score, one in the value sum); that is far below the ~20 flops/byte an
// H100 needs before its f32 units, not its HBM (3.35 TB/s), are the limit.
// The least traffic reads each live page once. K1, K5 and most K4 tokens
// reach that, but a K4 chunk of Q tokens reads its row's pages Q times:
// the TPU kernel stages one page in VMEM for the whole chunk, this design
// leaves the re-reads to the 50 MB L2 (a row's pages at GPT-2-small widths
// are 6 MB). Staging a page in shared memory for all Q queries of a
// (row, head) is the next design for K4.
//
// Design: one CTA per (token, head), kWarps warps in it. The CTA reads
// the token's block-table row itself (the TPU kernel got the page ids by
// scalar prefetch) and stops at the last page that holds a position <=
// horizon, so no byte past the causal end is read. Warp w walks pages
// w, w + kWarps, ... with its own online-softmax state (m, l, acc) in
// registers — the TPU grid walked one sequence's pages in order on one
// core; here the page walk of one long sequence is split kWarps ways so a
// decode step of a few tokens still puts hundreds of warps on the card —
// and the warps' states are merged through shared memory at the end. Each
// lane owns D/32 elements of the head, so a K or V row is one coalesced
// warp-wide load. Slots are taken kGroup at a time so their loads (and a
// quantised page's scales) are in flight together; scores are reduced
// with warp shuffles. Masked slots are neither loaded nor accumulated
// (a stale page's values never enter a sum), and a masked slot's weight
// is multiplied by 0, so a group that is wholly masked while the running
// max is still -1e30 adds nothing; a warp that saw no page keeps
// (m, l, acc) = (-1e30, 0, 0). Quantised pages move
// 1 byte per element instead of 4, which is the whole point of K2; the
// scale multiplies the reduced score (K) and the softmax weight (V), so
// the dequantised page never exists anywhere.
#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;   // _NEG_INF of ops/flash_attention.py
constexpr int kWarps = 8;           // warps splitting one token-head's pages
constexpr int kGroup = 8;           // slots in flight per warp

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// How query token t finds its block-table row and its causal horizon
// (the last position it may see), one struct per TPU kernel.
struct FlatQuery {      // K1/K2: packed tokens, any sequence, any position
  const int32_t* seq_ids;     // [T]
  const int32_t* positions;   // [T]
  int S;
  __device__ __forceinline__ void locate(int t, int& row,
                                         int& horizon) const {
    row = min(max(seq_ids[t], 0), S - 1);
    horizon = positions[t];
  }
};

struct ChunkQuery {     // K4: q [S, Q, H, D] as S*Q tokens
  const int32_t* kv_lens;     // [S], this chunk's tokens included
  const int32_t* q_lens;      // [S]
  int Q;
  __device__ __forceinline__ void locate(int t, int& row,
                                         int& horizon) const {
    row = t / Q;
    horizon = kv_lens[row] - q_lens[row] + t % Q;
  }
};

struct DecodeQuery {    // K5: q [S, H, D]
  const int32_t* kv_lens;     // [S]
  __device__ __forceinline__ void locate(int t, int& row,
                                         int& horizon) const {
    row = t;
    horizon = kv_lens[row] - 1;
  }
};

template <typename PageT, bool kScaled, int kEpl, typename Query>
__global__ void __launch_bounds__(kWarps * 32)
paged_attention_kernel(const float* __restrict__ q,          // [T, H, D]
                       const PageT* __restrict__ k_pages,    // [N, bs, H, D]
                       const PageT* __restrict__ v_pages,    // [N, bs, H, D]
                       const float* __restrict__ k_scales,   // [N, bs, H]
                       const float* __restrict__ v_scales,   // [N, bs, H]
                       const int32_t* __restrict__ block_tables,  // [S, MB]
                       Query query,
                       float* __restrict__ out,              // [T, H, D]
                       int H, int bs, int N, int MB, float scale) {
  constexpr int D = kEpl * 32;
  __shared__ float s_acc[kWarps][D];
  __shared__ float s_m[kWarps];
  __shared__ float s_l[kWarps];
  const int t = blockIdx.x;
  const int h = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  float qv[kEpl], acc[kEpl];
  const float* qrow = q + (static_cast<size_t>(t) * H + h) * D;
#pragma unroll
  for (int e = 0; e < kEpl; ++e) {
    qv[e] = qrow[lane + 32 * e];
    acc[e] = 0.f;
  }
  int row, qpos;
  query.locate(t, row, qpos);
  const int32_t* table = block_tables + static_cast<size_t>(row) * MB;
  float m = kNegInf;
  float l = 0.f;

  for (int j = warp; j < MB && j * bs <= qpos; j += kWarps) {
    // a corrupt table entry must not read outside the pool (the TPU path
    // clamps out-of-range indices the same way)
    const int pid = min(max(table[j], 0), N - 1);
    const size_t page = static_cast<size_t>(pid) * bs;
    for (int s0 = 0; s0 < bs; s0 += kGroup) {
      float sc[kGroup], ksc[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int slot = s0 + g;
        float part = 0.f;
        ksc[g] = 1.f;
        if (slot < bs && j * bs + slot <= qpos) {
          const PageT* kr = k_pages + ((page + slot) * H + h) * D;
          if (kScaled) ksc[g] = k_scales[(page + slot) * H + h];
#pragma unroll
          for (int e = 0; e < kEpl; ++e)
            part += qv[e] * to_float(kr[lane + 32 * e]);
        }
        sc[g] = part;
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) sc[g] = warp_sum(sc[g]);
      float gmax = kNegInf;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int slot = s0 + g;
        const bool live = slot < bs && j * bs + slot <= qpos;
        const float s = kScaled ? sc[g] * ksc[g] : sc[g];
        sc[g] = live ? s * scale : kNegInf;
        gmax = fmaxf(gmax, sc[g]);
      }
      const float m_new = fmaxf(m, gmax);
      const float alpha = expf(m - m_new);
#pragma unroll
      for (int e = 0; e < kEpl; ++e) acc[e] *= alpha;
      float psum = 0.f;
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
        const int slot = s0 + g;
        const bool live = slot < bs && j * bs + slot <= qpos;
        // a masked slot weighs exactly 0, even while the running max is
        // still -1e30 (exp(-1e30 - -1e30) is 1): multiplied by the mask
        // as the TPU kernel does, not branched around, so the V loads
        // below stay predicated and in flight together
        const float p = expf(sc[g] - m_new) * (live ? 1.f : 0.f);
        psum += p;
        if (live) {
          float pv = p;
          if (kScaled) pv *= v_scales[(page + slot) * H + h];
          const PageT* vr = v_pages + ((page + slot) * H + h) * D;
#pragma unroll
          for (int e = 0; e < kEpl; ++e)
            acc[e] += pv * to_float(vr[lane + 32 * e]);
        }
      }
      l = l * alpha + psum;
      m = m_new;
    }
  }

  // merge the warps' softmax states: a warp that saw no page holds
  // (m, l, acc) = (-1e30, 0, 0) and weighs nothing once any warp has a
  // real maximum
#pragma unroll
  for (int e = 0; e < kEpl; ++e) s_acc[warp][lane + 32 * e] = acc[e];
  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
  __syncthreads();
  float m_all = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, s_m[w]);
  float l_all = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) l_all += s_l[w] * expf(s_m[w] - m_all);
  const float l_safe = fmaxf(l_all, 1e-30f);
  float* orow = out + (static_cast<size_t>(t) * H + h) * D;
  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
    float o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) o += s_acc[w][d] * expf(s_m[w] - m_all);
    orow[d] = o / l_safe;
  }
}

// T query tokens (grid.x) by H heads (grid.y); D picks the instantiation.
template <typename PageT, bool kScaled, typename Query>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* block_tables, Query query, void* out, int T, int H,
           int D, int bs, int N, int MB, float scale, void* stream) {
  const dim3 grid(T, H);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_PAGED_ARGS                                                     \
  static_cast<const float*>(q), static_cast<const PageT*>(k_pages),        \
      static_cast<const PageT*>(v_pages),                                  \
      static_cast<const float*>(k_scales),                                 \
      static_cast<const float*>(v_scales),                                 \
      static_cast<const int32_t*>(block_tables), query,                    \
      static_cast<float*>(out), H, bs, N, MB, scale
  switch (D) {
    case 32:
      paged_attention_kernel<PageT, kScaled, 1, Query>
          <<<grid, block, 0, st>>>(MXT_PAGED_ARGS);
      break;
    case 64:
      paged_attention_kernel<PageT, kScaled, 2, Query>
          <<<grid, block, 0, st>>>(MXT_PAGED_ARGS);
      break;
    case 128:
      paged_attention_kernel<PageT, kScaled, 4, Query>
          <<<grid, block, 0, st>>>(MXT_PAGED_ARGS);
      break;
    case 256:
      paged_attention_kernel<PageT, kScaled, 8, Query>
          <<<grid, block, 0, st>>>(MXT_PAGED_ARGS);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXT_PAGED_ARGS
  return static_cast<int>(cudaGetLastError());
}

template <typename PageT, bool kScaled>
int launch_flat(const void* q, const void* k_pages, const void* v_pages,
                const void* k_scales, const void* v_scales,
                const void* block_tables, const void* seq_ids,
                const void* positions, void* out, int T, int H, int D,
                int bs, int N, int S, int MB, float scale, void* stream) {
  const FlatQuery query{static_cast<const int32_t*>(seq_ids),
                        static_cast<const int32_t*>(positions), S};
  return launch<PageT, kScaled>(q, k_pages, v_pages, k_scales, v_scales,
                                block_tables, query, out, T, H, D, bs, N,
                                MB, scale, stream);
}

}  // namespace

extern "C" {

int mxt_ragged_flat_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* block_tables,
                        const void* seq_ids, const void* positions,
                        void* out, int T, int H, int D, int bs, int N, int S,
                        int MB, float scale, void* stream) {
  return launch_flat<float, false>(q, k_pages, v_pages, nullptr, nullptr,
                                   block_tables, seq_ids, positions, out, T,
                                   H, D, bs, N, S, MB, scale, stream);
}

int mxt_ragged_flat_int8(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scales,
                         const void* v_scales, const void* block_tables,
                         const void* seq_ids, const void* positions,
                         void* out, int T, int H, int D, int bs, int N, int S,
                         int MB, float scale, void* stream) {
  return launch_flat<int8_t, true>(q, k_pages, v_pages, k_scales, v_scales,
                                   block_tables, seq_ids, positions, out, T,
                                   H, D, bs, N, S, MB, scale, stream);
}

int mxt_ragged_flat_fp8(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* block_tables,
                        const void* seq_ids, const void* positions,
                        void* out, int T, int H, int D, int bs, int N, int S,
                        int MB, float scale, void* stream) {
  return launch_flat<__nv_fp8_e4m3, true>(
      q, k_pages, v_pages, k_scales, v_scales, block_tables, seq_ids,
      positions, out, T, H, D, bs, N, S, MB, scale, stream);
}

// K4: q/out [S, Q, H, D], kv_lens/q_lens [S]
int mxt_ragged_chunk_f32(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_tables,
                         const void* kv_lens, const void* q_lens, void* out,
                         int S, int Q, int H, int D, int bs, int N, int MB,
                         float scale, void* stream) {
  const ChunkQuery query{static_cast<const int32_t*>(kv_lens),
                         static_cast<const int32_t*>(q_lens), Q};
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr,
                              block_tables, query, out, S * Q, H, D, bs, N,
                              MB, scale, stream);
}

// K5: q/out [S, H, D], kv_lens [S]
int mxt_ragged_decode_f32(const void* q, const void* k_pages,
                          const void* v_pages, const void* block_tables,
                          const void* kv_lens, void* out, int S, int H, int D,
                          int bs, int N, int MB, float scale, void* stream) {
  const DecodeQuery query{static_cast<const int32_t*>(kv_lens)};
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr,
                              block_tables, query, out, S, H, D, bs, N, MB,
                              scale, stream);
}

}  // extern "C"
