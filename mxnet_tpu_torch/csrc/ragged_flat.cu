// Flat ragged paged attention over a block-table-indirected KV pool,
// for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernels in mxnet_tpu/ops/ragged_attention.py:
//   K1  _flat_kernel        (f32 pages)
//   K2  _flat_quant_kernel  (int8 / fp8-e4m3 pages with per-(block, slot,
//                            head) f32 scales, dequantised in-tile)
// One templated kernel, instantiated per page type.
//
// What it computes: packed query token t (of T) belongs to sequence
// seq_ids[t] and sits at absolute position positions[t]; it attends
// causally over positions <= positions[t] of that sequence's paged
// history. Page j of the sequence lives at pool block
// block_tables[seq_ids[t], j]. Online softmax in f32, masked scores at
// -1e30 (never -inf), denominator floored at 1e-30, exactly as the TPU
// kernel does.
//
// What bounds it on the card: bytes. Every K/V byte of the live pages is
// read once per query token and used for 2 flops (one multiply-add in the
// score, one in the value sum); that is far below the ~20 flops/byte an
// H100 needs before its f32 units, not its HBM (3.35 TB/s), are the limit.
//
// Design: one CTA per (token, head), kWarps warps in it. The CTA reads
// the token's block-table row itself (the TPU kernel got the page ids by
// scalar prefetch) and stops at the last page that holds a position <=
// positions[t], so no byte past the causal end is read. Warp w walks pages
// w, w + kWarps, ... with its own online-softmax state (m, l, acc) in
// registers — the TPU grid walked one sequence's pages in order on one
// core; here the page walk of one long sequence is split kWarps ways so a
// decode step of a few tokens still puts hundreds of warps on the card —
// and the warps' states are merged through shared memory at the end. Each
// lane owns D/32 elements of the head, so a K or V row is one coalesced
// warp-wide load. Slots are taken kGroup at a time so their loads (and a
// quantised page's scales) are in flight together; scores are reduced
// with warp shuffles. Masked slots are neither loaded nor accumulated.
// Quantised pages move 1 byte per element instead of 4, which is the whole
// point of K2; the scale multiplies the reduced score (K) and the softmax
// weight (V), so the dequantised page never exists anywhere.
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

template <typename PageT, bool kScaled, int kEpl>
__global__ void __launch_bounds__(kWarps * 32)
flat_attention_kernel(const float* __restrict__ q,            // [T, H, D]
                      const PageT* __restrict__ k_pages,      // [N, bs, H, D]
                      const PageT* __restrict__ v_pages,      // [N, bs, H, D]
                      const float* __restrict__ k_scales,     // [N, bs, H]
                      const float* __restrict__ v_scales,     // [N, bs, H]
                      const int32_t* __restrict__ block_tables,  // [S, MB]
                      const int32_t* __restrict__ seq_ids,    // [T]
                      const int32_t* __restrict__ positions,  // [T]
                      float* __restrict__ out,                // [T, H, D]
                      int H, int bs, int N, int S, int MB, float scale) {
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
  const int sid = min(max(seq_ids[t], 0), S - 1);
  const int qpos = positions[t];
  const int32_t* table = block_tables + static_cast<size_t>(sid) * MB;
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
        const float p = expf(sc[g] - m_new);
        psum += p;
        if (slot < bs && j * bs + slot <= qpos) {
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

template <typename PageT, bool kScaled>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* k_scales, const void* v_scales,
           const void* block_tables, const void* seq_ids,
           const void* positions, void* out, int T, int H, int D, int bs,
           int N, int S, int MB, float scale, void* stream) {
  const dim3 grid(T, H);
  const dim3 block(kWarps * 32);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MXT_FLAT_ARGS                                                       \
  static_cast<const float*>(q), static_cast<const PageT*>(k_pages),         \
      static_cast<const PageT*>(v_pages),                                   \
      static_cast<const float*>(k_scales),                                  \
      static_cast<const float*>(v_scales),                                  \
      static_cast<const int32_t*>(block_tables),                            \
      static_cast<const int32_t*>(seq_ids),                                 \
      static_cast<const int32_t*>(positions), static_cast<float*>(out), H,  \
      bs, N, S, MB, scale
  switch (D) {
    case 32:
      flat_attention_kernel<PageT, kScaled, 1><<<grid, block, 0, st>>>(
          MXT_FLAT_ARGS);
      break;
    case 64:
      flat_attention_kernel<PageT, kScaled, 2><<<grid, block, 0, st>>>(
          MXT_FLAT_ARGS);
      break;
    case 128:
      flat_attention_kernel<PageT, kScaled, 4><<<grid, block, 0, st>>>(
          MXT_FLAT_ARGS);
      break;
    case 256:
      flat_attention_kernel<PageT, kScaled, 8><<<grid, block, 0, st>>>(
          MXT_FLAT_ARGS);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MXT_FLAT_ARGS
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mxt_ragged_flat_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* block_tables,
                        const void* seq_ids, const void* positions,
                        void* out, int T, int H, int D, int bs, int N, int S,
                        int MB, float scale, void* stream) {
  return launch<float, false>(q, k_pages, v_pages, nullptr, nullptr,
                              block_tables, seq_ids, positions, out, T, H, D,
                              bs, N, S, MB, scale, stream);
}

int mxt_ragged_flat_int8(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scales,
                         const void* v_scales, const void* block_tables,
                         const void* seq_ids, const void* positions,
                         void* out, int T, int H, int D, int bs, int N, int S,
                         int MB, float scale, void* stream) {
  return launch<int8_t, true>(q, k_pages, v_pages, k_scales, v_scales,
                              block_tables, seq_ids, positions, out, T, H, D,
                              bs, N, S, MB, scale, stream);
}

int mxt_ragged_flat_fp8(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* block_tables,
                        const void* seq_ids, const void* positions,
                        void* out, int T, int H, int D, int bs, int N, int S,
                        int MB, float scale, void* stream) {
  return launch<__nv_fp8_e4m3, true>(q, k_pages, v_pages, k_scales, v_scales,
                                     block_tables, seq_ids, positions, out, T,
                                     H, D, bs, N, S, MB, scale, stream);
}

}  // extern "C"
