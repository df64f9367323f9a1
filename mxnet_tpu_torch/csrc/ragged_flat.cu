// The f32, int8 and fp8 entry points of the staged paged attention
// kernel (paged_ring.cuh, where the design is written down): K1 and K4/K5
// over f32 pages, K2 over int8 / fp8-e4m3 pages with f32 scales. q and
// the output are f32, bf16 or f16 (q_dtype 0, 1, 2: the int before the
// scale). csrc/ragged_flat_lp.cu holds the bf16 and f16 page entry
// points, built on their own beside this source.
#include "paged_ring.cuh"

extern "C" {

// K1: q/out [T, H, D], pages [N, bs, H, D] f32; plan (qt, heads, splits,
// stages, subs) from flat_plan, then dealt (1: the pack-independent
// page order)
int mxt_ragged_flat_f32(const void* q, const void* k_pages,
                        const void* v_pages, const void* block_tables,
                        const void* seq_ids, const void* positions,
                        void* out, int T, int H, int D, int bs, int N, int S,
                        int MB, int qt, int heads, int splits, int stages,
                        int subs, int dealt, int q_dtype, float scale,
                        void* stream) {
  return launch_flat<float, false>(
      q, k_pages, v_pages, nullptr, nullptr, block_tables, seq_ids,
      positions, out, T, H, D, bs, N, S, MB, qt, heads, splits, stages, subs,
      dealt, q_dtype, scale, stream);
}

// K2: as K1 with int8 / fp8 pages and scales [N, bs, H] f32
int mxt_ragged_flat_int8(const void* q, const void* k_pages,
                         const void* v_pages, const void* k_scales,
                         const void* v_scales, const void* block_tables,
                         const void* seq_ids, const void* positions,
                         void* out, int T, int H, int D, int bs, int N, int S,
                         int MB, int qt, int heads, int splits, int stages,
                         int subs, int dealt, int q_dtype, float scale,
                         void* stream) {
  return launch_flat<int8_t, true>(
      q, k_pages, v_pages, k_scales, v_scales, block_tables, seq_ids,
      positions, out, T, H, D, bs, N, S, MB, qt, heads, splits, stages, subs,
      dealt, q_dtype, scale, stream);
}

int mxt_ragged_flat_fp8(const void* q, const void* k_pages,
                        const void* v_pages, const void* k_scales,
                        const void* v_scales, const void* block_tables,
                        const void* seq_ids, const void* positions,
                        void* out, int T, int H, int D, int bs, int N, int S,
                        int MB, int qt, int heads, int splits, int stages,
                        int subs, int dealt, int q_dtype, float scale,
                        void* stream) {
  return launch_flat<__nv_fp8_e4m3, true>(
      q, k_pages, v_pages, k_scales, v_scales, block_tables, seq_ids,
      positions, out, T, H, D, bs, N, S, MB, qt, heads, splits, stages, subs,
      dealt, q_dtype, scale, stream);
}

// K4: q/out [S, Q, H, D], kv_lens/q_lens [S]; plan from paged_plan
int mxt_ragged_chunk_f32(const void* q, const void* k_pages,
                         const void* v_pages, const void* block_tables,
                         const void* kv_lens, const void* q_lens, void* out,
                         int S, int Q, int H, int D, int bs, int N, int MB,
                         int heads, int splits, int stages, int subs,
                         int q_dtype, float scale, void* stream) {
  return launch_chunk<float>(q, k_pages, v_pages, block_tables, kv_lens,
                             q_lens, out, S, Q, H, D, bs, N, MB, heads,
                             splits, stages, subs, q_dtype, scale, stream);
}

// K5: q/out [S, H, D], kv_lens [S]; plan from paged_plan (Q = 1)
int mxt_ragged_decode_f32(const void* q, const void* k_pages,
                          const void* v_pages, const void* block_tables,
                          const void* kv_lens, void* out, int S, int H, int D,
                          int bs, int N, int MB, int heads, int splits,
                          int stages, int subs, int q_dtype, float scale,
                          void* stream) {
  return launch_decode<float>(q, k_pages, v_pages, block_tables, kv_lens,
                              out, S, H, D, bs, N, MB, heads, splits, stages,
                              subs, q_dtype, scale, stream);
}

}  // extern "C"
