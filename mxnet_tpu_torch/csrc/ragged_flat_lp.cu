// The bf16 and f16 entry points of the staged paged attention kernel
// (paged_ring.cuh, where the design is written down): K1, K4 and K5 over
// 16-bit pages, the port of the TPU kernels' cast of any float page to
// f32 (mxnet_tpu/ops/ragged_attention.py _flat_kernel, _chunk_kernel,
// _decode_kernel). The pages stream through the ring at 2 bytes an
// element and become f32 where they are read; the products and the
// online softmax are f32. q is f32 (the serving step's), bf16 or f16
// (q_dtype 0, 1, 2), whatever the pages' dtype; the output is in q's
// dtype. Built on its own, beside csrc/ragged_flat.cu, so the two builds
// run in parallel.
//
// What bounds them is what bounds the f32 kernels (bytes of the live
// pages, and at a decode step's few tokens the latency of each page
// walk): half the page bytes halve the first, not the second.
#include "paged_ring.cuh"

#define MXT_PAGED_LP(SUFFIX, PAGE_T)                                        \
  /* K1: q/out [T, H, D] in q_dtype, pages [N, bs, H, D] PAGE_T; plan from  \
     flat_plan, then dealt (1: the pack-independent page order) */       \
  int mxt_ragged_flat_##SUFFIX(                                             \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* block_tables, const void* seq_ids, const void* positions, \
      void* out, int T, int H, int D, int bs, int N, int S, int MB, int qt, \
      int heads, int splits, int stages, int subs, int dealt, int q_dtype,  \
      float scale, void* stream) {                                          \
    return launch_flat<PAGE_T, false>(                                      \
        q, k_pages, v_pages, nullptr, nullptr, block_tables, seq_ids,       \
        positions, out, T, H, D, bs, N, S, MB, qt, heads, splits, stages,   \
        subs, dealt, q_dtype, scale, stream);                               \
  }                                                                         \
  /* K4: q/out [S, Q, H, D], kv_lens/q_lens [S]; plan from paged_plan */    \
  int mxt_ragged_chunk_##SUFFIX(                                            \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* block_tables, const void* kv_lens, const void* q_lens,    \
      void* out, int S, int Q, int H, int D, int bs, int N, int MB,         \
      int heads, int splits, int stages, int subs, int q_dtype,             \
      float scale, void* stream) {                                          \
    return launch_chunk<PAGE_T>(q, k_pages, v_pages, block_tables, kv_lens, \
                                q_lens, out, S, Q, H, D, bs, N, MB, heads,  \
                                splits, stages, subs, q_dtype, scale,       \
                                stream);                                    \
  }                                                                         \
  /* K5: q/out [S, H, D], kv_lens [S]; plan from paged_plan (Q = 1) */      \
  int mxt_ragged_decode_##SUFFIX(                                           \
      const void* q, const void* k_pages, const void* v_pages,              \
      const void* block_tables, const void* kv_lens, void* out, int S,      \
      int H, int D, int bs, int N, int MB, int heads, int splits,           \
      int stages, int subs, int q_dtype, float scale, void* stream) {       \
    return launch_decode<PAGE_T>(q, k_pages, v_pages, block_tables,         \
                                 kv_lens, out, S, H, D, bs, N, MB, heads,   \
                                 splits, stages, subs, q_dtype, scale,      \
                                 stream);                                   \
  }

extern "C" {

MXT_PAGED_LP(bf16, __nv_bfloat16)
MXT_PAGED_LP(f16, __half)

}  // extern "C"
#undef MXT_PAGED_LP
