// Multi-tensor optimizer update: MXNet's update rules
// (mxnet_tpu/ops/optimizer_ops.py; the port's twins in
// mxnet_tpu_torch/ops/optimizer_ops.py) over many parameters in one launch.
//
// Replaces no TPU kernel. The reference applies a whole Trainer step as one
// XLA program (mxnet_tpu/optimizer/fused.py FusedUpdater), its framework's
// counterpart of MXNet's multi-tensor multi_sgd_* kernels; this is the
// port's. One templated grid-stride kernel per update rule walks a launch
// table: per tensor its weight's and up to three states' pointers, its
// element count (64-bit), its first chunk and its row of the step's table.
// The table stays on the card while those stay put (the update is in
// place); each step uploads only the rows: per tensor its scalars (lr, wd,
// betas, ...: lr_mult, wd_mult and each index's step count make them
// differ) and its gradient's address (autograd hands out a new gradient
// tensor every backward). _adamw_update's rescale_grad_arr, a one-element
// f32 tensor on the card, rides its row as an address too (int64 word
// kRescaleWord; 0: the row's float rescale): the kernel reads the scale on
// the device, so nothing syncs and a captured step reads what the tensor
// holds when it replays. The SGD rules (sgd, sgd_mom and their mp forms)
// read a per-tensor lr and wd the same way where the row holds their
// addresses (int64 words kLrWord and kWdWord; 0: the row's floats): the
// preloaded_multi_* ops take lrs and wds as arrays on the card. The mp
// NAG and mp AdamW rules are the port's mp_nag_mom_update and
// _mp_adamw_update, and FTML is ftml_update (mxnet_tpu/ops/extra.py).
// Each CTA takes chunks of kChunk
// elements, finds its tensor by a binary search over the first chunks, and
// streams the chunk with 16-byte loads of f32 (8-byte of 16-bit) buffers
// where all of the tensor's pointers are so aligned, element by element
// where they are not.
//
// Weights: f32 for every rule; bf16 or f16 for the mp rules (f32 states
// and arithmetic, as their twins upcast) and for the rules of
// kernel_takes_16bit (states of the weight's type, each operation's result
// rounded to it, as torch rounds each op of the twin on 16-bit tensors:
// a Trainer stepping a net cast to bfloat16 without multi_precision).
//
// Bound by bytes: each element reads the weight, the gradient and the
// states once and writes the weight and the states once (Adam in f32: 28
// bytes), a few operations per byte, far under the card's rate.
//
// Rounding: the kernel keeps the twin's bits. Each operation of the twin
// is one __fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn / __fsqrt_rn, in the
// twin's order; nvcc never contracts those into an FMA, so the library's
// -O3 flags (hashed for every source) stay as they are. Every scalar comes
// from the host, computed in float64 and rounded to f32 once, as torch
// rounds a Python scalar: (1 - beta1) is a table entry, not 1.0f - beta1.
// sgn() is jnp.sign's (x itself where x is NaN or either zero, else +-1:
// the twin's ops/elemwise.py sign), clamp() passes NaN through as torch's
// does, and 16-bit values round to nearest even as torch's .to() does.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr long long kChunk = 32768;  // ops/optimizer_ops.py CHUNK
constexpr int kRow = 16;             // ops/optimizer_ops.py SCALAR_ROW
constexpr int kScalars = kRow - 2;   // then the gradient's address
// the int64 word of a row that holds _adamw_update's rescale array's
// address (ops/optimizer_ops.py RESCALE_WORD), past its ten scalars
constexpr int kRescaleWord = 5;
// the int64 words of an SGD rule's row that hold the addresses of its lr
// and wd (ops/optimizer_ops.py LR_WORD, WD_WORD), past its five scalars
constexpr int kLrWord = 3;
constexpr int kWdWord = 4;

// one tensor of the launch table: eight int64 words packed by the host
// (ops/optimizer_ops.py UpdateTable); p[1], the gradient's slot, is unused
struct Entry {
  void* p[5];
  long long n;
  long long chunk0;
  long long row;
};
static_assert(sizeof(Entry) == 64, "the host packs eight words a tensor");

// the rule numbers of ops/optimizer_ops.py RULES
enum Rule {
  kSgd = 0, kSgdMom, kNagMom, kMpSgd, kMpSgdMom, kAdam, kAdamW, kRmsProp,
  kRmsPropAlex, kFtrl, kSignSgd, kSignum, kAdaGrad, kMpNagMom, kMpAdamW, kFtml
};

__host__ __device__ constexpr int n_states(int r) {
  return r == kSgd || r == kSignSgd ? 0
       : r == kSgdMom || r == kNagMom || r == kMpSgd || r == kRmsProp ||
         r == kSignum || r == kAdaGrad ? 1
       : r == kRmsPropAlex || r == kMpAdamW || r == kFtml ? 3 : 2;
}
__host__ __device__ constexpr bool is_mp(int r) {
  return r == kMpSgd || r == kMpSgdMom || r == kMpNagMom || r == kMpAdamW;
}
// the non-mp rules that take 16-bit weights (ops/optimizer_ops.py RULES'
// low16): their twins use only Python scalars, so rounding each operation
// to the weight's type gives the twin's bits; _adamw_update (its rescale
// array promotes to f32), ftrl_update and ftml_update (they divide by a 0-d
// tensor of the weight's type) take f32 only
__host__ __device__ constexpr bool takes_16bit(int r) {
  return r == kSgd || r == kSgdMom || r == kNagMom || r == kAdam ||
         r == kRmsProp || r == kRmsPropAlex || r == kSignSgd ||
         r == kSignum || r == kAdaGrad;
}
// the SGD rules, whose lr (s[0]) and wd may come from addresses in the row
__host__ __device__ constexpr bool reads_lr_wd(int r) {
  return r == kSgd || r == kSgdMom || r == kMpSgd || r == kMpSgdMom;
}
__host__ __device__ constexpr int wd_slot(int r) {
  return r == kSgd || r == kMpSgd ? 1 : 2;
}

// x rounded to CT (nearest even) and widened back: a torch op's result on
// CT tensors, computed in f32
template <typename CT> __device__ __forceinline__ float rnd(float x);
template <> __device__ __forceinline__ float rnd<float>(float x) { return x; }
template <> __device__ __forceinline__ float rnd<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <> __device__ __forceinline__ float rnd<__half>(float x) {
  return __half2float(__float2half_rn(x));
}

// the twin's operations on CT values: each in f32, rounded to CT
template <typename CT> struct Ops {
  static __device__ __forceinline__ float mul(float a, float b) {
    return rnd<CT>(__fmul_rn(a, b));
  }
  static __device__ __forceinline__ float add(float a, float b) {
    return rnd<CT>(__fadd_rn(a, b));
  }
  static __device__ __forceinline__ float sub(float a, float b) {
    return rnd<CT>(__fsub_rn(a, b));
  }
  static __device__ __forceinline__ float dvd(float a, float b) {
    return rnd<CT>(__fdiv_rn(a, b));
  }
  static __device__ __forceinline__ float sqr(float a) {
    return rnd<CT>(__fsqrt_rn(a));
  }
  // torch.clamp(x, -c, c), NaN passed through
  static __device__ __forceinline__ float clamp(float x, float c) {
    return isnan(x) ? x : rnd<CT>(fminf(fmaxf(x, -c), c));
  }
  // grad * rescale_grad, clipped where clip_gradient >= 0
  static __device__ __forceinline__ float prep(float g, float rescale,
                                               float clip) {
    g = mul(g, rescale);
    return clip >= 0.f ? clamp(g, clip) : g;
  }
};
// jnp.sign: x itself where x is NaN or +-0, else +-1 (exact in any type)
__device__ __forceinline__ float sgn(float x) {
  return (isnan(x) || x == 0.f) ? x : (x > 0.f ? 1.f : -1.f);
}

// one element of rule R in the arithmetic of CT: w and the states st in
// and out, g in; s the row (its layout is the rule's _row_* function in
// ops/optimizer_ops.py)
template <int R, typename CT>
__device__ __forceinline__ void apply(const float* s, float& w, float gr,
                                      float* st) {
  using O = Ops<CT>;
  if constexpr (R == kSgd || R == kSignSgd) {  // lr wd rescale clip
    const float g = O::prep(gr, s[2], s[3]);
    const float d = R == kSgd ? g : sgn(g);
    w = O::sub(w, O::mul(s[0], O::add(d, O::mul(s[1], w))));
  } else if constexpr (R == kSgdMom) {  // lr momentum wd rescale clip
    const float g = O::prep(gr, s[3], s[4]);
    st[0] = O::sub(O::mul(s[1], st[0]),
                   O::mul(s[0], O::add(g, O::mul(s[2], w))));
    w = O::add(w, st[0]);
  } else if constexpr (R == kNagMom) {  // lr momentum wd rescale clip
    const float g = O::add(O::prep(gr, s[3], s[4]), O::mul(s[2], w));
    st[0] = O::add(O::mul(s[1], st[0]), g);
    w = O::sub(w, O::mul(s[0], O::add(g, O::mul(s[1], st[0]))));
  } else if constexpr (R == kMpSgd) {  // lr wd rescale clip; st: w32
    const float g = O::prep(gr, s[2], s[3]);
    st[0] = O::sub(st[0], O::mul(s[0], O::add(g, O::mul(s[1], st[0]))));
    w = st[0];
  } else if constexpr (R == kMpSgdMom) {  // lr momentum wd rescale clip;
    const float g = O::prep(gr, s[3], s[4]);  // st: mom, w32
    st[0] = O::sub(O::mul(s[1], st[0]),
                   O::mul(s[0], O::add(g, O::mul(s[2], st[1]))));
    st[1] = O::add(st[1], st[0]);
    w = st[1];
  } else if constexpr (R == kAdam) {
    // lr b1 1-b1 b2 1-b2 eps wd rescale clip; st: mean, var
    const float g = O::add(O::prep(gr, s[7], s[8]), O::mul(s[6], w));
    st[0] = O::add(O::mul(s[1], st[0]), O::mul(s[2], g));
    st[1] = O::add(O::mul(s[3], st[1]), O::mul(s[4], O::mul(g, g)));
    w = O::sub(w,
               O::dvd(O::mul(s[0], st[0]), O::add(O::sqr(st[1]), s[5])));
  } else if constexpr (R == kAdamW) {
    // lr b1 1-b1 b2 1-b2 eps wd eta rescale clip; st: mean, var
    const float g = O::prep(gr, s[8], s[9]);
    st[0] = O::add(O::mul(s[1], st[0]), O::mul(s[2], g));
    st[1] = O::add(O::mul(s[3], st[1]), O::mul(s[4], O::mul(g, g)));
    w = O::sub(w, O::mul(s[7], O::add(O::dvd(O::mul(s[0], st[0]),
                                             O::add(O::sqr(st[1]), s[5])),
                                      O::mul(s[6], w))));
  } else if constexpr (R == kRmsProp) {
    // lr rho 1-rho eps wd rescale clip clip_weights; st: n
    const float g = O::add(O::prep(gr, s[5], s[6]), O::mul(s[4], w));
    st[0] = O::add(O::mul(s[1], st[0]), O::mul(s[2], O::mul(g, g)));
    w = O::sub(w, O::dvd(O::mul(s[0], g), O::sqr(O::add(st[0], s[3]))));
    if (s[7] > 0.f) w = O::clamp(w, s[7]);
  } else if constexpr (R == kRmsPropAlex) {
    // lr rho 1-rho momentum eps wd rescale clip clip_weights;
    // st: n, g_avg, delta
    const float g = O::add(O::prep(gr, s[6], s[7]), O::mul(s[5], w));
    st[0] = O::add(O::mul(s[1], st[0]), O::mul(s[2], O::mul(g, g)));
    st[1] = O::add(O::mul(s[1], st[1]), O::mul(s[2], g));
    st[2] = O::sub(O::mul(s[3], st[2]),
                   O::dvd(O::mul(s[0], g),
                          O::sqr(O::add(O::sub(st[0], O::mul(st[1], st[1])),
                                        s[4]))));
    w = O::add(w, st[2]);
    if (s[8] > 0.f) w = O::clamp(w, s[8]);
  } else if constexpr (R == kFtrl) {
    // lr lamda1 beta wd rescale clip; st: z, n
    const float g = O::prep(gr, s[4], s[5]);
    const float n = O::add(st[1], O::mul(g, g));
    const float root = O::sqr(n);
    const float sigma = O::dvd(O::sub(root, O::sqr(st[1])), s[0]);
    st[0] = O::sub(O::add(st[0], g), O::mul(sigma, w));
    st[1] = n;
    const float z = st[0];
    w = fabsf(z) <= s[1]
            ? 0.f
            : O::dvd(-O::sub(z, O::mul(sgn(z), s[1])),
                     O::add(O::dvd(O::add(root, s[2]), s[0]), s[3]));
  } else if constexpr (R == kSignum) {
    // lr momentum 1-momentum wd (1-lr*wd_lh) rescale clip; st: mom
    const float g = O::prep(gr, s[5], s[6]);
    st[0] = O::sub(O::mul(s[1], st[0]),
                   O::mul(s[2], O::add(g, O::mul(s[3], w))));
    w = O::add(O::mul(s[4], w), O::mul(s[0], sgn(st[0])));
  } else if constexpr (R == kAdaGrad) {  // lr eps wd rescale clip; st: h
    const float g = O::add(O::prep(gr, s[3], s[4]), O::mul(s[2], w));
    st[0] = O::add(st[0], O::mul(g, g));
    w = O::sub(w, O::dvd(O::mul(s[0], g), O::add(O::sqr(st[0]), s[1])));
  } else if constexpr (R == kMpNagMom) {
    // lr momentum wd rescale clip; st: mom, w32
    const float g = O::add(O::prep(gr, s[3], s[4]), O::mul(s[2], st[1]));
    st[0] = O::sub(O::mul(s[1], st[0]), O::mul(s[0], g));
    st[1] = O::sub(O::add(st[1], O::mul(s[1], st[0])), O::mul(s[0], g));
    w = st[1];
  } else if constexpr (R == kMpAdamW) {
    // lr b1 1-b1 b2 1-b2 eps wd eta rescale clip; st: mean, var, w32
    const float g = O::prep(gr, s[8], s[9]);
    st[0] = O::add(O::mul(s[1], st[0]), O::mul(s[2], g));
    st[1] = O::add(O::mul(s[3], st[1]), O::mul(s[4], O::mul(g, g)));
    st[2] = O::sub(st[2], O::mul(s[7], O::add(O::dvd(O::mul(s[0], st[0]),
                                                     O::add(O::sqr(st[1]),
                                                            s[5])),
                                              O::mul(s[6], st[2]))));
    w = st[2];
  } else if constexpr (R == kFtml) {
    // b1 1-b1 b2 1-b2 eps wd rescale clip (1-b1^t)/lr 1-b2^t; st: d, v, z
    const float g = O::add(O::prep(gr, s[6], s[7]), O::mul(s[5], w));
    st[1] = O::add(O::mul(s[2], st[1]), O::mul(s[3], O::mul(g, g)));
    const float dt = O::mul(s[8], O::add(O::sqr(O::dvd(st[1], s[9])), s[4]));
    st[2] = O::sub(O::add(O::mul(s[0], st[2]), O::mul(s[1], g)),
                   O::mul(O::sub(dt, O::mul(s[0], st[0])), w));
    st[0] = dt;
    w = O::dvd(-st[2], dt);
  }
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f(__half x) { return __half2float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f(float x) {
  return __float2half_rn(x);
}

// four elements of a T buffer at element i (aligned: 16 bytes of f32, 8 of
// 16-bit), as floats, and back
template <typename T>
__device__ __forceinline__ void load4(const void* p, long long i,
                                      float (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    const float4 v = reinterpret_cast<const float4*>(p)[i >> 2];
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    const uint2 v = reinterpret_cast<const uint2*>(p)[i >> 2];
    const T* h = reinterpret_cast<const T*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = to_f(h[k]);
  }
}
template <typename T>
__device__ __forceinline__ void store4(void* p, long long i,
                                       const float (&x)[4]) {
  if constexpr (sizeof(T) == 4) {
    reinterpret_cast<float4*>(p)[i >> 2] = make_float4(x[0], x[1], x[2],
                                                       x[3]);
  } else {
    uint2 v;
    T* h = reinterpret_cast<T*>(&v);
#pragma unroll
    for (int k = 0; k < 4; ++k) h[k] = from_f<T>(x[k]);
    reinterpret_cast<uint2*>(p)[i >> 2] = v;
  }
}

__device__ __forceinline__ bool aligned(const void* p, int bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// WT: the weight's and the gradient's type; the states are f32 for an mp
// rule (its arithmetic too), else of type WT, as its arithmetic
template <int R, typename WT>
__global__ void __launch_bounds__(kThreads)
multi_update_kernel(const Entry* __restrict__ tab, int ntensors,
                    long long nchunks, const float* __restrict__ scalars) {
  constexpr int S = n_states(R);
  constexpr bool kMp = is_mp(R);
  using ST = typename std::conditional<kMp, float, WT>::type;
  for (long long c = blockIdx.x; c < nchunks; c += gridDim.x) {
    int lo = 0, hi = ntensors - 1;  // the last tensor whose chunk0 <= c
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (tab[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    const Entry& e = tab[lo];
    const float* const row = scalars + e.row * kRow;
    float s[kScalars];
#pragma unroll
    for (int k = 0; k < kScalars; ++k) s[k] = row[k];
    const long long* const words = reinterpret_cast<const long long*>(row);
    if constexpr (R == kAdamW || R == kMpAdamW) {
      // the rescale array replaces s[8]
      const float* const rs =
          reinterpret_cast<const float*>(words[kRescaleWord]);
      if (rs != nullptr) s[8] = *rs;
    }
    if constexpr (reads_lr_wd(R)) {  // lr and wd arrays replace theirs
      const float* const lr = reinterpret_cast<const float*>(words[kLrWord]);
      const float* const wd = reinterpret_cast<const float*>(words[kWdWord]);
      if (lr != nullptr) s[0] = *lr;
      if (wd != nullptr) s[wd_slot(R)] = *wd;
    }
    void* const pw = e.p[0];
    const void* const pg = reinterpret_cast<const void*>(words[kRow / 2 - 1]);
    ST* st_p[S > 0 ? S : 1];
#pragma unroll
    for (int j = 0; j < S; ++j) st_p[j] = static_cast<ST*>(e.p[2 + j]);
    const long long begin = (c - e.chunk0) * kChunk;
    const long long end = min(begin + kChunk, e.n);
    bool vec = aligned(pw, 4 * sizeof(WT)) && aligned(pg, 4 * sizeof(WT));
#pragma unroll
    for (int j = 0; j < S; ++j) vec = vec && aligned(st_p[j], 4 * sizeof(ST));
    long long tail = begin;
    if (vec) {  // begin is a multiple of 4: the chunk keeps the alignment
      tail = begin + ((end - begin) & ~3LL);
      for (long long i = begin + 4LL * threadIdx.x; i < tail;
           i += 4LL * kThreads) {
        float w[4], g[4], st[S > 0 ? S : 1][4];
        if (!kMp) load4<WT>(pw, i, w);
        load4<WT>(pg, i, g);
#pragma unroll
        for (int j = 0; j < S; ++j) load4<ST>(st_p[j], i, st[j]);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float sk[S > 0 ? S : 1];
#pragma unroll
          for (int j = 0; j < S; ++j) sk[j] = st[j][k];
          if (kMp) w[k] = 0.f;
          apply<R, ST>(s, w[k], g[k], sk);
#pragma unroll
          for (int j = 0; j < S; ++j) st[j][k] = sk[j];
        }
        store4<WT>(pw, i, w);
#pragma unroll
        for (int j = 0; j < S; ++j) store4<ST>(st_p[j], i, st[j]);
      }
    }
    for (long long i = tail + threadIdx.x; i < end; i += kThreads) {
      float w = kMp ? 0.f : to_f(static_cast<const WT*>(pw)[i]);
      const float g = to_f(static_cast<const WT*>(pg)[i]);
      float st[S > 0 ? S : 1];
#pragma unroll
      for (int j = 0; j < S; ++j) st[j] = to_f(st_p[j][i]);
      apply<R, ST>(s, w, g, st);
      static_cast<WT*>(pw)[i] = from_f<WT>(w);
#pragma unroll
      for (int j = 0; j < S; ++j) st_p[j][i] = from_f<ST>(st[j]);
    }
  }
}

template <int R, typename WT>
cudaError_t launch(const void* table, int ntensors, long long nchunks,
                   const float* scalars, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long grid = nchunks < 8LL * sms ? nchunks : 8LL * sms;
  multi_update_kernel<R, WT><<<static_cast<unsigned>(grid), kThreads, 0,
                               stream>>>(
      static_cast<const Entry*>(table), ntensors, nchunks, scalars);
  return cudaGetLastError();
}

template <int R>
cudaError_t launch_f32(int wdtype, const void* table, int ntensors,
                       long long nchunks, const float* scalars,
                       cudaStream_t stream) {
  if (wdtype != 0) return cudaErrorInvalidValue;
  return launch<R, float>(table, ntensors, nchunks, scalars, stream);
}

// a rule of takes_16bit or an mp rule: f32 (not for the mp rules), bf16
// or f16 weights
template <int R>
cudaError_t launch_any(int wdtype, const void* table, int ntensors,
                       long long nchunks, const float* scalars,
                       cudaStream_t stream) {
  static_assert(takes_16bit(R) || is_mp(R), "an f32-only rule");
  if constexpr (!is_mp(R)) {
    if (wdtype == 0)
      return launch<R, float>(table, ntensors, nchunks, scalars, stream);
  }
  if (wdtype == 1)
    return launch<R, __nv_bfloat16>(table, ntensors, nchunks, scalars,
                                    stream);
  if (wdtype == 2)
    return launch<R, __half>(table, ntensors, nchunks, scalars, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

// rule: ops/optimizer_ops.py RULES' number; wdtype: the weight's dtype (0
// f32, 1 bf16, 2 f16; 16-bit for the mp rules and those of takes_16bit);
// table: ntensors entries; scalars: the step's rows the entries name, 64
// bytes each (kRow - 2 floats, then the gradient's address)
extern "C" int mxt_multi_tensor_update(int rule, int wdtype,
                                       const void* table, int ntensors,
                                       long long nchunks,
                                       const float* scalars, void* stream) {
  if (ntensors <= 0 || nchunks <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch (rule) {
#define MXT_F32(R) \
  case R: e = launch_f32<R>(wdtype, table, ntensors, nchunks, scalars, st); \
    break;
#define MXT_ANY(R) \
  case R: e = launch_any<R>(wdtype, table, ntensors, nchunks, scalars, st); \
    break;
    MXT_ANY(kSgd) MXT_ANY(kSgdMom) MXT_ANY(kNagMom) MXT_ANY(kAdam)
    MXT_F32(kAdamW) MXT_ANY(kRmsProp) MXT_ANY(kRmsPropAlex) MXT_F32(kFtrl)
    MXT_ANY(kSignSgd) MXT_ANY(kSignum) MXT_ANY(kAdaGrad) MXT_F32(kFtml)
    MXT_ANY(kMpSgd) MXT_ANY(kMpSgdMom) MXT_ANY(kMpNagMom) MXT_ANY(kMpAdamW)
#undef MXT_F32
#undef MXT_ANY
    default:
      e = cudaErrorInvalidValue;
  }
  return static_cast<int>(e);
}
