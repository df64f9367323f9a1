// Weight-only quantised matmul for NVIDIA Hopper (sm_90a):
//   out[t, c] = (sum_k x[t, k] * qw[k, c]) * s[c]
// x f32 [T, K]; qw int8 or fp8-e4m3 [K, N]; s f32 [N] (one scale per
// output column); out f32 [T, N].
//
// Replaces the TPU kernel K3, _wq_matmul_kernel in
// mxnet_tpu/ops/quantization.py, whose point is that the f32 weight
// matrix never exists in device memory: only the 1-byte weights are read.
//
// What bounds it on the card: at decode batch sizes (T of 8 to 128) the
// weight bytes. K*N bytes of weights against 2*T*K*N flops is 2*T flops
// per weight byte, below the ~20 flops/byte where an H100's f32 units
// (67 TFLOP/s) rather than its HBM (3.35 TB/s) set the pace for T <= 10;
// past that the f32 arithmetic does, since this kernel runs on the CUDA
// cores, not the tensor cores.
//
// Design: a shared-memory tiled f32 GEMM. A CTA owns a kBM x 64 output
// tile (kBM = 16 when T <= 16, so a decode batch wastes few rows, else
// 64) and a slice of K, which it walks in steps of 16: it stages a
// kBM x 16 tile of x and a 16 x 64 tile of qw, widening each weight byte
// to f32 as it lands in shared memory, so each weight byte is read from
// HBM once per kBM rows of x. 256 threads each accumulate kBM/16 x 4
// outputs in f32 registers. A 768-column projection has only 12 column
// tiles, too few for 132 SMs, so the caller splits K over `splits` CTAs
// per tile: each writes its partial tile to scratch, and a second kernel
// sums the partials in split order (deterministic, no atomics) and
// applies the per-column scale; with one split the scale is applied in
// the first kernel's epilogue. The scale factors out of each column's
// sum, so it is applied once per output, as quantized_matmul_reference
// does. Rows past T and columns past N (the LM head's N = 50257 leaves a
// ragged last tile) are masked on load and on store.
#include <cuda_runtime.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace {

constexpr int kBN = 64;
constexpr int kBK = 16;
constexpr int kTN = 4;
constexpr int kThreads = 256;
constexpr int kColThreads = kBN / kTN;          // 16
constexpr int kRowThreads = kThreads / kColThreads;  // 16

__device__ __forceinline__ float to_float(int8_t v) {
  return static_cast<float>(v);
}
__device__ __forceinline__ float to_float(__nv_fp8_e4m3 v) {
  return static_cast<float>(v);
}

// dst is `out` (scaled) when scaled, else the split's scratch slice
template <typename WT, int kBM>
__global__ void __launch_bounds__(kThreads)
wq_matmul_kernel(const float* __restrict__ x, const WT* __restrict__ qw,
                 const float* __restrict__ s, float* __restrict__ dst,
                 int T, int K, int N, int k_per_split, bool scaled) {
  constexpr int kTM = kBM / kRowThreads;
  __shared__ float xs[kBK][kBM];
  __shared__ float ws[kBK][kBN];
  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * kBM;
  const int k_begin = blockIdx.z * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  float* d = dst + static_cast<size_t>(blockIdx.z) * T * N;
  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
#pragma unroll
    for (int r = 0; r < (kBM * kBK + kThreads - 1) / kThreads; ++r) {
      const int e = tid + kThreads * r;
      if (e < kBM * kBK) {
        const int row = e / kBK, kk = e % kBK;
        const int gm = m0 + row, gk = k0 + kk;
        xs[kk][row] = (gm < T && gk < k_end)
                          ? x[static_cast<size_t>(gm) * K + gk] : 0.f;
      }
    }
#pragma unroll
    for (int r = 0; r < (kBK * kBN) / kThreads; ++r) {
      const int e = tid + kThreads * r;
      const int kk = e / kBN, cc = e % kBN;
      const int gk = k0 + kk, gn = n0 + cc;
      ws[kk][cc] = (gk < k_end && gn < N)
                       ? to_float(qw[static_cast<size_t>(gk) * N + gn])
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[kk][ty * kTM + i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[kk][tx * kTN + j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int gm = m0 + ty * kTM + i;
    if (gm >= T) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int gn = n0 + tx * kTN + j;
      if (gn < N)
        d[static_cast<size_t>(gm) * N + gn] =
            scaled ? acc[i][j] * s[gn] : acc[i][j];
    }
  }
}

// out[t, c] = s[c] * sum over splits z (in order) of scratch[z, t, c]
__global__ void __launch_bounds__(kThreads)
split_sum_kernel(const float* __restrict__ scratch,
                 const float* __restrict__ s, float* __restrict__ out,
                 int T, int N, int splits) {
  const size_t total = static_cast<size_t>(T) * N;
  for (size_t i = blockIdx.x * static_cast<size_t>(kThreads) + threadIdx.x;
       i < total; i += static_cast<size_t>(gridDim.x) * kThreads) {
    float acc = 0.f;
    for (int z = 0; z < splits; ++z) acc += scratch[z * total + i];
    out[i] = acc * s[i % N];
  }
}

template <typename WT>
int launch(const void* x, const void* qw, const void* s, void* out,
           void* scratch, int T, int K, int N, int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (splits < 1) return static_cast<int>(cudaErrorInvalidValue);
  // K slices are whole 16-deep steps; the last one may be shorter
  const int k_per_split =
      ((K + splits - 1) / splits + kBK - 1) / kBK * kBK;
  const bool one = splits == 1;
  float* dst = static_cast<float*>(one ? out : scratch);
  const float* xf = static_cast<const float*>(x);
  const WT* w = static_cast<const WT*>(qw);
  const float* sf = static_cast<const float*>(s);
  if (T <= 16) {
    const dim3 grid((N + kBN - 1) / kBN, (T + 15) / 16, splits);
    wq_matmul_kernel<WT, 16><<<grid, kThreads, 0, st>>>(
        xf, w, sf, dst, T, K, N, k_per_split, one);
  } else {
    const dim3 grid((N + kBN - 1) / kBN, (T + 63) / 64, splits);
    wq_matmul_kernel<WT, 64><<<grid, kThreads, 0, st>>>(
        xf, w, sf, dst, T, K, N, k_per_split, one);
  }
  if (!one) {
    const size_t tiles = (static_cast<size_t>(T) * N + kThreads - 1) /
                         kThreads;
    const int blocks = static_cast<int>(tiles < 1024 ? tiles : 1024);
    split_sum_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const float*>(scratch), sf, static_cast<float*>(out),
        T, N, splits);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int mxt_wq_matmul_int8(const void* x, const void* qw, const void* s,
                       void* out, void* scratch, int T, int K, int N,
                       int splits, void* stream) {
  return launch<int8_t>(x, qw, s, out, scratch, T, K, N, splits, stream);
}

int mxt_wq_matmul_fp8(const void* x, const void* qw, const void* s,
                      void* out, void* scratch, int T, int K, int N,
                      int splits, void* stream) {
  return launch<__nv_fp8_e4m3>(x, qw, s, out, scratch, T, K, N, splits,
                               stream);
}

}  // extern "C"
