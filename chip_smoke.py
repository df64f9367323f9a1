#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``mxnet_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line of output each (or more), in order:

1. card — ``nvidia-smi`` name and power limit, torch version; TF32 off;
2. build — ``nvcc`` builds every kernel in ``mxnet_tpu_torch/csrc/`` (one
   process per source, in parallel) and prints the build seconds;
3. kernels — each kernel at the main path's shapes against its plain
   PyTorch version on the same inputs (max error against the stated
   tolerance), with the kernel's, the plain version's and, where one
   exists, one library call's time (CUDA events, L2 flushed between
   launches), and the least time the card could take; the flash
   attention kernels at BERT-base shapes without a mask, with the
   padding mask and causal, and for each mask the two backward kernels'
   sum beside the library's backward (one call for dq, dk and dv), then
   at head dims 256 (padding mask, causal) and 192 (no mask, padded to
   256); the same three flash kernels on bf16 and f16 inputs (the AMP
   path's: the forward ``csrc/flash_fwd_lp_sm90.cu``, the backward
   ``csrc/flash_bwd_lp_sm90.cu``) at BERT-base shapes (no mask, padding
   mask, causal) and at head dim 256 (padding mask, causal), each giving
   the same bits on two launches, beside SDPA in the same dtype, and the
   three of them at a ragged tile edge (T=500) and at Tq != Tk; the chunk (Q=16 and Q=1) and decode (S=8 and S=64) paged
   attention kernels at the decode phase's shapes; every paged row
   (flat, chunk, decode: one staged kernel) carries its launch plan,
   shared bytes per CTA and ptxas's registers (a spill at D=64 fails the
   run); the flat and decode kernels and the D=256 flash kernels give
   the same bits on two launches; then the flat (T=8, 128), chunk and
   decode kernels over bf16 and f16 pages (``csrc/ragged_flat_lp.cu``)
   at the same shapes against their twins on the same 16-bit pages,
   bound at 2-byte pages, and the chunk (Q=16) and decode (S=8) kernels
   once more with q in the pages' dtype (one ulp of it); then the input
   dtypes the TPU kernels take beyond those: the flat kernels (K1, K2)
   with bf16 q over f32 and int8 pages, the chunk and decode kernels
   with f16 q over bf16 pages and over bf16 K and f16 V pages (widened
   to f32 by the wrapper: the row also times the kernel on pools widened
   beforehand), and the quantized matmul with bf16 and f16 x; then the
   multi-tensor optimizer update (``csrc/multi_tensor_update.cu``), each
   update rule in one launch over BERT-base's 203 parameter tensors (the
   mp rules with bf16 weights), bit for bit against its twin, the twin
   timed parameter by parameter; then the flat kernel (K1, f32 pages)
   at speculative decoding's packs: the verify's (T=24, 8 rows of 3)
   and the draft round's (T=16, 8 rows of 2);
4. main path f32 — ``LLMServer`` on ``TinyDecoder`` at GPT-2-small widths
   (vocab 50257, d_model 768, 12 layers, 12 heads, d_ff 3072, context
   1024; seeded random weights) serves 8 requests (prompts of 15 to 700
   tokens, two sampled, one a prefix-cache hit with copy-on-write);
   greedy streams are held against ``greedy_decode_reference`` and one
   mixed packed ``decode_flat`` batch against the dense ``forward``;
5. main path quantized — the same server with int8 KV + int8 weights,
   then fp8 KV + fp8 weights, on a few requests; logits held against the
   port's plain path (the same step on the CPU); then over 16-bit pools:
   ``dtype="bfloat16"`` with the f32 phase's traffic, ``dtype="float16"``
   on 3 requests, every greedy stream held token by token against the
   port's plain step on the CPU over pools of the same dtype
   (``check_greedy_plain``) and a mixed packed step against the same
   step on the CPU;
   5c. speculative decoding (``spec_k=2``, the draft the target truncated
   to 6 layers sharing its parameters, as the reference's serving bench
   runs it): ``LLMServer`` over f32 pools on the f32 phase's traffic,
   greedy streams against the oracle, 32 graphs (16 of the draft's
   ladder), every verify and draft round one replay, no degraded step;
   proposed, accepted and the accept rate, tokens/s, TTFT p50, host ms
   per step, verify dispatches per committed token, the draft rounds'
   and verifies' device ms (profiler ranges and CUDA events), beside
   the f32 phase's numbers; then the target as its own draft on 3
   requests (proposals accepted, fewer verifies than tokens), then fp8
   weights for target and draft on 3 requests, streams against the
   plain step on the CPU with the same weights;
   5d. multi-LoRA: ``LLMServer(..., adapter_bank=)`` over f32 pools with
   a bank of 4 adapters x 2 pages of rank 4 holding three seeded
   adapters (rank 4, rank 8, rank 8) serves the f32 phase's traffic
   under them (two base-model rows), greedy streams against
   ``greedy_decode_reference(lora=bank.adapter_arrays(name))``; adapter
   churn (evict, republish, publish) builds and captures nothing; the
   prefix cache is namespaced by adapter; tokens/s, TTFT p50, host ms
   per step and a profiled pass beside the f32 phase's, and the bank's
   bytes; then int8 KV and weights under adapters on 3 requests and
   speculative decoding (the base draft) under adapters on 3 requests;
   5e. faults, the tracer and the flight recorder on the captured step
   (``run_chaos_phase``): one scripted ``llm.decode`` raise (streams
   bit-identical to the fault-free run), three raises with four rows in
   the pack (one row isolated), worker death, a SIGUSR1 preemption
   drain, then the f32 phase's traffic shape with the tracer and the
   recorder off and on (tokens/s, host ms per step), a validated chrome
   trace, a flight bundle ``tools/flight_inspect.py`` checks, and
   ``mxtpu.llm.step`` ranges in a profiled pass;
   every serving phase (and the default config's, below) serves through
   CUDA graphs: ``warmup()`` captures one a rung (the graphs, capture
   seconds and the graph pool's bytes are printed), and the phase checks
   that every dispatch was one replay, that ``decode_flat`` never ran in
   Python after warmup and that nothing was built or captured; each
   serving phase ends with the same traffic through the idle engine,
   timed without the profiler (host ms per step), then under
   ``torch.profiler``: device busy share and the kernels that took the
   most device time;
6. paged decode through the model interface — ``TinyDecoder`` at the
   same widths prefills the same 8 prompts in chunks of 16 through
   ``decode_chunk`` over a ``PagedKVCache`` (rows done with their prompt
   sit in the batch at q_len 0), then takes 32 greedy steps through
   ``decode_step``: every stream against ``greedy_decode_reference``,
   each prompt's last chunk against the dense ``forward``, 12 chunk
   kernel launches per step, no kernel build after the first step; then
   the same decode with each step replayed from a CUDA graph captured at
   its first step (the same streams, ms per step beside the eager
   figure), and again from graphs over bf16 pools (the bf16 chunk
   kernel; streams against the plain step over bf16 pools); then the
   reference's default ``DecoderConfig()`` (head dim
   16) served through ``LLMServer(..., dtype="float32")``, streams
   against the oracle and one step against the same step on the CPU;
7. op front end — ``nd.ragged_paged_attention`` on the decode phase's
   pools with a 3-D q (the decode kernel) and a 4-D q (the chunk
   kernel), and on the same pools and q in bf16 and in f16 (the 16-bit
   kernels), with f16 q over bf16 pools and with bf16 K and f16 V pools;
   ``ragged_flat_attention`` with bf16 q over the f32 pools and their
   int8 quantization, ``quantized_matmul`` with bf16 and f16 x;
   ``nd.scaled_dot_product_attention``, and three user CUDA
   kernels registered through ``rtc.register_cuda_op`` (``scale_add``,
   ``square`` with its gradient, ``rowsum`` with its own output shape)
   at 8192 x 8192 f32, each against its plain version;
8. main path training — BERT-base (vocab 30522, 12 layers, 768 units,
   3072 hidden, 12 heads, 512 positions; seeded Xavier weights) with the
   tied masked-LM head of examples/bert_pretrain_mlm.py, batch 8 x 512
   of the example's synthetic corpus with ``valid_length`` in [128,
   512], through gluon, the flash attention kernels, ``backward()`` and
   ``Trainer.step`` (Adam, lr 1e-4, one fused launch of the update
   kernel a step): one step's loss and gradients with
   the kernels against the op's plain path (``flash=False``; where a
   ReLU gate of the MLM transform flips between the two on a tie, on
   the flash path's gates); 10 steps at
   dropout 0.1 with falling loss, 12 launches per step of each flash
   kernel, one ``adam_update`` launch a step (``last_dispatches`` 1, no
   fallback) and no kernel build after the first step; step ms and
   tokens/s, the host ms of forward, backward and ``trainer.step`` (each
   closed by a synchronize, two more steps), then two steps under
   ``torch.profiler``;
   then the same training under AMP (``amp.init()``, bf16, with
   ``amp.init_trainer``; int32 token ids): one step with the bf16 flash
   kernels against the plain op path under AMP (the loss, each
   gradient's norm-relative error, the query/key projections reported,
   the last attention layer's kernels against the f64 twin), 10 steps
   with falling loss and 12 launches per step of each bf16 kernel, step
   ms, tokens/s, peak memory and a profiled pass beside the f32 phase's;
   then ``amp.init(target_dtype="float16")`` with a fresh
   ``init_trainer`` (loss scale 2^16): 3 steps through the f16 kernels,
   each step's scale and whether it was skipped; then BERT-base's
   gradients of one f32 step through a Trainer for each update rule (SGD
   with and without momentum, NAG, Adam, AdamW, AdaGrad, RMSProp plain
   and centered, Ftrl, SignSGD, Signum, and SGD with
   ``multi_precision`` on bf16 weights, with and without momentum), two
   steps each, each step one launch of its rule and nothing else;
9. one JSON line listing every kernel: launches on the main paths,
   counted through graph replays (the speculative phase's verifies and
   draft rounds included; the flash kernels': the 10 training
   steps and the op phase's call; the 16-bit paged kernels': the bf16
   and f16 serving, the bf16 paged decode and the op phase), max
   error, times, bound (the quantized matmul's and the flash kernels'
   operations on the TF32 tensor cores, 2 and 3 passes for f32
   accuracy; the 16-bit flash kernels' at the dense bf16/f16 rate, one
   pass) and, beside the f32 rows' bound, the f32 CUDA-core bound;
then the card line and, last, ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. The script needs
the checkout's ``mxnet_tpu_torch`` package beside it and a CUDA device;
without either it exits 2 and prints no result.
"""
import itertools
import json
import os
import re
import subprocess
import sys
import time
import warnings

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate, f32 rate
# outside the tensor cores, dense TF32 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 495e12
# dense bf16 and f16 tensor-core rate, one pass (the 16-bit flash rows)
LP_FLOPS_PER_S = 989e12
# TF32 tensor-core passes per product at f32 accuracy (split-TF32): the
# quantized matmul splits only x (its weights are exact in TF32), the
# flash kernels split both operands (hi*hi + hi*lo + lo*hi). The flash
# backward's rows take the same count: the same work at f32 accuracy.
WQ_PASSES = 2
FLASH_PASSES = 3

# tolerances, each with its reason
# flat attention kernel vs its plain version: identical math, f32
# online softmax vs one softmax over <= 1024 keys, dot products summed
# in another order; outputs are O(1)
ATT_TOL = 2e-5
# quantized matmul kernel vs plain: one f32 sum of K <= 3072 terms in
# another order, relative to the output's magnitude
WQ_REL_TOL = 1e-5
# f32 logits of the kernel path vs the plain dense forward after 12
# layers: sums reordered in every matmul and in attention
F32_LOGIT_TOL = 2e-3
# 16-bit KV (bf16, f16 pools): the kernel path's logits vs the port's
# plain step on the CPU over pools of the same dtype. Both round their own
# f32 K/V to 16 bits, and those differ in the last f32 bits (matmuls
# summed in another order), so a value on a rounding boundary lands one
# 16-bit ulp apart (2^-8 relative in bf16, 2^-11 in f16) and carries
# through 12 layers: the int8 tolerance for bf16, an eighth of it for f16
LP_LOGIT_TOL = {"bfloat16": 0.05, "float16": 0.05 / 8}
# quantized kernel path vs the same quantized step's plain version: the
# tolerance table of tests/test_kv_quant.py / tests/test_weight_quant.py
# (int8 0.05; fp8 KV 0.15 and fp8 weights 0.25, so 0.25 with both)
QUANT_LOGIT_TOL = {"int8": 0.05, "float8_e4m3fn": 0.25}
# flash kernels vs their plain twins, relative to the largest magnitude
# of the output: f32 sums over up to 512 keys (forward, dQ) or queries
# (dK, dV, dbias) in another order, online softmax against one softmax
FLASH_REL_TOL = 2e-5
# the bf16 and f16 flash kernels vs their twins, relative to the largest
# magnitude of each result: both round P (P^T, dS) and the outputs to the
# input dtype from f32 sums taken in another order (online softmax
# against one softmax), so a value on a rounding boundary lands one ulp
# apart: 2^-8 relative in bf16, 2^-11 in f16 (this phase reads at most
# 7.8e-3 and 2.0e-3 on an H100)
FLASH_LP_REL_TOL = {"bfloat16": 2e-2, "float16": 5e-3}
# BERT-base training step, flash kernels vs the op's plain path
# (flash=False), both f32 with TF32 off: the loss, relative; and every
# parameter gradient, relative to its own largest entry (gradients that
# are zero in exact arithmetic, below 1e-6 of the largest gradient of
# the model, are float noise and not compared): 12 layers of backward
# carry the last-bit differences of attention
BERT_LOSS_REL_TOL = 1e-5
BERT_GRAD_REL_TOL = 1e-3
# a ReLU gate of the MLM transform whose pre-activation changes sign
# between the two paths sends that token's gradient through the unit in
# one path only; as check_greedy treats a near tie, such a flip is taken
# as a tie where |pre-activation| is below this share of the largest
# one, and the gradients are then compared on the flash path's gates
BERT_TIE_REL_TOL = 1e-5
# user CUDA kernels vs their plain versions, relative to the largest
# magnitude of the output: one rounding (2x + y fused into an FMA) or a
# sum of 8192 terms in another order
RTC_REL_TOL = 1e-5
# BERT-base under AMP (bf16), one step with the flash kernels against the
# op's plain path (flash=False, also under AMP). The loss, relative: both
# run bf16 matmuls and attention that round at different places (the
# plain path rounds the scores and probabilities, the kernels P and dS).
AMP_LOSS_REL_TOL = 1e-3
# Each parameter's gradient, as the norm of the difference over its own
# norm (bf16 rounds each element, so the largest-entry measure of the
# f32 check reads rounding noise): the two paths' roundings leave a few
# percent between them (5.0e-2 at most on an H100 at BERT-base).
AMP_GRAD_REL_TOL = 0.1
# ... except the attention query and key projections, which are reported
# and not held to it: at BERT's init their gradient is a small
# difference of large terms (the deep layers' token representations
# nearly coincide), and the flash backward takes delta = rowsum(dO * O)
# from the bf16 output O, as the reference's _flash_backward does, whose
# rounding then dominates dQ and dK (the plain path's softmax backward
# sums in f32). The kernels themselves are held on the last layer's
# attention inputs and output gradient: dq, dk, dv with delta from the
# exact (f64) output within this norm-relative distance of the f64 twin;
# the same with the reference's delta is printed beside it.
AMP_LAYER_REL_TOL = 2e-2
# a ReLU gate flip between the two AMP paths counts as a tie where
# |pre-activation| is within 2^-7 of the largest (two bf16 ulps)
AMP_TIE_REL_TOL = 2.0 ** -7
AMP_F16_STEPS = 3

DEVICE = "cuda"
GPT2_SMALL = dict(vocab_size=50257, d_model=768, num_layers=12,
                  num_heads=12, d_ff=3072, max_context=1024)
MAX_SEQS, BLOCK_SIZE, NEW_TOKENS = 8, 16, 32
# speculative decoding: proposals a row a step and the draft's layers
# (the target truncated to half its depth, sharing its parameters), the
# reference serving bench's knob and draft
SPEC_K, DRAFT_LAYERS = 2, 6
# BERT-base (the published config; gluon/model_zoo/bert.py "bert_base"),
# trained as a masked LM with the tied decoder of
# examples/bert_pretrain_mlm.py at batch 8 x 512 tokens
BERT_BASE = dict(vocab_size=30522, units=768, hidden_size=3072,
                 num_layers=12, num_heads=12, max_length=512)
BERT_BATCH, BERT_T, BERT_LR, BERT_STEPS = 8, 512, 1e-4, 10
# paged decode through the model interface: prefill chunk, decode steps
CHUNK_Q, DECODE_STEPS = 16, 32
# the chunk and decode kernels' rows: S rows of kv lengths over 15..1024
# with block edges, H=12, D=64, block 16, 64 table columns (context 1024)
PAGED_KV_LENS = (15, 16, 17, 255, 256, 511, 700, 1024)
RTC_N = 8192
# the optimizer phases: the update ops' hyperparameters (every scalar of
# each rule's row away from its default, the gradient clip in play), the
# kernel's operations per element (counted from its code; sqrt and div
# as one each), and the Trainer configurations that take BERT-base's
# gradients through each update rule (dtype: the weights' for the mp
# rules)
UPDATE_KW = dict(lr=0.01, wd=1e-3, rescale_grad=0.125, clip_gradient=2.0)
UPDATE_EXTRA = {
    "sgd_mom_update": dict(momentum=0.9),
    "nag_mom_update": dict(momentum=0.9),
    "mp_sgd_mom_update": dict(momentum=0.9),
    "adam_update": dict(beta1=0.8, beta2=0.99, epsilon=1e-6),
    "_adamw_update": dict(beta1=0.8, beta2=0.99, epsilon=1e-6, eta=0.5),
    "rmsprop_update": dict(rho=0.8, epsilon=1e-6, clip_weights=3.0),
    "rmspropalex_update": dict(rho=0.8, momentum=0.9, epsilon=1e-6,
                               clip_weights=3.0),
    "ftrl_update": dict(lamda1=0.05, beta=1.5),
    "signum_update": dict(momentum=0.9, wd_lh=0.05),
    "_adagrad_update": dict(epsilon=1e-6),
}
UPDATE_FLOPS = {"sgd_update": 7, "sgd_mom_update": 9, "nag_mom_update": 11,
                "mp_sgd_update": 7, "mp_sgd_mom_update": 9,
                "adam_update": 17, "_adamw_update": 18,
                "rmsprop_update": 16, "rmspropalex_update": 23,
                "ftrl_update": 22, "signsgd_update": 9,
                "signum_update": 14, "_adagrad_update": 12}
OPT_PATHS = (
    ("sgd", dict(learning_rate=1e-4), None, "sgd_update"),
    ("sgd", dict(learning_rate=1e-4, momentum=0.9), None, "sgd_mom_update"),
    ("nag", dict(learning_rate=1e-4, momentum=0.9), None, "nag_mom_update"),
    ("adam", dict(learning_rate=1e-4, wd=0.01), None, "adam_update"),
    ("adamw", dict(learning_rate=1e-4, wd=0.01), None, "_adamw_update"),
    ("adagrad", dict(learning_rate=1e-3), None, "_adagrad_update"),
    ("rmsprop", dict(learning_rate=1e-4), None, "rmsprop_update"),
    ("rmsprop", dict(learning_rate=1e-4, centered=True), None,
     "rmspropalex_update"),
    ("ftrl", dict(learning_rate=0.1, beta=1.0), None, "ftrl_update"),
    ("signsgd", dict(learning_rate=1e-4), None, "signsgd_update"),
    ("signum", dict(learning_rate=1e-4, wd_lh=0.01), None, "signum_update"),
    ("sgd", dict(learning_rate=1e-4, multi_precision=True), "bfloat16",
     "mp_sgd_update"),
    ("sgd", dict(learning_rate=1e-4, momentum=0.9, multi_precision=True),
     "bfloat16", "mp_sgd_mom_update"),
)
OPT_PATH_STEPS = 2

# the three user kernels of tests/test_rtc.py, in CUDA C, in the calling
# convention of mxnet_tpu_torch.rtc: input pointers, the output pointer,
# each input's numel, the output's numel
RTC_SOURCES = {
    "scale_add": r"""
extern "C" __global__ void scale_add(const float* x, const float* y,
                                     float* out, long long nx, long long ny,
                                     long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = 2.f * x[i] + y[i];
}
""",
    "square": r"""
extern "C" __global__ void square(const float* x, float* out, long long nx,
                                  long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = x[i] * x[i];
}
""",
    # one block of 256 threads per row (grid = rows, block = 256)
    "rowsum": r"""
extern "C" __global__ void rowsum(const float* x, float* out, long long nx,
                                  long long nrows) {
  __shared__ float part[256];
  const long long cols = nx / nrows;
  const float* row = x + blockIdx.x * cols;
  float s = 0.f;
  for (long long c = threadIdx.x; c < cols; c += 256) s += row[c];
  part[threadIdx.x] = s;
  __syncthreads();
  for (int w = 128; w > 0; w >>= 1) {
    if (threadIdx.x < w) part[threadIdx.x] += part[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = part[0];
}
""",
}


def register_rtc_ops(prefix):
    """Register the three user kernels as ops ``<prefix>scale_add``,
    ``<prefix>square`` (differentiable through its reference) and
    ``<prefix>rowsum`` (output [rows]); returns their names and plain
    versions."""
    from mxnet_tpu_torch import rtc
    plain = {"scale_add": lambda x, y: x * 2.0 + y,
             "square": lambda x: x * x,
             "rowsum": lambda x: x.sum(1)}
    names = {}
    for k, src in RTC_SOURCES.items():
        kw = {}
        if k == "square":
            kw["reference_fn"] = plain[k]
        if k == "rowsum":
            kw.update(out_shape=lambda shapes, dtypes: ((shapes[0][0],),
                                                        dtypes[0]),
                      grid=lambda shapes: (shapes[0][0],), block=(256,))
        names[k] = rtc.register_cuda_op(prefix + k, src, k, **kw)
    return names, plain


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------------- timing --
class Timer:
    """Median device time of ``fn`` over ``n`` launches (CUDA events
    around each), with a 256 MB write before each launch so none finds
    its inputs in the 50 MB L2."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.float32,
                                 device=DEVICE)

    def ms(self, fn, n=30):
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(n):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))


def bound(nbytes, flops, passes=None):
    """The least time the card could take: ``(ms, "bytes" or
    "operations", f32 ms)``. Bytes go at the HBM rate; with ``passes``
    the products go on the TF32 tensor cores, ``passes`` times each at
    f32 accuracy, else at the f32 rate of the CUDA cores. The third value
    is always the f32 CUDA-core bound, so rows stay comparable with
    earlier ones."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_f32 = max(t_bytes, flops / F32_FLOPS_PER_S * 1e3)
    t_ops = (flops * passes / TF32_FLOPS_PER_S * 1e3 if passes
             else flops / F32_FLOPS_PER_S * 1e3)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", t_f32
    return t_ops, "operations", t_f32


# ------------------------------------------------------ kernel phase --
def attention_case(torch, T, page_dtype, rng):
    """Inputs of one flat-attention launch at the main path's shapes
    (pages of ``page_dtype``: f32, bf16, f16, or int8/fp8 with scales):
    8 sequences with fragmented block tables over a 513-block pool,
    T packed tokens (T/8 consecutive positions per sequence, one block
    boundary crossed or more: a decode step at T=8, a pack of 16-token
    prefill chunks at T=128), positions up to 1023."""
    H, D, bs, MB, S = 12, 64, BLOCK_SIZE, 64, MAX_SEQS
    N = S * MB + 1
    perm = rng.permutation(np.arange(1, N)).astype(np.int32)
    tables = perm[:S * MB].reshape(S, MB)
    per = T // S
    ends = rng.randint(per, MB * bs, size=S)
    seq_ids = np.repeat(np.arange(S, dtype=np.int32), per)
    positions = np.concatenate(
        [np.arange(e - per, e, dtype=np.int32) for e in ends])
    q = rng.randn(T, H, D).astype(np.float32)
    kf = rng.randn(N, bs, H, D).astype(np.float32)
    vf = rng.randn(N, bs, H, D).astype(np.float32)
    dev = DEVICE
    args = dict(q=torch.from_numpy(q).to(dev),
                block_tables=torch.from_numpy(tables).to(dev),
                seq_ids=torch.from_numpy(seq_ids).to(dev),
                positions=torch.from_numpy(positions).to(dev))
    if page_dtype in ("float32", "bfloat16", "float16"):
        dt = getattr(torch, page_dtype)
        args["k_pages"] = torch.from_numpy(kf).to(dev).to(dt)
        args["v_pages"] = torch.from_numpy(vf).to(dev).to(dt)
        elem, scale_bytes = dt.itemsize, 0
    else:
        from mxnet_tpu_torch.serving.llm.model import _quantize_kv
        dt = (torch.int8 if page_dtype == "int8"
              else torch.float8_e4m3fn)
        for name, arr in (("k", kf), ("v", vf)):
            x = torch.from_numpy(arr).to(dev).reshape(N * bs, H, D)
            xq, sc = _quantize_kv(x, dt)
            args[f"{name}_pages"] = xq.reshape(N, bs, H, D).contiguous()
            args[f"{name}_scales"] = sc.reshape(N, bs, H).contiguous()
        elem, scale_bytes = 1, 4
    # the least bytes this run's data needs: q, out, and every K/V page
    # (with its scales) some token's causal range reaches, once
    pages = set()
    for sid, pos in zip(seq_ids, positions):
        pages.update(tables[sid, :pos // bs + 1].tolist())
    page_bytes = bs * H * (D * elem + scale_bytes)
    nbytes = (2 * T * H * D * 4 + 2 * len(pages) * page_bytes
              + 4 * (2 * T + S * MB))
    flops = 4 * D * H * int(np.sum(positions.astype(np.int64) + 1))
    return args, nbytes, flops


def run_kernel_phase(torch, timer, rng):
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import ragged_attention as ra
    from mxnet_tpu_torch.ops import quantization as qz
    from mxnet_tpu_torch.serving.llm.quant import quantize_leaf
    results = []
    # each case under the target step's plan (the pack's), then on the
    # same inputs under the draft's pack-independent one (pages dealt to
    # the ranks)
    for page_dtype, T in itertools.product(
            ("float32", "int8", "float8_e4m3fn"), (8, 128)):
        args, nbytes, flops = attention_case(torch, T, page_dtype, rng)
        for fixed in (False, True):
            def kern():
                return ra.ragged_flat_attention(**args,
                                                pack_independent=fixed)

            def plain():
                return ra.ragged_flat_attention_reference(**args)
            out_k = kern()
            again = kern()
            torch.cuda.synchronize()
            err = float((out_k - plain()).abs().max())
            b_ms, b_by, b_f32 = bound(nbytes, flops)
            name = ra.kernel_name(args["k_pages"].dtype)
            check(torch.equal(out_k, again), f"{name} T={T}: two launches "
                  f"gave different bits")
            extra, note = ring_note(kernels, ra, page_dtype, "FlatTiles",
                                    ra.flat_plan(T, MAX_SEQS, 12, 64,
                                                 BLOCK_SIZE, 64,
                                                 args["k_pages"].dtype,
                                                 fixed),
                                    64, BLOCK_SIZE, 64)
            note = "; " + note
            res = dict(name=name, route="cuda",
                       source="mxnet_tpu_torch/csrc/ragged_flat.cu",
                       replaces=("mxnet_tpu/ops/ragged_attention.py:158"
                                 if page_dtype == "float32" else
                                 "mxnet_tpu/ops/ragged_attention.py:244"),
                       shape=f"T={T},H=12,D=64,bs=16,MB=64"
                             + (",pack-independent" if fixed else ""),
                       max_abs_err=err, tol=ATT_TOL, ms=timer.ms(kern),
                       plain_ms=timer.ms(plain), bound_ms=b_ms,
                       bound_by=b_by, bound_f32_ms=b_f32, library_ms=None,
                       **extra)
            log(f"kernel {name} {res['shape']}: max_abs_err={err:.3e} "
                f"(tol {ATT_TOL}) kernel_ms={res['ms']:.4f} "
                f"plain_ms={res['plain_ms']:.4f} bound_ms={b_ms:.4f} "
                f"({b_by}){note}")
            check(err <= ATT_TOL, f"{name} {res['shape']} disagrees "
                  f"with its plain version: {err} > {ATT_TOL}")
            results.append(res)
    shapes = [(768, 768), (768, 3072), (3072, 768), (768, 50257)]
    for wdt in ("int8", "float8_e4m3fn"):
        for T in (8, 128):
            for K, N in shapes:
                w = rng.randn(K, N).astype(np.float32) / np.sqrt(K)
                q, s = quantize_leaf(w, wdt)
                x = torch.from_numpy(
                    rng.randn(T, K).astype(np.float32)).to(DEVICE)
                q, s = q.to(DEVICE), s.to(DEVICE)

                def kern():
                    return qz.quantized_matmul(x, q, s)

                def plain():
                    return qz.quantized_matmul_reference(x, q, s)

                def library():
                    return x @ (q.float() * s)
                out_k = kern()
                torch.cuda.synchronize()
                ref = plain()
                err = float((out_k - ref).abs().max())
                tol = WQ_REL_TOL * max(1.0, float(ref.abs().max()))
                b_ms, b_by, b_f32 = bound(
                    4 * T * K + K * N + 4 * N + 4 * T * N, 2 * T * K * N,
                    WQ_PASSES)
                name = qz.kernel_name(q.dtype)
                res = dict(name=name, route="cuda",
                           source="mxnet_tpu_torch/csrc/wq_matmul.cu",
                           replaces="mxnet_tpu/ops/quantization.py:297",
                           shape=f"T={T},K={K},N={N}", max_abs_err=err,
                           tol=tol, ms=timer.ms(kern),
                           plain_ms=timer.ms(plain), bound_ms=b_ms,
                           bound_by=b_by, bound_f32_ms=b_f32,
                           library_ms=timer.ms(library))
                log(f"kernel {name} {res['shape']}: max_abs_err={err:.3e} "
                    f"(tol {tol:.3e}) kernel_ms={res['ms']:.4f} "
                    f"plain_ms={res['plain_ms']:.4f} "
                    f"library_ms={res['library_ms']:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by}) bound_f32_ms={b_f32:.4f}")
                check(err <= tol, f"{name} {res['shape']} disagrees with "
                      f"its plain version: {err} > {tol}")
                results.append(res)
    return results


def flash_case(torch, rng, padding, causal, shape):
    """Inputs of one attention layer at ``shape`` (B, H, T, D; the BERT-
    base training step's is (8, 12, 512, 64)): q, k, v and dout, with the
    padding bias of ``valid_length`` drawn in [T/4, T] or none; and the
    (query, key) pairs the function must visit (pairs a mask drops need
    no work)."""
    B, H, T, D = shape
    q, k, v, dout = (torch.from_numpy(
        rng.randn(B, H, T, D).astype(np.float32)).to(DEVICE)
        for _ in range(4))
    vlen = np.full(B, T)
    bias = None
    if padding:
        vlen = rng.randint(T // 4, T + 1, size=B)
        bias = torch.from_numpy(np.where(
            np.arange(T)[None, :] < vlen[:, None], 0.0,
            -1e30).astype(np.float32)).to(DEVICE)
    pairs = (B * H * T * (T + 1) // 2 if causal
             else H * T * int(vlen.sum()))
    return dict(q=q, k=k, v=v, bias=bias, causal=causal), dout, pairs


def rel_err(got, want):
    """(max abs error, the same over max(1, largest |want|))."""
    err = float((got - want).abs().max())
    return err, err / max(1.0, float(want.abs().max()))


# the flash kernel phase's shapes: BERT-base's attention layer, then head
# dim 256 (the 32-row-tile instantiation) and 192 (padded to 256) at a
# size that keeps the phase short
BERT_ATTENTION = (BERT_BATCH, BERT_BASE["num_heads"], BERT_T, 64)
FLASH_WIDE = ((2, 8, 512, 256), (2, 8, 512, 192))


def run_flash_kernel_phase(torch, timer, rng):
    """K6 (forward), K7a (dK/dV/dbias) and K7b (dQ) at BERT-base shapes,
    then at head dims 256 and 192, against their plain twins (at D=256
    also: two launches give the same bits); library: torch's fused
    attention (SDPA) with the same additive mask, and that call's
    backward (which computes dq, dk and dv together: it is set beside
    both K7 rows)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    src = "mxnet_tpu_torch/csrc/flash_attention.cu"
    tpu = "mxnet_tpu/ops/flash_attention.py"
    results = []
    wide256, wide192 = FLASH_WIDE
    for label, padding, causal, shape in (
            ("no mask", False, False, BERT_ATTENTION),
            ("padding mask", True, False, BERT_ATTENTION),
            ("causal", False, True, BERT_ATTENTION),
            ("padding mask", True, False, wide256),
            ("causal", False, True, wide256),
            ("no mask", False, False, wide192)):
        B, H, T, D = shape
        scale = 1.0 / D ** 0.5
        bhtd = 4 * B * H * T * D
        a, dout, pairs = flash_case(torch, rng, padding, causal, shape)
        bias = a["bias"]
        bias_bytes = 0 if bias is None else 4 * B * T
        out, lse = fa.flash_forward(**a, scale=scale)
        torch.cuda.synchronize()
        ref_out, ref_lse = fa.flash_forward_reference(**a, scale=scale)
        delta = (dout * ref_out).sum(-1).reshape(B * H, T)
        bw = dict(a, dout=dout, lse=ref_lse, delta=delta, scale=scale)
        want_db = bias is not None
        got_kv = fa.flash_bwd_dkv(**bw, want_dbias=want_db)
        got_q = fa.flash_bwd_dq(**bw)
        torch.cuda.synchronize()
        ref_kv = fa.flash_bwd_dkv_reference(**bw, want_dbias=want_db)
        ref_q = fa.flash_bwd_dq_reference(**bw)
        if D == 256:
            again = (fa.flash_forward(**a, scale=scale)
                     + fa.flash_bwd_dkv(**bw, want_dbias=want_db)
                     + (fa.flash_bwd_dq(**bw),))
            first = (out, lse) + tuple(got_kv) + (got_q,)
            check(all(x is None and y is None or torch.equal(x, y)
                      for x, y in zip(first, again)),
                  f"flash kernels at D=256, {label}: two launches gave "
                  f"different bits")
        errs = {
            "flash_fwd": [rel_err(out, ref_out), rel_err(lse, ref_lse)],
            "flash_bwd_dkv": [rel_err(g, r) for g, r in
                              zip(got_kv, ref_kv) if r is not None],
            "flash_bwd_dq": [rel_err(got_q, ref_q)],
        }
        mask = None if bias is None else bias[:, None, None, :]
        lq, lk, lv = (t.detach().clone().requires_grad_()
                      for t in (a["q"], a["k"], a["v"]))
        lib_out = sdpa(lq, lk, lv, attn_mask=mask, is_causal=causal,
                       scale=scale)

        def lib_fwd():
            return sdpa(a["q"], a["k"], a["v"], attn_mask=mask,
                        is_causal=causal, scale=scale)

        def lib_bwd():
            return torch.autograd.grad(lib_out, (lq, lk, lv), dout,
                                       retain_graph=True)
        lib_bwd_ms = timer.ms(lib_bwd)
        cases = [
            ("flash_fwd", ":89", lambda: fa.flash_forward(**a, scale=scale),
             lambda: fa.flash_forward_reference(**a, scale=scale),
             bound(bhtd * 4 + 4 * B * H * T + bias_bytes, 4 * D * pairs,
                   FLASH_PASSES),
             timer.ms(lib_fwd)),
            ("flash_bwd_dkv", ":254",
             lambda: fa.flash_bwd_dkv(**bw, want_dbias=want_db),
             lambda: fa.flash_bwd_dkv_reference(**bw, want_dbias=want_db),
             bound(bhtd * 6 + 8 * B * H * T + bias_bytes
                   + (4 * B * H * T if want_db else 0), 8 * D * pairs,
                   FLASH_PASSES),
             lib_bwd_ms),
            ("flash_bwd_dq", ":292", lambda: fa.flash_bwd_dq(**bw),
             lambda: fa.flash_bwd_dq_reference(**bw),
             bound(bhtd * 5 + 8 * B * H * T + bias_bytes, 6 * D * pairs,
                   FLASH_PASSES),
             lib_bwd_ms),
        ]
        for name, line, kern, plain, (b_ms, b_by, b_f32), lib_ms in cases:
            err = max(e[0] for e in errs[name])
            rel = max(e[1] for e in errs[name])
            res = dict(name=name, route="cuda", source=src,
                       replaces=tpu + line,
                       shape=f"B={B},H={H},T={T},D={D},{label}",
                       max_abs_err=err, tol=FLASH_REL_TOL, ms=timer.ms(kern),
                       plain_ms=timer.ms(plain), bound_ms=b_ms,
                       bound_by=b_by, bound_f32_ms=b_f32, library_ms=lib_ms)
            log(f"kernel {name} {res['shape']}: max_abs_err={err:.3e} "
                f"(relative {rel:.3e}, tol {FLASH_REL_TOL}) "
                f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
                f"library_ms={lib_ms:.4f} bound_ms={b_ms:.4f} ({b_by}) "
                f"bound_f32_ms={b_f32:.4f}")
            check(rel <= FLASH_REL_TOL, f"{name} {res['shape']} disagrees "
                  f"with its plain twin: {rel} > {FLASH_REL_TOL}")
            results.append(res)
        # the library's backward computes dq, dk and dv in one call: set
        # it beside the sum of the two backward kernels
        bwd_ms = sum(r["ms"] for r in results[-2:])
        log(f"kernel flash_bwd_dkv + flash_bwd_dq B={B},H={H},T={T},D={D},"
            f"{label}: kernel_ms={bwd_ms:.4f} library_ms={lib_bwd_ms:.4f} "
            f"(the library's backward, dq, dk and dv in one call): "
            f"{bwd_ms / lib_bwd_ms:.3f}x the library")
        del lib_out
    return results


def bound_lp(nbytes, flops):
    """The least time the card could take for a 16-bit flash launch:
    ``(ms, "bytes" or "operations")``, bytes at the HBM rate, products at
    the dense bf16/f16 tensor-core rate, one pass."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / LP_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def run_flash_lp_kernel_phase(torch, timer, rng):
    """K6, K7a and K7b on bf16 and f16 inputs (the AMP training path's
    kernels: the forward of csrc/flash_fwd_lp_sm90.cu, the backward of
    csrc/flash_bwd_lp_sm90.cu) at BERT-base shapes (no mask, padding
    mask, causal) and at head dim 256 (padding, causal), against their
    twins on the same inputs, each giving the same bits on two launches;
    library: SDPA in the same dtype with the same mask, and its one-call
    backward. Then the three kernels, for correctness only
    (:func:`flash_lp_edge_checks`), at a ragged tile edge and at Tq !=
    Tk."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    sdpa = torch.nn.functional.scaled_dot_product_attention
    src = "mxnet_tpu_torch/csrc/flash_bwd_lp_sm90.cu"
    fwd_src = "mxnet_tpu_torch/csrc/flash_fwd_lp_sm90.cu"
    tpu = "mxnet_tpu/ops/flash_attention.py"
    wide256 = FLASH_WIDE[0]
    results = []
    for dtype in ("bfloat16", "float16"):
        dt, tol = getattr(torch, dtype), FLASH_LP_REL_TOL[dtype]
        for label, padding, causal, shape in (
                ("no mask", False, False, BERT_ATTENTION),
                ("padding mask", True, False, BERT_ATTENTION),
                ("causal", False, True, BERT_ATTENTION),
                ("padding mask", True, False, wide256),
                ("causal", False, True, wide256)):
            B, H, T, D = shape
            scale = 1.0 / D ** 0.5
            a, dout, pairs = flash_case(torch, rng, padding, causal, shape)
            a = dict(a, q=a["q"].to(dt), k=a["k"].to(dt), v=a["v"].to(dt))
            dout = dout.to(dt)
            bias = a["bias"]
            bhtd = 2 * B * H * T * D          # bytes of one 16-bit tensor
            bias_bytes = 0 if bias is None else 4 * B * T
            want_db = bias is not None
            ref_out, ref_lse = fa.flash_forward_reference(**a, scale=scale)
            delta = (dout.float() * ref_out.float()).sum(-1).reshape(
                B * H, T)
            bw = dict(a, dout=dout, lse=ref_lse, delta=delta, scale=scale)
            mask = None if bias is None else bias[:, None, None, :].to(dt)
            lq, lk, lv = (t.detach().clone().requires_grad_()
                          for t in (a["q"], a["k"], a["v"]))
            lib_out = sdpa(lq, lk, lv, attn_mask=mask, is_causal=causal,
                           scale=scale)

            def lib_fwd():
                return sdpa(a["q"], a["k"], a["v"], attn_mask=mask,
                            is_causal=causal, scale=scale)

            def lib_bwd():
                return torch.autograd.grad(lib_out, (lq, lk, lv), dout,
                                           retain_graph=True)
            lib_bwd_ms = timer.ms(lib_bwd)
            cases = [
                ("flash_fwd", ":89",
                 lambda: fa.flash_forward(**a, scale=scale),
                 lambda: fa.flash_forward_reference(**a, scale=scale),
                 bound_lp(bhtd * 4 + 4 * B * H * T + bias_bytes,
                          4 * D * pairs), timer.ms(lib_fwd)),
                ("flash_bwd_dkv", ":254",
                 lambda: fa.flash_bwd_dkv(**bw, want_dbias=want_db),
                 lambda: fa.flash_bwd_dkv_reference(**bw,
                                                    want_dbias=want_db),
                 bound_lp(bhtd * 6 + 8 * B * H * T + bias_bytes
                          + (4 * B * H * T if want_db else 0),
                          8 * D * pairs), lib_bwd_ms),
                ("flash_bwd_dq", ":292", lambda: fa.flash_bwd_dq(**bw),
                 lambda: fa.flash_bwd_dq_reference(**bw),
                 bound_lp(bhtd * 5 + 8 * B * H * T + bias_bytes,
                          6 * D * pairs), lib_bwd_ms),
            ]
            rows = []
            for base, line, kern, plain, (b_ms, b_by), lib_ms in cases:
                name = fa.kernel_name(base, dt)
                got, again = kern(), kern()
                torch.cuda.synchronize()
                want = plain()
                got, again, want = ((x if isinstance(x, tuple) else (x,))
                                    for x in (got, again, want))
                same = all(x is None and y is None or torch.equal(x, y)
                           for x, y in zip(got, again))
                errs = [rel_err(g.float(), w.float())
                        for g, w in zip(got, want) if w is not None]
                err = max(e[0] for e in errs)
                rel = max(e[1] for e in errs)
                res = dict(name=name, route="cuda",
                           source=fwd_src if base == "flash_fwd" else src,
                           replaces=tpu + line,
                           shape=f"B={B},H={H},T={T},D={D},{label}",
                           max_abs_err=err, tol=tol, ms=timer.ms(kern),
                           plain_ms=timer.ms(plain), bound_ms=b_ms,
                           bound_by=b_by, library_ms=lib_ms)
                log(f"kernel {name} {res['shape']}: max_abs_err={err:.3e} "
                    f"(relative {rel:.3e}, tol {tol}) same bits twice "
                    f"{same} kernel_ms={res['ms']:.4f} plain_ms="
                    f"{res['plain_ms']:.4f} library_ms={lib_ms:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by})")
                check(rel <= tol, f"{name} {res['shape']} disagrees with "
                      f"its plain twin: {rel} > {tol}")
                check(same, f"{name} {res['shape']}: two launches gave "
                      f"different bits")
                rows.append(res)
            bwd_ms = rows[1]["ms"] + rows[2]["ms"]
            log(f"kernel flash_bwd_dkv + flash_bwd_dq {dtype} "
                f"B={B},H={H},T={T},D={D},{label}: kernel_ms={bwd_ms:.4f} "
                f"library_ms={lib_bwd_ms:.4f} (the library's backward, dq, "
                f"dk and dv in one call): {bwd_ms / lib_bwd_ms:.3f}x the "
                f"library")
            results += rows
            del lib_out
    flash_lp_edge_checks(torch, np.random.RandomState(19))
    return results


def flash_lp_edge_checks(torch, rng):
    """The 16-bit forward and backward against their twins where their
    TMA tiles meet a ragged edge (Tq = Tk = 500, 12 heads, padding mask:
    the last query and key tiles run past T and are zero-filled) and with
    Tq != Tk (128 queries over 512 keys, no mask and causal), in bf16 and
    f16: out, dq, dk, dv (and dbias with the mask) within
    ``FLASH_LP_REL_TOL``, lse within ``FLASH_REL_TOL``, the same bits
    twice; the backward from the twin's lse and delta. Correctness only:
    no kernel row."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    for dtype in ("bfloat16", "float16"):
        dt, tol = getattr(torch, dtype), FLASH_LP_REL_TOL[dtype]
        for label, Tq, Tk, padding, causal in (
                ("T=500 padding", 500, 500, True, False),
                ("Tq=128 Tk=512", 128, 512, False, False),
                ("Tq=128 Tk=512 causal", 128, 512, False, True)):
            B, H, D = 2, 12, 64
            q, k, v = (torch.from_numpy(rng.randn(B, H, n, D).astype(
                np.float32)).to(DEVICE).to(dt) for n in (Tq, Tk, Tk))
            bias = None
            if padding:
                vlen = rng.randint(Tk // 4, Tk + 1, size=B)
                bias = torch.from_numpy(np.where(
                    np.arange(Tk)[None, :] < vlen[:, None], 0.0,
                    -1e30).astype(np.float32)).to(DEVICE)
            scale = 1.0 / D ** 0.5
            out, lse = fa.flash_forward(q, k, v, bias, causal, scale)
            again = fa.flash_forward(q, k, v, bias, causal, scale)
            torch.cuda.synchronize()
            ref_out, ref_lse = fa.flash_forward_reference(q, k, v, bias,
                                                          causal, scale)
            err, rel = rel_err(out.float(), ref_out.float())
            lse_rel = rel_err(lse, ref_lse)[1]
            same = torch.equal(out, again[0]) and torch.equal(lse, again[1])
            log(f"kernel {fa.kernel_name('flash_fwd', dt)} B={B},H={H},"
                f"D={D},{label}: max_abs_err={err:.3e} (relative "
                f"{rel:.3e}, tol {tol}; lse relative {lse_rel:.3e}, tol "
                f"{FLASH_REL_TOL}) same bits twice {same} (correctness "
                f"only)")
            check(rel <= tol and lse_rel <= FLASH_REL_TOL,
                  f"flash_fwd {dtype} {label} disagrees with its twin")
            check(same, f"flash_fwd {dtype} {label}: two launches gave "
                  f"different bits")
            dout = torch.from_numpy(rng.randn(B, H, Tq, D).astype(
                np.float32)).to(DEVICE).to(dt)
            delta = (dout.float() * ref_out.float()).sum(-1).reshape(
                B * H, Tq)
            bw = (q, k, v, bias, dout, ref_lse, delta, causal, scale)
            want_db = bias is not None
            got, again = ((fa.flash_bwd_dkv(*bw, want_dbias=want_db)
                           + (fa.flash_bwd_dq(*bw),)) for _ in range(2))
            torch.cuda.synchronize()
            want = (fa.flash_bwd_dkv_reference(*bw, want_dbias=want_db)
                    + (fa.flash_bwd_dq_reference(*bw),))
            errs = [rel_err(g.float(), w.float())
                    for g, w in zip(got, want) if w is not None]
            err, rel = max(e[0] for e in errs), max(e[1] for e in errs)
            same = all(x is None and y is None or torch.equal(x, y)
                       for x, y in zip(got, again))
            log(f"kernel {fa.kernel_name('flash_bwd_dkv', dt)} + "
                f"{fa.kernel_name('flash_bwd_dq', dt)} B={B},H={H},D={D},"
                f"{label}: max_abs_err={err:.3e} (relative {rel:.3e}, tol "
                f"{tol}) same bits twice {same} (correctness only)")
            check(rel <= tol, f"flash backward {dtype} {label} disagrees "
                  f"with its twins")
            check(same, f"flash backward {dtype} {label}: two launches "
                  f"gave different bits")


def paged_case(torch, rng, S, Q, page_dtype="float32"):
    """Inputs of one chunk (``Q`` set) or decode (``Q`` None) paged
    attention launch at the decode phase's shapes, pages of
    ``page_dtype`` (f32, bf16 or f16; f32 q): ``S`` rows with kv
    lengths over 15..1024 (``PAGED_KV_LENS``, then random), fragmented
    tables over an (S * 64 + 1)-block pool; chunk rows query their last
    min(Q, kv_len) positions, one row fewer (a padded tail). Returns the
    arguments, the least bytes and the operations this data needs, and
    the valid-token mask of the output."""
    H, D, bs, MB = 12, 64, BLOCK_SIZE, 64
    N = S * MB + 1
    kv = np.array(PAGED_KV_LENS[:S] + tuple(
        rng.randint(15, MB * bs + 1, size=max(0, S - len(PAGED_KV_LENS)))),
        np.int32)
    tables = rng.permutation(np.arange(1, N)).astype(np.int32)[
        :S * MB].reshape(S, MB)
    dev = DEVICE
    qshape = (S, H, D) if Q is None else (S, Q, H, D)
    args = dict(q=torch.from_numpy(rng.randn(*qshape).astype(np.float32)),
                k_pages=torch.from_numpy(
                    rng.randn(N, bs, H, D).astype(np.float32)),
                v_pages=torch.from_numpy(
                    rng.randn(N, bs, H, D).astype(np.float32)),
                block_tables=torch.from_numpy(tables),
                kv_lens=torch.from_numpy(kv))
    if Q is None:
        ql = np.ones(S, np.int64)
        valid = np.ones((S,), bool)
    else:
        ql = np.minimum(Q, kv)
        ql[S // 2] = max(1, Q // 2)
        args["q_lens"] = torch.from_numpy(ql.astype(np.int32))
        valid = np.arange(Q)[None, :] < ql[:, None]
    args = {k: v.to(dev) for k, v in args.items()}
    dt = getattr(torch, page_dtype)
    args["k_pages"] = args["k_pages"].to(dt)
    args["v_pages"] = args["v_pages"].to(dt)
    # every valid token's horizon lies below kv_len: each row's first
    # ceil(kv_len / bs) pages, read once, plus q, out, tables and lengths
    pages = int(np.sum(-(-kv // bs)))
    nq = int(np.prod(qshape))
    nbytes = (2 * nq * 4 + 2 * pages * bs * H * D * dt.itemsize
              + 4 * S * MB + 4 * S * (1 if Q is None else 2))
    # token t of a row sees kv_len - q_len + t + 1 positions
    seen = sum(int(k - q + t + 1) for k, q in zip(kv, ql)
               for t in range(int(q)))
    return args, nbytes, 4 * D * H * seen, torch.from_numpy(valid).to(dev)


def run_paged_kernel_phase(torch, timer, rng):
    """K4 (chunk, Q=16 and Q=1) and K5 (decode, S=8 and S=64) against
    their plain twins on the valid tokens. No single PyTorch call
    computes paged attention (as for K1/K2): library none."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import ragged_attention as ra
    results = []
    for name, line, S, Q in ((ra.CHUNK_KERNEL, ":412", MAX_SEQS, CHUNK_Q),
                             (ra.CHUNK_KERNEL, ":412", MAX_SEQS, 1),
                             (ra.DECODE_KERNEL, ":512", MAX_SEQS, None),
                             (ra.DECODE_KERNEL, ":512", 64, None)):
        args, nbytes, flops, valid = paged_case(torch, rng, S, Q)

        def kern():
            return ra.ragged_paged_attention(**args)

        def plain():
            if Q is None:
                return ra.ragged_attention_reference(**args)
            return ra.ragged_chunk_attention_reference(**args)
        out_k = kern()
        again = kern()
        torch.cuda.synchronize()
        err = float((out_k - plain())[valid].abs().max())
        b_ms, b_by, b_f32 = bound(nbytes, flops)
        shape = (f"S={S}," + ("" if Q is None else f"Q={Q},")
                 + "H=12,D=64,bs=16,MB=64")
        check(torch.equal(out_k, again), f"{name} {shape}: two launches "
              f"gave different bits")
        extra, note = ring_note(
            kernels, ra, "float32", "ChunkTiles", (min(Q or 1, 16),)
            + ra.paged_plan(S, Q or 1, 12, 64, BLOCK_SIZE, 64,
                            torch.float32), 64, BLOCK_SIZE, 64)
        note = "; " + note
        res = dict(name=name, route="cuda",
                   source="mxnet_tpu_torch/csrc/ragged_flat.cu",
                   replaces="mxnet_tpu/ops/ragged_attention.py" + line,
                   shape=shape, max_abs_err=err, tol=ATT_TOL,
                   ms=timer.ms(kern), plain_ms=timer.ms(plain),
                   bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_f32,
                   library_ms=None, **extra)
        log(f"kernel {name} {shape}: max_abs_err={err:.3e} (tol {ATT_TOL}) "
            f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"library: none bound_ms={b_ms:.4f} ({b_by}){note}")
        check(err <= ATT_TOL, f"{name} {shape} disagrees with its plain "
              f"version: {err} > {ATT_TOL}")
        results.append(res)
    return results


def run_spec_kernel_rows(torch, timer, seed):
    """K1 (f32 pages) at speculative decoding's packs: the verify's
    (T=24: 8 rows of spec_k + 1 = 3 tokens) and the draft round's (T=16:
    8 rows of 2, a catch-up token and the proposal input), each against
    its plain twin with its bound and launch plan, giving the same bits
    on two launches. Case i draws its inputs from ``RandomState(seed +
    i)``."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import ragged_attention as ra
    results = []
    for i, (T, pack) in enumerate(((MAX_SEQS * (SPEC_K + 1), "verify"),
                                   (MAX_SEQS * 2, "draft"))):
        args, nbytes, flops = attention_case(
            torch, T, "float32", np.random.RandomState(seed + i))
        fixed = pack == "draft"     # the draft's pack-independent plan

        def kern():
            return ra.ragged_flat_attention(**args, pack_independent=fixed)

        def plain():
            return ra.ragged_flat_attention_reference(**args)
        out_k = kern()
        again = kern()
        torch.cuda.synchronize()
        err = float((out_k - plain()).abs().max())
        name = ra.kernel_name(torch.float32)
        check(torch.equal(out_k, again), f"{name} T={T}: two launches "
              f"gave different bits")
        b_ms, b_by, b_f32 = bound(nbytes, flops)
        extra, note = ring_note(kernels, ra, "float32", "FlatTiles",
                                ra.flat_plan(T, MAX_SEQS, 12, 64,
                                             BLOCK_SIZE, 64, torch.float32,
                                             fixed),
                                64, BLOCK_SIZE, 64)
        res = dict(name=name, route="cuda",
                   source="mxnet_tpu_torch/csrc/ragged_flat.cu",
                   replaces="mxnet_tpu/ops/ragged_attention.py:158",
                   shape=f"T={T},H=12,D=64,bs=16,MB=64 ({pack} pack, "
                         f"{T // MAX_SEQS} tokens a row)",
                   max_abs_err=err, tol=ATT_TOL, ms=timer.ms(kern),
                   plain_ms=timer.ms(plain), bound_ms=b_ms, bound_by=b_by,
                   bound_f32_ms=b_f32, library_ms=None, **extra)
        log(f"kernel {name} {res['shape']}: max_abs_err={err:.3e} "
            f"(tol {ATT_TOL}) kernel_ms={res['ms']:.4f} "
            f"plain_ms={res['plain_ms']:.4f} bound_ms={b_ms:.4f} "
            f"({b_by}); {note}")
        check(err <= ATT_TOL, f"{name} {res['shape']} disagrees with its "
              f"plain version: {err} > {ATT_TOL}")
        results.append(res)
    return results


def run_paged_lp_kernel_phase(torch, timer, seed):
    """K1 (T=8, 128), K4 (S=8, Q=16 and Q=1) and K5 (S=8, S=64) over bf16
    and f16 pages (``csrc/ragged_flat_lp.cu``) at the f32 rows' shapes,
    each against its plain twin on the same 16-bit pages (both read them
    as f32: ``ATT_TOL``), its bound at 2-byte pages; then K4 (Q=16) and
    K5 (S=8) once more with q in the pages' dtype, against the twin
    within one ulp of that dtype. Library none, as for the f32 rows.
    Case i draws its inputs from ``RandomState(seed + i)`` for bf16, for
    f16 and, pages in f32, for the f32 kernel, whose time on the same
    inputs each row carries as ``f32_ms``."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import ragged_attention as ra
    results = []
    src = "mxnet_tpu_torch/csrc/ragged_flat_lp.cu"
    cases = [("flat", ":158", T, None, False) for T in (8, 128)]
    cases += [("chunk", ":412", MAX_SEQS, Q, False) for Q in (CHUNK_Q, 1)]
    cases += [("decode", ":512", S, None, False) for S in (MAX_SEQS, 64)]
    cases += [("chunk", ":412", MAX_SEQS, CHUNK_Q, True),
              ("decode", ":512", MAX_SEQS, None, True)]
    for page_dtype in ("bfloat16", "float16"):
        dt = getattr(torch, page_dtype)
        for i, (kind, line, n, Q, q16) in enumerate(cases):
            def inputs(pd):
                rng = np.random.RandomState(seed + i)
                if kind == "flat":
                    return attention_case(torch, n, pd, rng) + (None,)
                return paged_case(torch, rng, n,
                                  Q if kind == "chunk" else None, pd)
            args32 = inputs("float32")[0]
            args, nbytes, flops, valid = inputs(page_dtype)
            if kind == "flat":
                shape = f"T={n},H=12,D=64,bs=16,MB=64"
                plan = ra.flat_plan(n, MAX_SEQS, 12, 64, BLOCK_SIZE, 64, dt,
                                    False)
                tiles = "FlatTiles"

                def kern(a=args):     # the target step's plan
                    return ra.ragged_flat_attention(**a,
                                                    pack_independent=False)

                def plain():
                    return ra.ragged_flat_attention_reference(**args)
            else:
                if q16:
                    # q and out at 2 bytes an element, not 4
                    nbytes -= args["q"].numel() * 4
                    args["q"] = args["q"].to(dt)
                shape = (f"S={n}," + (f"Q={Q}," if kind == "chunk" else "")
                         + "H=12,D=64,bs=16,MB=64"
                         + (f",q={page_dtype}" if q16 else ""))
                plan = (min(Q or 1, 16),) + ra.paged_plan(
                    n, Q or 1, 12, 64, BLOCK_SIZE, 64, dt)
                tiles = "ChunkTiles"

                def kern(a=args):
                    return ra.ragged_paged_attention(**a)

                def plain():
                    if kind == "decode":
                        return ra.ragged_attention_reference(**args)
                    return ra.ragged_chunk_attention_reference(**args)
            name = ra.kernel_name(dt, kind)
            out_k = kern()
            again = kern()
            torch.cuda.synchronize()
            want = plain()
            diff = (out_k.float() - want.float())
            err = float((diff if valid is None else diff[valid]).abs().max())
            tol = ATT_TOL
            if q16:
                tol = float(torch.finfo(dt).eps) * float(
                    want.float().abs().max())
            check(torch.equal(out_k, again), f"{name} {shape}: two launches "
                  f"gave different bits")
            check(out_k.dtype == args["q"].dtype, f"{name} {shape}: output "
                  f"dtype {out_k.dtype}, q {args['q'].dtype}")
            b_ms, b_by, b_f32 = bound(nbytes, flops)
            extra, note = ring_note(kernels, ra, page_dtype, tiles, plan, 64,
                                    BLOCK_SIZE, 64)
            res = dict(name=name, route="cuda", source=src,
                       replaces="mxnet_tpu/ops/ragged_attention.py" + line,
                       shape=shape, max_abs_err=err, tol=tol,
                       ms=timer.ms(kern), plain_ms=timer.ms(plain),
                       bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_f32,
                       library_ms=None,
                       f32_ms=timer.ms(lambda: kern(args32)), **extra)
            log(f"kernel {name} {shape}: max_abs_err={err:.3e} (tol "
                f"{tol:.3e}) kernel_ms={res['ms']:.4f} "
                f"plain_ms={res['plain_ms']:.4f} library: none "
                f"bound_ms={b_ms:.4f} ({b_by}); the f32-page kernel on "
                f"the same inputs {res['f32_ms']:.4f} ms; {note}")
            check(err <= tol, f"{name} {shape} disagrees with its plain "
                  f"version: {err} > {tol}")
            results.append(res)
    results += run_paged_dtype_mix_rows(torch, timer, seed + 100)
    return results


# the input dtypes the TPU kernels take beyond q f32 or in the pages' own
# dtype: (kind, TPU kernel line, tokens or rows, Q, q, K pages, V pages)
PAGED_DTYPE_MIXES = (
    ("flat", ":158", 8, None, "bfloat16", "float32", "float32"),
    ("flat", ":244", 8, None, "bfloat16", "int8", "int8"),
    ("chunk", ":412", MAX_SEQS, CHUNK_Q, "float16", "bfloat16", "bfloat16"),
    ("decode", ":512", MAX_SEQS, None, "float16", "bfloat16", "bfloat16"),
    ("chunk", ":412", MAX_SEQS, CHUNK_Q, "float32", "bfloat16", "float16"),
    ("decode", ":512", MAX_SEQS, None, "float32", "bfloat16", "float16"))


def run_paged_dtype_mix_rows(torch, timer, seed):
    """K1 and K2 with bf16 q over f32 and int8 pages, K4 (Q=16) and K5
    (S=8) with f16 q over bf16 pages and with f32 q over bf16 K and f16 V
    pages, at the f32 rows' shapes, each against its plain twin on the
    same tensors (16-bit q: within one ulp of q's dtype; f32 q:
    ``ATT_TOL``), its bound from the bytes of the inputs as given. K and V
    of two dtypes run the f32-page kernel on pools the wrapper widens to
    f32: such a row also carries ``f32_ms``, the kernel alone on pools
    widened beforehand, so ``ms - f32_ms`` is what the widening costs the
    op. Case i draws from ``RandomState(seed + i)``."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import ragged_attention as ra
    results = []
    for i, (kind, line, n, Q, qd, kd, vd) in enumerate(PAGED_DTYPE_MIXES):
        rng = np.random.RandomState(seed + i)
        if kind == "flat":
            args, nbytes, flops = attention_case(torch, n, kd, rng)
            valid = None
            shape = f"T={n},H=12,D=64,bs=16,MB=64"
            plan = ra.flat_plan(n, MAX_SEQS, 12, 64, BLOCK_SIZE, 64,
                                args["k_pages"].dtype)
        else:
            # both pools at 2 bytes an element; V then in its own dtype
            # (bf16 values are exact in f16)
            args, nbytes, flops, valid = paged_case(
                torch, rng, n, Q if kind == "chunk" else None, kd)
            args["v_pages"] = args["v_pages"].to(getattr(torch, vd))
            shape = (f"S={n}," + (f"Q={Q}," if kind == "chunk" else "")
                     + "H=12,D=64,bs=16,MB=64")
            plan = (min(Q or 1, 16),) + ra.paged_plan(
                n, Q or 1, 12, 64, BLOCK_SIZE, 64,
                torch.float32 if kd != vd else getattr(torch, kd))
        shape += f",q={qd},k={kd},v={vd}"
        if qd != "float32":
            nbytes -= args["q"].numel() * 4   # q and out at 2 bytes, not 4
            args["q"] = args["q"].to(getattr(torch, qd))
        call = (ra.ragged_flat_attention if kind == "flat"
                else ra.ragged_paged_attention)
        twin = {"flat": ra.ragged_flat_attention_reference,
                "chunk": ra.ragged_chunk_attention_reference,
                "decode": ra.ragged_attention_reference}[kind]
        page_dt = args["k_pages"].dtype if kd == vd else torch.float32
        name = ra.kernel_name(page_dt, kind)

        def kern(a=args):
            return call(**a)

        def plain():
            return twin(**args)
        out_k = kern()
        again = kern()
        torch.cuda.synchronize()
        want = plain()
        diff = out_k.float() - want.float()
        err = float((diff if valid is None else diff[valid]).abs().max())
        tol = ATT_TOL if qd == "float32" else float(
            torch.finfo(want.dtype).eps) * float(want.float().abs().max())
        check(torch.equal(out_k, again), f"{name} {shape}: two launches "
              f"gave different bits")
        check(out_k.dtype == want.dtype == args["q"].dtype,
              f"{name} {shape}: output dtype {out_k.dtype}")
        b_ms, b_by, b_f32 = bound(nbytes, flops)
        src = ("mxnet_tpu_torch/csrc/ragged_flat_lp.cu"
               if page_dt in (torch.bfloat16, torch.float16)
               else "mxnet_tpu_torch/csrc/ragged_flat.cu")
        extra, note = ring_note(kernels, ra, str(page_dt)[6:],
                                "FlatTiles" if kind == "flat"
                                else "ChunkTiles",
                                plan, 64, BLOCK_SIZE, 64)
        res = dict(name=name, route="cuda", source=src,
                   replaces="mxnet_tpu/ops/ragged_attention.py" + line,
                   shape=shape, max_abs_err=err, tol=tol,
                   ms=timer.ms(kern), plain_ms=timer.ms(plain),
                   bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_f32,
                   library_ms=None, **extra)
        widen = ""
        if kd != vd:
            wide = dict(args, k_pages=args["k_pages"].float(),
                        v_pages=args["v_pages"].float())
            res["f32_ms"] = timer.ms(lambda: kern(wide))
            widen = (f"; on pools widened beforehand {res['f32_ms']:.4f} "
                     f"ms (the widening: "
                     f"{res['ms'] - res['f32_ms']:.4f} ms)")
            del wide
        log(f"kernel {name} {shape}: max_abs_err={err:.3e} (tol {tol:.3e}) "
            f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"library: none bound_ms={b_ms:.4f} ({b_by}){widen}; {note}")
        check(err <= tol, f"{name} {shape} disagrees with its plain "
              f"version: {err} > {tol}")
        results.append(res)
    return results


def run_wq_x16_rows(torch, timer, rng):
    """K3 with bf16 and f16 x at T=8, K=768, N=3072 (the step's MLP up
    projection shape), int8 and fp8 weights, against the plain twin on
    the same tensors (f32 out, ``WQ_REL_TOL``); bound from x at 2 bytes;
    library: ``x.float() @ (q.float() * s)``."""
    from mxnet_tpu_torch.ops import quantization as qz
    from mxnet_tpu_torch.serving.llm.quant import quantize_leaf
    results = []
    T, K, N = 8, 768, 3072
    for wdt in ("int8", "float8_e4m3fn"):
        w = rng.randn(K, N).astype(np.float32) / np.sqrt(K)
        q, s = (t.to(DEVICE) for t in quantize_leaf(w, wdt))
        x32 = torch.from_numpy(rng.randn(T, K).astype(np.float32)).to(DEVICE)
        for xdt in ("bfloat16", "float16"):
            x = x32.to(getattr(torch, xdt))

            def kern():
                return qz.quantized_matmul(x, q, s)

            def plain():
                return qz.quantized_matmul_reference(x, q, s)

            def library():
                return x.float() @ (q.float() * s)
            out_k = kern()
            torch.cuda.synchronize()
            ref = plain()
            err = float((out_k - ref).abs().max())
            tol = WQ_REL_TOL * max(1.0, float(ref.abs().max()))
            check(out_k.dtype == torch.float32, f"K3 {xdt} x gave "
                  f"{out_k.dtype}")
            # a 16-bit x is exact in TF32: one pass
            b_ms, b_by, b_f32 = bound(2 * T * K + K * N + 4 * N + 4 * T * N,
                                      2 * T * K * N, 1)
            name = qz.kernel_name(q.dtype)
            res = dict(name=name, route="cuda",
                       source="mxnet_tpu_torch/csrc/wq_matmul.cu",
                       replaces="mxnet_tpu/ops/quantization.py:297",
                       shape=f"T={T},K={K},N={N},x={xdt}", max_abs_err=err,
                       tol=tol, ms=timer.ms(kern), plain_ms=timer.ms(plain),
                       bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_f32,
                       library_ms=timer.ms(library))
            log(f"kernel {name} {res['shape']}: max_abs_err={err:.3e} "
                f"(tol {tol:.3e}) kernel_ms={res['ms']:.4f} "
                f"plain_ms={res['plain_ms']:.4f} "
                f"library_ms={res['library_ms']:.4f} bound_ms={b_ms:.4f} "
                f"({b_by})")
            check(err <= tol, f"{name} {res['shape']} disagrees with its "
                  f"plain version: {err} > {tol}")
            results.append(res)
    return results


# --------------------------------------------------- main-path phases --
def mixed_batch(model, rng, dev):
    """One packed batch of three sequences written from position 0
    (lengths 5, 16 and 37: inside a block, exactly one block, across two
    boundaries) plus two padded tokens; returns the decode_flat inputs
    and the per-sequence token lists."""
    import torch
    lens = (5, 16, 37)
    seqs = [rng.randint(0, model.vocab_size, size=n).tolist()
            for n in lens]
    bs, S, MB = BLOCK_SIZE, MAX_SEQS, 4
    tables = np.zeros((S, MB), np.int32)
    nxt = 1
    for i, n in enumerate(lens):
        nb = -(-n // bs)
        tables[i, :nb] = np.arange(nxt + 3 * nb, nxt, -3)[:nb]
        nxt += 3 * nb + 1
    tok, pos, sid = [], [], []
    for i, s in enumerate(seqs):
        tok += s
        pos += list(range(len(s)))
        sid += [i] * len(s)
    valid = [1] * len(tok) + [0, 0]
    tok += [0, 0]
    pos += [0, 0]
    sid += [0, 0]
    t = {k: torch.tensor(v, dtype=torch.int32, device=dev) for k, v in
         (("tokens", tok), ("positions", pos), ("seq_ids", sid),
          ("valid", valid))}
    t["block_tables"] = torch.from_numpy(tables).to(dev)
    return t, seqs


def step_logits(model, params, batch, kv_dtype, w_scales, num_blocks=64,
                adapter=None):
    from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache
    c = model.config
    cache = PagedKVCache(c.num_layers, c.num_heads, c.head_dim,
                         BLOCK_SIZE, num_blocks, c.max_context,
                         dtype=kv_dtype, device=model.device)
    kw = {} if w_scales is None else {"w_scales": w_scales}
    if cache.quantized:
        kw.update(k_scales=cache.k_scales, v_scales=cache.v_scales)
    if adapter is not None:
        kw["adapter"] = adapter
    return model.decode_flat(params, batch["tokens"], batch["positions"],
                             batch["seq_ids"], batch["valid"],
                             cache.k_pages, cache.v_pages,
                             batch["block_tables"], **kw)


def prompts_for(rng, vocab):
    """8 prompts, lengths spread over 15..700 (block boundaries and both
    table-width rungs crossed); index 3 and the late prefix-hit request
    share a 256-token prefix."""
    shared = rng.randint(0, vocab, size=256).tolist()
    lens = [15, 16, 33, None, 129, 300, 511, 700]
    out = []
    for n in lens:
        if n is None:
            out.append(shared + rng.randint(0, vocab, size=44).tolist())
        else:
            out.append(rng.randint(0, vocab, size=n).tolist())
    return out, shared


def serve(torch, server, prompts, sampled_idx, late=None):
    """Submit every prompt at once; with ``late=(after, prompt)`` submit
    one more as soon as request ``after`` has its first token (its
    prompt blocks are then registered and it still holds them).
    Returns (results, wall seconds)."""
    from mxnet_tpu_torch.serving.llm import SamplingParams
    t0 = time.monotonic()
    futs = []
    for i, p in enumerate(prompts):
        sp = (SamplingParams(temperature=0.8, top_p=0.9, seed=100 + i)
              if i in sampled_idx else None)
        futs.append(server.submit(p, NEW_TOKENS, sampling=sp))
    if late is not None:
        after, prompt = late
        seq = futs[after]._mxt_seq
        while not seq.generated and not futs[after].done():
            time.sleep(0.001)
        futs.append(server.submit(prompt, NEW_TOKENS))
    res = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    return res, time.monotonic() - t0


def ttft_ms(results, q=50):
    """The ``q``-th percentile of ``results``' TTFT in ms, each from its
    request's own submit and first-token times (``stats()["ttft_ms"]``
    interpolates inside the registry histogram's fixed buckets)."""
    return float(np.percentile([r.ttft_s for r in results], q)) * 1e3


def check_greedy(model, params, prompt, tokens, tol, label, lora=None):
    """The served greedy stream must equal the plain oracle's, except
    that it may leave it at a step where the oracle's top-2 logit gap
    is below ``tol`` (a near tie that float reordering can flip).
    ``lora``: the adapter's ``bank.adapter_arrays(name)``."""
    from mxnet_tpu_torch.serving.llm import greedy_decode_reference
    ref, logits = greedy_decode_reference(model, params, prompt,
                                          len(tokens), return_logits=True,
                                          lora=lora)
    for i, (a, b) in enumerate(zip(tokens, ref)):
        if a != b:
            top2 = logits[i].topk(2).values
            gap = float(top2[0] - top2[1])
            check(gap < tol, f"{label}: token {i} is {a}, oracle {b}, "
                  f"top-2 gap {gap} >= {tol}")
            return f"diverged at {i} on a near tie (gap {gap:.2e})"
    check(len(tokens) == len(ref), f"{label}: {len(tokens)} tokens, "
          f"oracle {len(ref)}")
    return "identical"


def drive_engine(torch, engine, prompts, adapters=None):
    """Drive ``engine`` (idle, warmed) through ``prompts`` (under
    ``adapters``, one name or None a prompt) on this thread to the end;
    returns (steps, wall seconds)."""
    from mxnet_tpu_torch.serving.llm import Sequence
    adapters = adapters or [None] * len(prompts)
    seqs = [Sequence(p, NEW_TOKENS, adapter=a)
            for p, a in zip(prompts, adapters)]
    t0 = time.monotonic()
    for s in seqs:
        engine.add(s)
    steps = 0
    while engine.has_work():
        engine.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    engine.pop_finished()
    return steps, wall


def profile_engine(torch, engine, prompts, adapters=None):
    """Drive ``engine`` (idle, warmed) through ``prompts`` (under
    ``adapters``) on this thread under ``torch.profiler``; print the
    device busy share of the wall time and the kernels that took the
    most device time. Returns the busy share, or None when the profiler
    saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps, wall = drive_engine(torch, engine, prompts, adapters)
    return report_profile(prof, wall, steps)


def warm_server(torch, server, tag):
    """``server.warmup()``, which captures the step's graph at every
    rung (and, with a draft model, the draft round's at every rung of
    its own ladder): prints the graphs, the capture seconds and the
    graph pool's bytes (device memory before and after), checks one
    graph a rung. Returns (compile count after warmup, the engine's
    programs(), the counter of ``decode_flat`` calls from Python, the
    target's and the draft's, from here on)."""
    from mxnet_tpu_torch.serving.telemetry import compile_count
    engine = server.engine
    torch.cuda.synchronize()
    alloc, reserved = (torch.cuda.memory_allocated(),
                       torch.cuda.memory_reserved())
    t0 = time.monotonic()
    server.warmup()
    torch.cuda.synchronize()
    progs = engine.programs()
    n_mb = len(progs["mb_widths"])
    rungs = 2 * n_mb * (len(progs["t_buckets"])
                        + len(progs["draft_t_buckets"]))
    draft = (f"; draft packed lengths {progs['draft_t_buckets']} x the "
             f"same widths x greedy/sampled" if progs["draft_t_buckets"]
             else "")
    log(f"{tag}: warmup {time.monotonic() - t0:.2f}s: {progs['graphs']} "
        f"graphs captured ({rungs} rungs: packed lengths "
        f"{progs['t_buckets']} x table widths {progs['mb_widths']} x "
        f"greedy/sampled{draft}) in {progs['capture_seconds']:.2f}s; "
        f"graph pool "
        f"{engine.graph_pool_bytes() / 1e6:.1f} MB; device memory "
        f"allocated {(torch.cuda.memory_allocated() - alloc) / 1e6:+.1f} "
        f"MB, reserved {(torch.cuda.memory_reserved() - reserved) / 1e6:+.1f}"
        f" MB over the warmup")
    check(progs["graphs"] == progs["step_variants"]
          + progs["draft_variants"] == rungs,
          f"{tag}: {progs['graphs']} graphs after warmup, {rungs} rungs")
    calls = count_calls(engine.model, "decode_flat")
    if engine.draft_model not in (None, engine.model):
        count_calls(engine.draft_model, "decode_flat", calls)
    return compile_count(), progs, calls


def count_calls(obj, name, calls=None):
    """Count the Python calls of ``obj.name`` (an instance attribute
    wraps the method) in ``calls`` (a new one-element counter if None);
    returns the counter."""
    calls = [0] if calls is None else calls
    fn = getattr(obj, name)

    def counted(*args, **kw):
        calls[0] += 1
        return fn(*args, **kw)
    setattr(obj, name, counted)
    return calls


def check_graph_steps(tag, engine, before, calls, compiles):
    """After serving: every dispatch was one graph replay, the model
    step never ran in Python, nothing was built or captured. Prints the
    replays and dispatches and restores ``decode_flat`` (the target's
    and the draft's)."""
    from mxnet_tpu_torch.serving.telemetry import compile_count
    for m in {id(m): m for m in (engine.model, engine.draft_model)
              if m is not None}.values():
        m.__dict__.pop("decode_flat", None)
    progs = engine.programs()
    replays = progs["replays"] - before["replays"]
    dispatches = progs["dispatches"] - before["dispatches"]
    log(f"{tag}: {dispatches} dispatches, {replays} graph replays; "
        f"decode_flat ran {calls[0]} times in Python after warmup; "
        f"builds + captures after warmup {compile_count() - compiles}")
    check(dispatches > 0 and replays == dispatches,
          f"{tag}: {replays} replays for {dispatches} dispatches")
    check(calls[0] == 0, f"{tag}: decode_flat ran {calls[0]} times in "
          "Python after warmup")
    check(compile_count() == compiles, f"{tag}: a kernel was built or a "
          "graph captured after warmup")


def verify_dispatches(engine, before):
    """Step (verify) dispatches since ``before`` (an earlier
    ``programs()``), draft rounds not counted."""
    now = engine.programs()
    return (now["dispatches"] - now["draft_dispatches"]
            - before["dispatches"] + before["draft_dispatches"])


def host_ms_per_step(torch, server, prompts, tag, adapters=None):
    """Capture the idle server's graphs again (shutdown released them)
    and drive ``prompts`` (under ``adapters``) through its engine on
    this thread without the profiler; prints host ms per step."""
    server.engine.warmup()
    steps, wall = drive_engine(torch, server.engine, prompts, adapters)
    log(f"{tag}: {steps} steps in {wall:.3f}s without the profiler: host "
        f"{wall / steps * 1e3:.2f} ms/step")
    return wall / steps * 1e3


def is_range(name):
    """A ``record_function`` range, not a kernel: the ``spec.*`` ranges
    of :func:`profile_spec` and the tracer's ``mxtpu.*`` spans, which the
    profiler also lays on the device timeline over the kernels they
    enclose."""
    return name.startswith(("spec.", "mxtpu."))


def device_rows(prof):
    """The profiler's rows with device time, and their sum in us
    (ranges, :func:`is_range`, not counted)."""
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0
            and not is_range(e.key)]
    return rows, sum(e.self_device_time_total for e in rows)


# the last profiled pass's device busy ms, steps and wall seconds
PROFILED = {}


def report_profile(prof, wall, steps):
    """Print the device busy share of ``wall`` seconds (``steps`` steps)
    and the kernels that took the most device time; returns the share,
    or None when the profiler saw no device time (the numbers also go
    to ``PROFILED``)."""
    rows, busy_us = device_rows(prof)
    PROFILED.clear()
    if not rows:
        log("profile: the profiler saw no device time (not measured)")
        return None
    share = busy_us / (wall * 1e6)
    PROFILED.update(busy_ms=busy_us / 1e3, steps=steps, wall=wall)
    log(f"profile: {steps} steps in {wall:.3f}s under the profiler "
        f"({wall / steps * 1e3:.2f} ms/step); device busy "
        f"{busy_us / 1e3:.1f} ms = {share:.3f} of wall, idle "
        f"{1 - share:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.self_device_time_total / busy_us:6.3f} of device "
            f"x{e.count:<6d} {e.key[:90]}")
    return share


def check_greedy_plain(model, params, prompt, tokens, kv_dtype, tol,
                       label, chunk=64, w_scales=None, adapter=None):
    """Hold a served greedy stream over ``kv_dtype`` pools against the
    port's plain step over pools of the same dtype: ``model``/``params``
    on the CPU (every kernel's plain version) run ``decode_flat`` over
    the prompt and the served tokens, ``chunk`` positions a call (as a
    prefill does); the logits at each position must pick the served
    token, or may pick another only where their top-2 gap is below
    ``tol`` (a near tie). Every token is checked: the plain step reads
    the served stream, not its own. ``w_scales``: quantized weights'
    scales (``params`` then the quantized tree). ``adapter``: ``(bank,
    name)``, a CPU bank holding the stream's adapter, whose delta the
    plain step adds. Returns a verdict."""
    import torch
    from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache
    c = model.config
    seq = list(prompt) + list(tokens[:-1])
    n = len(seq)
    mb = -(-n // BLOCK_SIZE)
    cache = PagedKVCache(c.num_layers, c.num_heads, c.head_dim,
                         BLOCK_SIZE, mb + 1, c.max_context, dtype=kv_dtype,
                         device="cpu")
    tables = torch.arange(1, mb + 1, dtype=torch.int32)[None, :]
    kw = {} if w_scales is None else {"w_scales": w_scales}
    if cache.k_scales is not None:
        kw.update(k_scales=cache.k_scales, v_scales=cache.v_scales)
    handle = None
    if adapter is not None:
        bank, name = adapter
        handle = bank.acquire(name)
        kw["adapter"] = (bank, torch.tensor([handle.pages_padded],
                                            dtype=torch.int32),
                         torch.tensor([handle.scale], dtype=torch.float32))
    picked = []
    with torch.no_grad():
        for p0 in range(0, n, chunk):
            pos = torch.arange(p0, min(n, p0 + chunk), dtype=torch.int32)
            logits = model.decode_flat(
                params, torch.tensor(seq[p0:p0 + chunk], dtype=torch.int32),
                pos, torch.zeros_like(pos), torch.ones_like(pos),
                cache.k_pages, cache.v_pages, tables, **kw)
            for i, p in enumerate(pos.tolist()):
                if p >= len(prompt) - 1:
                    picked.append(logits[i])
    if handle is not None:
        bank.release(handle)
    ties = []
    for i, (tok, lg) in enumerate(zip(tokens, picked)):
        top2 = lg.topk(2)
        if int(top2.indices[0]) != tok:
            gap = float(top2.values[0] - lg[tok])
            check(gap < tol, f"{label}: token {i} is {tok}, the plain step "
                  f"picks {int(top2.indices[0])} by {gap} >= {tol}")
            ties.append(f"{i} (gap {gap:.2e})")
    return ("identical" if not ties else
            f"another pick on near ties at {', '.join(ties)}")


def run_f32_phase(torch, rng, np_params, kernels, dtype="float32"):
    """``LLMServer`` at GPT-2-small widths over ``dtype`` pools (f32,
    or bf16 through ``dtype="bfloat16"``): 9 requests, greedy and
    sampled, a prefix hit with copy-on-write, every dispatch one graph
    replay. f32 greedy streams are held against the dense oracle and a
    mixed packed step against the dense forward; 16-bit ones against
    the port's plain step on the CPU over pools of the same dtype
    (:func:`check_greedy_plain`, :func:`step_logits`). Returns (launches,
    stats, tokens/s, a summary for the speculative phase: the traffic,
    tokens/s, TTFT p50, host ms per step, verify dispatches per
    committed token)."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.ops.ragged_attention import kernel_name
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    tag = {"float32": "f32", "bfloat16": "bf16"}[dtype]
    flat = kernel_name(getattr(torch, dtype))
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    server = LLMServer(model, np_params, name=f"gpt2-{tag}",
                       max_seqs=MAX_SEQS, block_size=BLOCK_SIZE,
                       dtype=dtype, device=DEVICE)
    check(server.engine.cache.k_pages.dtype == getattr(torch, dtype),
          f"{tag}: pools of {server.engine.cache.k_pages.dtype}")
    builds, progs, calls = warm_server(torch, server, tag)
    log(f"{tag}: kv pool {server.engine.cache.nbytes() / 1e9:.3f} GB "
        f"({dtype}), weights {server.engine.weight_bytes / 1e9:.3f} GB")
    prompts, shared = prompts_for(rng, model.vocab_size)
    # the packed length of each dispatch (one flat attention launch per
    # layer each), tallied where the engine fills the step's batch
    rungs = {}
    build_batch = server.engine._build_batch

    def tally(rows, plans, t, mb):
        rungs[t] = rungs.get(t, 0) + 1
        return build_batch(rows, plans, t, mb)
    server.engine._build_batch = tally
    server.start()
    kernels.reset_launch_counts()
    res, wall = serve(torch, server, prompts, sampled_idx=(1, 5),
                      late=(3, shared))
    launches = kernels.launch_counts()
    server.shutdown()
    verifies = verify_dispatches(server.engine, progs)
    server.engine._build_batch = build_batch
    per_rung = {t: n * model.num_layers for t, n in sorted(rungs.items())}
    st = server.stats()
    n_tok = sum(len(r.tokens) for r in res)
    log(f"{tag}: served {len(res)} requests, {n_tok} tokens in "
        f"{wall:.3f}s = {n_tok / wall:.1f} tokens/s (end to end); "
        f"decode EMA {st['tokens_per_sec']:.1f} tokens/s; TTFT p50 "
        f"{ttft_ms(res):.2f} ms p99 {ttft_ms(res, 99):.2f} ms;"
        f" prefix hits {st['prefix_hits']}, COW copies "
        f"{st['kv_cache']['cow_copies']}, preemptions {st['preemptions']}")
    log(f"{tag}: launches {launches}; flat attention launches per packed "
        f"length {per_rung}")
    check_graph_steps(tag, server.engine, progs, calls, builds)
    check(st["kv_dtype"] == dtype, f"{tag}: stats kv_dtype "
          f"{st['kv_dtype']}")
    check(sum(per_rung.values()) == launches.get(flat, 0),
          f"{tag}: flat attention launches do not match the dispatches")
    check(all(len(r.tokens) == NEW_TOKENS for r in res),
          f"{tag}: a request stopped short")
    check(launches.get(flat, 0) > 0,
          f"{tag}: the flat attention kernel never ran on the main path")
    check(st["prefix_hits"] >= 1 and st["kv_cache"]["cow_copies"] >= 1,
          f"{tag}: the prefix cache / copy-on-write path was not taken")
    params = server.engine.params
    greedy = [i for i in range(len(res)) if i not in (1, 5)]
    all_prompts = prompts + [shared]
    if dtype != "float32":
        cpu_model = TinyDecoder(device="cpu", **GPT2_SMALL)
        cpu_params = params_from_numpy(np_params, "cpu")
    for i in greedy:
        if dtype == "float32":
            verdict = check_greedy(model, params, all_prompts[i],
                                   res[i].tokens, F32_LOGIT_TOL,
                                   f"f32 request {i}")
            oracle = "oracle"
        else:
            verdict = check_greedy_plain(
                cpu_model, cpu_params, all_prompts[i], res[i].tokens,
                dtype, LP_LOGIT_TOL[dtype], f"{tag} request {i}")
            oracle = f"the plain step over {dtype} pools (CPU)"
        log(f"{tag}: request {i} (prompt {len(all_prompts[i])}) greedy vs "
            f"{oracle}: {verdict}")
    for i in (1, 5):
        toks = res[i].tokens
        check(all(0 <= t < model.vocab_size for t in toks),
              f"{tag}: sampled request {i} emitted an out-of-vocab token")
    batch, seqs = mixed_batch(model, rng, DEVICE)
    logits = step_logits(model, params, batch, dtype, None)
    check(bool(torch.isfinite(logits).all()), f"{tag}: non-finite logits")
    if dtype == "float32":
        off, err = 0, 0.0
        for s in seqs:
            dense, _, _ = model.forward(
                params, torch.tensor([s], device=DEVICE))
            err = max(err, float((logits[off:off + len(s)]
                                  - dense[0]).abs().max()))
            off += len(s)
        log(f"f32: decode_flat vs dense forward on a mixed packed batch: "
            f"max_abs_err={err:.3e} (tol {F32_LOGIT_TOL})")
        check(err <= F32_LOGIT_TOL,
              "f32: decode_flat disagrees with forward")
    else:
        want = step_logits(cpu_model, cpu_params,
                           {k: v.cpu() for k, v in batch.items()}, dtype,
                           None)
        n = int(batch["valid"].sum())
        err = float((logits[:n].cpu() - want[:n]).abs().max())
        log(f"{tag}: decode_flat kernel path vs plain path (CPU) over "
            f"{dtype} pools on a mixed packed batch: max_abs_err={err:.3e} "
            f"(tol {LP_LOGIT_TOL[dtype]})")
        check(err <= LP_LOGIT_TOL[dtype],
              f"{tag}: kernel path disagrees with the plain path")
    # where the time goes: the same traffic (fresh prompts, so no prefix
    # hits) through the idle engine on this thread, without the profiler
    # (prompts from a generator of its own: the later phases draw their
    # inputs from ``rng`` as they did before this pass existed), then
    # with it
    host_ms = host_ms_per_step(torch, server, prompts_for(
        np.random.RandomState(1), model.vocab_size)[0], tag)
    profile_engine(torch, server.engine,
                   prompts_for(rng, model.vocab_size)[0])
    summary = dict(prompts=prompts, shared=shared, tokens_s=n_tok / wall,
                   ttft_p50=ttft_ms(res), host_ms=host_ms,
                   per_token=verifies / n_tok, profiled=dict(PROFILED))
    return launches, st, n_tok / wall, summary


def run_default_config_phase(torch, rng, kernels):
    """The reference's default ``DecoderConfig()`` (vocab 32, d_model 32,
    2 layers, 2 heads: head dim 16) served through ``LLMServer`` with
    ``dtype="float32"`` (the reference's signature): greedy streams
    against ``greedy_decode_reference`` and one mixed packed
    ``decode_flat`` step against the same step on the CPU (the kernels'
    plain twins). Returns the launch counts of the served traffic."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.serving.llm import (DecoderConfig, LLMServer,
                                             TinyDecoder)
    model = TinyDecoder(device=DEVICE)
    c = model.config
    check(c.head_dim == 16, f"default config head_dim {c.head_dim}")
    np_params = model.init_params_numpy(0)
    server = LLMServer(model, np_params, name="default-f32", max_seqs=4,
                       block_size=BLOCK_SIZE, dtype="float32",
                       device=DEVICE)
    compiles, progs, calls = warm_server(torch, server, "default config")
    prompts = [rng.randint(0, c.vocab_size, size=n).tolist()
               for n in (1, 15, 17, 40)]
    server.start()
    kernels.reset_launch_counts()
    res, wall = serve(torch, server, prompts, sampled_idx=())
    launches = kernels.launch_counts()
    server.shutdown()
    check_graph_steps("default config", server.engine, progs, calls,
                      compiles)
    check(launches.get("flat_attention", 0) > 0,
          "default config: the flat attention kernel never ran")
    params = server.engine.params
    verdicts = [check_greedy(model, params, p, r.tokens, F32_LOGIT_TOL,
                             f"default config request {i}")
                for i, (p, r) in enumerate(zip(prompts, res))]
    cpu_model = TinyDecoder(DecoderConfig(), device="cpu")
    batch, _ = mixed_batch(model, rng, DEVICE)
    got = step_logits(model, params, batch, "float32", None)
    want = step_logits(cpu_model, params_from_numpy(np_params, "cpu"),
                       {k: v.cpu() for k, v in batch.items()}, "float32",
                       None)
    n = int(batch["valid"].sum())
    err = float((got[:n].cpu() - want[:n]).abs().max())
    log(f"default config (head_dim 16, dtype=float32): served "
        f"{len(res)} requests in {wall:.3f}s; greedy vs oracle: "
        f"{', '.join(verdicts)}; decode_flat on the card vs the plain step "
        f"on the CPU: max_abs_err={err:.3e} (tol {F32_LOGIT_TOL}); "
        f"launches {launches}")
    check(bool(torch.isfinite(got[:n]).all()),
          "default config: non-finite logits")
    check(err <= F32_LOGIT_TOL, "default config: the kernel path disagrees "
          "with the plain step")
    return launches


def run_quant_phase(torch, rng, np_params, kernels, dtype):
    """``LLMServer`` at GPT-2-small widths on 3 greedy requests: int8 or
    fp8 KV with weights of the same dtype (``kv_dtype=``), or f16 pools
    with f32 weights (``dtype="float16"``). A mixed packed step against
    the same step on the CPU (every kernel's plain version); f16's
    streams also against the plain step over f16 pools. Returns the
    launch counts."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.serving.llm import (LLMServer, TinyDecoder,
                                             quantize_weights)
    quant = dtype != "float16"
    tag = {"int8": "int8", "float8_e4m3fn": "fp8", "float16": "f16"}[dtype]
    if quant:
        weights = quantize_weights(np_params, dtype=dtype)
        cpu_params, w_scales = weights.params, weights.scales
        kw = dict(kv_dtype=dtype)
    else:
        weights = np_params
        cpu_params, w_scales = params_from_numpy(np_params, "cpu"), None
        kw = dict(dtype=dtype)
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    server = LLMServer(model, weights, name=f"gpt2-{tag}",
                       max_seqs=MAX_SEQS,
                       block_size=BLOCK_SIZE, device=DEVICE, **kw)
    builds, progs, calls = warm_server(torch, server, tag)
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in (17, 64, 200)]
    server.start()
    kernels.reset_launch_counts()
    res, wall = serve(torch, server, prompts, sampled_idx=())
    launches = kernels.launch_counts()
    server.shutdown()
    st = server.stats()
    n_tok = sum(len(r.tokens) for r in res)
    log(f"{tag}: served {len(res)} requests, {n_tok} tokens in "
        f"{wall:.3f}s = {n_tok / wall:.1f} tokens/s; TTFT p50 "
        f"{ttft_ms(res):.2f} ms; launches {launches}; kv pool "
        f"{server.engine.cache.nbytes() / 1e9:.3f} GB ({st['kv_dtype']}); "
        f"weights {st['weight_bytes'] / 1e9:.3f} GB")
    check_graph_steps(tag, server.engine, progs, calls, builds)
    if quant:
        check(launches.get(f"flat_attention_quant.{tag}", 0) > 0
              and launches.get(f"wq_matmul.{tag}", 0) > 0,
              f"{tag}: a quantized kernel never ran on the main path")
    else:
        check(st["kv_dtype"] == dtype
              and launches.get(f"flat_attention.{tag}", 0) > 0,
              f"{tag}: the f16 flat kernel never ran on the main path")
    # the same step on the CPU (every kernel's plain version)
    cpu_model = TinyDecoder(device="cpu", **GPT2_SMALL)
    batch, _ = mixed_batch(model, rng, DEVICE)
    got = step_logits(model, server.engine.params, batch, dtype,
                      server.engine.w_scales)
    want = step_logits(cpu_model, cpu_params,
                       {k: v.cpu() for k, v in batch.items()}, dtype,
                       w_scales)
    n = int(batch["valid"].sum())
    err = float((got[:n].cpu() - want[:n]).abs().max())
    tol = QUANT_LOGIT_TOL[dtype] if quant else LP_LOGIT_TOL[dtype]
    log(f"{tag}: decode_flat kernel path vs plain path (CPU) on a mixed "
        f"packed batch: max_abs_err={err:.3e} (tol {tol})")
    check(bool(torch.isfinite(got[:n]).all()), f"{tag}: non-finite logits")
    check(err <= tol, f"{tag}: kernel path disagrees with the plain path")
    if not quant:
        for i, (p, r) in enumerate(zip(prompts, res)):
            verdict = check_greedy_plain(cpu_model, cpu_params, p,
                                         r.tokens, dtype, tol,
                                         f"{tag} request {i}")
            log(f"{tag}: request {i} (prompt {len(p)}) greedy vs the plain "
                f"step over {dtype} pools (CPU): {verdict}")
    own = np.random.RandomState(1)          # as in run_f32_phase
    host_ms_per_step(torch, server,
                     [own.randint(0, model.vocab_size, size=n).tolist()
                      for n in (17, 64, 200)], tag)
    profile_engine(torch, server.engine,
                   [rng.randint(0, model.vocab_size, size=n).tolist()
                    for n in (17, 64, 200)])
    return launches


def profile_spec(torch, engine, prompts):
    """Drive ``engine`` (idle, warmed) through ``prompts`` under
    ``torch.profiler`` with each draft round and each verify inside a
    ``record_function`` range (``spec.draft``, ``spec.verify``). Prints
    the profile (:func:`report_profile`); returns {"draft"|"verify"|
    "other": (device ms, dispatches)}: every device activity (kernels
    and copies) of the pass, by the range whose host interval holds its
    start (a dispatch ends in a synchronize, so its device work runs
    inside its range), and the steps."""
    import bisect
    from torch.profiler import ProfilerActivity, profile, record_function
    for attr, kind in (("_draft_dispatch", "draft"), ("_dispatch", "verify")):
        fn = getattr(engine, attr)

        def ranged(*a, _fn=fn, _kind=kind, **k):
            with record_function(f"spec.{_kind}"):
                return _fn(*a, **k)
        setattr(engine, attr, ranged)
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            steps, wall = drive_engine(torch, engine, prompts)
    finally:
        for attr in ("_draft_dispatch", "_dispatch"):
            engine.__dict__.pop(attr, None)
    report_profile(prof, wall, steps)
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end, e.name[5:])
                   for e in events if e.name in ("spec.draft", "spec.verify")
                   and not str(e.device_type).endswith("CUDA"))
    starts = [a for a, _, _ in spans]
    out = {"draft": [0.0, 0], "verify": [0.0, 0], "other": [0.0, 0]}
    for _, _, kind in spans:
        out[kind][1] += 1
    for e in events:
        if not str(e.device_type).endswith("CUDA") or is_range(e.name):
            continue
        t = e.time_range.start
        i = bisect.bisect_right(starts, t) - 1
        kind = spans[i][2] if i >= 0 and t <= spans[i][1] else "other"
        out[kind][0] += (e.time_range.end - t) / 1e3
    return {k: tuple(v) for k, v in out.items()}, steps


def spec_server(torch, model, params, draft, dparams, tag, **kw):
    """``LLMServer`` with ``draft`` as its draft model at ``SPEC_K``,
    warmed (:func:`warm_server`); the graphs of both ladders are checked
    (16 rungs each at these widths). Returns (server, compile count,
    programs(), the ``decode_flat`` call counter)."""
    from mxnet_tpu_torch.serving.llm import LLMServer
    server = LLMServer(model, params, name=f"gpt2-{tag}",
                       max_seqs=MAX_SEQS, block_size=BLOCK_SIZE,
                       draft_model=draft, draft_params=dparams,
                       spec_k=SPEC_K, device=DEVICE, **kw)
    builds, progs, calls = warm_server(torch, server, tag)
    check(progs["graphs"] == 32 and progs["draft_graphs"] == 16,
          f"{tag}: {progs['graphs']} graphs ({progs['draft_graphs']} of "
          f"the draft) after warmup, expected 32 (16)")
    return server, builds, progs, calls


def spec_served(torch, kernels, server, prompts, sampled_idx, late=None):
    """Serve ``prompts`` (:func:`serve`) and shut the server down;
    returns (results, wall, launches, stats, verify dispatches, draft
    dispatches)."""
    before = server.engine.programs()
    server.start()
    kernels.reset_launch_counts()
    res, wall = serve(torch, server, prompts, sampled_idx, late=late)
    launches = kernels.launch_counts()
    server.shutdown()
    after = server.engine.programs()
    return (res, wall, launches, server.stats(),
            verify_dispatches(server.engine, before),
            after["draft_dispatches"] - before["draft_dispatches"])


def spec_line(tag, res, wall, st, verifies, drafts):
    n_tok = sum(len(r.tokens) for r in res)
    log(f"{tag}: served {len(res)} requests, {n_tok} tokens in {wall:.3f}s"
        f" = {n_tok / wall:.1f} tokens/s (end to end); TTFT p50 "
        f"{ttft_ms(res):.2f} ms; spec_k {st['spec_k']}, proposed "
        f"{st['spec_proposed']}, accepted {st['spec_accepted']} (rate "
        f"{st['spec_accept_rate']:.4f}), degraded {st['spec_degraded']}; "
        f"{verifies} verify dispatches ({verifies / n_tok:.3f} per "
        f"committed token), {drafts} draft rounds; prefix hits "
        f"{st['prefix_hits']}, COW copies {st['kv_cache']['cow_copies']}; "
        f"weights {st['weight_dtype']}, draft {st['draft_weight_dtype']}")
    check(st["spec_degraded"] == 0, f"{tag}: {st['spec_degraded']} steps "
          "degraded to plain decode")
    check(all(len(r.tokens) == NEW_TOKENS for r in res),
          f"{tag}: a request stopped short")
    return n_tok


def run_spec_phase(torch, rng, np_params, kernels, f32):
    """Speculative decoding at GPT-2-small widths (the reference serving
    bench's knobs: ``spec_k`` 2, the draft the target truncated to 6
    layers sharing its parameters):

    (a) ``LLMServer`` over f32 pools on the f32 phase's traffic (``f32``:
    its summary): greedy streams against ``greedy_decode_reference``,
    32 graphs, every dispatch (verify or draft round) one replay,
    nothing built or captured after warmup, no degraded step; the
    idle engine's host ms per step and a profiled pass with each draft
    round's and verify's device ms; the f32 phase's numbers beside;
    (b) the target as its own draft on 3 requests: proposals accepted
    and fewer verify dispatches than committed tokens;
    (c) fp8 weights for target and draft over f32 pools on 3 requests:
    streams against the port's plain step on the CPU with the same
    weights (:func:`check_greedy_plain`).
    Returns the launch counts of the served traffic."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.ops.quantization import kernel_name as wq_name
    from mxnet_tpu_torch.serving.llm import TinyDecoder, quantize_weights
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    draft = TinyDecoder(device=DEVICE,
                        **dict(GPT2_SMALL, num_layers=DRAFT_LAYERS))
    params = params_from_numpy(np_params, DEVICE)
    dparams = dict(params, layers=params["layers"][:DRAFT_LAYERS])
    # (a)
    tag = "spec"
    server, builds, progs, calls = spec_server(torch, model, params, draft,
                                               dparams, tag)
    prompts, shared = f32["prompts"], f32["shared"]
    res, wall, launches, st, verifies, drafts = spec_served(
        torch, kernels, server, prompts, (1, 5), late=(3, shared))
    add(launches)
    n_tok = spec_line(tag, res, wall, st, verifies, drafts)
    log(f"{tag}: launches {launches}")
    check_graph_steps(tag, server.engine, progs, calls, builds)
    check(launches.get("flat_attention", 0) > 0,
          f"{tag}: the flat attention kernel never ran")
    check(st["prefix_hits"] >= 1 and st["kv_cache"]["cow_copies"] >= 1,
          f"{tag}: the prefix cache / copy-on-write path was not taken")
    all_prompts = prompts + [shared]
    for i in [i for i in range(len(res)) if i not in (1, 5)]:
        verdict = check_greedy(model, params, all_prompts[i], res[i].tokens,
                               F32_LOGIT_TOL, f"{tag} request {i}")
        log(f"{tag}: request {i} (prompt {len(all_prompts[i])}) greedy vs "
            f"oracle: {verdict}")
    host_ms = host_ms_per_step(torch, server, prompts_for(
        np.random.RandomState(1), model.vocab_size)[0], tag)
    dev, steps = profile_spec(torch, server.engine, prompts_for(
        np.random.RandomState(2), model.vocab_size)[0])
    busy = sum(ms for ms, _ in dev.values())
    if busy == 0:
        log(f"{tag}: draft and verify device ms: not measured (the "
            f"profiler saw no device time)")
    for kind, (ms, n) in dev.items():
        if busy and kind != "other":
            log(f"{tag}: {kind}: {n} dispatches in {steps} steps, device "
                f"{ms:.2f} ms by the profiler ({ms / max(n, 1):.3f} ms a "
                f"dispatch, {ms / steps:.3f} ms a step; {ms / busy:.3f} of "
                f"the pass's device time)")
    if busy:
        log(f"{tag}: device time outside the dispatches "
            f"{dev['other'][0]:.2f} ms")
    log(f"{tag}: beside the f32 phase on the same traffic: tokens/s "
        f"{n_tok / wall:.1f} vs {f32['tokens_s']:.1f}; TTFT p50 "
        f"{ttft_ms(res):.2f} vs {f32['ttft_p50']:.2f} ms; host "
        f"ms/step {host_ms:.2f} vs {f32['host_ms']:.2f}; verify dispatches "
        f"per committed token {verifies / n_tok:.3f} vs "
        f"{f32['per_token']:.3f}")
    del server
    # (b) self-draft
    tag = "spec self-draft"
    server, builds, progs, calls = spec_server(torch, model, params, model,
                                               params, "spec-self")
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in (17, 64, 200)]
    res, wall, launches, st, verifies, drafts = spec_served(
        torch, kernels, server, prompts, ())
    add(launches)
    n_tok = spec_line(tag, res, wall, st, verifies, drafts)
    check_graph_steps(tag, server.engine, progs, calls, builds)
    check(st["spec_accepted"] > 0, f"{tag}: no proposal accepted")
    check(n_tok > verifies, f"{tag}: {verifies} verify dispatches for "
          f"{n_tok} committed tokens")
    verdicts = [check_greedy(model, params, p, r.tokens, F32_LOGIT_TOL,
                             f"{tag} request {i}")
                for i, (p, r) in enumerate(zip(prompts, res))]
    log(f"{tag}: greedy vs oracle: {', '.join(verdicts)}")
    del server
    # (c) fp8 weights for target and draft, f32 pools
    tag = "spec fp8"
    fp8 = "float8_e4m3fn"
    np_draft = dict(np_params, layers=np_params["layers"][:DRAFT_LAYERS])
    server, builds, progs, calls = spec_server(
        torch, model, np_params, draft, np_draft, "spec-fp8",
        weight_dtype=fp8, draft_weight_dtype=fp8)
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in (17, 64, 200)]
    res, wall, launches, st, verifies, drafts = spec_served(
        torch, kernels, server, prompts, ())
    add(launches)
    spec_line(tag, res, wall, st, verifies, drafts)
    check_graph_steps(tag, server.engine, progs, calls, builds)
    check(st["weight_dtype"] == st["draft_weight_dtype"] == fp8,
          f"{tag}: weights {st['weight_dtype']}, draft "
          f"{st['draft_weight_dtype']}")
    check(launches.get(wq_name(torch.float8_e4m3fn), 0) > 0,
          f"{tag}: the quantized matmul never ran")
    cpu_model = TinyDecoder(device="cpu", **GPT2_SMALL)
    qw = quantize_weights(np_params, dtype=fp8)
    for i, (p, r) in enumerate(zip(prompts, res)):
        verdict = check_greedy_plain(
            cpu_model, qw.params, p, r.tokens, "float32",
            QUANT_LOGIT_TOL[fp8], f"{tag} request {i}", w_scales=qw.scales)
        log(f"{tag}: request {i} (prompt {len(p)}) greedy vs the plain step "
            f"with the same fp8 weights (CPU): {verdict}")
    return counts


# multi-LoRA (phase 5d): the bank's geometry and its seeded adapters,
# (name, rank, alpha, seed): one of rank 4 (one page of rank 4) and two of
# rank 8 (two pages); the f32 traffic's 8 requests and the late prefix
# hit under these adapters (None: the base model)
LORA_BANK = dict(max_adapters=4, page_rank=4, max_pages_per_adapter=2)
LORA_ADAPTERS = (("ada", 4, None, 31), ("bob", 8, 4.0, 32),
                 ("cal", 8, None, 33))
LORA_TRAFFIC = ("ada", "bob", None, "cal", "bob", None, "cal", "ada", "cal")
LORA_SCALE = 0.08


def lora_factors(seed, rank, cfg=None):
    """Seeded LoRA factors ``[L, 4, d, rank]``, ``[L, 4, rank, d]`` for
    ``cfg`` (GPT-2-small widths by default)."""
    cfg = cfg or GPT2_SMALL
    r = np.random.RandomState(seed)
    L, d = cfg["num_layers"], cfg["d_model"]
    return ((r.randn(L, 4, d, rank) * LORA_SCALE).astype(np.float32),
            (r.randn(L, 4, rank, d) * LORA_SCALE).astype(np.float32))


def lora_bank(device, adapters=LORA_ADAPTERS, cfg=None):
    """An ``AdapterBank`` of ``LORA_BANK``'s geometry on ``device`` with
    ``adapters`` published."""
    from mxnet_tpu_torch.serving.adapters import AdapterBank
    cfg = cfg or GPT2_SMALL
    bank = AdapterBank(cfg["num_layers"], cfg["d_model"], device=device,
                       **LORA_BANK)
    for name, rank, alpha, seed in adapters:
        bank.publish(name, *lora_factors(seed, rank, cfg), alpha=alpha)
    return bank


def adapter_rows(torch, bank, names):
    """Pin ``names`` (one a table row, None: the base model) in ``bank``:
    returns the step's ``adapter=`` argument (the bank, each row's page
    table ``[MAX_SEQS, P]`` and scale) and the handles to release."""
    handles = [None if n is None else bank.acquire(n) for n in names]
    tables = np.zeros((MAX_SEQS, bank.max_pages_per_adapter), np.int32)
    scales = np.zeros(MAX_SEQS, np.float32)
    for i, h in enumerate(handles):
        if h is not None:
            tables[i], scales[i] = h.pages_padded, h.scale
    return ((bank, torch.from_numpy(tables).to(bank.device),
             torch.from_numpy(scales).to(bank.device)),
            [h for h in handles if h is not None])


def serve_lora(torch, server, prompts, adapters):
    """Submit every prompt under its adapter at once (greedy); returns
    (results, wall seconds, the sequences)."""
    t0 = time.monotonic()
    futs = [server.submit(p, NEW_TOKENS, adapter=a)
            for p, a in zip(prompts, adapters)]
    res = [f.result(timeout=600) for f in futs]
    torch.cuda.synchronize()
    return res, time.monotonic() - t0, [f._mxt_seq for f in futs]


def run_lora_phase(torch, rng, np_params, kernels, f32):
    """Multi-LoRA serving at GPT-2-small widths through ``LLMServer(...,
    adapter_bank=)`` and ``submit(adapter=)``:

    (a) f32 pools, a bank of ``LORA_BANK``'s geometry with the three
    ``LORA_ADAPTERS``: the f32 phase's 8 requests and its late prefix
    hit (``f32``: its summary) under ``LORA_TRAFFIC`` (two base-model
    rows), greedy, every stream held against ``greedy_decode_reference(
    lora=bank.adapter_arrays(name))`` on the card; 16 graphs, every
    dispatch one replay, nothing built or captured after warmup;
    (b) churn between waves (evict a cold adapter, republish a live one,
    publish a new one): ``compiles`` and the graphs do not move; then a
    wave whose repeat under the same adapter hits the prefix cache and
    whose same prompt under another adapter or the base model does not;
    the idle engine's host ms per step and a profiled pass on the f32
    traffic under adapters, beside the f32 phase's numbers, and the
    bank's bytes;
    (c) int8 KV and int8 weights under adapters on 3 requests, and one
    mixed packed step under adapters against the same step on the CPU
    (every kernel's plain version, the same weights, a CPU bank of the
    same factors), as ``run_quant_phase`` holds int8 serving;
    (d) speculative decoding under adapters on 3 requests (``spec_k``
    2, the 6-layer base draft): streams against the oracle.
    Returns the launch counts of the served traffic."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.ops.quantization import kernel_name as wq_name
    from mxnet_tpu_torch.ops.ragged_attention import kernel_name
    from mxnet_tpu_torch.serving.llm import (LLMServer, TinyDecoder,
                                             greedy_decode_reference,
                                             quantize_weights)
    from mxnet_tpu_torch.serving.telemetry import compile_count
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    params = params_from_numpy(np_params, DEVICE)
    # (a)
    tag = "lora"
    bank = lora_bank(DEVICE)
    server = LLMServer(model, params, name="gpt2-lora", max_seqs=MAX_SEQS,
                       block_size=BLOCK_SIZE, adapter_bank=bank,
                       device=DEVICE)
    builds, progs, calls = warm_server(torch, server, tag)
    check(progs["graphs"] == 16, f"{tag}: {progs['graphs']} graphs")
    log(f"{tag}: bank of {bank.num_pages} pages of rank {bank.page_rank} "
        f"({bank.max_adapters} adapters x {bank.max_pages_per_adapter} "
        f"pages + the null page): {bank.nbytes() / 1e6:.1f} MB on the "
        f"device; adapters {[(n, r) for n, r, _, _ in LORA_ADAPTERS]}")
    prompts = f32["prompts"] + [f32["shared"]]
    adapters = list(LORA_TRAFFIC)
    # the oracles of wave 1 read the factors it was served with: before
    # the churn below replaces any of them
    arrays = {n: bank.adapter_arrays(n) for n in bank.names()}
    server.start()
    kernels.reset_launch_counts()
    res, wall, seqs = serve_lora(torch, server, prompts, adapters)
    launches = kernels.launch_counts()
    st = server.stats()
    ttft = ttft_ms(res)
    n_tok = sum(len(r.tokens) for r in res)
    log(f"{tag}: served {len(res)} requests under adapters "
        f"{adapters}, {n_tok} tokens in {wall:.3f}s = {n_tok / wall:.1f} "
        f"tokens/s (end to end); TTFT p50 {ttft_ms(res):.2f} ms; "
        f"prefix hits {st['prefix_hits']}; adapter requests "
        f"{st['adapter_requests']}; bank {st['adapters']}")
    log(f"{tag}: launches {launches}")
    check(all(len(r.tokens) == NEW_TOKENS for r in res),
          f"{tag}: a request stopped short")
    check(launches.get("flat_attention", 0) > 0,
          f"{tag}: the flat attention kernel never ran")
    check(seqs[-1].cache_hit_tokens > 0, f"{tag}: the late request under "
          f"{adapters[-1]!r} did not hit its adapter's prefix")
    for i, (p, r, a) in enumerate(zip(prompts, res, adapters)):
        verdict = check_greedy(model, params, p, r.tokens, F32_LOGIT_TOL,
                               f"{tag} request {i} ({a})",
                               lora=None if a is None else arrays[a])
        log(f"{tag}: request {i} (prompt {len(p)}, adapter {a}) greedy vs "
            f"oracle: {verdict}")
    base, base_logits = greedy_decode_reference(
        model, params, prompts[0], NEW_TOKENS, return_logits=True)
    _, ada_logits = greedy_decode_reference(
        model, params, prompts[0], 1, return_logits=True, lora=arrays["ada"])
    moved = float((ada_logits[0] - base_logits[0]).abs().max())
    log(f"{tag}: request 0 under 'ada' vs the base model: first logits "
        f"{moved:.3e} apart at most, "
        f"{sum(a != b for a, b in zip(res[0].tokens, base))} of "
        f"{NEW_TOKENS} tokens differ")
    check(moved > 1e-2, f"{tag}: the adapter moved the logits by {moved}")
    # (b) churn, then the namespaced prefix cache
    graphs = server.engine.programs()["graphs"]
    bank.evict("cal")
    v_ada = bank.publish("ada", *lora_factors(41, 4))
    bank.publish("dan", *lora_factors(42, 4))
    check(compile_count() == builds and
          server.engine.programs()["graphs"] == graphs,
          f"{tag}: adapter churn built or captured something")
    log(f"{tag}: churn: evicted 'cal', republished 'ada' (v{v_ada}), "
        f"published 'dan'; bank {bank.stats()}; builds + captures "
        f"{compile_count() - builds}, graphs {graphs}")
    wave = [(prompts[4], "bob"), (prompts[4], "dan"), (prompts[4], None),
            (prompts[5], "ada")]
    res2, _, seqs2 = serve_lora(torch, server, [p for p, _ in wave],
                                [a for _, a in wave])
    hits = [q.cache_hit_tokens for q in seqs2]
    log(f"{tag}: wave 2 {[(len(p), a) for p, a in wave]}: prefix hit "
        f"tokens {hits} (a repeat under 'bob' hits; 'dan', the base model "
        f"and 'ada' v{v_ada} do not)")
    check(hits[0] > 0 and hits[1:] == [0, 0, 0],
          f"{tag}: the prefix cache is not namespaced by adapter: {hits}")
    for (p, a), r in zip(wave, res2):
        verdict = check_greedy(model, params, p, r.tokens, F32_LOGIT_TOL,
                               f"{tag} wave 2 ({a})", lora=None if a is None
                               else bank.adapter_arrays(a))
        log(f"{tag}: wave 2 (prompt {len(p)}, adapter {a}) greedy vs "
            f"oracle: {verdict}")
    server.shutdown()
    add(kernels.launch_counts())     # both waves
    check_graph_steps(tag, server.engine, progs, calls, builds)
    st = server.stats()
    check(st["adapters"]["in_use"] == 0 and bank.check(),
          f"{tag}: the bank did not drain: {st['adapters']}")
    # where the time goes, beside the f32 phase's
    names = ["ada", "bob", None, "dan", "bob", None, "dan", "ada"]
    traffic = prompts_for(np.random.RandomState(1), model.vocab_size)[0]
    host_ms = host_ms_per_step(torch, server, traffic, tag, names)
    share = profile_engine(torch, server.engine, prompts_for(
        np.random.RandomState(2), model.vocab_size)[0], names)
    mine, theirs = dict(PROFILED), f32.get("profiled") or {}

    def dev(p):
        if not p:
            return "not measured"
        return (f"{p['busy_ms'] / p['steps']:.3f} device ms a step, idle "
                f"{1 - p['busy_ms'] / (p['wall'] * 1e3):.3f}")
    log(f"{tag}: beside the f32 phase on the same traffic: tokens/s "
        f"{n_tok / wall:.1f} vs {f32['tokens_s']:.1f}; TTFT p50 "
        f"{ttft:.2f} vs {f32['ttft_p50']:.2f} ms; host "
        f"ms/step {host_ms:.2f} vs {f32['host_ms']:.2f}; profiled: "
        f"{dev(mine)} vs {dev(theirs)}; bank {bank.nbytes() / 1e6:.1f} MB")
    del server, share, mine, theirs
    # (c) int8 KV + int8 weights under adapters
    tag = "lora int8"
    server = LLMServer(model, np_params, name="gpt2-lora-int8",
                       max_seqs=MAX_SEQS, block_size=BLOCK_SIZE,
                       adapter_bank=bank, kv_dtype="int8",
                       weight_dtype="int8", device=DEVICE)
    builds, progs, calls = warm_server(torch, server, tag)
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in (17, 64, 200)]
    adapters = ["bob", None, "dan"]
    server.start()
    kernels.reset_launch_counts()
    res, wall, _ = serve_lora(torch, server, prompts, adapters)
    launches = kernels.launch_counts()
    server.shutdown()
    add(launches)
    log(f"{tag}: served {len(res)} requests under {adapters}, "
        f"{sum(len(r.tokens) for r in res)} tokens in {wall:.3f}s; "
        f"launches {launches}")
    check_graph_steps(tag, server.engine, progs, calls, builds)
    check(launches.get(kernel_name(torch.int8), 0) > 0
          and launches.get(wq_name(torch.int8), 0) > 0,
          f"{tag}: the int8 flat attention or matmul kernel never ran")
    check(all(len(r.tokens) == NEW_TOKENS and
              all(0 <= t < model.vocab_size for t in r.tokens) for r in res),
          f"{tag}: a stream stopped short or left the vocabulary")
    # the same prompts through a bank-less int8 server: its streams must
    # be the base row's bit for bit
    plain_server = LLMServer(model, np_params, name="gpt2-int8-nobank",
                             max_seqs=MAX_SEQS, block_size=BLOCK_SIZE,
                             kv_dtype="int8", weight_dtype="int8",
                             device=DEVICE)
    plain_server.start()
    res0, _, _ = serve_lora(torch, plain_server, prompts, [None] * 3)
    plain_server.shutdown()
    check(res[1].tokens == res0[1].tokens, f"{tag}: the base row's "
          f"stream differs from a bank-less engine's")
    # every stream, with and without the bank, against the plain step
    # over int8 pools on the CPU (every kernel's plain version) with the
    # same weights and, under an adapter, the same factors in a CPU bank
    cpu_model = TinyDecoder(device="cpu", **GPT2_SMALL)
    cpu_bank = lora_bank("cpu", (("bob", 8, 4.0, 32), ("dan", 4, None,
                                                       42)))
    qw = quantize_weights(np_params, dtype="int8")
    for i, (p, a) in enumerate(zip(prompts, adapters)):
        for r, ad, what in ((res[i], a, f"under {a}"),
                            (res0[i], None, "without a bank")):
            verdict = check_greedy_plain(
                cpu_model, qw.params, p, r.tokens, "int8",
                QUANT_LOGIT_TOL["int8"], f"{tag} request {i} {what}",
                w_scales=qw.scales,
                adapter=None if ad is None else (cpu_bank, ad))
            log(f"{tag}: request {i} (prompt {len(p)}) {what}: greedy vs "
                f"the plain step over int8 pools (CPU): {verdict}")
    del plain_server, res0
    # as run_quant_phase holds int8 serving: one mixed packed step under
    # adapters (rows of 'bob', the base model, 'dan'), the kernels
    # against their plain versions on the CPU with the same weights and
    # factors
    batch, _ = mixed_batch(model, rng, DEVICE)
    ad, pins = adapter_rows(torch, bank, adapters)
    cpu_ad, cpu_pins = adapter_rows(torch, cpu_bank, adapters)
    got = step_logits(model, server.engine.params, batch, "int8",
                      server.engine.w_scales, adapter=ad)
    want = step_logits(cpu_model, qw.params,
                       {k: v.cpu() for k, v in batch.items()}, "int8",
                       qw.scales, adapter=cpu_ad)
    for b, hs in ((bank, pins), (cpu_bank, cpu_pins)):
        for h in hs:
            b.release(h)
    n = int(batch["valid"].sum())
    err = float((got[:n].cpu() - want[:n]).abs().max())
    log(f"{tag}: decode_flat kernel path vs plain path (CPU) on a mixed "
        f"packed batch under {adapters}: max_abs_err={err:.3e} (tol "
        f"{QUANT_LOGIT_TOL['int8']})")
    check(bool(torch.isfinite(got[:n]).all()) and
          err <= QUANT_LOGIT_TOL["int8"],
          f"{tag}: kernel path disagrees with the plain path")
    del server, cpu_model, cpu_bank, qw
    # (d) speculative decoding under adapters: the base draft proposes
    tag = "lora spec"
    draft = TinyDecoder(device=DEVICE,
                        **dict(GPT2_SMALL, num_layers=DRAFT_LAYERS))
    dparams = dict(params, layers=params["layers"][:DRAFT_LAYERS])
    server, builds, progs, calls = spec_server(
        torch, model, params, draft, dparams, "lora-spec",
        adapter_bank=bank)
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in (17, 64, 200)]
    adapters = ["ada", "bob", None]
    server.start()
    kernels.reset_launch_counts()
    res, wall, _ = serve_lora(torch, server, prompts, adapters)
    launches = kernels.launch_counts()
    server.shutdown()
    add(launches)
    st = server.stats()
    log(f"{tag}: served {len(res)} requests under {adapters}, "
        f"{sum(len(r.tokens) for r in res)} tokens in {wall:.3f}s; "
        f"proposed {st['spec_proposed']}, accepted {st['spec_accepted']}, "
        f"degraded {st['spec_degraded']}")
    check_graph_steps(tag, server.engine, progs, calls, builds)
    check(st["spec_proposed"] > 0 and st["spec_degraded"] == 0,
          f"{tag}: no proposal made, or a step degraded")
    for i, (p, r, a) in enumerate(zip(prompts, res, adapters)):
        verdict = check_greedy(model, params, p, r.tokens, F32_LOGIT_TOL,
                               f"{tag} request {i}", lora=None if a is None
                               else bank.adapter_arrays(a))
        log(f"{tag}: request {i} (prompt {len(p)}, adapter {a}) greedy vs "
            f"oracle: {verdict}")
    check(bank.stats()["in_use"] == 0 and bank.check(),
          f"{tag}: the bank did not drain")
    return counts


# ------------------------------------------ chaos and observability --
CHAOS_PROMPTS = (5, 9, 12, 15)      # under a block: no prefix hit


def submit_together(server, prompts, n=NEW_TOKENS):
    """Submit ``prompts`` (greedy, ``n`` tokens each) so the worker takes
    them in one pull: the server's admission lock is held (re-entrantly)
    across the submits, so every run of the same prompts admits them in
    one step and packs the same rows each step. Returns the Futures."""
    with server._cv:
        return [server.submit(p, n) for p in prompts]


def outcomes(futs, timeout=600):
    """(results, errors) of ``futs``: every Future resolves."""
    res, errs = [], []
    for f in futs:
        try:
            res.append(f.result(timeout=timeout))
        except BaseException as exc:       # a typed resolution
            errs.append(exc)
    return res, errs


def check_pool_clean(tag, engine):
    a = engine.cache.allocator
    check(a.num_used == 0 and engine.cache.check(live_block_ids=[]),
          f"{tag}: the pool is not clean ({a.num_used} blocks in use)")


def wait_stopped(server):
    deadline = time.monotonic() + 60
    while server.running and time.monotonic() < deadline:
        time.sleep(0.01)
    return not server.running


def load_tool(name):
    """``tools/<name>.py`` of the checkout, loaded by path (the tools
    read bundles and expositions with the standard library only)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"{name}_smoke", os.path.join(HERE, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_chaos_phase(torch, rng, np_params, kernels, f32):
    """The fault switchboard, the tracer and the flight recorder on the
    captured serving step: ``LLMServer`` over f32 pools at GPT-2-small
    widths (``f32``: the f32 phase's summary), after ``warmup()``.

    (a) one scripted ``llm.decode`` raise mid-stream on
    ``CHAOS_PROMPTS``: the greedy streams are bit-identical to the same
    prompts' streams without a fault (the bisect re-dispatches each half
    through its rung's graph); (b) three scripted raises while two rows
    share the pack (the top dispatch, the first half, its leaf retry),
    parked first on a ``block_at`` gate: exactly one row fails with the
    original exception, the other finishes bit-identical, ``poison_isolated`` 1, the pool clean; every dispatch
    of (a), (b) and (e)'s serving one replay, nothing built or captured;
    (c) ``crash_at_point("llm.worker", nth=2)`` on a second server: every
    Future resolves typed, the pool is clean, a later ``submit`` raises
    ``ServerClosed``; (d) a ``PreemptionGuard`` on SIGUSR1 with
    ``attach_preemption_guard(deadline_ms=0)`` and 20 ms injected into
    each decode on a third: every Future resolves served or evicted, one
    eviction at least with partial tokens, the pool clean; (e) the f32
    phase's traffic shape (fresh prompts a pass) with the tracer and the
    recorder off, on, on, off: tokens/s through the server, then host ms
    per step through the idle engine; the chrome trace validated, a
    flight bundle that ``tools/flight_inspect.py`` checks with every
    request's timeline and a TTFT exemplar joined back to a request,
    ``debug_status()`` JSON-serialisable, and a profiled pass whose
    trace holds ``mxtpu.llm.step`` ranges. Returns the launch counts of
    the served traffic."""
    import shutil
    import signal
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.observability import (
        get_flightrecorder, get_registry, get_tracer, validate_chrome_trace)
    from mxnet_tpu_torch.observability.exemplars import collect
    from mxnet_tpu_torch.resilience import PreemptionGuard, faults
    from mxnet_tpu_torch.serving import SequenceEvictedError, ServerClosed
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    tag = "chaos"
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    params = params_from_numpy(np_params, DEVICE)
    tracer, fl = get_tracer(), get_flightrecorder()
    check(not tracer.enabled and not fl.enabled,
          f"{tag}: the tracer or the recorder is on before the phase")
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in CHAOS_PROMPTS]
    faults.reset()

    def server(name):
        return LLMServer(model, params, name=name, max_seqs=MAX_SEQS,
                         block_size=BLOCK_SIZE, device=DEVICE)
    srv = server("gpt2-chaos")
    builds, progs, calls = warm_server(torch, srv, tag)
    srv.start()
    kernels.reset_launch_counts()
    # (a) transient
    plain = [r.tokens for r in outcomes(submit_together(srv, prompts))[0]]
    faults.script("llm.decode", [None] * 3 + [RuntimeError("transient")])
    res, errs = outcomes(submit_together(srv, prompts))
    faults.reset()
    same = [r.tokens for r in res] == plain
    log(f"{tag}: (a) one llm.decode raise at the 4th decode dispatch of "
        f"{len(prompts)} requests: {len(res)} served, {len(errs)} failed; "
        f"streams bit-identical to the fault-free run: {same}")
    check(not errs and same and srv.stats()["poison_isolated"] == 0,
          f"{tag}: (a) a transient fault changed a stream or failed a row")
    # (b) persistent, two rows in the pack: the top dispatch, the first
    # half (one row) and its leaf retry raise; the survivor is held
    # against the same two prompts served without a fault (a pack of
    # other rows takes other rungs and plans)
    plain = [r.tokens for r in
             outcomes(submit_together(srv, prompts[:2]))[0]]
    gate = faults.block_at("llm.decode")
    futs = submit_together(srv, prompts[:2])
    check(gate.wait_reached(120), f"{tag}: (b) no decode reached the gate")
    faults.script("llm.decode", [RuntimeError("poison-decode")] * 3)
    gate.release()
    res, errs = [], []
    for i, f in enumerate(futs):
        try:
            res.append((i, f.result(timeout=600).tokens))
        except RuntimeError as exc:
            errs.append((i, exc))
    faults.reset()
    st = srv.stats()
    survivors = all(t == plain[i] for i, t in res)
    log(f"{tag}: (b) three llm.decode raises with 2 rows in "
        f"the pack: row(s) {[i for i, _ in errs]} failed with "
        f"{[repr(e) for _, e in errs]}, {len(res)} finished, bit-identical"
        f" to the fault-free run: {survivors}; poison_isolated "
        f"{st['poison_isolated']}")
    check(len(errs) == 1 and "poison-decode" in str(errs[0][1])
          and survivors and st["poison_isolated"] == 1,
          f"{tag}: (b) not exactly one row isolated with the original "
          "exception")
    check_pool_clean(f"{tag} (b)", srv.engine)
    # (e) observability on the f32 phase's traffic shape
    bundle_dir = tempfile.mkdtemp(prefix="chaos-flight-")
    passes = []
    for k, on in enumerate((False, True, True, False)):
        if on:
            tracer.enable()
            fl.enable(out_dir=bundle_dir)
        traffic, shared = prompts_for(np.random.RandomState(30 + k),
                                      model.vocab_size)
        out, wall = serve(torch, srv, traffic, sampled_idx=(1, 5),
                          late=(3, shared))
        n_tok = sum(len(r.tokens) for r in out)
        passes.append((on, n_tok / wall))
        log(f"{tag}: (e) tracer and recorder {'on' if on else 'off'}: "
            f"served {len(out)} requests, {n_tok} tokens in {wall:.3f}s = "
            f"{n_tok / wall:.1f} tokens/s (end to end)")
        tracer.disable()
        fl.disable()
    launches = kernels.launch_counts()
    status = srv.debug_status()
    json.dumps(status)
    check(status["engine"]["programs"]["warmed"]
          and status["engine"]["mesh"] is None,
          f"{tag}: debug_status {status['engine']['programs']}")
    srv.shutdown()
    check_graph_steps(tag, srv.engine, progs, calls, builds)
    spans = tracer.snapshot()
    names = [s["name"] for s in spans]
    n_events = validate_chrome_trace(tracer.to_chrome_trace())
    check(n_events == len(spans) and names.count("mxtpu.llm.request") == 18
          and "mxtpu.llm.step" in names,
          f"{tag}: the trace holds {names.count('mxtpu.llm.request')} "
          f"request spans and {names.count('mxtpu.llm.step')} step spans")
    events = fl.snapshot()
    timelines = {}
    for e in events:
        if e["req"]:
            timelines.setdefault(e["req"], set()).add(e["kind"])
    want = {"llm.submit", "llm.admit", "llm.prefill", "llm.served"}
    exm = collect(get_registry(), ("mxtpu_llm_ttft_seconds",))
    ttft_reqs = {e["req"] for row in exm.get("mxtpu_llm_ttft_seconds", [])
                 if row["labels"].get("server") == "gpt2-chaos"
                 for bkt in row["buckets"].values() for e in bkt}
    bundle = fl.dump(trigger="manual", reason="chip_smoke chaos phase")
    fi = load_tool("flight_inspect")
    problems = fi.check(bundle)
    req = sorted(ttft_reqs & set(timelines))[:1]
    view = fi.render_request(bundle, req[0]) if req else ""
    log(f"{tag}: (e) trace: {len(spans)} spans "
        f"({names.count('mxtpu.llm.step')} mxtpu.llm.step), chrome trace "
        f"valid; flight: {len(events)} "
        f"events over {len(timelines)} requests, bundle "
        f"{os.path.basename(bundle)} check {problems or 'clean'}; TTFT "
        f"exemplars name {len(ttft_reqs)} requests; statusz "
        f"{len(json.dumps(status))} bytes of JSON")
    check(len(timelines) == 18 and all(want <= k for k in
                                       timelines.values()),
          f"{tag}: a request's timeline lacks one of {sorted(want)}")
    check(not problems and req and "llm.served" in view,
          f"{tag}: the bundle does not check ({problems}) or no TTFT "
          "exemplar joins back to a request")
    fl.clear()
    tracer.clear()
    # (e) host ms per step through the idle engine (shutdown released
    # the graphs: captured once more, then every pass replays them)
    srv.engine.warmup()
    host = []
    for k, on in enumerate((False, True, True, False)):
        if on:
            tracer.enable()
            fl.enable(out_dir=bundle_dir)
        traffic = prompts_for(np.random.RandomState(40 + k),
                              model.vocab_size)[0]
        steps, wall = drive_engine(torch, srv.engine, traffic)
        host.append((on, wall / steps * 1e3))
        log(f"{tag}: (e) tracer and recorder {'on' if on else 'off'}: "
            f"{steps} steps in {wall:.3f}s without the profiler: host "
            f"{wall / steps * 1e3:.2f} ms/step")
        tracer.disable()
        fl.disable()
    tracer.clear()
    fl.clear()
    off = [v for on, v in host if not on]
    on_ = [v for on, v in host if on]
    tps_off = [v for on, v in passes if not on]
    tps_on = [v for on, v in passes if on]
    log(f"{tag}: (e) summary: host ms/step off {off[0]:.3f}/{off[1]:.3f}, "
        f"on {on_[0]:.3f}/{on_[1]:.3f}; tokens/s off "
        f"{tps_off[0]:.1f}/{tps_off[1]:.1f}, on {tps_on[0]:.1f}/"
        f"{tps_on[1]:.1f} (f32 phase: {f32['tokens_s']:.1f} tokens/s, "
        f"host {f32['host_ms']:.2f} ms/step)")
    tracer.enable()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        steps, wall = drive_engine(torch, srv.engine, prompts_for(
            np.random.RandomState(44), model.vocab_size)[0])
    tracer.disable()
    tracer.clear()
    ranges = [e for e in prof.key_averages() if e.key == "mxtpu.llm.step"]
    log(f"{tag}: (e) profiled pass, tracer on: {steps} steps, "
        f"mxtpu.llm.step ranges {ranges[0].count if ranges else 0}")
    check(ranges and ranges[0].count == steps,
          f"{tag}: the profiler's trace lacks the mxtpu.llm.step ranges")
    srv.engine.release_graphs()
    del srv
    torch.cuda.empty_cache()
    shutil.rmtree(bundle_dir)
    # (c) worker death
    srv = server("gpt2-chaos-death")
    srv.warmup()
    srv.start()
    faults.crash_at_point("llm.worker", nth=2)
    res, errs = outcomes(submit_together(srv, prompts))
    faults.reset()
    stopped = wait_stopped(srv)
    try:
        srv.submit(prompts[0], 1)
        closed = False
    except ServerClosed:
        closed = True
    log(f"{tag}: (c) crash at the 2nd llm.worker point: {len(res)} served,"
        f" {len(errs)} failed {sorted({type(e).__name__ for e in errs})}; "
        f"worker stopped {stopped}; a later submit raises ServerClosed "
        f"{closed}")
    check(len(res) + len(errs) == len(prompts) and stopped and closed
          and all(isinstance(e, ServerClosed) for e in errs),
          f"{tag}: (c) worker death left a Future or the server open")
    check_pool_clean(f"{tag} (c)", srv.engine)
    srv.shutdown()
    del srv
    # (d) preemption mid-drain under injected latency
    srv = server("gpt2-chaos-preempt")
    srv.warmup()
    guard = PreemptionGuard(signals=(signal.SIGUSR1,)).install()
    try:
        srv.start()
        srv.attach_preemption_guard(guard, poll_s=0.01, deadline_ms=0.0)
        faults.delay_at("llm.decode", 0.02)
        futs = submit_together(srv, prompts, n=200)
        deadline = time.monotonic() + 60
        while (srv.stats()["tokens_generated"] < 2 * len(prompts)
               and time.monotonic() < deadline):
            time.sleep(0.005)
        os.kill(os.getpid(), signal.SIGUSR1)
        res, errs = outcomes(futs)
        stopped = wait_stopped(srv)
    finally:
        faults.reset()
        guard.uninstall()
    partial = [len(e.tokens) for e in errs
               if isinstance(e, SequenceEvictedError)]
    log(f"{tag}: (d) SIGUSR1 with 20 ms a decode: {len(res)} served, "
        f"{len(errs)} evicted with {partial} tokens; worker stopped "
        f"{stopped}")
    check(len(res) + len(errs) == len(prompts) and stopped and errs
          and len(partial) == len(errs) and any(partial),
          f"{tag}: (d) the preemption drain left a Future or evicted "
          "nothing with partial tokens")
    check_pool_clean(f"{tag} (d)", srv.engine)
    srv.shutdown()
    return launches


class GraphedStep:
    """``fn`` replayed from a CUDA graph over static device copies of
    its int32 inputs, captured at the first call: the caller's side of
    the reference's ``jax.jit`` of the model interface's pure steps. The
    first call's warm run and capture run ``fn`` on that call's inputs:
    ``decode_chunk``/``decode_step`` write the same K/V each time.
    Returns ``fn``'s first output (the logits, the graph's static
    output: read it before the next call)."""

    def __init__(self, torch, fn, device, stream, pool, what):
        self.torch, self.fn, self.device = torch, fn, device
        self.stream, self.pool, self.what = stream, pool, what
        self.graph = None

    def __call__(self, *arrays):
        from mxnet_tpu_torch import kernels
        torch = self.torch
        if self.graph is None:
            self.inputs = [torch.from_numpy(np.asarray(a, np.int32)).to(
                self.device) for a in arrays]
            self.out = [None]

            def body():
                self.out[0] = self.fn(*self.inputs)[0]
            self.graph = kernels.capture(body, self.stream, self.pool,
                                         what=self.what)
        else:
            for dst, a in zip(self.inputs, arrays):
                dst.copy_(torch.from_numpy(np.asarray(a, np.int32)))
        self.graph.replay()
        return self.out[0]


def paged_greedy(torch, model, params, prompts, new_steps, chunk=CHUNK_Q,
                 block_size=BLOCK_SIZE, on_first_step=None, graphs=False,
                 kv_dtype="float32"):
    """Greedy decoding of ``prompts`` through the model interface alone:
    the rows prefill together in chunks of ``chunk`` tokens through
    ``decode_chunk`` (a row whose prompt is done sits in the batch at
    q_len 0), the first token comes from each prompt's last chunk, then
    ``new_steps`` steps of ``decode_step`` each add one token per row.
    Pools (of ``kv_dtype``) and tables come from the port's
    ``PagedKVCache``. With
    ``graphs`` each step replays a CUDA graph (:class:`GraphedStep`) of
    ``decode_chunk`` at (rows, Q, table width) or of ``decode_step`` at
    (rows, table width), captured at its first step.
    ``on_first_step()`` runs after the first step. Returns (streams,
    last-chunk logits per row, prefill steps, seconds per decode step
    after the first (host clock; each ends in the tokens' copy to the
    host), cache, block tables, kv lens)."""
    from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache
    c, dev = model.config, model.device
    S = len(prompts)
    lens = [len(p) for p in prompts]
    need = [-(-(n + new_steps + 1) // block_size) for n in lens]
    cache = PagedKVCache(c.num_layers, c.num_heads, c.head_dim, block_size,
                         1 + sum(need), c.max_context, dtype=kv_dtype,
                         device=dev)
    tables = np.zeros((S, cache.max_blocks_per_seq), np.int32)
    for i, nb in enumerate(need):
        tables[i, :nb] = cache.allocator.alloc(nb)
    bt = torch.from_numpy(tables).to(dev)

    def t32(a):
        return torch.from_numpy(np.asarray(a, np.int32)).to(dev)

    def eager_chunk(toks, pos, ql, kv):
        return model.decode_chunk(params, t32(toks), t32(pos), t32(ql),
                                  cache.k_pages, cache.v_pages, bt,
                                  t32(kv))[0]

    def eager_step(toks, pos, kv):
        return model.decode_step(params, t32(toks), t32(pos), cache.k_pages,
                                 cache.v_pages, bt, t32(kv))[0]
    run_chunk, run_step = eager_chunk, eager_step
    if graphs:
        side = (torch.cuda.Stream(dev), torch.cuda.graph_pool_handle())
        run_chunk = GraphedStep(
            torch, lambda *a: model.decode_chunk(
                params, *a[:3], cache.k_pages, cache.v_pages, bt, a[3]),
            dev, *side, f"decode_chunk at S={S} Q={chunk}")
        run_step = GraphedStep(
            torch, lambda *a: model.decode_step(
                params, *a[:2], cache.k_pages, cache.v_pages, bt, a[2]),
            dev, *side, f"decode_step at S={S}")
    done, last = [0] * S, [None] * S
    steps = 0
    while min(d - n for d, n in zip(done, lens)) < 0:
        toks = np.zeros((S, chunk), np.int32)
        pos = np.zeros((S, chunk), np.int32)
        ql = np.zeros(S, np.int32)
        for i, p in enumerate(prompts):
            n = min(chunk, lens[i] - done[i])
            toks[i, :n] = p[done[i]:done[i] + n]
            pos[i, :n] = np.arange(done[i], done[i] + n)
            ql[i] = n
            done[i] += n
        logits = run_chunk(toks, pos, ql, done)
        for i in range(S):
            if ql[i] and done[i] == lens[i]:
                last[i] = logits[i, :ql[i]].clone()
        steps += 1
        if steps == 1 and on_first_step is not None:
            on_first_step()
    streams = [[int(torch.argmax(last[i][-1]))] for i in range(S)]
    t0 = None
    for k in range(new_steps):
        if k == 1:                  # after the step that captures
            t0 = time.monotonic()
        pos = [lens[i] + len(streams[i]) - 1 for i in range(S)]
        logits = run_step([s[-1] for s in streams], pos,
                          [p + 1 for p in pos])
        for i, t in enumerate(logits.argmax(-1).tolist()):
            streams[i].append(t)
    step_s = None if t0 is None else (
        (time.monotonic() - t0) / (new_steps - 1))
    kv = t32([lens[i] + len(streams[i]) - 1 for i in range(S)])
    return streams, last, steps, step_s, cache, bt, kv


def run_paged_decode_phase(torch, rng, np_params, kernels):
    """This slice's path at GPT-2-small widths: chunked prefill through
    ``decode_chunk`` and greedy decode through ``decode_step``, every
    stream against ``greedy_decode_reference``, each prompt's last chunk
    against the dense ``forward``, 12 chunk-kernel launches per step and
    no build after the first step; then the same decode with each step
    replayed from a CUDA graph: the same streams, ms per step beside the
    eager figure, 12 launches per step counted through the replays; then
    the same decode over bf16 pools from graphs (the bf16 chunk kernel,
    12 launches a step), each stream against the plain step on the CPU
    over bf16 pools. Returns (launches of the three passes, (the f32
    cache, tables, kv lens, model))."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.ops.ragged_attention import (CHUNK_KERNEL,
                                                      kernel_name)
    from mxnet_tpu_torch.serving.llm import TinyDecoder
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    params = params_from_numpy(np_params, model.device)
    prompts, _ = prompts_for(rng, model.vocab_size)
    builds = []
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    streams, last, pre_steps, step_s, cache, bt, kv = paged_greedy(
        torch, model, params, prompts, DECODE_STEPS,
        on_first_step=lambda: builds.append(kernels.build_count()))
    wall = time.monotonic() - t0
    launches = kernels.launch_counts()
    steps = pre_steps + DECODE_STEPS
    S = len(prompts)
    log(f"paged: {S} prompts ({min(map(len, prompts))}-"
        f"{max(map(len, prompts))} tokens) prefilled in {pre_steps} "
        f"decode_chunk steps of Q={CHUNK_Q}, then {DECODE_STEPS} "
        f"decode_step steps: {wall:.3f}s in all (host clock); decode "
        f"{step_s * 1e3:.2f} ms/step = {S / step_s:.1f} tokens/s (host "
        f"clock, 8 rows, steps 2-{DECODE_STEPS}); "
        f"launches {launches}; builds after the first step "
        f"{kernels.build_count() - builds[0]}")
    check(launches.get(CHUNK_KERNEL, 0) == GPT2_SMALL["num_layers"] * steps,
          f"paged: {CHUNK_KERNEL} launched {launches.get(CHUNK_KERNEL, 0)} "
          f"times in {steps} steps, expected 12 per step")
    check(kernels.build_count() == builds[0], "paged: a kernel was built "
          "after the first step")
    err = 0.0
    for i, p in enumerate(prompts):
        dense, _, _ = model.forward(params, torch.tensor([p], device=DEVICE))
        n = last[i].shape[0]
        check(bool(torch.isfinite(last[i]).all()),
              "paged: non-finite logits")
        err = max(err, float((last[i] - dense[0, len(p) - n:]).abs().max()))
        verdict = check_greedy(model, params, p, streams[i], F32_LOGIT_TOL,
                               f"paged row {i}")
        log(f"paged: row {i} (prompt {len(p)}) {len(streams[i])} greedy "
            f"tokens vs oracle: {verdict}")
    log(f"paged: last prefill chunk vs dense forward: max_abs_err="
        f"{err:.3e} (tol {F32_LOGIT_TOL})")
    check(err <= F32_LOGIT_TOL, "paged: decode_chunk disagrees with forward")
    # the same decode, each step one replay of a graph captured at its
    # first step (the caller's side of the reference's jit)
    kernels.reset_launch_counts()
    captures = kernels.capture_count()
    builds = kernels.build_count()
    g_streams, g_last, g_steps, g_step_s, _, _, _ = paged_greedy(
        torch, model, params, prompts, DECODE_STEPS, graphs=True)
    g_launches = kernels.launch_counts()
    g_steps += DECODE_STEPS
    warm = 2                    # one warm run before each capture
    log(f"paged: graphs (decode_chunk at S={S} Q={CHUNK_Q}, decode_step "
        f"at S={S}, table width {bt.shape[1]}): decode "
        f"{g_step_s * 1e3:.2f} ms/step = {S / g_step_s:.1f} tokens/s, "
        f"eager {step_s * 1e3:.2f} ms/step in this run (host clock, 8 "
        f"rows, steps 2-{DECODE_STEPS}); captures {kernels.capture_count() - captures}, "
        f"builds {kernels.build_count() - builds}; launches {g_launches}")
    check(g_streams == streams, "paged: the graphs' streams differ from "
          "the eager decode's")
    err = max(float((a - b).abs().max()) for a, b in zip(g_last, last))
    check(err <= F32_LOGIT_TOL, f"paged: the graphs' last-chunk logits "
          f"differ from the eager decode's by {err:.3e}")
    check(kernels.capture_count() - captures == 2
          and kernels.build_count() == builds,
          "paged: a build, or a capture beyond one per step kind")
    check(g_launches.get(CHUNK_KERNEL, 0)
          == GPT2_SMALL["num_layers"] * (g_steps + warm),
          f"paged: under graphs {CHUNK_KERNEL} launched "
          f"{g_launches.get(CHUNK_KERNEL, 0)} times in {g_steps} steps and "
          f"{warm} warm runs, expected 12 per step")
    for k, v in g_launches.items():
        launches[k] = launches.get(k, 0) + v
    # the same decode over bf16 pools, from graphs (the bf16 chunk
    # kernel), each stream held against the plain step on the CPU over
    # bf16 pools
    chunk16 = kernel_name(torch.bfloat16, "chunk")
    kernels.reset_launch_counts()
    captures = kernels.capture_count()
    b_streams, _, b_steps, b_step_s, b_cache, _, _ = paged_greedy(
        torch, model, params, prompts, DECODE_STEPS, graphs=True,
        kv_dtype="bfloat16")
    b_launches = kernels.launch_counts()
    b_steps += DECODE_STEPS
    log(f"paged bf16: graphs over bf16 pools ({b_cache.nbytes() / 1e9:.3f} "
        f"GB, f32 {cache.nbytes() / 1e9:.3f} GB): decode "
        f"{b_step_s * 1e3:.2f} ms/step = {S / b_step_s:.1f} tokens/s (f32 "
        f"graphs {g_step_s * 1e3:.2f} ms/step in this run; host clock, 8 "
        f"rows, steps 2-{DECODE_STEPS}); captures "
        f"{kernels.capture_count() - captures}; launches {b_launches}")
    check(b_cache.k_pages.dtype == torch.bfloat16, "paged bf16: pools of "
          f"{b_cache.k_pages.dtype}")
    check(kernels.capture_count() - captures == 2,
          "paged bf16: a capture beyond one per step kind")
    check(b_launches.get(chunk16, 0)
          == GPT2_SMALL["num_layers"] * (b_steps + warm),
          f"paged bf16: {chunk16} launched {b_launches.get(chunk16, 0)} "
          f"times in {b_steps} steps and {warm} warm runs, expected 12 per "
          f"step")
    cpu_model = TinyDecoder(device="cpu", **GPT2_SMALL)
    cpu_params = params_from_numpy(np_params, "cpu")
    for i, p in enumerate(prompts):
        verdict = check_greedy_plain(
            cpu_model, cpu_params, p, b_streams[i], "bfloat16",
            LP_LOGIT_TOL["bfloat16"], f"paged bf16 row {i}")
        log(f"paged bf16: row {i} (prompt {len(p)}) {len(b_streams[i])} "
            f"greedy tokens vs the plain step over bf16 pools (CPU): "
            f"{verdict}")
    for k, v in b_launches.items():
        launches[k] = launches.get(k, 0) + v
    return launches, (cache, bt, kv, model)


def run_op_phase(torch, timer, rng, decoded):
    """The op front end: ``nd.ragged_paged_attention`` with a 3-D and a
    4-D q on the decode phase's layer-0 pools (each against its plain
    twin, each moving its kernel's count by one),
    ``nd.scaled_dot_product_attention`` (one ``flash_fwd``), and the
    three ``rtc`` kernels through ``nd`` at 8192 x 8192 f32 against their
    plain versions, with ``square``'s gradient under ``record()``; and
    the input dtypes the TPU kernels take beyond q in the pages' own
    dtype (``op_dtype_mixes``). Returns (launches of those calls, kernel
    rows for the rtc kernels)."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import kernels, nd
    from mxnet_tpu_torch.ops import ragged_attention as ra
    cache, bt, kv, model = decoded
    c = model.config
    S, H, D = bt.shape[0], c.num_heads, c.head_dim
    kp, vp = cache.k_pages[0], cache.v_pages[0]
    q3 = torch.from_numpy(rng.randn(S, H, D).astype(np.float32)).to(DEVICE)
    q4 = torch.from_numpy(
        rng.randn(S, CHUNK_Q, H, D).astype(np.float32)).to(DEVICE)
    ql = torch.full((S,), CHUNK_Q, dtype=torch.int32, device=DEVICE)
    # the same pools, and q, in bf16 and f16: the 16-bit kernels
    lowp = {dt: (kp.to(dt), vp.to(dt), q3.to(dt), q4.to(dt))
            for dt in (torch.bfloat16, torch.float16)}
    sdpa_in = [torch.from_numpy(rng.randn(2, H, 128, D).astype(
        np.float32)).to(DEVICE) for _ in range(3)]
    names, plain = register_rtc_ops("rtc_")
    x, y = (torch.from_numpy(rng.randn(RTC_N, RTC_N).astype(
        np.float32)).to(DEVICE) for _ in range(2))
    # its own generator: the later phases draw what they drew before
    mixes = op_dtype_mixes(torch, np.random.RandomState(14), decoded, q3, q4,
                           ql)
    # the path: every call below once, counted
    kernels.reset_launch_counts()
    got3 = nd.ragged_paged_attention(q3, kp, vp, bt, kv)
    got4 = nd.ragged_paged_attention(q4, kp, vp, bt, kv, q_lens=ql)
    got16 = {dt: (nd.ragged_paged_attention(a3, k16, v16, bt, kv),
                  nd.ragged_paged_attention(a4, k16, v16, bt, kv, q_lens=ql))
             for dt, (k16, v16, a3, a4) in lowp.items()}
    got_mix = {k: call() for k, (call, _, _) in mixes.items()}
    got_sdpa = nd.scaled_dot_product_attention(*sdpa_in)
    got_rtc = {"scale_add": getattr(nd, names["scale_add"])(x, y),
               "rowsum": getattr(nd, names["rowsum"])(x)}
    xg = x.detach().clone().requires_grad_()
    with ag.record():
        sq = getattr(nd, names["square"])(xg)
        sq.sum().backward()
    got_rtc["square"] = sq.detach()
    torch.cuda.synchronize()
    launches = kernels.launch_counts()
    log(f"ops: launches {launches}")
    want_launches = {ra.DECODE_KERNEL: 1, ra.CHUNK_KERNEL: 1,
                     "flash_fwd": 1}
    for dt in lowp:
        for kind in ("decode", "chunk"):
            want_launches[ra.kernel_name(dt, kind)] = 1
    for _, _, kname in mixes.values():
        want_launches[kname] = want_launches.get(kname, 0) + 1
    for kname, n in want_launches.items():
        check(launches.get(kname, 0) == n, f"ops: {kname} launched "
              f"{launches.get(kname, 0)} times, expected {n}")
    for what, (_, twin, _) in mixes.items():
        got, want = got_mix[what], twin()
        check(got.dtype == want.dtype, f"ops: {what} gave {got.dtype}, "
              f"its twin {want.dtype}")
        err = float((got.float() - want.float()).abs().max())
        if what.startswith("quantized_matmul"):
            tol = WQ_REL_TOL * max(1.0, float(want.abs().max()))
        elif want.dtype == torch.float32:
            tol = ATT_TOL
        else:
            tol = float(torch.finfo(want.dtype).eps) * float(
                want.float().abs().max())
        log(f"ops: {what}: {got.dtype} out, max_abs_err={err:.3e} (tol "
            f"{tol:.3e})")
        check(err <= tol, f"ops: {what} disagrees with its plain twin")
    e3 = float((got3 - ra.ragged_attention_reference(
        q3, kp, vp, bt, kv)).abs().max())
    e4 = float((got4 - ra.ragged_chunk_attention_reference(
        q4, kp, vp, bt, kv, ql)).abs().max())
    from mxnet_tpu_torch.ops.flash_attention import attention_reference
    es = float((got_sdpa - attention_reference(*sdpa_in)).abs().max())
    log(f"ops: nd.ragged_paged_attention 3-D q max_abs_err={e3:.3e}, 4-D q "
        f"{e4:.3e} (tol {ATT_TOL}); nd.scaled_dot_product_attention "
        f"{es:.3e} (relative tol {FLASH_REL_TOL})")
    check(max(e3, e4) <= ATT_TOL, "ops: nd.ragged_paged_attention "
          "disagrees with its plain twin")
    for dt, (k16, v16, a3, a4) in lowp.items():
        g3, g4 = got16[dt]
        w3 = ra.ragged_attention_reference(a3, k16, v16, bt, kv)
        w4 = ra.ragged_chunk_attention_reference(a4, k16, v16, bt, kv, ql)
        check(g3.dtype == g4.dtype == dt, f"ops: {dt} q gave "
              f"{g3.dtype}/{g4.dtype} out")
        for what, g, w in (("3-D", g3, w3), ("4-D", g4, w4)):
            err = float((g.float() - w.float()).abs().max())
            tol = float(torch.finfo(dt).eps) * float(w.float().abs().max())
            log(f"ops: nd.ragged_paged_attention {what} q, {dt} pages and q:"
                f" max_abs_err={err:.3e} (one ulp at the largest output, "
                f"{tol:.3e})")
            check(err <= tol, f"ops: nd.ragged_paged_attention {what} over "
                  f"{dt} pages disagrees with its plain twin")
    check(es <= FLASH_REL_TOL * max(1.0, float(got_sdpa.abs().max())),
          "ops: nd.scaled_dot_product_attention disagrees")
    gerr = float((xg.grad - 2 * x).abs().max())
    log(f"ops: rtc square gradient under record() vs 2x: max_abs_err="
        f"{gerr:.3e}")
    check(gerr == 0.0, "ops: rtc square's gradient is not 2x")
    nb = 4 * RTC_N * RTC_N
    library = {"scale_add": (lambda: torch.add(y, x, alpha=2), 3 * nb),
               "square": (lambda: torch.square(x), 2 * nb),
               "rowsum": (lambda: x.sum(1), nb + 4 * RTC_N)}
    results = []
    for k, (lib_fn, nbytes) in library.items():
        args = (x, y) if k == "scale_add" else (x,)
        op = getattr(nd, names[k])
        want = plain[k](*args)
        rel = rel_err(got_rtc[k], want)
        b_ms, b_by, b_f32 = bound(nbytes, 0)
        res = dict(name=f"rtc.{names[k]}", route="cuda",
                   source="chip_smoke.py",
                   replaces="mxnet_tpu/rtc.py:76",
                   shape=f"{RTC_N}x{RTC_N} f32", max_abs_err=rel[0],
                   tol=RTC_REL_TOL, ms=timer.ms(lambda: op(*args)),
                   plain_ms=timer.ms(lambda: plain[k](*args)),
                   bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_f32,
                   library_ms=timer.ms(lib_fn))
        log(f"kernel {res['name']} {res['shape']}: max_abs_err="
            f"{rel[0]:.3e} (relative {rel[1]:.3e}, tol {RTC_REL_TOL}) "
            f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"library_ms={res['library_ms']:.4f} bound_ms={b_ms:.4f} "
            f"({b_by})")
        check(rel[1] <= RTC_REL_TOL, f"{res['name']} disagrees with its "
              f"plain version: {rel[1]} > {RTC_REL_TOL}")
        results.append(res)
    return launches, results


def op_dtype_mixes(torch, rng, decoded, q3, q4, ql):
    """The input dtypes the TPU kernels take beyond q in the pages' own
    dtype, on the decode phase's layer-0 pools: ``nd.ragged_paged_attention``
    (3-D and 4-D q) with f16 q over bf16 pools and with f32 q over bf16 K
    and f16 V pools; ``ragged_flat_attention`` (one token a row at its
    last position) with bf16 q over the f32 pools and over their int8
    quantization; ``quantized_matmul`` with bf16 and f16 x at T=8, K=768,
    N=3072. ``{what: (call, plain twin, launch-counter name)}``."""
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import quantization as qz
    from mxnet_tpu_torch.ops import ragged_attention as ra
    from mxnet_tpu_torch.serving.llm.model import _quantize_kv
    from mxnet_tpu_torch.serving.llm.quant import quantize_leaf
    cache, bt, kv, model = decoded
    kp, vp = cache.k_pages[0], cache.v_pages[0]
    N, bs, H, D = kp.shape
    kb, vb, vh = kp.bfloat16(), vp.bfloat16(), vp.half()
    q3h, q4h, qf = q3.half(), q4.half(), q3.bfloat16()
    seq = torch.arange(bt.shape[0], dtype=torch.int32, device=DEVICE)
    pos = (kv - 1).to(torch.int32)
    quant = {}
    for name, pool in (("k", kp), ("v", vp)):
        xq, sc = _quantize_kv(pool.reshape(N * bs, H, D), torch.int8)
        quant[f"{name}_pages"] = xq.reshape(N, bs, H, D).contiguous()
        quant[f"{name}_scales"] = sc.reshape(N, bs, H).contiguous()
    w, ws = quantize_leaf((rng.randn(768, 3072) / np.sqrt(768)).astype(
        np.float32), "int8")
    w, ws = w.to(DEVICE), ws.to(DEVICE)
    x = torch.from_numpy(rng.randn(8, 768).astype(np.float32)).to(DEVICE)
    xs = {dt: x.to(dt) for dt in (torch.bfloat16, torch.float16)}
    dec, chk = ra.ragged_attention_reference, \
        ra.ragged_chunk_attention_reference
    mixes = {
        "nd.ragged_paged_attention 3-D f16 q, bf16 pages": (
            lambda: nd.ragged_paged_attention(q3h, kb, vb, bt, kv),
            lambda: dec(q3h, kb, vb, bt, kv),
            ra.kernel_name(torch.bfloat16, "decode")),
        "nd.ragged_paged_attention 4-D f16 q, bf16 pages": (
            lambda: nd.ragged_paged_attention(q4h, kb, vb, bt, kv,
                                              q_lens=ql),
            lambda: chk(q4h, kb, vb, bt, kv, ql),
            ra.kernel_name(torch.bfloat16, "chunk")),
        "nd.ragged_paged_attention 3-D f32 q, bf16 K, f16 V": (
            lambda: nd.ragged_paged_attention(q3, kb, vh, bt, kv),
            lambda: dec(q3, kb, vh, bt, kv), ra.DECODE_KERNEL),
        "nd.ragged_paged_attention 4-D f32 q, bf16 K, f16 V": (
            lambda: nd.ragged_paged_attention(q4, kb, vh, bt, kv,
                                              q_lens=ql),
            lambda: chk(q4, kb, vh, bt, kv, ql), ra.CHUNK_KERNEL),
        "ragged_flat_attention bf16 q, f32 pages": (
            lambda: ra.ragged_flat_attention(qf, kp, vp, bt, seq, pos),
            lambda: ra.ragged_flat_attention_reference(qf, kp, vp, bt, seq,
                                                       pos),
            ra.kernel_name(torch.float32)),
        "ragged_flat_attention bf16 q, int8 pages": (
            lambda: ra.ragged_flat_attention(qf, block_tables=bt,
                                             seq_ids=seq, positions=pos,
                                             **quant),
            lambda: ra.ragged_flat_attention_reference(
                qf, block_tables=bt, seq_ids=seq, positions=pos, **quant),
            ra.kernel_name(torch.int8)),
    }
    for dt, xd in xs.items():
        mixes[f"quantized_matmul {str(dt)[6:]} x"] = (
            lambda xd=xd: qz.quantized_matmul(xd, w, ws),
            lambda xd=xd: qz.quantized_matmul_reference(xd, w, ws),
            qz.kernel_name(torch.int8))
    return mixes


# ------------------------------------------------------ training phase --
def make_bert_mlm(dropout, **cfg):
    """``BertForMLM`` of examples/bert_pretrain_mlm.py on the port: BERT
    plus a Dense/LayerNorm transform and the decoder tied to the word
    embedding (``dot``, a low-precision op under AMP, as the example's
    ``nd.dot``), taking ``valid_length``."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel
    from mxnet_tpu_torch.ops import nn as F

    class BertForMLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.bert = BERTModel(dropout=dropout, **cfg)
                self.transform = nn.Dense(cfg["units"], activation="relu",
                                          flatten=False)
                self.ln = nn.LayerNorm()

        def forward(self, tokens, valid_length):
            seq, _ = self.bert(tokens, None, valid_length)
            h = self.ln(self.transform(seq))
            w = self.bert.word_embed.weight.data()
            return F.dot(h.reshape(-1, h.shape[-1]), w,
                         transpose_b=True).reshape(h.shape[0], h.shape[1],
                                                   -1)
    return BertForMLM()


def bert_batches(torch, rng, n, vocab, batch, seqlen, dev):
    """The example's synthetic corpus (bigram chains over a seeded
    successor table, 15% of positions masked) with ``valid_length``
    drawn in [seqlen/4, seqlen]; the loss weighs masked valid positions.
    Returns n (tokens, targets, weights, valid_length) on ``dev``."""
    trans = rng.randint(2, vocab, vocab)
    out = []
    for _ in range(n):
        toks = np.zeros((batch, seqlen), np.int32)
        toks[:, 0] = rng.randint(2, vocab, batch)
        for t in range(1, seqlen):
            toks[:, t] = trans[toks[:, t - 1]]
        masked = toks.copy()
        pos = rng.rand(batch, seqlen) < 0.15
        pos[:, 0] = False
        masked[pos] = 1                      # [MASK]
        vlen = rng.randint(seqlen // 4, seqlen + 1, size=batch)
        pos &= np.arange(seqlen)[None, :] < vlen[:, None]
        out.append(tuple(torch.from_numpy(a.astype(np.float32)).to(dev)
                         for a in (masked, toks, pos, vlen)))
    return out


def mlm_loss(net, loss_fn, batch_data, vocab):
    x, y, w, vlen = batch_data
    logits = net(x, vlen)
    per_tok = loss_fn(logits.reshape(-1, vocab), y.reshape(-1))
    wf = w.reshape(-1)
    return (per_tok * wf).sum() / (wf.sum() + 1e-6)


def set_flash(net, flash):
    from mxnet_tpu_torch.gluon.nn import MultiHeadAttention
    for m in net.modules():
        if isinstance(m, MultiHeadAttention):
            m._flash = flash


def bert_step_grads(net, loss_fn, batch_data, vocab, flash, pre, gate=None,
                    record=None):
    """One forward and backward of the masked-LM loss with the flash
    kernels or the op's plain path (``flash``); keeps the MLM
    transform ReLU's input (in f32) in ``pre[flash]``, or with ``gate``
    multiplies that input by the gate instead of applying the ReLU. With
    ``record`` (a dict), also keeps the last attention call's inputs and
    the gradient of its output there (:class:`recording_attention`).
    Returns the loss and every parameter's gradient."""
    from mxnet_tpu_torch import autograd as ag

    def hook(mod, inputs, out):
        if gate is None:
            pre[flash] = inputs[0].detach().float()
            return None
        return inputs[0] * gate.to(inputs[0].dtype)
    set_flash(net, flash)
    handle = net.transform.act.register_forward_hook(hook)
    with recording_attention() as rec, ag.record():
        loss = mlm_loss(net, loss_fn, batch_data, vocab)
    handle.remove()
    if record is not None:
        record.update(rec)
        rec["out"].register_hook(
            lambda g: record.__setitem__("dout", g.detach()))
    loss.backward()
    return float(loss.detach()), {
        n: p.grad().clone() for n, p in net.collect_params().items()}


def relu_flips(pre, weighed):
    """The MLM transform's ReLU gates that differ between the two paths
    at tokens the loss weighs (elsewhere no gradient reaches the
    transform): (count, largest |pre-activation| at a flip, largest
    |pre-activation| of the plain path)."""
    flips = ((pre[True] > 0) != (pre[False] > 0)) & weighed[..., None]
    n = int(flips.sum())
    tie = max(float(p.abs()[flips].max()) for p in pre.values()) if n \
        else 0.0
    return n, tie, float(pre[False].abs().max())


def bert_train(torch, kernels, net, trainer, loss_fn, data, vocab, label,
               names, layers, amp=None):
    """Train ``net`` one step per batch of ``data`` but the last two
    (dropout masks from seed 0; under AMP through ``amp.scale_loss``),
    then two more steps under the profiler. Checks a finite, falling
    loss, ``layers`` launches a step of each kernel in ``names`` and no
    kernel build after the first step. Returns the launch counts of the
    first steps and a summary (step ms, tokens/s, peak GB, profiled
    device ms per step, idle share)."""
    from mxnet_tpu_torch import autograd as ag
    batch, seqlen = data[0][0].shape
    steps = len(data) - 2

    def step(d):
        with ag.record():
            loss = mlm_loss(net, loss_fn, d, vocab)
            scaled = loss
            if amp is not None:
                with amp.scale_loss(loss, trainer) as scaled:
                    pass
        scaled.backward()
        trainer.step(batch)
        return float(loss.detach())
    torch.manual_seed(0)                  # dropout masks
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times, builds = [], [], None
    for i, d in enumerate(data[:steps]):
        t0 = time.monotonic()
        losses.append(step(d))
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        if i == 0:
            builds = kernels.build_count()
        fused = trainer._fused
        check(fused.fallbacks == {} and fused.last_dispatches == 1,
              f"{label}: step {i} did not take the fused update (fallbacks "
              f"{dict(fused.fallbacks)}, {fused.last_dispatches} launches)")
    launches = kernels.launch_counts()
    step_ms = float(np.median(times[1:])) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    valid = sum(float(d[3].sum()) for d in data[1:steps])
    log(f"{label}: {steps} Adam steps (lr {BERT_LR}, dropout 0.1): losses "
        + " ".join(f"{v:.4f}" for v in losses))
    log(f"{label}: step {step_ms:.2f} ms (median of steps 2-{steps}; first "
        f"{times[0] * 1e3:.1f} ms); {batch * seqlen / step_ms * 1e3:.0f} "
        f"tokens/s ({valid / (sum(times[1:])):.0f} valid tokens/s); peak "
        f"memory {peak_gb:.2f} GB; launches {launches}; builds after the "
        f"first step {kernels.build_count() - builds}")
    check(all(np.isfinite(losses)), f"{label}: non-finite training loss")
    check(losses[-1] < losses[0], f"{label}: loss did not fall over "
          f"{steps} steps ({losses[0]} -> {losses[-1]})")
    for name in names:
        check(launches.get(name, 0) == layers * steps,
              f"{label}: {name} launched {launches.get(name, 0)} times in "
              f"{steps} steps, expected {layers} per step")
    check(launches.get("adam_update", 0) == steps, f"{label}: adam_update "
          f"launched {launches.get('adam_update', 0)} times in {steps} "
          "steps, expected one a step (the fused update)")
    check(trainer._fused.programs_built == 1 and
          trainer._fused.tables_built == 1, f"{label}: the fused update "
          f"built {trainer._fused.programs_built} programs and "
          f"{trainer._fused.tables_built} launch tables in {steps} steps, "
          "expected one each")
    check(kernels.build_count() == builds, f"{label}: a kernel was built "
          "after the first step")
    # the host's split of a step: forward, backward and trainer.step, each
    # closed by a synchronize, over the profiled pass's batches
    split = step_split(torch, net, trainer, loss_fn, data[steps:], vocab,
                       amp)
    log(f"{label}: step split (median of {len(data) - steps}, each part "
        f"closed by a synchronize): forward {split['forward_ms']:.2f} ms, "
        f"backward {split['backward_ms']:.2f} ms, trainer.step "
        f"{split['trainer_step_ms']:.2f} ms")
    # where the time goes: two more steps under the profiler
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for d in data[steps:]:
            step(d)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    share = report_profile(prof, wall, 2)
    return launches, dict(step_ms=step_ms,
                          tokens_s=batch * seqlen / step_ms * 1e3,
                          peak_gb=peak_gb,
                          device_ms=device_rows(prof)[1] / 1e3 / 2,
                          idle=None if share is None else 1 - share,
                          **split)


def step_split(torch, net, trainer, loss_fn, data, vocab, amp=None):
    """Median host ms of a training step's forward (under record),
    backward and ``trainer.step`` over ``data``, each part closed by
    ``torch.cuda.synchronize()``."""
    from mxnet_tpu_torch import autograd as ag
    batch = data[0][0].shape[0]
    parts = {"forward_ms": [], "backward_ms": [], "trainer_step_ms": []}
    for d in data:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ag.record():
            loss = mlm_loss(net, loss_fn, d, vocab)
            scaled = loss
            if amp is not None:
                with amp.scale_loss(loss, trainer) as scaled:
                    pass
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        scaled.backward()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        trainer.step(batch)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        for key, t in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
            parts[key].append(t * 1e3)
    return {k: float(np.median(v)) for k, v in parts.items()}


def run_bert_phase(torch, rng, kernels, cfg=BERT_BASE, batch=BERT_BATCH,
                   seqlen=BERT_T, steps=BERT_STEPS):
    """BERT masked-LM training through gluon, the flash kernels and Adam:
    (a) one step's loss and gradients with the flash kernels against the
    op's plain path (flash=False), dropout 0 (on a ReLU gate flip at a
    tie: on the flash path's gates); (b) ``steps`` Trainer steps
    at dropout 0.1 with falling loss, (c) 12 launches per step of each
    flash kernel, (d) no kernel build after the first step; then a
    profiled pass of two more steps. Returns the launch counts of (b)
    and a summary (step ms, tokens/s, peak GB, profiled device ms per
    step and idle share)."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.ops.flash_attention import KERNEL_NAMES
    vocab, layers = cfg["vocab_size"], cfg["num_layers"]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    data = bert_batches(torch, rng, steps + 3, vocab, batch, seqlen, DEVICE)
    t0 = time.monotonic()
    net = make_bert_mlm(0.0, **cfg)
    net.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
    with ag.pause():                     # materialise the deferred shapes
        mlm_loss(net, loss_fn, data[0], vocab)
    n_params = sum(p.numel() for p in net.parameters())
    log(f"bert: {layers} layers, {cfg['units']} units, vocab {vocab}, "
        f"{n_params / 1e6:.1f}M parameters, seed 0, batch {batch} x "
        f"{seqlen}, set up in {time.monotonic() - t0:.2f}s")
    # (a) flash kernels vs the plain op path, same weights and batch
    grads, one, pre = {}, {}, {}

    def worst_error(got, want):
        gmax = max(float(g.abs().max()) for g in want.values())
        worst, skipped = (-1.0, ""), 0
        for name, g in want.items():
            ref = float(g.abs().max())
            if ref < 1e-6 * gmax:
                skipped += 1
                continue
            err = float((got[name] - g).abs().max()) / ref
            worst = max(worst, (err, name))
        return worst, skipped

    for flash in (True, False):
        one[flash], grads[flash] = bert_step_grads(net, loss_fn, data[0],
                                                   vocab, flash, pre)
    loss_rel = abs(one[True] - one[False]) / abs(one[False])
    worst, skipped = worst_error(grads[True], grads[False])
    log(f"bert: one step flash vs flash=False: loss {one[True]:.6f} vs "
        f"{one[False]:.6f} (relative {loss_rel:.3e}, tol "
        f"{BERT_LOSS_REL_TOL}); max relative gradient error "
        f"{worst[0]:.3e} ({worst[1]}; tol {BERT_GRAD_REL_TOL}; "
        f"{skipped} zero-in-exact-arithmetic gradients not compared)")
    check(all(np.isfinite(v) for v in one.values()),
          "bert: non-finite loss")
    check(loss_rel <= BERT_LOSS_REL_TOL, "bert: flash and plain losses "
          "disagree")
    n_flips, tie, top = relu_flips(pre, data[0][2].bool())
    log(f"bert: MLM transform pre-activations differ by up to "
        f"{float((pre[True] - pre[False]).abs().max()):.3e} (largest "
        f"{top:.3e}); ReLU gates flipped at weighed tokens {n_flips}"
        + (f", |pre-activation| <= {tie:.3e} there (tie below "
           f"{BERT_TIE_REL_TOL} of the largest)" if n_flips else ""))
    if n_flips and worst[0] > BERT_GRAD_REL_TOL:
        check(tie <= BERT_TIE_REL_TOL * top, "bert: a ReLU gate flipped "
              "between the paths away from a tie")
        _, gated = bert_step_grads(net, loss_fn, data[0], vocab, False, pre,
                                   gate=pre[True] > 0)
        worst, skipped = worst_error(grads[True], gated)
        log(f"bert: flash vs flash=False on the flash path's gates: max "
            f"relative gradient error {worst[0]:.3e} ({worst[1]}; tol "
            f"{BERT_GRAD_REL_TOL})")
    check(worst[0] <= BERT_GRAD_REL_TOL, "bert: flash and plain gradients "
          "disagree")
    del net, grads, pre
    torch.cuda.empty_cache()
    # (b)-(d) training at dropout 0.1 through the kernels
    net = make_bert_mlm(0.1, **cfg)
    net.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
    trainer = gluon.Trainer(net.collect_params(), "adam",
                            {"learning_rate": BERT_LR})
    return bert_train(torch, kernels, net, trainer, loss_fn, data[1:], vocab,
                      "bert", KERNEL_NAMES, layers)


def norm_rel(got, want):
    """|got - want| / |want| in the 2-norm, in f64."""
    want = want.double()
    return float((got.double() - want).norm() / want.norm().clamp_min(
        1e-300))


class recording_attention:
    """Within ``with``, the attention op of the port's gluon attention
    layer records the inputs of its last call (``args``: q, k, v and
    the mask as passed, ``kw``) and its output (``out``)."""

    def __enter__(self):
        from mxnet_tpu_torch.gluon.nn import attention as att
        self._att, self._op = att, att.scaled_dot_product_attention
        rec = self.rec = {}

        def recorded(q, k, v, bias=None, **kw):
            out = self._op(q, k, v, bias, **kw)
            rec.update(args=tuple(None if t is None else t.detach()
                                  for t in (q, k, v, bias)), kw=kw,
                       out=out)
            return out
        att.scaled_dot_product_attention = recorded
        return rec

    def __exit__(self, *exc):
        self._att.scaled_dot_product_attention = self._op


def amp_layer_check(torch, rec):
    """The last attention layer of an AMP step on its own: the kernels'
    dq, dk, dv against the f64 twin, with the reference's delta (from
    the bf16 output) and with delta from the f64 output. Returns the
    norm-relative errors of each, and the mean cosine of the layer's
    value rows to their mean (near 1 where the tokens' representations
    coincide, as in BERT's deep layers at init)."""
    from mxnet_tpu_torch.ops import flash_attention as fa
    q, k, v, bias = (None if t is None else t.contiguous()
                     for t in rec["args"])
    bias = bias.to(q.dtype)                  # as AMP casts the mask
    dout = rec["dout"].contiguous()
    causal = rec["kw"].get("causal", False)
    B, H, T, D = q.shape
    sc = 1.0 / D ** 0.5
    w = [t.double() for t in (q, k, v, bias, dout)]
    out64, lse64 = fa.flash_forward_reference(*w[:4], causal, sc)
    exact = fa.flash_backward_reference(*w[:4], out64, lse64, w[4], causal,
                                        sc, want_dbias=False)[:3]
    out, lse = fa.flash_forward(q, k, v, bias, causal, sc)
    ref_delta = fa.flash_backward(q, k, v, bias, out, lse, dout, causal, sc,
                                  want_dbias=False)[:3]
    delta = (w[4] * out64).sum(-1).reshape(B * H, T).float()
    dk, dv, _ = fa.flash_bwd_dkv(q, k, v, bias, dout, lse, delta, causal,
                                 sc)
    dq = fa.flash_bwd_dq(q, k, v, bias, dout, lse, delta, causal, sc)
    errs = [[norm_rel(g, e) for g, e in zip(got, exact)]
            for got in (ref_delta, (dq, dk, dv))]
    vf = v.float()
    cos = torch.nn.functional.cosine_similarity(
        vf, vf.mean(2, keepdim=True).expand_as(vf), dim=-1).mean()
    return errs, float(cos)


def run_bert_amp_phase(torch, rng, kernels, f32, cfg=BERT_BASE,
                       batch=BERT_BATCH, seqlen=BERT_T, steps=BERT_STEPS):
    """BERT masked-LM training under AMP (``amp.init()``, bf16, with
    ``amp.init_trainer``), int32 token ids: (a) one step's loss and
    gradients with the bf16 flash kernels against the op's plain path
    (flash=False, also under AMP), dropout 0 (on a ReLU gate flip at a
    tie: on the flash path's gates), and the last attention layer's
    kernels against the f64 twin (:func:`amp_layer_check`); (b) ``steps``
    steps at dropout 0.1 with falling loss, (c) 12 launches per step of
    each bf16 flash kernel, (d) no kernel build after the first step,
    then a profiled pass of two more steps, printed beside the f32
    phase's summary ``f32``; (e) ``amp.init(target_dtype="float16")``
    with a fresh ``init_trainer`` (loss scale 2^16): AMP_F16_STEPS steps
    through the f16 kernels, printing the scale and whether each step
    was skipped. Returns the launch counts of (b) and (e)."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.ops.flash_attention import KERNEL_NAMES, kernel_name
    vocab, layers = cfg["vocab_size"], cfg["num_layers"]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    data = [(x.int(), y, w, vl) for x, y, w, vl in bert_batches(
        torch, rng, steps + 3 + AMP_F16_STEPS, vocab, batch, seqlen,
        DEVICE)]
    amp.init()
    try:
        net = make_bert_mlm(0.0, **cfg)
        net.initialize(Xavier(), device=DEVICE,
                       generator=torch.Generator().manual_seed(0))
        with ag.pause():
            mlm_loss(net, loss_fn, data[0], vocab)
        log(f"bert amp: amp.init() (bf16), {layers} layers, batch {batch} "
            f"x {seqlen}, int32 token ids")
        # (a) flash kernels vs the plain op path, both under AMP
        grads, one, pre, rec = {}, {}, {}, {}

        def worst_error(got, want):
            worst, held = (-1.0, ""), (-1.0, "")
            for name, g in want.items():
                if float(g.norm()) == 0.0:
                    continue
                err = (norm_rel(got[name], g), name)
                worst = max(worst, err)
                if "attn_query_" not in name and "attn_key_" not in name:
                    held = max(held, err)
            return worst, held

        for flash in (True, False):
            one[flash], grads[flash] = bert_step_grads(
                net, loss_fn, data[0], vocab, flash, pre,
                record=rec if flash else None)
        loss_rel = abs(one[True] - one[False]) / abs(one[False])
        worst, held = worst_error(grads[True], grads[False])
        log(f"bert amp: one step flash vs flash=False: loss {one[True]:.6f}"
            f" vs {one[False]:.6f} (relative {loss_rel:.3e}, tol "
            f"{AMP_LOSS_REL_TOL}); gradient error (norm) {held[0]:.3e} "
            f"({held[1]}; tol {AMP_GRAD_REL_TOL}); query/key projections "
            f"up to {worst[0]:.3e} ({worst[1]}; not held)")
        check(all(np.isfinite(v) for v in one.values()),
              "bert amp: non-finite loss")
        check(loss_rel <= AMP_LOSS_REL_TOL, "bert amp: flash and plain "
              "losses disagree")
        n_flips, tie, top = relu_flips(pre, data[0][2].bool())
        log(f"bert amp: MLM transform ReLU gates flipped at weighed tokens "
            f"{n_flips}" + (f", |pre-activation| <= {tie:.3e} there "
                            f"(largest {top:.3e})" if n_flips else ""))
        if n_flips and held[0] > AMP_GRAD_REL_TOL:
            check(tie <= AMP_TIE_REL_TOL * top, "bert amp: a ReLU gate "
                  "flipped between the paths away from a tie")
            _, gated = bert_step_grads(net, loss_fn, data[0], vocab, False,
                                       pre, gate=pre[True] > 0)
            worst, held = worst_error(grads[True], gated)
            log(f"bert amp: flash vs flash=False on the flash path's gates:"
                f" gradient error (norm) {held[0]:.3e} ({held[1]})")
        check(held[0] <= AMP_GRAD_REL_TOL, "bert amp: flash and plain "
              "gradients disagree")
        ((r_dq, r_dk, r_dv), (e_dq, e_dk, e_dv)), cos = amp_layer_check(
            torch, rec)
        log(f"bert amp: last attention layer vs the f64 twin (norm): "
            f"kernels with the reference's delta (bf16 output) dq {r_dq:.3e}"
            f" dk {r_dk:.3e} dv {r_dv:.3e}; with delta from the exact "
            f"output dq {e_dq:.3e} dk {e_dk:.3e} dv {e_dv:.3e} (tol "
            f"{AMP_LAYER_REL_TOL}); value rows at mean cosine {cos:.4f} to "
            f"their mean")
        check(max(e_dq, e_dk, e_dv) <= AMP_LAYER_REL_TOL, "bert amp: the "
              "last layer's flash kernels disagree with the f64 twin")
        del net, grads, pre, rec
        torch.cuda.empty_cache()
        # (b)-(d) training at dropout 0.1 through the bf16 kernels
        net = make_bert_mlm(0.1, **cfg)
        net.initialize(Xavier(), device=DEVICE,
                       generator=torch.Generator().manual_seed(0))
        trainer = amp.init_trainer(gluon.Trainer(
            net.collect_params(), "adam", {"learning_rate": BERT_LR}))
        launches, summary = bert_train(
            torch, kernels, net, trainer, loss_fn, data[1:3 + steps], vocab,
            "bert amp", [kernel_name(n, torch.bfloat16)
                         for n in KERNEL_NAMES], layers, amp=amp)
        for name in KERNEL_NAMES:
            check(launches.get(name, 0) == 0, f"bert amp: the f32 kernel "
                  f"{name} ran under AMP")

        def vs(key, fmt):
            a, b = summary.get(key), f32.get(key)
            return ("not measured" if a is None else format(a, fmt)) + \
                " (f32 " + ("not measured" if b is None
                            else format(b, fmt)) + ")"
        log(f"bert amp: beside f32: step ms {vs('step_ms', '.2f')}, tokens/s "
            f"{vs('tokens_s', '.0f')}, peak GB {vs('peak_gb', '.2f')}, "
            f"profiled device ms a step {vs('device_ms', '.2f')}, idle "
            f"{vs('idle', '.3f')}, trainer.step ms "
            f"{vs('trainer_step_ms', '.2f')}; loss scale "
            f"{trainer._amp_loss_scaler.loss_scale:g}")
        # (e) float16: a fresh init_trainer, loss scale 2^16
        amp.uninit()
        amp.init(target_dtype="float16")
        trainer16 = amp.init_trainer(gluon.Trainer(
            net.collect_params(), "adam", {"learning_rate": BERT_LR}))
        scaler = trainer16._amp_loss_scaler
        check(scaler.loss_scale == 2.0 ** 16, "bert amp: the f16 loss "
              "scale does not start at 2^16")
        kernels.reset_launch_counts()
        for d in data[3 + steps:]:
            before = scaler.loss_scale
            with ag.record():
                loss = mlm_loss(net, loss_fn, d, vocab)
                with amp.scale_loss(loss, trainer16) as scaled:
                    pass
            scaled.backward()
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                trainer16.step(batch)
            log(f"bert amp f16: loss {float(loss.detach()):.4f}, scale "
                f"{before:g} -> {scaler.loss_scale:g}, step "
                + ("skipped (overflow)" if scaler.loss_scale < before
                   else "applied"))
            check(np.isfinite(float(loss.detach())), "bert amp f16: "
                  "non-finite loss")
        launches16 = kernels.launch_counts()
        for base in KERNEL_NAMES:
            name = kernel_name(base, torch.float16)
            check(launches16.get(name, 0) == layers * AMP_F16_STEPS,
                  f"bert amp f16: {name} launched "
                  f"{launches16.get(name, 0)} times in {AMP_F16_STEPS} "
                  f"steps, expected {layers} per step")
    finally:
        amp.uninit()
    return {k: launches.get(k, 0) + launches16.get(k, 0)
            for k in set(launches) | set(launches16)}


# -------------------------------------------------- optimizer phases --
def update_kwargs(name, k=0):
    """Op ``name``'s kwargs for the k-th tensor of a launch: every scalar
    of the rule's row in play, lr and wd differing by tensor (the rows
    differ), the gradient clip on for even k and off for odd k."""
    kw = dict(UPDATE_KW, **UPDATE_EXTRA.get(name, {}))
    kw["lr"] *= 1 + 0.5 * k
    kw["wd"] *= 1 + k % 3
    if k % 2:
        kw["clip_gradient"] = -1.0
    return kw


def update_case(torch, name, shapes, wdtype, dev, seed, offset=0):
    """Op ``name``'s tensor inputs for each shape, made on ``dev`` from
    ``seed``: weight and gradient (in ``wdtype`` for an mp op, whose f32
    master copy is the weight's value), f32 states in their valid range
    (second moments positive, rmspropalex's mean gradient small against
    its mean square). Each tensor is a view ``offset`` elements into its
    own buffer (1: off the 16-byte alignment)."""
    from mxnet_tpu_torch.ops.optimizer_ops import RULES
    rule = RULES[name]
    gen = torch.Generator(device=dev).manual_seed(seed)

    def make(shape, kind, dtype=torch.float32):
        if kind == "normal":
            x = torch.randn(shape, generator=gen, device=dev)
        elif kind == "positive":
            x = torch.rand(shape, generator=gen, device=dev) * 0.5 + 0.1
        else:                                    # small
            x = (torch.rand(shape, generator=gen, device=dev) - 0.5) * 0.2
        n = x.numel()
        buf = torch.empty(n + offset, dtype=dtype, device=dev)
        out = buf[offset:].view(shape)
        out.copy_(x)
        return out

    lists = []
    for shape in shapes:
        if rule.mp:
            w32 = make(shape, "normal")
            w = make(shape, "normal", wdtype)
            w.copy_(w32)
            xs = [w, make(shape, "normal", wdtype)]
            if name == "mp_sgd_mom_update":
                xs.append(make(shape, "small"))
            xs.append(w32)
        else:
            xs = [make(shape, "normal"), make(shape, "normal")]
            kinds = {"rmspropalex_update": ("positive", "small", "small"),
                     "ftrl_update": ("normal", "positive")}.get(name)
            if kinds is None:
                kinds = ("small" if "mom" in name or name == "signum_update"
                         else "positive", "positive")
            xs += [make(shape, k) for k in kinds[:rule.n_in - 2]]
        lists.append(xs)
    return lists


def mismatches(torch, got, want):
    """(elements whose bits differ, max |got - want|, NaNs) of two
    tensors; NaN on both sides at one place is not a mismatch."""
    a, b = got.float(), want.float()
    nan = torch.isnan(a) & torch.isnan(b)
    diff = (a != b) & ~nan
    err = float((a - b).abs().nan_to_num(0.0).max()) if a.numel() else 0.0
    return int(diff.sum()), err, int(nan.sum())


def kernel_vs_twin(torch, name, lists, kws, table=None):
    """Op ``name``'s twin on clones of ``lists``, then one kernel launch
    on ``lists`` in place (over ``table``, a cached launch table, if
    given): (mismatched elements, max abs error, NaNs) over every written
    tensor."""
    from mxnet_tpu_torch.ops import optimizer_ops as ops
    rule = ops.RULES[name]
    want = []
    for xs, kw in zip(lists, kws):
        out = rule.twin(*[x.clone() for x in xs], **kw)
        want.append((out,) if isinstance(out, torch.Tensor) else out)
    ops.multi_update(name, lists, kws, table=table)
    torch.cuda.synchronize()
    bad, worst, nans = 0, 0.0, 0
    for xs, outs in zip(lists, want):
        for m, w in zip(rule.mutates, outs):
            b, e, n = mismatches(torch, xs[m], w)
            bad, worst, nans = bad + b, max(worst, e), nans + n
    return bad, worst, nans


def adamw_rescale_check(torch, lists, seed):
    """``_adamw_update`` with its rescale array (``rescale_grad_arr``: one
    f32 element on the card a tensor, a new tensor each call, beside a
    float ``rescale_grad`` it replaces) against its twin, in a fresh
    launch table and then in two steps through one cached table: the
    summed (mismatched elements, max abs error, NaNs) and the launches."""
    from mxnet_tpu_torch.ops.optimizer_ops import UpdateTable
    name = "_adamw_update"
    dev = lists[0][0].device
    gen = torch.Generator(device=dev).manual_seed(seed)

    def kws():
        return [dict(update_kwargs(name, k), rescale_grad=64.0,
                     rescale_grad_arr=torch.rand(1, generator=gen,
                                                 device=dev) + 0.25)
                for k in range(len(lists))]
    bad, worst, nans = kernel_vs_twin(torch, name, lists, kws())
    table = UpdateTable(name, lists)
    for _ in range(2):
        b, e, n = kernel_vs_twin(torch, name, lists, kws(), table=table)
        bad, worst, nans = bad + b, max(worst, e), nans + n
    return bad, worst, nans, 3


def bert_base_params(torch, cfg=BERT_BASE, dropout=0.0):
    """BERT-base with the masked-LM head on the card (seeded Xavier), its
    deferred shapes set by one forward of a 1 x 8 batch: (net, loss_fn,
    parameters in the Trainer's order, sorted by name)."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.initializer import Xavier
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    net = make_bert_mlm(dropout, **cfg)
    net.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
    tiny = bert_batches(torch, np.random.RandomState(0), 1,
                        cfg["vocab_size"], 1, 8, DEVICE)[0]
    with ag.pause():
        mlm_loss(net, loss_fn, tiny, cfg["vocab_size"])
    params = net.collect_params()
    return net, loss_fn, [params[k] for k in sorted(params.keys())]


def run_optimizer_kernel_phase(torch, timer, seed=14):
    """Each update rule's kernel over BERT-base's parameter shapes (one
    launch over every tensor, f32; the mp rules with bf16 weights and
    gradients) against its twin on the same inputs, bit for bit, with
    the kernel's and the twin's (parameter by parameter) ms, median of
    30 after the L2 flush, and the bound in bytes; ``_adamw_update``
    also with its rescale array (:func:`adamw_rescale_check`)."""
    from mxnet_tpu_torch.ops import optimizer_ops as ops
    net, _, params = bert_base_params(torch)
    shapes = [tuple(p.shape) for p in params]
    del net, params
    torch.cuda.empty_cache()
    numel = sum(int(np.prod(s)) for s in shapes)
    results = []
    for k, name in enumerate(sorted(ops.RULES)):
        rule = ops.RULES[name]
        wdtype = torch.bfloat16 if rule.mp else torch.float32
        lists = update_case(torch, name, shapes, wdtype, DEVICE, seed + k)
        kws = [update_kwargs(name, i) for i in range(len(lists))]
        bad, err, nans = kernel_vs_twin(torch, name, lists, kws)
        table = ops.UpdateTable(name, lists)
        rows = ops._upload(table.rows(kws, [xs[1] for xs in lists]), DEVICE)

        def kern():
            table.launch(rows)

        def plain():
            for xs, kw in zip(lists, kws):
                rule.twin(*xs, **kw)
        nbytes = numel * ops.bytes_per_element(name, wdtype)
        b_ms, b_by, b_f32 = bound(nbytes, numel * UPDATE_FLOPS[name])
        res = dict(name=name, route="cuda",
                   source="mxnet_tpu_torch/csrc/multi_tensor_update.cu",
                   replaces="none (the reference's update is one XLA "
                            "program: mxnet_tpu/optimizer/fused.py:223)",
                   shape=f"BERT-base {len(shapes)} tensors "
                         f"{numel / 1e6:.1f}M {str(wdtype)[6:]}",
                   max_abs_err=err, tol=0.0, mismatched=bad,
                   ms=timer.ms(kern), plain_ms=timer.ms(plain),
                   bound_ms=b_ms, bound_by=b_by, bound_f32_ms=b_f32,
                   library_ms=None)
        log(f"kernel {name} {res['shape']}: {bad} elements differ from the "
            f"twin (max_abs_err={err:.3e}, NaN on both {nans}) "
            f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
            f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e9:.3f} GB) library "
            f"none")
        check(bad == 0 and nans == 0, f"{name}: the kernel disagrees with "
              f"its twin at BERT-base shapes ({bad} elements, {nans} NaN)")
        if name == "_adamw_update":
            rb, re_, rn, _ = adamw_rescale_check(torch, lists, seed)
            log(f"kernel {name} with rescale_grad_arr (fresh table, then "
                f"a cached one twice, a new array each step): {rb} "
                f"elements differ from the twin (max_abs_err={re_:.3e}, "
                f"NaN on both {rn})")
            check(rb == 0 and rn == 0, f"{name}: the kernel with a rescale "
                  f"array disagrees with its twin ({rb} elements)")
        results.append(res)
        del lists, table, rows
        torch.cuda.empty_cache()
    return results


def run_optimizer_path_phase(torch, rng, kernels, cfg=BERT_BASE,
                             batch=BERT_BATCH, seqlen=BERT_T):
    """BERT-base's Trainer through each fusable optimizer (every update
    rule): one forward and backward gives real gradients, then for each
    optimizer a fresh Trainer takes OPT_PATH_STEPS steps on them (the mp
    rules on the parameters cast to bf16, gradients cast alike), each
    step one launch of its rule and no other, ``last_dispatches`` 1, no
    fallback, no kernel build after the first step, finite weights.
    Returns the launch counts."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.ops.optimizer_ops import RULES
    net, loss_fn, params = bert_base_params(torch, cfg)
    d = bert_batches(torch, rng, 1, cfg["vocab_size"], batch, seqlen,
                     DEVICE)[0]
    with ag.record():
        loss = mlm_loss(net, loss_fn, d, cfg["vocab_size"])
    loss.backward()
    grads = [p.grad().clone() for p in params]
    totals, builds, host = {}, None, {}
    for opt, kw, dtype, rule in OPT_PATHS:
        if dtype is not None and params[0].data().dtype != getattr(
                torch, dtype):
            for p in params:
                p.cast(dtype)
        trainer = gluon.Trainer(net.collect_params(), opt, dict(kw))
        for _ in range(OPT_PATH_STEPS):
            for p, g in zip(params, grads):
                p.grad().copy_(g)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            trainer.step(batch)
            torch.cuda.synchronize()
            host.setdefault(rule, []).append(time.perf_counter() - t0)
            counts = kernels.launch_counts()
            if builds is None:
                builds = kernels.build_count()
            fused = trainer._fused
            check(fused.fallbacks == {} and fused.last_dispatches == 1,
                  f"optimizer {opt} {kw}: fallbacks {dict(fused.fallbacks)}"
                  f", {fused.last_dispatches} launches")
            upd = {k: v for k, v in counts.items() if k in RULES}
            check(upd == {rule: 1}, f"optimizer {opt} {kw}: update "
                  f"launches {upd}, expected {{{rule!r}: 1}}")
            for k, v in counts.items():
                totals[k] = totals.get(k, 0) + v
        check(all(bool(torch.isfinite(p.data()).all()) for p in params),
              f"optimizer {opt} {kw}: non-finite weights")
        log(f"optimizer path {opt} {kw}" + (f" ({dtype} weights)"
                                             if dtype else "")
            + f": {OPT_PATH_STEPS} Trainer steps on BERT-base gradients, "
            f"one {rule} launch each, trainer.step "
            + " ".join(f"{t * 1e3:.2f}" for t in host[rule]) + " ms")
        del trainer
        torch.cuda.empty_cache()
    check(kernels.build_count() == builds, "optimizer path: a kernel was "
          "built after the first step")
    check(set(totals) >= set(RULES), "optimizer path: rules never "
          f"launched: {sorted(set(RULES) - set(totals))}")
    del net, params, grads
    torch.cuda.empty_cache()
    return totals


# template arguments that are builtin types, as the Itanium ABI mangles them
_BUILTIN_ARGS = {"a": "int8", "h": "uint8", "f": "f32", "i": "int"}


def _template_args(s):
    """The arguments of a mangled template argument list ``I...E`` at the
    start of ``s`` (integer and bool literals, builtin types, source and
    nested names, a nested name by its last part), or None."""
    if not s.startswith("I"):
        return None
    args, i = [], 1
    while i < len(s) and s[i] != "E":
        lit = re.match(r"L[ib](\d+)E", s[i:])
        num = re.match(r"\d+", s[i:])
        if lit:
            args.append(lit.group(1))
            i += lit.end()
        elif s[i] in _BUILTIN_ARGS:
            args.append(_BUILTIN_ARGS[s[i]])
            i += 1
        elif num:
            j = i + num.end()
            args.append(s[j:j + int(num.group())])
            i = j + int(num.group())
        elif s[i] == "N":
            i, last = i + 1, "?"
            while i < len(s) and s[i] != "E":
                sub = re.match(r"S[0-9A-Z]*_", s[i:])
                num = re.match(r"\d+", s[i:])
                if sub:
                    i += sub.end()
                elif num:
                    j = i + num.end()
                    last = s[j:j + int(num.group())]
                    i = j + int(num.group())
                else:
                    i += 1
            args.append(last)
            i += 1
        else:
            return None
    return args


def kernel_name(mangled):
    """``flash_dkv_kernel<64>`` for a mangled ``..16flash_dkv_kernelILi64E..``,
    ``paged_ring_kernel<int8,1,2,0,FlatTiles>`` for one with type
    arguments (a length-prefixed name ending in ``_kernel`` and its
    template arguments); the mangled name where none is found."""
    for m in re.finditer(r"\d+", mangled):
        for i in range(m.start(), m.end()):
            end = m.end() + int(mangled[i:m.end()])
            name = mangled[m.end():end]
            if name.endswith("_kernel") and name.isidentifier():
                args = _template_args(mangled[end:])
                if args:
                    name += "<" + ",".join(args) + ">"
                return name
    return mangled


def ring_usage(kernels, page_dtype, tiles, D=64):
    """``(registers, (spill stores, spill loads))`` of the staged paged
    kernel's instantiation for ``page_dtype`` pages, query tiles
    ``tiles`` ("FlatTiles" or "ChunkTiles") and head dim ``D``, from
    this process's build log, or None where it built nothing."""
    t = {"float32": "f32", "int8": "int8",
         "float8_e4m3fn": "__nv_fp8_e4m3", "bfloat16": "__nv_bfloat16",
         "float16": "__half"}[page_dtype]
    scaled = int(page_dtype in ("int8", "float8_e4m3fn"))
    lib = ("ragged_flat_lp" if page_dtype in ("bfloat16", "float16")
           else "ragged_flat")
    name = (f"paged_ring_kernel<{t},{scaled},"
            f"{-(-D // 32)},{int(D % 32 != 0)},{tiles}>")
    for k, regs, spill in ptxas_usage(kernels.build_logs.get(lib, "")):
        if k == name:
            return regs, spill
    return None


def ring_note(kernels, ra, page_dtype, tiles, plan, D, bs, MB):
    """The staged kernel's ``plan`` (tile tokens, heads, splits, stages,
    subs), shared bytes per CTA, registers and spills for one launch, as
    a dict and as text; fails on a spill."""
    import torch
    dt = getattr(torch, page_dtype)
    qt, heads, splits, stages, subs = plan
    smem = ra.ring_smem_bytes(bs, heads, D, dt, qt, stages, MB, subs)[1]
    use = ring_usage(kernels, page_dtype, tiles, D)
    note = dict(plan=dict(qt=qt, heads=heads, splits=splits, stages=stages,
                          subs=subs), smem_bytes=smem,
                registers=None if use is None else use[0],
                spill_bytes=None if use is None else [int(x) for x in
                                                      use[1]])
    text = (f"{tiles} plan qt={qt} heads={heads} splits={splits} "
            f"stages={stages} subs={subs}, {smem} B shared per CTA, "
            + ("registers not in this build's log" if use is None else
               f"{use[0]} registers, spill stores/loads "
               f"{use[1][0]}/{use[1][1]} B"))
    if use is not None:
        check(use[1] == ("0", "0"), f"the staged kernel spills at D={D}: "
              f"{text}")
    return note, text


def ptxas_usage(text):
    """``(kernel, registers, (spill store bytes, spill load bytes))`` of
    each kernel in ``nvcc -Xptxas -v`` output (:func:`kernel_name`)."""
    out, kernel, spill = [], None, ("?", "?")
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = kernel_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = m.groups()
        m = re.search(r"Used (\d+) registers", line)
        if m and kernel is not None:
            out.append((kernel, int(m.group(1)), spill))
            kernel, spill = None, ("?", "?")
    return out


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(HERE, "mxnet_tpu_torch", "csrc")):
        print("chip_smoke: run from a checkout (mxnet_tpu_torch/ missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from mxnet_tpu_torch import kernels
    # 1. card
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"card: {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; TF32 off")
    # 2. build
    t0 = time.monotonic()
    kernels.build_all()
    log(f"build: {sorted(kernels.SOURCES)} in "
        f"{time.monotonic() - t0:.2f}s (each: " + ", ".join(
            f"{n} {t:.2f}s" for n, t in sorted(
                kernels.build_seconds.items())) + ")")
    for name, text in sorted(kernels.build_logs.items()):
        for kernel, regs, spill in ptxas_usage(text):
            log(f"build: {name}: {kernel}: {regs} registers, spill "
                f"stores/loads {spill[0]}/{spill[1]} bytes")
    rng = np.random.RandomState(0)
    timer = Timer(torch)
    # 3. kernels
    results = run_kernel_phase(torch, timer, rng)
    results += run_flash_kernel_phase(torch, timer, rng)
    # its own generator: the later phases draw what they drew before
    results += run_flash_lp_kernel_phase(torch, timer,
                                         np.random.RandomState(9))
    results += run_paged_kernel_phase(torch, timer, rng)
    results += run_paged_lp_kernel_phase(torch, timer, 10)
    results += run_wq_x16_rows(torch, timer, np.random.RandomState(11))
    results += run_optimizer_kernel_phase(torch, timer)
    results += run_spec_kernel_rows(torch, timer, 17)
    # 4. main path, f32
    from mxnet_tpu_torch.serving.llm import TinyDecoder
    t0 = time.monotonic()
    np_params = TinyDecoder(device=DEVICE, **GPT2_SMALL).init_params_numpy(0)
    log(f"params: GPT-2-small widths, seed 0, "
        f"{time.monotonic() - t0:.2f}s")
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    counts, _, _, f32_serving = run_f32_phase(torch, rng, np_params,
                                              kernels)
    add(counts)
    # 5. main path, quantized
    for dtype in ("int8", "float8_e4m3fn"):
        add(run_quant_phase(torch, rng, np_params, kernels, dtype))
    # 5b. main path over 16-bit pools: bf16 at the f32 phase's traffic,
    # then f16 on 3 requests (generators of their own: the later phases
    # draw what they drew before)
    add(run_f32_phase(torch, np.random.RandomState(12), np_params, kernels,
                      dtype="bfloat16")[0])
    add(run_quant_phase(torch, np.random.RandomState(13), np_params,
                        kernels, "float16"))
    # 5c. speculative decoding (its own generator, as 5b)
    add(run_spec_phase(torch, np.random.RandomState(16), np_params, kernels,
                       f32_serving))
    # 5d. multi-LoRA (its own generator, as 5b)
    add(run_lora_phase(torch, np.random.RandomState(18), np_params, kernels,
                       f32_serving))
    # 5e. faults, the tracer and the flight recorder on the captured step
    # (its own generator, as 5b)
    add(run_chaos_phase(torch, np.random.RandomState(19), np_params,
                        kernels, f32_serving))
    del f32_serving
    # 6. paged decode through the model interface
    counts, decoded = run_paged_decode_phase(torch, rng, np_params, kernels)
    add(counts)
    # 6b. the reference's default config (head dim 16), dtype="float32"
    add(run_default_config_phase(torch, rng, kernels))
    del np_params
    # 7. op front end and rtc
    counts, rtc_rows = run_op_phase(torch, timer, rng, decoded)
    add(counts)
    results += rtc_rows
    del decoded, timer
    torch.cuda.empty_cache()
    # 8. main path, training: f32, then under AMP (bf16, then f16)
    counts, f32_bert = run_bert_phase(torch, rng, kernels)
    add(counts)
    torch.cuda.empty_cache()
    add(run_bert_amp_phase(torch, rng, kernels, f32_bert))
    torch.cuda.empty_cache()
    # 8b. the Trainer through every update rule on BERT-base's gradients
    add(run_optimizer_path_phase(torch, np.random.RandomState(15), kernels))
    # 9. kernels line
    for r in results:
        r["launches"] = int(launches.get(r["name"], 0))
        check(r["launches"] > 0, f"{r['name']} never ran on the main path")
    log(json.dumps({"kernels": results}))
    log(card)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
