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
   256) and at phase 5h's encode shape (8 x 128 tokens, no mask); the
   same three flash kernels on bf16 and f16 inputs (the AMP
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
   5f. the adapter registry (``run_registry_phase``): a bank of 5d's
   geometry (8 pages) over an ``AdapterRegistry`` of six adapters (10
   pages, 2 shards each) and nothing published; three waves of eight
   requests under four adapters each fault adapters in at admission
   (every wave after the first two, evicting two cold ones for
   capacity), each fault-in's host ms (disk read, install, synchronise)
   logged, ``registry_loads``, evictions and ``adapter.fault_in`` events
   counted; every wave's streams bit for bit against a bank without a
   registry holding the wave's adapters at the same pages, and against
   the oracle; a wave under int8 KV and weights (K2, K3) faulting in,
   bit for bit against the same wave with the adapters published;
   5g. the decoder artifact (``run_artifact_phase``): ``export_decoder``
   of the f32 params and of int8 and fp8 ``QuantizedWeights``,
   ``load_decoder`` onto the card, the loaded weights the in-memory
   ones' bits, greedy streams bit-identical to a server on the in-memory
   params; artifact bytes, export and load ms;
   5h. the fleet (``run_fleet_phase``): one ``FleetRouter`` over the
   chat ``LLMServer`` (GPT-2-small widths, f32 pools) and an encode
   ``ModelServer`` over BERT-base returning the pooled output of 128
   token ids (buckets 1, 2, 4, 8, one CUDA graph each): ragged bursts
   of encode requests (each batch row bit-identical to the sample alone
   through its bucket's graph, every output against the plain path,
   one replay a batch); chat v2 published from a 2-shard checkpoint
   while two threads per model submit (every Future typed, post-swap
   streams against the oracle over v2); the encoder fine-tuned (2 Adam
   steps of ``L2Loss``, v1 serving its snapshot meanwhile) and
   published through ``FineTunePublisher`` (served against the trained
   block); no build, and captures only in each publish's warm phase;
   a publish killed at its drain rolls back; the quota sheds one
   tenant; each publish's phase seconds and graph pools (both replicas'
   during the drain), tokens/s and encode requests/s before, during
   and after the swap, encode p50/p99 latency, a profiled encode pass;
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
   7b. the framework core (``run_op_corpus_phase``): (a) every case of
   ``CORPUS`` (each op of the elementwise, reduction, shape, linalg and
   nn families, every alias among them; the CPU parity tests hold the
   same cases against the JAX ops) through ``nd`` on CUDA and on CPU
   NDArrays, outputs in shape, dtype and value and the gradient through
   ``autograd.grad`` within ``corpus_tol``; 25 ops at BERT-base's
   activation shape (8, 512, 768) in f32 and bf16; every sampler at
   2^20 draws on the card (moments within 4 standard errors, the same
   stream for one ``(seed, position)``, another for another seed); it
   names every op that fails; (b) each op of the multi-tensor update
   tail (``multi_*``, ``preloaded_multi_*``, ``_multi_*adamw_update``)
   over BERT-base's 203 parameters, f32 and with bf16 weights over f32
   masters: one launch of the update kernel, the twin's bits, its
   inputs unchanged (with ``out=``: written there), then its ms, bytes
   an element and bound; ``multi_sum_sq`` and ``multi_all_finite`` over
   203 gradients (one planted inf); (c) BERT-base (phase 8's model)
   stepped as a user of ``nd``/``autograd`` steps it: int32 NDArray ids,
   ``autograd.record()``, ``loss.backward()``, ``nd.multi_all_finite``
   and one ``nd.multi_sgd_mom_update`` over all parameters a step (3
   steps on one batch, falling loss, 12 launches a step of each f32
   flash kernel, one update launch, no build after step 1), step 1
   against a Trainer with SGD(momentum=0.9), bit for bit; (d) under
   ``amp.init(target_dtype="float16")`` an f16 NDArray's ``sum()`` and
   ``mean()`` return f32; each part's seconds;
   7c. the rest of the op registry (``run_op_tail_phase``): (a) every
   case of ``TAIL_CORPUS`` (the four aliases, the tail of
   ``ops/extra.py``, the detection, quantization and RNN ops; the CPU
   parity tests hold the same cases against the JAX ops) through
   ``nd``/``nd.contrib`` on CUDA and on CPU NDArrays, outputs and
   gradients within ``tail_tol``, each host op raising inside a CUDA-graph
   capture, ``_npi_uniform_n``/``_npi_normal_n`` at 2^20 draws; (b)
   SSD-300 on VOC at batch 32: ``MultiBoxPrior`` over the six maps (8732
   anchors), ``MultiBoxTarget`` with 3:1 negative mining,
   ``MultiBoxLoss``'s arithmetic through ``nd`` and its backward,
   ``MultiBoxDetection`` (NMS 0.45, top 400), against the CPU (a
   cls_target or detection-row flip allowed only where its probability
   lies within an ulp of a neighbour's, and printed); (c) Faster R-CNN's
   test settings on a 600x1000 image: ``MultiProposal`` (batch 2, 6000 ->
   300), ``ROIAlign``, ``PSROIPooling`` (R-FCN, 21 x 7 x 7),
   ``RROIAlign``, the two deformable convolutions (512 -> 512, 3x3,
   dilate 2) forward and backward, ``mrcnn_mask_target`` (28 x 28), each
   against the CPU on one image or 24 rois; (d) the PTB medium LSTM
   (vocab 10000, 2 x 650, 35 steps, batch 20) through ``nd.Embedding``,
   ``nd.RNN`` and ``nd.FullyConnected`` at p=0 against the CPU, 3 SGD
   steps at p=0.5 clipped to norm 5 through ``nd.multi_sum_sq`` (falling
   loss, keep fraction within 4 standard errors), GRU and the vanilla
   modes bidirectional against the CPU; (e) ``nd.contrib.quantized_matmul``
   (K3) at BERT-base's four projections on a 1024-token batch, int8 and
   fp8, against the twin, with kernel, plain and library ms and bound;
   the int8 chain ``quantize_v2`` -> ``quantized_fully_connected`` ->
   ``requantize`` -> ``dequantize`` and ResNet-50's res2 int8 convolution
   bit for bit with the CPU; (f) ``foreach`` over the PTB model's first
   LSTM layer against ``nd.RNN``, ``while_loop`` captured in a CUDA graph,
   ``cond`` both ways and raising inside a capture; each op's ms and each
   part's seconds;
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
   steps each, each step one launch of its rule and nothing else; then
   (8c, ``run_trainer_ckpt_phase``) the Trainer's full-state
   checkpoints on BERT-base, f32 and under AMP bf16: 3 steps, an async
   ``save_state(num_shards=4)`` (critical-path and background ms, the
   checkpoint's bytes), 2 steps over the write, a fresh Trainer's
   ``restore_state`` taking the same 2 steps twice (their spread; the
   resumed weights and Adam slots against the uninterrupted run's, bit
   for bit or within that spread), a sync save's wall ms, and a save
   killed at byte 2^20 of a shard leaving the previous checkpoint to
   restore;
   8d. the vision path (``run_vision_phase``): (a) every ``get_model``
   constructor (34) at batch 8 on the card, 224x224 (Inception V3
   299x299), eval: (8, 1000) finite logits; the first of each family
   also on the CPU from the card net's parameter file, within
   ``ZOO_REL_TOL``; (b) ResNet-50 v1, f32 NCHW, TF32 off, as
   ``bench.py`` sets it up (Xavier after ``mx.random.seed(0)``; the
   per-sample NLL of the f32 log-softmax through ``pick``; SGD lr 1e-3,
   momentum 0.9; ``trainer.step(batch)``): one step at batch 4 on the
   card and on the CPU from the same weights (losses, every update,
   the running statistics), then 10 steps at batch 32 (step ms, images/s,
   peak GB, kernels a step, one fused update launch a step) and two
   profiled steps (device ms, idle, split into convolutions,
   reductions, elementwise, the update kernel, other); (c) ``bench.py``'s
   default, ``resnet50_v1(layout="NHWC", stem_s2d=True)``: its f32
   forward at batch 4 against (b)'s net on the same weights (OIHW ->
   OHWI), then cast to bf16: the update kernel's bf16 ``sgd_mom_update``
   over its bf16 weights against the twin (a kernel row), then 10 steps
   at batch 128 (finite losses, two update launches a step: the bf16
   weights and the f32 BatchNorm group) and the same numbers as (b);
   8e. the compiled step (``run_compiled_phase``): (a) every case of
   ``tests/test_hybridize_sweep.py`` hybridized on the card (one CUDA
   graph per signature: one capture, none on a repeated call; recorded,
   the forward and backward pair) against its eager call, outputs and
   input gradients bit for bit, then ResNet-50 v1 eval at batch 8
   hybridized: one capture, the eager bits, and new weights loaded in
   place read by the next replay; (b) the reference's compiled-step MLP
   cases (SGD momentum and Adam, with and without a BatchNorm): five
   steps across lr and batch-size changes, bit for bit with the eager
   step, one replay a steady step, two captures (buckets 32 and 16) and
   none after across warm tails, the running statistics moving, and a
   forced float16 overflow leaving every weight; (c) BERT-base as phase
   8 trains it through ``Trainer.compile_step``, f32 and under AMP bf16:
   one compiled step against one eager step from the same weights
   (dropout 0; the loss and Adam's first moment, phase 8's tolerances),
   then 10 steps at dropout 0.1 (falling loss, one capture, one replay a
   step after the first, 12 launches a replay of each flash kernel and
   one update launch, dropout masks that differ between replays) and two
   profiled steps; (d) ResNet-50 v1 as ``bench.py`` trains it through
   ``compile_step``: f32 NCHW at batch 32, then bf16 NHWC with the s2d
   stem at batch 128 (10 steps, no fallback, one and two update launches
   a step), each with step ms, images/s, peak GB, device ms, idle,
   capture seconds and graph-pool GB beside 8d's eager numbers (and (c)'s
   beside phase 8's); (e) ``LoRAFineTuneJob`` over the f32 GPT-2-small
   serving decoder's frozen base and ``AdapterFineTunePublisher`` into
   the bank of an ``LLMServer``: two rounds of 4 compiled steps and a
   publish, the stream served under the adapter changing between them
   and the base rows' streams not;
   8f. the sparse tier and the optimizer tail (``run_sparse_phase``):
   (a) the matrix-factorisation net of ``examples/recommender_mf.py``
   with ``sparse_grad=True`` on both tables at MovieLens-20M's id counts
   (138,493 users, 27,278 movies), rank 128, batch 1024, synthetic
   ratings planted at rank 16, 20 Trainer steps each of lazy SGD with
   momentum, lazy Adam and AdaGrad: the loss falls, untouched rows keep
   their bits in the weights and the states, the last step equals the
   same step on CPU copies, the fused updater counts ``sparse_grad`` and
   ``compile_step`` falls back with it; step ms, device ms, idle; (b)
   Adam on a 2^20 x 128 table, 4096 ids a batch, the lazy step beside
   the dense one; (c) ``sparse.dot`` of a 1024 x 2^20 CSR batch (39
   non-zeros a row, Criteo's field count) and a (2^20, 1) weight,
   forward and gradient against CPU copies, beside ``torch.sparse.mm``;
   (d) the eleven new optimizers through the Trainer on BERT-base's
   gradients (8b's setup), 3 steps each, the first step's update of
   every ninth tensor against the same update on CPU copies (SGLD by its
   noise's mean and variance), the other two timed,
   and ``_multi_lamb_update`` / ``_multi_mp_lamb_update`` over the 203
   tensors against the per-tensor phases; (e) the kvstore on the card:
   ``row_sparse_pull``, a sparse push, 2-bit compression bit for bit
   with its CPU twin, a Trainer with a store instance bit for bit with
   ``kvstore=None``; phase 7b also runs the LAMB and AdaGrad update
   ops' corpus cases, card against CPU;
   8g. the rest of gluon (``run_gluon_rest_phase``): (a) SSD-300
   (``ssd_300_vgg16_reduced(classes=20)``, 8732 anchors) trained at
   batch 32 in f32 with SGD and momentum through ``Trainer.step``, fed
   by ``DataLoader(ArrayDataset(...), num_workers=2, pin_memory=True,
   device_prefetch=2)`` over synthetic boxes: one step at batch 2
   against the CPU path from the same weights (the loss, every
   gradient's norm, ``MultiBoxTarget``'s assignments), the loss falling
   over 10 steps, ``detect()``'s rows, step ms, images/s in the step
   and fed by the loader (steps 2-10, the consumer's wait for a batch),
   device ms and idle of two profiled steps, peak GB, kernels a step,
   ``MultiBoxTarget`` and ``MultiBoxDetection`` ms; (b) the word-level
   LSTM language model of MXNet's ``example/gluon/word_language_model``
   (vocabulary 10000, 650 units, 2 layers, dropout 0.5, bptt 35, batch
   32, the global norm clipped to 0.2, SGD at lr 20): one step with
   dropout off against the CPU path, three hybridized steps (replays of
   its CUDA graphs, the state carried) against three eager ones from the
   same weights, then the eager step's time against the hybridized
   one's, tokens/s, device ms, idle; (c) the data
   tier: the loader with and without ``pin_memory`` and
   ``device_prefetch``, every batch bit for bit the host's and in
   order, the consumer's wait and the queue's fill, a worker's exception
   in the consumer; (d) the twelve new losses and the cell families,
   forward and input gradient, card against CPU;
9. one JSON line listing every kernel (the update tail's ops of phase
   7b among them, K3's rows of phase 7c, 8d's bf16 update row): launches
   on the main paths
   (phase 7b's flash and update launches added, and 7c's K3 launches),
   counted through graph replays (8e's compiled steps, the speculative
   phase's verifies and
   draft rounds included, the registry and artifact phases' too; the
   flash kernels': the 10 training
   steps, 8c's steps and the op phase's call; the 16-bit paged kernels': the bf16
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
# phase 5h, the fleet: the encode model's items (token ids a request) and
# buckets, the chat traffic's new tokens, the seconds of traffic before
# and after the chat swap, and the tolerance of a served pooled output
# against the plain path (flash=False), relative to the output's largest
# magnitude: K6's own (the rest of the forward is the same f32 ops on
# both paths; the tanh pooler keeps the output O(1))
ENCODE_T, ENCODE_BUCKETS, FLEET_NEW_TOKENS, FLEET_PUMP_S = \
    128, (1, 2, 4, 8), 16, 2.0
ENCODE_REL_TOL = FLASH_REL_TOL
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
    "mp_nag_mom_update": dict(momentum=0.9),
    "_mp_adamw_update": dict(beta1=0.8, beta2=0.99, epsilon=1e-6, eta=0.5),
    "ftml_update": dict(beta1=0.6, beta2=0.999, epsilon=1e-8, t=3),
}
UPDATE_FLOPS = {"sgd_update": 7, "sgd_mom_update": 9, "nag_mom_update": 11,
                "mp_sgd_update": 7, "mp_sgd_mom_update": 9,
                "adam_update": 17, "_adamw_update": 18,
                "rmsprop_update": 16, "rmspropalex_update": 23,
                "ftrl_update": 22, "signsgd_update": 9,
                "signum_update": 14, "_adagrad_update": 12,
                "mp_nag_mom_update": 12, "_mp_adamw_update": 18,
                "ftml_update": 22}
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
# the update kernel's rules of mxnet_tpu/ops/extra.py's single update ops
EXTRA_RULES = ("mp_nag_mom_update", "_mp_adamw_update", "ftml_update")

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


# ------------------------------------------------------ the op corpus --
# Phase 7b's cases: every op of the framework core's families that the
# port registers (the random ops apart: DRAWS below), as (op, inputs,
# kwargs, family) with numpy inputs made from seeds. The CPU parity tests
# (tests/test_torch_op_corpus.py) hold the port's op against the JAX
# package's on these same inputs; phase 7b holds the card against the
# CPU on them. Keys starting with "_" steer the comparison, not the op:
# "_grad_inputs" (the inputs differentiated), "_int_input" (inputs as
# int32), "_lengths_as_params" (CTCLoss's lengths as parameters).
def _cr(*shape, seed=0, scale=1.0, shift=0.0):
    return np.random.RandomState(seed).randn(*shape) * scale + shift


def _cpos(*shape, seed=0, shift=1.0):
    return np.abs(_cr(*shape, seed=seed)) + shift


def _cspd(n, seed=0):
    a = _cr(n, n, seed=seed)
    return a @ a.T + n * np.eye(n)


_CMP_A = np.array([[1.0, 0.0, 2.0], [-1.0, 2.0, 0.5]])
_CMP_B = np.array([[1.0, 1.0, 1.0], [-2.0, 2.0, 0.0]])


def _corpus():
    out = []

    def add(family, name, inputs, kwargs=None):
        out.append((name, inputs, kwargs or {}, family))

    # elementwise: unary by input domain
    for n in ("abs", "sign", "ceil", "floor", "rint", "round", "trunc",
              "fix", "square", "exp", "expm1", "sin", "cos", "arctan",
              "sinh", "cosh", "tanh", "arcsinh", "degrees", "radians",
              "negative", "erf", "identity", "stop_gradient", "make_loss",
              "relu", "sigmoid", "softsign", "hard_sigmoid", "softrelu",
              "gelu", "silu", "log_sigmoid", "mish", "BlockGrad",
              "zeros_like", "ones_like"):
        add("elemwise", n, [_cr(3, 4, shift=0.29)])
    for n in ("sqrt", "rsqrt", "cbrt", "rcbrt", "log", "log10", "log2",
              "log1p", "reciprocal", "gammaln", "gamma", "digamma"):
        add("elemwise", n, [_cpos(3, 4, shift=0.5)])
    for n in ("arcsin", "arccos", "arctanh", "erfinv", "tan"):
        add("elemwise", n, [_cr(3, 4, scale=0.3)])
    add("elemwise", "arccosh", [_cpos(3, 4, shift=1.5)])
    for n in ("logical_not", "isnan", "isinf", "isfinite"):
        add("elemwise", n, [np.array([[1.0, np.nan, np.inf],
                                      [0.0, -np.inf, 2.0]])])
    # binary, same shapes and broadcast
    for n in ("broadcast_add", "broadcast_sub", "broadcast_mul",
              "broadcast_maximum", "broadcast_minimum", "elemwise_add",
              "elemwise_sub", "elemwise_mul", "_grad_add", "broadcast_plus",
              "broadcast_minus", "maximum", "minimum"):
        add("elemwise", n, [_cr(3, 4), _cr(3, 4, seed=1) + 0.05])
    for n in ("broadcast_div", "elemwise_div"):
        add("elemwise", n, [_cr(3, 4), _cpos(3, 4, seed=1, shift=0.5)])
    for n in ("broadcast_mod", "_mod"):
        add("elemwise", n, [_cpos(3, 4, shift=5.0), _cpos(3, 4, seed=1,
                                                          shift=2.0)])
    for n in ("broadcast_power", "_power"):
        add("elemwise", n, [_cpos(3, 4, shift=0.5), _cr(3, 4, seed=1,
                                                        scale=0.5)])
    for n in ("broadcast_hypot", "hypot", "arctan2"):
        add("elemwise", n, [_cr(3, 4, shift=2), _cr(1, 4, seed=1, shift=2)])
    add("elemwise", "broadcast_add", [_cr(3, 4), _cr(1, 4, seed=1)])
    add("elemwise", "broadcast_mul", [_cr(2, 3, 4), _cr(3, 1, seed=1)])
    for n in ("broadcast_equal", "broadcast_not_equal", "broadcast_greater",
              "broadcast_greater_equal", "broadcast_lesser",
              "broadcast_lesser_equal", "broadcast_logical_and",
              "broadcast_logical_or", "broadcast_logical_xor", "_equal",
              "_not_equal", "_greater", "_greater_equal", "_lesser",
              "_lesser_equal", "_logical_and", "_logical_or",
              "_logical_xor"):
        add("elemwise", n, [_CMP_A, _CMP_B])
    # scalar forms
    for n in ("_plus_scalar", "_minus_scalar", "_rminus_scalar",
              "_mul_scalar", "_div_scalar", "_maximum_scalar",
              "_minimum_scalar", "_hypot_scalar"):
        add("elemwise", n, [_cr(3, 4, shift=0.3)], {"scalar": 2.5})
    add("elemwise", "_rdiv_scalar", [_cpos(3, 4)], {"scalar": 2.5})
    add("elemwise", "_power_scalar", [_cpos(3, 4)], {"scalar": 2.5})
    add("elemwise", "_rpower_scalar", [_cr(3, 4, scale=0.5)],
        {"scalar": 2.5})
    add("elemwise", "_mod_scalar", [_cpos(3, 4, shift=0.6)], {"scalar": 2.5})
    add("elemwise", "_rmod_scalar", [_cpos(3, 4, shift=3.0)],
        {"scalar": 2.0})
    add("elemwise", "_maximum_scalar", [np.arange(6.0).reshape(2, 3)],
        {"scalar": 2.5, "_int_input": True})
    for n in ("_equal_scalar", "_not_equal_scalar", "_greater_scalar",
              "_greater_equal_scalar", "_lesser_scalar",
              "_lesser_equal_scalar", "_logical_and_scalar",
              "_logical_or_scalar", "_logical_xor_scalar"):
        for s in (1.0, 0.0):
            add("elemwise", n, [_CMP_A], {"scalar": s})
    add("elemwise", "smooth_l1", [_cr(3, 4, shift=0.3)], {"scalar": 1.5})
    add("elemwise", "where", [np.array([[1.0, 0.0], [0.0, 1.0]]),
                              _cr(2, 2), _cr(2, 2, seed=1)],
        {"_grad_inputs": (1, 2)})
    add("elemwise", "add_n", [_cr(3, 4), _cr(3, 4, seed=1),
                              _cr(3, 4, seed=2)])
    add("elemwise", "ElementWiseSum", [_cr(3, 4), _cr(3, 4, seed=1)])
    add("elemwise", "_square_sum", [_cr(3, 4)], {"axis": 1})
    # reductions
    for n in ("sum", "mean", "max", "min", "nansum", "sum_axis", "max_axis",
              "min_axis"):
        add("reduce", n, [_cr(2, 3, 4)], {"axis": 1})
    add("reduce", "sum", [_cr(2, 3, 4)], {"axis": (0, 2), "exclude": True,
                                          "keepdims": True})
    add("reduce", "mean", [_cr(2, 3, 4)], {})
    add("reduce", "max", [_cr(2, 3, 4)], {})
    for n in ("prod", "nanprod"):
        add("reduce", n, [_cpos(2, 3, 2, shift=0.5)], {"axis": (0, 2)})
    add("reduce", "norm", [_cr(3, 4, shift=1)], {"ord": 2, "axis": 1})
    add("reduce", "norm", [_cr(3, 4)], {"ord": 1, "axis": 0})
    add("reduce", "argmax", [_cr(3, 4)], {"axis": 1})
    add("reduce", "argmax", [_cr(3, 4)], {})
    add("reduce", "argmin", [_cr(3, 4)], {"axis": 0, "keepdims": True})
    add("reduce", "argmax_channel", [_cr(3, 4)])
    add("reduce", "moments", [_cr(3, 4, 2)], {"axes": (0, 2),
                                              "keepdims": True})
    add("reduce", "cumsum", [_cr(3, 4)], {"axis": 1})
    add("reduce", "cumsum", [_cr(3, 4)], {})
    add("reduce", "logsumexp", [_cr(3, 4)], {"axis": 1})
    # shape, indexing, ordering, creation
    s = "shape_ops"
    a234 = _cr(2, 3, 4)
    for shape in ((4, 6), (0, -1), (-3, 4), (2, -4, 3, 1, -2), (-2,)):
        add(s, "reshape", [a234], {"shape": shape})
    add(s, "Reshape", [a234], {"shape": (6, 4)})
    add(s, "reshape_like", [_cr(3, 4), _cr(2, 6, seed=1)],
        {"_grad_inputs": (0,)})
    add(s, "transpose", [a234])
    add(s, "transpose", [a234], {"axes": (1, 0, 2)})
    for n in ("swapaxes", "SwapAxis"):
        add(s, n, [a234], {"dim1": 0, "dim2": 2})
    for n in ("flatten", "Flatten"):
        add(s, n, [a234])
    add(s, "expand_dims", [_cr(3, 4)], {"axis": -1})
    add(s, "squeeze", [_cr(3, 1, 4, 1)])
    add(s, "squeeze", [_cr(3, 1, 4, 1)], {"axis": (1, 3)})
    add(s, "broadcast_to", [_cr(3, 1)], {"shape": (3, 4)})
    add(s, "broadcast_like", [_cr(3, 1), _cr(3, 4, seed=1)],
        {"_grad_inputs": (0,)})
    for n in ("broadcast_axis", "broadcast_axes"):
        add(s, n, [_cr(3, 1)], {"axis": 1, "size": 4})
    add(s, "tile", [_cr(2, 3)], {"reps": (2, 2)})
    add(s, "repeat", [_cr(2, 3)], {"repeats": 2, "axis": 1})
    add(s, "repeat", [_cr(2, 3)], {"repeats": 3})
    for n in ("flip", "reverse"):
        add(s, n, [a234], {"axis": 1})
    for n, mode in (("pad", "constant"), ("Pad", "edge"), ("pad", "reflect")):
        add(s, n, [_cr(1, 2, 3, 4)], {"mode": mode,
                                      "pad_width": (0, 0, 0, 0, 2, 1, 1, 2),
                                      "constant_value": 1.5})
    for n in ("concat", "Concat"):
        add(s, n, [_cr(2, 3), _cr(2, 4, seed=1)], {"dim": 1})
    add(s, "stack", [_cr(2, 3), _cr(2, 3, seed=1)], {"axis": 1})
    for n in ("split", "SliceChannel"):
        add(s, n, [_cr(2, 6)], {"num_outputs": 3, "axis": 1})
    add(s, "split", [_cr(2, 6)], {"num_outputs": 2, "axis": 0,
                                  "squeeze_axis": True})
    add(s, "slice", [_cr(4, 5)], {"begin": (1, 0), "end": (3, 4)})
    add(s, "slice", [_cr(4, 5)], {"begin": (3, None), "end": (0, None),
                                  "step": (-1, 2)})
    add(s, "slice_axis", [_cr(4, 5)], {"axis": 1, "begin": 1, "end": 4})
    add(s, "slice_like", [_cr(4, 5), _cr(2, 3, seed=1)],
        {"_grad_inputs": (0,)})
    add(s, "clip", [_cr(3, 4, scale=2)], {"a_min": -1.0, "a_max": 1.0})
    add(s, "take", [_cr(4, 3), np.array([0.0, 2.0])],
        {"_grad_inputs": (0,)})
    add(s, "take", [_cr(4, 3), np.array([[0.0, 5.0], [-1.0, 2.0]])],
        {"axis": 0, "mode": "wrap", "_grad_inputs": (0,)})
    add(s, "batch_take", [_cr(3, 4), np.array([0.0, 2.0, 1.0])],
        {"_grad_inputs": (0,)})
    add(s, "pick", [_cr(3, 4), np.array([0.0, 2.0, 1.0])],
        {"_grad_inputs": (0,)})
    add(s, "gather_nd", [_cr(3, 4), np.array([[0.0, 2.0], [1.0, 3.0]])],
        {"_grad_inputs": (0,)})
    add(s, "scatter_nd", [_cr(2), np.array([[0.0, 1.0], [1.0, 2.0]])],
        {"shape": (3, 4), "_grad_inputs": (0,)})
    add(s, "one_hot", [np.array([0.0, 2.0, 1.0])], {"depth": 4})
    add(s, "sort", [_cr(3, 5)], {"axis": 1})
    add(s, "sort", [_cr(3, 5)], {"axis": 0, "is_ascend": False})
    add(s, "argsort", [_cr(3, 4)], {"axis": 1, "is_ascend": False})
    add(s, "topk", [_cr(3, 5)], {"k": 2, "ret_typ": "both"})
    add(s, "topk", [_cr(3, 5)], {"k": 2, "axis": 0, "is_ascend": True})
    add(s, "shape_array", [a234])
    add(s, "size_array", [a234])
    for n in ("cast", "Cast"):
        add(s, n, [_cr(3, 4)], {"dtype": "float16"})
    add(s, "diag", [_cr(4, 4)])
    add(s, "diag", [_cr(4)], {"k": 1})
    add(s, "depth_to_space", [_cr(1, 8, 2, 2)], {"block_size": 2})
    add(s, "space_to_depth", [_cr(1, 2, 4, 4)], {"block_size": 2})
    seq = [_cr(4, 2, 3), np.array([2.0, 4.0])]
    for n in ("SequenceMask", "sequence_mask"):
        add(s, n, seq, {"use_sequence_length": True, "value": -1.0,
                        "_grad_inputs": (0,)})
    add(s, "SequenceMask", [_cr(2, 4, 3), np.array([2.0, 4.0])],
        {"use_sequence_length": True, "axis": 1, "_grad_inputs": (0,)})
    for n in ("SequenceLast", "sequence_last", "SequenceReverse",
              "sequence_reverse"):
        add(s, n, seq, {"use_sequence_length": True, "_grad_inputs": (0,)})
    add(s, "_zeros", [], {"shape": (2, 3), "ctx": "cpu"})
    add(s, "_ones", [], {"shape": (2, 3), "dtype": "int32", "ctx": "cpu"})
    add(s, "_full", [], {"shape": (2, 3), "value": 2.5, "ctx": "cpu"})
    add(s, "_arange", [], {"start": 1.0, "stop": 7.0, "step": 1.5,
                           "repeat": 2, "ctx": "cpu"})
    add(s, "_eye", [], {"N": 3, "M": 4, "k": 1, "ctx": "cpu"})
    # linalg
    la = "linalg"
    for n in ("_linalg_gemm", "linalg_gemm"):
        add(la, n, [_cr(2, 3), _cr(3, 4, seed=1), _cr(2, 4, seed=2)],
            {"alpha": 0.5, "beta": 2.0})
    for n in ("_linalg_gemm2", "linalg_gemm2"):
        add(la, n, [_cr(2, 4, 3), _cr(2, 4, 5, seed=1)],
            {"transpose_a": True, "alpha": 0.5})
    for n in ("_linalg_potrf", "linalg_potrf", "_linalg_det", "linalg_det",
              "_linalg_inverse", "linalg_inverse", "_linalg_sumlogdiag",
              "linalg_sumlogdiag", "_linalg_slogdet", "linalg_slogdet",
              "_linalg_syevd", "linalg_syevd"):
        add(la, n, [_cspd(3)])
    for n in ("_linalg_potri", "linalg_potri"):
        add(la, n, [np.linalg.cholesky(_cspd(3))])
    for n in ("_linalg_trsm", "linalg_trsm"):
        add(la, n, [np.tril(_cpos(3, 3, shift=1.5)), _cr(3, 2, seed=1)])
    add(la, "_linalg_trsm", [np.triu(_cpos(3, 3, shift=1.5)),
                             _cr(2, 3, seed=1)],
        {"lower": False, "rightside": True, "transpose": True, "alpha": 2.0})
    for n in ("_linalg_trmm", "linalg_trmm"):
        add(la, n, [np.tril(_cpos(3, 3, shift=0.5)), _cr(3, 2, seed=1)])
    add(la, "_linalg_trmm", [np.tril(_cpos(3, 3, shift=0.5)),
                             _cr(2, 3, seed=1)],
        {"rightside": True, "transpose": True})
    for n in ("_linalg_syrk", "linalg_syrk"):
        add(la, n, [_cr(3, 2)], {"transpose": True, "alpha": 0.5})
    for n in ("_linalg_gelqf", "linalg_gelqf"):
        add(la, n, [_cr(3, 4)])
    for n in ("_linalg_extractdiag", "linalg_extractdiag"):
        add(la, n, [_cr(2, 3, 3)], {"offset": 1})
    for n in ("_linalg_makediag", "linalg_makediag"):
        add(la, n, [_cr(2, 3)], {"offset": -1})
    add(la, "khatri_rao", [_cr(2, 3), _cr(4, 3, seed=1)])
    # nn
    nn = "nn"
    bn_in = [_cr(2, 3, 4, 4), _cpos(3), _cr(3, seed=1),
             _cr(3, seed=2, scale=0.3), _cpos(3, seed=3)]
    for n in ("FullyConnected", "fully_connected"):
        add(nn, n, [_cr(3, 4), _cr(5, 4, seed=1), _cr(5, seed=2)],
            {"num_hidden": 5})
    add(nn, "FullyConnected", [_cr(2, 3, 4), _cr(5, 4, seed=1)],
        {"num_hidden": 5, "no_bias": True, "flatten": False})
    add(nn, "dot", [_cr(3, 4), _cr(4, 5, seed=1)])
    add(nn, "dot", [_cr(3, 4), _cr(5, 3, seed=1)],
        {"transpose_a": True, "transpose_b": True})
    add(nn, "batch_dot", [_cr(2, 3, 4), _cr(2, 5, 4, seed=1)],
        {"transpose_b": True})
    for n in ("Convolution", "convolution"):
        add(nn, n, [_cr(1, 2, 5, 5), _cr(3, 2, 3, 3, seed=1, scale=0.5),
                    _cr(3, seed=2)],
            {"kernel": (3, 3), "num_filter": 3, "pad": (1, 1)})
    add(nn, "Convolution", [_cr(1, 5, 5, 2), _cr(3, 3, 3, 2, seed=1,
                                                 scale=0.5)],
        {"kernel": (3, 3), "num_filter": 3, "no_bias": True,
         "layout": "NHWC", "stride": (2, 2)})
    add(nn, "Convolution", [_cr(2, 4, 9), _cr(4, 2, 3, seed=1, scale=0.5),
                            _cr(4, seed=2)],
        {"kernel": (3,), "num_filter": 4, "num_group": 2, "dilate": (2,)})
    add(nn, "Deconvolution", [_cr(1, 2, 4, 4), _cr(2, 3, 3, 3, seed=1,
                                                   scale=0.5),
                              _cr(3, seed=2)],
        {"kernel": (3, 3), "stride": (2, 2), "pad": (1, 1), "adj": (1, 1),
         "num_filter": 3, "no_bias": False})
    add(nn, "_s2d_stem_conv", [_cr(1, 8, 8, 3), _cr(4, 7, 7, 3, seed=1,
                                                    scale=0.3)])
    for n, kw in (("Pooling", {"kernel": (3, 3), "stride": (2, 2),
                               "pool_type": "max", "pad": (1, 1)}),
                  ("pooling", {"kernel": (2, 2), "stride": (2, 2),
                               "pool_type": "avg",
                               "pooling_convention": "full",
                               "count_include_pad": False}),
                  ("Pooling", {"kernel": (3, 3), "pool_type": "sum",
                               "stride": (1, 1)}),
                  ("Pooling", {"kernel": (2, 2), "pool_type": "lp",
                               "stride": (2, 2), "p_value": 2}),
                  ("Pooling", {"global_pool": True, "pool_type": "avg",
                               "kernel": (1, 1)})):
        add(nn, n, [_cpos(1, 2, 7, 7, shift=0.1)], kw)
    add(nn, "_contrib_AdaptiveAvgPooling2D", [_cr(1, 2, 6, 6)],
        {"output_size": (3, 3)})
    add(nn, "_contrib_AdaptiveAvgPooling2D", [_cr(1, 2, 7, 5)],
        {"output_size": (3, 2)})
    add(nn, "UpSampling", [_cr(1, 2, 3, 3)], {"scale": 2,
                                              "sample_type": "nearest"})
    add(nn, "UpSampling", [_cr(1, 2, 3, 3)], {"scale": 2,
                                              "sample_type": "bilinear"})
    add(nn, "_contrib_BilinearResize2D", [_cr(1, 2, 6, 6)],
        {"height": 4, "width": 3})
    for n in ("BatchNorm", "batch_norm"):
        add(nn, n, bn_in, {"fix_gamma": False, "use_global_stats": True,
                           "_grad_inputs": (0, 1, 2)})
    add(nn, "BatchNorm", bn_in, {"fix_gamma": False, "_training": True,
                                 "output_mean_var": True,
                                 "_grad_inputs": (0, 1, 2)})
    add(nn, "_contrib_BatchNormWithReLU",
        [_cr(2, 3, 4), _cpos(3), _cr(3, seed=1), _cr(3, seed=2),
         _cpos(3, seed=3)],
        {"fix_gamma": False, "output_mean_var": True, "_training": True,
         "_grad_inputs": (0, 1, 2)})
    add(nn, "_contrib_SyncBatchNorm", bn_in,
        {"_training": True, "_grad_inputs": (0, 1, 2)})
    for n in ("LayerNorm", "layer_norm"):
        add(nn, n, [_cr(3, 6), _cpos(6, seed=1), _cr(6, seed=2)])
    add(nn, "GroupNorm", [_cr(2, 4, 3), _cpos(4, seed=1), _cr(4, seed=2)],
        {"num_groups": 2})
    add(nn, "InstanceNorm", [_cr(2, 3, 5), _cpos(3, seed=1),
                             _cr(3, seed=2)])
    for mode in ("instance", "channel", "spatial"):
        add(nn, "L2Normalization", [_cr(2, 3, 4, shift=1)], {"mode": mode})
    add(nn, "LRN", [_cr(1, 5, 3, 3)], {"nsize": 3, "alpha": 0.1})
    add(nn, "softmax", [_cr(3, 5)])
    add(nn, "softmax", [_cr(3, 5)], {"temperature": 2.0})
    add(nn, "softmax", [_cr(3, 5)], {"use_length": True,
                                     "length": np.array([5.0, 2.0, 3.0]),
                                     "_grad_inputs": (0,)})
    add(nn, "log_softmax", [_cr(3, 5)], {"temperature": 0.5})
    add(nn, "softmin", [_cr(3, 5)])
    add(nn, "softmax_cross_entropy", [_cr(3, 5), np.array([0.0, 2.0, 4.0])],
        {"_grad_inputs": (0,)})
    for n in ("SoftmaxOutput", "softmax_output"):
        add(nn, n, [_cr(3, 5), np.array([0.0, 2.0, 4.0])],
            {"grad_scale": 0.5, "_grad_inputs": (0,)})
    add(nn, "SoftmaxOutput", [_cr(4, 5), np.array([0.0, -1.0, 4.0, -1.0])],
        {"use_ignore": True, "ignore_label": -1.0, "normalization": "batch",
         "_grad_inputs": (0,)})
    for act in ("relu", "tanh", "gelu", "sigmoid", "softrelu", "softsign",
                "log_sigmoid", "silu", "mish"):
        add(nn, "Activation", [_cr(3, 4, shift=0.3)], {"act_type": act})
    add(nn, "activation", [_cr(3, 4)], {"act_type": "tanh"})
    for act in ("leaky", "elu", "selu", "gelu", "rrelu"):
        add(nn, "LeakyReLU", [_cr(3, 4, shift=0.3)], {"act_type": act,
                                                      "slope": 0.2})
    add(nn, "LeakyReLU", [_cr(2, 3, 4, shift=0.3), _cpos(3, seed=1)],
        {"act_type": "prelu"})
    for n in ("Embedding", "embedding"):
        add(nn, n, [np.array([0.0, 2.0, 1.0]), _cr(4, 3)],
            {"input_dim": 4, "output_dim": 3, "_grad_inputs": (1,)})
    add(nn, "_contrib_SparseEmbedding", [np.array([0.0, 2.0, 1.0]),
                                         _cr(4, 3)],
        {"input_dim": 4, "output_dim": 3, "_grad_inputs": (1,)})
    for n in ("CTCLoss", "ctc_loss"):
        add(nn, n, [_cr(5, 2, 4, scale=0.5), np.array([[1.0, 2.0],
                                                       [2.0, 1.0]])],
            {"_grad_inputs": (0,)})
    add(nn, "CTCLoss", [_cr(6, 2, 5, scale=0.5),
                        np.array([[0.0, 3.0], [2.0, 4.0]]),
                        np.array([5.0, 6.0]), np.array([2.0, 1.0])],
        {"blank_label": "last", "use_data_lengths": True,
         "use_label_lengths": True, "_lengths_as_params": True,
         "_grad_inputs": (0,)})
    add(nn, "Correlation", [_cr(1, 2, 4, 4), _cr(1, 2, 4, 4, seed=1)],
        {"kernel_size": 1, "max_displacement": 1, "pad_size": 1})
    add(nn, "Correlation", [_cr(1, 2, 5, 5), _cr(1, 2, 5, 5, seed=1)],
        {"kernel_size": 3, "max_displacement": 2, "stride2": 2,
         "pad_size": 2, "is_multiply": False})
    # jnp.sign's and jnp.maximum(x, 0)'s NaN, zeros and infinities;
    # forward only (jnp.maximum's gradient splits a tie at 0, the port's
    # relu takes torch.relu's), appended so earlier case ids stay
    for n in ("sign", "cbrt", "relu"):
        add("elemwise", n, [SPECIALS], {"_grad_inputs": ()})
    add(nn, "Activation", [SPECIALS], {"act_type": "relu",
                                       "_grad_inputs": ()})
    # topk's ties: the lower index first (lax.top_k), for is_ascend too
    for x, k in ((TIES, 3), (np.zeros(64), 3), (SPECIALS, 7)):
        for asc in (False, True):
            for typ in ("value", "indices", "both"):
                add(s, "topk", [x], {"k": k, "ret_typ": typ,
                                     "is_ascend": asc})
    # the LAMB and AdaGrad update tail (appended, as above): every branch
    # (bias correction, both bounds, a zero norm, clipping, zero rows),
    # and tests/test_op_tail_r3.py's case of the two AdaGrads
    u = "update"
    lamb = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-6, "t": 3,
            "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 1.0}

    def wgmv(seed, shape=(4, 5)):
        return [_cr(*shape, seed=seed), _cr(*shape, seed=seed + 1),
                _cr(*shape, seed=seed + 2, scale=0.1),
                _cpos(*shape, seed=seed + 3, shift=0.1)]
    add(u, "lamb_update_phase1", wgmv(40), lamb)
    add(u, "lamb_update_phase1", wgmv(44), dict(
        lamb, t=1, bias_correction=False, clip_gradient=-1.0))
    add(u, "mp_lamb_update_phase1", wgmv(48) + [_cr(4, 5, seed=48)], lamb)
    for r1, lo, hi in ((2.5, -1.0, 2.0), (0.0, -1.0, -1.0), (0.2, 6.0, -1.0)):
        bounds = {"lr": 0.05, "lower_bound": lo, "upper_bound": hi}
        ws = [_cr(4, 5, seed=52), _cr(4, 5, seed=53), np.array(r1),
              np.array(0.5)]
        add(u, "lamb_update_phase2", ws, bounds)
        add(u, "mp_lamb_update_phase2", ws + [_cr(4, 5, seed=52)], bounds)
    multi = {"learning_rates": (0.01, 0.02), "wds": (0.0, 0.01),
             "step_count": (1, 4), "beta1": 0.9, "beta2": 0.999,
             "epsilon": 1e-6, "rescale_grad": 0.5, "clip_gradient": 1.0,
             "lower_bound": 0.1, "upper_bound": 10.0}
    add(u, "_multi_lamb_update", wgmv(56) + wgmv(60, (7,)), multi)
    add(u, "_multi_mp_lamb_update", wgmv(64) + [_cr(4, 5, seed=64)]
        + wgmv(68, (7,)) + [_cr(7, seed=68)], multi)
    g_rows = _cr(5, 3, seed=72)
    g_rows[[1, 3]] = 0.0
    add(u, "_sparse_adagrad_update",
        [_cr(5, 3, seed=71), g_rows, _cpos(5, 3, seed=73, shift=0.0)],
        {"lr": 0.1, "wd": 0.01, "rescale_grad": 0.5, "clip_gradient": 1.0})
    add(u, "_contrib_group_adagrad_update",
        [_cr(5, 3, seed=74), _cr(5, 3, seed=75), _cpos(5, seed=76)],
        {"lr": 0.1, "rescale_grad": 0.5, "clip_gradient": 1.0})
    w1, g1 = np.ones((3, 2)), np.zeros((3, 2))
    g1[1] = [1.0, -2.0]
    add(u, "_sparse_adagrad_update", [w1, g1, np.zeros((3, 2))],
        {"lr": 0.1})
    add(u, "_contrib_group_adagrad_update", [w1, g1, np.zeros(3)],
        {"lr": 0.1})
    return out


# the special values of sign, relu and the sign-taking update rules
SPECIALS = np.array([np.nan, -0.0, 0.0, np.inf, -np.inf, -1.0, 2.0])
TIES = np.array([1.0, 1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0])
CORPUS = _corpus()


def _cboxes(n, seed=0, lead=(), lo=0.0, span=1.0):
    """``n`` corner boxes [x1, y1, x2, y2] inside [lo, lo + span]^2."""
    rs = np.random.RandomState(seed)
    xy = rs.uniform(lo, lo + 0.7 * span, size=lead + (n, 2))
    wh = rs.uniform(0.08 * span, 0.3 * span, size=lead + (n, 2))
    return np.concatenate([xy, xy + wh], axis=-1)


def _rois(n, seed, batch, size):
    """``n`` rois [b, x1, y1, x2, y2] inside an (h, w) = ``size`` image."""
    rs = np.random.RandomState(seed)
    h, w = size
    x1 = rs.uniform(0, 0.6 * w, n)
    y1 = rs.uniform(0, 0.6 * h, n)
    x2 = x1 + rs.uniform(0.1 * w, 0.4 * w, n)
    y2 = y1 + rs.uniform(0.1 * h, 0.4 * h, n)
    return np.stack([rs.randint(0, batch, n), x1, y1, x2, y2], axis=1)


def _rnn_case(mode, layers, bidir, seed, t=5, n=2, i=3, h=4):
    """Inputs and kwargs of one fused RNN case at p=0 (the flat vector's
    size as ``rnn_param_size`` counts it)."""
    d = 2 if bidir else 1
    g = {"lstm": 4, "gru": 3}.get(mode, 1)
    size = sum(d * (g * h * ((i if k == 0 else h * d) + h) + 2 * g * h)
               for k in range(layers))
    inputs = [_cr(t, n, i, seed=seed), _cr(size, seed=seed + 1, scale=0.3),
              _cr(layers * d, n, h, seed=seed + 2, scale=0.5)]
    if mode == "lstm":
        inputs.append(_cr(layers * d, n, h, seed=seed + 3, scale=0.5))
    return inputs, {"state_size": h, "num_layers": layers, "mode": mode,
                    "bidirectional": bidir, "p": 0.0}


def _tail_corpus():
    """The cases of phase 7c (a), which the CPU parity tests hold against
    the JAX ops: every op of the op tail, the detection, quantization and
    RNN modules, (name, inputs, kwargs, family). ``_dtypes`` names each
    input's numpy dtype (None: float32); the family picks the tolerance
    (:func:`corpus_tol`)."""
    out = []

    def add(family, name, inputs, kwargs=None):
        out.append((name, inputs, kwargs or {}, family))
    el, sh, nn = "elemwise", "shape_ops", "nn"
    x34 = _cr(3, 4, seed=3)
    lab = _cr(3, 4, seed=4)
    # the four aliases
    add(el, "MakeLoss", [x34])
    add(nn, "BatchNorm_v1", [_cr(2, 3, 4, 4), _cpos(3), _cr(3, seed=1),
                             _cr(3, seed=2, scale=0.3), _cpos(3, seed=3)],
        {"fix_gamma": False, "use_global_stats": True,
         "_grad_inputs": (0, 1, 2)})
    add(nn, "Convolution_v1", [_cr(1, 2, 5, 5), _cr(3, 2, 3, 3, seed=1,
                                                    scale=0.5),
                               _cr(3, seed=2)],
        {"kernel": (3, 3), "num_filter": 3, "pad": (1, 1)})
    add(nn, "Pooling_v1", [_cpos(1, 2, 7, 7, shift=0.1)],
        {"kernel": (3, 3), "stride": (2, 2), "pool_type": "max",
         "pad": (1, 1)})
    # output layers with their own backward
    for n in ("LinearRegressionOutput", "LogisticRegressionOutput",
              "MAERegressionOutput"):
        add(el, n, [x34, lab], {"grad_scale": 0.5, "_grad_inputs": (0,)})
    svm_lab = np.array([0.0, 2.0, 4.0, 1.0])
    add(el, "SVMOutput", [_cr(4, 5, seed=5), svm_lab],
        {"margin": 1.0, "regularization_coefficient": 0.5,
         "_grad_inputs": (0,)})
    add(el, "SVMOutput", [_cr(4, 5, seed=5), svm_lab],
        {"use_linear": True, "_grad_inputs": (0,)})
    add(el, "SoftmaxActivation", [_cr(2, 3, 4, seed=6)])
    add(el, "SoftmaxActivation", [_cr(2, 3, 4, seed=6)], {"mode": "channel"})
    add(el, "IdentityAttachKLSparseReg", [x34])
    add(el, "_contrib_gradientmultiplier", [x34], {"scalar": 3.0})
    add(el, "_contrib_round_ste", [_cr(3, 4, seed=7, scale=3.0)])
    add(el, "_contrib_sign_ste", [x34])
    # spatial ops
    add(nn, "GridGenerator", [_cr(2, 6, seed=8)], {"target_shape": (3, 4)})
    add(nn, "GridGenerator", [_cr(2, 2, 3, 4, seed=8)],
        {"transform_type": "warp", "target_shape": (3, 4)})
    grid = np.random.RandomState(9).uniform(-1.1, 1.1, (2, 2, 4, 5))
    add(nn, "BilinearSampler", [_cr(2, 3, 5, 6, seed=10), grid])
    theta = np.array([[1.0, 0.0, 0.0, 0.0, 1.0, 0.0]] * 2) + \
        _cr(2, 6, seed=11, scale=0.1)
    add(nn, "SpatialTransformer", [_cr(2, 3, 5, 6, seed=10), theta],
        {"target_shape": (4, 5)})
    add(nn, "ROIPooling", [_cr(2, 3, 8, 8, seed=12),
                           np.array([[0.0, 1, 1, 6, 5], [1, 0, 2, 7, 7],
                                     [0, 3, 3, 4, 4]])],
        {"pooled_size": (2, 2), "spatial_scale": 1.0, "_grad_inputs": (0,)})
    add(sh, "Crop", [_cr(2, 3, 6, 6, seed=13)],
        {"h_w": (3, 4), "offset": (1, 2)})
    add(sh, "Crop", [_cr(2, 3, 6, 6, seed=13), _cr(1, 1, 4, 4)],
        {"center_crop": True, "num_args": 2, "_grad_inputs": (0,)})
    add(sh, "im2col", [_cr(2, 3, 5, 5, seed=14)],
        {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1),
         "dilate": (1, 1)})
    add(sh, "im2col", [_cr(1, 2, 7, 6, seed=14)],
        {"kernel": (2, 3), "stride": (2, 1), "dilate": (2, 1)})
    add(nn, "col2im", [_cr(2, 27, 25, seed=15)],
        {"output_size": (5, 5), "kernel": (3, 3), "pad": (1, 1)})
    # the index and shape tail
    add(sh, "_split_v2", [_cr(6, 4, seed=16)], {"indices": (2, 5)})
    add(sh, "_split_v2", [_cr(3, 4, seed=16)],
        {"sections": 4, "axis": 1, "squeeze_axis": True})
    add(sh, "_unravel_index", [np.array([3.0, 5.0, 0.0, 4.0])],
        {"shape": (2, 3)})
    add(sh, "_ravel_multi_index", [np.array([[0.0, 1.0, 3.0],
                                             [1.0, 2.0, -1.0]])],
        {"shape": (2, 3)})
    add(sh, "_slice_assign", [_cr(4, 5, seed=17), _cr(2, 3, seed=18)],
        {"begin": (1, 1), "end": (3, 4), "step": ()})
    add(sh, "_slice_assign", [_cr(4, 5, seed=17), _cr(2, 2, seed=18)],
        {"begin": (3, 4), "end": (None, 0), "step": (-2, -2)})
    add(sh, "_slice_assign_scalar", [_cr(4, 5, seed=17)],
        {"scalar": 2.5, "begin": (0, 1), "end": (4, 5), "step": (2, 2)})
    add(sh, "_histogram", [_cr(50, seed=19)],
        {"bin_cnt": 7, "range": (-2.0, 2.0)})
    add(sh, "_histogram", [_cr(40, seed=20)], {"bin_cnt": 5})
    add(sh, "_linspace", [], {"start": 0.0, "stop": 3.0, "num": 7,
                              "ctx": "cpu"})
    add(sh, "_linspace", [], {"start": -1.0, "stop": 2.0, "num": 6,
                              "endpoint": False, "ctx": "cpu"})
    add(sh, "_zeros_without_dtype", [], {"shape": (2, 3), "ctx": "cpu"})
    add(sh, "_contrib_arange_like", [x34], {"start": 1.0, "step": 0.5,
                                            "repeat": 2})
    add(sh, "_contrib_arange_like", [x34], {"axis": 1})
    add(sh, "_contrib_allclose", [x34, x34 + 1e-7])
    add(sh, "_contrib_allclose", [x34, lab])
    add(el, "_contrib_div_sqrt_dim", [_cr(2, 3, 8, seed=21)])
    add(el, "_contrib_quadratic", [x34], {"a": 1.5, "b": -2.0, "c": 0.5})
    add(sh, "_contrib_index_array", [x34])
    add(sh, "_contrib_index_array", [_cr(2, 3, 2)], {"axes": (0, 2)})
    add(sh, "_contrib_index_copy", [_cr(5, 3, seed=22),
                                    np.array([4.0, 0.0, 2.0]),
                                    _cr(3, 3, seed=23)],
        {"_grad_inputs": (0, 2)})
    add(sh, "_contrib_edge_id", [_cr(4, 4, seed=24), np.array([0.0, 1, 3]),
                                 np.array([2.0, 3, 0])])
    add(sh, "_rnn_param_concat", [_cr(6), _cr(4, seed=1), _cr(3, seed=2)])
    add(sh, "_rnn_param_concat", [_cr(2, 3), _cr(2, 2, seed=1)], {"dim": 1})
    for kw in ({"offset": 0, "lower": True}, {"offset": 1, "lower": False},
               {"offset": -1, "lower": True}):
        add(sh, "_linalg_extracttrian", [_cr(2, 4, 4, seed=25)], kw)
    add(sh, "_linalg_maketrian", [_cr(2, 10, seed=26)])
    add(sh, "_linalg_maketrian", [_cr(2, 6, seed=26)],
        {"offset": 1, "lower": False})
    add(sh, "_scatter_set_nd", [_cr(3, 4, seed=27), _cr(2, seed=28),
                                np.array([[0.0, 2.0], [1.0, 3.0]])],
        {"_grad_inputs": (0, 1)})
    sparse = _cr(3, 4, seed=29) * (np.arange(12).reshape(3, 4) % 3 > 0)
    add(el, "_scatter_elemwise_div", [sparse, _cpos(3, 4, seed=30)])
    add(el, "_scatter_minus_scalar", [sparse], {"scalar": 0.7})
    add(el, "_scatter_plus_scalar", [sparse], {"scalar": 0.7})
    # contribs
    add(nn, "_contrib_box_encode",
        [np.array([[1.0, 0.0, 1.0, 1.0], [0.0, 1.0, 1.0, 0.0]]),
         np.array([[0.0, 1.0, -1.0, 2.0], [2.0, 0.0, 1.0, -1.0]]),
         _cboxes(4, seed=31, lead=(2,)), _cboxes(3, seed=32, lead=(2,))])
    add(nn, "_contrib_box_decode", [_cr(2, 4, 4, seed=33, scale=0.3),
                                    _cboxes(4, seed=34, lead=(1,))],
        {"std0": 0.1, "std1": 0.1, "std2": 0.2, "std3": 0.2})
    add(nn, "_contrib_box_decode", [_cr(2, 4, 4, seed=33), _cpos(1, 4, 4)],
        {"format": "center", "clip": 1.0})
    add(nn, "_contrib_fft", [_cr(3, 8, seed=35)])
    add(nn, "_contrib_ifft", [_cr(3, 16, seed=36)])
    add(nn, "_contrib_interleaved_matmul_selfatt_qk",
        [_cr(5, 2, 24, seed=37)], {"heads": 2})
    add(nn, "_contrib_interleaved_matmul_selfatt_valatt",
        [_cr(5, 2, 24, seed=37), _cr(4, 5, 5, seed=38)], {"heads": 2})
    add(nn, "_contrib_interleaved_matmul_encdec_qk",
        [_cr(4, 2, 8, seed=39), _cr(5, 2, 16, seed=40)], {"heads": 2})
    add(nn, "_contrib_interleaved_matmul_encdec_valatt",
        [_cr(5, 2, 16, seed=40), _cr(4, 4, 5, seed=41)], {"heads": 2})
    add(nn, "_contrib_count_sketch",
        [_cr(3, 6, seed=42), np.array([0.0, 2, 1, 2, 0, 3]),
         np.array([1.0, -1, 1, 1, -1, 1])],
        {"out_dim": 4, "_grad_inputs": (0,)})
    add(sh, "_contrib_getnnz", [sparse])
    add(sh, "_contrib_getnnz", [sparse], {"axis": 0})
    add(sh, "_contrib_boolean_mask", [_cr(4, 3, seed=43),
                                      np.array([1.0, 0.0, 1.0, 1.0])])
    add(sh, "_contrib_boolean_mask", [_cr(4, 3, seed=43),
                                      np.array([0.0, 1.0, 0.0, 1.0])],
        {"size": 3})
    add(sh, "_contrib_bipartite_matching", [_cr(2, 3, 4, seed=44)],
        {"threshold": 0.1})
    add(sh, "_contrib_bipartite_matching", [_cr(3, 4, seed=45)],
        {"threshold": 0.5, "is_ascend": True, "topk": 2})
    # image ops
    img = np.random.RandomState(46).uniform(0, 255, (8, 10, 3))
    add(sh, "_image_crop", [img], {"x": 1, "y": 2, "width": 3, "height": 2})
    add(sh, "_image_crop", [np.stack([img, img[::-1]])],
        {"x": 2, "y": 1, "width": 4, "height": 5})
    for size in ((5, 4), (13, 11), (6, 12)):
        add(nn, "_image_resize", [img], {"size": size})
    add(nn, "_image_resize", [np.stack([img, img[::-1]])], {"size": (4, 6)})
    add(sh, "_image_resize", [img], {"size": (7, 5), "interp": 0})
    add(sh, "_image_resize", [np.floor(img)], {"size": (6, 12),
                                               "_int_input": True})
    add(nn, "_image_to_tensor", [img])
    add(nn, "_image_to_tensor", [np.stack([img, img])])
    add(el, "_image_normalize", [_cr(3, 4, 5, seed=47)],
        {"mean": (0.1, 0.2, 0.3), "std": (1.1, 0.9, 1.2)})
    add(el, "_image_normalize", [_cr(2, 3, 4, 5, seed=47)],
        {"mean": 0.5, "std": 2.0})
    # the _npx_ / _npi_ tails
    add(sh, "_npx_reshape", [_cr(2, 3, 4, seed=48)], {"newshape": (0, -1)})
    add(sh, "_npx_reshape", [_cr(2, 3, 4, seed=48)],
        {"newshape": (-1, 0), "reverse": True})
    add(sh, "_npx_reshape", [_cr(2, 3, 4, seed=48)], {"newshape": (-2, 1)})
    add(el, "_npx_relu", [x34])
    add(el, "_npx_sigmoid", [x34])
    add(sh, "_npx_constraint_check", [_cpos(3, 4)])
    add(sh, "_npx_nonzero", [sparse])
    cond = (np.arange(12).reshape(3, 4) % 2).astype(np.float64)
    add(el, "_npi_where_lscalar", [cond, x34], {"scalar": 2.0,
                                                "_grad_inputs": (1,)})
    add(el, "_npi_where_rscalar", [cond, x34], {"scalar": -1.5,
                                                "_grad_inputs": (1,)})
    add(sh, "_npi_where_scalar2", [cond], {"x": 1.5, "y": -2.0})
    add(el, "_npi_powerd", [_cpos(3, 4, seed=49)], {"exp": 2.5})
    add(nn, "_npi_matmul", [_cr(2, 3, 4, seed=50), _cr(4, 5, seed=51)])
    add(nn, "_npi_matmul", [_cr(2, 1, 3, 4, seed=50),
                            _cr(3, 4, 2, seed=51)])
    add(nn, "_npi_tensordot_int_axes", [_cr(2, 3, 4, seed=52),
                                        _cr(3, 4, 5, seed=53)], {"axes": 2})
    add(sh, "_npi_matrix_rank_none_tol", [_cr(4, 3, seed=54)])
    add(sh, "_npi_matrix_rank_none_tol",
        [_cr(4, 2, seed=55) @ _cr(2, 4, seed=56)])
    add(nn, "_npi_pinv_scalar_rcond", [_cr(4, 3, seed=57)])
    add(el, "_npi_boolean_mask_assign_scalar", [x34, cond],
        {"value": 5.0, "_grad_inputs": (0,)})
    add(sh, "_npi_boolean_mask_assign_tensor", [x34, cond, _cr(6, seed=58)])
    add(sh, "_npi_insert_slice", [x34], {"obj": 1, "values": 2.0,
                                         "axis": 0})
    add(sh, "_npi_insert_slice", [x34], {"obj": 3, "values": -1.0})
    add(sh, "_npi_insert_tensor", [x34, np.array([0.0, 2.0])],
        {"values": 7.0, "axis": 1})
    add(sh, "_npi_share_memory", [x34, lab])
    # detection
    add(nn, "_contrib_box_iou", [_cboxes(3, seed=60, lead=(2,)),
                                 _cboxes(5, seed=61, lead=(2,))])
    add(nn, "_contrib_box_iou", [_cboxes(3, seed=60), _cboxes(4, seed=61)],
        {"format": "center"})
    add(sh, "_contrib_MultiBoxPrior", [np.zeros((1, 3, 4, 5))],
        {"sizes": (0.2, 0.3), "ratios": (1.0, 2.0, 0.5)})
    add(sh, "_contrib_MultiBoxPrior", [np.zeros((1, 3, 3, 3))],
        {"sizes": (0.5,), "ratios": (1.0, 3.0), "clip": True,
         "steps": (0.3, 0.3), "offsets": (0.4, 0.6)})
    mb_anchor = _cboxes(30, seed=62)[None]
    mb_label = np.full((2, 4, 5), -1.0)
    for i, nb in enumerate((3, 2)):
        mb_label[i, :nb, 0] = np.random.RandomState(63 + i).randint(0, 3, nb)
        mb_label[i, :nb, 1:] = _cboxes(nb, seed=65 + i)
    add(sh, "_contrib_MultiBoxTarget",
        [mb_anchor, mb_label, _cr(2, 4, 30, seed=67)],
        {"negative_mining_ratio": 3.0, "minimum_negative_samples": 2})
    add(sh, "_contrib_MultiBoxTarget",
        [mb_anchor, mb_label, _cr(2, 4, 30, seed=67)],
        {"overlap_threshold": 0.3})
    probs = np.exp(_cr(2, 4, 30, seed=68))
    probs /= probs.sum(axis=1, keepdims=True)
    add(sh, "_contrib_MultiBoxDetection",
        [probs, _cr(2, 120, seed=69, scale=0.2), mb_anchor],
        {"nms_threshold": 0.5, "nms_topk": 20, "threshold": 0.2})
    add(sh, "_contrib_MultiBoxDetection",
        [probs, _cr(2, 120, seed=69, scale=0.2), mb_anchor],
        {"force_suppress": True, "clip": False})
    nms = np.concatenate([
        np.random.RandomState(70).randint(0, 2, (2, 10, 1)),
        np.random.RandomState(71).uniform(0, 1, (2, 10, 1)),
        _cboxes(10, seed=72, lead=(2,))], axis=-1)
    add(sh, "_contrib_box_nms", [nms],
        {"overlap_thresh": 0.3, "topk": 8, "id_index": 0})
    add(sh, "_contrib_box_nms", [nms],
        {"overlap_thresh": 0.3, "valid_thresh": 0.3, "in_format": "center",
         "out_format": "corner", "force_suppress": True})
    add(nn, "_contrib_ROIAlign", [_cr(2, 4, 8, 9, seed=73),
                                  _rois(3, 74, 2, (16, 18))],
        {"pooled_size": (2, 3), "spatial_scale": 0.5, "sample_ratio": 2,
         "_grad_inputs": (0,)})
    add(nn, "_contrib_ROIAlign", [_cr(2, 8, 8, 9, seed=73),
                                  _rois(3, 75, 2, (8, 9))],
        {"pooled_size": (2, 2), "position_sensitive": True,
         "aligned": True, "_grad_inputs": (0,)})
    # the detection tail
    rpn_kw = {"scales": (2.0, 4.0), "ratios": (0.5, 1.0, 2.0),
              "feature_stride": 4, "rpn_pre_nms_top_n": 50,
              "rpn_post_nms_top_n": 10, "threshold": 0.7,
              "rpn_min_size": 2, "output_score": True}
    rpn_in = [np.random.RandomState(76).uniform(0, 1, (2, 12, 5, 6)),
              _cr(2, 24, 5, 6, seed=77, scale=0.2),
              np.array([[20.0, 24.0, 1.0], [18.0, 22.0, 1.0]])]
    add(sh, "_contrib_Proposal", [a[:1] for a in rpn_in], rpn_kw)
    add(sh, "_contrib_MultiProposal", rpn_in, rpn_kw)
    add(sh, "_contrib_MultiProposal", rpn_in,
        dict(rpn_kw, output_score=False, iou_loss=True))
    add(nn, "_contrib_PSROIPooling", [_cr(2, 18, 8, 9, seed=78),
                                      _rois(3, 79, 2, (16, 18))],
        {"spatial_scale": 0.5, "output_dim": 2, "pooled_size": 3,
         "_grad_inputs": (0,)})
    dcn = [_cr(2, 4, 6, 7, seed=80), _cr(2, 18, 6, 7, seed=81, scale=0.7),
           _cr(3, 4, 3, 3, seed=82, scale=0.3), _cr(3, seed=83)]
    add(nn, "_contrib_DeformableConvolution", dcn,
        {"kernel": (3, 3), "pad": (1, 1), "num_filter": 3})
    add(nn, "_contrib_DeformableConvolution",
        [dcn[0], _cr(2, 36, 3, 3, seed=84, scale=0.7),
         _cr(4, 2, 3, 3, seed=85, scale=0.3)],
        {"kernel": (3, 3), "pad": (2, 2), "dilate": (2, 2),
         "stride": (2, 3), "num_filter": 4, "num_group": 2,
         "num_deformable_group": 2, "no_bias": True})
    add(nn, "_contrib_ModulatedDeformableConvolution",
        [dcn[0], dcn[1],
         np.random.RandomState(86).uniform(0, 1, (2, 9, 6, 7)), dcn[2],
         dcn[3]], {"kernel": (3, 3), "pad": (1, 1), "num_filter": 3})
    add(nn, "_contrib_DeformablePSROIPooling",
        [_cr(2, 18, 8, 9, seed=87), _rois(3, 88, 2, (16, 18)),
         _cr(3, 2, 3, 3, seed=89)],
        {"spatial_scale": 0.5, "output_dim": 2, "group_size": 3,
         "pooled_size": 3, "part_size": 3, "sample_per_part": 2,
         "trans_std": 0.1, "_grad_inputs": (0, 2)})
    add(nn, "_contrib_DeformablePSROIPooling",
        [_cr(2, 18, 8, 9, seed=87), _rois(3, 88, 2, (16, 18))],
        {"spatial_scale": 0.5, "output_dim": 2, "group_size": 3,
         "pooled_size": 3, "no_trans": True, "_grad_inputs": (0,)})
    rr = _rois(3, 90, 2, (16, 18))
    rrois = np.stack([rr[:, 0], (rr[:, 1] + rr[:, 3]) / 2,
                      (rr[:, 2] + rr[:, 4]) / 2, rr[:, 3] - rr[:, 1],
                      rr[:, 4] - rr[:, 2], np.array([0.0, 30.0, -75.0])],
                     axis=1)
    add(nn, "_contrib_RROIAlign", [_cr(2, 3, 8, 9, seed=91), rrois],
        {"pooled_size": (2, 3), "spatial_scale": 0.5, "sampling_ratio": 2,
         "_grad_inputs": (0,)})
    add(nn, "_contrib_mrcnn_mask_target",
        [_rois(3, 92, 1, (8, 8))[:, 1:][None].repeat(2, 0),
         (np.random.RandomState(93).uniform(0, 1, (2, 2, 8, 8)) > 0.5)
         .astype(np.float64),
         np.array([[0.0, 1.0, 1.0], [1.0, 0.0, 1.0]]),
         np.array([[0.0, 1.0, 2.0], [2.0, 2.0, 0.0]])],
        {"num_rois": 3, "num_classes": 3, "mask_size": (4, 4),
         "sample_ratio": 2})
    lags = _cpos(2, 5, seed=94, shift=0.1)
    add(nn, "_contrib_hawkesll",
        [_cpos(2, 3, seed=95, shift=0.2),
         np.random.RandomState(96).uniform(0.1, 0.9, 3),
         _cpos(3, seed=97, shift=0.5), _cpos(2, 3, seed=98, shift=0.0) * 0.3,
         lags, np.array([[0.0, 1, 2, 1, 0], [2.0, 2, 1, 0, 1]]),
         np.array([5.0, 3.0]), lags.sum(axis=1) + 1.0],
        {"_dtypes": (None,) * 5 + ("int32",),
         "_grad_inputs": (0, 1, 2, 3, 4, 7)})
    # quantization
    q8 = np.random.RandomState(99).randint(-127, 128, (3, 4))
    rng_ = (np.array([-1.5]), np.array([2.0]))
    add(sh, "_contrib_quantize", [_cr(3, 4, seed=100), *rng_])
    add(sh, "_contrib_quantize", [_cr(3, 4, seed=100), *rng_],
        {"out_type": "uint8"})
    add(sh, "_contrib_quantize_v2", [_cr(3, 4, seed=101)])
    add(sh, "_contrib_quantize_v2", [_cr(3, 4, seed=101)],
        {"min_calib_range": -1.0, "max_calib_range": 1.2})
    add(sh, "_contrib_dequantize", [q8, *rng_], {"_dtypes": ("int8",)})
    add(sh, "_contrib_dequantize", [q8 + 127, *rng_], {"_dtypes": ("uint8",)})
    acc = np.random.RandomState(102).randint(-60000, 60000, (3, 4))
    add(sh, "_contrib_requantize", [acc, np.array([-3.0]), np.array([3.0])],
        {"_dtypes": ("int32",)})
    add(sh, "_contrib_requantize", [acc, np.array([-3.0]), np.array([3.0])],
        {"min_calib_range": -1.5, "max_calib_range": 1.5,
         "_dtypes": ("int32",)})
    add(sh, "_contrib_requantize", [q8, np.array([-3.0]), np.array([3.0])],
        {"_dtypes": ("int8",)})
    qx = np.random.RandomState(103).randint(-127, 128, (4, 16))
    qw = np.random.RandomState(104).randint(-127, 128, (5, 16))
    add(sh, "_contrib_quantized_fully_connected", [qx, qw],
        {"x_scale": 0.02, "w_scale": 0.03, "_dtypes": ("int8", "int8")})
    add(sh, "_contrib_quantized_fully_connected", [qx, qw],
        {"x_scale": 0.02, "w_scale": (0.01, 0.02, 0.03, 0.04, 0.05),
         "_dtypes": ("int8", "int8")})
    add(sh, "_contrib_quantized_conv",
        [np.random.RandomState(105).randint(-127, 128, (2, 6, 6, 3)),
         np.random.RandomState(106).randint(-127, 128, (3, 3, 3, 4))],
        {"kernel": (3, 3), "stride": (1, 1), "pad": (1, 1), "x_scale": 0.1,
         "w_scale": 0.05, "_dtypes": ("int8", "int8")})
    mm = (np.array([-2.0]), np.array([2.5]))
    add(sh, "_contrib_quantized_act", [q8, *mm], {"_dtypes": ("int8",)})
    qimg = np.random.RandomState(107).randint(-127, 128, (1, 2, 6, 6))
    add(sh, "_contrib_quantized_pooling", [qimg, *mm],
        {"kernel": (2, 2), "stride": (2, 2), "_dtypes": ("int8",)})
    add(sh, "_contrib_quantized_pooling", [qimg, *mm],
        {"kernel": (3, 3), "stride": (1, 1), "pool_type": "avg",
         "_dtypes": ("int8",)})
    add(sh, "_contrib_quantized_flatten",
        [np.random.RandomState(108).randint(-127, 128, (2, 3, 4)), *mm],
        {"_dtypes": ("int8",)})
    add(sh, "_contrib_quantized_concat",
        [q8, np.random.RandomState(109).randint(-127, 128, (3, 2)),
         np.array([-1.0]), np.array([-3.0]), np.array([2.0]),
         np.array([0.5])],
        {"dim": 1, "num_args": 2, "_dtypes": ("int8", "int8")})
    q8b = np.random.RandomState(110).randint(-127, 128, (3, 4))
    for n in ("_contrib_quantized_elemwise_add",
              "_contrib_quantized_elemwise_mul"):
        add(sh, n, [q8, q8b, np.array([-1.0]), np.array([2.0]),
                    np.array([-3.0]), np.array([0.5])],
            {"_dtypes": ("int8", "int8")})
    qbn = [np.random.RandomState(111).randint(-127, 128, (2, 3, 4)),
           _cpos(3), _cr(3, seed=112), _cr(3, seed=113, scale=0.3),
           _cpos(3, seed=114), np.array([-2.0]), np.array([2.0])]
    add(sh, "_contrib_quantized_batch_norm", qbn, {"_dtypes": ("int8",)})
    add(sh, "_contrib_quantized_batch_norm", qbn,
        {"min_calib_range": -3.0, "max_calib_range": 2.0,
         "_dtypes": ("int8",)})
    add(sh, "_contrib_quantized_embedding",
        [np.array([0.0, 4.0, 2.0]),
         np.random.RandomState(115).randint(-127, 128, (5, 4)), *mm],
        {"input_dim": 5, "output_dim": 4, "_dtypes": (None, "int8")})
    wq = np.random.RandomState(116).randint(-127, 128, (16, 8))
    for n in ("_contrib_quantized_matmul", "quantized_matmul"):
        add(nn, n, [_cr(6, 16, seed=117), wq, _cpos(8, seed=118) * 0.01],
            {"_dtypes": (None, "int8")})
    add(nn, "_contrib_quantized_matmul",
        [_cr(6, 16, seed=117), wq, _cpos(8, seed=118) * 0.01],
        {"use_pallas": False, "block_t": 64, "_dtypes": (None, "int8")})
    hist, edges = np.histogram(np.random.RandomState(119).randn(4000),
                               bins=511, range=(-4.0, 4.0))
    add(sh, "_contrib_calibrate_entropy", [hist.astype(np.float64), edges],
        {"num_quantized_bins": 255})
    # the fused RNN at p=0 (the draws at p > 0 are held by their
    # statistics)
    for i, (mode, layers, bidir) in enumerate(
            (("lstm", 2, True), ("gru", 2, False), ("rnn_tanh", 1, True),
             ("rnn_relu", 2, False), ("lstm", 1, False))):
        inputs, kw = _rnn_case(mode, layers, bidir, seed=120 + 4 * i)
        add(nn, "RNN" if i < 4 else "rnn", inputs, kw)
    return out


TAIL_CORPUS = _tail_corpus()
# card-vs-CPU and port-vs-JAX tolerances of a family's forward (rtol,
# atol); every VJP and the nn and linalg families take VJP_TOL; the
# shape family and every non-differentiable op are exact
FAMILY_TOL = {"elemwise": (1e-5, 1e-6), "reduce": (1e-5, 1e-6)}
VJP_TOL = (1e-4, 1e-5)
# ops whose two implementations differ by more, with the reason
WIDER_TOL = {
    "erfinv": (1e-4, 1e-5, "two erfinv approximations"),
    "gamma": (1e-4, 1e-5, "exp(lgamma) from two lgamma approximations"),
    "gammaln": (1e-4, 1e-5, "two lgamma approximations"),
    "digamma": (1e-4, 1e-5, "two digamma approximations"),
    "_linalg_det": (1e-4, 1e-4, "LU factorizations in another order"),
    "linalg_det": (1e-4, 1e-4, "LU factorizations in another order"),
    "_linalg_inverse": (1e-4, 1e-4, "LU factorizations in another order"),
    "linalg_inverse": (1e-4, 1e-4, "LU factorizations in another order"),
    "_contrib_AdaptiveAvgPooling2D": (1e-4, 1e-5, "the resize filter's "
                                      "weights summed in another order"),
    "UpSampling": (1e-4, 1e-5, "the resize filter's weights summed in "
                   "another order"),
    "_contrib_BilinearResize2D": (1e-4, 1e-5, "the resize filter's "
                                  "weights summed in another order"),
    "CTCLoss": (1e-4, 1e-4, "the alphas summed in another order"),
    "ctc_loss": (1e-4, 1e-4, "the alphas summed in another order"),
    "_linspace": (1e-6, 1e-7, "jnp.linspace is one fused XLA loop whose "
                  "multiply-adds may contract to FMAs: the last bit of "
                  "start*(1-t) + stop*t differs"),
    "_contrib_box_encode": (1e-5, 1e-6, "float arithmetic (log, "
                            "division), not an index: the elementwise "
                            "tolerance"),
}
# the LAMB and AdaGrad update tail: f32 update arithmetic (divisions,
# square roots, LAMB's norms as sums) rounded by two libraries
for _n in ("lamb_update_phase1", "lamb_update_phase2",
           "mp_lamb_update_phase1", "mp_lamb_update_phase2",
           "_multi_lamb_update", "_multi_mp_lamb_update",
           "_sparse_adagrad_update", "_contrib_group_adagrad_update"):
    WIDER_TOL[_n] = (1e-5, 1e-6, "update arithmetic and norms rounded "
                     "by two libraries")
# K3's registered op: an f32 product, summed in the kernel's (or the
# library's) order; held within 1e-5 of the output's scale
WIDER_TOL["_contrib_quantized_matmul"] = (1e-5, 1e-5, "f32 products "
                                          "summed in another order")
# the detection ops whose box coordinates go through exp or log (two
# libraries' approximations: an edge can move an ulp); their classes,
# masks and kept rows are integers, which these tolerances hold exactly
for _n in ("_contrib_MultiBoxTarget", "_contrib_MultiBoxDetection",
           "_contrib_Proposal", "_contrib_MultiProposal"):
    WIDER_TOL[_n] = (1e-5, 1e-6, "box coordinates through exp/log of "
                     "two libraries")


def corpus_tol(op, family, forward):
    """(rtol, atol) of a corpus case's comparison."""
    if op.name in WIDER_TOL:
        return WIDER_TOL[op.name][:2]
    if forward and (family == "shape_ops" or not op.differentiable):
        return 0.0, 0.0
    if forward and family in FAMILY_TOL:
        return FAMILY_TOL[family]
    return VJP_TOL


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
# phase 5h's encode requests: BERT-base over 8 x 128 token ids, no mask
BERT_ENCODE = (8, BERT_BASE["num_heads"], 128, 64)


def run_flash_kernel_phase(torch, timer, rng):
    """K6 (forward), K7a (dK/dV/dbias) and K7b (dQ) at BERT-base shapes,
    then at head dims 256 and 192, then at phase 5h's encode shape
    (BERT-base over 8 x 128 tokens), against their plain twins (at D=256
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
            ("no mask", False, False, wide192),
            ("no mask", False, False, BERT_ENCODE)):
        B, H, T, D = shape
        scale = 1.0 / D ** 0.5
        bhtd = 4 * B * H * T * D
        # the encode shape draws from a generator of its own: the later
        # phases draw what they drew before it was added
        a, dout, pairs = flash_case(
            torch, np.random.RandomState(27) if shape == BERT_ENCODE
            else rng, padding, causal, shape)
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
# the eager training phases' summaries by label (phase 8e prints the
# compiled steps beside them)
EAGER_ROWS = {}
# the compiled steps' summaries by label (phase 8i prints its Module
# steps beside them)
COMPILED_ROWS = {}


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


def submit_together(server, prompts, n=NEW_TOKENS, adapters=None):
    """Submit ``prompts`` (greedy, ``n`` tokens each; under ``adapters``,
    one name or None a prompt) so the worker takes them in one pull: the
    server's admission lock is held (re-entrantly) across the submits,
    so every run of the same prompts admits them in one step and packs
    the same rows each step. Returns the Futures."""
    adapters = adapters or [None] * len(prompts)
    with server._cv:
        return [server.submit(p, n, adapter=a)
                for p, a in zip(prompts, adapters)]


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


# ------------------------------------------ the adapter registry (5f) --
# six adapters on disk, more pages (10) than LORA_BANK holds (8): the
# three of LORA_ADAPTERS and three more, (name, rank, alpha, seed)
REGISTRY_ADAPTERS = LORA_ADAPTERS + (("dee", 8, 2.0, 34),
                                     ("eli", 8, None, 35),
                                     ("fox", 4, None, 36))
# waves of two requests an adapter, four adapters a wave, in submit order
# with prompts growing along it (so the adapters go cold in that order):
# every wave after the first pins two residents, then faults in two
# names that evict two cold ones for capacity
REGISTRY_WAVES = (("fox", "ada", "bob", "cal"), ("bob", "ada", "dee", "eli"),
                  ("eli", "bob", "cal", "fox"))
REGISTRY_INT8_WAVE = ("ada", "dee", "fox", "cal")
REGISTRY_PROMPT_LENS = (5, 9, 17, 30, 70, 100, 190, 260)


def time_fault_ins(bank):
    """Wrap ``bank``'s fault-in to time each one on the host: the disk
    reads (the registry's ``has`` and ``load``), the installs' copies and
    the synchronise that ends them. Returns the list it appends a dict a
    fault-in to."""
    rows, cur = [], {}
    reg = bank._registry
    has, load = reg.has, reg.load
    sync, fault = bank._installed_locked, bank._fault_in_locked

    def timed(fn, key):
        def run(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                if "name" in cur:
                    cur[key] = cur.get(key, 0.0) + \
                        (time.perf_counter() - t0) * 1e3
        return run

    def fault_in(name):
        cur.clear()
        cur["name"] = name
        t0 = time.perf_counter()
        rec = fault(name)
        total = (time.perf_counter() - t0) * 1e3
        rows.append(dict(name=name, pages=len(rec.pages),
                         read_ms=cur.get("read", 0.0),
                         sync_ms=cur.get("sync", 0.0),
                         install_ms=total - cur.get("read", 0.0)
                         - cur.get("sync", 0.0), total_ms=total))
        cur.clear()
        return rec
    reg.has, reg.load = timed(has, "read"), timed(load, "read")
    bank._installed_locked = timed(sync, "sync")
    bank._fault_in_locked = fault_in
    return rows


def publish_at(bank, layout, factors):
    """Publish ``layout``'s adapters (``{name: pages}``, in order) into
    ``bank`` (no registry) at exactly those pages: every resident is
    evicted and the free list ordered so the allocator hands each
    adapter its pages. The same adapters at the same pages give a pack
    the same bits as the bank they were read from."""
    for name in bank.names():
        bank.evict(name)
    want = [p for pages in layout.values() for p in pages]
    free = bank._alloc._free
    rest = [p for p in free if p not in want]
    free.clear()
    free.extend(want + rest)
    for name in layout:
        a, b, alpha = factors[name]
        bank.publish(name, a, b, alpha=alpha)
    got = {n: bank._resident[n].pages for n in layout}
    check(got == layout, f"publish_at: pages {got}, wanted {layout}")


def run_registry_phase(torch, rng, np_params, kernels, f32):
    """Multi-LoRA serving with the on-disk tier at GPT-2-small widths:
    ``LLMServer(..., adapter_bank=AdapterBank(registry=
    AdapterRegistry(tmp, num_shards=2)))`` over f32 pools, the bank of
    ``LORA_BANK``'s geometry (8 pages), the registry holding the six
    ``REGISTRY_ADAPTERS`` (10 pages) and no adapter published.

    (a) the ``REGISTRY_WAVES``, each eight requests under four adapters
    (``submit_together``): every adapter a wave needs and the bank lacks
    faults in at admission on the engine thread (disk read, in-place
    install, synchronise), evicting cold residents; after the first,
    every wave faults in two and evicts two for capacity; nothing built
    or captured after warmup, one replay a dispatch; each fault-in's
    host ms (disk read, install, synchronise), ``registry_loads``,
    ``evictions`` and the ``adapter.fault_in`` flight events logged;
    tokens/s of each wave beside the f32 phase's (``f32``);
    (b) every wave's streams bit for bit against the same prompts in the
    same packs through a second server whose bank (no registry, the same
    geometry) holds the wave's adapters published resident at the same
    pages (:func:`publish_at`), and against ``greedy_decode_reference(
    lora=bank.adapter_arrays(name))`` as phase 5d holds them;
    (c) a wave under int8 KV and int8 weights on a third server with a
    bank of its own over the same registry: the int8 flat attention (K2)
    and quantized matmul (K3) kernels run with every adapter faulted in;
    its streams bit for bit against the same wave on the same server
    after the adapters are published resident at the same pages.
    Returns the launch counts of the served traffic."""
    import shutil
    import tempfile
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.observability import get_flightrecorder
    from mxnet_tpu_torch.ops.quantization import kernel_name as wq_name
    from mxnet_tpu_torch.ops.ragged_attention import kernel_name
    from mxnet_tpu_torch.serving.adapters import (AdapterBank,
                                                  AdapterRegistry)
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    from mxnet_tpu_torch.serving.telemetry import compile_count
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    tag = "registry"
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    params = params_from_numpy(np_params, DEVICE)
    L, d = GPT2_SMALL["num_layers"], GPT2_SMALL["d_model"]
    root = tempfile.mkdtemp(prefix="mxt-registry-")
    fl = get_flightrecorder()
    try:
        factors = {}
        t0 = time.monotonic()
        writer = AdapterRegistry(root, num_shards=2)
        for name, rank, alpha, seed in REGISTRY_ADAPTERS:
            a, b = lora_factors(seed, rank)
            factors[name] = (a, b, alpha)
            writer.save(name, a, b, alpha=alpha)
        nbytes = sum(os.path.getsize(os.path.join(dp, f))
                     for dp, _, fs in os.walk(root) for f in fs)
        log(f"{tag}: registry of {len(REGISTRY_ADAPTERS)} adapters "
            f"{[(n, r) for n, r, _, _ in REGISTRY_ADAPTERS]} (10 pages "
            f"of rank 4, the bank holds 8), 2 shards each, {nbytes / 1e6:.1f}"
            f" MB on disk, written in {time.monotonic() - t0:.2f}s")
        bank = AdapterBank(L, d, device=DEVICE, registry=AdapterRegistry(
            root, num_shards=2), **LORA_BANK)
        timings = time_fault_ins(bank)
        server = LLMServer(model, params, name="gpt2-registry",
                           max_seqs=MAX_SEQS, block_size=BLOCK_SIZE,
                           adapter_bank=bank, device=DEVICE)
        _, progs, calls = warm_server(torch, server, tag)
        ref_bank = AdapterBank(L, d, device=DEVICE, **LORA_BANK)
        # a model object of its own: warm_server counts decode_flat's
        # Python calls on the model
        ref = LLMServer(TinyDecoder(device=DEVICE, **GPT2_SMALL), params,
                        name="gpt2-registry-resident", max_seqs=MAX_SEQS,
                        block_size=BLOCK_SIZE, adapter_bank=ref_bank,
                        device=DEVICE)
        _, ref_progs, ref_calls = warm_server(torch, ref, f"{tag} resident")
        builds = compile_count()
        server.start()
        ref.start()
        fl.clear()
        fl.enable()
        # (a) + (b)
        kernels.reset_launch_counts()
        events = []
        for w, wave in enumerate(REGISTRY_WAVES):
            names = [n for n in wave for _ in (0, 1)]
            prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
                       for n in REGISTRY_PROMPT_LENS]
            before = bank.stats()
            n_faults = len(timings)
            t0 = time.monotonic()
            res = [f.result(timeout=600) for f in submit_together(
                server, prompts, adapters=names)]
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
            # read the ring a wave: the two servers' step events are many
            events += [e for e in fl.snapshot()
                       if e["kind"] == "adapter.fault_in"]
            fl.clear()
            st = bank.stats()
            loads = st["registry_loads"] - before["registry_loads"]
            evicted = (st["evictions"]["capacity"]
                       - before["evictions"]["capacity"])
            n_tok = sum(len(r.tokens) for r in res)
            log(f"{tag}: wave {w + 1} under {list(wave)}: {n_tok} tokens in "
                f"{wall:.3f}s = {n_tok / wall:.1f} tokens/s (end to end; the "
                f"f32 phase's traffic: {f32['tokens_s']:.1f}); registry "
                f"loads {loads}, capacity evictions {evicted}; residents "
                f"{bank.names()}")
            for t in timings[n_faults:]:
                log(f"{tag}: fault-in of {t['name']} ({t['pages']} pages): "
                    f"{t['total_ms']:.3f} host ms = disk read "
                    f"{t['read_ms']:.3f} + install {t['install_ms']:.3f} + "
                    f"synchronise {t['sync_ms']:.3f}")
            check(loads == len(timings) - n_faults and loads >= (
                4 if w == 0 else 2), f"{tag}: wave {w + 1} faulted in "
                f"{loads} adapters")
            check(w == 0 or evicted >= 2, f"{tag}: wave {w + 1} evicted "
                  f"{evicted} cold adapters for capacity")
            check(all(len(r.tokens) == NEW_TOKENS for r in res),
                  f"{tag}: wave {w + 1}: a request stopped short")
            layout = {n: bank._resident[n].pages for n in wave}
            arrays = {n: bank.adapter_arrays(n) for n in wave}
            publish_at(ref_bank, layout, factors)
            want = [f.result(timeout=600) for f in submit_together(
                ref, prompts, adapters=names)]
            same = sum(a.tokens == b.tokens for a, b in zip(res, want))
            log(f"{tag}: wave {w + 1} at pages {layout}: {same} of "
                f"{len(res)} streams bit-identical to the resident bank's")
            check(same == len(res), f"{tag}: wave {w + 1}: streams differ "
                  "from the resident bank's")
            for i, (p, r, a) in enumerate(zip(prompts, res, names)):
                verdict = check_greedy(model, params, p, r.tokens,
                                       F32_LOGIT_TOL,
                                       f"{tag} wave {w + 1} request {i}",
                                       lora=arrays[a])
                if verdict != "identical":
                    log(f"{tag}: wave {w + 1} request {i} ({a}) greedy vs "
                        f"oracle: {verdict}")
        launches = kernels.launch_counts()
        add(launches)
        fl.disable()
        server.shutdown()
        ref.shutdown()
        st = bank.stats()
        log(f"{tag}: bank {st}; adapter.fault_in events {len(events)} "
            f"(last {events[-1]['attrs'] if events else None}); launches "
            f"{launches}")
        check(len(events) == st["registry_loads"] == len(timings),
              f"{tag}: {len(events)} fault-in events for "
              f"{st['registry_loads']} registry loads")
        check(launches.get("flat_attention", 0) > 0,
              f"{tag}: the flat attention kernel never ran")
        check_graph_steps(tag, server.engine, progs, calls, builds)
        check_graph_steps(f"{tag} resident", ref.engine, ref_progs,
                          ref_calls, builds)
        check(st["in_use"] == 0 and bank.check(),
              f"{tag}: the bank did not drain")
        read = [t["read_ms"] for t in timings]
        total = [t["total_ms"] for t in timings]
        log(f"{tag}: {len(timings)} fault-ins: host ms p50 "
            f"{np.percentile(total, 50):.3f} max {max(total):.3f}; disk "
            f"read p50 {np.percentile(read, 50):.3f} ms")
        del server, ref, ref_bank
        # (c) int8 KV + int8 weights under fault-in
        tag = "registry int8"
        bank8 = AdapterBank(L, d, device=DEVICE, registry=AdapterRegistry(
            root, num_shards=2), **LORA_BANK)
        timings = time_fault_ins(bank8)
        server = LLMServer(model, np_params, name="gpt2-registry-int8",
                           max_seqs=MAX_SEQS, block_size=BLOCK_SIZE,
                           adapter_bank=bank8, kv_dtype="int8",
                           weight_dtype="int8", device=DEVICE)
        builds, progs, calls = warm_server(torch, server, tag)
        names = [n for n in REGISTRY_INT8_WAVE for _ in (0, 1)]
        prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
                   for n in REGISTRY_PROMPT_LENS]
        server.start()
        kernels.reset_launch_counts()
        res = [f.result(timeout=600) for f in submit_together(
            server, prompts, adapters=names)]
        launches = kernels.launch_counts()
        add(launches)
        layout = {n: bank8._resident[n].pages for n in REGISTRY_INT8_WAVE}
        for t in timings:
            log(f"{tag}: fault-in of {t['name']} ({t['pages']} pages): "
                f"{t['total_ms']:.3f} host ms = disk read "
                f"{t['read_ms']:.3f} + install {t['install_ms']:.3f} + "
                f"synchronise {t['sync_ms']:.3f}")
        loads = bank8.stats()["registry_loads"]
        # the same wave again, every adapter published resident (no
        # registry read) at the pages the fault-ins gave it
        bank8._registry = None
        publish_at(bank8, layout, factors)
        again = [f.result(timeout=600) for f in submit_together(
            server, prompts, adapters=names)]
        server.shutdown()
        same = sum(a.tokens == b.tokens for a, b in zip(res, again))
        log(f"{tag}: {len(res)} requests under {list(REGISTRY_INT8_WAVE)}, "
            f"{loads} registry loads; launches {launches}; {same} of "
            f"{len(res)} streams bit-identical to the same wave over the "
            f"adapters published resident at the same pages")
        check(loads == len(REGISTRY_INT8_WAVE),
              f"{tag}: {loads} registry loads")
        check(launches.get(kernel_name(torch.int8), 0) > 0
              and launches.get(wq_name(torch.int8), 0) > 0,
              f"{tag}: the int8 flat attention or matmul kernel never ran")
        check(same == len(res) and all(
            len(r.tokens) == NEW_TOKENS and all(
                0 <= t < model.vocab_size for t in r.tokens) for r in res),
            f"{tag}: the fault-in streams differ from the resident ones "
            "or left the vocabulary")
        check_graph_steps(tag, server.engine, progs, calls, builds)
        check(bank8.stats()["in_use"] == 0 and bank8.check(),
              f"{tag}: the bank did not drain")
    finally:
        fl.disable()
        shutil.rmtree(root, ignore_errors=True)
    return counts


# ------------------------------------------- the decoder artifact (5g) --
ARTIFACT_PROMPT_LENS = (15, 64, 200, 511)


def run_artifact_phase(torch, rng, np_params, kernels):
    """The decoder artifact at GPT-2-small widths: ``deploy.
    export_decoder`` of the f32 params and of int8 and fp8
    ``QuantizedWeights`` to a file, ``deploy.load_decoder`` onto the
    card, an ``LLMServer`` over what it loaded: the loaded weights are
    the in-memory ones' bits on the card, and the greedy streams
    (``submit_together``) bit-identical to a server built on the
    in-memory params with the same packs; every dispatch one replay,
    nothing built or captured after warmup. Logs each artifact's bytes
    and the export and load ms. Returns the launch counts."""
    import shutil
    import tempfile
    from mxnet_tpu_torch import deploy
    from mxnet_tpu_torch.ops.quantization import kernel_name as wq_name
    from mxnet_tpu_torch.serving.llm import (LLMServer, TinyDecoder,
                                             quantize_weights)
    from mxnet_tpu_torch.serving.llm.quant import flatten_params
    counts = {}
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
               for n in ARTIFACT_PROMPT_LENS]
    root = tempfile.mkdtemp(prefix="mxt-artifact-")
    try:
        for wd in (None, "int8", "float8_e4m3fn"):
            tag = f"artifact {wd or 'f32'}"
            params = np_params if wd is None else quantize_weights(
                np_params, dtype=wd)
            path = os.path.join(root, "decoder.mxtpu")
            t0 = time.monotonic()
            deploy.export_decoder(model, params, path)
            t_export = time.monotonic() - t0
            t0 = time.monotonic()
            m2, p2 = deploy.load_decoder(path, device=DEVICE)
            torch.cuda.synchronize()
            t_load = time.monotonic() - t0
            log(f"{tag}: {os.path.getsize(path) / 1e6:.1f} MB artifact, "
                f"export {t_export * 1e3:.0f} ms, load onto the card "
                f"{t_load * 1e3:.0f} ms; config {m2.config.to_dict()}")
            check(m2.config.to_dict() == model.config.to_dict(),
                  f"{tag}: the config did not round-trip")
            streams = {}
            for label, (mm, pp) in (("artifact", (m2, p2)),
                                    ("in-memory", (model, params))):
                server = LLMServer(mm, pp, name=f"gpt2-{label}-{wd}",
                                   max_seqs=MAX_SEQS, block_size=BLOCK_SIZE,
                                   device=DEVICE)
                builds, progs, calls = warm_server(torch, server,
                                                   f"{tag} {label}")
                server.start()
                kernels.reset_launch_counts()
                res = [f.result(timeout=600) for f in
                       submit_together(server, prompts)]
                launches = kernels.launch_counts()
                server.shutdown()
                check_graph_steps(f"{tag} {label}", server.engine, progs,
                                  calls, builds)
                streams[label] = [r.tokens for r in res]
                if label == "artifact":
                    for k, v in launches.items():
                        counts[k] = counts.get(k, 0) + v
                    loaded = server.engine
                    log(f"{tag}: launches {launches}")
                    check(wd is None or launches.get(
                        wq_name(getattr(torch, wd)), 0) > 0,
                        f"{tag}: the quantized matmul never ran")
                else:
                    mine = flatten_params(server.engine.params)
                    theirs = flatten_params(loaded.params)
                    diff = [k for k in mine if not torch.equal(
                        mine[k].view(torch.uint8), theirs[k].view(
                            torch.uint8))]
                    if server.engine.w_scales is not None:
                        diff += [k for k, v in server.engine.w_scales
                                 .items() if not torch.equal(
                                     v, loaded.w_scales[k])]
                    check(not diff, f"{tag}: loaded weights differ from "
                          f"the in-memory ones at {diff[:4]}")
                del server
            same = sum(a == b for a, b in zip(streams["artifact"],
                                              streams["in-memory"]))
            log(f"{tag}: {same} of {len(prompts)} greedy streams "
                f"bit-identical to the in-memory params' server")
            check(same == len(prompts) and all(
                len(t) == NEW_TOKENS for t in streams["artifact"]),
                f"{tag}: the artifact's streams differ")
            del loaded, m2, p2
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return counts


# ----------------------------------------------------- the fleet (5h) --
def make_bert_encoder(flash=True, **cfg):
    """BERT (dropout off) serving its pooled output: ``forward(token ids
    (B, T), int) -> pooled (B, units)``, phase 5h's encode model."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.model_zoo.bert import BERTModel

    class PooledBert(gluon.HybridBlock):
        def __init__(self):
            super().__init__()
            with self.name_scope():
                self.bert = BERTModel(dropout=0.0, flash=flash, **cfg)

        def forward(self, tokens):
            return self.bert(tokens)[1]
    return PooledBert()


def encode_server(block, name):
    """``ModelServer`` over an encoder block: items of ``ENCODE_T`` int32
    token ids, buckets ``ENCODE_BUCKETS``."""
    from mxnet_tpu_torch.serving import ModelServer
    return ModelServer(block, buckets=list(ENCODE_BUCKETS),
                       max_delay_ms=2.0, item_shape=(ENCODE_T,),
                       dtype="int32", name=name)


def encode_builder(cfg, name):
    """The encode entry's builder: a fresh encoder on the card with the
    published arrays (host numpy by name) copied in, behind a new
    server."""
    from mxnet_tpu_torch.convert import load_gluon_params
    from mxnet_tpu_torch.initializer import Zero

    def build(arrays):
        block = make_bert_encoder(**cfg)
        block.initialize(Zero(), device=DEVICE)
        load_gluon_params(block, arrays)
        return encode_server(block, name)
    return build


def replica(server):
    """What holds a replica's graphs: an ``LLMServer``'s engine, or the
    ``ModelServer`` itself (``programs()``, ``graph_pool_bytes()``)."""
    return server.engine if hasattr(server, "engine") else server


def graphs_of(server):
    return replica(server).programs()["graphs"]


def capture_seconds(server):
    cs = replica(server).programs()["capture_seconds"]
    return sum(cs.values()) if isinstance(cs, dict) else cs


def replays_are_dispatches(tag, server):
    """Every dispatch of ``server`` (an LLM engine's steps, a model
    server's batches) was one graph replay."""
    progs = replica(server).programs()
    check(progs["dispatches"] > 0 and progs["replays"]
          == progs["dispatches"], f"{tag}: {progs['replays']} replays for "
          f"{progs['dispatches']} dispatches")
    return progs


def gated_publish(torch, router, model, publish):
    """Run ``publish()`` (a ``router.publish`` or a publisher's round)
    on a thread of its own, parked at the ``fleet.drain`` point (the
    route already on the new replica, the old not yet quiesced) while
    both replicas' graph pools, capture seconds and the device's
    allocated bytes are read. Returns (publish's result, the reading,
    the publish's wall seconds)."""
    import threading
    from mxnet_tpu_torch.resilience import faults
    gate = faults.block_at("fleet.drain")
    out = {}

    def run():
        try:
            out["result"] = publish()
        except BaseException as exc:       # re-raised on this thread
            out["error"] = exc
    t0 = time.monotonic()
    th = threading.Thread(target=run, name="mxt-smoke-publish")
    th.start()
    seen = None
    try:
        if gate.wait_reached(900):
            entry = router._models[model]
            old, new = entry.active.server, entry.route.server
            torch.cuda.synchronize()
            seen = dict(old_pool=replica(old).graph_pool_bytes(),
                        new_pool=replica(new).graph_pool_bytes(),
                        new_graphs=graphs_of(new),
                        capture_s=capture_seconds(new),
                        allocated=torch.cuda.memory_allocated())
    finally:
        gate.release()
        th.join(900)
        faults.reset()
    if "error" in out:
        raise out["error"]
    check(seen is not None, f"{model}: the publish never reached its "
          "drain")
    return out["result"], seen, time.monotonic() - t0


def publish_line(tag, router, seen, wall):
    log_ = router.last_publish
    log(f"{tag}: publish v{log_['version']} in {wall:.2f}s: phases "
        + ", ".join(f"{p} {s:.3f}s" for p, s in log_["phases"].items())
        + f"; builds + captures by phase {log_['compiles']}; the new "
        f"replica's {seen['new_graphs']} graphs captured in "
        f"{seen['capture_s']:.2f}s, graph pool "
        f"{seen['new_pool'] / 1e6:.1f} MB; during the drain the old "
        f"replica's pool {seen['old_pool'] / 1e6:.1f} MB beside it, device "
        f"memory allocated {seen['allocated'] / 1e9:.2f} GB")


class FleetPump:
    """Threads submitting through a router until stopped: ``chat``
    threads 2 prompts at a time (8 to 96 tokens, ``FLEET_NEW_TOKENS``
    greedy), ``encode`` threads bursts of 4 samples; each waits for its
    own. Every request lands in ``records`` as (done time, kind,
    outcome, tokens, latency s): outcome ``served``, ``shed``,
    ``evicted``, ``expired`` or ``error:<type>``."""

    def __init__(self, router, vocab, seed):
        import threading
        self.router, self.vocab, self.seed = router, vocab, seed
        self.stop = threading.Event()
        self.lock = threading.Lock()
        self.records = []
        self.threads = []

    def start(self, kind):
        """Two threads submitting ``kind`` requests."""
        import threading
        for i in range(2):
            th = threading.Thread(target=self._run, args=(
                kind, self.seed + len(self.threads)),
                name=f"mxt-smoke-{kind}{i}")
            self.threads.append(th)
            th.start()

    def _record(self, kind, outcome, tokens, t0):
        now = time.monotonic()
        with self.lock:
            self.records.append((now, kind, outcome, tokens, now - t0))

    def _run(self, kind, seed):
        from mxnet_tpu_torch.serving import (
            DeadlineExceededError, Overloaded, SequenceEvictedError)
        rng = np.random.RandomState(seed)
        while not self.stop.is_set():
            if kind == "chat":
                args = [(rng.randint(0, self.vocab, size=rng.randint(
                    8, 97)).tolist(), FLEET_NEW_TOKENS) for _ in range(2)]
            else:
                args = [(rng.randint(0, BERT_BASE["vocab_size"],
                                     size=ENCODE_T).astype(np.int32),)
                        for _ in range(4)]
            pending = []
            for a in args:
                t0 = time.monotonic()
                try:
                    pending.append((self.router.submit(kind, *a), t0))
                except Overloaded:
                    self._record(kind, "shed", 0, t0)
                except Exception as exc:
                    self._record(kind, f"error:{exc!r}", 0, t0)
            for fut, t0 in pending:
                try:
                    res = fut.result(timeout=600)
                    self._record(kind, "served", len(res.tokens)
                                 if kind == "chat" else 1, t0)
                except SequenceEvictedError:
                    self._record(kind, "evicted", 0, t0)
                except DeadlineExceededError:
                    self._record(kind, "expired", 0, t0)
                except Overloaded:
                    self._record(kind, "shed", 0, t0)
                except Exception as exc:
                    self._record(kind, f"error:{exc!r}", 0, t0)

    def finish(self):
        self.stop.set()
        for th in self.threads:
            th.join(900)
            check(not th.is_alive(), f"{th.name} did not stop")

    def rates(self, kind, windows):
        """Per window ``(name, t0, t1)``: served tokens (chat) or
        requests (encode) a second."""
        return {name: sum(r[3] for r in self.records if r[1] == kind
                          and r[2] == "served" and t0 <= r[0] < t1)
                / max(t1 - t0, 1e-9) for name, t0, t1 in windows}


def run_fleet_phase(torch, rng, np_params, kernels):
    """Phase 5h: one ``FleetRouter`` over two full-width models, the chat
    ``LLMServer`` at GPT-2-small widths (f32 pools, ``np_params``, the f32
    phase's ``MAX_SEQS``/``BLOCK_SIZE``; K1 through its captured step)
    and the encode ``ModelServer`` over BERT-base (seeded Xavier as
    phase 8, dropout off) serving the pooled ``(B, 768)`` output of 128
    int32 token ids, buckets 1, 2, 4, 8 (K6 inside each bucket's graph).

    (a) ragged bursts of 1 to 8 concurrent encode requests: each batch
    row bit-identical to the same sample alone through the same bucket's
    graph, every output within ``ENCODE_REL_TOL`` (K6's) of the plain path
    (``flash=False``, eager), no build or capture, one replay a batch,
    ``bucket_hits`` summing to the batches;
    (b) chat v2 (seed 1) written through a 2-shard checkpoint and
    published with ``ckpt_dir=`` while two threads per model submit:
    every Future typed, the partition summing to what was submitted, the
    post-swap greedy streams the oracle's over v2, the pool clean;
    (c) ``FineTunePublisher`` on the encoder v1 serves: 2 Adam steps of
    ``L2Loss`` on the pooled outputs against seeded targets (K6, K7a,
    K7b, one update launch a step; the v1 replica keeps serving its
    snapshot bit for bit meanwhile), a sync 2-shard checkpoint, the
    publish; the served outputs the trained block's within
    ``ENCODE_REL_TOL``, the same bits on two replays;
    (d) across (b) and (c): no build, captures only in each publish's
    warm phase (the new replica's graphs), every dispatch of every
    replica one replay;
    (e) a publish killed at ``fleet.publish:drain`` rolls back (the same
    streams before and after, admission open); the router's quota sheds
    a greedy tenant typed while another tenant's streams stay the same;
    (f) each publish's phase seconds, capture seconds and graph pools
    (both replicas' during the drain), tokens/s and encode requests/s
    before, during and after the swap, encode p50/p99 latency and the
    device busy share of a profiled encode pass. Returns the launch
    counts of the phase's serving and training."""
    import shutil
    import tempfile
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import deploy, gluon
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.ops.flash_attention import KERNEL_NAMES
    from mxnet_tpu_torch.ops.ragged_attention import kernel_name
    from mxnet_tpu_torch.resilience import CheckpointManager, faults
    from mxnet_tpu_torch.resilience.faults import InjectedCrash
    from mxnet_tpu_torch.serving import (FineTunePublisher, FleetRouter,
                                         Overloaded, pad_batch)
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    from mxnet_tpu_torch.serving.telemetry import compile_count
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    cfg = dict(BERT_BASE, max_length=ENCODE_T)
    flat, fwd = kernel_name(torch.float32), KERNEL_NAMES[0]
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)

    def chat_builder(name):
        def build(arrays):
            return LLMServer(model, deploy.params_from_arrays(arrays),
                             name=name, max_seqs=MAX_SEQS,
                             block_size=BLOCK_SIZE, device=DEVICE)
        return build
    t0 = time.monotonic()
    chat = chat_builder("fleet-chat-v1")(deploy.flatten_params(np_params))
    chat.warmup()
    enc = make_bert_encoder(**cfg)
    enc.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
    with ag.pause():                     # materialise the deferred shapes
        enc(torch.zeros((1, ENCODE_T), dtype=torch.int32, device=DEVICE))
    encode = encode_server(enc, "fleet-encode-v1")
    encode.warmup()
    check(graphs_of(encode) == len(ENCODE_BUCKETS),
          f"fleet: {graphs_of(encode)} encode graphs after warmup")
    router = FleetRouter(name="fleet-5h", quota_rps=0.05, quota_burst=3)
    router.add_model("chat", chat.start(), version=1,
                     builder=chat_builder("fleet-chat"))
    router.add_model("encode", encode.start(), version=1,
                     builder=encode_builder(cfg, "fleet-encode"))
    log(f"fleet: chat v1 ({graphs_of(chat)} graphs captured idle in "
        f"{capture_seconds(chat):.2f}s, pool "
        f"{replica(chat).graph_pool_bytes() / 1e6:.1f} MB) and encode v1 "
        f"(buckets "
        f"{list(ENCODE_BUCKETS)} x {ENCODE_T} tokens, {graphs_of(encode)} "
        f"graphs in {capture_seconds(encode):.2f}s, pool "
        f"{encode.graph_pool_bytes() / 1e6:.1f} MB) behind one router, "
        f"set up "
        f"in {time.monotonic() - t0:.2f}s")
    root = tempfile.mkdtemp(prefix="mxt-fleet-")
    try:
        # (a) batching is invisible
        backend = encode._fn
        seen = []

        def recorded(batch):
            out = backend(batch)
            seen.append((batch.copy(), out.copy()))
            return out
        encode._fn = recorded
        samples = rng.randint(0, cfg["vocab_size"], size=(
            72, ENCODE_T)).astype(np.int32)
        compiles, st0 = compile_count(), encode.stats()
        progs0 = encode.programs()
        kernels.reset_launch_counts()
        served, i = [], 0
        for k in itertools.chain(range(1, 9), range(8, 0, -1)):
            futs = [router.submit("encode", x) for x in samples[i:i + k]]
            served += [f.result(timeout=600) for f in futs]
            i += k
        launches = kernels.launch_counts()
        add(launches)
        encode._fn = backend
        st, progs = encode.stats(), encode.programs()
        batches = st["batches"] - st0["batches"]
        replays = progs["replays"] - progs0["replays"]
        check(compile_count() == compiles, "fleet (a): a build or capture "
              "after warmup")
        check(replays == batches == progs["dispatches"]
              - progs0["dispatches"] == len(seen),
              f"fleet (a): {replays} replays for {batches} batches")
        check(sum(st["bucket_hits"].values()) == st["batches"],
              "fleet (a): bucket hits do not sum to the batches")
        check(launches.get(fwd, 0) == cfg["num_layers"] * replays,
              f"fleet (a): {launches.get(fwd, 0)} {fwd} launches for "
              f"{replays} replays")
        same = rows = 0
        for padded, out in seen:
            n = next((j for j in range(len(padded), 0, -1)
                      if padded[j - 1].any()), 0)
            for j in range(n):
                alone = backend(pad_batch(padded[j:j + 1], len(padded)))
                rows += 1
                same += bool(np.array_equal(alone[0], out[j]))
        set_flash(enc, False)
        with ag.pause():
            plain = enc(torch.from_numpy(samples[:i]).to(DEVICE)) \
                .cpu().numpy()
        set_flash(enc, True)
        err = float(np.abs(np.stack(served) - plain).max()
                    / np.abs(plain).max())
        log(f"fleet (a): {i} encode requests in bursts of 1..8..1: "
            f"{batches} batches, bucket hits {st['bucket_hits']}, "
            f"{replays} replays, {launches.get(fwd, 0)} {fwd} launches; "
            f"{same} of {rows} batch rows bit-identical to the sample "
            f"alone through its bucket's graph; served vs the plain path "
            f"(flash=False): max relative error {err:.3e} (tol "
            f"{ENCODE_REL_TOL})")
        check(same == rows == i, "fleet (a): a batched row differs from "
              "the sample alone through the same graph")
        check(err <= ENCODE_REL_TOL, "fleet (a): served encodings "
              "disagree with the plain path")
        # (b) chat v2 through a 2-shard checkpoint, under load
        builds, compiles = kernels.build_count(), compile_count()
        old_chat, old_encode = chat, encode
        np_v2 = model.init_params_numpy(1)
        t0 = time.monotonic()
        ckpt = CheckpointManager(os.path.join(root, "chat"), async_=False,
                                 num_shards=2).save(
            deploy.flatten_params(np_v2), step=1)
        log(f"fleet (b): chat v2 (seed 1) written as a 2-shard "
            f"checkpoint in {time.monotonic() - t0:.2f}s")
        del np_v2
        kernels.reset_launch_counts()
        pump = FleetPump(router, model.vocab_size, 50)
        t_start = time.monotonic()
        pump.start("chat")
        pump.start("encode")
        time.sleep(FLEET_PUMP_S)
        t_pub = time.monotonic()
        _, chat_seen, chat_wall = gated_publish(
            torch, router, "chat",
            lambda: router.publish("chat", 2, ckpt_dir=ckpt))
        t_done = time.monotonic()
        time.sleep(FLEET_PUMP_S)
        pump.finish()
        t_end = time.monotonic()
        publish_line("fleet (b) chat", router, chat_seen, chat_wall)
        chat_log = router.last_publish
        parts = {}
        for r in pump.records:
            parts[(r[1], r[2])] = parts.get((r[1], r[2]), 0) + 1
        log(f"fleet (b): outcomes {dict(sorted(parts.items()))}")
        check(not [k for k in parts if k[1].startswith("error")],
              "fleet (b): a request resolved untyped")
        check(sum(parts.values()) == len(pump.records) and all(
            parts.get((k, "served"), 0) > 0 for k in ("chat", "encode")),
            "fleet (b): the partition does not cover the traffic")
        windows = (("before", t_start, t_pub), ("during", t_pub, t_done),
                   ("after", t_done, t_end))
        tok, req = pump.rates("chat", windows), pump.rates("encode",
                                                           windows)
        lat = [r[4] for r in pump.records
               if r[1] == "encode" and r[2] == "served"]
        log("fleet (b): chat tokens/s " + ", ".join(
            f"{k} {v:.1f}" for k, v in tok.items()) + "; encode "
            "requests/s " + ", ".join(f"{k} {v:.1f}" for k, v in
                                      req.items())
            + f"; encode latency p50 {np.percentile(lat, 50) * 1e3:.2f} "
            f"ms p99 {np.percentile(lat, 99) * 1e3:.2f} ms "
            f"({len(lat)} requests)")
        new_chat = router.server("chat")
        check(router.active_version("chat") == 2 and new_chat
              is not old_chat, "fleet (b): chat v2 is not serving")
        v2 = new_chat.engine.params
        for j, n in enumerate((15, 40, 100)):
            prompt = rng.randint(0, model.vocab_size, size=n).tolist()
            toks = router.generate("chat", prompt, FLEET_NEW_TOKENS,
                                   timeout=600).tokens
            verdict = check_greedy(model, v2, prompt, toks, F32_LOGIT_TOL,
                                   f"fleet (b) v2 request {j}")
            log(f"fleet (b): v2 request {j} (prompt {n}) greedy vs the "
                f"oracle over v2: {verdict}")
        check(new_chat.engine.cache.check(live_block_ids=[]),
              "fleet (b): the v2 pool is not clean")
        # (c) fine-tune the encoder v1 serves, publish it
        probe = samples[:1][0]
        before = router.predict("encode", probe, timeout=600)
        trainer = gluon.Trainer(enc.collect_params(), "adam",
                                {"learning_rate": BERT_LR})
        loss_fn = gluon.loss.L2Loss()
        x_train = torch.from_numpy(samples[:8]).to(DEVICE)
        y_train = torch.from_numpy(rng.randn(8, cfg["units"]).astype(
            np.float32)).to(DEVICE)
        losses, steps, during = [], {}, []

        def train_step():
            c0 = kernels.launch_counts()
            with ag.record():
                out = loss_fn(enc(x_train), y_train)
            out.backward(torch.ones_like(out))
            trainer.step(len(x_train))
            losses.append(float(out.detach().mean()))
            c1 = kernels.launch_counts()
            for k in c1:
                steps[k] = steps.get(k, []) + [c1[k] - c0.get(k, 0)]
            # v1 serves its snapshot, not the block being trained
            during.append(router.predict("encode", probe, timeout=600))

        def get_arrays():
            return {k: p.data().detach()
                    for k, p in enc.collect_params().items()}
        pub = FineTunePublisher(router, "encode", train_step, get_arrays,
                                os.path.join(root, "encode"),
                                steps_per_publish=2, num_shards=2,
                                version_start=2)
        _, enc_seen, enc_wall = gated_publish(torch, router, "encode",
                                              pub.run_once)
        check(len(during) == 2 and all(np.array_equal(before, d)
                                       for d in during),
              "fleet (c): a Trainer step on the block changed what v1 "
              "serves")
        publish_line("fleet (c) encode", router, enc_seen, enc_wall)
        enc_log = router.last_publish
        log(f"fleet (c): 2 Adam steps, loss {losses[0]:.5f} -> "
            f"{losses[1]:.5f}; launches a step "
            + ", ".join(f"{k} {v}" for k, v in sorted(steps.items())))
        for k in KERNEL_NAMES:
            check(steps.get(k) == [cfg["num_layers"]] * 2,
                  f"fleet (c): {k} launched {steps.get(k)} times a step")
        check(steps.get("adam_update") == [1, 1], "fleet (c): "
              f"adam_update launched {steps.get('adam_update')} a step")
        new_enc = router.server("encode")
        check(router.active_version("encode") == 2 and new_enc
              is not old_encode, "fleet (c): encode v2 is not serving")
        probes = samples[8:16]
        got = np.stack([router.predict("encode", x, timeout=600)
                        for x in probes])
        again = np.stack([router.predict("encode", x, timeout=600)
                          for x in probes])
        add(kernels.launch_counts())
        with ag.pause():
            want = enc(torch.from_numpy(probes).to(DEVICE)).cpu().numpy()
        err = float(np.abs(got - want).max() / np.abs(want).max())
        same = np.array_equal(got, again)
        log(f"fleet (c): encode v2 served vs the trained block's forward: "
            f"max relative error {err:.3e} (tol {ENCODE_REL_TOL}); two "
            f"replays {'bit-identical' if same else 'DIFFER'}")
        check(err <= ENCODE_REL_TOL, "fleet (c): encode v2 does not serve "
              "the trained weights")
        check(same, "fleet (c): two replays of a bucket differ")
        # (d) counting across (b) and (c)
        warm = chat_log["compiles"]["warm"] + enc_log["compiles"]["warm"]
        log(f"fleet (d): builds {kernels.build_count() - builds}, captures "
            f"{compile_count() - compiles} (warm phases: chat "
            f"{chat_log['compiles']['warm']} = its ladder "
            f"{chat_seen['new_graphs']}, encode "
            f"{enc_log['compiles']['warm']} = its buckets "
            f"{enc_seen['new_graphs']})")
        check(kernels.build_count() == builds, "fleet (d): a kernel was "
              "built")
        check(compile_count() - compiles == warm
              and chat_log["compiles"]["warm"] == chat_seen["new_graphs"]
              and enc_log["compiles"]["warm"] == enc_seen["new_graphs"]
              == len(ENCODE_BUCKETS)
              and not any(v for lg in (chat_log, enc_log)
                          for p, v in lg["compiles"].items()
                          if p != "warm"),
              "fleet (d): a capture outside a publish's warm phase")
        for tag, srv in (("chat v1", old_chat), ("chat v2", new_chat),
                         ("encode v1", old_encode),
                         ("encode v2", new_enc)):
            progs = replays_are_dispatches(f"fleet (d) {tag}", srv)
            log(f"fleet (d): {tag}: {progs['dispatches']} dispatches, "
                f"{progs['replays']} replays")
        # where the time goes: one profiled encode pass (6 bursts of 8;
        # the wall from inside the profiler, its start and stop left out)
        st0 = new_enc.stats()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            for b in range(6):
                futs = [router.submit("encode", x)
                        for x in samples[16 + 8 * b:24 + 8 * b]]
                for f in futs:
                    f.result(timeout=600)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        report_profile(prof, wall,
                       new_enc.stats()["batches"] - st0["batches"])
        # (e) a killed publish rolls back; the quota sheds one tenant
        prompts = [rng.randint(0, model.vocab_size, size=n).tolist()
                   for n in CHAOS_PROMPTS[:3]]   # no prefix hit

        def streams(tenant=None):
            srv = router.server("chat")
            with srv._cv:        # one admission: the same packs each run
                futs = [router.submit("chat", p, FLEET_NEW_TOKENS,
                                      tenant=tenant) for p in prompts]
            return [f.result(timeout=600).tokens for f in futs]
        kernels.reset_launch_counts()
        first = streams()
        faults.crash_at_point("fleet.publish:drain")
        try:
            router.publish("chat", 3,
                           arrays=deploy.flatten_params(np_params))
            check(False, "fleet (e): the publish was not killed")
        except InjectedCrash:
            pass
        finally:
            faults.reset()
        killed = router.last_publish
        check(router.active_version("chat") == 2 and router.server("chat")
              is new_chat and new_chat.admitting, "fleet (e): the killed "
              "publish did not roll back")
        rolled = streams()
        greedy_futs, shed = [], 0
        for _ in range(4):
            try:
                greedy_futs.append(router.submit(
                    "chat", prompts[0], FLEET_NEW_TOKENS, tenant="greedy"))
            except Overloaded as exc:
                check(exc.reason == "quota", f"fleet (e): shed {exc.reason}")
                shed += 1
        for f in greedy_futs:
            f.result(timeout=600)
        polite = streams("polite")
        add(kernels.launch_counts())
        log(f"fleet (e): publish killed at drain after phases "
            f"{list(killed['phases'])} (builds + captures "
            f"{killed['compiles']}); streams after the rollback "
            f"{'bit-identical' if rolled == first else 'DIFFER'}; greedy "
            f"tenant: {len(greedy_futs)} admitted, {shed} shed (quota); "
            f"the polite tenant's streams "
            f"{'bit-identical' if polite == first else 'DIFFER'}")
        check(rolled == first, "fleet (e): streams changed across the "
              "rolled-back publish")
        check(shed == 1 and polite == first, "fleet (e): the quota did "
              "not isolate the greedy tenant")
        check(new_chat.engine.cache.check(live_block_ids=[]),
              "fleet (e): the pool is not clean")
        check(counts.get(flat, 0) > 0 and counts.get(fwd, 0) > 0,
              "fleet: K1 or K6 never ran")
    finally:
        router.shutdown()
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return counts


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
    # nd returns NDArrays; the checks below read their tensors (DLPack,
    # no copy)
    def tensor(a):
        return a if isinstance(a, torch.Tensor) else torch.from_dlpack(a)
    got3 = tensor(nd.ragged_paged_attention(q3, kp, vp, bt, kv))
    got4 = tensor(nd.ragged_paged_attention(q4, kp, vp, bt, kv, q_lens=ql))
    got16 = {dt: (tensor(nd.ragged_paged_attention(a3, k16, v16, bt, kv)),
                  tensor(nd.ragged_paged_attention(a4, k16, v16, bt, kv,
                                                   q_lens=ql)))
             for dt, (k16, v16, a3, a4) in lowp.items()}
    got_mix = {k: tensor(call()) for k, (call, _, _) in mixes.items()}
    got_sdpa = tensor(nd.scaled_dot_product_attention(*sdpa_in))
    got_rtc = {"scale_add": tensor(getattr(nd, names["scale_add"])(x, y)),
               "rowsum": tensor(getattr(nd, names["rowsum"])(x))}
    xg = x.detach().clone().requires_grad_()
    with ag.record():
        sq = getattr(nd, names["square"])(xg)
        sq.sum().backward()
    got_rtc["square"] = tensor(sq)
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
    import torch
    from mxnet_tpu_torch import autograd as ag

    def hook(mod, inputs, out):
        if gate is None:
            pre[flash] = inputs[0].detach().float()
            return None
        return inputs[0] * gate.to(inputs[0].dtype)
    set_flash(net, flash)
    # torch's own hook (its return value replaces the output); gluon's
    # register_forward_hook has the reference's, which ignores it
    handle = torch.nn.Module.register_forward_hook(net.transform.act, hook)
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
    EAGER_ROWS[label] = summary = dict(
        step_ms=step_ms, tokens_s=batch * seqlen / step_ms * 1e3,
        peak_gb=peak_gb, device_ms=device_rows(prof)[1] / 1e3 / 2,
        idle=None if share is None else 1 - share, **split)
    return launches, summary


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
    if name == "ftml_update":          # FTML names its clip clip_grad
        kw["clip_grad"] = kw.pop("clip_gradient")
    return kw


def update_case(torch, name, shapes, wdtype, dev, seed, offset=0):
    """Op ``name``'s tensor inputs for each shape, made on ``dev`` from
    ``seed``: weight and gradient (in ``wdtype`` for an mp op, whose f32
    master copy is the weight's value, and for a low16 op, whose states
    are in ``wdtype`` too), f32 states in their valid range
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
            states = {"mp_sgd_mom_update": ("small",),
                      "mp_nag_mom_update": ("small",),
                      "_mp_adamw_update": ("small", "positive")}
            xs += [make(shape, k) for k in states.get(name, ())]
            xs.append(w32)
        else:
            # a low16 rule on 16-bit weights: every input in their dtype
            dt = wdtype if rule.low16 else torch.float32
            xs = [make(shape, "normal", dt), make(shape, "normal", dt)]
            kinds = {"rmspropalex_update": ("positive", "small", "small"),
                     "ftrl_update": ("normal", "positive"),
                     "ftml_update": ("positive", "positive", "small")
                     }.get(name)
            if kinds is None:
                kinds = ("small" if "mom" in name or name == "signum_update"
                         else "positive", "positive")
            xs += [make(shape, k, dt) for k in kinds[:rule.n_in - 2]]
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
    # every rule but extra.py's three, whose optimizers (FTML, mp NAG, mp
    # AdamW) the port has not yet (ROADMAP §1 item 13): phase 7b drives
    # those through nd
    want = set(RULES) - set(EXTRA_RULES)
    check(set(totals) >= want, "optimizer path: rules never "
          f"launched: {sorted(want - set(totals))}")
    del net, params, grads
    torch.cuda.empty_cache()
    return totals


# template arguments that are builtin types, as the Itanium ABI mangles them
# --------------------------------------- the Trainer checkpoint (8c) --
CKPT_SHARDS, CKPT_KEEP = 4, 2


# --------------------------------------- phase 7b: the framework core --
DRAWS = 1 << 20
# BERT-base's activation, the shape phase 7b's large cases take
CORPUS_BERT_SHAPE = (BERT_BATCH, BERT_T, 768)
# the update tail at BERT-base: (op, the kernel rule it runs, 16-bit
# weights or None)
TAIL_OPS = (
    ("multi_sgd_update", "sgd_update", None),
    ("multi_sgd_mom_update", "sgd_mom_update", None),
    ("multi_mp_sgd_update", "mp_sgd_update", "bfloat16"),
    ("multi_mp_sgd_mom_update", "mp_sgd_mom_update", "bfloat16"),
    ("preloaded_multi_sgd_update", "sgd_update", None),
    ("preloaded_multi_sgd_mom_update", "sgd_mom_update", None),
    ("preloaded_multi_mp_sgd_update", "mp_sgd_update", "bfloat16"),
    ("preloaded_multi_mp_sgd_mom_update", "mp_sgd_mom_update", "bfloat16"),
    ("_multi_adamw_update", "_adamw_update", None),
    ("_multi_mp_adamw_update", "_mp_adamw_update", "bfloat16"),
)
# steps on one batch (its loss falls), SGD momentum's lr (the gradient
# scaled by 1/batch, as Trainer.step(batch) scales it)
IMPERATIVE_STEPS, IMPERATIVE_LR = 3, 0.5


def corpus_call(torch, nd, name, inputs, kwargs, dev):
    """A corpus case's op through ``nd`` on ``dev``: (the NDArray inputs,
    the kwargs the op takes, the inputs to differentiate)."""
    kw = {k: v for k, v in kwargs.items() if not k.startswith("_")}
    arrays = [np.asarray(a, np.int32 if kwargs.get("_int_input")
                         else np.float32) for a in inputs]
    if "length" in kw:
        kw["length"] = torch.tensor(np.asarray(kw["length"], np.float32),
                                    device=dev)
    if kwargs.get("_lengths_as_params"):
        kw["data_lengths"], kw["label_lengths"] = (
            torch.from_numpy(a).to(dev) for a in arrays[2:4])
        arrays = arrays[:2]
    if "ctx" in kw:
        kw["ctx"] = dev
    xs = [nd.array(a, ctx=dev) for a in arrays]
    grad_inputs = kwargs.get("_grad_inputs", tuple(
        i for i, a in enumerate(arrays) if a.dtype == np.float32))
    return xs, kw, grad_inputs


def corpus_run(torch, nd, ag, op, name, inputs, kwargs, dev):
    """Forward outputs and, for a differentiable op, the gradients on a
    seeded cotangent (through ``autograd.grad``), as host float64."""
    xs, kw, grad_inputs = corpus_call(torch, nd, name, inputs, kwargs, dev)
    # sparse Embedding gradients wait for ndarray/sparse: forward only
    diff = op.differentiable and bool(grad_inputs) and \
        name != "_contrib_SparseEmbedding"
    if diff:
        for i in grad_inputs:
            xs[i].attach_grad()
    with ag.record(train_mode=False) if diff else ag.pause():
        out = getattr(nd, name)(*xs, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    host = [(o.shape, str(o.dtype), o.asnumpy().astype(np.float64))
            for o in outs]
    grads = []
    floats = [o for o in outs if o._data.is_floating_point()
              and o._data.requires_grad]
    if diff and floats:
        rs = np.random.RandomState(7)
        cots = [nd.array(np.asarray(rs.randn(*o.shape), np.float32),
                         ctx=dev) for o in floats]
        got = ag.grad(floats, [xs[i] for i in grad_inputs],
                      head_grads=cots)
        grads = [g.asnumpy().astype(np.float64) for g in got]
    return host, grads


def _close(got, want, rtol, atol):
    both = np.isnan(got) & np.isnan(want)
    same_inf = np.isinf(got) & (got == want)
    ok = both | same_inf | (np.abs(got - want) <= atol + rtol *
                            np.abs(want))
    return bool(ok.all())


def _sign_fixed(v):
    idx = np.argmax(np.abs(v), axis=-2)
    return v * np.sign(np.take_along_axis(v, idx[..., None, :], axis=-2))


def run_corpus_cases(torch, nd, ag, registry):
    """(a) every corpus case on CUDA and on CPU NDArrays: outputs in
    shape, dtype and value, gradients in value. Returns (cases, op
    groups, failing case names)."""
    failed, groups = [], set()
    for name, inputs, kwargs, family in CORPUS:
        op = registry.get(name)
        groups.add(id(op))
        try:
            got, ggot = corpus_run(torch, nd, ag, op, name, inputs, kwargs,
                                   DEVICE)
            want, gwant = corpus_run(torch, nd, ag, op, name, inputs, kwargs,
                                     "cpu")
            ok = len(got) == len(want) and len(ggot) == len(gwant)
            rtol, atol = corpus_tol(op, family, True)
            for k, ((gs, gd, g), (ws, wd, w)) in enumerate(zip(got, want)):
                if name.endswith("syevd") and k == 1:
                    g, w = _sign_fixed(g), _sign_fixed(w)
                ok = ok and gs == ws and gd == wd and _close(g, w, rtol,
                                                             atol)
            if not name.endswith("syevd"):
                rtol, atol = corpus_tol(op, family, False)
                for g, w in zip(ggot, gwant):
                    ok = ok and g.shape == w.shape and _close(g, w, rtol,
                                                              atol)
        except Exception as exc:       # named below, then the phase fails
            log(f"7b: {name} raised {type(exc).__name__}: {exc}")
            ok = False
        if not ok:
            failed.append(name)
    return len(CORPUS), len(groups), failed


def bert_shape_cases(torch, nd, dtype):
    """(a) at BERT-base's activation shape: the elementwise, reduction,
    shape and normalization ops on the card against the CPU, each
    within ``tol`` of the output's largest magnitude (f32 1e-5, 1e-4 for
    the normalizations; bf16 one rounding, 2^-7). Returns the failing
    names and the worst error."""
    rs = np.random.RandomState(33)
    x = rs.randn(*CORPUS_BERT_SHAPE).astype(np.float32)
    b = rs.randn(CORPUS_BERT_SHAPE[-1]).astype(np.float32)
    g = (rs.rand(CORPUS_BERT_SHAPE[-1]) + 0.5).astype(np.float32)
    cases = [
        ("exp", (x * 0.5,), {}), ("tanh", (x,), {}), ("gelu", (x,), {}),
        ("sigmoid", (x,), {}), ("relu", (x,), {}), ("square", (x,), {}),
        ("sqrt", (np.abs(x),), {}), ("broadcast_add", (x, b[None, None]), {}),
        ("broadcast_mul", (x, g[None, None]), {}),
        ("_mul_scalar", (x,), {"scalar": 0.125}),
        ("sum", (x,), {"axis": -1}), ("mean", (x,), {"axis": (0, 1)}),
        ("max", (x,), {"axis": -1}), ("norm", (x,), {"axis": -1}),
        ("argmax", (x,), {"axis": -1}),
        ("reshape", (x,), {"shape": (0, -1, 12, 64)}),
        ("transpose", (x,), {"axes": (0, 2, 1)}),
        ("swapaxes", (x,), {"dim1": 0, "dim2": 1}),
        ("slice_axis", (x,), {"axis": 1, "begin": 3, "end": 300}),
        ("split", (x,), {"num_outputs": 3, "axis": -1}),
        ("concat", (x, x * 2), {"dim": -1}),
        ("softmax", (x,), {}), ("log_softmax", (x,), {"axis": -1}),
        ("LayerNorm", (x, g, b), {}), ("L2Normalization", (x,), {}),
    ]
    norm_ops = {"softmax", "log_softmax", "LayerNorm", "L2Normalization"}
    failed, worst = [], 0.0
    for name, arrays, kw in cases:
        outs = {}
        for dev in (DEVICE, "cpu"):
            xs = [nd.array(a, ctx=dev, dtype=dtype) for a in arrays]
            out = getattr(nd, name)(*xs, **kw)
            out = list(out) if isinstance(out, (tuple, list)) else [out]
            outs[dev] = [(o.shape, str(o.dtype), o.asnumpy().astype(
                np.float64)) for o in out]
        tol = 2.0 ** -7 if dtype == "bfloat16" else (
            1e-4 if name in norm_ops else 1e-5)
        ok = len(outs[DEVICE]) == len(outs["cpu"])
        for (gs, gd, gv), (ws, wd, wv) in zip(outs[DEVICE], outs["cpu"]):
            scale = max(float(np.abs(wv).max()), 1e-30)
            err = float(np.abs(gv - wv).max()) / scale
            if name != "argmax":
                worst = max(worst, err)
            ok = ok and gs == ws and gd == wd and err <= tol
        if not ok:
            failed.append(f"{name}[{dtype}]")
    return failed, worst


def _moment_check(x, mean, var):
    x = np.asarray(x, np.float64).ravel()
    m, v = x.mean(), x.var()
    se_m = np.sqrt(var / x.size)
    se_v = np.sqrt(max(((x - m) ** 4).mean() - v * v, 1e-30) / x.size)
    return abs(m - mean) <= 4 * se_m and abs(v - var) <= 4 * se_v


def random_draw_cases(torch, nd):
    """(a) the samplers on the card at 2^20 draws: moments within 4
    standard errors of the closed form; one (seed, position) gives the
    same stream twice, another seed another. Returns the failing names."""
    from mxnet_tpu_torch import _rng
    r = nd.random
    dev = DEVICE
    one = lambda v: nd.array([v], ctx=dev)  # noqa: E731
    draws = [
        ("uniform", lambda: r.uniform(-1, 3, shape=(DRAWS,), ctx=dev),
         1.0, 16 / 12),
        ("normal", lambda: r.normal(0.5, 2.0, shape=(DRAWS,), ctx=dev),
         0.5, 4.0),
        ("gamma", lambda: r.gamma(2.5, 1.5, shape=(DRAWS,), ctx=dev),
         3.75, 2.5 * 2.25),
        ("gamma_small", lambda: r.gamma(0.4, 2.0, shape=(DRAWS,), ctx=dev),
         0.8, 1.6),
        ("exponential", lambda: r.exponential(0.5, shape=(DRAWS,), ctx=dev),
         0.5, 0.25),
        ("poisson", lambda: r.poisson(3.5, shape=(DRAWS,), ctx=dev),
         3.5, 3.5),
        ("randint", lambda: r.randint(2, 9, shape=(DRAWS,), ctx=dev),
         5.0, 4.0),
        ("bernoulli", lambda: r.bernoulli(0.3, shape=(DRAWS,), ctx=dev),
         0.3, 0.21),
        ("negative_binomial", lambda: r.negative_binomial(
            3, 0.4, shape=(DRAWS,), ctx=dev), 4.5, 11.25),
        ("generalized_negative_binomial",
         lambda: r.generalized_negative_binomial(2.0, 0.5, shape=(DRAWS,),
                                                 ctx=dev), 2.0, 4.0),
        ("sample_uniform", lambda: r.uniform(one(2.0), one(5.0),
                                             shape=(DRAWS,)), 3.5, 0.75),
        ("sample_normal", lambda: r.normal(one(-1.0), one(0.5),
                                           shape=(DRAWS,)), -1.0, 0.25),
        ("sample_gamma", lambda: r.gamma(one(3.0), one(0.5),
                                         shape=(DRAWS,)), 1.5, 0.75),
        ("_sample_exponential", lambda: nd._sample_exponential(
            one(4.0), shape=(DRAWS,)), 0.25, 1 / 16),
        ("_sample_poisson", lambda: nd._sample_poisson(
            one(7.0), shape=(DRAWS,)), 7.0, 7.0),
        ("_sample_negative_binomial", lambda: nd._sample_negative_binomial(
            one(5.0), one(0.5), shape=(DRAWS,)), 5.0, 10.0),
        ("_sample_generalized_negative_binomial",
         lambda: nd._sample_generalized_negative_binomial(
             one(3.0), one(0.25), shape=(DRAWS,)), 3.0, 5.25),
    ]
    failed = []
    for name, draw, mean, var in draws:
        r.seed(2024)
        a = draw().asnumpy()
        r.seed(2024)
        b = draw().asnumpy()
        r.seed(2025)
        c = draw().asnumpy()
        if not (_moment_check(a, mean, var) and np.array_equal(a, b)
                and not np.array_equal(a, c)):
            failed.append(name)
    p = nd.array(np.array([[0.1, 0.2, 0.7]], np.float32), ctx=dev)
    d = r.multinomial(p, shape=(DRAWS,)).asnumpy()
    if not all(abs((d == k).mean() - q) <= 4 * np.sqrt(q * (1 - q) / DRAWS)
               for k, q in enumerate((0.1, 0.2, 0.7))):
        failed.append("multinomial")
    rows = nd.array(np.arange(64, dtype=np.float32).reshape(32, 2), ctx=dev)
    sh = r.shuffle(rows).asnumpy()
    if sorted(map(tuple, sh)) != sorted(map(tuple, rows.asnumpy())):
        failed.append("shuffle")
    x = nd.ones((DRAWS,), ctx=dev)
    from mxnet_tpu_torch import autograd as ag
    with ag.record():
        kept = (nd.Dropout(x, p=0.25).asnumpy() != 0).astype(np.float64)
    if not _moment_check(kept, 0.75, 0.1875):
        failed.append("Dropout")
    if _rng.get_state()["seed"] != 2025:
        failed.append("state")
    return failed, len(draws) + 4


def tail_lists(torch, rule, shapes, wdtype, seed):
    """Update-case tensors of ``rule`` at ``shapes`` on the card."""
    return update_case(torch, rule, shapes,
                       torch.bfloat16 if wdtype else torch.float32, DEVICE,
                       seed)


def tail_call(torch, nd, op, lists, lrs, wds, out=None):
    """Op ``op`` of the update tail over ``lists`` through ``nd``."""
    flat = [x for xs in lists for x in xs]
    common = dict(rescale_grad=0.125, clip_gradient=2.0)
    if "mom" in op:
        common["momentum"] = 0.9
    if op.startswith("preloaded_"):
        return getattr(nd, op)(*flat, torch.tensor(lrs, device=DEVICE),
                               torch.tensor(wds, device=DEVICE), out=out,
                               **common)
    if "adamw" in op:
        return getattr(nd, op)(*flat, torch.tensor([0.125], device=DEVICE),
                               lrs=lrs, wds=wds, etas=[0.5] * len(lists),
                               beta1=0.8, beta2=0.99, epsilon=1e-6, out=out)
    return getattr(nd, op)(*flat, num_weights=len(lists), lrs=lrs, wds=wds,
                           out=out, **common)


def tail_twin(torch, op, rule, lists, lrs, wds):
    """The rule's twin over clones of ``lists``, weight by weight, with
    the op's scalars: its outputs in the op's order."""
    from mxnet_tpu_torch.ops import optimizer_ops as ops
    twin = ops.RULES[rule].twin
    out = []
    for k, xs in enumerate(lists):
        if "adamw" in op:
            kw = dict(lr=lrs[k], wd=wds[k], eta=0.5, beta1=0.8, beta2=0.99,
                      epsilon=1e-6, rescale_grad_arr=torch.tensor(
                          [0.125], device=DEVICE))
        else:
            lr, wd = lrs[k], wds[k]
            if op.startswith("preloaded_"):
                lr = torch.tensor(lr, device=DEVICE)
                wd = torch.tensor(wd, device=DEVICE)
            kw = dict(lr=lr, wd=wd, rescale_grad=0.125, clip_gradient=2.0)
            if "mom" in op:
                kw["momentum"] = 0.9
        res = twin(*[x.clone() for x in xs], **kw)
        out += list(res) if isinstance(res, tuple) else [res]
    return out


def run_update_tail(torch, nd, kernels, shapes):
    """(b) each op of the update tail over BERT-base's parameters:
    one launch of the update kernel, its outputs the twin's bits, its
    inputs unchanged (with ``out=``: written there); the reductions over
    the gradients; extra.py's single update ops through ``nd``. Returns
    the launch counts and each op's max error against its twin."""
    from mxnet_tpu_torch.ops import optimizer_ops as ops
    lrs, wds = tail_scalars(shapes)
    errs = {}
    kernels.reset_launch_counts()
    for j, (op, rule, low) in enumerate(TAIL_OPS):
        lists = tail_lists(torch, rule, shapes, low, 40 + j)
        before = [x.clone() for xs in lists for x in xs]
        n0 = kernels.launch_counts().get(op, 0)
        got = tail_call(torch, nd, op, lists, lrs, wds)
        torch.cuda.synchronize()
        launched = kernels.launch_counts().get(op, 0) - n0
        want = tail_twin(torch, op, rule, lists, lrs, wds)
        bad = sum(int((g._data != w).sum()) for g, w in zip(got, want))
        err = max(float((g._data.float() - w.float()).abs().max())
                  for g, w in zip(got, want))
        unchanged = all(torch.equal(x, b) for x, b in zip(
            [x for xs in lists for x in xs], before))
        check(launched == 1, f"7b: {op} launched the update kernel "
              f"{launched} times, expected once")
        check(bad == 0, f"7b: {op} differs from its twin in {bad} "
              f"elements (max {err:.3e})")
        check(unchanged, f"7b: {op} changed its inputs")
        errs[op] = err
        log(f"7b: {op} ({rule} rule, {'bf16' if low else 'f32'} weights) "
            f"over {len(shapes)} tensors: one launch, the twin's bits "
            f"(max_abs_err {err:.3e}), inputs unchanged")
        del before, want
        if op == "multi_sgd_mom_update":
            outs = [torch.empty_like(g._data) for g in got]
            res = tail_call(torch, nd, op, lists, lrs, wds, out=outs)
            check(all(r is o for r, o in zip(res, outs)) and all(
                torch.equal(o, g._data) for o, g in zip(outs, got)),
                "7b: multi_sgd_mom_update with out= did not write there")
            del outs, res
        del got, lists
        torch.cuda.empty_cache()
    # the reductions over BERT-base's gradients
    grads = [torch.randn(s, device=DEVICE, generator=torch.Generator(
        device=DEVICE).manual_seed(k)) for k, s in enumerate(shapes)]
    sq = nd.multi_sum_sq(*grads, num_arrays=len(grads))
    twin = [(g.double() ** 2).sum() for g in grads]
    rel = max(float(abs(s._data.double().reshape(()) - t) / t)
              for s, t in zip(sq, twin))
    fin = float(nd.multi_all_finite(*grads).asscalar())
    grads[len(grads) // 2].view(-1)[0] = float("inf")
    fin_inf = float(nd.multi_all_finite(*grads).asscalar())
    # f32 sums of up to 23.4M squares (the word embedding's gradient)
    # against f64 ones
    log(f"7b: multi_sum_sq over {len(grads)} gradients: max relative error "
        f"{rel:.3e} against f64 sums (tol 1e-4); multi_all_finite {fin} "
        f"clean, {fin_inf} with one inf planted")
    check(rel <= 1e-4, "7b: multi_sum_sq disagrees with its twin")
    check(fin == 1.0 and fin_inf == 0.0, "7b: multi_all_finite missed")
    # the rules of extra.py's single update ops, through nd, for the
    # kernel phase's rows
    for rule in EXTRA_RULES:
        rl = ops.RULES[rule]
        lists = update_case(torch, rule, shapes[:3],
                            torch.bfloat16 if rl.mp else torch.float32,
                            DEVICE, 60)
        for k, xs in enumerate(lists):
            want = rl.twin(*[x.clone() for x in xs],
                           **update_kwargs(rule, k))
            getattr(nd, rule)(*xs, **update_kwargs(rule, k))
            torch.cuda.synchronize()
            check(all(torch.equal(xs[m], w) for m, w in zip(rl.mutates,
                                                            want)),
                  f"7b: nd.{rule} differs from its twin")
    return dict(kernels.launch_counts()), errs


def tail_scalars(shapes):
    """Per-tensor lr and wd of the update tail's calls (they differ)."""
    return ([1e-3 * (1 + k % 5) for k in range(len(shapes))],
            [1e-4 * (1 + k % 3) for k in range(len(shapes))])


def time_update_tail(torch, nd, timer, shapes, errs):
    """Each update-tail op's ms (the whole op: clones and one launch;
    median of 30 after the L2 flush), the twin's (tensor by tensor,
    median of 5) and the bound of the bytes the function moves: the
    kernels' result rows."""
    from mxnet_tpu_torch.ops import optimizer_ops as ops
    numel = sum(int(np.prod(s)) for s in shapes)
    lrs, wds = tail_scalars(shapes)
    rows = []
    for j, (op, rule, low) in enumerate(TAIL_OPS):
        lists = tail_lists(torch, rule, shapes, low, 40 + j)
        rl = ops.RULES[rule]
        per = ops.bytes_per_element(rule, torch.bfloat16 if low
                                    else torch.float32)
        # the clones: the weight (unless mp) and the states, read and
        # written once more
        clone = 2 * ((0 if rl.mp else (2 if low else 4))
                     + 4 * (rl.n_in - 2))
        b_ms, b_by, _ = bound(numel * per, numel * UPDATE_FLOPS[rule])
        ms = timer.ms(lambda: tail_call(torch, nd, op, lists, lrs, wds))
        plain_ms = timer.ms(lambda: tail_twin(torch, op, rule, lists, lrs,
                                              wds), n=5)
        rows.append(dict(
            name=op, route="cuda",
            source="mxnet_tpu_torch/csrc/multi_tensor_update.cu",
            replaces="none (a multi-tensor op of mxnet_tpu/ops/extra.py; "
                     "the JAX package runs it as XLA ops)",
            shape=f"BERT-base {len(shapes)} tensors {numel / 1e6:.1f}M "
                  f"{'bf16' if low else 'f32'}",
            max_abs_err=errs[op], tol=0.0, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            bytes_per_elem=per, op_bytes_per_elem=per + clone))
        log(f"7b kernel {op} ({rule} rule) {rows[-1]['shape']}: "
            f"ms={ms:.4f} (clones and one launch) plain_ms={plain_ms:.4f} "
            f"(twin, {len(shapes)} tensors) bound_ms={b_ms:.4f} ({b_by}, "
            f"{per} B an element; {per + clone} B with the clones)")
        del lists
        torch.cuda.empty_cache()
    return rows


def imperative_bert(torch, kernels, cfg=BERT_BASE, batch=BERT_BATCH,
                    seqlen=BERT_T):
    """(c) BERT-base (phase 8's model) trained through ``nd`` and
    ``autograd`` as a user of the reference would: NDArray token ids and
    labels, ``autograd.record()``, ``loss.backward()``, the gradients
    through ``Parameter.grad()``, ``nd.multi_all_finite`` on them and one
    ``nd.multi_sgd_mom_update`` over all parameters a step (written into
    the weights and momenta with ``out=``). Step 1's weights are held
    against a Trainer with SGD(momentum=0.9) from the same gradients.
    Returns the launch counts and the step losses."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.ops.flash_attention import KERNEL_NAMES
    vocab, layers = cfg["vocab_size"], cfg["num_layers"]
    data = bert_batches(torch, np.random.RandomState(31), 1, vocab, batch,
                        seqlen, "cpu") * IMPERATIVE_STEPS
    net = make_bert_mlm(0.0, **cfg)
    net.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    with ag.pause():                     # the deferred shapes
        net(nd.array(data[0][0][:1, :8].numpy(), ctx=DEVICE, dtype="int32"),
            nd.array([8], ctx=DEVICE, dtype="int32"))
    params = [p for _, p in sorted(net.collect_params().items())]
    moms = [torch.zeros_like(p.data()) for p in params]
    kernels.reset_launch_counts()
    builds, losses = None, []
    for step, (x, y, w, vlen) in enumerate(data):
        tokens = nd.array(x.numpy(), ctx=DEVICE, dtype="int32")
        labels = nd.array(y.numpy(), ctx=DEVICE, dtype="int32")
        weight = nd.array(w.numpy(), ctx=DEVICE)
        vl = nd.array(vlen.numpy(), ctx=DEVICE, dtype="int32")
        with ag.record():
            logits = net(tokens, vl)
            per_tok = loss_fn(logits.reshape(-1, vocab),
                              labels.reshape((-1,)))
            wf = weight.reshape((-1,))
            loss = nd.sum(per_tok * wf) / (nd.sum(wf) + 1e-6)
        loss.backward()
        grads = [p.grad() for p in params]
        finite = float(nd.multi_all_finite(*grads,
                                           num_arrays=len(grads)).asscalar())
        check(finite == 1.0, f"7b: step {step} has non-finite gradients")
        flat, out = [], []
        for p, m, g in zip(params, moms, grads):
            flat += [p.data().detach(), g, m]
            out += [p.data().detach(), m]
        if step == 0:
            w0 = [p.data().detach().clone() for p in params]
            g0 = [g.clone() for g in grads]
        nd.multi_sgd_mom_update(*flat, num_weights=len(params),
                                lrs=[IMPERATIVE_LR] * len(params),
                                wds=[0.0] * len(params), momentum=0.9,
                                rescale_grad=1.0 / batch, out=out)
        losses.append(float(loss.asscalar()))
        torch.cuda.synchronize()
        if step == 0:
            builds = kernels.build_count()
            w1 = [p.data().detach().clone() for p in params]
    launches = kernels.launch_counts()
    # step 1 against the Trainer from the same weights and gradients
    for p, w in zip(params, w0):
        p.set_data(w)
    trainer = gluon.Trainer(params, "sgd", {"learning_rate": IMPERATIVE_LR,
                                            "momentum": 0.9})
    for p, g in zip(params, g0):
        p.data().grad = g.clone()
    trainer.step(batch)
    torch.cuda.synchronize()
    diff = sum(int((p.data() != w).sum()) for p, w in zip(params, w1))
    log(f"7b: imperative BERT-base ({layers} layers, batch {batch} x "
        f"{seqlen}, nd/autograd, SGD momentum 0.9, lr {IMPERATIVE_LR}): "
        f"losses " + " ".join(f"{v:.4f}" for v in losses) + f"; launches "
        f"{ {k: v for k, v in launches.items() if v} }; builds after step "
        f"1: {kernels.build_count() - builds}; step 1 against the Trainer "
        f"(SGD momentum 0.9, the same sgd_mom rule and scalars): {diff} "
        "elements differ (bit for bit expected)")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"7b: the imperative loss did not fall ({losses})")
    for name in KERNEL_NAMES:
        check(launches.get(name, 0) == layers * IMPERATIVE_STEPS,
              f"7b: {name} launched {launches.get(name, 0)} times in "
              f"{IMPERATIVE_STEPS} steps, expected {layers} a step")
    check(launches.get("multi_sgd_mom_update", 0) == IMPERATIVE_STEPS,
          "7b: multi_sgd_mom_update was not one launch a step")
    check(kernels.build_count() == builds, "7b: a kernel was built after "
          "the first step")
    check(diff == 0, f"7b: step 1 differs from the Trainer in {diff} "
          "elements")
    del net, params, moms, trainer, w0, w1, g0
    torch.cuda.empty_cache()
    return launches, losses


def amp_reduction_check(torch, nd):
    """(d) §3 item 7 on the card: under amp.init(float16) an f16
    NDArray's sum() and mean() go through the op chokepoint's cast and
    return f32, as the reference's methods do."""
    from mxnet_tpu_torch import amp
    x = (np.random.RandomState(5).rand(*CORPUS_BERT_SHAPE) * 4).astype(
        np.float16)
    amp.init(target_dtype="float16")
    try:
        a = nd.array(x, ctx=DEVICE, dtype="float16")
        s, m = a.sum(), a.mean(axis=-1)
    finally:
        amp.uninit()
    want = x.astype(np.float64).sum()
    rel = abs(float(s.asscalar()) - want) / want
    log(f"7b: under amp.init(float16) an f16 NDArray's sum() is "
        f"{s.dtype} ({rel:.2e} from the f64 sum), mean(axis=-1) "
        f"{m.dtype}")
    check(str(s.dtype) == "float32" and str(m.dtype) == "float32",
          "7b: an f16 reduction method under AMP did not return f32")
    check(rel <= 1e-5, "7b: the f16 sum under AMP is off")


def run_op_corpus_phase(torch, timer, kernels):
    """Phase 7b: (a) the op corpus on the card against the CPU, the
    BERT-base activation shape in f32 and bf16, the samplers; (b) the
    update tail at BERT-base; (c) the imperative BERT-base step; (d) the
    AMP reduction. Returns (the launch counts of (b) and (c), the update
    tail's result rows)."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import registry
    seconds = {}
    t0 = time.monotonic()
    n_cases, n_groups, failed = run_corpus_cases(torch, nd, ag, registry)
    for dtype in ("float32", "bfloat16"):
        f, worst = bert_shape_cases(torch, nd, dtype)
        failed += f
        log(f"7b: at {CORPUS_BERT_SHAPE} {dtype}: 25 ops, worst error "
            f"{worst:.3e} of the output's largest magnitude")
    f, n_draws = random_draw_cases(torch, nd)
    failed += f
    seconds["a"] = time.monotonic() - t0
    log(f"7b (a): {n_cases} corpus cases over {n_groups} ops (every alias "
        f"name among them), 50 at BERT-base's activation shape, {n_draws} "
        f"samplers at 2^20 draws: {len(failed)} failed"
        + (f": {sorted(set(failed))}" if failed else ""))
    check(not failed, f"7b: ops failed on the card: {sorted(set(failed))}")
    t0 = time.monotonic()
    _, _, params = bert_base_params(torch)
    shapes = [tuple(p.shape) for p in params]
    del params
    torch.cuda.empty_cache()
    counts, errs = run_update_tail(torch, nd, kernels, shapes)
    rows = time_update_tail(torch, nd, timer, shapes, errs)
    seconds["b"] = time.monotonic() - t0
    t0 = time.monotonic()
    bert_counts, _ = imperative_bert(torch, kernels)
    for k, v in bert_counts.items():
        counts[k] = counts.get(k, 0) + v
    seconds["c"] = time.monotonic() - t0
    t0 = time.monotonic()
    amp_reduction_check(torch, nd)
    seconds["d"] = time.monotonic() - t0
    log("7b seconds: " + ", ".join(f"({k}) {v:.1f}" for k, v in
                                   seconds.items()))
    return counts, rows


# ------------------------------ phase 7c: the rest of the op registry --
# SSD-300 on VOC (ssd_300_vgg16_reduced(classes=20)): the six maps, their
# anchor sizes and ratios (mxnet_tpu/gluon/model_zoo/ssd.py:198-202)
SSD_MAPS = (38, 19, 10, 5, 3, 1)
SSD_SIZES = ((0.1, 0.141), (0.2, 0.272), (0.37, 0.447), (0.54, 0.619),
             (0.71, 0.79), (0.88, 0.961))
SSD_RATIOS = ((1.0, 2.0, 0.5),) + ((1.0, 2.0, 0.5, 3.0, 1.0 / 3),) * 3 + \
    ((1.0, 2.0, 0.5),) * 2
SSD_STEPS = (8 / 300, 16 / 300, 32 / 300, 64 / 300, 100 / 300, 1.0)
SSD_BATCH, SSD_GT, SSD_CLASSES = 32, 16, 20
# Faster R-CNN's test settings on a 600x1000 image (stride 16)
RCNN_IMAGE, RCNN_STRIDE, RCNN_BATCH = (600, 1000), 16, 2
RCNN_RPN = dict(scales=(8, 16, 32), ratios=(0.5, 1, 2), feature_stride=16,
                rpn_pre_nms_top_n=6000, rpn_post_nms_top_n=300,
                threshold=0.7, rpn_min_size=16)
# rois held against the CPU (the rest run on the card alone)
RCNN_CPU_ROIS = 24
# the PTB "medium" LSTM language model (Zaremba et al. 2014)
PTB = dict(vocab=10000, units=650, layers=2, steps=35, batch=20,
           dropout=0.5, lr=1.0, clip=5.0, init=0.05)
PTB_TRAIN_STEPS = 3
# BERT-base's four projections (K, N) and phase 5h's encode batch
BERT_PROJ = ((768, 2304), (768, 768), (768, 3072), (3072, 768))
ENCODE_TOKENS = 8 * 128
# ResNet-50's res2 3x3 convolution, NHWC
RES2 = dict(n=8, hw=56, c=64)


def tail_tol(op, family, forward, is_float):
    """(rtol, atol) of a 7c (a) comparison, card against CPU: integers
    and booleans exact, floats as :func:`corpus_tol`, except that a
    float the CPU tests hold exactly (a non-differentiable op's) takes
    the elementwise tolerance here: the card's exp, log and fused
    multiply-adds round the last bit another way."""
    if forward and not is_float:
        return 0.0, 0.0
    rtol, atol = corpus_tol(op, family, forward)
    if (rtol, atol) == (0.0, 0.0):
        return FAMILY_TOL["elemwise"]
    return rtol, atol


def tail_arrays(inputs, kwargs):
    """A tail case's inputs as numpy arrays of their ``_dtypes`` (int32
    with ``_int_input``, else float32)."""
    dtypes = kwargs.get("_dtypes") or ()
    base = np.int32 if kwargs.get("_int_input") else np.float32
    return [np.asarray(a, dtypes[i] if i < len(dtypes) and dtypes[i]
                       else base) for i, a in enumerate(inputs)]


def nd_fn(nd, name):
    """The op as a user reaches it: ``nd.contrib.X`` for ``_contrib_X``,
    else ``nd.X``."""
    if name.startswith("_contrib_"):
        return getattr(nd.contrib, name[len("_contrib_"):])
    return getattr(nd, name)


def tail_run(torch, nd, ag, op, name, inputs, kwargs, dev):
    """A tail case through ``nd``/``nd.contrib`` on ``dev``: outputs as
    (shape, dtype, host float64, is float) and, for a differentiable op,
    the gradients on a seeded cotangent."""
    kw = {k: v for k, v in kwargs.items() if not k.startswith("_")}
    if "ctx" in kw:
        kw["ctx"] = dev
    arrays = tail_arrays(inputs, kwargs)
    xs = [nd.array(a, ctx=dev) for a in arrays]
    grad_inputs = kwargs.get("_grad_inputs", tuple(
        i for i, a in enumerate(arrays) if a.dtype == np.float32))
    diff = op.differentiable and bool(grad_inputs)
    if diff:
        for i in grad_inputs:
            xs[i].attach_grad()
    with ag.record(train_mode=False) if diff else ag.pause():
        out = nd_fn(nd, name)(*xs, **kw)
    outs = list(out) if isinstance(out, (tuple, list)) else [out]
    host = [(o.shape, str(o.dtype), o.asnumpy().astype(np.float64),
             o._data.is_floating_point()) for o in outs]
    grads = []
    floats = [o for o in outs if o._data.is_floating_point()
              and o._data.requires_grad]
    if diff and floats:
        rs = np.random.RandomState(7)
        cots = [nd.array(np.asarray(rs.randn(*o.shape), np.float32),
                         ctx=dev) for o in floats]
        got = ag.grad(floats, [xs[i] for i in grad_inputs],
                      head_grads=cots)
        grads = [g.asnumpy().astype(np.float64) for g in got]
    return host, grads


def in_capture_raises(torch, fn):
    """True when ``fn`` raises a RuntimeError inside a CUDA-graph
    capture."""
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    raised = False
    with torch.cuda.stream(side):
        try:
            with torch.cuda.graph(graph, stream=side):
                fn()
        except RuntimeError:
            raised = True
    torch.cuda.synchronize()
    return raised


def run_tail_cases(torch, nd, ag, registry):
    """7c (a): every case of ``TAIL_CORPUS`` through ``nd``/``nd.contrib``
    on CUDA and on CPU NDArrays; each host op raises inside a capture;
    the two samplers at 2^20 draws. Returns (cases, ops, failures)."""
    failed, names = [], set()
    for name, inputs, kwargs, family in TAIL_CORPUS:
        op = registry.get(name)
        names.add(name)
        try:
            got, ggot = tail_run(torch, nd, ag, op, name, inputs, kwargs,
                                 DEVICE)
            want, gwant = tail_run(torch, nd, ag, op, name, inputs, kwargs,
                                   "cpu")
            ok = len(got) == len(want) and len(ggot) == len(gwant)
            for (gs, gd, g, fl), (ws, wd, w, _) in zip(got, want):
                rtol, atol = tail_tol(op, family, True, fl)
                ok = ok and gs == ws and gd == wd and _close(g, w, rtol,
                                                             atol)
            rtol, atol = tail_tol(op, family, False, True)
            for g, w in zip(ggot, gwant):
                ok = ok and g.shape == w.shape and _close(g, w, rtol, atol)
            if op.host_op:
                xs = [nd.array(a, ctx=DEVICE)
                      for a in tail_arrays(inputs, kwargs)]
                kw = {k: v for k, v in kwargs.items()
                      if not k.startswith("_")}
                ok = ok and in_capture_raises(
                    torch, lambda: nd_fn(nd, name)(*xs, **kw))
        except Exception as exc:       # named below, then the phase fails
            log(f"7c: {name} raised {type(exc).__name__}: {exc}")
            ok = False
        if not ok:
            failed.append(name)
    from mxnet_tpu_torch import _rng
    for name, kw, mean, var in (
            ("_npi_uniform_n", {"low": -1.0, "high": 3.0}, 1.0, 16.0 / 12),
            ("_npi_normal_n", {"loc": 0.5, "scale": 2.0}, 0.5, 4.0)):
        names.add(name)
        _rng.seed(5)
        a = getattr(nd, name)(size=(DRAWS,), ctx=DEVICE, **kw).asnumpy()
        _rng.seed(5)
        b = getattr(nd, name)(size=(DRAWS,), ctx=DEVICE, **kw).asnumpy()
        if not (_moment_check(a, mean, var) and np.array_equal(a, b)):
            failed.append(name)
    return len(TAIL_CORPUS) + 2, len(names), failed


def ssd_inputs(rng):
    """SSD-300's anchors' feature maps, seeded labels (1 to 8 boxes an
    image, padded with -1), class and box predictions."""
    label = np.full((SSD_BATCH, SSD_GT, 6), -1.0, np.float32)
    for i in range(SSD_BATCH):
        nb = rng.randint(1, 9)
        label[i, :nb, 0] = rng.randint(0, SSD_CLASSES, nb)
        label[i, :nb, 1:5] = _cboxes(nb, seed=1000 + i)
        label[i, :nb, 5] = 0.0
    a = sum(m * m * (len(s) + len(r) - 1) for m, s, r in
            zip(SSD_MAPS, SSD_SIZES, SSD_RATIOS))
    cls = rng.randn(SSD_BATCH, SSD_CLASSES + 1, a).astype(np.float32)
    loc = (rng.randn(SSD_BATCH, a * 4) * 0.1).astype(np.float32)
    return label, cls, loc


def ssd_anchors(nd, dev):
    return nd.concat(*[
        nd.contrib.MultiBoxPrior(nd.zeros((1, 1, m, m), ctx=dev),
                                 sizes=s, ratios=r, steps=(st, st),
                                 clip=False)
        for m, s, r, st in zip(SSD_MAPS, SSD_SIZES, SSD_RATIOS, SSD_STEPS)],
        dim=1)


def multibox_loss(nd, cls_preds, loc_preds, loc_t, loc_m, cls_t):
    """``MultiBoxLoss``'s arithmetic (ssd.py:168-185) through ``nd``:
    softmax cross entropy ignoring ``cls_t == -1``, smooth L1 on the
    positives; (N,)."""
    logp = nd.log_softmax(cls_preds.transpose((0, 2, 1)), axis=-1)
    tgt = nd.maximum(cls_t, nd.zeros_like(cls_t))
    picked = -nd.pick(logp, tgt, axis=-1)
    keep = cls_t >= 0
    cls_loss = (picked * keep).sum(axis=-1) / nd.maximum(
        keep.sum(axis=-1), nd.ones_like(keep.sum(axis=-1)))
    loc_loss = (nd.smooth_l1(loc_preds - loc_t, scalar=1.0) * loc_m).sum(
        axis=-1) / nd.maximum(loc_m.sum(axis=-1),
                              nd.ones_like(loc_m.sum(axis=-1)))
    return cls_loss + loc_loss


def timed_ms(torch, fn):
    """One call's wall ms, synchronized (the op, its host steps and its
    launches: what a caller waits for)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def flips(got, want, near):
    """The indices where ``got`` and ``want`` differ, and whether each
    sits where ``near`` says a one-ulp move decides it."""
    idx = np.argwhere(got != want)
    return [(tuple(i), bool(near(tuple(i)))) for i in idx]


def run_ssd_phase(torch, nd, ag, rng):
    """7c (b): SSD-300 on VOC at batch 32."""
    anchors = ssd_anchors(nd, DEVICE)
    check(anchors.shape == (1, 8732, 4), f"SSD-300 anchors: "
          f"{anchors.shape}, want (1, 8732, 4)")
    anchors_cpu = ssd_anchors(nd, "cpu")
    check(np.array_equal(anchors.asnumpy(), anchors_cpu.asnumpy()),
          "SSD-300 anchors differ from the CPU's")
    label, cls_np, loc_np = ssd_inputs(rng)
    lab = nd.array(label, ctx=DEVICE)
    cls_p = nd.array(cls_np, ctx=DEVICE)
    loc_p = nd.array(loc_np, ctx=DEVICE)
    kw = dict(overlap_threshold=0.5, negative_mining_ratio=3.0,
              negative_mining_thresh=0.5)
    (loc_t, loc_m, cls_t), t_ms = timed_ms(
        torch, lambda: nd.contrib.MultiBoxTarget(anchors, lab, cls_p, **kw))
    c_loc, c_m, c_cls = nd.contrib.MultiBoxTarget(
        anchors_cpu, nd.array(label, ctx="cpu"), nd.array(cls_np, ctx="cpu"),
        **kw)
    g_cls, w_cls = cls_t.asnumpy(), c_cls.asnumpy()
    bg = np.exp(cls_np - cls_np.max(axis=1, keepdims=True))
    bg = (bg / bg.sum(axis=1, keepdims=True))[:, 0]

    def near(i):
        # a negative-mining swap: the background probability one ulp
        # from another candidate's
        n, a = i
        p = bg[n, a]
        return np.min(np.abs(np.delete(bg[n], a) - p)) <= \
            2 * np.spacing(np.float32(p))
    fl = flips(g_cls, w_cls, near)
    for f in fl:
        log(f"7c (b): cls_target flip at {f[0]}: card "
            f"{g_cls[f[0]]}, CPU {w_cls[f[0]]}, within an ulp: {f[1]}")
    check(len(fl) <= 1 and all(f[1] for f in fl),
          f"SSD-300 cls_target differs from the CPU's at {fl}")
    mask_same = np.array_equal(loc_m.asnumpy(), c_m.asnumpy())
    loc_err = float(np.abs(loc_t.asnumpy() - c_loc.asnumpy()).max())
    check(mask_same or fl, "SSD-300 loc_mask differs from the CPU's")
    check(loc_err <= 1e-5 * max(1.0, float(np.abs(c_loc.asnumpy()).max()))
          or fl, f"SSD-300 loc_target error {loc_err}")
    cls_p.attach_grad()
    loc_p.attach_grad()
    with ag.record():
        loss = multibox_loss(nd, cls_p, loc_p, loc_t, loc_m, cls_t)
        total = loss.mean()
    _, b_ms = timed_ms(torch, total.backward)
    g1, g2 = cls_p.grad.asnumpy(), loc_p.grad.asnumpy()
    check(np.isfinite(g1).all() and np.abs(g1).sum() > 0 and
          np.isfinite(g2).all() and np.abs(g2).sum() > 0,
          "MultiBoxLoss: backward() reached no prediction")
    probs = nd.softmax(cls_p.detach(), axis=1)
    det_kw = dict(nms_threshold=0.45, threshold=0.01, nms_topk=400)
    det, d_ms = timed_ms(torch, lambda: nd.contrib.MultiBoxDetection(
        probs, loc_p.detach(), anchors, **det_kw))
    # the CPU decodes the card's probabilities: a softmax an ulp off would
    # reorder near-equal scores, which says nothing of the op
    c_det = nd.contrib.MultiBoxDetection(
        nd.array(probs.asnumpy(), ctx="cpu"), nd.array(loc_np, ctx="cpu"),
        anchors_cpu, **det_kw).asnumpy()
    g_det = det.asnumpy()
    kept_same = np.array_equal(g_det[..., 0], c_det[..., 0])
    sc = c_det[..., 1]

    def near_score(i):
        n, a = i[:2]
        p = sc[n, a]
        return np.min(np.abs(np.delete(sc[n], a) - p)) <= \
            2 * np.spacing(np.float32(abs(p)) + np.float32(1e-30))
    dfl = [] if kept_same else flips(g_det[..., 0], c_det[..., 0],
                                     near_score)
    for f in dfl:
        log(f"7c (b): detection row flip at {f[0]}, within an ulp: {f[1]}")
    det_err = float(np.abs(g_det - c_det).max()) if kept_same else 0.0
    check(kept_same or (len(dfl) <= 2 and all(f[1] for f in dfl)),
          f"SSD-300 detections keep other rows than the CPU: {dfl}")
    check(det_err <= 1e-5, f"SSD-300 detection rows error {det_err}")
    n_det = int((g_det[..., 0] >= 0).sum())
    log(f"7c (b): SSD-300 batch {SSD_BATCH}: 8732 anchors; MultiBoxTarget "
        f"{t_ms:.2f} ms ({int((g_cls > 0).sum())} positives, "
        f"{int((g_cls == 0).sum())} mined negatives, flips {len(fl)}), "
        f"loc_target err {loc_err:.2e}; MultiBoxLoss backward {b_ms:.2f} "
        f"ms; MultiBoxDetection {d_ms:.2f} ms ({n_det} rows kept, row err "
        f"{det_err:.2e}); against the CPU")
    return {"MultiBoxTarget": t_ms, "MultiBoxLoss backward": b_ms,
            "MultiBoxDetection": d_ms}


def rcnn_inputs(rng):
    h = RCNN_IMAGE[0] // RCNN_STRIDE + (RCNN_IMAGE[0] % RCNN_STRIDE > 0)
    w = RCNN_IMAGE[1] // RCNN_STRIDE + (RCNN_IMAGE[1] % RCNN_STRIDE > 0)
    a = len(RCNN_RPN["scales"]) * len(RCNN_RPN["ratios"])
    cls = rng.uniform(0, 1, (RCNN_BATCH, 2 * a, h, w)).astype(np.float32)
    bbox = (rng.randn(RCNN_BATCH, 4 * a, h, w) * 0.1).astype(np.float32)
    info = np.array([[RCNN_IMAGE[0], RCNN_IMAGE[1], 1.0]] * RCNN_BATCH,
                    np.float32)
    return cls, bbox, info, (h, w)


def card_and_cpu(torch, nd, ag, fn, arrays, grad=(), seed=8):
    """``fn(*NDArrays)`` on the card and on the CPU: (card outputs, CPU
    outputs, card grads, CPU grads, card wall ms) as numpy, the grads of
    the inputs ``grad`` on a seeded cotangent of the first output."""
    res = []
    for dev in (DEVICE, "cpu"):
        xs = [nd.array(a, ctx=dev) for a in arrays]
        for i in grad:
            xs[i].attach_grad()
        with ag.record() if grad else ag.pause():
            out, ms = timed_ms(torch, lambda: fn(*xs)) if dev == DEVICE \
                else (fn(*xs), 0.0)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        grads = []
        if grad:
            cot = nd.array(np.random.RandomState(seed).randn(
                *outs[0].shape).astype(np.float32), ctx=dev)
            (outs[0] * cot).sum().backward()
            grads = [xs[i].grad.asnumpy() for i in grad]
        res.append(([o.asnumpy() for o in outs], grads, ms))
    return res[0][0], res[1][0], res[0][1], res[1][1], res[0][2]


def rel_max(got, want):
    return float(np.abs(got - want).max() / max(1.0, np.abs(want).max()))


def run_rcnn_phase(torch, nd, ag, rng):
    """7c (c): the R-CNN family at Faster R-CNN's test settings on a
    600x1000 image; each op against the CPU on one image or a slice of
    the rois, and its ms."""
    cls, bbox, info, (h, w) = rcnn_inputs(rng)
    ms = {}
    args = [nd.array(a, ctx=DEVICE) for a in (cls, bbox, info)]
    (rois, scores), ms["MultiProposal"] = timed_ms(
        torch, lambda: nd.contrib.MultiProposal(*args, output_score=True,
                                                **RCNN_RPN))
    c_rois, c_sc = nd.contrib.MultiProposal(
        *[nd.array(a[:1], ctx="cpu") for a in (cls, bbox, info)],
        output_score=True, **RCNN_RPN)
    p = RCNN_RPN["rpn_post_nms_top_n"]
    g_rois = rois.asnumpy()
    check(g_rois.shape == (RCNN_BATCH * p, 5), f"MultiProposal: rois "
          f"{g_rois.shape}")
    err = rel_max(g_rois[:p], c_rois.asnumpy())
    check(err <= 1e-5 and np.array_equal(scores.asnumpy()[:p],
                                         c_sc.asnumpy()),
          f"MultiProposal image 0 against the CPU: rois err {err}")
    log(f"7c (c): MultiProposal batch {RCNN_BATCH} (K=6000 -> 300, a "
        f"{h}x{w} map, 9 anchors): {ms['MultiProposal']:.2f} ms; image 0 "
        f"against the CPU: scores exact, rois err {err:.2e}")
    feat = (rng.randn(RCNN_BATCH, 1024, h, w) * 0.5).astype(np.float32)
    roi_np = g_rois
    sl = np.r_[0:RCNN_CPU_ROIS // 2, p:p + RCNN_CPU_ROIS // 2]
    for name, fn, data, roi_in, kw, grad in (
            ("ROIAlign", nd.contrib.ROIAlign, feat, roi_np,
             dict(pooled_size=(7, 7), spatial_scale=1.0 / RCNN_STRIDE,
                  sample_ratio=2), (0,)),
            ("PSROIPooling", nd.contrib.PSROIPooling,
             (rng.randn(RCNN_BATCH, 21 * 49, h, w) * 0.5).astype(np.float32),
             roi_np, dict(spatial_scale=1.0 / RCNN_STRIDE, output_dim=21,
                          pooled_size=7), (0,)),
            ("RROIAlign", nd.contrib.RROIAlign, feat,
             np.concatenate([roi_np[:, :1],
                             (roi_np[:, 1:3] + roi_np[:, 3:5]) / 2,
                             roi_np[:, 3:5] - roi_np[:, 1:3] + 1,
                             rng.uniform(-90, 90, (len(roi_np), 1))],
                            axis=1).astype(np.float32),
             dict(pooled_size=(7, 7), spatial_scale=1.0 / RCNN_STRIDE,
                  sampling_ratio=2), (0,))):
        xs = [nd.array(data, ctx=DEVICE), nd.array(roi_in, ctx=DEVICE)]
        xs[0].attach_grad()
        with ag.record():
            out, f_ms = timed_ms(torch, lambda: fn(*xs, **kw))
        _, b_ms = timed_ms(torch, lambda: out.backward(nd.ones_like(out)))
        check(np.isfinite(xs[0].grad.asnumpy()).all(),
              f"{name}: gradient not finite")
        got, want, gg, gw, _ = card_and_cpu(
            torch, nd, ag, lambda d, r: fn(d, r, **kw),
            [data, roi_in[sl]], grad=grad)
        err, gerr = rel_max(got[0], want[0]), rel_max(gg[0], gw[0])
        check(err <= 1e-4 and gerr <= 1e-4, f"{name} against the CPU: "
              f"out {err}, grad {gerr}")
        ms[name] = f_ms
        ms[name + " backward"] = b_ms
        log(f"7c (c): {name} {tuple(out.shape)} over ({RCNN_BATCH}, "
            f"{data.shape[1]}, {h}, {w}): forward {f_ms:.2f} ms, backward "
            f"{b_ms:.2f} ms; {RCNN_CPU_ROIS} rois against the CPU: out "
            f"{err:.2e}, grad {gerr:.2e}")
    x = (rng.randn(RCNN_BATCH, 512, h, w) * 0.5).astype(np.float32)
    off = (rng.randn(RCNN_BATCH, 18, h, w) * 0.5).astype(np.float32)
    mask = rng.uniform(0, 1, (RCNN_BATCH, 9, h, w)).astype(np.float32)
    wt = (rng.randn(512, 512, 3, 3) / np.sqrt(512 * 9)).astype(np.float32)
    bias = (rng.randn(512) * 0.1).astype(np.float32)
    dkw = dict(kernel=(3, 3), dilate=(2, 2), pad=(2, 2), num_filter=512)
    for name, fn, arrays in (
            ("DeformableConvolution", nd.contrib.DeformableConvolution,
             [x, off, wt, bias]),
            ("ModulatedDeformableConvolution",
             nd.contrib.ModulatedDeformableConvolution,
             [x, off, mask, wt, bias])):
        xs = [nd.array(a, ctx=DEVICE) for a in arrays]
        for v in xs:
            v.attach_grad()
        with ag.record():
            out, f_ms = timed_ms(torch, lambda: fn(*xs, **dkw))
        _, b_ms = timed_ms(torch, lambda: out.backward(nd.ones_like(out)))
        one = [a[:1] if a.ndim == 4 else a for a in arrays]
        got, want, gg, gw, _ = card_and_cpu(
            torch, nd, ag, lambda *v: fn(*v, **dkw), one,
            grad=tuple(range(len(one))))
        err = rel_max(got[0], want[0])
        gerr = max(rel_max(g, w_) for g, w_ in zip(gg, gw))
        check(err <= 1e-4 and gerr <= 1e-4, f"{name} against the CPU: out "
              f"{err}, grads {gerr}")
        ms[name] = f_ms
        ms[name + " backward"] = b_ms
        log(f"7c (c): {name} 512->512 3x3 dilate 2 on ({RCNN_BATCH}, 512, "
            f"{h}, {w}): forward {f_ms:.2f} ms, backward {b_ms:.2f} ms; "
            f"one image against the CPU: out {err:.2e}, grads {gerr:.2e}")
    m = 8
    masks = (rng.uniform(0, 1, (RCNN_BATCH, m) + RCNN_IMAGE) > 0.5).astype(
        np.float32)
    mrois = roi_np[:, 1:].reshape(RCNN_BATCH, p, 4)
    matches = rng.randint(0, m, (RCNN_BATCH, p)).astype(np.float32)
    cls_t = rng.randint(0, 21, (RCNN_BATCH, p)).astype(np.float32)
    mkw = dict(num_rois=p, num_classes=21, mask_size=(28, 28),
               sample_ratio=2)
    args = [nd.array(a, ctx=DEVICE) for a in (mrois, masks, matches, cls_t)]
    (mt, mc), ms["mrcnn_mask_target"] = timed_ms(
        torch, lambda: nd.contrib.mrcnn_mask_target(*args, **mkw))
    k = RCNN_CPU_ROIS
    c_mt, c_mc = nd.contrib.mrcnn_mask_target(
        *[nd.array(a, ctx="cpu") for a in (mrois[:1, :k], masks[:1],
                                           matches[:1, :k], cls_t[:1, :k])],
        **dict(mkw, num_rois=k))
    err = rel_max(mt.asnumpy()[:1, :k], c_mt.asnumpy())
    # a resampling (the tolerance of the other roi ops): a sample's
    # position, ~600 in magnitude, moves by its ulp (6e-5) between the
    # two devices' divisions, and a 0/1 mask's bilinear value with it
    check(err <= 1e-4 and np.array_equal(mc.asnumpy()[:1, :k],
                                         c_mc.asnumpy()),
          f"mrcnn_mask_target against the CPU: {err}")
    log(f"7c (c): mrcnn_mask_target {tuple(mt.shape)}: "
        f"{ms['mrcnn_mask_target']:.2f} ms; {k} rois against the CPU: "
        f"targets {err:.2e}, class masks exact")
    return ms


def ptb_params(rng):
    from mxnet_tpu_torch.ops.rnn import rnn_param_size
    u, v, s = PTB["units"], PTB["vocab"], PTB["init"]
    size = rnn_param_size(u, u, PTB["layers"], "lstm")
    return [rng.uniform(-s, s, (v, u)).astype(np.float32),
            rng.uniform(-s, s, size).astype(np.float32),
            rng.uniform(-s, s, (v, u)).astype(np.float32),
            np.zeros(v, np.float32)]


def ptb_loss(nd, params, ids, labels, p, state):
    """The language model through ``nd``: Embedding, the fused 2-layer
    LSTM, the decoder, softmax cross entropy (mean per token); the
    embedding's dropout (and the RNN's between its layers) at ``p``."""
    emb_w, rnn_w, dec_w, dec_b = params
    u, v = PTB["units"], PTB["vocab"]
    x = nd.Embedding(ids, emb_w, input_dim=v, output_dim=u)
    if p > 0:
        x = nd.Dropout(x, p=p)
    out, ht, ct = nd.RNN(x, rnn_w, state[0], state[1], state_size=u,
                         num_layers=PTB["layers"], mode="lstm", p=p)
    logits = nd.FullyConnected(out.reshape((-1, u)), dec_w, dec_b,
                               num_hidden=v)
    loss = nd.softmax_cross_entropy(logits, labels.reshape((-1,))) / \
        labels.size
    return loss, out, ht, ct, x


def run_ptb_phase(torch, nd, ag, rng):
    """7c (d): the PTB medium LSTM: p=0 against the CPU, then 3 SGD steps
    at p=0.5 with the gradients clipped to norm 5 (``multi_sum_sq``),
    then GRU and the vanilla modes, bidirectional, against the CPU."""
    T, N, u, L = PTB["steps"], PTB["batch"], PTB["units"], PTB["layers"]
    params_np = ptb_params(rng)
    ids_np = rng.randint(0, PTB["vocab"], (T, N)).astype(np.float32)
    lab_np = rng.randint(0, PTB["vocab"], (T, N)).astype(np.float32)
    zeros = np.zeros((L, N, u), np.float32)
    res = {}
    for dev in (DEVICE, "cpu"):
        ps = [nd.array(a, ctx=dev) for a in params_np]
        for q in ps:
            q.attach_grad()
        state = [nd.array(zeros, ctx=dev), nd.array(zeros, ctx=dev)]
        with ag.record():
            loss, out, ht, ct, _ = ptb_loss(nd, ps, nd.array(ids_np, ctx=dev),
                                            nd.array(lab_np, ctx=dev), 0.0,
                                            state)
        loss.backward()
        res[dev] = [a.asnumpy() for a in (out, ht, ct, loss)] + \
            [q.grad.asnumpy() for q in ps]
    errs = [rel_max(g, w) for g, w in zip(res[DEVICE], res["cpu"])]
    names = ("out", "hT", "cT", "loss", "d embedding", "d rnn", "d decoder",
             "d bias")
    check(max(errs) <= 1e-4, "PTB LSTM at p=0 against the CPU: " + ", ".join(
        f"{n} {e:.2e}" for n, e in zip(names, errs)))
    log(f"7c (d): PTB medium LSTM (vocab {PTB['vocab']}, {L} x {u}, {T} "
        f"steps, batch {N}) at p=0 against the CPU, max error over the "
        "largest magnitude: " + ", ".join(f"{n} {e:.1e}" for n, e in
                                          zip(names, errs)))
    ps = [nd.array(a, ctx=DEVICE) for a in params_np]
    for q in ps:
        q.attach_grad()
    state = [nd.array(zeros, ctx=DEVICE), nd.array(zeros, ctx=DEVICE)]
    ids, labs = nd.array(ids_np, ctx=DEVICE), nd.array(lab_np, ctx=DEVICE)
    losses, step_ms, keep = [], [], []
    for _ in range(PTB_TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ag.record():
            loss, _, _, _, x = ptb_loss(nd, ps, ids, labs, PTB["dropout"],
                                        state)
        loss.backward()
        grads = [q.grad for q in ps]
        sq = nd.multi_sum_sq(*grads, num_arrays=len(grads))
        norm = float(np.sqrt(sum(float(s.asnumpy()[0]) for s in sq)))
        scale = PTB["lr"] * min(1.0, PTB["clip"] / max(norm, 1e-12))
        for q, g in zip(ps, grads):
            q._data.data.sub_(scale * g._data)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(loss.asnumpy()))
        keep.append(float((x.asnumpy() != 0).mean()))
    check(losses[-1] < losses[0], f"PTB LSTM: loss did not fall: {losses}")
    se = np.sqrt(0.25 / (T * N * u))
    check(all(abs(k - 0.5) <= 4 * se for k in keep),
          f"PTB LSTM: dropout keep fractions {keep}, 4 standard errors "
          f"{4 * se:.1e}")
    log(f"7c (d): 3 SGD steps at p=0.5 (lr 1, clipped to norm 5 through "
        f"multi_sum_sq): losses {[round(v, 4) for v in losses]}, keep "
        f"fractions {[round(k, 4) for k in keep]}, step ms "
        f"{[round(m, 2) for m in step_ms]}")
    x_np = (rng.randn(T, N, u) * 0.5).astype(np.float32)
    from mxnet_tpu_torch.ops.rnn import rnn_param_size
    for mode in ("gru", "rnn_tanh", "rnn_relu"):
        size = rnn_param_size(u, u, L, mode, True)
        w_np = rng.uniform(-0.05, 0.05, size).astype(np.float32)
        h0 = np.zeros((2 * L, N, u), np.float32)
        outs = {}
        for dev in (DEVICE, "cpu"):
            o = nd.RNN(nd.array(x_np, ctx=dev), nd.array(w_np, ctx=dev),
                       nd.array(h0, ctx=dev), state_size=u, num_layers=L,
                       mode=mode, bidirectional=True)
            outs[dev] = [a.asnumpy() for a in o[:2]]
        err = max(rel_max(g, w) for g, w in zip(outs[DEVICE], outs["cpu"]))
        check(err <= 1e-4, f"PTB widths, {mode} bidirectional against the "
              f"CPU: {err}")
        log(f"7c (d): {mode} bidirectional, {L} x {u}, {T} steps: against "
            f"the CPU {err:.1e}")
    return {"PTB step (fwd+bwd+clip+SGD)": float(np.median(step_ms))}, \
        params_np, ids_np


def run_quant_k3_phase(torch, nd, timer, rng):
    """7c (e): ``nd.contrib.quantized_matmul`` (K3) at BERT-base's four
    projections on the 1024-token encode batch, int8 and fp8, against the
    twin on the card; the int8 x int8 chain and ResNet-50's res2
    convolution bit for bit against the CPU. Returns (K3's launches from
    the nd calls, the kernel rows, ms)."""
    from mxnet_tpu_torch import kernels
    from mxnet_tpu_torch.ops import quantization as qz
    from mxnet_tpu_torch.serving.llm.quant import quantize_leaf
    T = ENCODE_TOKENS
    counts, rows, ms = {}, [], {}
    for wdt in ("int8", "float8_e4m3fn"):
        for K, N in BERT_PROJ:
            w = rng.randn(K, N).astype(np.float32) / np.sqrt(K)
            q, s = quantize_leaf(w, wdt)
            q, s = q.to(DEVICE), s.to(DEVICE)
            x = nd.array(rng.randn(T, K).astype(np.float32), ctx=DEVICE)
            name = qz.kernel_name(q.dtype)
            n0 = kernels.launch_counts().get(name, 0)
            out = nd.contrib.quantized_matmul(x, q, s)
            torch.cuda.synchronize()
            n1 = kernels.launch_counts().get(name, 0)
            check(n1 == n0 + 1, f"nd.contrib.quantized_matmul: {n1 - n0} "
                  f"launches of {name}, want 1")
            counts[name] = counts.get(name, 0) + 1
            xt = x._data
            ref = qz.quantized_matmul_reference(xt, q, s)
            err = float((out._data - ref).abs().max())
            tol = WQ_REL_TOL * max(1.0, float(ref.abs().max()))
            check(err <= tol, f"K3 at T={T}, K={K}, N={N} {wdt}: {err} > "
                  f"{tol}")

            def kern():
                return nd.contrib.quantized_matmul(x, q, s)

            def plain():
                return qz.quantized_matmul_reference(xt, q, s)

            def library():
                return xt @ (q.float() * s)
            b_ms, b_by, b_f32 = bound(4 * T * K + K * N + 4 * N + 4 * T * N,
                                      2 * T * K * N, WQ_PASSES)
            row = dict(name=name, route="cuda",
                       source="mxnet_tpu_torch/csrc/wq_matmul.cu",
                       replaces="mxnet_tpu/ops/quantization.py:297",
                       shape=f"T={T},K={K},N={N},nd.contrib",
                       max_abs_err=err, tol=tol, ms=timer.ms(kern),
                       plain_ms=timer.ms(plain), bound_ms=b_ms,
                       bound_by=b_by, bound_f32_ms=b_f32,
                       library_ms=timer.ms(library))
            log(f"kernel {name} {row['shape']}: max_abs_err={err:.3e} (tol "
                f"{tol:.3e}) kernel_ms={row['ms']:.4f} plain_ms="
                f"{row['plain_ms']:.4f} library_ms={row['library_ms']:.4f} "
                f"bound_ms={b_ms:.4f} ({b_by}) bound_f32_ms={b_f32:.4f}")
            rows.append(row)
    # the int8 x int8 chain at the same shapes, bit for bit with the CPU
    chain_ms = 0.0
    for K, N in BERT_PROJ:
        x_np = rng.randn(T, K).astype(np.float32)
        w_np = (rng.randn(N, K) / np.sqrt(K)).astype(np.float32)
        outs = {}
        for dev in (DEVICE, "cpu"):
            def chain():
                qx, xmn, xmx = nd.contrib.quantize_v2(nd.array(x_np,
                                                               ctx=dev))
                qw, wmn, wmx = nd.contrib.quantize_v2(nd.array(w_np,
                                                               ctx=dev))
                acc = nd.contrib.quantized_fully_connected(qx, qw)
                t = (xmx * wmx).asnumpy()
                q8, mn, mx_ = nd.contrib.requantize(
                    acc.astype("int32"), nd.array(-t, ctx=dev),
                    nd.array(t, ctx=dev))
                return [v.asnumpy() for v in (qx, acc, q8, nd.contrib.
                                               dequantize(q8, mn, mx_))]
            if dev == DEVICE:
                outs[dev], t_ms = timed_ms(torch, chain)
                chain_ms += t_ms
            else:
                outs[dev] = chain()
        same = all(np.array_equal(g, w) for g, w in zip(outs[DEVICE],
                                                        outs["cpu"]))
        check(same, f"int8 chain K={K} N={N}: the card's bits differ from "
              f"the CPU's")
    ms["int8 chain (4 projections)"] = chain_ms
    log(f"7c (e): quantize_v2 -> quantized_fully_connected -> requantize -> "
        f"dequantize at the four projections, T={T}: bit for bit with the "
        f"CPU, {chain_ms:.2f} ms")
    n, hw, c = RES2["n"], RES2["hw"], RES2["c"]
    qx = rng.randint(-127, 128, (n, hw, hw, c)).astype(np.int8)
    qw = rng.randint(-127, 128, (3, 3, c, c)).astype(np.int8)
    ckw = dict(kernel=(3, 3), stride=(1, 1), pad=(1, 1), x_scale=0.02,
               w_scale=0.01)
    got, ms["quantized_conv res2"] = timed_ms(
        torch, lambda: nd.contrib.quantized_conv(
            nd.array(qx, ctx=DEVICE), nd.array(qw, ctx=DEVICE), **ckw))
    want = nd.contrib.quantized_conv(nd.array(qx, ctx="cpu"),
                                     nd.array(qw, ctx="cpu"), **ckw)
    check(np.array_equal(got.asnumpy(), want.asnumpy()),
          "quantized_conv res2: the card's bits differ from the CPU's")
    log(f"7c (e): quantized_conv ResNet-50 res2 3x3 ({n}, {hw}, {hw}, {c}) "
        f"NHWC: bit for bit with the CPU, {ms['quantized_conv res2']:.2f} "
        f"ms")
    return counts, rows, ms


def run_control_flow_phase(torch, nd, ag, params_np, ids_np):
    """7c (f): ``foreach`` over the PTB model's first LSTM layer against
    ``nd.RNN``, ``while_loop`` captured, ``cond`` both ways and in a
    capture."""
    from mxnet_tpu_torch.ops.rnn import rnn_cell_step
    u, N = PTB["units"], PTB["batch"]
    g = 4 * u
    flat = params_np[1]
    # the first layer's [Wx, Wh] (the flat vector's first block) and its
    # [bx, bh] (after both layers' weights)
    w_end = 2 * (2 * g * u)
    one_layer = np.concatenate([flat[:2 * g * u], flat[w_end:w_end + 2 * g]])
    emb = params_np[0][ids_np.astype(np.int64)]
    h0 = np.zeros((1, N, u), np.float32)
    res = {}
    for mode in ("rnn", "foreach"):
        x = nd.array(emb, ctx=DEVICE)
        w = nd.array(one_layer, ctx=DEVICE)
        x.attach_grad()
        w.attach_grad()
        with ag.record():
            if mode == "rnn":
                out = nd.RNN(x, w, nd.array(h0, ctx=DEVICE),
                             nd.array(h0, ctx=DEVICE), state_size=u,
                             num_layers=1, mode="lstm")[0]
            else:
                wx = w[:g * u].reshape((g, u))
                wh = w[g * u:2 * g * u].reshape((g, u))
                bx, bh = w[2 * g * u:2 * g * u + g], w[2 * g * u + g:]
                xproj = nd.dot(x.reshape((-1, u)), wx, transpose_b=True) + bx

                def body(xp, states):
                    o, h, c = rnn_cell_step("lstm", xp._data,
                                            states[0]._data,
                                            states[1]._data, wh._data,
                                            bh._data)
                    return nd.NDArray(o), [nd.NDArray(h), nd.NDArray(c)]
                out, _ = nd.contrib.foreach(
                    body, xproj.reshape((PTB["steps"], N, g)),
                    [nd.array(h0[0], ctx=DEVICE), nd.array(h0[0],
                                                           ctx=DEVICE)])
            loss = (out * out).sum()
        loss.backward()
        res[mode] = [out.asnumpy(), x.grad.asnumpy(), w.grad.asnumpy()]
    errs = [rel_max(a, b) for a, b in zip(res["foreach"], res["rnn"])]
    check(errs[0] <= 1e-5 and max(errs[1:]) <= 1e-4,
          f"foreach over the LSTM layer against nd.RNN: {errs}")
    log(f"7c (f): foreach over PTB's first LSTM layer (35 rnn_cell_steps) "
        f"against nd.RNN: out {errs[0]:.1e}, d input {errs[1]:.1e}, d "
        f"weights {errs[2]:.1e}")
    i0 = torch.zeros((), device=DEVICE)
    s0 = torch.ones((), device=DEVICE)

    def loop():
        outs, (fi, fs) = nd.contrib.while_loop(
            lambda i, s: i < 5, lambda i, s: (s + i, (i + 1, s + i)),
            [nd.NDArray(i0), nd.NDArray(s0)], max_iterations=8)
        return outs._data, fi._data, fs._data
    eager = [t.clone() for t in loop()]
    graph, side = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        loop()
        with torch.cuda.graph(graph, stream=side):
            static = loop()
    graph.replay()
    torch.cuda.synchronize()
    check(all(torch.equal(a, b) for a, b in zip(static, eager)) and
          not eager[0][5:].any() and float(eager[1]) == 5.0,
          "while_loop: the captured run differs or the tail is not zero")
    log(f"7c (f): while_loop exits after 5 of 8 steps, rows 5-7 zero, "
        f"captured in one CUDA graph and replayed to the eager bits")
    x = nd.NDArray(torch.tensor([1.0, -2.0, 3.0], device=DEVICE))
    a = nd.contrib.cond(lambda v: v.sum() > 0, lambda v: v * 2,
                        lambda v: v * 0, [x]).asnumpy()
    b = nd.contrib.cond(lambda v: v.sum() > 5, lambda v: v * 2,
                        lambda v: v * 0, [x]).asnumpy()
    raised = in_capture_raises(torch, lambda: nd.contrib.cond(
        lambda v: v.sum() > 0, lambda v: v * 2, lambda v: v, [x]))
    check(np.array_equal(a, [2.0, -4.0, 6.0]) and not b.any() and raised,
          "cond: a branch was wrong or it ran inside a capture")
    log("7c (f): cond picks each branch and raises inside a capture")


def run_op_tail_phase(torch, timer, rng):
    """Phase 7c: (a) the tail corpus, (b) SSD-300, (c) the R-CNN family,
    (d) the PTB LSTM, (e) K3 and the int8 ops at BERT-base widths, (f)
    control flow. Returns (K3's launches, K3's rows)."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import nd
    from mxnet_tpu_torch.ops import registry
    seconds, op_ms = {}, {}
    t0 = time.monotonic()
    n_cases, n_ops, failed = run_tail_cases(torch, nd, ag, registry)
    seconds["a"] = time.monotonic() - t0
    log(f"7c (a): {n_cases} cases over {n_ops} ops through nd/nd.contrib "
        f"on the card against the CPU (host ops raising inside a capture, "
        f"the two samplers at 2^20 draws): {len(failed)} failed"
        + (f": {sorted(set(failed))}" if failed else ""))
    check(not failed, f"7c: ops failed on the card: {sorted(set(failed))}")
    for part, fn in (("b", run_ssd_phase), ("c", run_rcnn_phase)):
        t0 = time.monotonic()
        op_ms.update(fn(torch, nd, ag, rng))
        seconds[part] = time.monotonic() - t0
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    ms, params_np, ids_np = run_ptb_phase(torch, nd, ag, rng)
    op_ms.update(ms)
    seconds["d"] = time.monotonic() - t0
    t0 = time.monotonic()
    counts, rows, ms = run_quant_k3_phase(torch, nd, timer, rng)
    op_ms.update(ms)
    seconds["e"] = time.monotonic() - t0
    t0 = time.monotonic()
    run_control_flow_phase(torch, nd, ag, params_np, ids_np)
    seconds["f"] = time.monotonic() - t0
    torch.cuda.empty_cache()
    log("7c ms: " + ", ".join(f"{k} {v:.2f}" for k, v in op_ms.items()))
    log("7c seconds: " + ", ".join(f"({k}) {v:.1f}" for k, v in
                                   seconds.items()))
    return counts, rows


def _train_state(trainer):
    """Every weight and optimizer slot of ``trainer``, cloned (slots a
    restore left on the host as numpy, until the next update moves
    them, as tensors)."""
    import torch
    out = [p.data().detach().clone() for p in trainer._params]
    for i in sorted(trainer._updaters[0].states):
        st = trainer._updaters[0].states[i]
        out += [torch.as_tensor(np.array(s)) if isinstance(s, np.ndarray)
                else s.detach().clone()
                for s in (st if isinstance(st, (tuple, list)) else [st])]
    return out


def _max_diff(a, b):
    """Largest absolute difference over two lists of tensors, and how
    many of the tensors differ at all."""
    worst, n = 0.0, 0
    for x, y in zip(a, b):
        x = x.to(y.device)
        if not x.equal(y):
            n += 1
            worst = max(worst, float((x.double() - y.double()).abs().max()))
    return worst, n


def run_trainer_ckpt_phase(torch, rng, kernels, cfg=BERT_BASE,
                           batch=BERT_BATCH, seqlen=BERT_T):
    """The Trainer's full-state checkpoints on BERT-base (the f32 phase's
    model at dropout 0.1, then under AMP bf16 with its loss scaler), in
    a temporary run directory the phase removes (``keep=2``, 4 shards):
    (a) 3 Adam steps, ``save_state(num_shards=4)`` with
    ``MXNET_TPU_CKPT_ASYNC=1`` (the critical path: the blocking snapshot
    and the optimizer blob; the write on the background thread), 2 more
    steps while it writes (the overlap counter), ``ckpt_wait()``;
    (b) a fresh model and Trainer ``restore_state`` and take the same 2
    steps, twice from the one checkpoint: the two resumed runs give the
    spread of the path's launches (where they differ, the parameters
    whose gradients differ after one step are named), and the resumed
    weights and Adam slots equal the original run's bit for bit, or
    within that spread and never looser;
    (c) a sync ``save_state`` (wall ms and the checkpoint's bytes), then a
    save killed at byte 2^20 of a shard through the fault switchboard:
    the partial directory does not validate and ``restore_state`` brings
    back the previous checkpoint's bits. Returns the launch counts."""
    import shutil
    import tempfile
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.error import CheckpointCorruptError
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.resilience import async_writer
    from mxnet_tpu_torch.resilience import checkpoint as ckpt
    from mxnet_tpu_torch.resilience import faults
    vocab = cfg["vocab_size"]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    data = bert_batches(torch, rng, 5, vocab, batch, seqlen, DEVICE)
    # the async writer's series on the registry (mxtpu_ckpt_async_*)
    series = async_writer._obs()
    write_s, snap_s = series["write_secs"], series["snapshot_secs"]
    overlap = series["overlap_steps"]
    env = os.environ.get("MXNET_TPU_CKPT_ASYNC")
    counts = {}
    for use_amp in (False, True):
        tag = "ckpt amp bf16" if use_amp else "ckpt f32"
        dd = [(x.int(), y, w, vl) for x, y, w, vl in data] if use_amp \
            else data
        root = tempfile.mkdtemp(prefix="mxt-ckpt-")
        if use_amp:
            amp.init()
        try:
            def make():
                net = make_bert_mlm(0.1, **cfg)
                net.initialize(Xavier(), device=DEVICE,
                               generator=torch.Generator().manual_seed(0))
                tr = gluon.Trainer(net.collect_params(), "adam",
                                   {"learning_rate": BERT_LR})
                if use_amp:
                    amp.init_trainer(tr)
                return net, tr

            def step(net, tr, d):
                with ag.record():
                    loss = mlm_loss(net, loss_fn, d, vocab)
                    scaled = loss
                    if use_amp:
                        with amp.scale_loss(loss, tr) as scaled:
                            pass
                scaled.backward()
                tr.step(batch)
                return float(loss.detach())
            # (a)
            torch.manual_seed(0)              # dropout masks
            net, tr = make()
            kernels.reset_launch_counts()
            losses = [step(net, tr, d) for d in dd[:3]]
            os.environ["MXNET_TPU_CKPT_ASYNC"] = "1"
            w0, s0, o0 = write_s.sum, snap_s.sum, overlap.value
            torch.cuda.synchronize()
            t0 = time.monotonic()
            handle = tr.save_state(root, keep=CKPT_KEEP,
                                   num_shards=CKPT_SHARDS)
            crit_ms = (time.monotonic() - t0) * 1e3
            losses += [step(net, tr, d) for d in dd[3:5]]
            torch.cuda.synchronize()
            steps_done = time.monotonic()
            tr.ckpt_wait()
            tail_ms = (time.monotonic() - steps_done) * 1e3
            path = handle.result(0)
            manifest = ckpt.validate_checkpoint(path)
            nbytes = sum(int(r["nbytes"])
                         for r in manifest["files"].values())
            log(f"{tag}: 3 steps, async save_state(num_shards="
                f"{CKPT_SHARDS}) of step {manifest['step']}: "
                f"{nbytes / 1e9:.3f} GB in {len(manifest['files'])} files; "
                f"critical path {crit_ms:.1f} ms (snapshot "
                f"{(snap_s.sum - s0) * 1e3:.1f} ms of it), background "
                f"write {(write_s.sum - w0) * 1e3:.1f} ms; 2 steps "
                f"overlapped the write ({overlap.value - o0:.0f} counted), "
                f"ckpt_wait after them {tail_ms:.1f} ms; losses "
                + " ".join(f"{v:.4f}" for v in losses))
            check(all(np.isfinite(losses)), f"{tag}: non-finite loss")
            check(manifest["step"] == 3 and manifest["format"] ==
                  ckpt.FORMAT_SHARDED, f"{tag}: checkpoint {manifest['step']}"
                  f" {manifest['format']}")
            want = _train_state(tr)
            # (b) two resumed runs from the one checkpoint
            net2, tr2 = make()
            runs, grads, restore_ms = [], [], []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                m = tr2.restore_state(root)
                torch.cuda.synchronize()
                restore_ms.append((time.monotonic() - t0) * 1e3)
                check(m["step"] == 3 and tr2._step_count == 3,
                      f"{tag}: restored step {m['step']}")
                step(net2, tr2, dd[3])
                grads.append([p.grad().detach().clone()
                              for p in tr2._params])
                step(net2, tr2, dd[4])
                runs.append(_train_state(tr2))
            spread, n_spread = _max_diff(runs[0], runs[1])
            err, n_err = _max_diff(want, runs[0])
            names = [p.name for p, a, b in zip(tr2._params, *grads)
                     if not torch.equal(a, b)]
            log(f"{tag}: restore_state {restore_ms[0]:.1f} ms (then "
                f"{restore_ms[1]:.1f} ms); 2 resumed steps twice from it: "
                f"{n_spread} of {len(runs[0])} tensors differ between the "
                f"two, by {spread:.3e} at most" + (
                    f" (gradients that differ after one step: {names})"
                    if names else "") + f"; against the uninterrupted run "
                f"{n_err} differ, by {err:.3e} at most")
            check(err <= spread, f"{tag}: the resumed run is {err} from the "
                  f"uninterrupted one, beyond the resume's own spread "
                  f"{spread}")
            del runs, grads
            # (c) a sync save, then a save killed at byte N
            os.environ["MXNET_TPU_CKPT_ASYNC"] = "0"
            t0 = time.monotonic()
            path = tr.save_state(root, keep=CKPT_KEEP,
                                 num_shards=CKPT_SHARDS)
            sync_ms = (time.monotonic() - t0) * 1e3
            committed = _train_state(tr)
            faults.kill_write_at("shard-00002-of-00004", 1 << 20)
            try:
                killed = False
                try:
                    tr.save_state(root, step=6, keep=CKPT_KEEP,
                                  num_shards=CKPT_SHARDS)
                except faults.InjectedCrash:
                    killed = True
            finally:
                faults.reset()
            partial = os.path.join(root, ckpt.checkpoint_dirname(6))
            try:
                ckpt.validate_checkpoint(partial)
                valid = True
            except CheckpointCorruptError:
                valid = False
            m = tr2.restore_state(root)
            err, n_err = _max_diff(committed, _train_state(tr2))
            log(f"{tag}: sync save_state of step 5: {sync_ms:.1f} ms wall; "
                f"a save of step 6 killed at byte {1 << 20} of shard 2: "
                f"killed {killed}, its directory valid {valid}; "
                f"restore_state brought back step {m['step']}, {n_err} "
                f"tensors differ from it; directories "
                f"{[st for st, _ in ckpt.list_checkpoints(root)]} (keep "
                f"{CKPT_KEEP}, and the killed save's)")
            check(killed and not valid and m["step"] == 5 and n_err == 0,
                  f"{tag}: the killed save left something other than the "
                  "previous checkpoint to restore")
            for k, v in kernels.launch_counts().items():
                counts[k] = counts.get(k, 0) + v
            del net, tr, net2, tr2, want, committed
        finally:
            if env is None:
                os.environ.pop("MXNET_TPU_CKPT_ASYNC", None)
            else:
                os.environ["MXNET_TPU_CKPT_ASYNC"] = env
            if use_amp:
                amp.uninit()
            shutil.rmtree(root, ignore_errors=True)
            torch.cuda.empty_cache()
    return counts


# ------------------------------------------------- 8d: the vision path --
ZOO_BATCH = 8
# the first constructor of each family, held card against CPU
ZOO_FIRSTS = ("resnet18_v1", "resnet18_v2", "vgg11_bn", "alexnet",
              "squeezenet1_1", "densenet121", "mobilenet1_0",
              "mobilenet_v2_1_0", "inception_v3")
# card vs CPU logits, max |diff| / max |CPU|, f32 with TF32 off: cuDNN and
# oneDNN sum each convolution in their own order, over up to 121 layers
ZOO_REL_TOL = 1e-3
RESNET_CHECK_BATCH = 4
RESNET_F32_BATCH = 32
RESNET_BF16_BATCH = 128
RESNET_STEPS = 10
RESNET_SGD = {"learning_rate": 1e-3, "momentum": 0.9}
# one f32 step at batch 4, card vs CPU: the loss (per sample); each
# parameter's update, |card - CPU| / |CPU update| in the 2-norm (a ReLU
# gate that flips at a tie, |x| ~ 1e-6, moves a whole gradient entry and,
# through the training-mode BatchNorms, the updates before it); the
# running statistics. The biases of the convolutions under a BatchNorm
# have a zero gradient in exact arithmetic (the normalisation removes
# them): their updates, rounding noise below RESNET_ZERO_GRAD of the
# largest update, are held to that bound instead
RESNET_LOSS_REL_TOL = 1e-4
RESNET_UPDATE_REL_TOL = 0.1
RESNET_STAT_REL_TOL = 1e-4
RESNET_ZERO_GRAD = 1e-5
# the NHWC s2d-stem net against the NCHW net on the same weights (f32)
LAYOUT_REL_TOL = 1e-4


def zoo_size(name):
    return 299 if name.startswith("inception") else 224


def run_zoo_phase(torch, rng):
    """(a) every ``get_model`` constructor on the card at batch 8, its
    input size (299 Inception V3, 224 the rest), eval mode: logits of
    shape (8, 1000), finite; the first of each family also on the CPU
    from the same weights (the card net's ``save_parameters`` file,
    ``load_parameters`` onto the CPU), within ZOO_REL_TOL."""
    import tempfile
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.initializer import Xavier
    names = sorted(n for n in vision._models if not n.startswith("get_"))
    t0 = time.monotonic()
    worst = {}
    with tempfile.TemporaryDirectory() as tmp:
        for k, name in enumerate(names):
            size = zoo_size(name)
            x = rng.randn(ZOO_BATCH, 3, size, size).astype(np.float32)
            net = vision.get_model(name, prefix=f"{name}_")
            net.initialize(Xavier(), device=DEVICE,
                           generator=torch.Generator().manual_seed(k))
            with ag.pause():
                out = net(torch.from_numpy(x).to(DEVICE))
            torch.cuda.synchronize()
            check(tuple(out.shape) == (ZOO_BATCH, 1000) and
                  bool(torch.isfinite(out).all()), f"8d zoo: {name} gave "
                  f"{tuple(out.shape)} logits, finite "
                  f"{bool(torch.isfinite(out).all())}")
            if name in ZOO_FIRSTS:
                path = os.path.join(tmp, f"{name}.params")
                net.save_parameters(path)
                cpu = vision.get_model(name, prefix=f"{name}_")
                cpu.load_parameters(path, ctx="cpu")
                with ag.pause():
                    want = cpu(torch.from_numpy(x)).numpy()
                got = out.cpu().numpy()
                worst[name] = float(np.abs(got - want).max()
                                    / np.abs(want).max())
                del cpu
            del net, out
            torch.cuda.empty_cache()
    log(f"8d (a): {len(names)} constructors at batch {ZOO_BATCH} (224x224, "
        f"Inception V3 299x299) on the card: logits ({ZOO_BATCH}, 1000), "
        f"finite; in "
        f"{time.monotonic() - t0:.1f}s")
    log("8d (a): card vs CPU, eval, same weights (max |diff| / max |CPU|, "
        f"tol {ZOO_REL_TOL}): " + ", ".join(
            f"{n} {e:.2e}" for n, e in worst.items()))
    for name, err in worst.items():
        check(err <= ZOO_REL_TOL, f"8d zoo: {name} card vs CPU {err:.3e}")


def resnet_loss(nd, net, x, y):
    """``bench.py``'s loss: per-sample NLL of the f32 log-softmax."""
    logp = nd.log_softmax(net(x).float(), axis=-1)
    return -nd.pick(logp, y, axis=1)


def resnet_step(nd, ag, net, trainer, x, y):
    with ag.record():
        loss = resnet_loss(nd, net, x, y)
    loss.backward()
    trainer.step(x.shape[0])
    return loss


def kernel_class(name):
    """The split of a profiled ResNet step: convolutions (cuDNN and its
    GEMMs), reductions (batch-norm statistics and their gradients,
    pooling), elementwise (normalisation, ReLU, residual adds, casts
    and their gradients), the update kernel, other (copies, layout
    permutes)."""
    n = name.lower()
    if "multi_update_kernel" in n:
        return "update"
    if "reduce" in n:
        return "reductions"
    if "elementwise" in n or "vectorized" in n:
        return "elementwise"
    if any(k in n for k in ("conv", "cudnn", "xmma", "gemm", "wgrad",
                            "dgrad", "fprop", "cutlass", "sm90_", "sm80_",
                            "implicit")):
        return "convolutions"
    return "other"


def resnet_train(torch, nd, ag, kernels, net, trainer, data, label,
                 groups):
    """``RESNET_STEPS`` steps over ``data`` (all but its last two
    batches), then two under the profiler. Checks finite losses, the
    fused update (``groups`` launches a step, no fallback), no kernel
    build after the first step. Returns the update kernel's launch
    counts of the timed steps and a summary (step ms: median of steps
    2-10, images/s, peak GB, launches a step, profiled device ms a step,
    idle share, the device split)."""
    batch = data[0][0].shape[0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    losses, times, builds = [], [], None
    for i, (x, y) in enumerate(data[:-2]):
        t0 = time.monotonic()
        loss = resnet_step(nd, ag, net, trainer, x, y)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(float(loss.mean().asnumpy()))
        if i == 0:
            builds = kernels.build_count()
        fused = trainer._fused
        check(fused.fallbacks == {} and fused.last_dispatches == groups,
              f"{label}: step {i} did not take the fused update (fallbacks "
              f"{dict(fused.fallbacks)}, {fused.last_dispatches} launches, "
              f"expected {groups})")
    launches = kernels.launch_counts()
    steps = len(data) - 2
    step_ms = float(np.median(times[1:])) * 1e3
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    check(kernels.build_count() == builds, f"{label}: a kernel was built "
          "after the first step")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for x, y in data[-2:]:
            resnet_step(nd, ag, net, trainer, x, y)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    share = report_profile(prof, wall, 2)
    rows, busy_us = device_rows(prof)
    split = {}
    for e in rows:
        c = kernel_class(e.key)
        split[c] = split.get(c, 0.0) + e.self_device_time_total / 1e3 / 2
    per_step = sum(e.count for e in rows) / 2
    summary = dict(step_ms=step_ms, images_s=batch / step_ms * 1e3,
                   peak_gb=peak_gb, kernels_per_step=per_step,
                   device_ms=busy_us / 1e3 / 2,
                   idle=None if share is None else 1 - share, split=split)
    log(f"{label}: {steps} SGD-momentum steps (lr 1e-3, momentum 0.9), "
        f"batch {batch}: losses " + " ".join(f"{v:.4f}" for v in losses))
    log(f"{label}: step {step_ms:.2f} ms (median of steps 2-{steps}; first "
        f"{times[0] * 1e3:.1f} ms); {summary['images_s']:.1f} images/s; "
        f"peak memory {peak_gb:.2f} GB; {per_step:.0f} kernels a step "
        f"(profiled); update launches {launches}")
    log(f"{label}: profiled device {summary['device_ms']:.2f} ms a step, "
        f"idle {summary['idle']}; split (ms a step): " + ", ".join(
            f"{k} {v:.2f}" for k, v in sorted(split.items())))
    EAGER_ROWS[label] = summary
    return launches, summary


def resnet_data(torch, rng, n, batch, layout="NCHW", dtype=None):
    """``n`` batches of seeded images (on the card, from one seed drawn
    from ``rng``) and int32 labels of 1000 classes."""
    gen = torch.Generator(device=DEVICE).manual_seed(int(rng.randint(2**31)))
    shape = (batch, 3, 224, 224) if layout == "NCHW" else (batch, 224, 224,
                                                           3)
    return [(torch.randn(shape, generator=gen, device=DEVICE,
                         dtype=dtype or torch.float32),
             torch.randint(0, 1000, (batch,), generator=gen, device=DEVICE,
                           dtype=torch.int32)) for _ in range(n)]


def norm_ratio(a, b):
    """|a - b| / |b| in the 2-norm, in f64 (0 over 0 is 0)."""
    d = float((a.double() - b.double()).norm())
    n = float(b.double().norm())
    return d / n if n else d


def resnet_step_check(torch, nd, ag, gluon, net, rng, tmp):
    """One step at batch 4 on the card and on a CPU copy of ``net`` (its
    ``save_parameters`` file): the per-sample losses, every parameter's
    update and the BatchNorm running statistics."""
    from mxnet_tpu_torch.gluon.model_zoo import vision
    path = os.path.join(tmp, "r50.params")
    net.save_parameters(path)
    cpu = vision.resnet50_v1(prefix="r50_")
    cpu.load_parameters(path, ctx="cpu")
    before = {k: p.data().detach().clone()
              for k, p in cpu._collect_params_with_prefix().items()}
    x = torch.from_numpy(rng.randn(RESNET_CHECK_BATCH, 3, 224, 224)
                         .astype(np.float32))
    y = torch.from_numpy(rng.randint(0, 1000, RESNET_CHECK_BATCH)
                         .astype(np.int32))
    losses = []
    for n, dev in ((net, DEVICE), (cpu, "cpu")):
        tr = gluon.Trainer(n.collect_params(), "sgd", dict(RESNET_SGD))
        losses.append(resnet_step(nd, ag, n, tr, x.to(dev), y.to(dev))
                      .asnumpy())
    loss_rel = float(np.abs(losses[0] - losses[1]).max()
                     / np.abs(losses[1]).max())
    card = net._collect_params_with_prefix()
    upd, stat, errs = (0.0, ""), (0.0, ""), []
    diffs = {}
    for key, p in cpu._collect_params_with_prefix().items():
        got = card[key].data().detach().cpu()
        want = p.data().detach()
        if p.grad_req == "null":
            stat = max(stat, (norm_ratio(got, want), key))
        else:
            diffs[key] = (got - before[key], want - before[key])
    top = max(float(w.norm()) for _, w in diffs.values())
    zero, zero_err = [], 0.0
    for key, (g, w) in diffs.items():
        if float(w.norm()) < RESNET_ZERO_GRAD * top:
            zero.append(key)
            zero_err = max(zero_err, float((g - w).norm()) / top)
        else:
            errs.append(norm_ratio(g, w))
            upd = max(upd, (errs[-1], key))
    log(f"8d (b): one step at batch {RESNET_CHECK_BATCH}, card vs CPU: "
        f"losses {losses[0].round(5).tolist()} vs "
        f"{losses[1].round(5).tolist()} (max relative {loss_rel:.2e}, tol "
        f"{RESNET_LOSS_REL_TOL}); updates (2-norm relative): median "
        f"{np.median(errs):.2e}, worst {upd[0]:.2e} ({upd[1]}; tol "
        f"{RESNET_UPDATE_REL_TOL}); {len(zero)} zero-gradient biases within "
        f"{zero_err:.2e} of the largest update (tol {RESNET_ZERO_GRAD}); "
        f"worst running statistic {stat[0]:.2e} ({stat[1]}; tol "
        f"{RESNET_STAT_REL_TOL})")
    check(loss_rel <= RESNET_LOSS_REL_TOL, "8d: ResNet-50's loss card vs "
          "CPU")
    check(upd[0] <= RESNET_UPDATE_REL_TOL and zero_err <= RESNET_ZERO_GRAD,
          f"8d: ResNet-50's update of {upd[1]} card vs CPU")
    check(stat[0] <= RESNET_STAT_REL_TOL, f"8d: ResNet-50's running "
          f"statistic {stat[1]} card vs CPU")


def update_bf16_row(torch, timer, net, seed):
    """The update kernel's bf16 ``sgd_mom_update`` (new in this slice)
    over ``net``'s bf16 parameters (ResNet-50's weights after the cast),
    bit for bit against its twin on the card, with its time, the twin's
    (parameter by parameter) and the bound in bytes."""
    from mxnet_tpu_torch.ops import optimizer_ops as ops
    name = "sgd_mom_update"
    shapes = [tuple(p.shape) for p in net.collect_params().values()
              if p.data().dtype == torch.bfloat16]
    numel = sum(int(np.prod(s)) for s in shapes)
    lists = update_case(torch, name, shapes, torch.bfloat16, DEVICE, seed)
    kws = [update_kwargs(name, i) for i in range(len(lists))]
    bad, err, nans = kernel_vs_twin(torch, name, lists, kws)
    table = ops.UpdateTable(name, lists)
    rows = ops._upload(table.rows(kws, [xs[1] for xs in lists]), DEVICE)
    rule = ops.RULES[name]

    def plain():
        for xs, kw in zip(lists, kws):
            rule.twin(*xs, **kw)
    nbytes = numel * ops.bytes_per_element(name, torch.bfloat16)
    b_ms, b_by, b_f32 = bound(nbytes, numel * UPDATE_FLOPS[name])
    res = dict(name=table.counter, route="cuda",
               source="mxnet_tpu_torch/csrc/multi_tensor_update.cu",
               replaces="none (the reference's update is one XLA "
                        "program: mxnet_tpu/optimizer/fused.py:223)",
               shape=f"ResNet-50 {len(shapes)} bf16 tensors "
                     f"{numel / 1e6:.1f}M",
               max_abs_err=err, tol=0.0, mismatched=bad,
               ms=timer.ms(lambda: table.launch(rows)),
               plain_ms=timer.ms(plain), bound_ms=b_ms, bound_by=b_by,
               bound_f32_ms=b_f32, library_ms=None)
    log(f"kernel {res['name']} {res['shape']}: {bad} elements differ from "
        f"the twin (max_abs_err={err:.3e}, NaN on both {nans}) "
        f"kernel_ms={res['ms']:.4f} plain_ms={res['plain_ms']:.4f} "
        f"bound_ms={b_ms:.4f} ({b_by}, {nbytes / 1e9:.3f} GB) library none")
    check(bad == 0 and nans == 0, f"{res['name']}: the kernel disagrees with "
          f"its twin at ResNet-50's shapes ({bad} elements)")
    return res


def nhwc_from_nchw(torch, src, dst):
    """``dst`` (an NHWC net) takes ``src``'s (NCHW) weights, 4-D ones
    OIHW -> OHWI; both keyed by structural path."""
    theirs = src._collect_params_with_prefix()
    for key, p in dst._collect_params_with_prefix().items():
        w = theirs[key].data().detach()
        p.set_data(w.permute(0, 2, 3, 1) if w.ndim == 4 else w)


def run_resnet_phase(torch, rng, kernels):
    """8d (b) ResNet-50 v1 f32 NCHW (TF32 off) as ``bench.py`` sets it up
    (Xavier after ``mx.random.seed(0)``; the per-sample NLL of the f32
    log-softmax; SGD lr 1e-3, momentum 0.9; ``trainer.step(batch)``):
    one step at batch 4 card vs CPU, then RESNET_STEPS steps at batch 32;
    (c) ``bench.py``'s default: ``resnet50_v1(layout="NHWC",
    stem_s2d=True)``, its f32 forward at batch 4 held against (b)'s net
    on the same weights, then cast to bf16, RESNET_STEPS steps at batch
    128 (the bf16 weights through the update kernel's bf16 instantiation
    beside the f32 BatchNorm group). Returns the launch counts of the
    timed steps, the two summaries and the bf16 update kernel's row."""
    import tempfile
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.initializer import Xavier
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    nd.random.seed(0)
    net = vision.resnet50_v1(prefix="r50_")
    net.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
    with ag.pause():
        net(torch.ones(1, 3, 224, 224, device=DEVICE))
    n_params = sum(p.data().numel() for p in net.collect_params().values())
    log(f"8d (b): ResNet-50 v1, {len(net.collect_params())} parameters, "
        f"{n_params / 1e6:.2f}M elements")
    with tempfile.TemporaryDirectory() as tmp:
        resnet_step_check(torch, nd, ag, gluon, net, rng, tmp)
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_SGD))
    data = resnet_data(torch, rng, RESNET_STEPS + 2, RESNET_F32_BATCH)
    c, f32 = resnet_train(torch, nd, ag, kernels, net, trainer, data,
                          "8d (b) f32 NCHW", groups=1)
    check(c.get("sgd_mom_update", 0) == RESNET_STEPS, f"8d (b): "
          f"sgd_mom_update launched {c.get('sgd_mom_update', 0)} times in "
          f"{RESNET_STEPS} steps, expected one a step")
    add(c)
    del data, trainer
    torch.cuda.empty_cache()
    # (c) bench.py's default configuration
    s2d = vision.resnet50_v1(layout="NHWC", stem_s2d=True, prefix="r50s_")
    s2d.initialize(device=DEVICE)
    with ag.pause():
        s2d(torch.ones(1, 224, 224, 3, device=DEVICE))
    nhwc_from_nchw(torch, net, s2d)
    x = torch.from_numpy(rng.randn(RESNET_CHECK_BATCH, 3, 224, 224)
                         .astype(np.float32)).to(DEVICE)
    with ag.pause():
        want = net(x)
        got = s2d(x.permute(0, 2, 3, 1).contiguous())
    lay = float((got - want).abs().max() / want.abs().max())
    log(f"8d (c): NHWC + s2d stem vs NCHW, f32 forward at batch "
        f"{RESNET_CHECK_BATCH} on the same weights: max |diff| / max |NCHW| "
        f"{lay:.2e} (tol {LAYOUT_REL_TOL})")
    check(lay <= LAYOUT_REL_TOL, "8d: the NHWC s2d-stem net disagrees with "
          "the NCHW net")
    del net, want, got
    torch.cuda.empty_cache()
    s2d.cast("bfloat16")
    timer = Timer(torch)
    row = update_bf16_row(torch, timer, s2d, seed=26)
    del timer
    torch.cuda.empty_cache()
    trainer = gluon.Trainer(s2d.collect_params(), "sgd", dict(RESNET_SGD))
    data = resnet_data(torch, rng, RESNET_STEPS + 2, RESNET_BF16_BATCH,
                       layout="NHWC", dtype=torch.bfloat16)
    c, bf16 = resnet_train(torch, nd, ag, kernels, s2d, trainer, data,
                           "8d (c) bf16 NHWC s2d", groups=2)
    for name in ("sgd_mom_update", "sgd_mom_update.bf16"):
        check(c.get(name, 0) == RESNET_STEPS, f"8d (c): {name} launched "
              f"{c.get(name, 0)} times in {RESNET_STEPS} steps, expected one "
              "a step")
    add(c)
    del data, trainer, s2d
    torch.cuda.empty_cache()
    return counts, f32, bf16, row


def run_vision_phase(torch, rng, kernels):
    """8d: the vision path — (a) the zoo, (b) ResNet-50 f32 NCHW, (c)
    ``bench.py``'s bf16 NHWC s2d configuration. Returns the launch
    counts of (b) and (c) and the bf16 update kernel's row."""
    run_zoo_phase(torch, rng)
    counts, f32, bf16, row = run_resnet_phase(torch, rng, kernels)
    for label, s in (("f32 NCHW", f32), ("bf16 NHWC s2d", bf16)):
        log(f"8d resnet50 {label}: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in s.items() if k != "split"}
            | {"split": {k: round(v, 3) for k, v in s["split"].items()}}))
    return counts, row


# ------------------------------------------------- 8e: the compiled step --
# tests/test_hybridize_sweep.py's cases, on the port's layers
HYBRID_CASES = (
    ("dense", lambda nn: nn.Dense(8, activation="relu"), (4, 6)),
    ("dense_nobias", lambda nn: nn.Dense(5, use_bias=False), (3, 7)),
    ("conv2d", lambda nn: nn.Conv2D(6, 3, padding=1), (2, 3, 8, 8)),
    ("conv2d_nhwc", lambda nn: nn.Conv2D(6, 3, padding=1, layout="NHWC"),
     (2, 8, 8, 3)),
    ("conv1d", lambda nn: nn.Conv1D(4, 3, padding=1), (2, 3, 9)),
    ("conv2dT", lambda nn: nn.Conv2DTranspose(4, 2, strides=2),
     (2, 3, 5, 5)),
    ("maxpool", lambda nn: nn.MaxPool2D(2), (2, 3, 8, 8)),
    ("avgpool", lambda nn: nn.AvgPool2D(2), (2, 3, 8, 8)),
    ("gap", lambda nn: nn.GlobalAvgPool2D(), (2, 3, 6, 6)),
    ("batchnorm", lambda nn: nn.BatchNorm(), (4, 3, 5)),
    ("layernorm", lambda nn: nn.LayerNorm(), (4, 6)),
    ("instancenorm", lambda nn: nn.InstanceNorm(), (3, 4, 6)),
    ("dropout_eval", lambda nn: nn.Dropout(0.5), (4, 6)),
    ("embedding", lambda nn: nn.Embedding(20, 5), (3, 4)),
    ("leakyrelu", lambda nn: nn.LeakyReLU(0.1), (3, 5)),
    ("prelu", lambda nn: nn.PReLU(), (3, 5)),
    ("elu", lambda nn: nn.ELU(), (3, 5)),
    ("swish", lambda nn: nn.Swish(), (3, 5)),
    ("flatten", lambda nn: nn.Flatten(), (2, 3, 4)),
)
HYBRID_NO_GRAD = ("dropout_eval", "embedding")
HYBRID_BATCH = 8
# a graph replays the kernels the eager call launches, so hybridized
# outputs and gradients, and compiled steps, are held to the eager
# path's bits (max |diff| 0); a hybridized convolution may differ in the
# last bits (cuDNN may pick another algorithm inside a capture, whose
# workspace comes from the graph's pool): held to HYBRID_REL_TOL of the
# eager result's largest magnitude instead, and reported
HYBRID_REL_TOL = 1e-5
MLP_SIZES, MLP_LRS = (32, 16, 32, 16, 32), (0.05, 0.02, 0.05, 0.01, 0.03)
FT_STEPS, FT_LR, FT_ALPHA = 4, 0.05, 4096.0
FT_PROMPTS = (9, 17, 30, 12)
FT_ADAPTERS = ("ft", None, "ft", None)


def max_diff(a, b):
    """max |a - b| over tensors (0 for two Nones)."""
    if a is None and b is None:
        return 0.0
    return float((a.double() - b.double()).abs().max())


def hybrid_diff(got, want):
    """(max |got - want|, the same over want's largest magnitude)."""
    d = max_diff(got, want)
    return d, d / max(float(want.abs().max()), 1e-30)


def hybrid_case(torch, ag, nn, kernels, name, fn, shape, k):
    """One sweep case on the card: the hybridized call (twice: one
    capture) and, unless in HYBRID_NO_GRAD, the recorded pair (the input
    gradient), each against the eager call. Returns the largest (|diff|,
    relative |diff|)."""
    gen = torch.Generator().manual_seed(k)
    net = fn(nn)
    net.initialize(device=DEVICE, generator=gen)
    x = (torch.randint(0, 20, shape, generator=gen).float()
         if name == "embedding" else torch.randn(shape, generator=gen))
    x = x.to(DEVICE)
    with ag.pause():
        eager = net(x)
    net.hybridize()
    c0 = kernels.capture_count()
    with ag.pause():
        h1, h2 = net(x), net(x)
    check(kernels.capture_count() == c0 + 1, f"8e (a) {name}: "
          f"{kernels.capture_count() - c0} captures for one signature")
    worst = max(hybrid_diff(h1, eager), hybrid_diff(h2, eager))
    if name not in HYBRID_NO_GRAD:
        grads = []
        for block in (net, None):
            xi = x.clone().requires_grad_(True)
            if block is None:
                net.hybridize(active=False)
            with ag.record():
                loss = (net(xi) ** 2).sum()
            ag.backward(loss)
            grads.append(xi.grad)
        worst = max(worst, hybrid_diff(*grads))
    return worst


def run_hybridize_sweep(torch, rng, kernels):
    """8e (a): every case of tests/test_hybridize_sweep.py hybridized on
    the card against its eager call (and, recorded, its input
    gradient); ResNet-50 v1 eval at batch 8 hybridized: one capture,
    none on a repeated call, the eager output's bits, and a reload of new
    weights read by the next replay."""
    import tempfile
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.initializer import Xavier
    t0 = time.monotonic()
    worst = {name: hybrid_case(torch, ag, nn, kernels, name, fn, shape, k)
             for k, (name, fn, shape) in enumerate(HYBRID_CASES)}
    exact = [n for n, (d, _) in worst.items() if d == 0.0]
    log("8e (a): hybridized vs eager on the card, max |diff| (relative) "
        "(outputs; recorded: the input gradient too): " + ", ".join(
            f"{n} {d:.1e} ({r:.1e})" for n, (d, r) in worst.items())
        + f"; {len(exact)} of {len(worst)} bit for bit (tol "
        f"{HYBRID_REL_TOL} relative)")
    check(all(r <= HYBRID_REL_TOL for _, r in worst.values()), "8e (a): a "
          "hybridized layer's graph disagrees with its eager call")
    net = vision.resnet50_v1(prefix="r50h_")
    net.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(1))
    x = torch.from_numpy(rng.randn(HYBRID_BATCH, 3, 224, 224)
                         .astype(np.float32)).to(DEVICE)
    with ag.pause():
        eager = net(x)
    net.hybridize()
    c0 = kernels.capture_count()
    t1 = time.monotonic()
    with ag.pause():
        h1 = net(x)
    torch.cuda.synchronize()
    first_s = time.monotonic() - t1
    with ag.pause():
        h2 = net(x)
    check(kernels.capture_count() == c0 + 1, "8e (a): ResNet-50 eval "
          "took more than one capture")
    twin = vision.resnet50_v1(prefix="r50h_")
    twin.initialize(Xavier(), device=DEVICE,
                    generator=torch.Generator().manual_seed(2))
    with ag.pause():
        want = twin(x)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "r50h.params")
        twin.save_parameters(path)
        net.load_parameters(path)
    with ag.pause():
        h3 = net(x)
    torch.cuda.synchronize()
    diffs = (hybrid_diff(h1, eager), hybrid_diff(h2, eager),
             hybrid_diff(h3, want))
    log(f"8e (a): ResNet-50 v1 eval at batch {HYBRID_BATCH} hybridized: "
        f"capture + first replay {first_s:.2f}s, "
        f"{kernels.capture_count() - c0} capture, max |diff| (relative) vs "
        f"eager {diffs[0][0]:.1e} ({diffs[0][1]:.1e}) / {diffs[1][0]:.1e}; "
        f"after loading new weights in place {diffs[2][0]:.1e} "
        f"({diffs[2][1]:.1e}; vs the new weights' eager net); "
        f"{time.monotonic() - t0:.1f}s for (a)")
    check(kernels.capture_count() == c0 + 1 and
          max(r for _, r in diffs) <= HYBRID_REL_TOL,
          "8e (a): hybridized ResNet-50 disagrees with its eager call")


def compiled_mlp(torch, seed, bn=False):
    """tests/test_compiled_step.py's ``_build`` on the card."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.initializer import Xavier
    net = nn.HybridSequential(prefix=f"cs8e{seed}_")
    with net.name_scope():
        if bn:
            net.add(nn.Dense(16), nn.BatchNorm(), nn.Activation("relu"),
                    nn.Dense(4))
        else:
            net.add(nn.Dense(16, activation="relu"), nn.Dense(4))
    net.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(seed))
    with ag.pause():
        net(torch.zeros(1, 6, device=DEVICE))
    return net


def params_of(net):
    return {k: p.data().detach().clone()
            for k, p in sorted(net.collect_params().items())}


def run_compiled_mlp_cases(torch, kernels):
    """8e (b): the reference's MLP cases compiled against eager on the
    card: five steps across lr and batch-size changes (SGD momentum and
    Adam, with and without a BatchNorm), the eager bits; one replay per
    steady step, no capture after the two buckets' warm-up across warm
    tails, ``cache_size() == 2``; the BatchNorm's running statistics
    move; a forced float16 overflow leaves every weight."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    r = np.random.RandomState(7)
    X = torch.from_numpy(r.randn(8, 32, 6).astype(np.float32)).to(DEVICE)
    Y = torch.from_numpy((np.arange(256).reshape(8, 32) % 4)
                         .astype(np.float32)).to(DEVICE)
    rows = []
    for opt, args in (("sgd", {"learning_rate": 0.05, "momentum": 0.9,
                               "wd": 1e-4}),
                      ("adam", {"learning_rate": 1e-3, "wd": 1e-3})):
        for bn in (False, True):
            net_e, net_c = compiled_mlp(torch, 0, bn), compiled_mlp(
                torch, 0, bn)
            stats0 = {k: v for k, v in params_of(net_c).items()
                      if "running" in k}
            tr_e = gluon.Trainer(net_e.collect_params(), opt, dict(args))
            tr_c = gluon.Trainer(net_c.collect_params(), opt, dict(args))
            step = tr_c.compile_step(
                lambda x, y, net=net_c: loss_fn(net(x), y))
            c0, diff = kernels.capture_count(), 0.0
            for s, n in enumerate(MLP_SIZES):
                tr_e.set_learning_rate(MLP_LRS[s])
                tr_c.set_learning_rate(MLP_LRS[s])
                with ag.record():
                    le = loss_fn(net_e(X[s][:n]), Y[s][:n])
                ag.backward(le)
                tr_e.step(n)
                replays = step.replays
                lc = step(X[s][:n], Y[s][:n])
                diff = max(diff, max_diff(le.detach(), lc))
                if s >= 2:
                    check(step.replays == replays + 1, f"8e (b) {opt} bn="
                          f"{bn}: step {s} took "
                          f"{step.replays - replays} replays")
            pe, pc = params_of(net_e), params_of(net_c)
            diff = max(diff, max(max_diff(pe[k], pc[k]) for k in pe))
            # tails padded to the warm buckets: no capture
            for s, n in zip(range(5, 8), (20, 9, 19)):
                step(X[s][:n], Y[s][:n])
            moved = all(not torch.equal(v, pc[k]) for k, v in stats0.items())
            rows.append(f"{opt}{' bn' if bn else ''} {diff:.1e}")
            check(step.last_reason is None and step.cache_size() == 2
                  and kernels.capture_count() == c0 + 2, f"8e (b) {opt} "
                  f"bn={bn}: reason {step.last_reason}, "
                  f"{step.cache_size()} graphs, "
                  f"{kernels.capture_count() - c0} captures")
            check(diff == 0.0, f"8e (b) {opt} bn={bn}: compiled and eager "
                  f"differ by {diff}")
            check(moved, f"8e (b) {opt} bn={bn}: the running statistics "
                  "did not move")
            step.release()
    net = compiled_mlp(torch, 4)
    tr = gluon.Trainer(net.collect_params(), "sgd", {"learning_rate": .05})
    amp.init_trainer(tr, loss_scaler=amp.LossScaler(
        init_scale=1e39, target_dtype="float16"))
    step = tr.compile_step(lambda x, y: loss_fn(net(x), y))
    before = params_of(net)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for s in range(2):
            step(X[s], Y[s])
    after = params_of(net)
    check(all(torch.equal(before[k], after[k]) for k in before) and
          tr._step_count == 0 and step.cache_size() == 1,
          "8e (b): a float16 overflow moved a weight or a step")
    log("8e (b): the reference's MLP cases, compiled vs eager on the card "
        f"(5 steps, lr and batch changes, then tails 20, 9, 19), max "
        f"|diff| of losses and weights: {', '.join(rows)}; one replay a "
        "steady step, 2 captures, cache_size 2; BN statistics moved; a "
        f"forced f16 overflow (scale 1e39 -> {tr._amp_loss_scaler.loss_scale:g}"
        ") left every weight and the step count")


def compiled_summary(torch, step, times, prof, wall, batch, unit):
    """Step ms (median of the timed steps but the first), rate, peak
    GB, profiled device ms a step, idle, capture seconds and the graph
    pool's GB of a compiled step's run."""
    share = report_profile(prof, wall, 2)
    step_ms = float(np.median(times[1:])) * 1e3
    return {"step_ms": step_ms, unit: batch / step_ms * 1e3,
            "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "device_ms": device_rows(prof)[1] / 1e3 / 2,
            "idle": None if share is None else 1 - share,
            "capture_s": sum(step.capture_seconds.values()),
            "pool_gb": step.graph_pool_bytes() / 1e9,
            "first_ms": times[0] * 1e3}


def beside(label, got, eager, unit):
    def fmt(v, f):
        return "not measured" if v is None else format(v, f)
    log(f"{label}: compiled step {fmt(got['step_ms'], '.2f')} ms (eager "
        f"{fmt(eager.get('step_ms'), '.2f')}), {unit} "
        f"{fmt(got[unit], '.1f')} (eager {fmt(eager.get(unit), '.1f')}), "
        f"profiled device ms a step {fmt(got['device_ms'], '.2f')} (eager "
        f"{fmt(eager.get('device_ms'), '.2f')}), idle "
        f"{fmt(got['idle'], '.3f')} (eager {fmt(eager.get('idle'), '.3f')}),"
        f" peak GB {got['peak_gb']:.2f} (eager "
        f"{fmt(eager.get('peak_gb'), '.2f')}); warm run + capture "
        f"{got['capture_s']:.2f}s (first call {got['first_ms']:.0f} ms), "
        f"graph pool {got['pool_gb']:.2f} GB")
    log(f"8e row {label}: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in got.items()}))


def profiled(torch, fn, batches):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for b in batches:
            fn(*b)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    return prof, wall


def run_compiled_bert(torch, rng, kernels, use_amp, cfg=BERT_BASE,
                      batch=BERT_BATCH, seqlen=BERT_T, steps=BERT_STEPS):
    """8e (c): BERT-base as phase 8 trains it, through ``compile_step``
    (f32 with TF32 off, or under ``amp.init()`` bf16): one compiled step
    against one eager step from the same weights at dropout 0 (the loss,
    and each parameter's gradient as Adam's first moment after the
    step, to phase 8's tolerances), then ``steps`` steps at dropout 0.1
    with falling loss, one replay a step after the first, 12 launches a
    replay of each flash kernel and one update launch, fresh dropout
    masks at each replay, and two profiled steps. Returns the launch
    counts of the timed steps."""
    from mxnet_tpu_torch import amp
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.ops.flash_attention import KERNEL_NAMES, kernel_name
    label = "8e (c) bert" + (" amp bf16" if use_amp else " f32")
    vocab, layers = cfg["vocab_size"], cfg["num_layers"]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    data = bert_batches(torch, rng, steps + 3, vocab, batch, seqlen, DEVICE)
    if use_amp:
        data = [(x.int(), y, w, vl) for x, y, w, vl in data]
        amp.init()
    names = [kernel_name(n, torch.bfloat16) if use_amp else n
             for n in KERNEL_NAMES]
    loss_tol = AMP_LOSS_REL_TOL if use_amp else BERT_LOSS_REL_TOL
    grad_tol = AMP_GRAD_REL_TOL if use_amp else BERT_GRAD_REL_TOL
    try:
        def make(dropout):
            net = make_bert_mlm(dropout, **cfg)
            net.initialize(Xavier(), device=DEVICE,
                           generator=torch.Generator().manual_seed(0))
            with ag.pause():
                mlm_loss(net, loss_fn, data[0], vocab)
            tr = gluon.Trainer(net.collect_params(), "adam",
                               {"learning_rate": BERT_LR})
            if use_amp:
                amp.init_trainer(tr)
            return net, tr
        # one step each from the same weights, dropout 0
        (net_e, tr_e), (net_c, tr_c) = make(0.0), make(0.0)
        with ag.record():
            le = mlm_loss(net_e, loss_fn, data[0], vocab)
        ag.backward(le)
        tr_e.step(batch)
        step = tr_c.compile_step(
            lambda *d: mlm_loss(net_c, loss_fn, d, vocab), buckets=False)
        lc = float(step(*data[0]))
        le = float(le.detach())
        loss_rel = abs(lc - le) / abs(le)
        worst = (0.0, "")
        se, sc = tr_e._updaters[0].states, tr_c._updaters[0].states
        names_e = [p.name for p in tr_e._params]
        for i in se:
            m_e, m_c = se[i][0], sc[i][0]
            if float(m_e.norm()) > 0:
                worst = max(worst, (norm_rel(m_c, m_e), names_e[i]))
        log(f"{label}: one compiled step vs one eager step, same weights, "
            f"dropout 0: loss {lc:.6f} vs {le:.6f} (relative "
            f"{loss_rel:.3e}, tol {loss_tol}); gradients through the "
            f"update (Adam's first moment, norm-relative) worst "
            f"{worst[0]:.3e} ({worst[1]}; tol {grad_tol})")
        check(step.last_reason is None, f"{label}: fell back "
              f"({step.last_reason})")
        check(loss_rel <= loss_tol and worst[0] <= grad_tol,
              f"{label}: the compiled step disagrees with the eager step")
        step.release()
        del net_e, tr_e, net_c, tr_c, step
        torch.cuda.empty_cache()
        # training at dropout 0.1
        net, tr = make(0.1)
        probe = {}
        drop = next(m for m in net.modules() if isinstance(m, nn.Dropout))
        torch.nn.Module.register_forward_hook(
            drop, lambda m, i, o: probe.__setitem__("out", o))
        step = tr.compile_step(
            lambda *d: mlm_loss(net, loss_fn, d, vocab), buckets=False)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launch_counts()
        c0, b0 = kernels.capture_count(), None
        losses, times, masks = [], [], []
        for i, d in enumerate(data[1:1 + steps]):
            t0 = time.monotonic()
            loss = step(*d)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
            losses.append(loss.item())
            if i == 0:
                b0 = kernels.build_count()
            if i in (1, 2):
                masks.append((probe["out"] == 0).clone())
        launches = kernels.launch_counts()
        check(step.last_reason is None and step.replays == steps - 1
              and kernels.capture_count() == c0 + 1
              and step.cache_size() == 1
              and kernels.build_count() == b0,
              f"{label}: reason {step.last_reason}, {step.replays} replays "
              f"in {steps} steps, {kernels.capture_count() - c0} captures")
        check(all(np.isfinite(losses)) and losses[-1] < losses[0],
              f"{label}: losses {losses}")
        for name in names:
            check(launches.get(name, 0) == layers * steps, f"{label}: "
                  f"{name} launched {launches.get(name, 0)} times in "
                  f"{steps} steps (the first a warm run, the rest "
                  f"replays), expected {layers} each")
        check(launches.get("adam_update", 0) == steps, f"{label}: "
              f"adam_update launched {launches.get('adam_update', 0)} "
              f"times in {steps} steps")
        check(not torch.equal(masks[0], masks[1]), f"{label}: two replays "
              "drew the same dropout mask")
        prof, wall = profiled(torch, step, data[1 + steps:3 + steps])
        got = compiled_summary(torch, step, times, prof, wall,
                               batch * seqlen, "tokens_s")
        log(f"{label}: {steps} Adam steps (dropout 0.1): losses "
            + " ".join(f"{v:.4f}" for v in losses) + f"; dropout masks of "
            f"two replays differ in {int((masks[0] != masks[1]).sum())} "
            f"of {masks[0].numel()} entries; launches {launches}")
        beside(label, got, EAGER_ROWS.get("bert amp" if use_amp
                                          else "bert", {}), "tokens_s")
        step.release()
        return launches
    finally:
        if use_amp:
            amp.uninit()


def run_compiled_resnet(torch, rng, kernels, bf16):
    """8e (d): ResNet-50 v1 exactly as ``bench.py`` builds and trains it,
    through ``compile_step``: bf16 NHWC with the s2d stem at batch 128
    (``bf16``) or f32 NCHW at batch 32; bench.py's loss (the per-sample
    NLL of the f32 log-softmax through ``pick``), SGD lr 1e-3 momentum
    0.9. RESNET_STEPS steps: no fallback, finite losses, one replay a
    step after the first, the update launches of a step (two in bf16:
    the bf16 weights and the f32 BatchNorm group), then two profiled
    steps. Returns the launch counts of the timed steps."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch.gluon.model_zoo import vision
    from mxnet_tpu_torch.initializer import Xavier
    nd.random.seed(0)
    if bf16:
        label, batch, layout = "8e (d) bf16 NHWC s2d", RESNET_BF16_BATCH, \
            "NHWC"
        net = vision.resnet50_v1(layout="NHWC", stem_s2d=True,
                                 prefix="r50e_")
        shape = (1, 224, 224, 3)
    else:
        label, batch, layout = "8e (d) f32 NCHW", RESNET_F32_BATCH, "NCHW"
        net = vision.resnet50_v1(prefix="r50f_")
        shape = (1, 3, 224, 224)
    net.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
    with ag.pause():
        net(torch.ones(shape, device=DEVICE))
    if bf16:
        net.cast("bfloat16")
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(RESNET_SGD))
    step = trainer.compile_step(lambda x, y: resnet_loss(nd, net, x, y))
    data = resnet_data(torch, rng, RESNET_STEPS + 2, batch, layout=layout,
                       dtype=torch.bfloat16 if bf16 else None)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    c0 = kernels.capture_count()
    losses, times = [], []
    for x, y in data[:-2]:
        t0 = time.monotonic()
        loss = step(x, y)
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        losses.append(float(loss.mean().asnumpy()))
    launches = kernels.launch_counts()
    groups = ("sgd_mom_update", "sgd_mom_update.bf16") if bf16 else \
        ("sgd_mom_update",)
    check(step.last_reason is None and step.replays == RESNET_STEPS - 1
          and kernels.capture_count() == c0 + 1, f"{label}: reason "
          f"{step.last_reason}, {step.replays} replays, "
          f"{kernels.capture_count() - c0} captures")
    check(all(np.isfinite(losses)), f"{label}: non-finite loss {losses}")
    for g in groups:
        check(launches.get(g, 0) == RESNET_STEPS, f"{label}: {g} launched "
              f"{launches.get(g, 0)} times in {RESNET_STEPS} steps")
    prof, wall = profiled(torch, step, data[-2:])
    got = compiled_summary(torch, step, times, prof, wall, batch,
                           "images_s")
    log(f"{label}: {RESNET_STEPS} SGD-momentum steps at batch {batch}: "
        "losses " + " ".join(f"{v:.4f}" for v in losses)
        + f"; update launches {[launches.get(g, 0) for g in groups]}")
    eager = EAGER_ROWS.get("8d (c) bf16 NHWC s2d" if bf16
                           else "8d (b) f32 NCHW", {})
    beside(label, got, eager, "images_s")
    COMPILED_ROWS[label] = got
    step.release()
    del net, trainer, step, data
    torch.cuda.empty_cache()
    return launches


def run_lora_finetune_phase(torch, rng, kernels):
    """8e (e): ``LoRAFineTuneJob`` on the f32 serving decoder's frozen
    base (GPT-2-small widths, seeded weights) beside an ``LLMServer``
    over a bank of ``LORA_BANK``'s geometry: ``AdapterFineTunePublisher``
    rounds of FT_STEPS compiled steps each, then ``run_once``'s publish;
    the stream served under the adapter changes between two published
    versions, the base rows' streams do not; the job's step is one
    capture and one replay a step after the first. Returns the launch
    counts of the rounds and their serving."""
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.serving.adapters import (
        AdapterBank, AdapterFineTunePublisher, LoRAFineTuneJob)
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    cfg = GPT2_SMALL
    model = TinyDecoder(device=DEVICE, **cfg)
    params = params_from_numpy(model.init_params_numpy(0), DEVICE)
    bank = AdapterBank(cfg["num_layers"], cfg["d_model"], device=DEVICE,
                       **LORA_BANK)
    server = LLMServer(model, params, name="gpt2-finetune",
                       max_seqs=MAX_SEQS, block_size=BLOCK_SIZE,
                       adapter_bank=bank, device=DEVICE)
    warm_server(torch, server, "8e (e)")
    server.start()
    job = LoRAFineTuneJob(model, params, "ft", rank=LORA_BANK["page_rank"],
                          learning_rate=FT_LR, seed=5)
    losses = []

    def train_step():
        losses.append(job.step(batch_size=8))
    # published at FT_ALPHA: the few steps' factors move the served
    # logits by a visible amount
    pub = AdapterFineTunePublisher(bank, job.name, train_step, job.get_ab,
                                   steps_per_publish=FT_STEPS,
                                   alpha=FT_ALPHA)
    prompts = [rng.randint(0, cfg["vocab_size"], size=n).tolist()
               for n in FT_PROMPTS]
    kernels.reset_launch_counts()
    streams = []
    for _ in range(2):
        version = pub.run_once()
        res, _, _ = serve_lora(torch, server, prompts, list(FT_ADAPTERS))
        streams.append([r.tokens for r in res])
    launches = kernels.launch_counts()
    server.shutdown()
    step = job.step_fn
    changed = [a != b for a, b, n in zip(*streams, FT_ADAPTERS)
               if n is not None]
    same = [a == b for a, b, n in zip(*streams, FT_ADAPTERS) if n is None]
    log(f"8e (e): LoRA fine-tune at GPT-2-small widths, rank "
        f"{job.rank}: {2 * FT_STEPS} compiled steps, losses "
        + " ".join(f"{v:.4g}" for v in losses) + f"; published versions "
        f"up to {version}; adapter rows' streams changed {changed}, base "
        f"rows' unchanged {same}; {step.replays} replays, "
        f"{step.cache_size()} graph")
    check(step.last_reason is None and step.cache_size() == 1 and
          step.replays == 2 * FT_STEPS - 1, f"8e (e): the job's step "
          f"(reason {step.last_reason}, {step.cache_size()} graphs, "
          f"{step.replays} replays)")
    check(all(np.isfinite(losses)), "8e (e): a non-finite fine-tune loss")
    check(any(changed), "8e (e): no stream under the adapter changed "
          "between the published versions")
    check(all(same), "8e (e): a base row's stream changed")
    return launches


def run_compiled_phase(torch, rng, kernels):
    """8e: the compiled step — (a) the hybridize sweep and ResNet-50
    eval, (b) the reference's MLP cases, (c) BERT-base f32 and AMP bf16,
    (d) ResNet-50 as bench.py trains it, (e) the LoRA fine-tune job.
    Returns the launch counts of (c)-(e)."""
    counts = {}

    def add(c):
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
    t0 = time.monotonic()
    run_hybridize_sweep(torch, rng, kernels)
    run_compiled_mlp_cases(torch, kernels)
    log(f"time: 8e (a)-(b) {time.monotonic() - t0:.1f}s")
    for use_amp in (False, True):
        add(run_compiled_bert(torch, rng, kernels, use_amp))
        torch.cuda.empty_cache()
    log(f"time: 8e (c) {time.monotonic() - t0:.1f}s")
    for bf16 in (False, True):
        add(run_compiled_resnet(torch, rng, kernels, bf16))
    log(f"time: 8e (d) {time.monotonic() - t0:.1f}s")
    add(run_lora_finetune_phase(torch, rng, kernels))
    torch.cuda.empty_cache()
    return counts


# ------------------------ phase 8f: the sparse tier and the optimizer tail --
# (a) MovieLens-20M's id counts as GroupLens publishes them (138,493 users,
# 27,278 movies), rank 128, batch 1024; ratings synthetic, planted at rank
# 16 from the seed; ids drawn skewed (id = n * u^3: popular ids repeat in
# a batch, as ratings do); MF_BATCHES fixed batches cycled over MF_STEPS
# steps, so the loss on them falls and most rows are never touched
ML20M_USERS, ML20M_MOVIES = 138493, 27278
MF_RANK, MF_BATCH, MF_STEPS, MF_BATCHES, MF_PLANTED = 128, 1024, 20, 4, 16
MF_OPTS = (("sgd", {"learning_rate": 5.0, "momentum": 0.9}),
           ("adam", {"learning_rate": 0.01}),
           ("adagrad", {"learning_rate": 0.1}))
# (b) one table of 2^20 x 128 f32 under Adam, 4096 ids a batch
LAZY_ROWS, LAZY_DIM, LAZY_IDS, LAZY_STEPS = 1 << 20, 128, 4096, 10
# (c) CSR batches of 1024 rows over 2^20 features, 39 non-zeros a row (the
# Criteo click logs' field count), times a dense (2^20, 1) weight
CSR_ROWS, CSR_FEATURES, CSR_NNZ = 1024, 1 << 20, 39
# (d) the eleven new optimizers on BERT-base's gradients (8b's setup)
OPT_TAIL = (("adadelta", {}), ("adamax", {}), ("nadam", {}), ("ftml", {}),
            ("lamb", {}), ("lars", {"momentum": 0.9}),
            ("dcasgd", {"momentum": 0.9}), ("sgld", {}),
            ("lbsgd", {"momentum": 0.9}), ("groupadagrad", {}),
            ("test", {}))
OPT_TAIL_STEPS = 3
# card against CPU copies: a lazy step (the same operations in the same
# order; the repeats summed in a fixed order) within 1e-6 of the weights'
# scale; the optimizer tail's steps within 1e-5 of each tensor's scale
# (LARS/LBSGD norms and GroupAdaGrad's row means are sums in another
# order on the card); sparse.dot and its gradient (an atomic sum on the
# card) within 1e-5 of the output's scale; the multi-tensor LAMB against
# the per-tensor phases 1e-6
SPARSE_CARD_TOL = 1e-6
OPT_TAIL_REL_TOL = 1e-5
SPARSE_DOT_TOL = 1e-5
MULTI_LAMB_TOL = 1e-6


def _cpu_state(torch, state):
    if state is None:
        return None
    if isinstance(state, (tuple, list)):
        return type(state)(_cpu_state(torch, s) for s in state)
    return state.detach().cpu().clone()


def _state_leaves(state):
    if state is None:
        return []
    if isinstance(state, (tuple, list)):
        return [x for s in state for x in _state_leaves(s)]
    return [state]


def mf_net(torch, gluon, seed, users, movies, rank, dev):
    """MFNet of ``examples/recommender_mf.py`` with ``sparse_grad=True`` on
    both tables, weights N(0, 0.1) from ``seed`` (on the host)."""
    class MFNet(gluon.Block):
        def __init__(self):
            super().__init__(prefix="mf_")
            with self.name_scope():
                self.user = gluon.nn.Embedding(users, rank, sparse_grad=True,
                                               prefix="user_")
                self.item = gluon.nn.Embedding(movies, rank,
                                               sparse_grad=True,
                                               prefix="item_")

        def forward(self, u, i):
            return (self.user(u) * self.item(i)).sum(dim=-1)
    net = MFNet()
    net.initialize(device=dev)
    gen = torch.Generator().manual_seed(seed)
    for p in (net.user.weight, net.item.weight):
        p.set_data(torch.randn(p.shape, generator=gen) * 0.1)
    return net


def mf_batches(torch, rng, users, movies, dev):
    """MF_BATCHES (user ids, movie ids, planted ratings) on ``dev``."""
    pu = rng.randn(users, MF_PLANTED).astype(np.float32) * 0.5
    pv = rng.randn(movies, MF_PLANTED).astype(np.float32) * 0.5
    out = []
    for _ in range(MF_BATCHES):
        u = (users * rng.rand(MF_BATCH) ** 3).astype(np.int64)
        m = (movies * rng.rand(MF_BATCH) ** 3).astype(np.int64)
        y = (pu[u] * pv[m]).sum(-1).astype(np.float32)
        out.append(tuple(torch.from_numpy(a).to(dev) for a in (u, m, y)))
    return out


def lazy_cpu_step(torch, topt, tr, snap, grads):
    """The Trainer's step again on CPU copies: the weights, gradients and
    states ``snap``/``grads`` took before it, the optimizer's counts as
    they stood. Returns the CPU updater (its states and weights)."""
    opt = tr.optimizer
    name = type(opt).__name__.lower()
    upd = topt.get_updater(topt.create(name, **snap["kw"]))
    upd.optimizer._index_update_count = dict(snap["counts"])
    upd.optimizer.num_update = snap["num_update"]
    upd.optimizer.rescale_grad = opt.rescale_grad
    upd.states = dict(snap["states"])
    upd.states_synced = dict.fromkeys(upd.states, True)
    for i, (w, g) in enumerate(zip(snap["weights"], grads)):
        upd(i, g, w)
    return upd


def run_mf_case(torch, nd, ag, gluon, topt, sparse, name, kw, batches,
                dev):
    """(a) one optimizer: MF_STEPS Trainer steps of the MF net; returns
    its summary and fails on a check."""
    loss_fn = gluon.loss.L2Loss()
    net = mf_net(torch, gluon, 7, ML20M_USERS, ML20M_MOVIES, MF_RANK, dev)
    params = [net.item.weight, net.user.weight]     # the Trainer's order
    tr = gluon.Trainer(net.collect_params(), name, dict(kw))
    w0 = [p.data().detach().clone() for p in params]
    losses, times = [], []
    snap = None
    for s in range(MF_STEPS):
        u, m, y = batches[s % MF_BATCHES]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ag.record():
            loss = loss_fn(net(u, m), y)
        ag.backward(loss)
        if s == MF_STEPS - 1:
            grads = [p.grad() for p in params]
            check(all(isinstance(g, sparse.RowSparseNDArray) and
                      not g.densified for g in grads),
                  f"8f (a) {name}: a gradient was not row-sparse")
            snap = {"kw": dict(kw),
                    "counts": dict(tr.optimizer._index_update_count),
                    "num_update": tr.optimizer.num_update,
                    "weights": [p.data().detach().cpu().clone()
                                for p in params],
                    "states": {i: _cpu_state(torch, st) for i, st in
                               tr._updaters[0].states.items()}}
            cpu_grads = [sparse.RowSparseNDArray(
                g._values.cpu(), g._indices.cpu(), g.shape) for g in grads]
        tr.step(MF_BATCH)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(float(loss.detach().mean()))
    # untouched rows: weights and states keep their bits
    touched = [torch.unique(torch.cat([b[k] for b in batches]))
               for k in (1, 0)]
    untouched_ok = True
    for i, (p, w, t) in enumerate(zip(params, w0, touched)):
        rest = torch.ones(p.shape[0], dtype=torch.bool, device=dev)
        rest[t] = False
        untouched_ok &= bool(torch.equal(p.data().detach()[rest], w[rest]))
        for st in _state_leaves(tr._updaters[0].states[i]):
            untouched_ok &= not bool(st[rest].any())
    # the last step on CPU copies
    cpu = lazy_cpu_step(torch, topt, tr, snap, cpu_grads)
    err, scale = 0.0, 0.0
    for i, p in enumerate(params):
        got = [p.data().detach()] + _state_leaves(tr._updaters[0].states[i])
        want = [snap["weights"][i]] + _state_leaves(cpu.states[i])
        for a, b in zip(got, want):
            err = max(err, float((a.cpu() - b).abs().max()))
        scale = max(scale, float(snap["weights"][i].abs().max()))
    fallbacks = dict(tr._fused.fallbacks)
    # the profiled steps (4, one of each batch), then the compiled step
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        for u, m, y in batches:
            with ag.record():
                loss = loss_fn(net(u, m), y)
            ag.backward(loss)
            tr.step(MF_BATCH)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    share = report_profile(prof, wall, MF_BATCHES)
    busy = PROFILED.get("busy_ms")
    step = tr.compile_step(lambda u, m, y: loss_fn(net(u, m), y))
    step(*batches[0])
    first = float(np.mean(losses[:MF_BATCHES]))
    last = float(np.mean(losses[-MF_BATCHES:]))
    res = {"name": name, "step_ms": float(np.median(times[1:])) * 1e3,
           "device_ms": None if busy is None else busy / MF_BATCHES,
           "idle": None if share is None else 1 - share,
           "first": first, "last": last, "err": err, "scale": scale,
           "fallbacks": fallbacks, "compiled": step.last_reason,
           "touched": [int(t.numel()) for t in touched]}
    log(f"8f (a) {name} {kw}: MF net {ML20M_USERS} users x "
        f"{ML20M_MOVIES} movies rank {MF_RANK}, batch {MF_BATCH}, "
        f"{MF_STEPS} steps over {MF_BATCHES} batches ({res['touched'][1]} "
        f"users, {res['touched'][0]} movies touched): loss {first:.5f} -> "
        f"{last:.5f}; step {res['step_ms']:.2f} ms (median, forward + "
        f"backward + Trainer.step), device "
        + ("not measured" if busy is None else
           f"{res['device_ms']:.3f} ms/step, idle {res['idle']:.3f}")
        + f"; last step vs CPU copies max_abs_err={err:.3e} (weights' "
        f"scale {scale:.3f}); untouched rows kept their bits "
        f"{untouched_ok}; fused fallbacks {fallbacks}; compile_step "
        f"{step.last_reason}")
    check(last < first, f"8f (a) {name}: the loss did not fall "
          f"({first} -> {last})")
    check(untouched_ok, f"8f (a) {name}: an untouched row or its state "
          "changed")
    check(err <= SPARSE_CARD_TOL * scale, f"8f (a) {name}: the card's step "
          f"differs from the CPU's by {err}")
    check(fallbacks == {"sparse_grad": MF_STEPS}, f"8f (a) {name}: fused "
          f"fallbacks {fallbacks}")
    check(step.last_reason == "sparse_grad", f"8f (a) {name}: compile_step "
          f"reason {step.last_reason}")
    del net, tr, step
    return res


def run_lazy_vs_dense(torch, nd, ag, gluon, rng, dev):
    """(b) a 2^20 x 128 table under Adam, LAZY_IDS ids a batch: the lazy
    step (``sparse_grad=True``) against the dense one, from the same
    weights and ids: median full-step and ``Trainer.step`` ms over
    LAZY_STEPS steps; the same weights after the first step (within
    1e-5 of their scale: two Adam implementations)."""
    gen = torch.Generator().manual_seed(11)
    w = (torch.randn(LAZY_ROWS, LAZY_DIM, generator=gen) * 0.02).to(dev)
    ids = [torch.from_numpy(rng.randint(0, LAZY_ROWS, LAZY_IDS)).to(dev)
           for _ in range(LAZY_STEPS + 1)]
    out, first = {}, {}
    for sparse_grad in (True, False):
        emb = gluon.nn.Embedding(LAZY_ROWS, LAZY_DIM,
                                 sparse_grad=sparse_grad,
                                 prefix=f"lazy{int(sparse_grad)}_")
        emb.initialize(device=dev)
        emb.weight.set_data(w)
        tr = gluon.Trainer(emb.collect_params(), "adam",
                           {"learning_rate": 1e-3})
        full, upd = [], []
        for s, x in enumerate(ids):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ag.record():
                loss = (emb(x) ** 2).sum()
            loss.backward()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            tr.step(LAZY_IDS)
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if s == 0:
                first[sparse_grad] = emb.weight.data().detach().clone()
            else:
                full.append(t2 - t0)
                upd.append(t2 - t1)
        out[sparse_grad] = (float(np.median(full)) * 1e3,
                            float(np.median(upd)) * 1e3,
                            dict(tr._fused.fallbacks))
        del emb, tr
        torch.cuda.empty_cache()
    diff = float((first[True] - first[False]).abs().max())
    scale = float(w.abs().max())
    log(f"8f (b) Adam on one {LAZY_ROWS} x {LAZY_DIM} f32 table, "
        f"{LAZY_IDS} ids a batch: lazy step {out[True][0]:.3f} ms "
        f"(Trainer.step {out[True][1]:.3f} ms, fallbacks {out[True][2]}), "
        f"dense step {out[False][0]:.3f} ms (Trainer.step "
        f"{out[False][1]:.3f} ms, fallbacks {out[False][2]}); after one "
        f"step max |lazy - dense| = {diff:.3e} (scale {scale:.3f})")
    check(diff <= 1e-5 * scale, f"8f (b): the lazy and the dense Adam "
          f"step differ by {diff}")
    del w, first
    torch.cuda.empty_cache()
    return {"lazy_ms": out[True][0], "lazy_update_ms": out[True][1],
            "dense_ms": out[False][0], "dense_update_ms": out[False][1]}


def run_sparse_dot(torch, nd, ag, sparse, timer, rng, dev):
    """(c) ``sparse.dot`` of a CSR batch (CSR_ROWS x CSR_FEATURES,
    CSR_NNZ distinct columns a row) and a dense (CSR_FEATURES, 1)
    weight: the forward and the weight's gradient against the same op on
    CPU copies; forward and forward + backward ms, ``torch.sparse.mm``'s
    ms, the bound."""
    # CSR_NNZ distinct columns a row, sorted (the canonical CSR order)
    cols = np.concatenate([np.unique(rng.randint(0, CSR_FEATURES,
                                                 2 * CSR_NNZ))[:CSR_NNZ]
                           for _ in range(CSR_ROWS)])
    check(cols.size == CSR_ROWS * CSR_NNZ, "8f (c): a CSR row drew fewer "
          "distinct columns than asked")
    indptr = np.arange(0, CSR_ROWS * CSR_NNZ + 1, CSR_NNZ)
    data = rng.randn(CSR_ROWS * CSR_NNZ).astype(np.float32)
    w_np = (rng.randn(CSR_FEATURES, 1) * 0.01).astype(np.float32)
    dy = rng.randn(CSR_ROWS, 1).astype(np.float32)
    got = {}
    for d in (dev, "cpu"):
        csr = sparse.csr_matrix((data, cols, indptr),
                                shape=(CSR_ROWS, CSR_FEATURES), ctx=d)
        w = nd.array(w_np, ctx=d)
        w.attach_grad()
        with ag.record():
            out = sparse.dot(csr, w)
            loss = (out * nd.array(dy, ctx=d)).sum()
        loss.backward()
        got[str(d)] = (out.asnumpy(), w.grad.asnumpy(), csr.densified)
    (o, g, dens), (oc, gc, _) = got[str(dev)], got["cpu"]
    err_o = float(np.abs(o - oc).max()) / float(np.abs(oc).max())
    err_g = float(np.abs(g - gc).max()) / float(np.abs(gc).max())
    csr = sparse.csr_matrix((data, cols, indptr),
                            shape=(CSR_ROWS, CSR_FEATURES), ctx=dev)
    w = torch.from_numpy(w_np).to(dev)
    wg = w.clone().requires_grad_(True)
    dyt = torch.from_numpy(dy).to(dev)
    lib = torch.sparse_csr_tensor(csr._indptr, csr._indices, csr._values,
                                  (CSR_ROWS, CSR_FEATURES))
    fwd_ms = timer.ms(lambda: sparse._csr_dot(csr, w, False))
    bwd_ms = timer.ms(lambda: torch.autograd.grad(
        sparse._csr_dot(csr, wg, False), wg, dyt))
    lib_ms = timer.ms(lambda: torch.sparse.mm(lib, w))
    nnz = CSR_ROWS * CSR_NNZ
    # the values, their columns, the row pointers, the weight rows the
    # values name and the output, each once
    nbytes = nnz * 4 + nnz * 8 + (CSR_ROWS + 1) * 8 + nnz * 4 + CSR_ROWS * 4
    b_ms, b_by, _ = bound(nbytes, 2 * nnz)
    log(f"8f (c) sparse.dot CSR {CSR_ROWS} x {CSR_FEATURES} ({CSR_NNZ} "
        f"non-zeros a row) times ({CSR_FEATURES}, 1): forward rel err "
        f"{err_o:.2e}, weight gradient rel err {err_g:.2e} vs CPU copies; "
        f"densified {dens}; forward {fwd_ms:.4f} ms, forward + backward "
        f"{bwd_ms:.4f} ms, torch.sparse.mm {lib_ms:.4f} ms, bound "
        f"{b_ms:.5f} ms ({b_by}, {nbytes / 1e6:.2f} MB)")
    check(not dens, "8f (c): sparse.dot densified its CSR operand")
    check(err_o <= SPARSE_DOT_TOL and err_g <= SPARSE_DOT_TOL,
          f"8f (c): sparse.dot differs from the CPU's ({err_o}, {err_g})")
    return {"fwd_ms": fwd_ms, "fwd_bwd_ms": bwd_ms, "library_ms": lib_ms,
            "bound_ms": b_ms}


def tail_twin_check(torch, opt, subset, errs):
    """Wrap ``opt.update``: for each index of ``subset`` the same update
    runs again on CPU copies of its inputs from a copy of the
    optimizer's host state; ``errs`` gets each (max abs error over the
    weight and states) / the weight's scale (its largest magnitude
    before or after: a bias that starts at zero has the step's)."""
    import copy
    from mxnet_tpu_torch.optimizer.optimizer import _dense
    orig = opt.update

    def update(index, weight, grad, state):
        if index not in subset:
            return orig(index, weight, grad, state)
        host = copy.deepcopy({k: v for k, v in opt.__dict__.items()
                              if k not in ("param_dict", "update")})
        w0 = weight.detach().cpu().clone()
        g0 = _dense(grad).detach().cpu().clone()
        s0 = _cpu_state(torch, state)
        orig(index, weight, grad, state)
        twin = type(opt).__new__(type(opt))
        twin.__dict__.update(host)
        twin.param_dict = {}
        scale = max(float(w0.nan_to_num(0.0).abs().max()),
                    float(weight.detach().nan_to_num(0.0).abs().max()),
                    1e-30)
        twin.update(index, w0, g0, s0)
        err = max([nan_diff(torch, weight.detach().cpu(), w0)] +
                  [nan_diff(torch, a.cpu(), b) for a, b in zip(
                      _state_leaves(state), _state_leaves(s0))])
        errs.append(err / scale)
    opt.update = update


def nan_diff(torch, a, b):
    """max |a - b|, a NaN on both sides at one place counting 0 and a NaN
    on one side infinity."""
    both = torch.isnan(a) & torch.isnan(b)
    d = (a - b).abs().masked_fill(both, 0.0)
    return float(d.nan_to_num(float("inf")).max()) if d.numel() else 0.0


def run_optimizer_tail_on_bert(torch, rng, kernels, nd, ag, gluon, timer,
                               cfg=BERT_BASE, batch=BERT_BATCH,
                               seqlen=BERT_T):
    """(d) the eleven new optimizers through the Trainer on BERT-base's
    gradients (8b's setup), OPT_TAIL_STEPS steps each: the first step's
    update of every ninth tensor (up to 2.5M elements) checked against
    the same update on CPU copies (SGLD: its noise's statistics on the
    word embeddings), the later steps timed;
    then the multi-tensor LAMB ops over the 203 tensors against the
    per-tensor phases. Returns the step ms by optimizer."""
    import mxnet_tpu_torch.optimizer.optimizer as optmod
    from mxnet_tpu_torch.ops import optimizer_ops as ops
    from mxnet_tpu_torch.ops.registry import get as get_op
    net, loss_fn, params = bert_base_params(torch, cfg)
    d = bert_batches(torch, rng, 1, cfg["vocab_size"], batch, seqlen,
                     DEVICE)[0]
    with ag.record():
        loss = mlm_loss(net, loss_fn, d, cfg["vocab_size"])
    loss.backward()
    grads = [p.grad().clone() for p in params]
    start = [p.data().detach().clone() for p in params]
    subset = {i for i, p in enumerate(params)
              if i % 9 == 0 and p.data().numel() <= 2_500_000}
    big = max(range(len(params)), key=lambda i: params[i].data().numel())
    reads = [0]
    host_norm = optmod._host_norm

    def counted(x):
        reads[0] += 1
        return host_norm(x)
    optmod._host_norm = counted
    rows = {}
    try:
        for name, kw in OPT_TAIL:
            for p, s in zip(params, start):
                p.set_data(s)
            tr = gluon.Trainer(net.collect_params(), name, dict(kw))
            errs, times, noise = [], [], None
            if name != "sgld":
                tail_twin_check(torch, tr.optimizer, subset, errs)
            for k in range(OPT_TAIL_STEPS):
                for p, g in zip(params, grads):
                    p.grad().copy_(g)
                before = params[big].data().detach().clone() \
                    if name == "sgld" and k == 0 else None
                if k == 1:
                    # the first step is checked; the others are timed
                    tr.optimizer.__dict__.pop("update", None)
                    reads[0] = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tr.step(batch)
                torch.cuda.synchronize()
                if k:
                    times.append((time.perf_counter() - t0) * 1e3)
                if before is not None:
                    o = tr.optimizer
                    det = before - o.lr / 2 * (grads[big] * o.rescale_grad
                                               + o.wd * before)
                    noise = params[big].data().detach() - det
            if name == "adamax":
                # w -= lr * m / u divides 0 by 0 where a gradient entry
                # was 0 at every step (as the reference's): NaN there only
                finite = all(bool((torch.isfinite(p.data()) |
                                   (g == 0)).all())
                             for p, g in zip(params, grads))
            else:
                finite = all(bool(torch.isfinite(p.data()).all())
                             for p in params)
            worst = max(errs) if errs else None
            line = (f"8f (d) {name} {kw}: {OPT_TAIL_STEPS} Trainer steps "
                    f"on BERT-base gradients, trainer.step of steps 2-"
                    f"{OPT_TAIL_STEPS} " + " ".join(f"{t:.2f}" for t in times)
                    + f" ms; fused fallbacks {dict(tr._fused.fallbacks)}")
            if reads[0]:
                line += (f"; {reads[0] // len(times)} norms read on the "
                         "host a step")
            if noise is not None:
                n = noise.numel()
                lr = tr.optimizer.lr
                mean, var = float(noise.mean()), float(noise.var())
                line += (f"; noise on {n} elements mean {mean:.2e} var "
                         f"{var:.5f} (lr {lr})")
                check(abs(mean) < 4 * np.sqrt(lr / n) and
                      abs(var - lr) < 4 * lr * np.sqrt(2.0 / n),
                      f"8f (d) sgld: noise mean {mean}, var {var}")
            else:
                line += (f"; step 1's updates of {len(errs)} tensors vs CPU "
                         f"copies, max rel err {worst:.2e}")
                check(worst <= OPT_TAIL_REL_TOL, f"8f (d) {name}: the card "
                      f"differs from the CPU copies by {worst}")
            log(line)
            check(finite, f"8f (d) {name}: non-finite weights")
            check(dict(tr._fused.fallbacks) == {"optimizer": OPT_TAIL_STEPS},
                  f"8f (d) {name}: fallbacks {dict(tr._fused.fallbacks)}")
            rows[name] = float(np.median(times))
            del tr
    finally:
        optmod._host_norm = host_norm
    # the multi-tensor LAMB ops against the per-tensor phases
    shapes = [tuple(p.shape) for p in params]
    del net, params, start
    torch.cuda.empty_cache()
    for mp in (False, True):
        gen = torch.Generator(device=DEVICE).manual_seed(30 + mp)
        arrays, per = [], []
        lrs = [1e-3 * (1 + k % 3) for k in range(len(shapes))]
        wds = [0.01 * (k % 2) for k in range(len(shapes))]
        steps = [1 + k % 4 for k in range(len(shapes))]
        for k, (shape, g) in enumerate(zip(shapes, grads)):
            w32 = torch.randn(shape, generator=gen, device=DEVICE) * 0.05
            m = torch.randn(shape, generator=gen, device=DEVICE) * 1e-3
            v = torch.rand(shape, generator=gen, device=DEVICE) * 1e-4
            w = w32.to(torch.bfloat16) if mp else w32
            gg = g.to(torch.bfloat16) if mp else g
            arrays += [w, gg, m, v] + ([w32] if mp else [])
            per.append((w32, gg, m, v))
        name = "_multi_mp_lamb_update" if mp else "_multi_lamb_update"
        kw = dict(learning_rates=lrs, wds=wds, step_count=steps,
                  rescale_grad=1.0 / batch)
        outs = get_op(name).impl(arrays, **kw)
        n_out = 4 if mp else 3
        err = 0.0

        def per_tensor():
            res = []
            for k, (w32, gg, m, v) in enumerate(per):
                step, m1, v1 = ops.lamb_phase1(
                    w32, gg.float() if mp else gg, m, v, t=steps[k],
                    wd=wds[k], rescale_grad=1.0 / batch)
                r1 = torch.sqrt(torch.sum(w32 * w32))
                r2 = torch.sqrt(torch.sum(step * step))
                res.append((ops.lamb_phase2(w32, step, r1, r2, lr=lrs[k]),
                            m1, v1))
            return res
        for k, (new, m1, v1) in enumerate(per_tensor()):
            got = outs[k * n_out:k * n_out + 3]
            ref = (new.to(torch.bfloat16) if mp else new, m1, v1)
            for a, b in zip(got, ref):
                scale = max(float(b.float().abs().max()), 1e-30)
                err = max(err, float((a.float() - b.float()).abs().max())
                          / scale)
        multi_ms = timer.ms(lambda: get_op(name).impl(arrays, **kw), n=5)
        per_ms = timer.ms(per_tensor, n=5)
        tol = MULTI_LAMB_TOL if not mp else 2.0 ** -8
        log(f"8f (d) {name} over {len(shapes)} BERT-base tensors"
            + (" (bf16 weights and gradients)" if mp else "")
            + f": vs the per-tensor phases max rel err {err:.2e} "
            f"(tol {tol:g}); {multi_ms:.3f} ms, the per-tensor route "
            f"{per_ms:.3f} ms (plain PyTorch both)")
        check(err <= tol, f"8f (d) {name}: differs from the per-tensor "
              f"phases by {err}")
        rows[name] = multi_ms
        del arrays, per, outs
        torch.cuda.empty_cache()
    del grads
    torch.cuda.empty_cache()
    return rows


def run_kvstore_on_card(torch, nd, ag, gluon, sparse, dev):
    """(e) the store on the card: ``row_sparse_pull`` and a sparse push;
    2-bit compression against its CPU twin, bit for bit; a Trainer with
    a local store instance steps bit for bit as one with
    ``kvstore=None``."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch.kvstore import compression as gc
    gen = torch.Generator().manual_seed(12)
    table = (torch.randn(ML20M_USERS, MF_RANK, generator=gen) * 0.1).to(dev)
    kv = mx.kv.create("local")
    kv.init("user", table)
    ids = torch.randint(0, ML20M_USERS, (4096,), generator=gen).to(dev)
    out = sparse.zeros("row_sparse", tuple(table.shape), ctx=dev)
    kv.row_sparse_pull("user", out=out, row_ids=ids)
    rows = torch.unique(ids)
    pull_ok = torch.equal(out._indices, rows) and \
        torch.equal(out._values, table[rows]) and not out.densified
    a = sparse.RowSparseNDArray(torch.ones(3, MF_RANK, device=dev),
                                torch.tensor([5, 9, 5], device=dev),
                                tuple(table.shape))
    b = sparse.RowSparseNDArray(torch.ones(1, MF_RANK, device=dev),
                                torch.tensor([9], device=dev),
                                tuple(table.shape))
    kv.init("g", sparse.zeros("row_sparse", tuple(table.shape), ctx=dev))
    kv.push("g", [a, b])
    stored = kv._store["g"]
    dense = torch.zeros_like(table)
    kv.pull("g", out=dense)
    push_ok = isinstance(stored, sparse.RowSparseNDArray) and \
        stored._indices.tolist() == [5, 9, 5, 9] and \
        float(dense[5, 0]) == 2.0 and float(dense[9, 0]) == 2.0 and \
        int((dense != 0).any(dim=1).sum()) == 2
    comp = gc.TwoBitCompression(0.5)
    g = torch.randn(1 << 24, generator=gen) * 0.7
    r = torch.randn(1 << 24, generator=gen) * 0.1
    packed, res = comp.compress(g.to(dev), r.to(dev))
    packed_c, res_c = comp.compress(g, r)
    comp_ok = torch.equal(packed.cpu(), packed_c) and torch.equal(
        res.cpu(), res_c)
    nets = []
    w = (torch.randn(1024, 1024, generator=gen) * 0.03).to(dev)
    x = torch.randn(256, 1024, generator=gen).to(dev)
    for store in (None, mx.kv.create("local")):
        net = gluon.nn.Dense(1024, in_units=1024, prefix="kvnet_")
        net.initialize(device=dev)
        net.weight.set_data(w)
        net.bias.set_data(w[0])
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": 1e-3}, kvstore=store)
        for _ in range(2):
            with ag.record():
                loss = (net(x) ** 2).sum()
            loss.backward()
            tr.step(256)
        nets.append((net, tr))
    (n0, t0_), (n1, t1_) = nets
    same = all(torch.equal(a.data(), b.data()) for a, b in zip(
        n0.collect_params().values(), n1.collect_params().values()))
    log(f"8f (e) kvstore on the card: row_sparse_pull of 4096 ids "
        f"({rows.numel()} rows) from the {ML20M_USERS} x {MF_RANK} table "
        f"{'exact' if pull_ok else 'WRONG'}, a sparse push stays sparse "
        f"and sums {'right' if push_ok else 'WRONG'}; 2-bit compression "
        f"of 2^24 values: words and residual "
        f"{'bit for bit' if comp_ok else 'DIFFER'} with the CPU twin; a "
        f"Trainer with a local store (pushes and pulls each gradient, "
        f"kvstore {type(t1_._kvstore).__name__}) steps "
        f"{'bit for bit' if same else 'DIFFERENTLY'} as kvstore=None")
    check(pull_ok and push_ok, "8f (e): the store's sparse pull or push")
    check(comp_ok, "8f (e): 2-bit compression differs from the CPU twin")
    check(same and t1_._kvstore is not None and t0_._kvstore is None,
          "8f (e): the store instance's step differs from kvstore=None's")
    del table, nets, g, r
    torch.cuda.empty_cache()


def run_sparse_phase(torch, rng, kernels):
    """Phase 8f: (a) sparse-embedding training of the MF net at
    MovieLens-20M's widths (lazy SGD with momentum, lazy Adam, AdaGrad);
    (b) a lazy against a dense Adam step; (c) ``sparse.dot`` at the
    Criteo field count; (d) the optimizer tail on BERT-base's
    gradients; (e) the kvstore on the card. Returns the launch counts
    (phase 8f's flash and update-kernel launches)."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon, nd
    from mxnet_tpu_torch import optimizer as topt
    from mxnet_tpu_torch.ndarray import sparse
    dev = torch.device(DEVICE)
    timer = Timer(torch)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    batches = mf_batches(torch, rng, ML20M_USERS, ML20M_MOVIES, dev)
    for name, kw in MF_OPTS:
        run_mf_case(torch, nd, ag, gluon, topt, sparse, name, kw, batches,
                    dev)
        torch.cuda.empty_cache()
    log(f"time: 8f (a) {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    run_lazy_vs_dense(torch, nd, ag, gluon, rng, dev)
    run_sparse_dot(torch, nd, ag, sparse, timer, rng, dev)
    log(f"time: 8f (b), (c) {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    run_optimizer_tail_on_bert(torch, rng, kernels, nd, ag, gluon, timer)
    log(f"time: 8f (d) {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    run_kvstore_on_card(torch, nd, ag, gluon, sparse, dev)
    log(f"time: 8f (e) {time.monotonic() - t0:.1f}s")
    del timer
    torch.cuda.empty_cache()
    return kernels.launch_counts()


# ------------------------------------------------ 8g: the rest of gluon --
# SSD-300 as examples/ssd_detect.py builds it, trained at VOC's batch
G_SSD_BATCH, G_SSD_IMAGES, G_SSD_STEPS, G_SSD_SIZE = 32, 96, 10, 300
G_SSD_CLASSES = 20
G_SSD_ANCHORS = 8732
G_LOADER = dict(num_workers=2, pin_memory=True, device_prefetch=2)
G_SSD_SGD = {"learning_rate": 0.01, "momentum": 0.9}
# card against CPU at batch 2, TF32 off: the loss and every gradient's
# norm (f32 convolutions in cuDNN's order against oneDNN's, fifteen deep)
G_SSD_LOSS_REL_TOL = 1e-4
G_SSD_GRAD_REL_TOL = 1e-3
# MXNet's example/gluon/word_language_model (medium): the Penn Treebank
# vocabulary, 650 units, two layers, bptt 35
G_LM = dict(vocab=10000, units=650, layers=2, bptt=35, batch=32,
            dropout=0.5, lr=20.0, clip=0.2)
G_LM_STEPS = 6
G_LM_REL_TOL = 1e-4
# the losses and cells against their CPU path, TF32 off; CTC's
# forward-backward recursion in log space over 50 steps in the CUDA
# kernel's order against the CPU's
G_PART_REL_TOL = 1e-5
G_PART_TOL = {"CTCLoss": 1e-4}


def g_ssd_data(seed, n, size, classes):
    """``n`` synthetic SSD images (noise, one to three bright boxes an
    image, each box's brightness its class) and labels (N, 3, 6) padded
    with -1, as ``examples/ssd_detect.py`` makes them."""
    rs = np.random.RandomState(seed)
    imgs = (rs.randn(n, 3, size, size) * 0.05).astype(np.float32)
    labels = np.full((n, 3, 6), -1.0, np.float32)
    for i in range(n):
        nb = rs.randint(1, 4)
        boxes = _cboxes(nb, seed=seed * 1000 + i)
        cls = rs.randint(0, classes, nb)
        for b in range(nb):
            x1, y1, x2, y2 = (boxes[b] * size).astype(int)
            imgs[i, :, y1:y2, x1:x2] += 0.5 + cls[b] / classes
            labels[i, b] = [cls[b], *boxes[b], 0.0]
    return imgs, labels


def g_lm_net(torch, gluon, seed, dropout, dev):
    """The word language model: Embedding, a 2-layer TNC LSTM and a
    Dense decoder over the vocabulary, uniform(0.1) weights from
    ``seed``."""
    from mxnet_tpu_torch import initializer
    from mxnet_tpu_torch.gluon import nn, rnn

    class WordLM(gluon.HybridBlock):
        def __init__(self):
            super().__init__(prefix="wordlm_")
            with self.name_scope():
                self.encoder = nn.Embedding(G_LM["vocab"], G_LM["units"])
                self.rnn = rnn.LSTM(G_LM["units"], num_layers=G_LM["layers"],
                                    dropout=dropout, layout="TNC",
                                    input_size=G_LM["units"])
                self.decoder = nn.Dense(G_LM["vocab"], flatten=False,
                                        in_units=G_LM["units"])

        def hybrid_forward(self, F, x, h, c):
            out, (h, c) = self.rnn(self.encoder(x), [h, c])
            return self.decoder(out), h, c

    net = WordLM()
    net.initialize(initializer.Uniform(0.1), device=dev,
                   generator=torch.Generator().manual_seed(seed))
    return net


def g_lm_step(torch, ag, gluon, net, trainer, loss_fn, x, y, h, c):
    """One truncated-BPTT step: forward from the carried (detached)
    state, the mean cross-entropy over the tokens, backward, the global
    norm clipped to 0.2 (read on the host, as the example does), SGD.
    Returns (loss, h, c)."""
    h, c = h.detach(), c.detach()
    with ag.record():
        out, h, c = net(x, h, c)
        loss = loss_fn(out.reshape(-1, G_LM["vocab"]), y.reshape(-1)
                       ).mean()
    loss.backward()
    grads = [p.grad() for p in net.collect_params().values()]
    gluon.utils.clip_global_norm(grads, G_LM["clip"])
    trainer.step(1)
    return loss, h, c


def g_norms(net):
    return {k: float(p.grad().detach().double().norm())
            for k, p in net._collect_params_with_prefix().items()
            if p.grad_req != "null"}


def g_copy_to_cpu(torch, src, dst):
    """``src``'s parameters into ``dst`` (of the same structure, on the
    CPU) by structural path."""
    theirs = dst._collect_params_with_prefix()
    for k, p in src._collect_params_with_prefix().items():
        a = p.data().detach().cpu()
        q = theirs[k]
        q.shape = tuple(a.shape)
        q.set_data(a.clone())
        q._finish_deferred_init()


def g_rel(a, b):
    return abs(a - b) / max(abs(b), 1e-12)


def g_ssd_check(torch, ag, gluon, ssd, net, imgs, labels):
    """One SSD step on the card against the same step on the CPU from
    the same weights, at batch 2: the loss, every gradient's norm and
    MultiBoxTarget's class assignments."""
    from mxnet_tpu_torch.gluon.block import _F
    cpu = ssd.ssd_300_vgg16_reduced(classes=G_SSD_CLASSES, prefix="g8ssd_")
    cpu.initialize(device="cpu")
    g_copy_to_cpu(torch, net, cpu)
    loss_fn = ssd.MultiBoxLoss()
    res = {}
    for name, block, dev in (("card", net, DEVICE), ("cpu", cpu, "cpu")):
        block.zero_grad()
        x = torch.from_numpy(imgs[:2]).to(dev)
        y = torch.from_numpy(labels[:2]).to(dev)
        with ag.record():
            c, lo, a = block(x)
            loss = loss_fn(c, lo, y, a).mean()
        loss.backward()
        _, _, cls_t = _F._contrib_MultiBoxTarget(
            a, y, c.detach(), overlap_threshold=0.5,
            negative_mining_ratio=3.0, negative_mining_thresh=0.5)
        res[name] = (loss.item(), g_norms(block), cls_t.cpu().numpy())
    (l_card, n_card, t_card), (l_cpu, n_cpu, t_cpu) = res["card"], \
        res["cpu"]
    flips = int((t_card != t_cpu).sum())
    positives_same = np.array_equal(t_card > 0, t_cpu > 0) and \
        np.array_equal(t_card[t_card > 0], t_cpu[t_cpu > 0])
    loss_tol, grad_tol = G_SSD_LOSS_REL_TOL, G_SSD_GRAD_REL_TOL
    grad_err = max(g_rel(n_card[k], n_cpu[k]) for k in n_cpu)
    log(f"8g (a): SSD-300 step on the card against the CPU at batch 2 "
        f"(TF32 off): loss {l_card:.6f} vs {l_cpu:.6f} (rel "
        f"{g_rel(l_card, l_cpu):.2e}, tol {loss_tol}), {len(n_cpu)} "
        f"gradient norms max rel err {grad_err:.2e} (tol {grad_tol}), "
        f"MultiBoxTarget assignments {int((t_cpu > 0).sum())} positives "
        f"{int((t_cpu == 0).sum())} mined negatives, {flips} differ "
        f"(positives the same: {positives_same})")
    check(positives_same, "SSD-300: MultiBoxTarget assigns other "
          "positives on the card than on the CPU")
    check(flips <= t_cpu.size // 1000, f"SSD-300: {flips} mined "
          "negatives differ from the CPU's")
    check(g_rel(l_card, l_cpu) <= loss_tol, "SSD-300 loss differs from "
          f"the CPU's: {l_card} vs {l_cpu}")
    check(grad_err <= grad_tol, f"SSD-300 gradient norms differ from the "
          f"CPU's by {grad_err:.2e}")
    del cpu


def run_g_ssd(torch, kernels, rng):
    """8g (a): SSD-300 at full width, batch 32, f32, SGD with momentum
    through ``Trainer.step``, fed by ``DataLoader(ArrayDataset(...),
    num_workers=2, pin_memory=True, device_prefetch=2)``."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.block import _F
    from mxnet_tpu_torch.gluon.model_zoo import ssd
    imgs, labels = g_ssd_data(31, G_SSD_IMAGES, G_SSD_SIZE, G_SSD_CLASSES)
    from mxnet_tpu_torch import initializer
    net = ssd.ssd_300_vgg16_reduced(classes=G_SSD_CLASSES, prefix="g8ssd_")
    net.initialize(initializer.Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(31))
    with ag.pause():
        net(torch.from_numpy(imgs[:1]).to(DEVICE))
    g_ssd_check(torch, ag, gluon, ssd, net, imgs, labels)
    loss_fn = ssd.MultiBoxLoss()
    trainer = gluon.Trainer(net.collect_params(), "sgd", dict(G_SSD_SGD))
    loader = gluon.data.DataLoader(
        gluon.data.ArrayDataset(imgs, labels), batch_size=G_SSD_BATCH,
        shuffle=True, last_batch="discard", **G_LOADER)

    def step(x, y):
        with ag.record():
            c, lo, a = net(x)
            loss = loss_fn(c, lo, y, a).mean()
        loss.backward()
        trainer.step(G_SSD_BATCH)
        return loss

    def batches(n):
        out = []
        while len(out) < n:
            for x, y in loader:
                out.append((x._data, y._data))
                if len(out) == n:
                    break
        return out
    from mxnet_tpu_torch.gluon.data.prefetch import _metrics
    wait = _metrics()["wait"]
    kernels.reset_launch_counts()
    losses, times = [], []
    t_all = time.monotonic()
    fed = 0
    # the loader-fed window: steps 2..10, from the end of the first
    # (its warm-up) to the end of the last, the loader's waits included
    t_fed = n_wait = s_wait = None
    while fed < G_SSD_STEPS:
        for x, y in loader:
            if fed == G_SSD_STEPS:
                break
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(step(x._data, y._data).item())
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            fed += 1
            if fed == 1:
                t_fed, n_wait, s_wait = time.perf_counter(), wait.count, \
                    wait.sum
    fed_s = time.perf_counter() - t_fed
    fed_wait_ms = (wait.sum - s_wait) / max(wait.count - n_wait, 1) * 1e3
    counts = kernels.launch_counts()
    wall = time.monotonic() - t_all
    log(f"8g (a): SSD-300 losses {[round(v, 4) for v in losses]}")
    check(all(np.isfinite(losses)), "SSD-300 loss is not finite")
    check(np.mean(losses[-2:]) < np.mean(losses[:2]),
          f"SSD-300 loss did not fall over {G_SSD_STEPS} steps: {losses}")
    torch.cuda.reset_peak_memory_stats()
    prof_batches = batches(2)
    prof, pwall = profiled(torch, step, prof_batches)
    share = report_profile(prof, pwall, 2)
    rows, busy = device_rows(prof)
    launches_a_step = sum(e.count for e in rows) / 2
    x, y = prof_batches[0]
    with ag.pause():
        c, lo, a = net(x)
    (_, _, cls_t), t_ms = timed_ms(torch, lambda: _F._contrib_MultiBoxTarget(
        a, y, c, overlap_threshold=0.5, negative_mining_ratio=3.0,
        negative_mining_thresh=0.5))
    with ag.pause():
        det, d_ms = timed_ms(torch, lambda: net.detect(x))
    d = det.cpu().numpy()
    check(a.shape[1] == G_SSD_ANCHORS and d.shape == (
        G_SSD_BATCH, G_SSD_ANCHORS, 6), f"anchors {tuple(a.shape)}, "
          f"detect() {d.shape}")
    live = d[d[..., 0] >= 0]
    check(((live[:, 0] < G_SSD_CLASSES) & (live[:, 1] >= 0) &
           (live[:, 1] <= 1)).all() and np.isfinite(d).all(),
          "detect(): rows not of the reference's form [class, score, x1, "
          "y1, x2, y2]")
    step_ms = float(np.median(times[1:])) * 1e3
    summary = dict(step_ms=step_ms,
                   images_s=G_SSD_BATCH / step_ms * 1e3,
                   fed_images_s=(G_SSD_STEPS - 1) * G_SSD_BATCH / fed_s,
                   fed_step_ms=fed_s / (G_SSD_STEPS - 1) * 1e3,
                   fed_wait_ms=fed_wait_ms,
                   device_ms=busy / 1e3 / 2,
                   idle=None if share is None else 1 - share,
                   peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                   kernels_a_step=launches_a_step,
                   multibox_target_ms=t_ms, multibox_detection_ms=d_ms,
                   rows_kept=int(len(live)))
    log(f"8g (a): SSD-300 batch {G_SSD_BATCH} f32: step "
        f"{step_ms:.2f} ms, {summary['images_s']:.1f} images/s in the "
        f"step; fed by the loader (steps 2-{G_SSD_STEPS}) "
        f"{summary['fed_step_ms']:.2f} ms a step, "
        f"{summary['fed_images_s']:.1f} images/s, the consumer waiting "
        f"{fed_wait_ms:.2f} ms a batch for the loader; profiled "
        f"device {summary['device_ms']:.2f} ms a step, idle "
        f"{'not measured' if share is None else format(1 - share, '.3f')}"
        f", peak {summary['peak_gb']:.2f} GB, {launches_a_step:.0f} "
        f"kernels a step; MultiBoxTarget {t_ms:.2f} ms, MultiBoxDetection "
        f"(detect) {d_ms:.2f} ms, {len(live)} rows kept; {G_SSD_STEPS} "
        f"steps in {wall:.1f}s with the loader")
    log("8g row ssd: " + json.dumps({k: (round(v, 4) if isinstance(
        v, float) else v) for k, v in summary.items()}))
    loader.close()
    del net, trainer
    return counts, (imgs, labels)


def g_lm_time(torch, ag, gluon, net, trainer, loss_fn, data, steps, label):
    """``steps`` timed steps and two profiled ones; returns the summary."""
    tokens = G_LM["batch"] * G_LM["bptt"]
    h = torch.zeros(G_LM["layers"], G_LM["batch"], G_LM["units"],
                    device=DEVICE)
    c = torch.zeros_like(h)
    losses, times = [], []
    for i in range(steps):
        x, y = data[i % len(data)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, h, c = g_lm_step(torch, ag, gluon, net, trainer, loss_fn, x,
                               y, h, c)
        losses.append(loss.item())
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    state = [h, c]

    def one(x, y):
        _, state[0], state[1] = g_lm_step(torch, ag, gluon, net, trainer,
                                          loss_fn, x, y, *state)
    prof, wall = profiled(torch, one, data[:2])
    share = report_profile(prof, wall, 2)
    rows, busy = device_rows(prof)
    step_ms = float(np.median(times[1:])) * 1e3
    out = dict(step_ms=step_ms, tokens_s=tokens / step_ms * 1e3,
               device_ms=busy / 1e3 / 2,
               idle=None if share is None else 1 - share,
               kernels_a_step=sum(e.count for e in rows) / 2,
               first_ms=times[0] * 1e3)
    log(f"8g (b): word LM {label}: step {step_ms:.2f} ms, "
        f"{out['tokens_s']:.0f} tokens/s, profiled device "
        f"{out['device_ms']:.2f} ms a step, idle "
        f"{'not measured' if share is None else format(1 - share, '.3f')}"
        f", {out['kernels_a_step']:.0f} kernels a step, first step "
        f"{out['first_ms']:.0f} ms; losses {[round(v, 3) for v in losses]}")
    check(all(np.isfinite(losses)), f"word LM {label}: loss not finite")
    return out


def g_lm_hybrid_check(torch, ag, gluon, loss_fn, data):
    """Three steps of the hybridized model (replays of its CUDA graphs,
    the state carried between them) against three eager steps from the
    same weights on the same batches, dropout off: each step's loss,
    every gradient norm and the carried state."""
    res = {}
    for label, hybrid in (("eager", False), ("hybridized", True)):
        net = g_lm_net(torch, gluon, 7, 0.0, DEVICE)
        if hybrid:
            net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": G_LM["lr"]})
        h = torch.zeros(G_LM["layers"], G_LM["batch"], G_LM["units"],
                        device=DEVICE)
        c = torch.zeros_like(h)
        steps = []
        for i in range(3):
            loss, h, c = g_lm_step(torch, ag, gluon, net, tr, loss_fn,
                                   *data[i], h, c)
            steps.append((loss.item(), g_norms(net), h.detach().clone(),
                          c.detach().clone()))
        graphs = net._cached_op.graphs if hybrid and net._cached_op else 0
        res[label] = steps
        del net, tr
    lerr = gerr = serr = 0.0
    for (l1, n1, h1, c1), (l2, n2, h2, c2) in zip(res["hybridized"],
                                                  res["eager"]):
        lerr = max(lerr, g_rel(l1, l2))
        gerr = max(gerr, max(g_rel(n1[k], n2[k]) for k in n2))
        serr = max(serr, float((h1 - h2).abs().max()),
                   float((c1 - c2).abs().max()))
    log(f"8g (b): hybridized word LM ({graphs} CUDA graphs) against eager "
        f"over 3 steps from the same weights (dropout off): loss max rel "
        f"err {lerr:.2e}, gradient norms {gerr:.2e}, carried state max err "
        f"{serr:.2e} (tol {G_LM_REL_TOL})")
    check(graphs >= 2, "hybridized word LM captured no forward and "
          "backward graphs")
    check(lerr <= G_LM_REL_TOL and gerr <= G_LM_REL_TOL and
          serr <= G_LM_REL_TOL, "hybridized word LM steps differ from the "
          "eager ones")


def run_g_lm(torch, kernels, rng):
    """8g (b): the word-level LSTM language model at its published width:
    one step with dropout off against the CPU path, then the eager step
    against the hybridized one (a CachedOp of CUDA graphs)."""
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    V, T, B = G_LM["vocab"], G_LM["bptt"], G_LM["batch"]
    stream = rng.randint(0, V, size=(T * 4 + 1) * B)
    data = []
    for i in range(4):
        seg = stream[i * T * B:(i * T + T + 1) * B].reshape(T + 1, B)
        data.append((torch.from_numpy(seg[:-1].copy()).to(DEVICE),
                     torch.from_numpy(seg[1:].astype(np.float32)).to(
                         DEVICE)))
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    # one step, dropout off, against the CPU path from the same weights
    res = {}
    for dev in (DEVICE, "cpu"):
        net = g_lm_net(torch, gluon, 7, 0.0, dev)
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": G_LM["lr"]})
        h = torch.zeros(G_LM["layers"], B, G_LM["units"], device=dev)
        x, y = (t.to(dev) for t in data[0])
        loss, h, _ = g_lm_step(torch, ag, gluon, net, tr, loss_fn, x, y, h,
                               torch.zeros_like(h))
        res[dev] = (loss.item(), g_norms(net),
                    {k: p.data().detach().cpu() for k, p in
                     net._collect_params_with_prefix().items()},
                    h.detach().cpu())
    (l1, n1, p1, h1), (l2, n2, p2, h2) = res[DEVICE], res["cpu"]
    gerr = max(g_rel(n1[k], n2[k]) for k in n2)
    perr = max(float((p1[k] - p2[k]).abs().max()) /
               max(float(p2[k].abs().max()), 1e-12) for k in p2)
    herr = float((h1 - h2).abs().max())
    log(f"8g (b): word LM step on the card against the CPU (dropout off, "
        f"TF32 off): loss {l1:.6f} vs {l2:.6f}, gradient norms max rel err "
        f"{gerr:.2e}, clipped SGD update max rel err {perr:.2e}, carried "
        f"state max err {herr:.2e} (tol {G_LM_REL_TOL})")
    check(g_rel(l1, l2) <= G_LM_REL_TOL and gerr <= G_LM_REL_TOL and
          perr <= G_LM_REL_TOL and herr <= G_LM_REL_TOL,
          "word LM step differs from the CPU's")
    del res
    g_lm_hybrid_check(torch, ag, gluon, loss_fn, data)
    kernels.reset_launch_counts()
    rows = {}
    for label, hybrid in (("eager", False), ("hybridized", True)):
        net = g_lm_net(torch, gluon, 7, G_LM["dropout"], DEVICE)
        if hybrid:
            net.hybridize()
        tr = gluon.Trainer(net.collect_params(), "sgd",
                           {"learning_rate": G_LM["lr"]})
        rows[label] = g_lm_time(torch, ag, gluon, net, tr, loss_fn, data,
                                G_LM_STEPS, label)
        if hybrid:
            graphs = net._cached_op.graphs if net._cached_op else 0
            log(f"8g (b): hybridized word LM: {graphs} CUDA graph(s)")
            check(graphs >= 2, "hybridized word LM captured no forward "
                  "and backward graphs")
        del net, tr
    counts = kernels.launch_counts()
    log(f"8g (b): hybridized/eager step time "
        f"{rows['hybridized']['step_ms'] / rows['eager']['step_ms']:.3f}, "
        f"device ms {rows['hybridized']['device_ms']:.2f} vs "
        f"{rows['eager']['device_ms']:.2f}")
    for label, row in rows.items():
        log(f"8g row word_lm_{label}: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in row.items()}))
    return counts


def g_epoch(torch, loader, consume_ms=0.0):
    """One pass over ``loader``: the batches (host copies) and seconds;
    each batch is moved to the card when it is not there, and the
    consumer then takes ``consume_ms`` (a host sleep standing in for a
    step) before the next."""
    got = []
    t0 = time.monotonic()
    for x, y in loader:
        x, y = x._data.to(DEVICE), y._data.to(DEVICE)
        got.append((x.cpu().numpy(), y.cpu().numpy()))
        if consume_ms:
            time.sleep(consume_ms / 1e3)
    torch.cuda.synchronize()
    return got, time.monotonic() - t0


def run_g_data(torch, data):
    """8g (c): the data tier: the same loader with and without
    ``device_prefetch`` and ``pin_memory``; the batches in order and bit
    for bit the host's; the consumer's wait and the queue's fill; a
    worker's exception in the consumer."""
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.gluon.data.prefetch import _metrics
    imgs, labels = data
    ds = gluon.data.ArrayDataset(imgs, labels)
    want = [(imgs[i:i + G_SSD_BATCH], labels[i:i + G_SSD_BATCH])
            for i in range(0, len(imgs), G_SSD_BATCH)]
    series = _metrics()
    wait, fill = series["wait"], series["fill"]
    rows = {}
    for label, kw in (("serial", dict(num_workers=0)),
                      ("plain", dict(num_workers=2)),
                      ("pinned+prefetch", dict(
                          num_workers=2, pin_memory=G_LOADER["pin_memory"],
                          device_prefetch=2))):
        t0 = time.monotonic()
        loader = gluon.data.DataLoader(ds, batch_size=G_SSD_BATCH, **kw)
        start_s = time.monotonic() - t0
        g_epoch(torch, loader)                           # warm the pool
        n0, s0 = wait.count, wait.sum
        got, secs = g_epoch(torch, loader, consume_ms=20.0)
        loader.close()
        n, s = wait.count - n0, wait.sum - s0
        check(len(got) == len(want) and all(
            np.array_equal(a, c) and np.array_equal(b, d)
            for (a, b), (c, d) in zip(got, want)),
            f"8g (c) {label}: batches differ from the host's or arrive out "
            "of order")
        rows[label] = dict(epoch_s=secs, start_s=start_s,
                           wait_ms=(s / n * 1e3) if n else None,
                           fill=fill.value if n else None)
        log(f"8g (c): loader {label} ({kw}), batch {G_SSD_BATCH}, a 20 ms "
            f"consumer: pool start {start_s * 1e3:.0f} ms, epoch "
            f"{secs * 1e3:.1f} ms for {len(got)} "
            f"batches, bit for bit the host's, in order; consumer wait "
            f"{'not measured (no prefetch)' if not n else format(s / n * 1e3, '.3f') + ' ms a batch'}"
            f", queue fill at the last read "
            f"{'not measured' if not n else fill.value}")
    bad = gluon.data.DataLoader(
        gluon.data.ArrayDataset(labels[:8]).transform(int), batch_size=4,
        num_workers=2, device_prefetch=2)
    raised = None
    try:
        list(bad)
    except TypeError as e:
        raised = e
    bad.close()
    check(raised is not None, "8g (c): a worker's exception did not reach "
          "the consumer")
    log(f"8g (c): a worker's TypeError surfaced in the consumer: "
        f"{str(raised)[:60]}")
    return rows


def g_pair(torch, make, inputs, grad_idx):
    """``make(dev)``'s block on the card and on the CPU from the same
    parameters (the card's copied), on the same inputs: the largest
    relative error of the outputs and of the input gradients."""
    from mxnet_tpu_torch import autograd as ag
    out = {}
    card = make(DEVICE)
    cpu = make("cpu")
    for side, dev, blk in (("card", DEVICE, card), ("cpu", "cpu", cpu)):
        if side == "cpu" and len(card.collect_params()):
            # the card's parameters, shapes resolved by its forward
            g_copy_to_cpu(torch, card, cpu)
        args = [[torch.from_numpy(v).to(dev) for v in a]
                if isinstance(a, list) else
                torch.from_numpy(a).to(dev) for a in inputs]
        for i in grad_idx:
            args[i].requires_grad_()
        with ag.record():
            y = blk(*args)
        flat = []

        def walk(v):
            if isinstance(v, (list, tuple)):
                for w in v:
                    walk(w)
            else:
                flat.append(v)
        walk(y)
        sum(f.float().sum() * (k + 1) for k, f in enumerate(flat)).backward()
        out[side] = ([f.detach().cpu().double() for f in flat],
                     [args[i].grad.cpu().double() for i in grad_idx])
    err = 0.0
    for a, b in zip(out["card"][0] + out["card"][1],
                    out["cpu"][0] + out["cpu"][1]):
        err = max(err, float((a - b).abs().max()) /
                  max(float(b.abs().max()), 1.0))
    return err


def run_g_parts(torch, rng):
    """8g (d): each of the twelve new losses and each cell family,
    forward and gradient, on the card against the CPU."""
    from mxnet_tpu_torch.gluon import loss as L
    from mxnet_tpu_torch.gluon import rnn
    from mxnet_tpu_torch.gluon.contrib import rnn as crnn
    f = np.float32
    pred = rng.randn(64, 16).astype(f)
    dense = np.abs(rng.randn(64, 16)).astype(f)
    sign = np.sign(rng.randn(64, 16)).astype(f)
    sm = np.exp(dense) / np.exp(dense).sum(-1, keepdims=True)
    logits = rng.randn(32, 50, 20).astype(f)
    lab = rng.randint(0, 19, (32, 10)).astype(f)
    lab[:, 7:] = -1
    x1, x2 = rng.randn(32, 24).astype(f), rng.randn(32, 24).astype(f)
    cos_l = np.sign(rng.randn(32)).astype(f)
    losses = [
        ("L1Loss", {}, [pred, dense]),
        ("SigmoidBinaryCrossEntropyLoss", {}, [pred, (sign + 1) / 2]),
        ("KLDivLoss", {}, [np.log(sm).astype(f), sm]),
        ("CTCLoss", {}, [logits, lab]),
        ("HuberLoss", {}, [pred, dense]),
        ("HingeLoss", {}, [pred, sign]),
        ("SquaredHingeLoss", {}, [pred, sign]),
        ("LogisticLoss", {}, [pred, sign]),
        ("TripletLoss", {}, [pred, dense, dense + 1]),
        ("PoissonNLLLoss", {}, [pred, dense]),
        ("CosineEmbeddingLoss", {}, [x1, x2, cos_l]),
        ("SDMLLoss", {}, [x1, x2]),
    ]
    worst = {}
    for name, kw, arrays in losses:
        err = g_pair(torch, lambda dev, n=name, k=kw: getattr(L, n)(**k),
                     arrays, [0])
        worst[name] = err
    seq = rng.randn(8, 12, 32).astype(f)

    def cell(cls, **kw):
        def make(dev):
            c = cls(prefix="g8c_", **kw)
            c.initialize(device=dev,
                         generator=torch.Generator().manual_seed(3))
            return _Unroll(c)
        return make

    class _Unroll:
        def __init__(self, c):
            self.c = c

        def collect_params(self):
            return self.c.collect_params()

        def _collect_params_with_prefix(self):
            return self.c._collect_params_with_prefix()

        def __call__(self, x):
            out, states = self.c.unroll(x.shape[1], x, layout="NTC")
            return [out] + list(states)

    def layer(cls, **kw):
        def make(dev):
            net = cls(64, prefix="g8l_", **kw)
            net.initialize(device=dev,
                           generator=torch.Generator().manual_seed(4))
            return net
        return make
    cells = [
        ("RNNCell", cell(rnn.RNNCell, hidden_size=48), [seq]),
        ("LSTMCell", cell(rnn.LSTMCell, hidden_size=48), [seq]),
        ("GRUCell", cell(rnn.GRUCell, hidden_size=48), [seq]),
        ("LSTMPCell", cell(crnn.LSTMPCell, hidden_size=48,
                           projection_size=16), [seq]),
        ("RNN", layer(rnn.RNN, num_layers=2, layout="NTC"), [seq]),
        ("LSTM", layer(rnn.LSTM, num_layers=2, bidirectional=True,
                       layout="NTC"), [seq]),
        ("GRU", layer(rnn.GRU, layout="NTC"), [seq]),
    ]
    img = rng.randn(4, 3, 16, 16).astype(f)
    for name in ("Conv2DRNNCell", "Conv2DLSTMCell", "Conv2DGRUCell"):
        def make(dev, n=name):
            cc = getattr(crnn, n)((3, 16, 16), 8, prefix="g8cv_")
            cc.initialize(device=dev,
                          generator=torch.Generator().manual_seed(5))
            return cc
        states = [np.zeros((4, 8, 16, 16), f)] * (
            2 if "LSTM" in name else 1)
        cells.append((name, make, [img, states]))
    for name, make, arrays in cells:
        worst[name] = g_pair(torch, make, arrays, [0])
    log("8g (d): card against CPU, max rel err of outputs and input "
        "gradients: " + ", ".join(f"{k} {v:.1e}" for k, v in worst.items()))
    bad = {k: v for k, v in worst.items()
           if not v <= G_PART_TOL.get(k, G_PART_REL_TOL)}
    check(not bad, f"8g (d): beyond tolerance on the card: {bad}")
    return worst


def run_gluon_rest_phase(torch, rng, kernels):
    """Phase 8g, the rest of gluon: (a) SSD-300 training and detection at
    full width through the DataLoader with workers, pinned memory and
    device prefetch; (b) the word-level LSTM language model, eager and
    hybridized; (c) the data tier; (d) the losses and cells on the card.
    Returns the launch counts of (a) and (b) (the update kernel)."""
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    t0 = time.monotonic()
    counts, data = run_g_ssd(torch, kernels, rng)
    add(counts)
    torch.cuda.empty_cache()
    log(f"time: 8g (a) {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    add(run_g_lm(torch, kernels, rng))
    torch.cuda.empty_cache()
    log(f"time: 8g (b) {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    run_g_data(torch, data)
    log(f"time: 8g (c) {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    run_g_parts(torch, rng)
    torch.cuda.empty_cache()
    log(f"time: 8g (d) {time.monotonic() - t0:.1f}s")
    return launches


# --------------------------------- 8h: the estimator and its telemetry --
# (a) ResNet-50 bf16 NHWC s2d at batch 128 (8e (d)'s configuration) fed by
# a DataLoader over H_RESNET_BATCHES seeded batches with device prefetch;
# (b) BERT-base at phase 8's batch, length and steps, then
# (c) two profiled ones; (d) a serving burst of H_BURST_S seconds sampled
# every H_SAMPLE_S
H_RESNET_BATCH, H_RESNET_BATCHES, H_PROFILED = 128, 6, 3
# (a)'s timed loops: H_TURNS rounds of the three loops in alternating
# order, each turn H_TURN_EPOCHS passes over the loader
H_TURNS, H_TURN_EPOCHS = 5, 2
H_BERT_STEPS, H_BURST_S, H_SAMPLE_S = BERT_STEPS, 10.0, 0.5
H_SERVE_UNITS, H_SERVE_BUCKETS = 1024, (1, 2, 4, 8)
H_METRIC_READ_SHARE = 0.05      # ROADMAP item 22 when the reads cost more
H_LOSS_REL_TOL = 1e-5


def h_series(names):
    """Sums and counts of registry series now: a counter's value, a
    histogram's ``(count, sum)``."""
    from mxnet_tpu_torch.observability import get_registry
    reg = get_registry()
    out = {}
    for name in names:
        m = reg.get(name)
        if m is None:
            out[name] = 0
            continue
        c = m.children()[0] if m.children() else None
        out[name] = (0 if c is None else
                     (c.count, c.sum) if hasattr(c, "count") else c.value)
    return out


H_SERIES = ("mxtpu_training_optimizer_steps_total",
            "mxtpu_training_examples_total", "mxtpu_training_steps_total",
            "mxtpu_training_step_seconds", "mxtpu_training_compute_seconds",
            "mxtpu_training_data_wait_seconds")


def h_delta(before, after):
    out = {}
    for k, v in after.items():
        b = before[k]
        if isinstance(v, tuple):
            b = b or (0, 0.0)            # the series did not exist yet
            out[k] = tuple(x - y for x, y in zip(v, b))
        else:
            out[k] = v - b
    return out


def h_weights(net):
    return {k: p.data().detach().clone()
            for k, p in sorted(net.collect_params().items())}


def h_same_bits(torch, a, b):
    """Names of parameters (matched by position: the two nets' prefixes
    differ) whose bits differ."""
    return [ka for (ka, va), (_, vb) in zip(a.items(), b.items())
            if not torch.equal(va, vb)]


def h_resnet_loader(torch, gluon, seed):
    """A DataLoader over ``H_RESNET_BATCHES`` batches of seeded float32
    images (host numpy, one sample an item) and int labels; the batchify
    stacks them into bf16 NHWC images and int32 labels, pinned, and the
    loader stages them on the card two batches ahead."""
    rs = np.random.default_rng(seed)
    n = H_RESNET_BATCH * H_RESNET_BATCHES
    images = rs.standard_normal((n, 224, 224, 3), dtype=np.float32)
    labels = rs.integers(0, 1000, n).astype(np.int32)

    class Images(gluon.data.Dataset):
        def __len__(self):
            return n

        def __getitem__(self, i):
            return images[i], labels[i]

    def batchify(samples):
        x = torch.from_numpy(np.stack([s[0] for s in samples]))
        y = torch.from_numpy(np.array([s[1] for s in samples]))
        return [x.to(torch.bfloat16), y]
    return gluon.data.DataLoader(
        Images(), batch_size=H_RESNET_BATCH, batchify_fn=batchify,
        pin_memory=DEVICE == "cuda", device_prefetch=2)


def h_bench_loss(gluon, nd):
    """``bench.py``'s loss (per-sample NLL of the f32 log-softmax) as a
    gluon Loss, the Estimator's loss."""
    class BenchNLL(gluon.loss.Loss):
        def __init__(self):
            super().__init__(None, 0)

        def forward(self, pred, label):
            logp = nd.log_softmax(pred.float(), axis=-1)
            return -nd.pick(logp, label, axis=1)
    return BenchNLL()


def h_resnet(torch, ag, vision, prefix):
    from mxnet_tpu_torch.initializer import Xavier
    net = vision.resnet50_v1(layout="NHWC", stem_s2d=True, prefix=prefix)
    net.initialize(Xavier(), device=DEVICE,
                   generator=torch.Generator().manual_seed(0))
    with ag.pause():
        net(torch.ones((1, 224, 224, 3), device=DEVICE))
    net.cast("bfloat16")
    return net


def h_profile(torch, fn, steps):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if DEVICE == "cuda" else [])
    with profile(activities=acts) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    share = report_profile(prof, wall, steps)
    return None if share is None else 1 - share


def h_metric_read_ms(torch, est, pred, label, loss, n=20):
    """The metrics' per-batch cost on their own: the estimator's train
    metrics and loss metric updated from one step's outputs already on
    the card (the device idle), ``n`` times; ms a batch."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    for _ in range(n):
        for m in est.train_metrics:
            m.update(label, pred)
        est.train_loss_metric.update(0, loss)
    return (time.monotonic() - t0) / n * 1e3


def run_h_resnet(torch, kernels, card):
    """8h (a): ResNet-50 v1 as bench.py builds it (bf16 NHWC s2d, batch
    128), trained through ``Estimator.fit(compiled_step=True)`` from a
    DataLoader with device prefetch; Accuracy, TopKAccuracy(5) and the
    loss metric; ValidationHandler, CheckpointHandler (rotation 2),
    LoggingHandler and the default StepTimerHandler. Checks: the weights
    after the epoch bit for bit those of a bare ``compile_step`` loop
    over the same batches from the same weights (cuDNN deterministic in
    both), the metrics equal numpy's on the same host copies of the
    predictions, the optimizer-step and example counters moved by N and
    128 N, one capture (the first call) and none after. Then
    ``H_TURNS`` rounds of three loops, each turn ``H_TURN_EPOCHS`` passes
    over the loader, in the order bare, estimator, estimator without
    metrics (nothing read back) and the reverse in the next round: each
    loop's median step ms with its spread and images/s, StepTimer's
    compute/data-wait split, the metrics' own per-batch cost and both
    loops' device idle share. The loop without metrics splits the
    estimator's gap into the reads' share and the handlers'. Returns the
    launch counts of the estimator's epoch."""
    import shutil
    import tempfile
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon, metric, nd
    from mxnet_tpu_torch.gluon.contrib import estimator as E
    from mxnet_tpu_torch.gluon.model_zoo import vision
    label = "8h (a) resnet-50 bf16 NHWC s2d"
    n, b = H_RESNET_BATCHES, H_RESNET_BATCH
    loader = h_resnet_loader(torch, gluon, 31)
    loss_fn = h_bench_loss(gluon, nd)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    tmp = tempfile.mkdtemp(prefix="chip_smoke_8h_")
    try:
        # the bare loop: same function shape as the estimator's step
        net_b = h_resnet(torch, ag, vision, "r50hb_")
        tr_b = gluon.Trainer(net_b.collect_params(), "sgd",
                             dict(RESNET_SGD))
        def loss_and_pred(x, y):
            pred = net_b(x)
            return loss_fn(pred, y), pred
        step_b = tr_b.compile_step(loss_and_pred)
        t0 = time.monotonic()
        for x, y in loader:
            step_b(x, y)
        torch.cuda.synchronize()
        bare_first = time.monotonic() - t0
        want = h_weights(net_b)
        step_b.release()
        del net_b, tr_b, step_b
        torch.cuda.empty_cache()
        # the estimator, from the same weights
        net = h_resnet(torch, ag, vision, "r50ha_")
        est = E.Estimator(
            net, loss_fn,
            train_metrics=[metric.Accuracy(), metric.TopKAccuracy(5)],
            # the default copies type(m)() of each, and TopKAccuracy()
            # refuses top_k=1 (the reference's Estimator does the same)
            val_metrics=[metric.Accuracy(), metric.TopKAccuracy(5)],
            trainer=gluon.Trainer(net.collect_params(), "sgd",
                                  dict(RESNET_SGD)))
        seen = []

        class Recorder(E.BatchEnd):
            priority = 0

            def batch_end(self, est, *a, **kw):
                loss = getattr(kw["loss"], "_data", kw["loss"])
                seen.append((kw["pred"].float().cpu().numpy(),
                             kw["label"].cpu().numpy(),
                             loss.float().cpu().numpy()))
        val = [next(iter(loader))]
        handlers = [E.ValidationHandler(val, est.evaluate),
                    E.CheckpointHandler(tmp, model_prefix="r50",
                                        epoch_period=None, batch_period=2,
                                        max_checkpoints=2),
                    E.LoggingHandler(), Recorder()]
        before, c0 = h_series(H_SERIES), kernels.capture_count()
        kernels.reset_launch_counts()
        t0 = time.monotonic()
        est.fit(loader, epochs=1, event_handlers=handlers,
                compiled_step=True)
        torch.cuda.synchronize()
        fit_s = time.monotonic() - t0
        launches = kernels.launch_counts()
        moved = h_delta(before, h_series(H_SERIES))
        captures = kernels.capture_count() - c0
        step = est._compiled_step_auto
        differ = h_same_bits(torch, h_weights(net), want)
        preds = np.concatenate([s[0] for s in seen])
        labels = np.concatenate([s[1] for s in seen]).astype(np.int64)
        acc = float((preds.argmax(1) == labels).mean())
        top5 = float((np.argsort(preds, 1)[:, -5:] ==
                      labels[:, None]).any(1).mean())
        loss_mean = float(np.concatenate([s[2] for s in seen]).mean())
        got = dict(est.train_metrics[0].get_name_value() +
                   est.train_metrics[1].get_name_value() +
                   est.train_loss_metric.get_name_value())
        files = sorted(f for f in os.listdir(tmp) if f.endswith(".params"))
        log(f"{label}: Estimator.fit over {n} batches of {b} from the "
            f"loader ({fit_s:.2f}s with the validation pass, "
            f"{len(files)} checkpoints kept: {files}); weights against the "
            f"bare compile_step loop ({bare_first:.2f}s, cuDNN "
            f"deterministic): {len(differ)} of {len(want)} differ; "
            f"metrics {got} against numpy on the host copies: accuracy "
            f"{acc}, top-5 {top5}, loss {loss_mean:.6f}; counters moved "
            f"{moved['mxtpu_training_optimizer_steps_total']} steps, "
            f"{moved['mxtpu_training_examples_total']} examples; captures "
            f"{captures}; update launches {launches}")
        check(step is not None and step.last_reason is None,
              f"{label}: the compiled step fell back "
              f"({None if step is None else step.last_reason})")
        check(not differ, f"{label}: weights differ from the bare loop's: "
              f"{differ[:5]}")
        check(got["accuracy"] == acc and got["top_k_accuracy_5"] == top5,
              f"{label}: metrics {got} against numpy {acc}, {top5}")
        check(abs(got["train_loss"] - loss_mean) <= H_LOSS_REL_TOL *
              abs(loss_mean), f"{label}: loss metric {got['train_loss']} "
              f"against numpy {loss_mean}")
        check(moved["mxtpu_training_optimizer_steps_total"] == n and
              moved["mxtpu_training_examples_total"] == b * n,
              f"{label}: counters moved {moved}")
        check(captures == 1 and step.replays == n - 1,
              f"{label}: {captures} captures, {step.replays} replays in "
              f"{n} steps")
        check(files == ["r50-batch4.params", "r50-batch6.params"],
              f"{label}: checkpoint rotation kept {files}")
        # in turns: the bare loop on the estimator's own step (its graph;
        # no handlers, no metrics) against the estimator's epoch
        c1 = kernels.capture_count()

        def bare():
            for _ in range(H_TURN_EPOCHS):
                for x, y in loader:
                    step(x, y)

        def fitted():
            est.fit(loader, epochs=H_TURN_EPOCHS, compiled_step=True,
                    event_handlers=[E.LoggingHandler()])

        def unread():
            # the same loop with no metric: nothing reads the step's
            # outputs back, so the host runs ahead of the card
            est.fit(loader, epochs=H_TURN_EPOCHS, compiled_step=True,
                    event_handlers=[E.LoggingHandler(), E.MetricHandler([])])
        loops = {"bare": bare, "estimator": fitted, "no_metrics": unread}
        walls = {k: [] for k in loops}
        split = None
        for r in range(H_TURNS):
            for which in list(loops)[::1 if r % 2 == 0 else -1]:
                before = h_series(H_SERIES)
                torch.cuda.synchronize()
                t0 = time.monotonic()
                loops[which]()
                torch.cuda.synchronize()
                walls[which].append(time.monotonic() - t0)
                if which == "estimator":
                    split = h_delta(before, h_series(H_SERIES))
        check(kernels.capture_count() == c1, f"{label}: a capture after "
              "the first replay")
        per_turn = n * H_TURN_EPOCHS
        step_ms = {k: sorted(w / per_turn * 1e3 for w in v)
                   for k, v in walls.items()}
        bare_ms = float(np.median(step_ms["bare"]))
        est_ms = float(np.median(step_ms["estimator"]))
        unread_ms = float(np.median(step_ms["no_metrics"]))
        steps = split["mxtpu_training_steps_total"]
        comp = split["mxtpu_training_compute_seconds"]
        wait = split["mxtpu_training_data_wait_seconds"]
        x, y = val[0]
        pred_loss = step(x, y)
        read_ms = h_metric_read_ms(torch, est, pred_loss[1], y,
                                   pred_loss[0])
        idle_bare = h_profile(torch, lambda: [step(*xy) for xy, _ in zip(
            loader, range(H_PROFILED))], H_PROFILED)
        idle_est = h_profile(torch, lambda: est.fit(
            loader, batches=H_PROFILED, event_handlers=[],
            compiled_step=True), H_PROFILED)
        row = {"bare_step_ms": bare_ms, "estimator_step_ms": est_ms,
               "no_metrics_step_ms": unread_ms,
               "bare_images_s": b / bare_ms * 1e3,
               "estimator_images_s": b / est_ms * 1e3,
               "reads_share": (est_ms - unread_ms) / bare_ms,
               "compute_ms": comp[1] / max(1, comp[0]) * 1e3,
               "data_wait_ms": wait[1] / max(1, wait[0]) * 1e3,
               "timed_steps": steps, "metric_read_ms": read_ms,
               "metric_read_share": read_ms / bare_ms,
               "idle_bare": idle_bare, "idle_estimator": idle_est,
               "step_ms_spread": {k: [round(v[0], 4), round(v[-1], 4)]
                                  for k, v in step_ms.items()},
               "walls_s": {k: [round(w, 4) for w in v]
                           for k, v in walls.items()}}
        spread = "; ".join(f"{k} {v[0]:.2f}..{v[-1]:.2f}"
                           for k, v in step_ms.items())
        log(f"{label} ({card}): {H_TURNS} rounds of turns of {per_turn} "
            f"batches (bare, estimator, estimator without metrics, then "
            f"reversed), medians: bare {bare_ms:.2f} ms a step "
            f"({row['bare_images_s']:.1f} images/s), estimator "
            f"{est_ms:.2f} ms ({row['estimator_images_s']:.1f} images/s), "
            f"gap {est_ms - bare_ms:+.2f} ms, of which the metrics' reads "
            f"{est_ms - unread_ms:+.2f} ms (the estimator without metrics "
            f"{unread_ms:.2f} ms); ms a step from fastest to slowest turn: "
            f"{spread}; StepTimer over the "
            f"estimator's epoch: compute {row['compute_ms']:.2f} ms, data "
            f"wait {row['data_wait_ms']:.2f} ms a step ({steps} steps); "
            f"the metrics' own cost {read_ms:.2f} ms a batch "
            f"({row['metric_read_share']:.3f} of the bare step); idle "
            f"bare {idle_bare}, estimator {idle_est}")
        log("8h row resnet: " + json.dumps(
            {k: (round(v, 4) if isinstance(v, float) else v)
             for k, v in row.items()}))
        if row["reads_share"] > H_METRIC_READ_SHARE:
            log(f"{label}: the metrics' host reads cost more than "
                f"{H_METRIC_READ_SHARE:.0%} of the step "
                f"({row['reads_share']:.3f})")
        step.release()
        del est, net, step, loader
        torch.cuda.empty_cache()
        return launches
    finally:
        torch.backends.cudnn.deterministic = deterministic
        shutil.rmtree(tmp, ignore_errors=True)


def run_h_bert(torch, rng, kernels, card, cfg=BERT_BASE, batch=BERT_BATCH,
               seqlen=BERT_T, steps=H_BERT_STEPS):
    """8h (b): BERT-base masked LM as phase 8 trains it (f32, dropout
    0.1, Adam) through an ``Estimator`` subclass whose ``fit_batch``
    passes the masked weights and valid lengths to a pre-built
    ``trainer.compile_step`` (the reference's documented override):
    ``steps`` batches, 12 launches of K6, K7a and K7b a step and one
    update launch, falling loss, the weights bit for bit those of 8e
    (c)'s bare compiled loop from the same weights and draw positions,
    the loss metric the mean of the per-step losses. (c): ``mx.profiler``
    around two more steps: the hand-written kernels in
    ``dumps(lane='device')``, the estimator's epoch and the train step's
    ranges on the host lane, ``rollup.summary``'s families summing to
    the trace's device time. Returns the launch counts of (b)."""
    import gzip
    import shutil
    import tempfile
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon, nd, profiler
    from mxnet_tpu_torch.gluon.contrib import estimator as E
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.observability import rollup
    from mxnet_tpu_torch.ops.flash_attention import KERNEL_NAMES
    label = "8h (b) bert f32"
    vocab, layers = cfg["vocab_size"], cfg["num_layers"]
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    data = bert_batches(torch, rng, steps + 2, vocab, batch, seqlen, DEVICE)

    def make():
        net = make_bert_mlm(0.1, **cfg)
        net.initialize(Xavier(), device=DEVICE,
                       generator=torch.Generator().manual_seed(0))
        with ag.pause():
            mlm_loss(net, loss_fn, data[0], vocab)
        tr = gluon.Trainer(net.collect_params(), "adam",
                           {"learning_rate": BERT_LR})
        return net, tr, tr.compile_step(
            lambda *d: mlm_loss(net, loss_fn, d, vocab), buckets=False)
    # 8e (c)'s bare loop; dropout draws from torch's default generator
    # (a capture registers it), the step's own draws from the process RNG
    net_b, tr_b, step_b = make()
    nd.random.seed(81)
    torch.manual_seed(81)
    bare = [step_b(*data[0])]
    torch.cuda.synchronize()
    t0 = time.monotonic()
    bare += [step_b(*d) for d in data[1:steps]]
    torch.cuda.synchronize()
    bare_ms = (time.monotonic() - t0) / (steps - 1) * 1e3
    bare = [float(v) for v in bare]
    want = h_weights(net_b)
    step_b.release()
    del net_b, tr_b, step_b
    torch.cuda.empty_cache()
    net, tr, step = make()

    class MLMEstimator(E.Estimator):
        """``fit_batch`` over the pre-built compiled step: the batch's
        masked weights and valid lengths go with it."""

        def fit_batch(self, batch):
            loss = step(*batch)
            self._step_applied = True
            return batch[0], batch[1], None, loss
    est = MLMEstimator(net, loss_fn, trainer=tr)
    losses, ends = [], []

    class Losses(E.BatchEnd):
        priority = 0

        def batch_end(self, est, *a, **kw):
            losses.append(float(kw["loss"]))
            ends.append(time.monotonic())
    nd.random.seed(81)
    torch.manual_seed(81)
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    est.fit(data[:steps], epochs=1, event_handlers=[Losses()])
    torch.cuda.synchronize()
    fit_s = time.monotonic() - t0
    launches = kernels.launch_counts()
    differ = h_same_bits(torch, h_weights(net), want)
    metric_loss = est.train_loss_metric.get()[1]
    est_ms = (ends[-1] - ends[0]) / (steps - 1) * 1e3
    log(f"{label} ({card}): steps 2-{steps}: the bare loop {bare_ms:.2f} ms "
        f"a step ({batch * seqlen / bare_ms * 1e3:.0f} tokens/s), the "
        f"estimator {est_ms:.2f} ms ({batch * seqlen / est_ms * 1e3:.0f} "
        f"tokens/s; its loss metric reads each step's loss back)")
    log(f"{label}: Estimator.fit over {steps} batches of {batch} x "
        f"{seqlen} through the pre-built compiled step in {fit_s:.2f}s: "
        "losses " + " ".join(f"{v:.4f}" for v in losses) + f" (bare loop "
        + " ".join(f"{v:.4f}" for v in bare) + f"); weights against the "
        f"bare loop: {len(differ)} of {len(want)} differ; loss metric "
        f"{metric_loss:.6f} against the mean {np.mean(losses):.6f}; "
        f"launches {launches}")
    check(step.last_reason is None and step.replays == steps - 1,
          f"{label}: reason {step.last_reason}, {step.replays} replays")
    check(all(np.isfinite(losses)) and losses[-1] < losses[0],
          f"{label}: losses {losses}")
    for name in KERNEL_NAMES:
        check(launches.get(name, 0) == layers * steps, f"{label}: {name} "
              f"launched {launches.get(name, 0)} times in {steps} steps")
    check(launches.get("adam_update", 0) == steps, f"{label}: adam_update "
          f"launched {launches.get('adam_update', 0)} times")
    check(not differ, f"{label}: weights differ from the bare loop's: "
          f"{differ[:5]}")
    check(losses == bare, f"{label}: losses {losses} against the bare "
          f"loop's {bare}")
    check(abs(metric_loss - np.mean(losses)) <= H_LOSS_REL_TOL *
          abs(np.mean(losses)), f"{label}: loss metric {metric_loss}")
    # (c) mx.profiler around two steps
    tmp = tempfile.mkdtemp(prefix="chip_smoke_8h_prof_")
    try:
        profiler.set_config(filename=os.path.join(tmp, "prof"))
        profiler.set_state("run")
        est.fit(data[steps:steps + 2], epochs=1, event_handlers=[])
        torch.cuda.synchronize()
        profiler.set_state("stop")
        dev = profiler.dumps(format_="dict", lane="device")
        both = profiler.dumps(format_="dict", lane="both")
        trace = rollup.find_trace(os.path.join(tmp, "prof"))
        with gzip.open(trace) as f:
            events = json.load(f)["traceEvents"]
        ranges = {e["name"] for e in events if e.get("ph") == "X"
                  and e.get("cat") == "user_annotation"}
        summ = rollup.summary(trace, steps=2, top=10 ** 6)
        fam_us = sum(f["ms_per_step"] for f in summ["families"]) * 2 * 1e3
        fam, total = rollup.rollup(trace)
        dev_us = both["device"]["total_us"]
        mine = {k: [key for key, (us, _) in dev.items() if k in key and
                    us > 0] for k in ("flash_fwd_kernel", "flash_dkv_kernel",
                                      "flash_dq_kernel",
                                      "multi_update_kernel")}
        log(f"8h (c) ({card}): mx.profiler over two estimator steps: "
            f"device {dev_us / 1e3:.2f} ms ({dev_us / 2e3:.2f} a step), "
            f"the families sum to {fam_us / 1e3:.2f} ms; hand-written "
            f"kernels on the device lane {sorted(k for k, v in mine.items() if v)}; "
            f"host ranges mxtpu.estimator.epoch "
            f"{'mxtpu.estimator.epoch' in ranges}, mxtpu.train_step "
            f"{'mxtpu.train_step' in ranges}")
        for line in rollup.family_table(fam, total, steps=2,
                                        top=8).splitlines():
            log(f"8h (c): {line}")
        for name, (us, cnt) in sorted(dev.items(),
                                      key=lambda kv: -kv[1][0])[:6]:
            log(f"8h (c): dumps {us / 1e3:9.3f} ms x{cnt:<5d} {name[:80]}")
        check(all(mine.values()), f"8h (c): hand-written kernels missing "
              f"from the device lane: {mine}")
        check({"mxtpu.estimator.epoch", "mxtpu.train_step"} <= ranges,
              "8h (c): the estimator's epoch or the train step's range is "
              "not on the host lane")
        check(abs(fam_us - dev_us) <= 0.01 * dev_us, f"8h (c): the "
              f"families sum to {fam_us} us, the trace's device time is "
              f"{dev_us} us")
    finally:
        profiler.set_state("stop")
        shutil.rmtree(tmp, ignore_errors=True)
    step.release()
    del est, net, tr, step, data
    torch.cuda.empty_cache()
    return launches


def run_h_slo(torch, kernels, card):
    """8h (d): a serving burst of ``H_BURST_S`` seconds on an f32
    ``ModelServer`` on the card (a two-layer MLP of ``H_SERVE_UNITS``,
    one CUDA graph a bucket) with one request in 250 expired at submit; a
    ``TimeSeriesRing`` samples the registry every ``H_SAMPLE_S``, an
    ``SLOEngine`` evaluates a latency SLO and an availability SLO,
    ``capacity.build_report(..., chips=1)`` derives the rates. Checks:
    the report's rates equal the counters' deltas read at the window's
    quiet ends, the report names the card, ``compile_count()`` equals the
    counter and the counter the builds and captures since the process
    began."""
    import threading
    from mxnet_tpu_torch import serving
    from mxnet_tpu_torch.gluon import nn
    from mxnet_tpu_torch.initializer import Xavier
    from mxnet_tpu_torch.observability import (SLO, SLOEngine,
                                               STATUS_PAGE, STATUS_WARN,
                                               TimeSeriesRing, capacity,
                                               compilemon, get_registry)
    from mxnet_tpu_torch.serving import telemetry
    u = H_SERVE_UNITS
    block = nn.HybridSequential(prefix="h_slo_")
    with block.name_scope():
        block.add(nn.Dense(4 * u, activation="relu", in_units=u),
                  nn.Dense(u, in_units=4 * u))
    block.initialize(Xavier(), device=DEVICE,
                     generator=torch.Generator().manual_seed(0))
    server = serving.ModelServer(block, buckets=list(H_SERVE_BUCKETS),
                                 max_delay_ms=2.0, item_shape=(u,),
                                 dtype="float32", name="h-slo").start()
    server.warmup()
    name = server._stats.server_label
    reg = get_registry()
    served = reg.get("mxtpu_serving_requests_completed_total").labels(
        server=name)
    views = (telemetry.compile_count(), compilemon.compile_count(),
             kernels.build_count() + kernels.capture_count())
    ring = TimeSeriesRing(reg, capacity=128)
    x = np.random.RandomState(5).randn(64, u).astype(np.float32)
    futs, expired, stop = [], [0], threading.Event()

    def client():
        i = 0
        while not stop.is_set():
            if i % 250 == 249:
                try:
                    server.submit(x[i % 64], deadline_ms=0)
                except serving.DeadlineExceededError:
                    expired[0] += 1
            else:
                futs.append(server.submit(x[i % 64]))
            i += 1
            time.sleep(0.001)
    t_first = time.monotonic()
    v_first = served.value
    ring.record(now=t_first)
    th = threading.Thread(target=client)
    th.start()
    end = t_first + H_BURST_S
    while time.monotonic() < end - H_SAMPLE_S:
        time.sleep(H_SAMPLE_S)
        ring.record()
    stop.set()
    th.join()
    for f in futs:
        f.result(timeout=60)
    server.shutdown()      # the worker has counted every batch it served
    t_last = time.monotonic()
    v_last = served.value
    ring.record(now=t_last)
    lat = SLO.latency("h_latency", threshold_ms=25.0, target=0.99,
                      labels={"server": name})
    avail = SLO.serving_availability("h_availability", name, target=0.99)
    eng = SLOEngine([lat, avail], ring, windows=[
        (4.0, 1.0, 14.4, STATUS_PAGE), (8.0, 2.0, 6.0, STATUS_WARN)])
    reports = eng.evaluate()
    rec = capacity.build_report(ring, reports, [("serving", name, lat)],
                                chips=1)
    fe = rec["frontends"][0]
    want_qps = (v_last - v_first) / (t_last - t_first)
    p99 = ring.percentile_over("mxtpu_serving_latency_seconds", 99,
                               {"server": name})
    log(f"8h (d) ({card}): {len(futs)} requests served and {expired[0]} "
        f"expired at submit in {t_last - t_first:.2f}s, {len(ring)} "
        f"snapshots; served {fe['served_qps']:.2f}/s (the counter's delta "
        f"{want_qps:.2f}/s), good {fe['good_qps']:.2f}/s, expired "
        f"{fe['expired_qps']:.2f}/s, windowed p99 "
        f"{'not measured' if p99 is None else f'{p99 * 1e3:.2f} ms'}; "
        + "; ".join(f"{k}: attainment {r['attainment']:.4f}, status "
                    f"{r['status_name']}, burn {r['burn_rates']}"
                    for k, r in reports.items())
        + f"; capacity {rec['value']} chips per 1M users at "
        f"{rec['user_model']}, device {rec['device']!r}; compile count "
        f"{views}")
    log("8h row capacity: " + json.dumps(
        {k: rec[k] for k in ("metric", "value", "slo_attained", "chips",
                             "device", "window_s", "snapshots")}
        | {"served_qps": fe["served_qps"], "good_qps": fe["good_qps"]}))
    check(abs(fe["served_qps"] - want_qps) <= 1e-9 * max(1.0, want_qps),
          f"8h (d): served_qps {fe['served_qps']} against the counter's "
          f"delta {want_qps}")
    check(v_last - v_first == len(futs), f"8h (d): the counter moved "
          f"{v_last - v_first} for {len(futs)} served requests")
    check(rec["device"] == torch.cuda.get_device_name(0),
          f"8h (d): the report names {rec['device']!r}")
    check(views[0] == views[1] == views[2], f"8h (d): compile_count(), "
          f"the counter and builds + captures differ: {views}")
    check(reports["h_availability"]["total"] > 0 and
          reports["h_availability"]["good"] == len(futs),
          f"8h (d): availability report {reports['h_availability']}")


def run_estimator_phase(torch, rng, kernels, card):
    """Phase 8h, the estimator and its telemetry: (a) ResNet-50 through
    ``Estimator.fit(compiled_step=True)``, (b) BERT-base through an
    Estimator subclass over a pre-built compiled step, (c) ``mx.profiler``
    and the rollup around two of its steps, (d) SLOs and capacity over a
    serving burst. Returns the launch counts of (a) and (b)."""
    launches = {}

    def add(counts):
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
    t0 = time.monotonic()
    add(run_h_resnet(torch, kernels, card))
    log(f"time: 8h (a) {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    add(run_h_bert(torch, rng, kernels, card))
    log(f"time: 8h (b)-(c) {time.monotonic() - t0:.1f}s")
    t0 = time.monotonic()
    run_h_slo(torch, kernels, card)
    torch.cuda.empty_cache()
    log(f"time: 8h (d) {time.monotonic() - t0:.1f}s")
    return launches


_BUILTIN_ARGS = {"a": "int8", "h": "uint8", "f": "f32", "i": "int"}


# ------------------------------------------- 8i: the symbolic API --
def _sym_conv_bn_relu(mx, data, num_filter, kernel, stride, pad, name,
                      relu=True):
    body = mx.sym.Convolution(data, num_filter=num_filter, kernel=kernel,
                              stride=stride, pad=pad, no_bias=True,
                              name=name + "_conv")
    body = mx.sym.BatchNorm(body, fix_gamma=False, eps=2e-5, momentum=0.9,
                            name=name + "_bn")
    if relu:
        body = mx.sym.Activation(body, act_type="relu", name=name + "_relu")
    return body


def _sym_residual_unit(mx, data, num_filter, stride, dim_match, name):
    """One bottleneck ResNet v1.5 unit (the stride in the 3x3 conv)."""
    body = _sym_conv_bn_relu(mx, data, num_filter // 4, (1, 1), (1, 1),
                             (0, 0), name + "_a")
    body = _sym_conv_bn_relu(mx, body, num_filter // 4, (3, 3), stride,
                             (1, 1), name + "_b")
    body = _sym_conv_bn_relu(mx, body, num_filter, (1, 1), (1, 1), (0, 0),
                             name + "_c", relu=False)
    shortcut = data if dim_match else _sym_conv_bn_relu(
        mx, data, num_filter, (1, 1), stride, (0, 0), name + "_ds",
        relu=False)
    out = mx.sym.elemwise_add(body, shortcut, name=name + "_add")
    return mx.sym.Activation(out, act_type="relu", name=name + "_out")


def symbolic_resnet(mx, num_classes=1000, num_layers=50):
    """examples/train_imagenet.py's symbolic ResNet v1.5 (its
    get_resnet_symbol at a 224x224 image, bottleneck depths 50/101/152),
    built from the port's ``mx.sym``: the example imports the JAX
    package, so its network is copied here."""
    units = {50: [3, 4, 6, 3], 101: [3, 4, 23, 3],
             152: [3, 8, 36, 3]}[num_layers]
    data = mx.sym.Variable("data")
    body = _sym_conv_bn_relu(mx, data, 64, (7, 7), (2, 2), (3, 3), "stem")
    body = mx.sym.Pooling(body, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max", name="stem_pool")
    for stage, (n_units, nf) in enumerate(zip(units,
                                              [256, 512, 1024, 2048])):
        for unit in range(n_units):
            stride = (1, 1) if stage == 0 or unit > 0 else (2, 2)
            body = _sym_residual_unit(mx, body, nf, stride, unit > 0,
                                      f"stage{stage + 1}_unit{unit + 1}")
    body = mx.sym.Pooling(body, global_pool=True, pool_type="avg",
                          kernel=(1, 1), name="gap")
    body = mx.sym.Flatten(body, name="flat")
    body = mx.sym.FullyConnected(body, num_hidden=num_classes, name="fc1")
    return mx.sym.SoftmaxOutput(body, name="softmax")


# 8i (a): examples/train_imagenet.py --benchmark 1 at its defaults but
# the batch (32, as 8d (b) and 8e (d) train f32 NCHW) and the epoch (10
# steps): 128 seeded images a pass (the example's synthetic iterator)
# behind a ResizeIter
SYM_BATCH, SYM_STEPS, SYM_IMAGES = 32, 10, 128
SYM_SGD = {"learning_rate": 0.1, "momentum": 0.9, "wd": 1e-4,
           "rescale_grad": 1.0 / SYM_BATCH}
# the first training forward's logits (fc1's output) at batch 2, the card
# against the same bound graph on the CPU, f32 with TF32 off, relative to
# the largest logit: 53 convolutions summed in other orders (cuDNN's and
# the CPU's) through training-mode BatchNorm; ReLU is continuous, so a
# gate that flips on a tie moves the logits by the tie's size only
SYM_LOGIT_REL_TOL = 1e-4
# 8i (b): one BERT-base encoder layer, written with the symbolic API
SYM_LAYER = dict(units=768, heads=12, hidden=3072)
SYM_LAYER_BATCH, SYM_LAYER_T = 8, 512
# the layer's output and its q/k/v projections' weight gradients, flash
# kernels against the op's plain path (flash=False), relative to each
# result's largest entry: one layer of f32 products after attention
# carries the kernels' last-bit differences (FLASH_REL_TOL) into sums
# over 4096 tokens
SYM_LAYER_REL_TOL = 1e-4


def symbolic_encoder_layer(mx, flash=True, units=768, heads=12,
                           hidden=3072):
    """A post-LN transformer encoder layer (BERT's) from ``mx.sym``:
    ``data`` (B, T, units) and an additive padding row ``bias`` (B, T);
    the attention is ``sym.scaled_dot_product_attention`` (the flash
    kernels, or with ``flash=False`` its plain path)."""
    x = mx.sym.var("data")
    bias = mx.sym.var("bias")

    def split(t):
        return mx.sym.transpose(mx.sym.reshape(t, shape=(0, 0, heads, -1)),
                                axes=(0, 2, 1, 3))
    q, k, v = (mx.sym.FullyConnected(x, num_hidden=units, flatten=False,
                                     name=n) for n in ("query", "key",
                                                       "value"))
    att = mx.sym.scaled_dot_product_attention(
        split(q), split(k), split(v), bias, name="att", flash=flash)
    att = mx.sym.reshape(mx.sym.transpose(att, axes=(0, 2, 1, 3)),
                         shape=(0, 0, -1))
    proj = mx.sym.FullyConnected(att, num_hidden=units, flatten=False,
                                 name="proj")
    h = mx.sym.LayerNorm(proj + x, name="attn_ln")
    f = mx.sym.Activation(mx.sym.FullyConnected(
        h, num_hidden=hidden, flatten=False, name="ffn1"), act_type="gelu",
        name="gelu")
    f = mx.sym.FullyConnected(f, num_hidden=units, flatten=False,
                              name="ffn2")
    return mx.sym.LayerNorm(f + h, name="ffn_ln")


def sym_rel(a, b):
    """max |a - b| over the largest |b| (NDArrays or tensors)."""
    a = a.asnumpy() if hasattr(a, "asnumpy") else a.detach().cpu().numpy()
    b = b.asnumpy() if hasattr(b, "asnumpy") else b.detach().cpu().numpy()
    return float(np.abs(a - b).max() / max(float(np.abs(b).max()), 1e-30))


def run_sym_resnet(torch, kernels, rng):
    """8i (a): examples/train_imagenet.py's symbolic ResNet-50 (v1.5, 3 x
    224 x 224, 1000 classes, f32 NCHW, TF32 off) trained through
    ``Module.fit`` over an ``NDArrayIter`` as the example's --benchmark 1
    mode does (SGD lr 0.1, momentum 0.9, wd 1e-4, the example's Xavier),
    at batch SYM_BATCH for SYM_STEPS steps, then two profiled steps.
    Checks: the first training forward's logits at batch 2 against the
    same bound graph on the CPU, finite loss and parameters, the
    BatchNorm running statistics moved, one update launch a parameter a
    step. Returns the launch counts of the fit."""
    import mxnet_tpu_torch as mx
    label = "8i (a) symbolic ResNet-50 Module.fit"
    sym = symbolic_resnet(mx, 1000, 50)
    data = rng.uniform(-1, 1, (SYM_IMAGES, 3, 224, 224)).astype(np.float32)
    labels = rng.randint(0, 1000, SYM_IMAGES).astype(np.float32)
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    it = mx.io.ResizeIter(mx.io.NDArrayIter(
        mx.nd.array(data, ctx=ctx), mx.nd.array(labels, ctx=ctx),
        batch_size=SYM_BATCH), SYM_STEPS)
    mod = mx.mod.Module(sym, context=ctx)
    mod.bind(data_shapes=it.provide_data, label_shapes=it.provide_label)
    mx.random.seed(0)
    torch.manual_seed(0)
    mod.init_params(initializer=mx.initializer.Xavier(
        rnd_type="gaussian", factor_type="in", magnitude=2))
    args, auxs = mod.get_params()
    # the first forward's logits at batch 2, card and CPU
    feat = sym.get_internals()["fc1_output"]
    logits = []
    for c in (ctx, mx.cpu()):
        ex = feat.simple_bind(ctx=c, grad_req="null", data=(2, 3, 224, 224))
        ex.copy_params_from({k: v.as_in_context(c) for k, v in args.items()},
                            {k: v.as_in_context(c) for k, v in auxs.items()},
                            allow_extra_params=True)
        logits.append(ex.forward(is_train=True,
                                 data=mx.nd.array(data[:2], ctx=c))[0])
        del ex
    err = sym_rel(logits[0], logits[1])
    check(err <= SYM_LOGIT_REL_TOL, f"{label}: first forward's logits card "
          f"vs CPU {err:.3g} > {SYM_LOGIT_REL_TOL}")
    n_params = len(args)
    times = []

    def tick(param):
        torch.cuda.synchronize()
        times.append(time.monotonic())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    mod.fit(it, eval_metric="acc", kvstore=mx.kv.create("device"),
            optimizer="sgd", optimizer_params=dict(SYM_SGD),
            initializer=mx.initializer.Xavier(rnd_type="gaussian",
                                              factor_type="in", magnitude=2),
            batch_end_callback=[tick], num_epoch=1, allow_missing=True)
    fit_s = time.monotonic() - t0
    launches = kernels.launch_counts()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    step_ms = float(np.median(np.diff(times))) * 1e3
    probs = mod.get_outputs()[0].asnumpy()
    last = labels[((SYM_STEPS - 1) * SYM_BATCH) % SYM_IMAGES:][:SYM_BATCH]
    loss = float(-np.log(np.maximum(
        probs[np.arange(SYM_BATCH), last.astype(np.int64)], 1e-30)).mean())
    new_args, new_auxs = mod.get_params()
    check(np.isfinite(loss) and all(np.isfinite(v.asnumpy()).all()
                                    for v in new_args.values()),
          f"{label}: non-finite loss {loss} or parameters")
    moved = [n for n in new_auxs if not np.array_equal(
        new_auxs[n].asnumpy(), auxs[n].asnumpy())]
    check(len(moved) == len(auxs) and len(auxs) == 106,
          f"{label}: {len(moved)} of {len(auxs)} BatchNorm running "
          "statistics moved")
    check(launches.get("sgd_mom_update", 0) == SYM_STEPS * n_params,
          f"{label}: sgd_mom_update launched "
          f"{launches.get('sgd_mom_update', 0)} times, want "
          f"{SYM_STEPS} x {n_params}")
    it.reset()
    batches = [(next(it),), (next(it),)]

    def step(batch):
        mod.forward_backward(batch)
        mod.update()
    prof, wall = profiled(torch, step, batches)
    share = report_profile(prof, wall, 2)
    summary = {"step_ms": step_ms, "images_s": SYM_BATCH / step_ms * 1e3,
               "peak_gb": peak_gb,
               "device_ms": device_rows(prof)[1] / 1e3 / 2,
               "idle": None if share is None else 1 - share}
    SYM_ROWS["8i (a)"] = summary
    log(f"{label}: batch {SYM_BATCH}, {SYM_STEPS} steps in {fit_s:.2f}s "
        f"(fit, binding done); last batch loss {loss:.4f}; first forward's "
        f"logits card vs CPU {err:.3g} (tol {SYM_LOGIT_REL_TOL}); "
        f"{len(moved)} running statistics moved; {n_params} parameters, "
        f"update launches {launches.get('sgd_mom_update', 0)}")
    eager = EAGER_ROWS.get("8d (b) f32 NCHW", {})
    compiled = COMPILED_ROWS.get("8e (d) f32 NCHW", {})

    def fmt(v, f):
        return "not measured" if v is None else format(v, f)
    log(f"{label}: step {step_ms:.2f} ms (median of steps 2-{SYM_STEPS}), "
        f"{summary['images_s']:.1f} images/s, peak {peak_gb:.2f} GB, "
        f"profiled device {fmt(summary['device_ms'], '.2f')} ms a step, "
        f"idle {fmt(summary['idle'], '.3f')}; gluon ResNet-50 v1 at the "
        f"same batch in this call: eager (8d (b)) "
        f"{fmt(eager.get('step_ms'), '.2f')} ms, compiled (8e (d)) "
        f"{fmt(compiled.get('step_ms'), '.2f')} ms")
    log("8i row (a): " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in summary.items()}))
    del mod, it, logits
    torch.cuda.empty_cache()
    return launches


def run_sym_attention(torch, kernels, rng):
    """8i (b): one BERT-base encoder layer written with the symbolic API
    (768 wide, 12 heads, B=8, T=512, f32, the padding mask), bound with
    ``simple_bind``: one ``forward(is_train=True)`` + ``backward()``
    launches K6 once and K7a/K7b once each; the output and the q/k/v
    projections' gradients against the same executor on the op's plain
    path; the attention op alone at the layer's shapes, its q, k and v
    gradients against the plain path to FLASH_REL_TOL. Returns the
    launch counts of the kernel step."""
    import mxnet_tpu_torch as mx
    label = "8i (b) symbolic encoder layer"
    B, T, U = SYM_LAYER_BATCH, SYM_LAYER_T, SYM_LAYER["units"]
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    vlen = rng.randint(T // 4, T + 1, size=B)
    bias = np.where(np.arange(T)[None, :] < vlen[:, None], 0.0,
                    -1e30).astype(np.float32)
    shapes = {"data": (B, T, U), "bias": (B, T)}
    og = mx.nd.array(rng.randn(B, T, U).astype(np.float32), ctx=ctx)
    runs, counts = [], None
    args = None
    for flash in (True, False):
        sym = symbolic_encoder_layer(mx, flash=flash, **SYM_LAYER)
        ex = sym.simple_bind(ctx=ctx, **shapes)
        if args is None:
            arg_shapes, _, _ = sym.infer_shape(**shapes)
            args = {n: (rng.randn(*s) * (0.02 if n.endswith("weight")
                                         else 0.1)).astype(np.float32)
                    for n, s in zip(sym.list_arguments(), arg_shapes)}
            args["data"] = rng.randn(B, T, U).astype(np.float32)
            args["bias"] = bias
            for n in ("attn_ln_gamma", "ffn_ln_gamma"):
                args[n] = np.ones(U, np.float32)
        ex.copy_params_from({k: mx.nd.array(v, ctx=ctx)
                             for k, v in args.items()})
        ex.forward(is_train=True)       # builds, loads and warms
        ex.backward(og)
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        out = ex.forward(is_train=True)[0]
        ex.backward(og)
        torch.cuda.synchronize()
        if flash:
            counts = kernels.launch_counts()
        times = []
        for _ in range(3):
            t0 = time.monotonic()
            ex.forward(is_train=True)
            ex.backward(og)
            torch.cuda.synchronize()
            times.append(time.monotonic() - t0)
        runs.append((out, {n: ex.grad_dict[n] for n in
                           ("query_weight", "key_weight", "value_weight",
                            "data")}, float(np.median(times)) * 1e3))
        del ex
    for k in ("flash_fwd", "flash_bwd_dkv", "flash_bwd_dq"):
        check(counts.get(k, 0) == 1, f"{label}: {k} launched "
              f"{counts.get(k, 0)} times in one forward + backward")
    errs = {"out": sym_rel(runs[0][0], runs[1][0])}
    errs.update({n: sym_rel(runs[0][1][n], runs[1][1][n])
                 for n in runs[0][1]})
    bad = {n: e for n, e in errs.items() if e > SYM_LAYER_REL_TOL}
    check(not bad, f"{label}: kernels vs plain {bad} > {SYM_LAYER_REL_TOL}")
    # the attention op alone: the gradients of q, k and v
    q, k, v, b = (mx.sym.var(n) for n in ("q", "k", "v", "b"))
    H = SYM_LAYER["heads"]
    qkv = {n: rng.randn(B, H, T, U // H).astype(np.float32) for n in "qkv"}
    aog = mx.nd.array(rng.randn(B, H, T, U // H).astype(np.float32),
                      ctx=ctx)
    alone = []
    for flash in (True, False):
        ex = mx.sym.scaled_dot_product_attention(
            q, k, v, b, flash=flash, name="att").simple_bind(
                ctx=ctx, q=(B, H, T, U // H), k=(B, H, T, U // H),
                v=(B, H, T, U // H), b=(B, T))
        out = ex.forward(is_train=True, b=bias, **qkv)[0]
        ex.backward(aog)
        alone.append([out] + [ex.grad_dict[n] for n in "qkv"])
    aerrs = [sym_rel(g, w) for g, w in zip(*alone)]
    check(max(aerrs) <= FLASH_REL_TOL, f"{label}: the attention op alone, "
          f"out/dq/dk/dv vs plain {aerrs} > {FLASH_REL_TOL}")
    log(f"{label}: one forward + backward launched flash_fwd "
        f"{counts.get('flash_fwd', 0)}, flash_bwd_dkv "
        f"{counts.get('flash_bwd_dkv', 0)}, flash_bwd_dq "
        f"{counts.get('flash_bwd_dq', 0)}; kernels vs plain (relative): "
        + ", ".join(f"{n} {e:.3g}" for n, e in errs.items())
        + f" (tol {SYM_LAYER_REL_TOL}); the op alone out/dq/dk/dv "
        + " ".join(f"{e:.3g}" for e in aerrs)
        + f" (tol {FLASH_REL_TOL}); executor step (forward + backward) "
        f"{runs[0][2]:.2f} ms with the kernels, {runs[1][2]:.2f} ms plain")
    log("8i row (b): " + json.dumps({"step_ms": round(runs[0][2], 4),
                                     "plain_step_ms": round(runs[1][2], 4),
                                     **{k: round(e, 8)
                                        for k, e in errs.items()}}))
    torch.cuda.empty_cache()
    return counts


def run_symbolic_phase(torch, rng, kernels):
    """8i: the symbolic API and the Module: (a) the symbolic ResNet-50
    through Module.fit, (b) a symbolic encoder layer on the flash
    kernels. Returns the launch counts of both."""
    counts = dict(run_sym_resnet(torch, kernels, rng))
    for k, n in run_sym_attention(torch, kernels, rng).items():
        counts[k] = counts.get(k, 0) + n
    return counts


# 8j: records and images. The decoders it requires, fixed from a probe of
# the card host (g++ 13.3; Python cv2 4.13.0; no OpenCV C++ headers or
# libraries): the native record readers build with g++; the native decode
# pool needs OpenCV's C++ libraries and does not, so ImageRecordIter is
# ImageIter there (cv2 decodes, the pure-Python augmenters run on the
# card). A missing decoder fails the phase.
REC_ITER = "ImageIter"
# 256 seeded 256 x 256 RGB images, labels in 0-999, JPEG quality 90:
# the first REC_TRAIN in train.rec/.idx, the rest in val.rec/.idx
REC_IMAGES, REC_SIDE, REC_QUALITY, REC_TRAIN = 256, 256, 90, 128
REC_SHAPE, REC_BATCH, REC_RESIZE = (3, 224, 224), 32, 256
# ImageNet's channel mean and std (the reference's ImageRecordIter options)
REC_MEAN = dict(mean_r=123.68, mean_g=116.779, mean_b=103.939)
REC_STD = dict(std_r=58.393, std_g=57.12, std_b=57.375)
REC_SEED = 7
# the float augmenters (brightness, normalization), card against CPU,
# relative to the largest value: the same host arithmetic on both
REC_AUG_REL_TOL = 1e-6
# SYM_ROWS: 8i's summaries by label (8j prints its record-fed step beside
# 8i (a)'s synthetic-fed one)
SYM_ROWS = {}


def rec_images(rng, n, side):
    """``n`` seeded side x side RGB images: a 16 x 16 field resized
    bilinearly, plus noise (JPEGs of a natural image's size)."""
    import cv2
    base = rng.randint(0, 256, (n, 16, 16, 3)).astype(np.uint8)
    noise = rng.randint(-8, 9, (n, side, side, 3)).astype(np.int16)
    out = np.empty((n, side, side, 3), np.uint8)
    for i in range(n):
        up = cv2.resize(base[i], (side, side),
                        interpolation=cv2.INTER_LINEAR)
        out[i] = np.clip(up.astype(np.int16) + noise[i], 0, 255)
    return out


def load_example(name):
    """``examples/<name>.py`` as a module over the port (its imports of
    the JAX package turned into ``mxnet_tpu_torch``)."""
    import types
    path = os.path.join(HERE, "examples", name + ".py")
    with open(path) as f:
        src = re.sub(r"\bmxnet_tpu\b", "mxnet_tpu_torch", f.read())
    mod = types.ModuleType(f"_{name}_port")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def run_rec_write_read(torch, rng, root):
    """8j (a): write the records with ``recordio.pack_img`` and read them
    back through the native sequential reader, the native prefetch
    reader and the pure-Python reader: the same bytes. Returns
    {"train": path, "val": path} and the labels of each."""
    from mxnet_tpu_torch import native, recordio
    label = "8j (a) records"
    check(native.recordio_lib() is not None, f"{label}: the native record "
          f"reader did not build: {native.last_build_error}")
    imgs = rec_images(rng, REC_IMAGES, REC_SIDE)
    labels = rng.randint(0, 1000, REC_IMAGES)
    paths, parts = {}, {"train": range(REC_TRAIN),
                        "val": range(REC_TRAIN, REC_IMAGES)}
    t0 = time.monotonic()
    for part, rows in parts.items():
        paths[part] = os.path.join(root, part + ".rec")
        w = recordio.MXIndexedRecordIO(os.path.join(root, part + ".idx"),
                                       paths[part], "w")
        for k, i in enumerate(rows):
            w.write_idx(k, recordio.pack_img(
                recordio.IRHeader(0, float(labels[i]), k, 0), imgs[i],
                quality=REC_QUALITY, img_fmt=".jpg"))
        w.close()
    write_s = time.monotonic() - t0
    nbytes = sum(os.path.getsize(p) for p in paths.values())
    reads = {}

    def python_reader(path):
        os.environ["MXNET_TPU_NATIVE"] = "0"
        try:
            r = recordio.MXRecordIO(path, "r")
        finally:
            del os.environ["MXNET_TPU_NATIVE"]
        check(r._native is None, f"{label}: the Python reader is native")
        return r

    for name, make in (("native", native.NativeRecordReader),
                       ("prefetch", native.NativePrefetchReader),
                       ("python", python_reader)):
        t0 = time.monotonic()
        got = []
        for part in parts:
            r = make(paths[part])
            while True:
                rec = r.read()
                if rec is None:
                    break
                got.append(rec)
            r.close()
        reads[name] = (got, time.monotonic() - t0)
    recs = reads["python"][0]
    check(len(recs) == REC_IMAGES, f"{label}: {len(recs)} records read of "
          f"{REC_IMAGES}")
    for name in ("native", "prefetch"):
        check(reads[name][0] == recs, f"{label}: the {name} reader's bytes "
              "differ from the Python reader's")
    got_labels = [float(recordio.unpack(r)[0].label) for r in recs]
    check(got_labels == [float(v) for v in labels],
          f"{label}: labels read back differ")
    h, img = recordio.unpack_img(recs[0])
    check(img.shape == (REC_SIDE, REC_SIDE, 3) and
          float(np.abs(img.astype(np.float32) - imgs[0]).mean()) < 8.0,
          f"{label}: record 0 decodes to {img.shape}, far from its image")
    log(f"{label}: {REC_IMAGES} images {REC_SIDE} x {REC_SIDE} JPEG "
        f"q{REC_QUALITY} in train.rec ({REC_TRAIN}) and val.rec, "
        f"{nbytes / 1e6:.2f} MB written in {write_s:.2f}s; the same bytes "
        "through " + ", ".join(
            f"{n} ({nbytes / 1e6 / max(t, 1e-9):.0f} MB/s)"
            for n, (_, t) in reads.items()))
    return paths, labels


def rec_iter(mx, path, **kw):
    return mx.io.MXDataIter(
        "ImageRecordIter", path_imgrec=path, data_shape=REC_SHAPE,
        batch_size=REC_BATCH, shuffle=True, rand_crop=True,
        rand_mirror=True, resize=REC_RESIZE, **REC_MEAN, **REC_STD, **kw)


def run_rec_iter(torch, paths, labels):
    """8j (b): ``MXDataIter("ImageRecordIter", ...)`` over train.rec: the
    iterator is ``REC_ITER``, every batch on the card in f32 at
    (32, 3, 224, 224) with the records' labels, normalized; the same
    bits with ``preprocess_threads=1``; ms a batch and images/s."""
    import random
    import mxnet_tpu_torch as mx
    label = "8j (b) ImageRecordIter"
    random.seed(REC_SEED)
    it = rec_iter(mx, paths["train"])
    check(type(it).__name__ == REC_ITER, f"{label}: MXDataIter gave "
          f"{type(it).__name__}, the probe's host gives {REC_ITER}")
    times, got, first = [], [], None
    while True:
        t0 = time.monotonic()
        try:
            b = next(it)
        except StopIteration:
            break
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
        x = b.data[0]
        check(x._data.device.type == DEVICE and x.dtype == np.float32
              and x.shape == (REC_BATCH,) + REC_SHAPE,
              f"{label}: batch on {x._data.device}, {x.dtype}, {x.shape}")
        check(bool(torch.isfinite(x._data).all()) and
              abs(float(x._data.mean())) < 3.0,
              f"{label}: a batch is not finite or not normalized")
        got += b.label[0].asnumpy().tolist()
        first = x if first is None else first
    check(len(times) == REC_TRAIN // REC_BATCH, f"{label}: {len(times)} "
          "batches")
    check(sorted(got) == sorted(float(v) for v in labels[:REC_TRAIN]),
          f"{label}: the batches' labels are not the records'")
    random.seed(REC_SEED)
    again = next(rec_iter(mx, paths["train"], preprocess_threads=1))
    check(torch.equal(again.data[0]._data, first._data),
          f"{label}: preprocess_threads=1 gives other bits")
    ms = float(np.median(times)) * 1e3
    summary = {"iterator": type(it).__name__, "iter_batch_ms": ms,
               "iter_images_s": REC_BATCH / ms * 1e3}
    log(f"{label}: {type(it).__name__} (as asked: {REC_ITER}), "
        f"{len(times)} batches of {REC_BATCH} at {REC_SHAPE} on "
        f"{first._data.device}, f32; {ms:.1f} ms a batch (median), "
        f"{summary['iter_images_s']:.1f} images/s; the same bits with "
        "preprocess_threads=1")
    return summary


def run_rec_train_imagenet(torch, kernels, paths, root):
    """8j (c): examples/train_imagenet.py's ``main`` through the port on
    the records: ResNet-50 (1000 classes, 3 x 224 x 224, batch 32), the
    128 training records (4 batches), val.rec for its eval, a
    ``--model-prefix`` checkpoint; the checkpoint reloaded scores the
    val records as the trained module does, its parameters the trained
    ones bit for bit; one update launch a parameter a step. Then 4 steps
    fed by the records (fetch, forward and backward, update, metric)
    timed, 2 of them profiled. Returns the summary and the launch counts
    of ``main``."""
    import argparse
    import mxnet_tpu_torch as mx
    label = "8j (c) train_imagenet.py on the records"
    ti = load_example("train_imagenet")
    prefix = os.path.join(root, "r50")
    argv = ["--data-train", paths["train"], "--data-val", paths["val"],
            "--network", "resnet", "--num-layers", "50", "--num-classes",
            "1000", "--image-shape", ",".join(map(str, REC_SHAPE)),
            "--resize", str(REC_RESIZE), "--batch-size", str(REC_BATCH),
            "--num-examples", str(REC_TRAIN), "--num-epochs", "1",
            "--lr-step-epochs", "", "--disp-batches", "2",
            "--model-prefix", prefix]
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.monotonic()
    mod = ti.main(argv)
    torch.cuda.synchronize()
    main_s = time.monotonic() - t0
    launches = kernels.launch_counts()
    args, auxs = mod.get_params()
    steps = REC_TRAIN // REC_BATCH
    check(launches.get("sgd_mom_update", 0) == steps * len(args),
          f"{label}: sgd_mom_update launched "
          f"{launches.get('sgd_mom_update', 0)} times, want {steps} x "
          f"{len(args)}")
    check(all(np.isfinite(v.asnumpy()).all() for v in args.values()),
          f"{label}: non-finite parameters")
    ns = ti.add_args(argparse.ArgumentParser()).parse_args(argv)
    ns.image_shape_t = REC_SHAPE
    kv = mx.kv.create(ns.kv_store)
    val = ti.get_rec_iter(ns, kv)[1]
    trained = dict(mod.score(val, "acc"))["accuracy"]
    sym, l_args, l_auxs = mx.model.load_checkpoint(prefix, 1)
    same = all(np.array_equal(l_args[k].asnumpy(), v.asnumpy())
               for k, v in args.items()) and all(
        np.array_equal(l_auxs[k].asnumpy(), v.asnumpy())
        for k, v in auxs.items())
    check(same, f"{label}: the checkpoint's parameters are not the "
          "trained module's")
    scored = mx.mod.Module(symbol=sym, context=mx.current_context())
    val.reset()
    scored.bind(data_shapes=val.provide_data,
                label_shapes=val.provide_label, for_training=False)
    scored.set_params(l_args, l_auxs)
    acc = dict(scored.score(val, "acc"))["accuracy"]
    check(np.isfinite(acc) and acc == trained, f"{label}: the reloaded "
          f"checkpoint scores {acc}, the trained module {trained}")
    del scored, l_args, l_auxs
    train = ti.get_rec_iter(ns, kv)[0]
    metric = mx.metric.create("acc")

    def step():
        batch = next(train)
        mod.forward_backward(batch)
        mod.update()
        mod.update_metric(metric, batch.label)
    times = []
    for _ in range(steps):
        t0 = time.monotonic()
        step()
        torch.cuda.synchronize()
        times.append(time.monotonic() - t0)
    train.reset()
    prof, wall = profiled(torch, step, [(), ()])
    share = report_profile(prof, wall, 2)
    step_ms = float(np.median(times[1:])) * 1e3
    summary = {"step_ms": step_ms, "images_s": REC_BATCH / step_ms * 1e3,
               "device_ms": device_rows(prof)[1] / 1e3 / 2,
               "idle": None if share is None else 1 - share,
               "main_s": main_s}
    synth = SYM_ROWS.get("8i (a)", {})

    def fmt(v, f):
        return "not measured" if v is None else format(v, f)
    log(f"{label}: main() {main_s:.2f}s ({steps} training batches, the "
        f"val eval, the checkpoint); {len(args)} parameters, update "
        f"launches {launches.get('sgd_mom_update', 0)}; the reloaded "
        f"checkpoint scores {acc:.4f} on val.rec as the trained module; "
        f"a step fed by the records {step_ms:.2f} ms (median of steps "
        f"2-{steps}: fetch, forward and backward, update, metric), "
        f"{summary['images_s']:.1f} images/s, profiled device "
        f"{fmt(summary['device_ms'], '.2f')} ms a step, idle "
        f"{fmt(summary['idle'], '.3f')}; 8i (a)'s synthetic-fed step in "
        f"this call {fmt(synth.get('step_ms'), '.2f')} ms, idle "
        f"{fmt(synth.get('idle'), '.3f')}")
    del mod, train, val
    torch.cuda.empty_cache()
    return summary, launches


def run_rec_augmenters(torch, paths):
    """8j (d): one batch through ``mx.image.ImageIter`` on the card and
    under ``with mx.cpu():`` from the same ``random.seed``: with the
    crops, flips and casts alone the same bits; with brightness and
    normalization added, within REC_AUG_REL_TOL."""
    import random
    import mxnet_tpu_torch as mx
    label = "8j (d) augmenters card vs CPU"
    mean = np.array([REC_MEAN[k] for k in ("mean_r", "mean_g", "mean_b")])
    std = np.array([REC_STD[k] for k in ("std_r", "std_g", "std_b")])
    card = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    res, times = {}, {}
    for floats in (False, True):
        kw = dict(mean=mean, std=std, brightness=0.1) if floats else {}
        for where in ("card", "cpu"):
            random.seed(REC_SEED)
            augs = mx.image.CreateAugmenter(
                REC_SHAPE, resize=REC_RESIZE, rand_crop=True,
                rand_mirror=True, **kw)
            with (mx.cpu() if where == "cpu" else card):
                it = mx.image.ImageIter(REC_BATCH, REC_SHAPE,
                                        path_imgrec=paths["train"],
                                        shuffle=True, aug_list=augs)
                t0 = time.monotonic()
                x = next(it).data[0]
                torch.cuda.synchronize()
                times[(floats, where)] = (time.monotonic() - t0) * 1e3
            check(x._data.device.type == ("cpu" if where == "cpu"
                                          else DEVICE),
                  f"{label}: the {where} batch is on {x._data.device}")
            res[(floats, where)] = x.asnumpy()
    check(np.array_equal(res[(False, "card")], res[(False, "cpu")]),
          f"{label}: crops, flips and casts differ card vs CPU")
    a, b = res[(True, "card")], res[(True, "cpu")]
    err = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    check(err <= REC_AUG_REL_TOL, f"{label}: the float passes differ "
          f"{err:.3g} > {REC_AUG_REL_TOL}")
    log(f"{label}: crops, flips and casts the same bits; brightness and "
        f"normalization {err:.3g} relative (tol {REC_AUG_REL_TOL}); a "
        f"batch of {REC_BATCH}: " + ", ".join(
            f"{'float passes' if f else 'crop/flip/cast'} on the {w} "
            f"{t:.1f} ms" for (f, w), t in times.items()))


def run_rec_ndarray_blocks(torch):
    """8j: a gluon net fed NDArrays on the card hands NDArrays on the
    card back, eagerly and hybridized, with the values a tensor caller
    gets; its loss's ``backward`` runs from the NDArray."""
    import mxnet_tpu_torch as mx
    from mxnet_tpu_torch import autograd as ag, gluon
    from mxnet_tpu_torch.gluon import nn
    label = "8j fault 21 NDArray callers"
    ctx = mx.gpu(0) if DEVICE == "cuda" else mx.cpu()
    net = nn.HybridSequential(prefix="rec_blocks_")
    with net.name_scope():
        net.add(nn.Dense(64, activation="relu"), nn.Dense(10))
    net.initialize(ctx=ctx)
    x = mx.nd.array(np.random.RandomState(3).randn(8, 32)
                    .astype(np.float32), ctx=ctx)
    y = mx.nd.array(np.arange(8) % 10, ctx=ctx)
    loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
    outs = []
    # calls outside record() under pause(): no autograd graph outlives
    # them into the hybridized block's captures
    for hybrid in (False, True, True):
        if hybrid:
            net.hybridize()
        with ag.pause():
            out = net(x)
            want = net(x._data)
        mode = "hybridized" if hybrid else "eager"
        check(isinstance(out, mx.nd.NDArray) and out.context == ctx,
              f"{label}: an {mode} call gave {type(out).__name__} on "
              f"{getattr(out, 'context', None)}")
        check(isinstance(want, torch.Tensor) and torch.equal(want,
                                                             out._data),
              f"{label}: an {mode} tensor call gives another type or "
              "other values")
        outs.append(out.asnumpy())
        del out, want
    for _ in range(2):
        with ag.record():
            loss = loss_fn(net(x), y)
        check(isinstance(loss, mx.nd.NDArray), f"{label}: the loss is "
              f"{type(loss).__name__}")
        loss.backward()
        del loss
    check(np.allclose(outs[0], outs[1], rtol=1e-5, atol=1e-6),
          f"{label}: eager and hybridized outputs differ")
    log(f"{label}: eager and hybridized calls on NDArrays return NDArrays "
        f"on {ctx}; a tensor call returns a tensor, the same values; the "
        "loss's backward ran from the NDArray, eagerly and from the "
        "hybridized block's graphs")


def run_records_phase(torch, rng, kernels):
    """8j: records and images: (a) write and read the records, (b) the
    ImageRecordIter alone, (c) train_imagenet.py's ResNet-50 on them,
    (d) the augmenters card vs CPU, and gluon blocks' NDArray callers.
    Returns the launch counts of (c)."""
    import tempfile
    with tempfile.TemporaryDirectory(prefix="chip_smoke_8j_") as root:
        paths, labels = run_rec_write_read(torch, rng, root)
        it_row = run_rec_iter(torch, paths, labels)
        step_row, counts = run_rec_train_imagenet(torch, kernels, paths,
                                                  root)
        run_rec_augmenters(torch, paths)
    run_rec_ndarray_blocks(torch)
    log("8j row: " + json.dumps(
        {k: (round(v, 4) if isinstance(v, float) else v)
         for k, v in {**it_row, **step_row}.items()}))
    return counts


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
    started = time.monotonic()

    def lap(phase):
        log(f"time: {phase} done at {time.monotonic() - started:.1f}s")
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
    lap("build")
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
    lap("3 kernels")
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
    lap("4 f32 serving")
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
    lap("5, 5b quantized and 16-bit serving")
    # 5c. speculative decoding (its own generator, as 5b)
    add(run_spec_phase(torch, np.random.RandomState(16), np_params, kernels,
                       f32_serving))
    lap("5c speculative")
    # 5d. multi-LoRA (its own generator, as 5b)
    add(run_lora_phase(torch, np.random.RandomState(18), np_params, kernels,
                       f32_serving))
    lap("5d multi-LoRA")
    # 5e. faults, the tracer and the flight recorder on the captured step
    # (its own generator, as 5b)
    add(run_chaos_phase(torch, np.random.RandomState(19), np_params,
                        kernels, f32_serving))
    lap("5e chaos")
    # 5f. the adapter registry: fault-ins beside the captured step (its
    # own generator, as 5b)
    add(run_registry_phase(torch, np.random.RandomState(20), np_params,
                           kernels, f32_serving))
    del f32_serving
    lap("5f registry")
    # 5g. the decoder artifact (its own generator, as 5b)
    add(run_artifact_phase(torch, np.random.RandomState(21), np_params,
                           kernels))
    torch.cuda.empty_cache()
    lap("5g artifact")
    # 5h. the fleet: chat and encode behind one router, hot swaps (its
    # own generator, as 5b)
    add(run_fleet_phase(torch, np.random.RandomState(23), np_params,
                        kernels))
    lap("5h fleet")
    # 6. paged decode through the model interface
    counts, decoded = run_paged_decode_phase(torch, rng, np_params, kernels)
    add(counts)
    # 6b. the reference's default config (head dim 16), dtype="float32"
    add(run_default_config_phase(torch, rng, kernels))
    del np_params
    lap("6, 6b paged decode")
    # 7. op front end and rtc
    counts, rtc_rows = run_op_phase(torch, timer, rng, decoded)
    add(counts)
    results += rtc_rows
    del decoded
    torch.cuda.empty_cache()
    lap("7 op front end")
    # 7b. the framework core: the op corpus, the update tail, the
    # imperative BERT-base step, the AMP reduction
    counts, tail_rows = run_op_corpus_phase(torch, timer, kernels)
    add(counts)
    results += tail_rows
    torch.cuda.empty_cache()
    lap("7b framework core")
    # 7c. the rest of the op registry: the tail corpus, SSD-300, the R-CNN
    # family, the PTB LSTM, K3 and the int8 ops at BERT-base widths,
    # control flow (its own generator, as 5b)
    counts, k3_rows = run_op_tail_phase(torch, timer,
                                        np.random.RandomState(24))
    add(counts)
    results += k3_rows
    del timer
    torch.cuda.empty_cache()
    lap("7c op registry tail")
    # 8. main path, training: f32, then under AMP (bf16, then f16)
    counts, f32_bert = run_bert_phase(torch, rng, kernels)
    add(counts)
    torch.cuda.empty_cache()
    add(run_bert_amp_phase(torch, rng, kernels, f32_bert))
    torch.cuda.empty_cache()
    lap("8 BERT f32 and AMP")
    # 8b. the Trainer through every update rule on BERT-base's gradients
    add(run_optimizer_path_phase(torch, np.random.RandomState(15), kernels))
    torch.cuda.empty_cache()
    lap("8b update rules")
    # 8c. the Trainer's full-state checkpoints (its own generator, as 5b)
    add(run_trainer_ckpt_phase(torch, np.random.RandomState(22), kernels))
    lap("8c checkpoints")
    # 8d. the vision path: the zoo, ResNet-50 training in f32 NCHW and in
    # bench.py's bf16 NHWC s2d configuration (its own generator, as 5b)
    counts, update_row = run_vision_phase(torch, np.random.RandomState(25),
                                          kernels)
    add(counts)
    results.append(update_row)
    torch.cuda.empty_cache()
    lap("8d vision path")
    # 8e. the compiled step: hybridize as CUDA graphs, compile_step on the
    # MLP cases, BERT-base, ResNet-50 and the LoRA fine-tune job (its own
    # generator, as 5b)
    add(run_compiled_phase(torch, np.random.RandomState(28), kernels))
    lap("8e compiled step")
    # 8f. the sparse tier and the optimizer tail: sparse-embedding
    # training at MovieLens-20M's widths, lazy against dense Adam,
    # sparse.dot, the eleven new optimizers on BERT-base's gradients, the
    # kvstore on the card (its own generator, as 5b)
    add(run_sparse_phase(torch, np.random.RandomState(29), kernels))
    lap("8f sparse tier and optimizer tail")
    # 8g. the rest of gluon: SSD-300 through the DataLoader with workers
    # and device prefetch, the word LSTM LM eager and hybridized, the data
    # tier, the losses and cells on the card (its own generator, as 5b)
    add(run_gluon_rest_phase(torch, np.random.RandomState(30), kernels))
    lap("8g rest of gluon")
    # 8h. the estimator and its telemetry: ResNet-50 and BERT-base through
    # Estimator.fit, mx.profiler and the rollup, SLOs and capacity over a
    # serving burst (its own generator, as 5b)
    add(run_estimator_phase(torch, np.random.RandomState(32), kernels,
                            card))
    lap("8h estimator and telemetry")
    # 8i. the symbolic API and the Module: train_imagenet.py's symbolic
    # ResNet-50 through Module.fit, a symbolic encoder layer on the flash
    # kernels (its own generator, as 5b)
    add(run_symbolic_phase(torch, np.random.RandomState(33), kernels))
    lap("8i symbolic API and Module")
    # 8j. records and images: the record readers, ImageRecordIter,
    # train_imagenet.py's ResNet-50 fed by the records, the augmenters
    # card vs CPU, gluon blocks' NDArray callers (its own generator, as 5b)
    add(run_records_phase(torch, np.random.RandomState(34), kernels))
    lap("8j records and images")
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
