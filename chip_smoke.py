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
   tolerance), with the kernel's, the plain version's and, for the
   quantized matmul, one library call's time (CUDA events, L2 flushed
   between launches), and the least time the card could take;
4. main path f32 — ``LLMServer`` on ``TinyDecoder`` at GPT-2-small widths
   (vocab 50257, d_model 768, 12 layers, 12 heads, d_ff 3072, context
   1024; seeded random weights) serves 8 requests (prompts of 15 to 700
   tokens, two sampled, one a prefix-cache hit with copy-on-write);
   greedy streams are held against ``greedy_decode_reference`` and one
   mixed packed ``decode_flat`` batch against the dense ``forward``;
5. main path quantized — the same server with int8 KV + int8 weights,
   then fp8 KV + fp8 weights, on a few requests; logits held against the
   port's plain path (the same step on the CPU);
   each main-path phase ends with a pass of the same traffic through the
   idle engine under ``torch.profiler``: device busy share and the
   kernels that took the most device time;
6. one JSON line listing every kernel: launches on the main path, max
   error, times, bound;
then the card line and, last, ``{"ok": true, "device": {...}}``.

Any failed check exits non-zero before the last line. The script needs
the checkout's ``mxnet_tpu_torch`` package beside it and a CUDA device;
without either it exits 2 and prints no result.
"""
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM published peaks (NVIDIA data sheet): HBM3 rate and f32 rate
# outside the tensor cores (both kernels accumulate f32 on CUDA cores)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

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
# quantized kernel path vs the same quantized step's plain version: the
# tolerance table of tests/test_kv_quant.py / tests/test_weight_quant.py
# (int8 0.05; fp8 KV 0.15 and fp8 weights 0.25, so 0.25 with both)
QUANT_LOGIT_TOL = {"int8": 0.05, "float8_e4m3fn": 0.25}

DEVICE = "cuda"
GPT2_SMALL = dict(vocab_size=50257, d_model=768, num_layers=12,
                  num_heads=12, d_ff=3072, max_context=1024)
MAX_SEQS, BLOCK_SIZE, NEW_TOKENS = 8, 16, 32


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


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops,
                                                        "operations")


# ------------------------------------------------------ kernel phase --
def attention_case(torch, T, page_dtype, rng):
    """Inputs of one flat-attention launch at the main path's shapes:
    8 sequences with fragmented block tables over a 513-block pool,
    T packed tokens (T/8 consecutive positions per sequence, one block
    boundary crossed or more), positions up to 1023."""
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
    if page_dtype == "float32":
        args["k_pages"] = torch.from_numpy(kf).to(dev)
        args["v_pages"] = torch.from_numpy(vf).to(dev)
        elem, scale_bytes = 4, 0
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
    from mxnet_tpu_torch.ops import ragged_attention as ra
    from mxnet_tpu_torch.ops import quantization as qz
    from mxnet_tpu_torch.serving.llm.quant import quantize_leaf
    results = []
    for page_dtype in ("float32", "int8", "float8_e4m3fn"):
        for T in (8, 128):
            args, nbytes, flops = attention_case(torch, T, page_dtype, rng)

            def kern():
                return ra.ragged_flat_attention(**args)

            def plain():
                return ra.ragged_flat_attention_reference(**args)
            out_k = kern()
            torch.cuda.synchronize()
            err = float((out_k - plain()).abs().max())
            b_ms, b_by = bound(nbytes, flops)
            name = ra.kernel_name(args["k_pages"].dtype)
            res = dict(name=name, route="cuda",
                       source="mxnet_tpu_torch/csrc/ragged_flat.cu",
                       replaces=("mxnet_tpu/ops/ragged_attention.py:158"
                                 if page_dtype == "float32" else
                                 "mxnet_tpu/ops/ragged_attention.py:244"),
                       shape=f"T={T},H=12,D=64,bs=16,MB=64",
                       max_abs_err=err, tol=ATT_TOL, ms=timer.ms(kern),
                       plain_ms=timer.ms(plain), bound_ms=b_ms,
                       bound_by=b_by, library_ms=None)
            log(f"kernel {name} {res['shape']}: max_abs_err={err:.3e} "
                f"(tol {ATT_TOL}) kernel_ms={res['ms']:.4f} "
                f"plain_ms={res['plain_ms']:.4f} bound_ms={b_ms:.4f} "
                f"({b_by})")
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
                b_ms, b_by = bound(4 * T * K + K * N + 4 * N + 4 * T * N,
                                   2 * T * K * N)
                name = qz.kernel_name(q.dtype)
                res = dict(name=name, route="cuda",
                           source="mxnet_tpu_torch/csrc/wq_matmul.cu",
                           replaces="mxnet_tpu/ops/quantization.py:297",
                           shape=f"T={T},K={K},N={N}", max_abs_err=err,
                           tol=tol, ms=timer.ms(kern),
                           plain_ms=timer.ms(plain), bound_ms=b_ms,
                           bound_by=b_by, library_ms=timer.ms(library))
                log(f"kernel {name} {res['shape']}: max_abs_err={err:.3e} "
                    f"(tol {tol:.3e}) kernel_ms={res['ms']:.4f} "
                    f"plain_ms={res['plain_ms']:.4f} "
                    f"library_ms={res['library_ms']:.4f} "
                    f"bound_ms={b_ms:.4f} ({b_by})")
                check(err <= tol, f"{name} {res['shape']} disagrees with "
                      f"its plain version: {err} > {tol}")
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


def step_logits(model, params, batch, kv_dtype, w_scales, num_blocks=64):
    from mxnet_tpu_torch.serving.llm.kv_cache import PagedKVCache
    c = model.config
    cache = PagedKVCache(c.num_layers, c.num_heads, c.head_dim,
                         BLOCK_SIZE, num_blocks, c.max_context,
                         dtype=kv_dtype, device=model.device)
    kw = {} if w_scales is None else {"w_scales": w_scales}
    if cache.quantized:
        kw.update(k_scales=cache.k_scales, v_scales=cache.v_scales)
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


def check_greedy(model, params, prompt, tokens, tol, label):
    """The served greedy stream must equal the plain oracle's, except
    that it may leave it at a step where the oracle's top-2 logit gap
    is below ``tol`` (a near tie that float reordering can flip)."""
    from mxnet_tpu_torch.serving.llm import greedy_decode_reference
    ref, logits = greedy_decode_reference(model, params, prompt,
                                          len(tokens), return_logits=True)
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


def profile_engine(torch, engine, prompts):
    """Drive ``engine`` (idle, warmed) through ``prompts`` on this thread
    under ``torch.profiler``; print the device busy share of the wall
    time and the kernels that took the most device time. Returns the
    busy share, or None when the profiler saw no device time."""
    from torch.profiler import ProfilerActivity, profile
    from mxnet_tpu_torch.serving.llm import Sequence
    seqs = [Sequence(p, NEW_TOKENS) for p in prompts]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
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
    rows = [e for e in prof.key_averages()
            if str(getattr(e, "device_type", "")).endswith("CUDA")
            and getattr(e, "self_device_time_total", 0) > 0]
    busy_us = sum(e.self_device_time_total for e in rows)
    if not rows:
        log("profile: the profiler saw no device time (not measured)")
        return None
    share = busy_us / (wall * 1e6)
    log(f"profile: {steps} steps in {wall:.3f}s under the profiler "
        f"({wall / steps * 1e3:.2f} ms/step); device busy "
        f"{busy_us / 1e3:.1f} ms = {share:.3f} of wall, idle "
        f"{1 - share:.3f}")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"profile:   {e.self_device_time_total / 1e3:9.2f} ms "
            f"{e.self_device_time_total / busy_us:6.3f} of device "
            f"x{e.count:<6d} {e.key[:90]}")
    return share


def run_f32_phase(torch, rng, np_params, kernels):
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    from mxnet_tpu_torch.serving.telemetry import compile_count
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    server = LLMServer(model, np_params, name="gpt2-f32",
                       max_seqs=MAX_SEQS, block_size=BLOCK_SIZE,
                       device=DEVICE)
    t0 = time.monotonic()
    server.warmup()
    torch.cuda.synchronize()
    log(f"f32: warmup {time.monotonic() - t0:.2f}s, kv pool "
        f"{server.engine.cache.nbytes() / 1e9:.3f} GB, weights "
        f"{server.engine.weight_bytes / 1e9:.3f} GB")
    builds = compile_count()
    prompts, shared = prompts_for(rng, model.vocab_size)
    server.start()
    kernels.reset_launch_counts()
    res, wall = serve(torch, server, prompts, sampled_idx=(1, 5),
                      late=(3, shared))
    launches = kernels.launch_counts()
    server.shutdown()
    st = server.stats()
    n_tok = sum(len(r.tokens) for r in res)
    log(f"f32: served {len(res)} requests, {n_tok} tokens in "
        f"{wall:.3f}s = {n_tok / wall:.1f} tokens/s (end to end); "
        f"decode EMA {st['tokens_per_sec']:.1f} tokens/s; TTFT p50 "
        f"{st['ttft_ms']['p50']:.2f} ms p99 {st['ttft_ms']['p99']:.2f} ms;"
        f" prefix hits {st['prefix_hits']}, COW copies "
        f"{st['kv_cache']['cow_copies']}, preemptions {st['preemptions']}")
    log(f"f32: launches {launches}, builds after warmup "
        f"{compile_count() - builds}")
    check(all(len(r.tokens) == NEW_TOKENS for r in res),
          "f32: a request stopped short")
    check(launches.get("flat_attention", 0) > 0,
          "f32: the flat attention kernel never ran on the main path")
    check(compile_count() == builds, "f32: a kernel was built after "
          "warmup")
    check(st["prefix_hits"] >= 1 and st["kv_cache"]["cow_copies"] >= 1,
          "f32: the prefix cache / copy-on-write path was not taken")
    params = server.engine.params
    greedy = [i for i in range(len(res)) if i not in (1, 5)]
    all_prompts = prompts + [shared]
    for i in greedy:
        verdict = check_greedy(model, params, all_prompts[i],
                               res[i].tokens, F32_LOGIT_TOL,
                               f"f32 request {i}")
        log(f"f32: request {i} (prompt {len(all_prompts[i])}) greedy vs "
            f"oracle: {verdict}")
    for i in (1, 5):
        toks = res[i].tokens
        check(all(0 <= t < model.vocab_size for t in toks),
              f"f32: sampled request {i} emitted an out-of-vocab token")
    batch, seqs = mixed_batch(model, rng, DEVICE)
    logits = step_logits(model, params, batch, "float32", None)
    off, err = 0, 0.0
    for s in seqs:
        dense, _, _ = model.forward(
            params, torch.tensor([s], device=DEVICE))
        err = max(err, float((logits[off:off + len(s)]
                              - dense[0]).abs().max()))
        off += len(s)
    check(bool(torch.isfinite(logits).all()), "f32: non-finite logits")
    log(f"f32: decode_flat vs dense forward on a mixed packed batch: "
        f"max_abs_err={err:.3e} (tol {F32_LOGIT_TOL})")
    check(err <= F32_LOGIT_TOL, "f32: decode_flat disagrees with forward")
    # where the time goes: the same traffic (fresh prompts, so no prefix
    # hits) through the idle engine on this thread, profiled
    profile_engine(torch, server.engine,
                   prompts_for(rng, model.vocab_size)[0])
    return launches, st, n_tok / wall


def run_quant_phase(torch, rng, np_params, kernels, dtype):
    from mxnet_tpu_torch.serving.llm import (LLMServer, TinyDecoder,
                                             quantize_weights)
    from mxnet_tpu_torch.serving.telemetry import compile_count
    tag = "int8" if dtype == "int8" else "fp8"
    qw = quantize_weights(np_params, dtype=dtype)
    model = TinyDecoder(device=DEVICE, **GPT2_SMALL)
    server = LLMServer(model, qw, name=f"gpt2-{tag}", max_seqs=MAX_SEQS,
                       block_size=BLOCK_SIZE, kv_dtype=dtype,
                       device=DEVICE)
    server.warmup()
    builds = compile_count()
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
        f"{st['ttft_ms']['p50']:.2f} ms; launches {launches}; builds "
        f"after warmup {compile_count() - builds}; weights "
        f"{st['weight_bytes'] / 1e9:.3f} GB")
    check(launches.get(f"flat_attention_quant.{tag}", 0) > 0
          and launches.get(f"wq_matmul.{tag}", 0) > 0,
          f"{tag}: a quantized kernel never ran on the main path")
    check(compile_count() == builds, f"{tag}: a kernel was built after "
          "warmup")
    # the same quantized step on the CPU (every kernel's plain version)
    cpu_model = TinyDecoder(device="cpu", **GPT2_SMALL)
    batch, _ = mixed_batch(model, rng, DEVICE)
    got = step_logits(model, server.engine.params, batch, dtype,
                      server.engine.w_scales)
    want = step_logits(cpu_model, qw.params,
                       {k: v.cpu() for k, v in batch.items()}, dtype,
                       qw.scales)
    n = int(batch["valid"].sum())
    err = float((got[:n].cpu() - want[:n]).abs().max())
    tol = QUANT_LOGIT_TOL[dtype]
    log(f"{tag}: decode_flat kernel path vs plain path (CPU) on a mixed "
        f"packed batch: max_abs_err={err:.3e} (tol {tol})")
    check(bool(torch.isfinite(got[:n]).all()), f"{tag}: non-finite logits")
    check(err <= tol, f"{tag}: kernel path disagrees with the plain path")
    profile_engine(torch, server.engine,
                   [rng.randint(0, model.vocab_size, size=n).tolist()
                    for n in (17, 64, 200)])
    return launches


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
        f"{time.monotonic() - t0:.2f}s")
    for name, text in sorted(kernels.build_logs.items()):
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"build: {name}: {line.strip()}")
    rng = np.random.RandomState(0)
    timer = Timer(torch)
    # 3. kernels
    results = run_kernel_phase(torch, timer, rng)
    # 4. main path, f32
    from mxnet_tpu_torch.serving.llm import TinyDecoder
    t0 = time.monotonic()
    np_params = TinyDecoder(device=DEVICE, **GPT2_SMALL).init_params_numpy(0)
    log(f"params: GPT-2-small widths, seed 0, "
        f"{time.monotonic() - t0:.2f}s")
    launches = dict(run_f32_phase(torch, rng, np_params, kernels)[0])
    # 5. main path, quantized
    for dtype in ("int8", "float8_e4m3fn"):
        launches.update(run_quant_phase(torch, rng, np_params, kernels,
                                        dtype))
    # 6. kernels line
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
