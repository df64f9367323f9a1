#!/usr/bin/env python3
"""Two trees' kernel timings on one card, in turns.

Run from the root of a checkout on a machine with an NVIDIA H100, with
the other tree unpacked under a git-ignored directory:

    git archive <rev> | tar -x -C _checkout/parent
    python3 chip_ab.py --tree parent=_checkout/parent --tree change=. \\
        --order ABBA --phases kernel,flash --profile
    python3 chip_ab.py --tree parent=_checkout/parent --tree change=. \\
        --order ABBA --phases flash --profile-bert
    python3 chip_ab.py --tree parent=_checkout/parent --tree change=. \\
        --order ABBA --phases kernel,paged --profile --profile-paged
    python3 chip_ab.py --tree parent=_checkout/parent --tree change=. \\
        --order ABBA --phases flash_lp,paged_lp
    python3 chip_ab.py --tree parent=_checkout/parent --tree change=. \\
        --order ABBA --phases flash_lp --profile-bert-amp
    python3 chip_ab.py --tree parent=_checkout/parent --tree change=. \\
        --order ABBA --phases optimizer --split-bert
    python3 chip_ab.py --tree parent=_checkout/parent --tree change=. \\
        --order ABBA --phases kernel --profile-spec

Each turn is its own process, started from that tree's root: it builds
the tree's kernels and runs the named kernel phases of the tree's
``chip_smoke.py`` (``kernel``: ``run_kernel_phase``, K1-K3; ``flash``:
``run_flash_kernel_phase``, K6/K7; ``paged``: ``run_paged_kernel_phase``,
K4/K5; ``flash_lp``: ``run_flash_lp_kernel_phase``, K6/K7 in bf16 and
f16; ``paged_lp``: ``run_paged_lp_kernel_phase``, K1/K4/K5 over bf16 and
f16 pages; ``optimizer``: ``run_optimizer_kernel_phase``, the
multi-tensor update kernel's rules at BERT-base's parameter shapes, in
a tree that has it), each phase from ``np.random.RandomState(0)`` (``paged_lp``
from seed 10, as ``chip_smoke.py`` runs it), so both trees time the same
inputs; a row only one tree has is printed with that tree's turns. ``--order`` lists the turns by tree letter (A the first
``--tree``). With ``--profile``, each tree then serves, in the turns of
``--order``, chip_smoke's f32 traffic (8 prompts of 15-700 tokens, two
sampled, 32 new tokens each) through ``LLMServer`` with f32, int8 and
fp8 KV and weights: end-to-end tokens/s and TTFT p50, then host ms per
step of the idle engine driven on the turn's thread without the
profiler, then a profiled pass of the same traffic, whose device busy
ms, idle share and the device time of the flat attention kernels (K1,
K2) and the quantized matmul (K3) are printed. With ``--profile-paged``,
each turn of ``--order`` also decodes chip_smoke's paged phase
(``paged_greedy``: chunked prefill at Q=16, then 32 ``decode_step``s at
Q=1; each step replayed from a CUDA graph where the tree's
``paged_greedy`` takes ``graphs``): host ms per ``decode_step`` step
without the profiler, then under the profiler, prefill alone and then
prefill and decode, and K4's device ms per ``decode_chunk`` step and per
``decode_step`` step are printed. With ``--profile-bert``, each tree then trains BERT-base
(``run_bert_phase``) in the turns of ``--order``, and its profiled pass
gives device ms per step, the flash kernels' device ms per step
(forward; dK/dV and dQ) and the device's idle share; with
``--profile-bert-amp`` the same for BERT-base under AMP
(``run_bert_amp_phase``: its bf16 steps' profiled pass), with the 16-bit
flash kernels' device ms per step (forward, dK/dV, dQ, in either tree's
design) and that of the delta pass (``rowsum(dout * out)`` in torch,
timed as the kernels launched inside a profiler range around it), then
the split below under AMP. With ``--split-bert`` each tree trains
BERT-base in f32 and then under AMP, in the turns of ``--order``, by
calls both trees have (``split_run`` in the child): two warm steps,
then five steps timing forward, backward and ``trainer.step`` on the
host, each closed by ``torch.cuda.synchronize()`` (medians printed),
then two steps whose ``trainer.step`` alone runs under the profiler: its
device ms, kernel launches and copies a step, and its top kernels. With
``--profile-spec`` each tree, in the turns of ``--order``, drives
chip_smoke's second f32 traffic (``prompts_for`` of seed 2, 32 new
tokens) through a warmed ``LLMEngine`` at GPT-2-small widths under the
profiler, without a draft (device ms per step and idle share; in a tree
whose model has ``DENSE_ROWS``, once more with the target's steps on the
draft's pack-independent route, ``decode_flat(dense_rows=DENSE_ROWS)``:
its cost on a plain step), then with chip_smoke's 6-layer draft at ``spec_k`` 2
(``profile_spec``: device ms per draft round and per verify). Prints the card
line, one line per (kernel, shape) with every turn's ms, the profile
lines and one JSON line of it all; ``--log FILE`` keeps the turns' full
output. Exits non-zero if a turn fails.
"""
import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import functools, inspect, json, os, sys, time
sys.path.insert(0, os.getcwd())
import numpy as np
import torch
import chip_smoke
from mxnet_tpu_torch import kernels
from mxnet_tpu_torch.serving.llm import Sequence
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
kernels.build_all()
# phase -> (chip_smoke function, its last argument: a generator, or the
# seed the function takes itself)
phases = {"kernel": ("run_kernel_phase", lambda: np.random.RandomState(0)),
          "flash": ("run_flash_kernel_phase",
                    lambda: np.random.RandomState(0)),
          "paged": ("run_paged_kernel_phase",
                    lambda: np.random.RandomState(0)),
          "flash_lp": ("run_flash_lp_kernel_phase",
                       lambda: np.random.RandomState(0)),
          "paged_lp": ("run_paged_lp_kernel_phase", lambda: 10)}
timer = chip_smoke.Timer(torch)
phases["optimizer"] = ("run_optimizer_kernel_phase", lambda: 14)
rows = []
for ph in sys.argv[1].split(","):
    if ph:
        fn, arg = phases[ph]
        if hasattr(chip_smoke, fn):         # a phase only one tree has
            rows += getattr(chip_smoke, fn)(torch, timer, arg())
print("AB_ROWS " + json.dumps(
    [{k: r.get(k) for k in ("name", "shape", "ms", "plain_ms",
                            "library_ms", "max_abs_err")} for r in rows]),
    flush=True)
# device time of each group of kernels (by name, in either tree's design;
# the paged kernels by template and query type, demangled or not: K1 is
# paged_attention_kernel with FlatQuery before the staged design and
# paged_ring_kernel with FlatTiles after it)
PAGED = ("paged_attention_kernel", "paged_ring_kernel")


def paged(types, queries):
    return lambda key: (any(k in key for k in PAGED)
                        and any(t in key for t in types)
                        and any(q in key for q in queries))


FLOAT = ("kernel<float", "kernelIf")
BYTES = ("kernel<signed char", "kernelIa", "__nv_fp8_e4m3")
GROUPS = {"quant": {"K1": paged(FLOAT, ("FlatQuery", "FlatTiles")),
                    "K2": paged(BYTES, ("FlatQuery", "FlatTiles")),
                    "K3": ("wq_mma_kernel", "wq_matmul_kernel",
                           "split_sum_kernel")},
          "paged": {"K4": paged(FLOAT, ("ChunkQuery", "ChunkTiles"))},
          "bert": {"flash_fwd": ("flash_fwd_kernel",),
                   "flash_bwd_dkv": ("flash_dkv_kernel",),
                   "flash_bwd_dq": ("flash_dq_kernel",)},
          "bert_amp": {"flash_fwd.lp": ("flash_fwd_sm90_kernel",),
                       "flash_bwd_dkv.lp": ("flash_dkv_lp_kernel",
                                            "flash_dkv_sm90_kernel"),
                       "flash_bwd_dq.lp": ("flash_dq_lp_kernel",
                                           "flash_dq_sm90_kernel")}}
# the profiler range around the backward's delta pass (bert_amp)
DELTA = "ab_flash_delta"
profile = sys.argv[2]


# BERT-base training (chip_smoke's BertForMLM, Adam, batch 8 x 512,
# dropout 0.1; under AMP with amp.init() and init_trainer), by calls both
# trees have: two warm steps, then the host ms of forward, backward and
# trainer.step over `steps` steps, each part closed by a synchronize,
# then `profiled` steps whose trainer.step alone runs under the profiler:
# its device ms, kernel launches and copies a step, and its top kernels
def split_run(label, use_amp, steps=5, profiled=2):
    from mxnet_tpu_torch import amp as tamp
    from mxnet_tpu_torch import autograd as ag
    from mxnet_tpu_torch import gluon
    from mxnet_tpu_torch.initializer import Xavier
    from torch.profiler import ProfilerActivity, profile as tprofile
    cfg = chip_smoke.BERT_BASE
    vocab, batch = cfg["vocab_size"], chip_smoke.BERT_BATCH
    data = chip_smoke.bert_batches(torch, np.random.RandomState(1),
                                   2 + steps + profiled, vocab, batch,
                                   chip_smoke.BERT_T, "cuda")
    if use_amp:
        data = [(x.int(), y, w, vl) for x, y, w, vl in data]
        tamp.init()
    try:
        net = chip_smoke.make_bert_mlm(0.1, **cfg)
        net.initialize(Xavier(), device="cuda",
                       generator=torch.Generator().manual_seed(0))
        trainer = gluon.Trainer(net.collect_params(), "adam",
                                {"learning_rate": chip_smoke.BERT_LR})
        if use_amp:
            trainer = tamp.init_trainer(trainer)
        loss_fn = gluon.loss.SoftmaxCrossEntropyLoss()
        parts = {"forward_ms": [], "backward_ms": [], "trainer_step_ms": []}
        dev_us, launches, copies, top = 0.0, 0, 0, {}
        torch.manual_seed(0)
        for i, d in enumerate(data):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with ag.record():
                loss = chip_smoke.mlm_loss(net, loss_fn, d, vocab)
                scaled = loss
                if use_amp:
                    with tamp.scale_loss(loss, trainer) as scaled:
                        pass
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            scaled.backward()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            if i < 2 + steps:
                trainer.step(batch)
                torch.cuda.synchronize()
            else:
                with tprofile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                    trainer.step(batch)
                    torch.cuda.synchronize()
                for e in prof.key_averages():
                    us = getattr(e, "self_device_time_total", 0)
                    if not (str(getattr(e, "device_type", "")).endswith(
                            "CUDA") and us > 0):
                        continue
                    dev_us += us
                    if "Memcpy" in e.key or "Memset" in e.key:
                        copies += e.count
                    else:
                        launches += e.count
                    top[e.key[:60]] = top.get(e.key[:60], 0.0) + us
            t3 = time.perf_counter()
            if 2 <= i < 2 + steps:
                for key, t in zip(parts, (t1 - t0, t2 - t1, t3 - t2)):
                    parts[key].append(t * 1e3)
        best = sorted(top.items(), key=lambda kv: -kv[1])[:3]
        print("AB_SPLIT " + json.dumps(dict(
            label=label, loss=float(loss.detach()),
            **{k: float(np.median(v)) for k, v in parts.items()},
            per_step={k: v for k, v in parts.items()},
            opt_device_ms=dev_us / 1e3 / profiled,
            opt_launches=launches / profiled, opt_copies=copies / profiled,
            opt_top=[(k, v / 1e3 / profiled) for k, v in best])),
            flush=True)
        del net, trainer, data
        torch.cuda.empty_cache()
    finally:
        if use_amp:
            tamp.uninit()
if profile in GROUPS:
    report = chip_smoke.report_profile

    def report_groups(prof, wall, steps):
        events = prof.key_averages()
        rows = [e for e in events
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and getattr(e, "self_device_time_total", 0) > 0
                and e.key != DELTA]
        busy = sum(e.self_device_time_total for e in rows)
        groups = {}
        for label, names in GROUPS[profile].items():
            match = names if callable(names) else (
                lambda key, names=names: any(n in key for n in names))
            ev = [e for e in rows if match(e.key)]
            groups[label] = dict(
                ms=sum(e.self_device_time_total for e in ev) / 1e3,
                launches=sum(e.count for e in ev))
        if profile == "bert_amp":
            # the device time of the kernels launched inside the range
            ev = [e for e in events if e.key == DELTA
                  and not str(getattr(e, "device_type", "")).endswith("CUDA")]
            groups["delta"] = dict(
                ms=sum(e.device_time_total for e in ev) / 1e3,
                launches=sum(e.count for e in ev))
        print("AB_PROFILE " + json.dumps(dict(
            steps=steps, wall_s=wall, busy_ms=busy / 1e3,
            idle=1 - busy / (wall * 1e6), groups=groups)), flush=True)
        return report(prof, wall, steps)
    chip_smoke.report_profile = report_groups
if profile == "quant":
    # the same traffic through LLMServer with f32, int8 and fp8 KV and
    # weights, by calls both trees have: served end to end (tokens/s,
    # TTFT), then through the idle engine on this thread without the
    # profiler (host ms per step; warmup() first, since a server may
    # release its graphs at shutdown), then under the profiler
    from mxnet_tpu_torch.serving.llm import LLMServer, TinyDecoder
    np_params = TinyDecoder(device="cuda", **chip_smoke.GPT2_SMALL
                            ).init_params_numpy(0)
    for dtype in ("float32", "int8", "float8_e4m3fn"):
        print(f"AB_DTYPE {dtype}", flush=True)
        rng = np.random.RandomState(1)
        model = TinyDecoder(device="cuda", **chip_smoke.GPT2_SMALL)
        quant = {} if dtype == "float32" else dict(kv_dtype=dtype,
                                                   weight_dtype=dtype)
        server = LLMServer(model, np_params, max_seqs=chip_smoke.MAX_SEQS,
                           block_size=chip_smoke.BLOCK_SIZE, device="cuda",
                           **quant)
        t0 = time.monotonic()
        server.warmup()
        torch.cuda.synchronize()
        warm_s = time.monotonic() - t0
        server.start()
        res, wall = chip_smoke.serve(
            torch, server, chip_smoke.prompts_for(rng, model.vocab_size)[0],
            sampled_idx=(1, 5))
        server.shutdown()
        st = server.stats()
        engine = server.engine
        engine.warmup()
        seqs = [Sequence(p, chip_smoke.NEW_TOKENS) for p in
                chip_smoke.prompts_for(rng, model.vocab_size)[0]]
        t0 = time.monotonic()
        for q in seqs:
            engine.add(q)
        steps = 0
        while engine.has_work():
            engine.step()
            steps += 1
        torch.cuda.synchronize()
        host_s = time.monotonic() - t0
        engine.pop_finished()
        n_tok = sum(len(r.tokens) for r in res)
        print("AB_SERVE " + json.dumps(dict(
            warmup_s=warm_s, tokens=n_tok, tokens_per_s=n_tok / wall,
            ttft_p50_ms=st["ttft_ms"]["p50"], steps=steps,
            host_ms_per_step=host_s / steps * 1e3)), flush=True)
        chip_smoke.profile_engine(
            torch, engine, chip_smoke.prompts_for(rng, model.vocab_size)[0])
        del server, engine, model
        torch.cuda.empty_cache()
elif profile == "paged":
    # chunked prefill alone, then prefill and decode: the difference is
    # the decode steps
    from torch.profiler import ProfilerActivity, profile as tprofile
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.serving.llm import TinyDecoder
    model = TinyDecoder(device="cuda", **chip_smoke.GPT2_SMALL)
    params = params_from_numpy(model.init_params_numpy(0), model.device)
    prompts, _ = chip_smoke.prompts_for(np.random.RandomState(1),
                                        model.vocab_size)
    # a tree whose paged_greedy replays each step from a CUDA graph
    # does so here (captured at each kind's first step, inside the
    # profiled window)
    graphs = {"graphs": True} if "graphs" in inspect.signature(
        chip_smoke.paged_greedy).parameters else {}
    chip_smoke.paged_greedy(torch, model, params, prompts, 2, **graphs)
    out = chip_smoke.paged_greedy(torch, model, params, prompts,
                                  chip_smoke.DECODE_STEPS, **graphs)
    step_s = out[3] if graphs else out[3] / chip_smoke.DECODE_STEPS
    print("AB_PAGED " + json.dumps(dict(graphs=bool(graphs),
                                        decode_ms_per_step=step_s * 1e3)),
          flush=True)
    for label, new in (("decode_chunk", 0),
                       ("decode_chunk+decode_step",
                        chip_smoke.DECODE_STEPS)):
        print(f"AB_DTYPE {label}", flush=True)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            t0 = time.monotonic()
            out = chip_smoke.paged_greedy(torch, model, params, prompts, new,
                                          **graphs)
            torch.cuda.synchronize()
            wall = time.monotonic() - t0
        chip_smoke.report_profile(prof, wall, out[2] + new)
elif profile == "bert":
    print("AB_DTYPE bert", flush=True)
    chip_smoke.run_bert_phase(torch, np.random.RandomState(1), kernels)
elif profile == "bert_amp":
    from mxnet_tpu_torch.ops import flash_attention as fa
    delta = fa._delta

    def ranged_delta(out, dout):
        with torch.profiler.record_function(DELTA):
            return delta(out, dout)
    fa._delta = ranged_delta
    print("AB_DTYPE bert_amp", flush=True)
    # no f32 phase in this process: its summary prints as not measured
    chip_smoke.run_bert_amp_phase(
        torch, np.random.RandomState(1), kernels,
        dict(step_ms=None, tokens_s=None, peak_gb=None, device_ms=None,
             idle=None))
    torch.cuda.empty_cache()
    split_run("amp", True)
elif profile == "split":
    split_run("f32", False)
    split_run("amp", True)
elif profile == "spec":
    from torch.profiler import ProfilerActivity, profile as tprofile
    from mxnet_tpu_torch.convert import params_from_numpy
    from mxnet_tpu_torch.serving.llm import LLMEngine, TinyDecoder
    from mxnet_tpu_torch.serving.llm import model as model_mod
    cs = chip_smoke
    model = TinyDecoder(device="cuda", **cs.GPT2_SMALL)
    params = params_from_numpy(model.init_params_numpy(0), "cuda")
    prompts = cs.prompts_for(np.random.RandomState(2), model.vocab_size)[0]
    variants = [("plain", None)]
    if hasattr(model_mod, "DENSE_ROWS"):
        variants.append(("plain_dense_rows", model_mod.DENSE_ROWS))
    for label, rows in variants:
        # the target step on the draft's pack-independent route: the
        # model's decode_flat with dense_rows given, for this engine
        if rows is not None:
            model.decode_flat = functools.partial(
                TinyDecoder.decode_flat, model, dense_rows=rows)
        try:
            eng = LLMEngine(model, params, max_seqs=cs.MAX_SEQS,
                            block_size=cs.BLOCK_SIZE, device="cuda")
            eng.warmup()
            cs.drive_engine(torch, eng, prompts[:2])
            with tprofile(activities=[ProfilerActivity.CPU,
                                      ProfilerActivity.CUDA]) as prof:
                steps, wall = cs.drive_engine(torch, eng, prompts)
        finally:
            model.__dict__.pop("decode_flat", None)
        _, busy = cs.device_rows(prof)
        print("AB_SPEC " + json.dumps(dict(
            label=label, steps=steps, device_ms=busy / 1e3 / steps,
            idle=1 - busy / (wall * 1e6))), flush=True)
        eng.release_graphs()
        del eng
        torch.cuda.empty_cache()
    draft = TinyDecoder(device="cuda", **dict(cs.GPT2_SMALL,
                                              num_layers=cs.DRAFT_LAYERS))
    dparams = dict(params, layers=params["layers"][:cs.DRAFT_LAYERS])
    eng = LLMEngine(model, params, max_seqs=cs.MAX_SEQS,
                    block_size=cs.BLOCK_SIZE, draft_model=draft,
                    draft_params=dparams, spec_k=cs.SPEC_K, device="cuda")
    eng.warmup()
    dev, steps = cs.profile_spec(torch, eng, prompts)
    print("AB_SPEC " + json.dumps(dict(
        label="spec", steps=steps,
        draft_ms=dev["draft"][0] / max(1, dev["draft"][1]),
        drafts=dev["draft"][1],
        verify_ms=dev["verify"][0] / max(1, dev["verify"][1]),
        verifies=dev["verify"][1])), flush=True)
"""


def turn(root, phases, profile, log):
    """One process in ``root``: the kernel ``phases``, then the profiled
    pass named by ``profile`` ("", "quant", "paged", "bert" or
    "bert_amp")."""
    proc = subprocess.run([sys.executable, "-c", CHILD, phases, profile],
                          cwd=root, capture_output=True, text=True)
    log.write(f"===== {root} phases={phases} profile={profile} "
              f"rc={proc.returncode}\n{proc.stdout}\n{proc.stderr}\n")
    log.flush()
    if proc.returncode != 0:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"chip_ab: the turn in {root} failed")
    rows, prof, dtype = [], [], None
    for line in proc.stdout.splitlines():
        if line.startswith("AB_ROWS "):
            rows = json.loads(line[8:])
        elif line.startswith("AB_DTYPE "):
            dtype = line[9:]
        elif line.startswith(("AB_PROFILE ", "AB_SERVE ", "AB_PAGED ",
                              "AB_SPLIT ", "AB_SPEC ")):
            kind, _, body = line.partition(" ")
            prof.append(dict(json.loads(body), dtype=dtype,
                             kind=kind[3:].lower()))
    return rows, prof


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="label=path, in letter order A, B, ...")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--phases", default="kernel,flash")
    ap.add_argument("--profile", action="store_true",
                    help="f32/int8/fp8 serving in the turns of --order: "
                         "tokens/s, TTFT, host ms per step, profiled "
                         "passes with K1/K2/K3's device ms")
    ap.add_argument("--profile-bert", action="store_true",
                    help="the flash kernels in BERT-base training's pass")
    ap.add_argument("--profile-bert-amp", action="store_true",
                    help="the 16-bit flash kernels and the delta pass in "
                         "BERT-base training under AMP, in the turns of "
                         "--order")
    ap.add_argument("--profile-paged", action="store_true",
                    help="K4's device ms per decode_chunk / decode_step "
                         "step of the paged decode pass, in the turns of "
                         "--order")
    ap.add_argument("--split-bert", action="store_true",
                    help="BERT-base training in f32 and under AMP in the "
                         "turns of --order: host ms of forward, backward "
                         "and trainer.step, and trainer.step's device ms "
                         "and launches")
    ap.add_argument("--profile-spec", action="store_true",
                    help="device ms per plain f32 step (and, where the "
                         "tree has it, at the fixed dense row count) and "
                         "per draft round and verify of speculative "
                         "decoding, in the turns of --order")
    ap.add_argument("--log", help="file for the turns' full output")
    args = ap.parse_args()
    trees = [t.split("=", 1) for t in args.tree]
    if args.log:
        os.makedirs(os.path.dirname(os.path.abspath(args.log)),
                    exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    table, profiles = {}, []
    with open(args.log or os.devnull, "w") as log:
        for letter in args.order:
            label, root = trees[ord(letter) - ord("A")]
            rows, _ = turn(os.path.abspath(root), args.phases, "", log)
            if args.profile_paged:
                _, prof = turn(os.path.abspath(root), "", "paged", log)
                profiles += [dict(p, tree=label) for p in prof]
            for r in rows:
                key = (r["name"], r["shape"])
                table.setdefault(key, []).append(
                    (label, r["ms"], r["max_abs_err"], r["library_ms"]))
        if args.profile:
            for letter in args.order:
                label, root = trees[ord(letter) - ord("A")]
                _, prof = turn(os.path.abspath(root), "", "quant", log)
                profiles += [dict(p, tree=label) for p in prof]
        for flag, kind in ((args.profile_bert, "bert"),
                           (args.profile_bert_amp, "bert_amp"),
                           (args.split_bert, "split"),
                           (args.profile_spec, "spec")):
            if not flag:
                continue
            for letter in args.order:
                label, root = trees[ord(letter) - ord("A")]
                _, prof = turn(os.path.abspath(root), "", kind, log)
                profiles += [dict(p, tree=label) for p in prof]
    for (name, shape), cells in table.items():
        turns = " ".join(f"{label}={ms:.4f}" for label, ms, _, _ in cells)
        errs = max(e for _, _, e, _ in cells)
        lib = cells[0][3]
        lib_s = "none" if lib is None else f"{lib:.4f}"
        print(f"ab {name} {shape}: {turns} (ms, in turn order); "
              f"library {lib_s}; max_abs_err {errs:.3e}", flush=True)
    for p in profiles:
        if p["kind"] == "serve":
            print(f"ab serve {p['tree']} {p['dtype']}: {p['tokens']} tokens "
                  f"at {p['tokens_per_s']:.1f} tokens/s end to end, TTFT "
                  f"p50 {p['ttft_p50_ms']:.2f} ms; idle engine "
                  f"{p['steps']} steps at {p['host_ms_per_step']:.3f} ms "
                  f"per step without the profiler; warmup "
                  f"{p['warmup_s']:.2f}s", flush=True)
            continue
        if p["kind"] == "split":
            top = "; ".join(f"{k} {ms:.3f} ms" for k, ms in p["opt_top"])
            print(f"ab split {p['tree']} {p['label']}: forward "
                  f"{p['forward_ms']:.2f} ms, backward "
                  f"{p['backward_ms']:.2f} ms, trainer.step "
                  f"{p['trainer_step_ms']:.2f} ms (host, medians); "
                  f"trainer.step on the device {p['opt_device_ms']:.3f} ms "
                  f"in {p['opt_launches']:.0f} kernel launches and "
                  f"{p['opt_copies']:.0f} copies a step; top: {top}",
                  flush=True)
            continue
        if p["kind"] == "spec":
            if p["label"] == "spec":
                print(f"ab spec {p['tree']}: {p['steps']} steps, "
                      f"{p['drafts']} draft rounds at {p['draft_ms']:.3f} "
                      f"device ms each, {p['verifies']} verifies at "
                      f"{p['verify_ms']:.3f} device ms each", flush=True)
            else:
                print(f"ab spec {p['tree']} {p['label']}: {p['steps']} "
                      f"steps at {p['device_ms']:.3f} device ms a step, "
                      f"idle {p['idle']:.3f}", flush=True)
            continue
        if p["kind"] == "paged":
            print(f"ab paged {p['tree']}: decode "
                  f"{p['decode_ms_per_step']:.3f} ms per decode_step step "
                  f"without the profiler ({'graphs' if p['graphs'] else 'eager'})",
                  flush=True)
            continue
        n = p["steps"]
        parts = ", ".join(
            f"{k} {g['ms']:.2f} ms in {g['launches']} launches "
            f"({g['ms'] / n:.3f} ms/step, {g['ms'] / p['busy_ms']:.3f} of "
            f"device time)" for k, g in p["groups"].items())
        print(f"ab profile {p['tree']} {p['dtype']}: {n} steps, device busy "
              f"{p['busy_ms']:.2f} ms ({p['busy_ms'] / n:.2f} ms/step), idle "
              f"{p['idle']:.3f}; {parts}", flush=True)
    for label, _ in trees:
        runs = [p for p in profiles if p["tree"] == label
                and p["kind"] == "profile"
                and p["dtype"].startswith("decode_chunk")]
        for a, b in zip(runs[0::2], runs[1::2]):
            chunk = a["groups"]["K4"]
            both = b["groups"]["K4"]
            n_chunk = a["steps"]
            n_dec = b["steps"] - a["steps"]
            print(f"ab paged {label}: K4 {chunk['ms'] / n_chunk:.4f} ms "
                  f"per decode_chunk step (Q=16, "
                  f"{n_chunk} steps), "
                  f"{(both['ms'] - chunk['ms']) / max(1, n_dec):.4f} ms "
                  f"per decode_step step (Q=1, {n_dec} steps)", flush=True)
    print(json.dumps({"ab": [dict(name=n, shape=s, turns=[
        dict(tree=label, ms=ms) for label, ms, _, _ in c])
        for (n, s), c in table.items()], "profiles": profiles}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
