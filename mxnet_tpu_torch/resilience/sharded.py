"""Sharded checkpoint layout: parallel per-shard files + one manifest
(the port of ``mxnet_tpu/resilience/sharded.py``; the same
``mxtpu-ckpt-v2`` layout, so either package reads the other's).

A single-file checkpoint serializes the whole training state through
one writer — a per-step stall at large parameter counts and a dead end
past single-host model sizes (every byte must funnel through host 0).
The sharded layout (``mxtpu-ckpt-v2``) splits the flat array tree into
``N`` shard files written in parallel::

    ckpt-0000000042/
      shard-00000-of-00004.params   # rows 0..k of the big arrays
      shard-00001-of-00004.params   # + whole small arrays, bin-packed
      ...
      trainer.pkl                   # opaque sidecar blobs (unchanged)
      MANIFEST.json                 # commit record, written LAST

Layout rules (deterministic — the reader re-derives nothing):

- arrays whose leading axis has at least ``num_shards`` rows are split
  into contiguous row ranges, ``start = rows*k//N``;
- everything else (scalars, small vectors) is assigned whole to the
  currently least-loaded shard (greedy by bytes, sorted names, ties to
  the lowest shard id), so shard files stay byte-balanced.

The manifest records the **global tree structure** — every array's
global shape/dtype plus the exact (file, row-range) parts that hold it.
That makes restore *elastic*: a reader at any target world size ``M``
(``M != N`` included) plans its own layout over the global shapes and
assembles each new shard from whichever old shard files contain its
rows (:func:`read_for_shard`), or assembles the full tree
(:func:`read_sharded_arrays`). Validity is unchanged from v1: a
checkpoint exists iff its manifest committed and every listed file
passes its size/CRC check — a crash after K of N shard writes leaves an
invisible partial directory, never a torn checkpoint.

Arrays are tensors on any device or host numpy on the way in; every
array is copied to the host on the calling thread before the shard
writer threads start, so those threads do no CUDA work. Reads return
CPU tensors (numpy cannot name bfloat16 without ``ml_dtypes``).
"""
from __future__ import annotations

import os
import re
import threading

import numpy as _np
import torch

from . import faults
from ..base import dtype_name, itemsize, torch_dtype

__all__ = ["shard_filename", "parse_shard_filename", "plan_layout",
           "partition_arrays", "write_shard_files", "global_array_meta",
           "read_sharded_arrays", "read_for_shard", "check_layout",
           "reshard_check", "writer_threads"]

_SHARD_RE = re.compile(r"^shard-(\d{5})-of-(\d{5})\.params$")


def shard_filename(shard_id: int, num_shards: int) -> str:
    return f"shard-{shard_id:05d}-of-{num_shards:05d}.params"


def parse_shard_filename(name):
    """``(shard_id, num_shards)`` or ``None`` for non-shard files."""
    m = _SHARD_RE.match(os.path.basename(str(name)))
    return (int(m.group(1)), int(m.group(2))) if m else None


def writer_threads(num_shards: int) -> int:
    """Parallel shard-writer thread count (``MXNET_TPU_CKPT_WRITERS``;
    1 = sequential in shard order, the deterministic mode fault tests
    use)."""
    try:
        n = int(os.environ.get("MXNET_TPU_CKPT_WRITERS", "8") or 8)
    except ValueError:
        n = 8
    return max(1, min(n, num_shards))


# ---------------------------------------------------------------- plan ----

def plan_layout(meta, num_shards):
    """Partition plan for one array tree.

    meta : dict name -> (shape tuple, dtype str)
    Returns dict name -> ``{"parts": [{"shard", "start", "stop"}, ...]}``
    for row-split arrays or ``{"shard": k}`` for whole assignment. Pure
    function of (meta, num_shards) — writer and resharding readers must
    agree without communicating.
    """
    layout = {}
    load = [0] * num_shards
    whole = []
    for name in sorted(meta):
        shape, dtype = meta[name]
        shape = tuple(int(s) for s in shape)
        rows = shape[0] if shape else 0
        size = itemsize(dtype)
        nbytes = int(_np.prod(shape, dtype=_np.int64)) * size \
            if shape else size
        if num_shards > 1 and rows >= num_shards:
            parts = []
            row_bytes = nbytes // rows
            for k in range(num_shards):
                start = rows * k // num_shards
                stop = rows * (k + 1) // num_shards
                parts.append({"shard": k, "start": start, "stop": stop})
                load[k] += row_bytes * (stop - start)
            layout[name] = {"parts": parts}
        else:
            whole.append((name, nbytes))
    for name, nbytes in whole:
        k = min(range(num_shards), key=lambda i: (load[i], i))
        load[k] += nbytes
        layout[name] = {"shard": k}
    return layout


def _to_host(a):
    """A CPU tensor (a device tensor is copied, blocking) or a host numpy
    array."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu()
    return _np.asarray(a)


def global_array_meta(arrays):
    """``{name: (shape, dtype)}`` over tensors or host numpy."""
    meta = {}
    for name, a in arrays.items():
        if not isinstance(a, torch.Tensor):
            a = _np.asarray(a)
        meta[name] = (tuple(a.shape), dtype_name(a.dtype))
    return meta


def partition_arrays(arrays, layout, num_shards):
    """Split an array tree into per-shard payload dicts of host arrays
    (row views: no copy beyond the one device-to-host fetch an array)."""
    per_shard = [dict() for _ in range(num_shards)]
    for name, rec in layout.items():
        host = _to_host(arrays[name])
        if "parts" in rec:
            for p in rec["parts"]:
                per_shard[p["shard"]][name] = host[p["start"]:p["stop"]]
        else:
            per_shard[rec["shard"]][name] = host
    return per_shard


# --------------------------------------------------------------- write ----

def write_shard_files(ckpt_dir, per_shard, num_shards):
    """Write every shard file (atomic + CRC'd via ``nd.save``) from host
    arrays (:func:`partition_arrays`), in parallel up to
    :func:`writer_threads` workers; returns the manifest
    ``files`` entries ``{fname: {"crc32", "nbytes"}}``.

    An :class:`~.faults.InjectedCrash` in any shard aborts the whole
    save (first failure wins, as a real SIGKILL would take down every
    writer thread of the process); completed shard files stay on disk
    but the directory never commits without the manifest.
    """
    from ..ndarray import save as nd_save

    files = {}
    files_lock = threading.Lock()

    def write_one(k):
        faults.point(f"ckpt.shard:{k}")
        fname = shard_filename(k, num_shards)
        meta = nd_save(os.path.join(ckpt_dir, fname), per_shard[k])
        with files_lock:
            files[fname] = {"crc32": meta["crc32"],
                            "nbytes": meta["nbytes"]}

    workers = writer_threads(num_shards)
    if workers == 1:
        for k in range(num_shards):
            write_one(k)
        return files

    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(max_workers=workers,
                            thread_name_prefix="mxtpu-ckpt-shard") as ex:
        futs = [ex.submit(write_one, k) for k in range(num_shards)]
        first_exc = None
        for f in futs:
            try:
                f.result()
            except BaseException as exc:   # InjectedCrash included
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc
    return files


# ---------------------------------------------------------------- read ----

class _ShardCache:
    """Loads each shard file at most once per read pass."""

    def __init__(self, ckpt_dir, num_shards):
        self._dir = ckpt_dir
        self._n = num_shards
        self._loaded = {}

    def get(self, k):
        if k not in self._loaded:
            from ..ndarray import load_tensors as nd_load
            self._loaded[k] = nd_load(
                os.path.join(self._dir, shard_filename(k, self._n)))
        return self._loaded[k]


def _corrupt(msg):
    from ..error import CheckpointCorruptError
    return CheckpointCorruptError(msg)


def _layout_of(manifest):
    layout = manifest.get("layout")
    if not layout or "arrays" not in layout:
        raise _corrupt("sharded manifest carries no layout section")
    return layout


def _assemble(name, rec, meta, cache, lo=None, hi=None):
    """One array (or its ``[lo:hi)`` row window) from the shard files."""
    if "parts" not in rec:
        arr = cache.get(rec["shard"]).get(name)
        if arr is None:
            raise _corrupt(f"shard {rec['shard']} is missing array "
                           f"{name!r}")
        if lo is None:
            return arr
        return arr[lo:hi]
    pieces = []
    for p in sorted(rec["parts"], key=lambda p: int(p["start"])):
        start, stop = int(p["start"]), int(p["stop"])
        if lo is not None and (stop <= lo or start >= hi):
            continue
        arr = cache.get(p["shard"]).get(name)
        if arr is None:
            raise _corrupt(f"shard {p['shard']} is missing its part of "
                           f"array {name!r}")
        host = arr
        if lo is not None:
            host = host[max(lo - start, 0):
                        max(min(hi, stop) - start, 0)]
        pieces.append(host)
    if not pieces:
        return torch.zeros((0,), dtype=torch_dtype(
            meta.get("dtype", "float32")))
    out = pieces[0] if len(pieces) == 1 else torch.cat(pieces, 0)
    want_rows = (hi - lo) if lo is not None \
        else int(meta["shape"][0])
    if out.shape[0] != want_rows:
        raise _corrupt(
            f"array {name!r}: assembled {out.shape[0]} rows, layout "
            f"promises {want_rows} — shard files disagree with manifest")
    return out


def read_sharded_arrays(ckpt_dir, manifest, verify=False):
    """Assemble the FULL global array tree from a sharded checkpoint.
    Every referenced shard file already passed its whole-file CRC in
    ``validate_checkpoint``; assembly re-checks only structural
    consistency (row counts). ``verify=True`` additionally re-checks
    every assembled array's global shape/dtype against the manifest
    (the ``verify_arrays=True`` contract of ``checkpoint.read_arrays``).
    Returns dict name -> CPU tensor."""
    layout = _layout_of(manifest)
    cache = _ShardCache(ckpt_dir, int(layout["num_shards"]))
    arrays_meta = manifest.get("arrays", {})
    out = {}
    for name, rec in layout["arrays"].items():
        meta = arrays_meta.get(name, {})
        a = _assemble(name, rec, meta, cache)
        if verify and meta:
            want_shape = tuple(int(s) for s in meta.get("shape", ()))
            want_dtype = dtype_name(meta.get("dtype", "float32"))
            got_dtype = dtype_name(a.dtype)
            if tuple(a.shape) != want_shape or got_dtype != want_dtype:
                raise _corrupt(
                    f"array {name!r}: shard files hold "
                    f"{tuple(a.shape)}/{got_dtype}, manifest promises "
                    f"{want_shape}/{want_dtype}")
        out[name] = a
    return out


def read_for_shard(ckpt_dir, manifest, shard_id, num_shards):
    """The *resharding reader*: the slice of every array that shard
    ``shard_id`` of a NEW ``num_shards``-way layout owns, assembled
    from whichever OLD shard files contain those rows. Only overlapping
    source files are opened — restore I/O stays ~1/M of the checkpoint
    at any target world size M. Returns dict name -> CPU tensor."""
    layout = _layout_of(manifest)
    arrays_meta = manifest.get("arrays", {})
    meta = {name: (tuple(arrays_meta[name]["shape"]),
                   arrays_meta[name]["dtype"])
            for name in layout["arrays"]}
    new_plan = plan_layout(meta, int(num_shards))
    cache = _ShardCache(ckpt_dir, int(layout["num_shards"]))
    out = {}
    for name, new_rec in new_plan.items():
        old_rec = layout["arrays"][name]
        if "parts" in new_rec:
            mine = [p for p in new_rec["parts"]
                    if p["shard"] == int(shard_id)]
            if not mine:
                continue
            lo, hi = int(mine[0]["start"]), int(mine[0]["stop"])
            out[name] = _assemble(
                name, old_rec, arrays_meta.get(name, {}), cache, lo, hi)
        elif new_rec["shard"] == int(shard_id):
            out[name] = _assemble(name, old_rec, arrays_meta.get(name, {}),
                                  cache)
    return out


# ------------------------------------------------------------ validate ----

def check_layout(ckpt_dir, manifest):
    """Structural layout check beyond per-file CRCs. Returns a list of
    problem strings (empty = consistent): row-coverage gaps/overlaps,
    parts referencing shards outside the manifest's file list, and
    orphan ``shard-*`` files on disk the manifest never committed
    (strays of a crashed save at a different shard count)."""
    problems = []
    layout = manifest.get("layout") or {}
    num = int(layout.get("num_shards", 0) or 0)
    files = manifest.get("files", {})
    arrays_meta = manifest.get("arrays", {})
    for name, rec in layout.get("arrays", {}).items():
        shape = tuple(arrays_meta.get(name, {}).get("shape", ()))
        if "parts" in rec:
            parts = sorted(rec["parts"], key=lambda p: int(p["start"]))
            prev = 0
            for p in parts:
                k = int(p["shard"])
                if not 0 <= k < num:
                    problems.append(f"{name}: part references shard {k} "
                                    f"of {num}")
                elif shard_filename(k, num) not in files:
                    problems.append(
                        f"{name}: part lives in uncommitted file "
                        f"{shard_filename(k, num)}")
                if int(p["start"]) != prev:
                    problems.append(
                        f"{name}: rows [{prev}, {p['start']}) uncovered")
                prev = int(p["stop"])
            if shape and prev != int(shape[0]):
                problems.append(f"{name}: rows [{prev}, {shape[0]}) "
                                "uncovered")
        else:
            k = int(rec["shard"])
            if not 0 <= k < num or shard_filename(k, num) not in files:
                problems.append(f"{name}: assigned to missing shard {k}")
    try:
        on_disk = os.listdir(ckpt_dir)
    except OSError:
        on_disk = []
    for fname in sorted(on_disk):
        if parse_shard_filename(fname) and fname not in files:
            problems.append(f"orphan shard file not in manifest: {fname}")
    return problems


def reshard_check(ckpt_dir, manifest, num_shards):
    """Dry-run: is this checkpoint assemblable at target world size
    ``num_shards``? Validates layout consistency, plans the new layout
    over the manifest's global shapes, and confirms every source part
    each new shard needs exists on disk — WITHOUT reading any payload.
    Returns ``{"num_shards": M, "reads": {new_shard: [src files]}}``;
    raises :class:`~mxnet_tpu.error.CheckpointCorruptError` if not."""
    problems = [p for p in check_layout(ckpt_dir, manifest)
                if not p.startswith("orphan ")]
    if problems:
        raise _corrupt("layout inconsistent: " + "; ".join(problems))
    layout = _layout_of(manifest)
    old_n = int(layout["num_shards"])
    arrays_meta = manifest.get("arrays", {})
    meta = {name: (tuple(arrays_meta[name]["shape"]),
                   arrays_meta[name]["dtype"])
            for name in layout["arrays"]}
    new_plan = plan_layout(meta, int(num_shards))
    reads = {k: set() for k in range(int(num_shards))}
    for name, new_rec in new_plan.items():
        old_rec = layout["arrays"][name]
        old_parts = old_rec.get("parts") or [
            {"shard": old_rec["shard"], "start": 0,
             "stop": (meta[name][0][0] if meta[name][0] else 0)}]
        new_parts = new_rec.get("parts") or [
            {"shard": new_rec["shard"], "start": 0,
             "stop": (meta[name][0][0] if meta[name][0] else 0)}]
        for npart in new_parts:
            for opart in old_parts:
                whole = "parts" not in old_rec
                overlap = whole or (int(opart["stop"]) > int(npart["start"])
                                    and int(opart["start"]) < int(npart["stop"]))
                if overlap:
                    reads[int(npart["shard"])].add(
                        shard_filename(int(opart["shard"]), old_n))
    for srcs in reads.values():
        for fname in srcs:
            if not os.path.isfile(os.path.join(ckpt_dir, fname)):
                raise _corrupt(f"reshard to {num_shards} needs missing "
                               f"source file {fname}")
    return {"num_shards": int(num_shards),
            "reads": {k: sorted(v) for k, v in reads.items()}}
