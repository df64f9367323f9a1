"""Gluon utilities of the port (mirrors ``mxnet_tpu/gluon/utils.py``):
``split_data`` / ``split_and_load`` (a batch sliced over contexts),
``clip_global_norm``, ``check_sha1`` and ``download``."""
from __future__ import annotations

import hashlib
import os
import warnings

import numpy as np
import torch

from ..ndarray.ndarray import NDArray

__all__ = ["split_data", "split_and_load", "clip_global_norm", "check_sha1",
           "download"]


def split_data(data, num_slice, batch_axis=0, even_split=True):
    """``data`` (an NDArray or tensor) in ``num_slice`` slices along
    ``batch_axis``; the last takes the remainder unless ``even_split``
    requires none."""
    size = data.shape[batch_axis]
    if even_split and size % num_slice != 0:
        raise ValueError(
            f"data with shape {tuple(data.shape)} cannot be evenly split "
            f"into {num_slice} slices along axis {batch_axis}. Use a batch "
            f"size that's multiple of {num_slice} or set even_split=False "
            "to allow uneven partitioning of data.")
    step = size // num_slice
    if not even_split and size < num_slice:
        step = 1
        num_slice = size
    slices = []
    for i in range(num_slice):
        begin = i * step
        end = (i + 1) * step if i < num_slice - 1 else size
        slices.append(data.slice_axis(batch_axis, begin, end)
                      if isinstance(data, NDArray)
                      else data.narrow(batch_axis, begin, end - begin))
    return slices


def split_and_load(data, ctx_list, batch_axis=0, even_split=True):
    """``data`` split along ``batch_axis`` and each slice placed on its
    context of ``ctx_list`` (Contexts, strings or ``torch.device``s), as
    NDArrays."""
    if not isinstance(data, NDArray):
        data = NDArray(data, ctx=ctx_list[0])
    if len(ctx_list) == 1:
        return [data.as_in_context(ctx_list[0])]
    slices = split_data(data, len(ctx_list), batch_axis, even_split)
    return [s.as_in_context(ctx) for s, ctx in zip(slices, ctx_list)]


def clip_global_norm(arrays, max_norm, check_isfinite=True):
    """Scale ``arrays`` (NDArrays or tensors, e.g. the parameters'
    gradients) in place so that the 2-norm of them all together is at
    most ``max_norm``. Returns the norm before clipping: a Python float
    read on the host when ``check_isfinite`` (with a warning if it is not
    finite), else a 0-d tensor on the first array's device, read
    nowhere."""
    if not arrays:
        raise ValueError("clip_global_norm takes at least one array")
    tensors = [a._data if isinstance(a, NDArray) else a for a in arrays]
    dev = tensors[0].device
    with torch.no_grad():
        total = None
        for t in tensors:
            t = t.to(dev)
            n = (t * t).sum()
            total = n if total is None else total + n
        total_norm = total.sqrt()
        if check_isfinite:
            tn = float(total_norm.item())
            if not np.isfinite(tn):
                warnings.warn("nan or inf is detected. Clipping results "
                              "will be undefined.", stacklevel=2)
        scale = max_norm / (total_norm + 1e-8)
        # the reference's arithmetic: a NaN norm scales by NaN
        scale = (scale < 1.0) * scale + (scale >= 1.0)
        for t in tensors:
            t.mul_(scale.to(t.device))
    if check_isfinite:
        return tn
    return total_norm


def check_sha1(filename, sha1_hash):
    """Whether the file's SHA-1 is ``sha1_hash``."""
    sha1 = hashlib.sha1()
    with open(filename, "rb") as f:
        while True:
            data = f.read(1048576)
            if not data:
                break
            sha1.update(data)
    return sha1.hexdigest() == sha1_hash


def download(url, path=None, overwrite=False, sha1_hash=None,
             retries=5, verify_ssl=True):
    """The reference's signature. The port fetches nothing: it returns
    the local file's name when the file is present (and matches
    ``sha1_hash``), and raises otherwise."""
    if path is None:
        fname = url.split("/")[-1]
    elif os.path.isdir(path):
        fname = os.path.join(path, url.split("/")[-1])
    else:
        fname = path
    if os.path.exists(fname) and not overwrite and (
            sha1_hash is None or check_sha1(fname, sha1_hash)):
        return fname
    raise RuntimeError(
        f"download of {url} is not available: place the file at {fname}")
