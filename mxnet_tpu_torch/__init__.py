"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package stays the reference; this package ports it slice by
slice to PyTorch with hand-written CUDA kernels for an NVIDIA H100
(``sm_90a``). Ported so far:

- paged LLM serving (:mod:`mxnet_tpu_torch.serving.llm` — ``LLMServer``
  down to the flat ragged step) with the flat ragged paged-attention
  kernels (f32 and int8/fp8 pages) and the weight-only quantized matmul
  kernel;
- BERT masked-LM training through gluon (:mod:`mxnet_tpu_torch.gluon`,
  :mod:`~mxnet_tpu_torch.autograd`, :mod:`~mxnet_tpu_torch.optimizer`)
  with the flash attention forward and backward kernels;
- paged chunk and decode attention: ``TinyDecoder.decode_chunk`` /
  ``decode_step`` and the op ``nd.ragged_paged_attention`` with the chunk
  and decode paged-attention kernels; the op front end
  (:mod:`~mxnet_tpu_torch.ops.registry`, ``nd``, exported here as
  :mod:`~mxnet_tpu_torch.ndarray` and ``nd``) and :mod:`~mxnet_tpu_torch.rtc`,
  which registers a user's CUDA kernel as an op;
- mixed-precision training (:mod:`~mxnet_tpu_torch.amp`: the op
  chokepoint's casts by the reference's lists, ``LossScaler``,
  ``init_trainer``) with the flash attention kernels in bf16 and f16;
- the optimizer package (:mod:`~mxnet_tpu_torch.optimizer`: nine
  optimizers, ``Updater``, ``FusedUpdater``; the update ops of
  :mod:`~mxnet_tpu_torch.ops.optimizer_ops`; the lr schedulers of
  :mod:`~mxnet_tpu_torch.lr_scheduler`), whose fused Trainer update is
  one launch of the multi-tensor update kernel per (op, dtype) group.
- the rest of serving (:mod:`mxnet_tpu_torch.serving`): ``ModelServer``
  with ``MicroBatchQueue`` and shape bucketing (one CUDA graph per
  bucket, over the server's own copy of a gluon block's parameters;
  ``Block.serve``), and the fleet (:mod:`~mxnet_tpu_torch.serving.fleet`:
  ``FleetRouter``'s hot swap of ``LLMServer`` and ``ModelServer``
  entries, quotas and lanes, ``FineTunePublisher``); with speculative
  decoding, multi-LoRA serving (``AdapterBank``, ``AdapterRegistry``),
  the fault switchboard, tracer, flight recorder and metrics registry
  (:mod:`~mxnet_tpu_torch.resilience`,
  :mod:`~mxnet_tpu_torch.observability`) and the on-disk tier
  (``nd.save``/``load``, checkpoints, decoder artifacts);
- the framework core, part 1: the :class:`~mxnet_tpu_torch.nd.NDArray`
  class, ``autograd`` (``backward``, ``grad``, ``mark_variables``),
  ``mx.random`` (:mod:`~mxnet_tpu_torch._rng`'s ``(seed, position)``
  draws) and the elementwise, reduction, shape, linalg, random and nn
  op families, with the multi-tensor update tail on the update kernel;
- the compiled step (:mod:`~mxnet_tpu_torch.jit`): ``hybridize()`` as a
  ``CachedOp`` of CUDA graphs and ``Trainer.compile_step`` as one graph
  replay a training step;
- the sparse tier and the optimizer tail: ``nd.sparse`` (row-sparse and
  CSR arrays, ``sparse.dot``), row-sparse Embedding gradients and the
  lazy SGD/Adam updates, the reference's 20 optimizers with the LAMB
  ops, the initializer tail and the single-process ``mx.kv`` store
  (2-bit gradient compression, ``row_sparse_pull``), which
  ``gluon.Trainer(kvstore=...)`` takes as the reference's does;
- ``mx.cpu()`` / ``mx.gpu()`` as the reference's
  :class:`~mxnet_tpu_torch.context.Context`, and the rest of gluon: the
  fifteen losses, ``gluon.rnn``, ``gluon.contrib`` (nn, rnn),
  ``gluon.data`` (the ``DataLoader`` with worker processes, pinned
  batches and device prefetch), ``gluon.utils`` and SSD-300.
- the estimator and its telemetry (``gluon.contrib.estimator``,
  ``metric``, ``callback``, ``monitor``, ``profiler``);
- the symbolic API and the Module: ``mx.sym`` over the op registry,
  ``Symbol.bind``/``simple_bind`` and the ``Executor``, ``mx.mod``,
  ``mx.io``, ``mx.model``, ``mx.viz``, the legacy ``mx.rnn`` and
  ``mx.test_utils``.

See ROADMAP.md for what remains.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), where every kernel's plain PyTorch
version runs instead. This package never imports ``jax`` or
``mxnet_tpu``; kernels are built from ``csrc/`` at first use
(:mod:`mxnet_tpu_torch.kernels`).
"""
__version__ = "0.1.0"

from . import amp, autograd, ndarray, rtc  # noqa: E402
from . import ndarray as nd  # noqa: E402
from .base import MXNetError  # noqa: E402
from .context import (Context, cpu, gpu, tpu, cpu_pinned,  # noqa: E402
                      current_context, num_gpus, num_tpus)
from .ndarray import NDArray  # noqa: E402
from .ndarray import random  # noqa: E402  (mx.random: nd.random)

__all__ = ["amp", "autograd", "ndarray", "nd", "random", "rtc",
           "MXNetError", "NDArray", "waitall", "Context", "cpu", "gpu",
           "tpu", "cpu_pinned", "current_context", "num_gpus", "num_tpus"]

# The reference's lazy subpackages (``mxnet_tpu/__init__.py``
# ``_LAZY_MODULES``, ``_ALIAS``): loaded at first touch. Those not yet
# ported raise AttributeError naming their ROADMAP.md item.
_LAZY_MODULES = ("gluon", "optimizer", "initializer", "lr_scheduler",
                 "amp", "contrib", "error", "rtc", "deploy", "resilience",
                 "serving", "observability", "jit", "kvstore",
                 "metric", "profiler", "callback", "monitor", "symbol",
                 "module", "io", "executor", "model", "visualization",
                 "rnn", "test_utils", "attribute", "name", "image",
                 "recordio", "native")
_NOT_PORTED = {name: "§1 item 14" for name in (
    "numpy", "numpy_extension", "parallel", "util", "runtime",
    "operator", "onnx", "library", "engine")}
_ALIAS = {"np": "numpy", "npx": "numpy_extension", "sym": "symbol",
          "viz": "visualization", "mod": "module", "kv": "kvstore"}


def __getattr__(name):
    target = _ALIAS.get(name, name)
    if target in _LAZY_MODULES:
        import importlib
        mod = importlib.import_module(f".{target}", __name__)
        globals()[name] = mod
        return mod
    if target in _NOT_PORTED:
        raise AttributeError(
            f"module 'mxnet_tpu_torch' has no attribute {name!r}: "
            f"mxnet_tpu.{target} is not ported yet (ROADMAP.md "
            f"{_NOT_PORTED[target]})")
    raise AttributeError(f"module 'mxnet_tpu_torch' has no attribute "
                         f"{name!r}")


def waitall():
    """Wait for all queued work on the card (``nd.waitall``)."""
    nd.waitall()
