"""Checkpoint helpers + legacy FeedForward (a copy of
``mxnet_tpu/model.py``).

Reference: python/mxnet/model.py (save_checkpoint :403, load_checkpoint
:452, FeedForward). Checkpoints keep the reference's file naming and key
conventions (``prefix-symbol.json`` + ``prefix-NNNN.params`` with
``arg:``/``aux:`` key prefixes) in the JAX package's MXTPU1 container
(``nd.save``), byte for byte: a checkpoint written by either package
loads in the other. Reference-produced .params files (the C++ NDArray
serialisation) cannot be loaded directly and vice versa.
"""
from __future__ import annotations

from .ndarray import NDArray, save as nd_save, load as nd_load

__all__ = ["save_checkpoint", "load_checkpoint", "load_params",
           "BatchEndParam", "FeedForward"]


def save_checkpoint(prefix, epoch, symbol, arg_params, aux_params,
                    remove_amp_cast=True):
    """reference: model.py:403. The ``.params`` write is atomic
    (``nd_save`` goes through resilience.atomic): a crash mid-save
    leaves the previous epoch's file intact, never a torn one. Returns
    the nd_save metadata (file/array CRCs) for manifest use."""
    if symbol is not None:
        symbol.save(f"{prefix}-symbol.json")
    save_dict = {f"arg:{k}": v for k, v in arg_params.items()}
    save_dict.update({f"aux:{k}": v for k, v in aux_params.items()})
    param_name = f"{prefix}-{epoch:04d}.params"
    return nd_save(param_name, save_dict)


def load_params(prefix, epoch):
    """reference: model.py:429.

    Malformed containers raise ``mxnet_tpu_torch.error.CheckpointCorruptError``
    (from ``nd_load``); keys without the ``arg:``/``aux:`` convention
    raise ``mxnet_tpu_torch.error.InternalError`` naming the key and file —
    never silently dropped, never a bare KeyError/ValueError."""
    from . import error
    fname = f"{prefix}-{epoch:04d}.params"
    save_dict = nd_load(fname)
    if not isinstance(save_dict, dict):
        raise error.InternalError(
            f"'{fname}': contains unnamed arrays — not a checkpoint "
            "saved by save_checkpoint")
    arg_params = {}
    aux_params = {}
    for k, v in save_dict.items():
        tp, _, name = k.partition(":")
        if not _ or tp not in ("arg", "aux"):
            raise error.InternalError(
                f"'{fname}': key '{k}' has no 'arg:'/'aux:' prefix — "
                "file was not produced by save_checkpoint or is corrupt")
        (arg_params if tp == "arg" else aux_params)[name] = v
    return arg_params, aux_params


def load_checkpoint(prefix, epoch):
    """reference: model.py:452."""
    from .symbol import load as sym_load
    symbol = sym_load(f"{prefix}-symbol.json")
    arg_params, aux_params = load_params(prefix, epoch)
    return symbol, arg_params, aux_params


class BatchEndParam:
    def __init__(self, epoch, nbatch, eval_metric, locals):
        self.epoch = epoch
        self.nbatch = nbatch
        self.eval_metric = eval_metric
        self.locals = locals


class FeedForward:
    """Oldest-generation model API (reference: model.py:551) — kept as a
    thin veneer over Module for script compatibility."""

    def __init__(self, symbol, ctx=None, num_epoch=None,
                 epoch_size=None, optimizer="sgd",
                 initializer=None, numpy_batch_size=128,
                 arg_params=None, aux_params=None, allow_extra_params=False,
                 begin_epoch=0, **kwargs):
        self.symbol = symbol
        self.ctx = ctx
        self.num_epoch = num_epoch
        self.optimizer = optimizer
        self.initializer = initializer
        self.arg_params = arg_params
        self.aux_params = aux_params
        self.numpy_batch_size = numpy_batch_size
        self.begin_epoch = begin_epoch
        self.kwargs = kwargs
        self._module = None

    def fit(self, X, y=None, eval_data=None, eval_metric="acc",
            epoch_end_callback=None, batch_end_callback=None,
            kvstore="local", logger=None, work_load_list=None,
            monitor=None, eval_end_callback=None,
            eval_batch_end_callback=None):
        from .module import Module
        from .io.io import NDArrayIter
        from . import initializer as init_mod
        if not hasattr(X, "provide_data"):
            X = NDArrayIter(X, y, batch_size=self.numpy_batch_size)
        label_names = [n for n in self.symbol.list_arguments()
                       if n.endswith("label")]
        mod = Module(self.symbol,
                     data_names=[d.name for d in X.provide_data],
                     label_names=label_names)
        mod.fit(X, eval_data=eval_data, eval_metric=eval_metric,
                epoch_end_callback=epoch_end_callback,
                batch_end_callback=batch_end_callback, kvstore=kvstore,
                optimizer=self.optimizer,
                optimizer_params=self.kwargs.get(
                    "optimizer_params", (("learning_rate", 0.01),)),
                initializer=self.initializer or init_mod.Uniform(0.01),
                arg_params=self.arg_params, aux_params=self.aux_params,
                num_epoch=self.num_epoch, begin_epoch=self.begin_epoch)
        self._module = mod
        self.arg_params, self.aux_params = mod.get_params()
        return self

    def predict(self, X, num_batch=None, return_data=False, reset=True):
        from .io.io import NDArrayIter
        if not hasattr(X, "provide_data"):
            X = NDArrayIter(X, batch_size=self.numpy_batch_size)
        out = self._module.predict(X, num_batch=num_batch, reset=reset)
        return out.asnumpy() if isinstance(out, NDArray) else out

    def save(self, prefix, epoch=None):
        save_checkpoint(prefix, epoch if epoch is not None
                        else self.num_epoch, self.symbol,
                        self.arg_params, self.aux_params)

    @staticmethod
    def load(prefix, epoch, ctx=None, **kwargs):
        symbol, arg_params, aux_params = load_checkpoint(prefix, epoch)
        return FeedForward(symbol, ctx=ctx, arg_params=arg_params,
                           aux_params=aux_params, begin_epoch=epoch,
                           **kwargs)
