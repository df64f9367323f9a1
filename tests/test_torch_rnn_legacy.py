"""PyTorch port, the legacy ``mx.rnn`` (``mxnet_tpu_torch/rnn``) against the
JAX package's:

- ``unroll`` of ``RNNCell``, ``LSTMCell``, ``GRUCell``, a
  ``SequentialRNNCell`` of two LSTM layers, ``BidirectionalCell``,
  ``ResidualCell`` and ``DropoutCell`` (p=0), and ``FusedRNNCell`` over
  the port's ``RNN`` op (LSTM, GRU, bidirectional, 2 layers): the same
  argument names and, with the same weights, the same outputs (f32, rtol
  1e-5, atol 1e-6 over 4 steps of width 5; 1e-5 / 1e-5 for the fused
  2-layer bidirectional op, whose steps chain 8 products);
- ``encode_sentences`` and ``BucketSentenceIter`` batch by batch (both
  shuffle from python's and numpy's global generators, seeded alike);
- ``save_rnn_checkpoint`` in one package, ``load_rnn_checkpoint`` in the
  other;
- the cases of ``tests/test_rnn_cells.py`` run through the port.
"""
import importlib.util
import os
import random
import sys

import numpy as np
import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
import torch  # noqa: E402

import mxnet_tpu as jmx  # noqa: E402
import mxnet_tpu_torch as tmx  # noqa: E402

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-6


def _symbol_tests():
    spec = importlib.util.spec_from_file_location(
        "_torch_symbol_cases", os.path.join(HERE, "test_torch_symbol.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SYM = _symbol_tests()
CELL_CASES = SYM.load_reference_tests("test_rnn_cells")
T, B, I, H = 4, 2, 3, 5


def _cell(mx, kind):
    r = mx.rnn
    return {
        "rnn": lambda: r.RNNCell(H, prefix="c_"),
        "lstm": lambda: r.LSTMCell(H, prefix="c_"),
        "gru": lambda: r.GRUCell(H, prefix="c_"),
        "stack": lambda: _stack(r),
        "bidirectional": lambda: r.BidirectionalCell(
            r.LSTMCell(H, prefix="l_"), r.GRUCell(H, prefix="r_")),
        "residual": lambda: r.ResidualCell(r.GRUCell(I, prefix="c_")),
        "dropout": lambda: _dropout(r),
        "fused_lstm": lambda: r.FusedRNNCell(H, num_layers=2, mode="lstm",
                                             bidirectional=True,
                                             prefix="f_"),
        "fused_gru": lambda: r.FusedRNNCell(H, num_layers=1, mode="gru",
                                            prefix="f_"),
    }[kind]()


def _stack(r):
    s = r.SequentialRNNCell()
    s.add(r.LSTMCell(H, prefix="a_"))
    s.add(r.LSTMCell(H, prefix="b_"))
    return s


def _dropout(r):
    s = r.SequentialRNNCell()
    s.add(r.LSTMCell(H, prefix="a_"))
    s.add(r.DropoutCell(0.0, prefix="d_"))
    return s


KINDS = ["rnn", "lstm", "gru", "stack", "bidirectional", "residual",
         "dropout", "fused_lstm", "fused_gru"]


def _unrolled(mx, kind):
    SYM.reset_names()
    out, states = _cell(mx, kind).unroll(T, mx.sym.var("data"),
                                         layout="NTC", merge_outputs=True)
    return mx.sym.Group([out] + list(states))


@pytest.mark.parametrize("kind", KINDS)
def test_unroll_matches_the_reference(kind):
    j, t = _unrolled(jmx, kind), _unrolled(tmx, kind)
    assert t.list_arguments() == j.list_arguments()
    assert t.list_outputs() == j.list_outputs()
    arg_shapes, out_shapes, _ = j.infer_shape(data=(B, T, I))
    assert t.infer_shape(data=(B, T, I)) == (arg_shapes, out_shapes, [])
    rs = np.random.RandomState(KINDS.index(kind))
    feeds = {n: (rs.randn(*s) * 0.4).astype(np.float32)
             for n, s in zip(j.list_arguments(), arg_shapes)}
    want = j.eval(**{k: jmx.nd.array(v) for k, v in feeds.items()})
    with tmx.cpu():
        got = t.eval(**{k: tmx.nd.array(v) for k, v in feeds.items()})
    atol = 1e-5 if kind == "fused_lstm" else ATOL
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.asnumpy(), w.asnumpy(), rtol=RTOL,
                                   atol=atol)


def test_bucket_sentence_iter_matches_the_reference():
    rs = np.random.RandomState(7)
    sentences = [list(rs.randint(1, 20, size=rs.randint(2, 11)))
                 for _ in range(60)]
    batches = []
    for mx in (jmx, tmx):
        random.seed(3)
        np.random.seed(3)
        with (tmx.cpu() if mx is tmx else jmx.cpu()):
            it = mx.rnn.BucketSentenceIter(sentences, batch_size=4,
                                           buckets=[5, 10], invalid_label=0)
            seen = []
            for _ in range(2):
                for b in it:
                    seen.append((b.bucket_key, b.data[0].asnumpy(),
                                 b.label[0].asnumpy(),
                                 [tuple(d.shape) for d in b.provide_data]))
                it.reset()
        batches.append(seen)
    want, got = batches
    assert len(got) == len(want) > 4
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])


def test_encode_sentences_matches_the_reference():
    sents = [["a", "b", "c"], ["c", "d"], ["a", "e", "e", "b"]]
    for kw in ({}, {"invalid_label": 0, "start_label": 1}):
        assert tmx.rnn.encode_sentences(sents, **kw) == \
            jmx.rnn.encode_sentences(sents, **kw)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_rnn_checkpoints_load_across_packages(writer, tmp_path):
    flat = np.random.RandomState(10).randn(
        4 * H * (I + H) + 8 * H).astype(np.float32)
    prefix = str(tmp_path / "m")
    pkgs = {"jax": jmx, "torch": tmx}
    w = pkgs[writer]
    r = pkgs["torch" if writer == "jax" else "jax"]
    with tmx.cpu():
        cell = w.rnn.FusedRNNCell(H, mode="lstm", prefix="c_")
        out, _ = cell.unroll(2, w.sym.var("data"), layout="NTC")
        w.rnn.save_rnn_checkpoint(cell, prefix, 3, out,
                                  {"c_parameters": w.nd.array(flat)}, {})
        rcell = r.rnn.FusedRNNCell(H, mode="lstm", prefix="c_")
        sym, args, _ = r.rnn.load_rnn_checkpoint(rcell, prefix, 3)
    assert sym.list_arguments() == out.list_arguments()
    np.testing.assert_array_equal(args["c_parameters"].asnumpy(), flat)


@pytest.mark.parametrize("case", list(CELL_CASES))
def test_rnn_cells_case_through_the_port(case, tmp_path):
    SYM.run_reference_test(CELL_CASES[case], tmp_path)
