"""Bucketing data iterator for the legacy RNN API (a copy of
``mxnet_tpu/rnn/io.py``).

Reference: python/mxnet/rnn/io.py (encode_sentences:29,
BucketSentenceIter:83). Sentences are binned into the smallest bucket
that fits, padded with ``invalid_label``, and served as
(data, shifted-label) batches carrying a ``bucket_key`` — each bucket
key is one bound executor of the consuming BucketingModule.
"""
from __future__ import annotations

import bisect
import random

import numpy as np

from .. import ndarray
from ..io.io import DataBatch, DataDesc, DataIter

__all__ = ["encode_sentences", "BucketSentenceIter"]


def encode_sentences(sentences, vocab=None, invalid_label=-1,
                     invalid_key="\n", start_label=0, unknown_token=None):
    """Map token sentences to int ids, growing ``vocab`` as needed
    (reference: io.py:29). Returns (encoded, vocab)."""
    idx = start_label
    if vocab is None:
        vocab = {invalid_key: invalid_label}
        new_vocab = True
    else:
        new_vocab = False
        idx = max(vocab.values()) + 1
    res = []
    for sent in sentences:
        coded = []
        for word in sent:
            if word not in vocab:
                if not new_vocab:
                    if unknown_token is None:
                        raise ValueError(
                            f"unknown token {word!r} with a fixed vocab "
                            "and no unknown_token")
                    if unknown_token not in vocab:
                        # mutating a fixed vocab would push ids past the
                        # embedding width trained against it
                        raise ValueError(
                            f"unknown_token {unknown_token!r} must "
                            "already be in the fixed vocab")
                    word = unknown_token
                else:
                    if idx == invalid_label:
                        idx += 1
                    vocab[word] = idx
                    idx += 1
            coded.append(vocab[word])
        res.append(coded)
    return res, vocab


class BucketSentenceIter(DataIter):
    """Bucketed LM iterator: label[t] = data[t+1] (reference:
    io.py:83)."""

    def __init__(self, sentences, batch_size, buckets=None,
                 invalid_label=-1, data_name="data",
                 label_name="softmax_label", dtype="float32", layout="NT"):
        super().__init__(batch_size=batch_size)
        if not buckets:
            counts = np.bincount([len(s) for s in sentences])
            buckets = [length for length, n in enumerate(counts)
                       if n >= batch_size]
        buckets = sorted(buckets)

        binned = [[] for _ in buckets]
        discarded = 0
        for sent in sentences:
            i = bisect.bisect_left(buckets, len(sent))
            if i == len(buckets):
                discarded += 1
                continue
            row = np.full((buckets[i],), invalid_label, dtype=dtype)
            row[:len(sent)] = sent
            binned[i].append(row)
        if discarded:
            print(f"WARNING: discarded {discarded} sentences longer than "
                  "the largest bucket.")
        keep = [i for i, rows in enumerate(binned) if rows]
        if not keep:
            if buckets and discarded:
                raise ValueError(
                    f"no bucket holds any sentence: all {discarded} "
                    f"sentences are longer than the largest bucket "
                    f"({buckets[-1]}) — add a larger bucket")
            raise ValueError(
                "no bucket holds any sentence: auto-bucketing keeps "
                "only lengths occurring >= batch_size times — pass "
                "explicit `buckets` or lower batch_size")
        self.buckets = [buckets[i] for i in keep]
        self.data = [np.asarray(binned[i], dtype=dtype) for i in keep]

        self.batch_size = batch_size
        self.data_name = data_name
        self.label_name = label_name
        self.dtype = dtype
        self.invalid_label = invalid_label
        self.layout = layout
        self.major_axis = layout.find("N")
        if self.major_axis not in (0, 1):
            raise ValueError(f"invalid layout {layout!r}: need NT or TN")
        self.default_bucket_key = max(self.buckets)
        self.provide_data = [DataDesc(
            data_name, self._shape(self.default_bucket_key), layout=layout)]
        self.provide_label = [DataDesc(
            label_name, self._shape(self.default_bucket_key), layout=layout)]

        self.idx = [(i, j) for i, rows in enumerate(self.data)
                    for j in range(0, len(rows) - batch_size + 1,
                                   batch_size)]
        self.curr_idx = 0
        self.reset()

    def _shape(self, seq_len):
        return ((self.batch_size, seq_len) if self.major_axis == 0
                else (seq_len, self.batch_size))

    def reset(self):
        self.curr_idx = 0
        random.shuffle(self.idx)
        for rows in self.data:
            np.random.shuffle(rows)
        self.nddata, self.ndlabel = [], []
        for rows in self.data:
            label = np.full_like(rows, self.invalid_label)
            label[:, :-1] = rows[:, 1:]
            self.nddata.append(ndarray.array(rows, dtype=self.dtype))
            self.ndlabel.append(ndarray.array(label, dtype=self.dtype))

    def next(self):
        if self.curr_idx == len(self.idx):
            raise StopIteration
        i, j = self.idx[self.curr_idx]
        self.curr_idx += 1
        data = self.nddata[i][j:j + self.batch_size]
        label = self.ndlabel[i][j:j + self.batch_size]
        if self.major_axis == 1:
            data = data.T
            label = label.T
        key = self.buckets[i]
        return DataBatch(
            [data], [label], pad=0, bucket_key=key,
            provide_data=[DataDesc(self.data_name, self._shape(key),
                                   layout=self.layout)],
            provide_label=[DataDesc(self.label_name, self._shape(key),
                                    layout=self.layout)])
