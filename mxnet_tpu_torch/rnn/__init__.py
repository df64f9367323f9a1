"""mx.rnn — legacy symbolic RNN cell API + bucketing iterator.

Reference: python/mxnet/rnn/ (rnn_cell.py, io.py). The modern path is
``gluon.rnn``; this package exists so reference Module-era RNN code
(stacked cells, FusedRNNCell, BucketSentenceIter) ports unchanged.
"""
from .rnn_cell import (BaseRNNCell, BidirectionalCell, DropoutCell,
                       FusedRNNCell, GRUCell, LSTMCell, ModifierCell,
                       ResidualCell, RNNCell, RNNParams,
                       SequentialRNNCell)
from .io import BucketSentenceIter, encode_sentences
from .rnn import (do_rnn_checkpoint, load_rnn_checkpoint, rnn_unroll,
                  save_rnn_checkpoint)

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "DropoutCell",
           "ModifierCell", "ResidualCell", "BidirectionalCell",
           "BucketSentenceIter", "encode_sentences", "rnn_unroll",
           "save_rnn_checkpoint", "load_rnn_checkpoint",
           "do_rnn_checkpoint"]
