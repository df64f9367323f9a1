"""PyTorch port, the op corpus: every other case of the nn family
(the rest: tests/test_torch_op_corpus_nn2.py) against
the JAX package's ops, forward and VJP (the cases, the tolerances and
the comparison of tests/test_torch_op_corpus.py, loaded by path)."""
import importlib.util
import os

import pytest
import torch

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location(
    "_corpus_main", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                 "test_torch_op_corpus.py"))
_corpus = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_corpus)
_CASES, _IDS = _corpus.cases_of(("nn",), part=(0, 2))


@pytest.mark.parametrize("name,inputs,kwargs", _CASES, ids=_IDS)
def test_op_matches_jax(name, inputs, kwargs):
    _corpus.run_case(name, inputs, kwargs)
