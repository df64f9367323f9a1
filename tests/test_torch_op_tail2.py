"""PyTorch port, the rest of the op registry: every third case of the
op tail, from the second (the rest: tests/test_torch_op_tail.py,
tests/test_torch_op_tail3.py) against the JAX
package's ops, forward and VJP (the cases, the tolerances and the
comparison of tests/test_torch_op_tail.py, loaded by path)."""
import importlib.util
import os

import pytest
import torch

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location(
    "_tail_main", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                               "test_torch_op_tail.py"))
_tail = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_tail)
_CASES, _IDS = _tail.cases_for("op_tail", part=(1, 3))


@pytest.mark.parametrize("name,inputs,kwargs,family", _CASES, ids=_IDS)
def test_op_matches_jax(name, inputs, kwargs, family):
    _tail.run_tail_case(name, inputs, kwargs, family)
