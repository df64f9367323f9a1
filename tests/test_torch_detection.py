"""PyTorch port, the SSD/R-CNN detection ops
(``mxnet_tpu_torch/ops/contrib_det.py``) against the JAX package's on
the same numpy inputs: the cases of chip_smoke.py's ``TAIL_CORPUS`` and
the JAX suite's (forward and VJP, through tests/test_torch_op_tail.py's
``run_tail_case``). tests/test_torch_detection_suite.py runs the op
tests of tests/test_detection.py on both packages and the ties;
tests/test_torch_detection2.py, tests/test_torch_detection2b.py,
tests/test_torch_detection2c.py and tests/test_torch_detection2_suite.py
hold ``contrib_det2.py``'s ops the
same way.

Anchors, targets, masks and kept rows are exact (the port sorts stably,
as ``jnp.argsort`` orders ties); box coordinates that go through exp or
log within rtol 1e-5 / atol 1e-6 (``chip_smoke.WIDER_TOL``); ROIAlign
and every VJP within the product tolerance (rtol 1e-4, atol 1e-5: the
gathers' gradients are summed in another order).
"""
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
_CASES, _IDS = _tail.cases_for("detection")


@pytest.mark.parametrize("name,inputs,kwargs,family", _CASES, ids=_IDS)
def test_op_matches_jax(name, inputs, kwargs, family):
    _tail.run_tail_case(name, inputs, kwargs, family)
