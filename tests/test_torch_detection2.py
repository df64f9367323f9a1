"""PyTorch port, the detection op tail (``mxnet_tpu_torch/ops/
contrib_det2.py``: proposals, position-sensitive, deformable and rotated
ROI ops, Mask R-CNN targets, the Hawkes log-likelihood) against the JAX
package's on the same numpy inputs: every third case of chip_smoke.py's
``TAIL_CORPUS`` and the JAX suite's (the rest:
tests/test_torch_detection2b.py, tests/test_torch_detection2c.py), forward and VJP through
tests/test_torch_op_tail.py's ``run_tail_case``. The rois' batch column
and the kept rows are exact (the top K is a stable sort, as
``lax.top_k`` orders ties); their coordinates go through exp, so they
are held within rtol 1e-5 / atol 1e-6; the resampling ops and every VJP
take the product tolerance (rtol 1e-4, atol 1e-5).
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
_CASES, _IDS = _tail.cases_for("detection2", part=(0, 3))


@pytest.mark.parametrize("name,inputs,kwargs,family", _CASES, ids=_IDS)
def test_op_matches_jax(name, inputs, kwargs, family):
    _tail.run_tail_case(name, inputs, kwargs, family)
