"""PyTorch port, the vision model zoo: DenseNet 169 and 201 (121 and
161: tests/test_torch_vision_zoo3.py), each constructor's eval forward
(the helper, sizes and tolerance of tests/test_torch_vision_zoo.py,
loaded by path)."""
import importlib.util
import os

import pytest
import torch

torch.set_num_threads(2)
_spec = importlib.util.spec_from_file_location(
    "_zoo_main", os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "test_torch_vision_zoo.py"))
_zoo = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_zoo)


@pytest.mark.parametrize("name", _zoo.constructors("densenet")[2:])
def test_densenet_deep_eval_forward_matches_jax(name):
    _zoo.check_model(name)
