"""PyTorch port, the vision model zoo: AlexNet and VGG, each
constructor's eval forward against the JAX net's on the same weights
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


@pytest.mark.parametrize("name", _zoo.constructors("alexnet")
                         + _zoo.constructors("vgg"))
def test_alexnet_vgg_eval_forward_matches_jax(name):
    _zoo.check_model(name)
