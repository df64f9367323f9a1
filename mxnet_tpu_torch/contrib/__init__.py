"""``mxnet_tpu_torch.contrib`` (mirrors ``mxnet_tpu/contrib``): so far
only the entropy calibration of :mod:`.quantization`, which the
``_contrib_calibrate_entropy`` op reads. The rest of the JAX package's
``contrib`` (``quantize_net`` and the calibration collectors among it)
waits with item 14 of ROADMAP.md."""
