"""mxnet_tpu_torch — the PyTorch/CUDA port of ``mxnet_tpu``.

The JAX package stays the reference; this package ports it slice by
slice to PyTorch with hand-written CUDA kernels for an NVIDIA H100
(``sm_90a``). Ported so far: paged LLM serving
(:mod:`mxnet_tpu_torch.serving.llm` — ``LLMServer`` down to the flat
ragged step) with the flat ragged paged-attention kernels (f32 and
int8/fp8 pages) and the weight-only quantized matmul kernel. See
ROADMAP.md for what remains.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU (``device="cpu"``), where every kernel's plain PyTorch
version runs instead. This package never imports ``jax`` or
``mxnet_tpu``; kernels are built from ``csrc/`` at first use
(:mod:`mxnet_tpu_torch.kernels`).
"""
__version__ = "0.1.0"
