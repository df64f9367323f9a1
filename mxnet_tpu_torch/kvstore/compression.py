"""2-bit gradient compression with error feedback (mirrors
``mxnet_tpu/kvstore/compression.py``).

Each element of ``grad + residual`` becomes one of ``{-t, 0, +t}``
(codes 2, 0, 1) for the threshold ``t``; what the code does not carry
stays in the residual and joins the next gradient, so the compression
is unbiased over time. Sixteen codes pack into one int32 word (code k at
bits 2k, 2k+1), as the JAX package packs them. In f32 the codes, the
packed words and the residual are the JAX package's bits: the same
comparisons against the threshold rounded to the gradient's dtype, and
one rounding for each of ``grad + residual`` and ``g - q``.
"""
from __future__ import annotations

import torch

__all__ = ["TwoBitCompression", "create"]

_VALS_PER_WORD = 16   # 2 bits per value in an int32


class TwoBitCompression:
    """Threshold quantizer: ``sign(g) * threshold`` where ``|g| >=
    threshold``, else 0."""

    def __init__(self, threshold=0.5):
        if threshold <= 0:
            raise ValueError("threshold must be positive")
        self.threshold = float(threshold)

    def _t(self, like):
        return torch.full((), self.threshold, dtype=like.dtype,
                          device=like.device)

    def quantize(self, grad, residual):
        """(flat uint8 codes, the new residual)."""
        g = grad + residual
        t = self._t(g)
        zero = torch.zeros((), dtype=torch.uint8, device=g.device)
        codes = torch.where(g >= t, torch.ones_like(zero),
                            torch.where(g <= -t, torch.full_like(zero, 2),
                                        zero))
        q = torch.where(codes == 1, t, torch.where(
            codes == 2, -t, torch.zeros_like(t)))
        return codes.reshape(-1), g - q

    def pack(self, codes):
        """Flat 2-bit codes as int32 words, 16 to a word."""
        n = codes.shape[0]
        pad = (-n) % _VALS_PER_WORD
        codes = torch.nn.functional.pad(codes.to(torch.int32), (0, pad))
        words = codes.reshape(-1, _VALS_PER_WORD)
        shifts = torch.arange(_VALS_PER_WORD, dtype=torch.int32,
                              device=codes.device) * 2
        return (words << shifts).sum(dim=1, dtype=torch.int32)

    def unpack(self, packed, n):
        shifts = torch.arange(_VALS_PER_WORD, dtype=torch.int32,
                              device=packed.device) * 2
        codes = (packed[:, None] >> shifts) & 0x3
        return codes.reshape(-1)[:n]

    def dequantize(self, codes, shape, dtype):
        t = torch.full((), self.threshold, dtype=dtype, device=codes.device)
        vals = torch.where(codes == 1, t, torch.where(
            codes == 2, -t, torch.zeros_like(t)))
        return vals.reshape(shape)

    def compress(self, grad, residual):
        """(the packed int32 words, the new residual): ceil(n / 16) words
        for n gradients."""
        codes, residual = self.quantize(grad, residual)
        return self.pack(codes), residual

    def decompress(self, packed, shape, dtype):
        n = 1
        for s in shape:
            n *= int(s)
        return self.dequantize(self.unpack(packed, n), shape, dtype)

    def roundtrip(self, grad, residual):
        """Compress and decompress in one call: (what the receiving side
        sees, the new residual)."""
        packed, residual = self.compress(grad, residual)
        return self.decompress(packed, grad.shape, grad.dtype), residual


def create(compression_params):
    """A compressor from ``set_gradient_compression``'s parameters
    (``{"type": "2bit", "threshold": 0.5}``); None for none."""
    if not compression_params:
        return None
    params = dict(compression_params)
    ctype = params.pop("type", "2bit")
    if ctype != "2bit":
        raise ValueError(f"unsupported compression type {ctype!r}; the "
                         "reference supports '2bit'")
    threshold = float(params.pop("threshold", 0.5))
    if params:
        raise ValueError(f"unknown compression params: {sorted(params)}")
    return TwoBitCompression(threshold)
