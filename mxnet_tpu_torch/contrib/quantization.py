"""Entropy calibration (the port of ``optimal_threshold`` in
``mxnet_tpu/contrib/quantization.py``, numpy only, copied so the port
imports nothing of the JAX package). ``quantize_net`` and the rest of
that module wait with item 14 of ROADMAP.md."""
from __future__ import annotations

import numpy as _np

__all__ = ["optimal_threshold"]


def optimal_threshold(hist, edges, num_quantized_bins=255):
    """The KL-divergence-optimal |threshold| of a symmetric histogram
    (the reference's ``_get_optimal_threshold``: the MXNet/TensorRT
    entropy calibration)."""
    hist = _np.asarray(hist, _np.float64)
    nbins = hist.size
    zero_bin = nbins // 2
    thresholds, divergences = [], []
    # candidate thresholds: growing symmetric windows around zero
    for i in range(num_quantized_bins // 2, zero_bin + 1,
                   max(1, zero_bin // 64)):
        lo, hi = zero_bin - i, zero_bin + i
        sliced = hist[lo:hi]
        # p: the outliers clamped into the edge bins; q: built from the
        # unclamped slice, so clipped mass q cannot represent is what the
        # KL term penalizes
        p = sliced.copy()
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        if p.sum() == 0:
            continue
        factor = sliced.size / num_quantized_bins
        q = _np.zeros_like(sliced)
        for j in range(num_quantized_bins):
            a = int(_np.floor(j * factor))
            b = int(_np.ceil((j + 1) * factor))
            chunk = sliced[a:b]
            nz = (chunk != 0)
            if nz.any():
                q[a:b][nz] = chunk[nz].sum() / nz.sum()
        pn = p / p.sum()
        qn = q / max(q.sum(), 1e-300)
        mask = pn > 0
        kl = _np.sum(pn[mask] * _np.log(pn[mask] /
                                        _np.maximum(qn[mask], 1e-300)))
        thresholds.append(edges[hi])
        divergences.append(kl)
    if not thresholds:
        return float(edges[-1])
    return float(thresholds[int(_np.argmin(divergences))])
