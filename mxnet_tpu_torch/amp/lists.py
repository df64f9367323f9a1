"""AMP op classification lists of the port (a copy of
``mxnet_tpu/amp/lists.py``; the port imports nothing of the JAX
package).

Reference: python/mxnet/contrib/amp/lists/symbol_fp16.py (FP16_FUNCS /
FP32_FUNCS / WIDEST_TYPE_CASTS). The policy is bfloat16-first:
matmul-class ops run in the target dtype on the tensor cores;
numerically sensitive reductions, normalizations, softmaxes and losses
stay float32. Ops in neither list run in whatever dtype their inputs
carry.
"""

# run in the target dtype: tensor-core contractions
LP_OPS = frozenset({
    "FullyConnected", "fully_connected", "Convolution", "convolution",
    "Deconvolution", "dot", "batch_dot", "linalg_gemm", "linalg_gemm2",
    "RNN", "rnn", "scaled_dot_product_attention", "Embedding", "embedding",
})

# forced to float32: softmax/norm/loss numerics
F32_OPS = frozenset({
    "softmax", "log_softmax", "softmin", "Softmax", "SoftmaxOutput",
    "softmax_output", "softmax_cross_entropy", "CTCLoss", "ctc_loss",
    "BatchNorm", "batch_norm", "LayerNorm", "layer_norm", "InstanceNorm",
    "GroupNorm", "L2Normalization", "LRN", "norm", "logsumexp",
    "exp", "log", "log1p", "expm1", "mean", "sum", "nansum", "nanprod",
    "erf", "erfinv", "gamma", "gammaln", "smooth_l1", "moments",
})
