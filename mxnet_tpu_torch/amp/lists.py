"""AMP op categorization: ``mxnet_tpu/amp/lists.py``'s four lists,
verbatim (parity: python/mxnet/contrib/amp/lists/symbol.py) — which ops
run in the low-precision target dtype (the matmul and conv families), which
are pinned to fp32 (reductions and exp/log-shaped numerics), which only
under fp16, and which cast their float inputs to the widest. Everything
unlisted follows the dtype of its inputs.
"""

# run in the target dtype (bf16/fp16): MXU-bound compute
TARGET_DTYPE_OPS = [
    "Convolution", "Deconvolution", "FullyConnected", "RNN",
    "dot", "batch_dot",
    "_contrib_interleaved_matmul_selfatt_qk",
    "_contrib_interleaved_matmul_selfatt_valatt",
    "_contrib_interleaved_matmul_encdec_qk",
    "_contrib_interleaved_matmul_encdec_valatt",
]

# pinned to fp32: reductions / exp-log numerics
FP32_OPS = [
    "softmax", "log_softmax", "softmin", "SoftmaxOutput", "SoftmaxActivation",
    "exp", "log", "log2", "log10", "log1p", "expm1",
    "sum", "mean", "prod", "nansum", "nanprod", "norm",
    "L2Normalization", "InstanceNorm", "LayerNorm", "GroupNorm", "LRN",
    "make_loss", "MakeLoss", "smooth_l1", "CTCLoss",
    "linalg_gemm", "linalg_gemm2", "linalg_potrf", "linalg_trsm",
    "power", "rsqrt", "sqrt", "square", "reciprocal",
]

# kept in fp32 only under fp16 (bf16 has fp32's range, fp16 does not)
FP16_FP32_OPS = [
    "BatchNorm", "cumsum",
]

# ops whose float inputs must all agree — cast to the widest
WIDEST_TYPE_CASTS = [
    "broadcast_add", "broadcast_sub", "broadcast_mul", "broadcast_div",
    "elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div",
    "Concat", "concat", "stack", "where",
]
