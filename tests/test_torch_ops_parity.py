"""Every op of ``mxnet_tpu/ops/math.py``, ``nn.py``, ``parity_aliases.py``
and ``random_ops.py``'s pdf ops through both packages' ``mx.nd`` on the
same seeded inputs (``tests/_torch_parity.py``), outputs and, where marked,
input gradients. Tolerances: 1e-5 relative / 1e-6 absolute unless a case
says otherwise (float32 transcendental and linalg ops get 1e-4, the ops
whose two implementations sum in different orders more). An alias is
held to resolve to the op its reference name resolves to."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from mxnet_tpu.ops import registry as jreg  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

from _torch_parity import check_op, run_both  # noqa: E402

_R = np.random.RandomState(0)
F32 = np.float32


def u(*shape, lo=-1.0, hi=1.0):
    return _R.uniform(lo, hi, shape).astype(F32)


def pos(*shape):
    return u(*shape, lo=0.5, hi=2.0)


def ids(n, *shape, dtype=F32):
    return _R.randint(0, n, shape).astype(dtype)


def spd(n, batch=2):
    a = _R.randn(batch, n, n).astype(F32)
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype=F32)).astype(F32)


CASES = []


def case(name, inputs, params=None, rtol=1e-5, atol=1e-6, grad=False,
         tag=""):
    CASES.append(pytest.param(name, inputs, params or {}, rtol, atol, grad,
                              id=f"{name}{'-' + tag if tag else ''}"))


# Gradients are held where the port writes them (the output heads) or
# composes ops whose autodiff differs in form from the reference's; a torch
# primitive's own gradient is held on a sample of each family.

# ------------------------------------------------------------ binary (bcast)
for _n in ("elemwise_add", "elemwise_sub", "elemwise_mul", "elemwise_div"):
    case(_n, [u(3, 4), pos(3, 4)], grad=_n == "elemwise_div")
case("elemwise_mod", [u(3, 4, lo=-3, hi=3), pos(3, 4)])
case("elemwise_pow", [pos(3, 4), u(3, 4)], grad=True)
for _n in ("broadcast_maximum", "broadcast_minimum", "broadcast_hypot",
           "broadcast_logaddexp"):
    case(_n, [u(3, 4), u(1, 4)], grad=_n == "broadcast_maximum")
for _n in ("elemwise_add_scalar", "elemwise_sub_scalar",
           "elemwise_mul_scalar", "elemwise_div_scalar"):
    case(_n, [pos(3, 4)], {"scalar": 1.5})
    case(_n, [pos(3, 4)], {"scalar": 1.5, "reverse": True},
         grad=_n == "elemwise_div_scalar", tag="reverse")
case("elemwise_mod_scalar", [u(3, 4, lo=-3, hi=3)], {"scalar": 1.5})
case("elemwise_mod_scalar", [pos(3, 4)], {"scalar": 2.5, "reverse": True},
     tag="reverse")
case("elemwise_pow_scalar", [pos(3, 4)], {"scalar": 2.5})
case("elemwise_pow_scalar", [u(3, 4)], {"scalar": 2.0, "reverse": True},
     grad=True, tag="reverse")

# ---------------------------------------------------------------- comparisons
_A = np.array([[1, 2, 3], [3, 2, 1]], F32)
_B = np.array([[3, 2, 1], [1, 2, 3]], F32)
for _n in ("equal", "not_equal", "greater", "greater_equal", "lesser",
           "lesser_equal"):
    case(f"broadcast_{_n}", [_A, _B])
    case(f"broadcast_{_n}_scalar", [_A], {"scalar": 2.0})
    case(f"broadcast_{_n}_scalar", [_A], {"scalar": 2.0, "reverse": True},
         tag="reverse")
_L1 = np.array([[0, 1, 0], [1, 1, 0]], F32)
_L2 = np.array([[1, 1, 0], [0, 1, 0]], F32)
for _n in ("and", "or", "xor"):
    case(f"broadcast_logical_{_n}", [_L1, _L2])
case("logical_not", [_L1])

# ---------------------------------------------------------------------- unary
for _n in ("abs", "square", "exp", "sin", "cos", "tan", "arctan", "sinh",
           "cosh", "tanh", "arcsinh", "degrees", "radians", "relu",
           "sigmoid", "softsign", "negative", "expm1", "erf", "cbrt",
           "reciprocal"):
    case(_n, [u(3, 5, lo=-2, hi=2) if _n != "reciprocal" else pos(3, 5)],
         rtol=1e-5, atol=1e-5, grad=_n in ("tanh", "erf", "cbrt"))
for _n in ("sqrt", "rsqrt", "rcbrt", "log", "log10", "log2", "log1p",
           "gamma", "gammaln", "digamma"):
    case(_n, [pos(3, 5)], rtol=1e-4, atol=1e-5,
         grad=_n in ("rsqrt", "gammaln"))
for _n in ("arcsin", "arccos", "arctanh", "erfinv"):
    case(_n, [u(3, 5, lo=-0.9, hi=0.9)], rtol=1e-4, atol=1e-5,
         grad=_n == "erfinv")
case("arccosh", [pos(3, 5) + 1.0], rtol=1e-4, atol=1e-5)
_HALF = np.array([-2.5, -1.5, -0.5, 0.5, 1.5, 2.5, -1.2, 0.7], F32)
for _n in ("sign", "round", "rint", "ceil", "floor", "trunc", "fix"):
    case(_n, [_HALF])
case("identity", [u(3, 4)])
case("BlockGrad", [u(3, 4)])
case("make_loss", [u(3, 4)])
_SPECIAL = np.array([1.0, np.nan, np.inf, -np.inf, -2.0], F32)
for _n in ("isnan", "isinf", "isfinite"):
    case(_n, [_SPECIAL])
case("clip", [u(3, 4)], {"a_min": -0.5, "a_max": 0.5}, grad=True)
case("Cast", [u(3, 4)], {"dtype": "float16"}, rtol=1e-3, atol=1e-3)
case("amp_cast", [u(3, 4)], {"dtype": "float16"}, rtol=1e-3, atol=1e-3)
case("amp_multicast", [u(3, 4), u(3, 4).astype(np.float16)],
     {"num_outputs": 2}, rtol=1e-3, atol=1e-3)

# ----------------------------------------------------------------- reductions
_X3 = u(2, 3, 4)
for _n in ("sum", "mean", "prod", "max", "min"):
    case(_n, [_X3], {"axis": 1}, grad=_n == "prod")
    case(_n, [_X3], {"axis": (0, 2), "keepdims": True}, tag="keepdims")
    case(_n, [_X3], {"axis": 1, "exclude": True}, tag="exclude")
_NAN = u(3, 4)
_NAN[0, 1] = _NAN[2, 3] = np.nan
case("nansum", [_NAN], {"axis": 1})
case("nanprod", [_NAN], {"axis": 0})
case("norm", [u(3, 4)])
case("norm", [u(3, 4)], {"ord": 1, "axis": 1}, tag="l1")
for _m in ("instance", "channel", "spatial"):
    case("L2Normalization", [u(2, 3, 4)], {"mode": _m},
         grad=_m == "instance", tag=_m)
_DISTINCT = _R.permutation(24).reshape(2, 3, 4).astype(F32)
case("argmax", [_DISTINCT], {"axis": 1})
case("argmax", [_DISTINCT], {}, tag="flat")
case("argmin", [_DISTINCT], {"axis": 2, "keepdims": True})
case("argmax_channel", [_DISTINCT[0]])
case("cumsum", [u(3, 4)], {"axis": 1}, grad=True)
case("cumprod", [u(3, 4)], {"axis": 0})

# -------------------------------------------------------------------- matmul
case("dot", [u(3, 4), u(4, 5)], grad=True)
case("dot", [u(4, 3), u(5, 4)], {"transpose_a": True, "transpose_b": True},
     grad=True, tag="tt")
case("dot", [u(4), u(4)], tag="vec")
case("dot", [u(2, 3, 4), u(4, 5)], tag="3d")
case("batch_dot", [u(2, 3, 4), u(2, 4, 5)])
case("batch_dot", [u(2, 4, 3), u(2, 5, 4)],
     {"transpose_a": True, "transpose_b": True}, tag="tt")
case("khatri_rao", [u(3, 4), u(2, 4)])

# ------------------------------------------------------------------- linalg
_TRI = np.tril(u(2, 3, 3)) + 3 * np.eye(3, dtype=F32)
_LA = dict(rtol=1e-4, atol=1e-5)
case("linalg_gemm", [u(2, 3, 4), u(2, 4, 5), u(2, 3, 5)],
     {"alpha": 0.5, "beta": 2.0}, grad=True, **_LA)
case("linalg_gemm2", [u(2, 4, 3), u(2, 4, 5)],
     {"transpose_a": True, "alpha": 1.5}, **_LA)
case("linalg_potrf", [spd(3)], **_LA)
case("linalg_potri", [_TRI], **_LA)
case("linalg_trsm", [_TRI, u(2, 3, 4)], {"alpha": 2.0}, **_LA)
case("linalg_trsm", [_TRI, u(2, 3, 4)], {"transpose": True}, tag="t", **_LA)
case("linalg_trsm", [_TRI, u(2, 4, 3)], {"rightside": True}, tag="right",
     **_LA)
case("linalg_trmm", [_TRI, u(2, 3, 4)], {"alpha": 2.0}, **_LA)
case("linalg_syrk", [u(2, 3, 4)], {"alpha": 0.5}, **_LA)
case("linalg_sumlogdiag", [_TRI], grad=True, **_LA)
case("linalg_extractdiag", [u(2, 3, 3)], {"offset": 1})
case("linalg_makediag", [u(2, 3)], {"offset": -1})
case("linalg_det", [spd(3)], rtol=1e-4, atol=1e-3)
case("linalg_slogdet", [spd(3)], **_LA)
case("linalg_inverse", [spd(3)], **_LA)

# ------------------------------------------------------------------- reshape
case("Reshape", [u(2, 3, 4)], {"shape": (4, -1)}, grad=True)
case("Reshape", [u(2, 3, 4)], {"shape": (0, -3)}, tag="codes")
case("Flatten", [u(2, 3, 4)])
case("transpose", [u(2, 3, 4)], {"axes": (1, 0, 2)})
case("transpose", [u(2, 3, 4)], tag="reverse")
case("expand_dims", [u(2, 3)], {"axis": 1})
case("squeeze", [u(2, 1, 3, 1)], {"axis": 1})
case("squeeze", [u(2, 1, 3, 1)], tag="all")
case("broadcast_axis", [u(2, 1, 3)], {"axis": 1, "size": 4})
case("broadcast_to", [u(1, 3)], {"shape": (4, 0)})
case("broadcast_like", [u(1, 3), u(4, 3)])
case("SwapAxis", [u(2, 3, 4)], {"dim1": 0, "dim2": 2})
case("slice", [u(4, 5)], {"begin": (1, 0), "end": (3, 5), "step": (1, 2)},
     grad=True)
case("slice", [u(4, 5)], {"begin": (None, 4), "end": (None, 0),
                          "step": (None, -2)}, tag="negstep")
case("slice_axis", [u(4, 5)], {"axis": 1, "begin": 1, "end": 3})
case("slice_like", [u(4, 5), u(2, 3)])
case("Concat", [u(2, 3), u(1, 3)], {"dim": 0}, grad=True)
case("stack", [u(2, 3), u(2, 3)], {"axis": 1})
case("SliceChannel", [u(2, 4, 3)], {"num_outputs": 2, "axis": 1})
case("SliceChannel", [u(2, 4, 3)],
     {"num_outputs": 4, "axis": 1, "squeeze_axis": True}, tag="squeeze")
case("split_v2", [u(6, 3)], {"indices": (1, 4)})
case("split_v2", [u(6, 3)], {"sections": 3}, tag="sections")
case("tile", [u(2, 3)], {"reps": (2, 1, 2)})
case("repeat", [u(2, 3)], {"repeats": 2, "axis": 1})
case("repeat", [u(2, 3)], {"repeats": 2}, tag="flat")
case("pad", [u(1, 2, 3, 4)], {"mode": "constant", "constant_value": 0.5,
                              "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)})
case("pad", [u(1, 2, 3, 4)], {"mode": "edge",
                              "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
     tag="edge")
case("pad", [u(1, 2, 3, 4)], {"mode": "reflect",
                              "pad_width": (0, 0, 0, 0, 1, 2, 2, 1)},
     tag="reflect")
case("flip", [u(2, 3)], {"axis": 1})
case("reverse", [u(2, 3, 4)], {"axis": (0, 2)})
case("depth_to_space", [u(1, 8, 2, 3)], {"block_size": 2})
case("space_to_depth", [u(1, 2, 4, 6)], {"block_size": 2})
case("diag", [u(4)], {"k": 1})
case("diag", [u(3, 4)], {"k": -1}, tag="2d")
case("shape_array", [u(2, 3, 4)])
case("size_array", [u(2, 3, 4)])
case("zeros_like", [u(2, 3)])
case("ones_like", [u(2, 3)])

# ------------------------------------------------------------------- indexing
case("take", [u(5, 3), np.array([[0, 4], [7, -2]], F32)], grad=True)
case("take", [u(3, 5), np.array([1, 3], F32)], {"axis": 1}, tag="axis1")
case("batch_take", [u(4, 5), np.array([0, 4, 2, 1], F32)])
case("pick", [u(4, 5), np.array([0, 4, 2, 3], F32)], grad=True)
case("pick", [u(4, 5), np.array([[0], [4], [2], [1]], F32)],
     {"axis": 1, "keepdims": True}, tag="keepdims")
case("Embedding", [np.array([[0, 3], [5, 1]], F32), u(6, 4)],
     {"input_dim": 6, "output_dim": 4}, grad=True)
case("gather_nd", [u(3, 4), np.array([[0, 2, 1], [3, 0, 1]], F32)])
case("scatter_nd", [u(3), np.array([[0, 2, 1], [3, 0, 1]], F32)],
     {"shape": (3, 4)})
case("one_hot", [np.array([0, 2, 5, -1], F32)], {"depth": 4,
                                                "on_value": 2.0,
                                                "off_value": -1.0})
case("where", [np.array([[1, 0, 1]], F32), u(2, 3), u(2, 3)])
case("boolean_mask", [u(4, 3), np.array([1, 0, 1, 1], F32)])
_LENS = np.array([2, 4, 1], F32)
for _n in ("sequence_mask", "SequenceMask"):
    case(_n, [u(4, 3, 2), _LENS], {"use_sequence_length": True,
                                   "value": -1.0})
case("SequenceLast", [u(4, 3, 2), _LENS], {"use_sequence_length": True})
case("SequenceLast", [u(4, 3, 2)], tag="nolen")
case("SequenceReverse", [u(4, 3, 2), _LENS], {"use_sequence_length": True})

# ------------------------------------------------------------------- ordering
_ORD = _R.permutation(15).reshape(3, 5).astype(F32)
case("argsort", [_ORD])
case("argsort", [_ORD], {"axis": 0, "is_ascend": False}, tag="desc")
case("sort", [_ORD], {"is_ascend": False})
for _rt in ("indices", "value", "both", "mask"):
    case("topk", [_ORD], {"k": 2, "ret_typ": _rt}, tag=_rt)
case("topk", [_ORD], {"k": 2, "axis": 0, "is_ascend": True,
                      "ret_typ": "both"}, tag="ascend")

# ---------------------------------------------------------------------- misc
case("histogram", [u(50)], {"bin_cnt": 5, "range": (-1.0, 1.0)})
case("add_n", [u(2, 3), u(2, 3), u(2, 3)])
case("smooth_l1", [u(3, 4, lo=-2, hi=2)], {"scalar": 1.5}, grad=True)
case("hard_sigmoid", [u(3, 4, lo=-4, hi=4)])
case("_ravel_multi_index", [np.array([[0, 1, 2], [3, 0, 1]], F32)],
     {"shape": (3, 4)})
case("_unravel_index", [np.array([0, 5, 11], F32)], {"shape": (3, 4)})
case("_contrib_index_copy", [u(5, 3), np.array([4, 0], F32), u(2, 3)])
case("_contrib_index_add", [u(5, 3), np.array([4, 0], F32), u(2, 3)])
case("moments", [u(3, 4, 5)], {"axes": (0, 2)})
case("reshape_like", [u(2, 6), u(3, 4)])
case("reshape_like", [u(2, 12, 2), u(3, 4)],
     {"lhs_begin": 1, "lhs_end": 2, "rhs_begin": 0, "rhs_end": 2},
     tag="range")
case("_contrib_allclose", [_SPECIAL, _SPECIAL.copy()])

# ------------------------------------------------------------------------ nn
case("FullyConnected", [u(4, 6), u(3, 6), u(3)], {"num_hidden": 3},
     grad=True)
case("Convolution", [u(2, 3, 6, 6), u(4, 3, 3, 3), u(4)],
     {"kernel": (3, 3), "num_filter": 4, "pad": (1, 1)}, grad=True,
     rtol=1e-4, atol=1e-5)
case("Deconvolution", [u(2, 4, 5, 5), u(4, 3, 3, 3)],
     {"kernel": (3, 3), "num_filter": 3, "stride": (2, 2), "pad": (1, 1),
      "adj": (1, 1)}, grad=True, rtol=1e-4, atol=1e-5)
case("Deconvolution", [u(2, 4, 5, 5), u(4, 2, 3, 3), u(4)],
     {"kernel": (3, 3), "num_filter": 4, "num_group": 2, "no_bias": False},
     rtol=1e-4, atol=1e-5, tag="groups")
for _pt in ("max", "avg", "sum", "lp"):
    case("Pooling", [u(2, 3, 6, 6)], {"kernel": (2, 2), "stride": (2, 2),
                                      "pool_type": _pt}, tag=_pt,
         rtol=1e-5, atol=1e-5)
case("UpSampling", [u(1, 2, 3, 3)], {"scale": 2, "sample_type": "nearest"},
     grad=True)
case("UpSampling", [u(1, 2, 4, 4), u(1, 3, 2, 2)],
     {"scale": 2, "sample_type": "nearest", "num_args": 2}, tag="multi")
case("UpSampling", [u(1, 2, 3, 3)], {"scale": 2, "sample_type": "bilinear"},
     rtol=1e-5, atol=1e-5, tag="bilinear")
case("BilinearResize2D", [u(1, 2, 3, 4)], {"height": 6, "width": 7},
     rtol=1e-5, atol=1e-5)
case("BatchNorm", [u(4, 3, 2), pos(3), u(3), u(3), pos(3)],
     {"fix_gamma": False}, grad=True, rtol=1e-4, atol=1e-5)
case("LayerNorm", [u(3, 5), pos(5), u(5)], grad=True, rtol=1e-4,
     atol=1e-5)
case("LayerNorm", [u(3, 4, 5), pos(4), u(4)], {"axis": 1}, rtol=1e-4,
     atol=1e-5, tag="axis1")
case("GroupNorm", [u(2, 4, 3, 3), pos(2), u(2)], {"num_groups": 2},
     grad=True, rtol=1e-4, atol=1e-5)
case("InstanceNorm", [u(2, 3, 4, 4), pos(3), u(3)], rtol=1e-4,
     atol=1e-5)
case("LRN", [u(2, 6, 3, 3)], {"nsize": 3}, grad=True, rtol=1e-5, atol=1e-5)
for _at in ("relu", "sigmoid", "tanh", "softrelu", "softsign", "gelu",
            "silu"):
    case("Activation", [u(3, 4, lo=-3, hi=3)], {"act_type": _at},
         grad=_at == "gelu", tag=_at, rtol=1e-5, atol=1e-5)
for _at in ("leaky", "elu", "selu", "gelu", "rrelu"):
    case("LeakyReLU", [u(3, 4, lo=-3, hi=3)], {"act_type": _at,
                                               "slope": 0.3},
         grad=_at in ("elu", "gelu"), tag=_at, rtol=1e-5, atol=1e-5)
case("LeakyReLU", [u(2, 3, 4), pos(3)], {"act_type": "prelu"}, grad=True,
     tag="prelu")
case("softmax", [u(3, 5)], {"temperature": 2.0}, grad=True)
case("log_softmax", [u(3, 5)], {"axis": 0})
case("softmin", [u(3, 5)])
case("SoftmaxActivation", [u(2, 3, 4)])
case("SoftmaxActivation", [u(2, 3, 4)], {"mode": "channel"}, tag="channel")
_LOGITS = u(4, 5, lo=-2, hi=2)
_LABEL = np.array([0, 3, 4, 1], F32)
case("SoftmaxOutput", [_LOGITS, _LABEL], grad=True)
case("SoftmaxOutput", [_LOGITS, np.array([0, -1, 4, -1], F32)],
     {"use_ignore": True, "ignore_label": -1.0, "grad_scale": 2.0},
     grad=True, tag="ignore")
case("SoftmaxOutput", [u(2, 3, 4), ids(3, 2, 4)], {"multi_output": True},
     tag="multi")
for _n in ("LinearRegressionOutput", "LogisticRegressionOutput",
           "MAERegressionOutput"):
    case(_n, [u(4, 3), u(4, 3)], {"grad_scale": 2.0}, grad=True)
case("softmax_cross_entropy", [_LOGITS, _LABEL], grad=True)
case("SVMOutput", [_LOGITS, _LABEL])
case("Dropout", [u(3, 4)], {"p": 0.5}, tag="inference")
case("CTCLoss", [u(6, 2, 5), np.array([[1, 2, 0], [3, 3, 4]], F32)],
     rtol=1e-4, atol=1e-4)
case("_contrib_interleaved_matmul_selfatt_qk", [u(5, 2, 12)], {"heads": 2})
case("_contrib_interleaved_matmul_selfatt_valatt",
     [u(5, 2, 12), u(4, 5, 5)], {"heads": 2}, grad=True)
case("_contrib_interleaved_matmul_encdec_qk", [u(3, 2, 8), u(5, 2, 16)],
     {"heads": 2})
case("_contrib_interleaved_matmul_encdec_valatt", [u(5, 2, 16), u(4, 3, 5)],
     {"heads": 2})
_Q, _K, _V = u(1, 2, 6, 8), u(1, 2, 6, 8), u(1, 2, 6, 8)
case("scaled_dot_product_attention", [_Q, _K, _V], {"causal": True},
     grad=True, rtol=1e-5, atol=1e-5)
case("scaled_dot_product_attention", [_Q, _K, _V],
     {"causal": True, "impl": "flash"}, grad=True, rtol=1e-4, atol=1e-5,
     tag="flash")

# ------------------------------------------------------------- parity tail
case("_zeros", [], {"shape": (2, 3)})
case("_ones", [], {"shape": (2, 3)})
case("_full", [], {"shape": (2, 3), "value": 1.5})
case("_eye", [], {"N": 3, "M": 4, "k": 1})
case("_arange", [], {"start": 1.0, "stop": 7.0, "step": 2.0, "repeat": 2})
case("_linspace", [], {"start": 0.0, "stop": 1.0, "num": 5})
case("_linspace", [], {"start": 0.0, "stop": 1.0, "num": 4,
                       "endpoint": False}, tag="open")
case("linalg_extracttrian", [u(2, 3, 3)])
case("linalg_extracttrian", [u(2, 3, 3)], {"offset": 1}, tag="offset")
case("linalg_maketrian", [u(2, 6)])
case("linalg_maketrian", [u(2, 3)], {"offset": 1}, tag="offset")
case("im2col", [u(1, 2, 5, 5)], {"kernel": (3, 3), "stride": (2, 2),
                                 "pad": (1, 1)}, grad=True)
case("col2im", [u(1, 18, 9)], {"output_size": (5, 5), "kernel": (3, 3),
                               "stride": (2, 2), "pad": (1, 1)})
case("_slice_assign", [u(4, 5), u(2, 2)], {"begin": (1, 2), "end": (3, 4)})
case("_slice_assign_scalar", [u(4, 5)], {"scalar": 2.0, "begin": (0, 1),
                                         "end": (4, 5), "step": (2, 2)})
case("_scatter_set_nd", [u(3, 4), u(2), np.array([[0, 2], [3, 1]], F32)])
case("_identity_with_attr_like_rhs", [u(2, 3), u(2, 3)])
case("_rnn_param_concat", [u(4), u(6)], {"dim": 0})
case("IdentityAttachKLSparseReg", [u(3, 4), u(1)])
case("_contrib_edge_id", [np.array([[0, 5, 0], [2, 0, 7], [0, 0, 1]], F32),
                          np.array([0, 1, 2, 0], F32),
                          np.array([1, 2, 0, 0], F32)])
case("_contrib_SyncBatchNorm", [u(4, 3), pos(3), u(3), u(3), pos(3)],
     {"fix_gamma": False}, rtol=1e-5, atol=1e-5)

# ---------------------------------------------------------------- pdf ops
_S = pos(2, 5)
case("_random_pdf_uniform", [u(2, 5, lo=0, hi=1), np.zeros(2, F32),
                             np.array([0.5, 2.0], F32)])
case("_random_pdf_normal", [u(2, 5), u(2), pos(2)], grad=True,
     rtol=1e-5, atol=1e-5)
case("_random_pdf_normal", [u(2, 5), u(2), pos(2)], {"is_log": True},
     tag="log")
case("_random_pdf_exponential", [_S, pos(2)])
case("_random_pdf_gamma", [_S, pos(2), pos(2)], rtol=1e-4, atol=1e-5)
_COUNT = ids(6, 2, 5)
case("_random_pdf_poisson", [_COUNT, pos(2)], rtol=1e-4, atol=1e-6)
case("_random_pdf_negative_binomial", [_COUNT, pos(2) * 2,
                                       np.array([0.3, 0.6], F32)],
     rtol=1e-4, atol=1e-6)
case("_random_pdf_generalized_negative_binomial", [_COUNT, pos(2), pos(2)],
     rtol=1e-4, atol=1e-6)
_DIR = _R.dirichlet([1.0, 2.0, 3.0], size=(2, 4)).astype(F32)
case("_random_pdf_dirichlet", [_DIR, pos(2, 3)], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name,inputs,params,rtol,atol,grad", CASES)
def test_op_parity(name, inputs, params, rtol, atol, grad):
    check_op(name, inputs, params, rtol=rtol, atol=atol, grad=grad)


# ----------------------------------------------- ops held by a reconstruction

def test_factorizations_by_reconstruction():
    """gelqf and syevd are unique up to signs: each side's factors rebuild
    the input within 1e-4, and the eigenvalues agree within 1e-4."""
    a = u(2, 3, 5)
    (jl, jq), (tl, tq), _, _ = run_both("linalg_gelqf", [a])
    for ll, q in ((jl, jq), (tl, tq)):
        np.testing.assert_allclose(ll @ q, a, rtol=1e-4, atol=1e-4)
    s = spd(4)
    (ju, jw), (tu, tw), _, _ = run_both("linalg_syevd", [s])
    np.testing.assert_allclose(tw, jw, rtol=1e-4, atol=1e-4)
    rebuilt = np.einsum("bki,bk,bkj->bij", tu, tw, tu)
    np.testing.assert_allclose(rebuilt, s, rtol=1e-4, atol=1e-3)


# ------------------------------------------------------------------ aliases

def _ref_aliases():
    from test_torch_registry_coverage import PENDING

    return sorted(a for a in jreg._ALIASES if a not in PENDING)


CASE_NAMES = {p.values[0] for p in CASES} | {
    "linalg_gelqf", "linalg_syevd", "_contrib_calibrate_entropy"}


@pytest.mark.parametrize("alias", _ref_aliases())
def test_alias_resolves_like_the_reference(alias):
    """An alias of ``mxnet_tpu`` resolves in the port to the op its
    reference name resolves to, which has a parity case here or elsewhere
    (``test_torch_registry_coverage.py`` checks that). The port's
    optimizer slice registered ``_multi_mp_lamb_update`` as an op of its
    own (fp32 masters), where ``mxnet_tpu`` aliases it to
    ``multi_lamb_update``."""
    got = treg.get_op(alias).name
    assert got == jreg.get_op(alias).name or \
        (got == alias and alias in treg._OPS), (alias, got)


def test_calibrate_entropy_takes_the_ports_calibration():
    """``_contrib_calibrate_entropy`` gives (-t, t) for the threshold of
    the port's calibration, equal to ``mxnet_tpu``'s threshold search on
    the same histogram (its op cannot run eagerly there: a host op under
    jit)."""
    from mxnet_tpu.contrib.quantization import _entropy_threshold

    import mxnet_tpu_torch as mt

    x = np.abs(np.random.RandomState(5).randn(2000))
    counts, edges = np.histogram(x, bins=200, range=(0.0, float(x.max())))
    with mt.cpu():
        lo, hi = mt.nd._contrib_calibrate_entropy(
            mt.nd.array(counts), mt.nd.array(edges), num_quantized_bins=63)
    want = _entropy_threshold(counts.astype(F32), edges.astype(F32), 63)
    np.testing.assert_allclose([lo.asscalar(), hi.asscalar()],
                               [-want, want], rtol=1e-6)

