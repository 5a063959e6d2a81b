"""Every op name and alias ``mxnet_tpu`` registers resolves in the port, or
sits in :data:`PENDING` with the ROADMAP item that ports it. Later slices
shrink the dict. The names of ``mxnet_tpu/ops/math.py``, ``nn.py``,
``parity_aliases.py``, ``random_ops.py``, ``rnn.py``,
``control_flow.py``, ``detection.py`` and ``image_ops.py`` each have a
parity case (``test_torch_ops_parity.py``, ``test_torch_random.py``,
``test_torch_detection.py``, ``test_torch_image.py``, or the earlier file
named in :data:`ELSEWHERE`); the sparse-storage ones raise."""
import inspect

import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402,F401  (registers the ops)
import mxnet_tpu.operator  # noqa: E402,F401  (registers "Custom" at import)
import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu.ops import registry as jreg  # noqa: E402
from mxnet_tpu_torch.ops import registry as treg  # noqa: E402

_VISION = "ROADMAP Queue 1 item 11 (vision_extra, the last op family)"

# name -> the ROADMAP item that ports it
PENDING = {
    "Custom": "ROADMAP Queue 1 item 11 (operator.py, CustomOp)",
    **{n: _VISION for n in (
        # vision_extra
        "BilinearSampler", "GridGenerator", "SpatialTransformer",
        "ROIPooling", "Correlation", "_contrib_Proposal",
        "_contrib_DeformableConvolution", "_contrib_fft", "_contrib_ifft",
        "_contrib_count_sketch", "_contrib_quadratic", "_contrib_index_array",
        "_contrib_arange_like", "_contrib_hawkesll",
        "_contrib_DeformablePSROIPooling", "_contrib_AdaptiveAvgPooling2D",
        "_contrib_RROIAlign", "Proposal", "DeformableConvolution", "fft",
        "ifft", "count_sketch", "quadratic", "index_array", "arange_like",
        "hawkesll", "hawkes_ll", "_contrib_hawkes_ll",
        "DeformablePSROIPooling", "AdaptiveAvgPooling2D", "RROIAlign")},
}

# sparse storage: resolves, raises naming ROADMAP Queue 1 item 9
RAISES = ("cast_storage", "_sparse_retain", "_contrib_getnnz")

# covered by an earlier slice's parity tests
ELSEWHERE = {
    "_mp_adamw_update": "test_torch_optimizers.py",
    "_multi_adamw_update": "test_torch_optimizers.py",
    "_multi_mp_adamw_update": "test_torch_optimizers.py",
    "_sparse_adagrad_update": "test_torch_optimizers.py",
    "mp_lamb_update_phase1": "test_torch_optimizers.py",
    "mp_lamb_update_phase2": "test_torch_optimizers.py",
    "preloaded_multi_mp_sgd_update": "test_torch_optimizers.py",
    "preloaded_multi_mp_sgd_mom_update": "test_torch_optimizers.py",
    "RNN": "test_torch_rnn.py",
    "_foreach": "test_torch_control_flow.py",
    "_while_loop": "test_torch_control_flow.py",
    "_cond": "test_torch_control_flow.py",
}

_SOURCES = ("mxnet_tpu/ops/math.py", "mxnet_tpu/ops/nn.py",
            "mxnet_tpu/ops/parity_aliases.py",
            "mxnet_tpu/ops/random_ops.py", "mxnet_tpu/ops/rnn.py",
            "mxnet_tpu/ops/control_flow.py", "mxnet_tpu/ops/detection.py",
            "mxnet_tpu/ops/image_ops.py")


def _source(op):
    try:
        path = inspect.getsourcefile(op.fn) or ""
    except TypeError:     # a jax / numpy callable, registered by math.py
        return "mxnet_tpu/ops/math.py"
    if "mxnet_tpu/" not in path:
        return "mxnet_tpu/ops/math.py"
    return "mxnet_tpu/" + path.rsplit("mxnet_tpu/", 1)[1]


def _resolves(name):
    try:
        treg.get_op(name)
        return True
    except mt.MXNetError:
        return False


def test_every_reference_name_resolves_or_is_pending():
    names = sorted(set(jreg._OPS) | set(jreg._ALIASES))
    missing = [n for n in names if not _resolves(n) and n not in PENDING]
    assert not missing, missing
    # the dict lists nothing that resolves (shrink it as items land)
    stale = [n for n in PENDING if _resolves(n)]
    assert not stale, stale
    unknown = [n for n in PENDING if n not in names]
    assert not unknown, unknown


def test_every_slice_op_has_a_parity_case():
    from test_torch_detection import CASE_NAMES as DETECTION
    from test_torch_image import CASE_NAMES as IMAGE
    from test_torch_ops_parity import CASE_NAMES
    from test_torch_random import SAMPLERS

    required = sorted(n for n, op in jreg._OPS.items()
                      if _source(op) in _SOURCES)
    covered = CASE_NAMES | set(SAMPLERS) | set(RAISES) | set(ELSEWHERE) | \
        DETECTION | IMAGE
    assert {"_contrib_MultiBoxTarget", "_image_resize"} <= set(required)
    uncovered = [n for n in required if n not in covered]
    assert not uncovered, uncovered


@pytest.mark.parametrize("name", RAISES)
def test_sparse_storage_ops_raise_naming_item_9(name):
    with mt.cpu():
        x = mt.nd.ones((3, 2))
        with pytest.raises(mt.MXNetError, match="item 9"):
            getattr(mt.nd, name)(x, x)
