"""The port's decoder LM (model zoo TransformerLM) against mxnet_tpu's.

Same names for ``prefix="tlm_"``, and the same logits from the same
weights (carried across with ``load_numpy_params``) within 1e-4 absolute
and relative (f32 matmuls reordered), for impl 'dense' and 'flash'. The
JAX side runs its eager forward; on the CPU its 'flash' path is the dense
composition, which the port's flash kernel must agree with as well.
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402

CFG = dict(vocab=64, units=32, num_heads=2, num_layers=2, max_len=64)
T = 24


def _pair(impl, seed=0):
    """(JAX net, port net) with the same weights, and the weights."""
    jnet = jzoo.transformer_lm(impl=impl, prefix="tlm_", **CFG)
    jnet.initialize(mx.init.Xavier())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX flash: CPU fallback warning
        jnet(mx.nd.array(np.zeros((1, 4)), dtype="int32"))  # deferred init
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jnet.collect_params().items():
        # random gammas/betas too, so the norms' affine part is exercised
        values[name] = p.data().asnumpy() + (
            rng.randn(*p.shape) * 0.05).astype(np.float32)
        p.set_data(mx.nd.array(values[name]))
    tnet = tzoo.transformer_lm(impl=impl, prefix="tlm_", **CFG)
    tnet.initialize(ctx=mt.cpu())
    tnet.load_numpy_params(values)
    return jnet, tnet, values


def _ids(b=2, t=T, seed=1):
    return np.random.RandomState(seed).randint(0, CFG["vocab"], (b, t))


def test_param_names_match_letter_for_letter():
    jnet, tnet, _ = _pair("flash")
    assert list(tnet.collect_params()) == list(jnet.collect_params())
    names = list(tnet.collect_params())
    assert names[:3] == ["tlm_embed_weight", "tlm_pos_weight",
                         "tlm_blocks_transformerblock0_ln1_gamma"]
    assert names[-4:] == ["tlm_norm_gamma", "tlm_norm_beta",
                          "tlm_head_weight", "tlm_head_bias"]
    for name, t in tnet.collect_params().items():
        assert tuple(t.shape) == jnet.collect_params()[name].shape


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_logits_match_jax_eager(impl):
    jnet, tnet, _ = _pair(impl, seed=2)
    ids = _ids()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jnet(mx.nd.array(ids, dtype="int32")).asnumpy()
    with torch.inference_mode():
        got = tnet(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, T, CFG["vocab"])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_sequence_longer_than_max_len_raises():
    tnet = tzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    tnet.initialize(ctx=mt.cpu())
    with pytest.raises(ValueError, match="max_len"):
        tnet(torch.zeros(1, CFG["max_len"] + 1, dtype=torch.int64))


def test_decode_spec_and_param_order_match_jax():
    jnet, tnet, _ = _pair("dense")
    spec = tzoo.decode_spec(tnet)
    assert spec == jzoo.decode_spec(jnet)
    assert tzoo.decode_param_names(spec, tnet.collect_params()) == \
        jzoo.decode_param_names(spec, jnet.collect_params())


def test_bf16_cast_keeps_the_model_in_bf16():
    tnet = tzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    tnet.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                    generator=torch.Generator().manual_seed(0))
    tnet.cast("bfloat16")
    with torch.inference_mode():
        out = tnet(torch.from_numpy(_ids()))
    assert out.dtype == torch.bfloat16 and torch.isfinite(out).all()
