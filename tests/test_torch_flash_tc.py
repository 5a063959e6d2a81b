"""Kernel K1's tensor-core route in the PyTorch port, CPU side.

K1 has two CUDA kernels, chosen by ``ops/kernels.py:_flash_route``: the
tensor-core one (``csrc/flash_attn_fwd_tc.cu``) reads q, k, v in place as
the LM's strided views of one qkv buffer and writes O as the (B, H, T, D)
view of (B, T, H, D) memory; the CUDA-core one takes contiguous copies.
Here the route is checked as a rule, and the plain version (which the
wrapper runs for CPU tensors) is fed the same strided views: it must equal
the contiguous call exactly and ``mxnet_tpu``'s Pallas kernel, run in
interpret mode, within 1e-5 absolute (f32 sums taken in another order).
The kernel itself is held to its plain version on the card (the ``cuda``
test below, and chip_smoke.py's phase b).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon import contrib as jcontrib  # noqa: E402
from mxnet_tpu.ops.pallas_kernels import (  # noqa: E402
    flash_attention as jax_flash)

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.gluon import contrib as tcontrib  # noqa: E402
from mxnet_tpu_torch.ops import kernels  # noqa: E402

TOL = 1e-5
BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


def _qkv_views(b, h, t, d, seed, dtype=F32):
    """numpy q, k, v (B, H, T, D) and the same values as torch views of one
    (B, T, 3 * H * D) buffer, the qkv projection's layout."""
    rng = np.random.RandomState(seed)
    buf = (rng.randn(b, t, 3 * h * d) * 0.3).astype(np.float32)
    x = buf.reshape(b, t, 3 * h, d).transpose(0, 2, 1, 3)
    arrays = [np.ascontiguousarray(x[:, i * h:(i + 1) * h])
              for i in range(3)]
    tx = torch.from_numpy(buf).to(dtype).reshape(b, t, 3 * h, d)
    tx = tx.transpose(1, 2)
    views = [tx[:, i * h:(i + 1) * h] for i in range(3)]
    return arrays, views


def _strides(shape):
    b, h, t, d = shape
    return (h * t * d, t * d, d, 1)


# name, dtype, d, strides of q/k/v, base addresses, t, route
ROUTES = [
    ("bf16_d64_contiguous", BF16, 64, [_strides((2, 4, 8, 64))] * 3,
     [0, 4096, 8192], 8, "tc"),
    ("fp16_d128_contiguous", F16, 128, [_strides((2, 4, 8, 128))] * 3,
     [256] * 3, 8, "tc"),
    ("bf16_qkv_views", BF16, 64, [(1024 * 2304, 64, 2304, 1)] * 3,
     [0, 1536, 3072], 1024, "tc"),
    ("fp32", F32, 64, [_strides((2, 4, 8, 64))] * 3, [0] * 3, 8, "tf32x3"),
    ("bf16_d80", BF16, 80, [_strides((2, 4, 8, 80))] * 3, [0] * 3, 8,
     "simt"),
    ("bf16_d256", BF16, 256, [_strides((2, 4, 8, 256))] * 3, [0] * 3, 8,
     "simt"),
    ("bf16_d32", BF16, 32, [_strides((2, 4, 8, 32))] * 3, [0] * 3, 8,
     "simt"),
    ("d_not_unit_stride", BF16, 64, [(4096, 1, 64, 512)] * 3, [0] * 3, 8,
     "simt"),
    ("stride_not_16_bytes", BF16, 64, [(8 * 196, 196, 3 * 65, 1)] * 3,
     [0] * 3, 8, "simt"),
    ("broadcast_zero_stride", BF16, 64, [(0, 512, 64, 1)] * 3, [0] * 3, 8,
     "simt"),
    ("base_not_16_bytes", BF16, 64, [_strides((2, 4, 8, 64))] * 3,
     [0, 2, 0], 8, "simt"),
    ("t_beyond_grid", BF16, 64, [_strides((1, 1, 8, 64))] * 3, [0] * 3,
     65535 * 128 + 1, "simt"),
]


@pytest.mark.parametrize("name,dtype,d,strides,ptrs,t,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_flash_route(name, dtype, d, strides, ptrs, t, want):
    assert kernels._flash_route(dtype, d, strides, ptrs, t) == want


def test_tma_strides_ignore_size_one_dims():
    x = torch.zeros(1, 3, 1, 64).as_strided((1, 3, 1, 64), (7, 64, 5, 1))
    assert kernels._tma_strides(x) == (3 * 64, 64, 64)
    y = torch.zeros(2, 12, 16, 3 * 64)[..., 64:128]
    assert kernels._tma_strides(y) == (12 * 16 * 192, 16 * 192, 192)


@pytest.fixture
def one_thread():
    """One intra-op thread while the test runs. Two calls of the plain
    version on the same values must then take the same arithmetic path: a
    worker loaded by other processes or by other threads of its own process
    can no longer split a product's work differently between them."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.usefixtures("one_thread")
@pytest.mark.parametrize("causal,qo,ko", [(True, 0, 0), (False, 0, 0),
                                          (True, 64, 0), (True, 0, 64)],
                         ids=["causal", "non_causal", "q_offset_64",
                              "whole_skip_k_offset_64"])
def test_strided_views_match_contiguous_and_pallas(causal, qo, ko):
    (q, k, v), views = _qkv_views(2, 3, 100, 64, seed=11)
    assert not any(t.is_contiguous() for t in views)
    kw = dict(causal=causal, return_lse=True, q_offset=qo, k_offset=ko)
    o_s, lse_s = kernels.flash_attention(*views, **kw)
    o_c, lse_c = kernels.flash_attention(*(t.contiguous() for t in views),
                                         **kw)
    env = (f"torch threads {torch.get_num_threads()}, q/k/v base mod 64 "
           f"{[t.data_ptr() % 64 for t in views]}")
    assert torch.equal(o_s, o_c) and torch.equal(lse_s, lse_c), (
        f"strided views != contiguous copies: O max diff "
        f"{(o_s - o_c).abs().max().item():.3e}, lse max diff "
        f"{(lse_s - lse_c).abs().max().item():.3e} ({env})")
    o_j, lse_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, interpret=True, return_lse=True,
                           q_offset=qo, k_offset=ko)
    o_j, lse_j = np.asarray(o_j), np.asarray(lse_j)
    if ko > qo:
        # rows that see no key follow the port's definition (O = 0), not
        # the Pallas kernel's tiling artifact (ROADMAP Queue 3); the rows
        # after them are compared below
        blind = ko - qo
        assert (o_s[:, :, :blind] == 0).all()
        o_s, lse_s = o_s[:, :, blind:], lse_s[:, :, blind:]
        o_j, lse_j = o_j[:, :, blind:], lse_j[:, :, blind:]
    np.testing.assert_allclose(o_s.numpy(), o_j, rtol=0, atol=TOL,
                               err_msg=f"O vs Pallas ({env})")
    np.testing.assert_allclose(lse_s.numpy(), lse_j, rtol=0, atol=TOL,
                               err_msg=f"lse vs Pallas ({env})")


@pytest.mark.parametrize("t", [24, 130])
def test_multi_head_attention_flash_matches_mxnet_tpu(t):
    """The model's flash path, whose q/k/v now reach the kernel as views
    (no .contiguous()), gives mxnet_tpu's outputs from the same weights."""
    jb = jcontrib.MultiHeadAttention(64, 2, impl="flash", causal=True,
                                     prefix="mha_")
    jb.initialize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX flash: CPU fallback warning
        jb(mx.nd.array(np.zeros((1, 4, 64), np.float32)))
    rng = np.random.RandomState(t)
    values = {}
    for name, p in jb.collect_params().items():
        values[name] = (rng.randn(*p.shape) * 0.2).astype(np.float32)
        p.set_data(mx.nd.array(values[name]))
    tb = tcontrib.nn.MultiHeadAttention(64, 2, impl="flash", causal=True,
                                        prefix="mha_")
    tb.initialize(ctx=mt.cpu())
    tb.load_numpy_params(values)
    x = rng.randn(2, t, 64).astype(np.float32)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jb(mx.nd.array(x)).asnumpy()
    with torch.inference_mode():
        got = tb(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_launch_counts_by_route_name_both_kernels():
    assert set(kernels.flash_attention.launches_by_route) == {
        "tc", "tf32x3", "simt"}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [BF16, F16], ids=["bf16", "fp16"])
def test_tensor_core_kernel_matches_plain_on_card(dtype):
    """On the card: the LM's strided q/k/v take the tensor-core kernel,
    whose O (a (B, T, H, D)-memory view) is within 4 output ulps of the
    plain version (1 ulp measured on the H100) and lse within 1e-3; a
    second launch is bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    _, views = _qkv_views(2, 4, 300, 64, seed=3, dtype=dtype)
    q, k, v = (t.cuda() for t in views)
    before = kernels.flash_attention.launches_by_route["tc"]
    out, lse = kernels.flash_attention(q, k, v, causal=True,
                                       return_lse=True)
    again = kernels.flash_attention(q, k, v, causal=True, return_lse=True)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches_by_route["tc"] == before + 2
    assert out.transpose(1, 2).is_contiguous()
    ref, ref_lse = kernels.flash_attention_reference(q, k, v, causal=True,
                                                     return_lse=True)
    r = ref.float().abs()
    mant = 7 if dtype == BF16 else 10
    mag = torch.maximum(r, r.max() * 2.0 ** -6)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
    assert ((out.float() - ref.float()).abs() / ulp).max().item() <= 4
    assert (lse - ref_lse).abs().max().item() <= 1e-3
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
