"""One packed qkv gradient on the LM's path (PyTorch port, CPU side).

``ops/kernels.flash_attention_qkv`` runs K1 on the three head views of the
qkv projection's output (B, T, 3 H D) and, in its backward, has K2 write
dq, dk and dv straight into one (B, T, 3H, D) gradient through their
strides, so autograd has nothing to scatter. ``MultiHeadAttention
(impl='flash')`` goes through it. On the CPU K2's plain version fills the
same packed buffer, so these tests exercise the layout code: the packed
gradient must equal, bitwise, the one autograd scatters back from the
three-view Function (``flash_attention_with_grad``), and match
``mxnet_tpu``'s ``MultiHeadAttention(impl='flash')`` gradients from the
same numpy weights and inputs within 1e-5 of the largest value (f32 sums
in other orders). The kernel writing through the strides is held to the
same plain version on the card (the ``cuda`` test below, and
chip_smoke.py's phase b).
"""
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon import contrib as jcontrib  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.gluon import contrib as tcontrib  # noqa: E402
from mxnet_tpu_torch.ops import kernels  # noqa: E402

TOL = 1e-5
SENTINEL = -7.25


def _buf(b, t, h, d, seed, dtype=torch.float32):
    rng = np.random.RandomState(seed)
    return torch.from_numpy(
        (rng.randn(b, t, 3 * h * d) * 0.3).astype(np.float32)).to(dtype)


def _views(x, h):
    b, t, c = x.shape
    y = x.reshape(b, t, 3 * h, c // (3 * h)).transpose(1, 2)
    return y[:, :h], y[:, h:2 * h], y[:, 2 * h:]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("shape", [(2, 40, 3, 16), (1, 130, 2, 64)],
                         ids=["t40_d16", "t130_d64"])
def test_packed_gradient_equals_three_view_gradient_bitwise(shape, causal):
    b, t, h, d = shape
    x = _buf(b, t, h, d, seed=t)
    w = torch.from_numpy(np.random.RandomState(1).randn(b, h, t, d)
                         .astype(np.float32))
    a = x.clone().requires_grad_(True)
    out_a = kernels.flash_attention_qkv(a, h, causal=causal)
    (out_a * w).sum().backward()
    bx = x.clone().requires_grad_(True)
    out_b = kernels.flash_attention_with_grad(*_views(bx, h), causal=causal)
    (out_b * w).sum().backward()
    assert torch.equal(out_a, out_b)
    assert a.grad.shape == x.shape and a.grad.is_contiguous()
    assert torch.equal(a.grad, bx.grad)


def test_backward_builds_one_gradient_and_counts_no_launch():
    """The packed Function's backward hands autograd the projection's
    gradient itself (no slice-and-scatter nodes), and on the CPU no
    kernel is launched or built."""
    before = kernels.flash_attention_backward.launches
    x = _buf(1, 24, 2, 16, seed=3).requires_grad_(True)
    out = kernels.flash_attention_qkv(x, 2, causal=True)
    assert type(out.grad_fn).__name__ == "_FlashAttentionQKVBackward"
    assert out.grad_fn.next_functions[0][0].variable is x
    out.sum().backward()
    assert kernels.flash_attention_backward.launches == before
    assert torch.isfinite(x.grad).all()


@pytest.mark.parametrize("bad", [(2, 8, 95), (2, 8), "not a tensor"])
def test_packed_rejects_what_is_not_a_qkv_buffer(bad):
    x = torch.zeros(bad) if isinstance(bad, tuple) else bad
    with pytest.raises(ValueError):
        kernels.flash_attention_qkv(x, 2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
def test_plain_backward_writes_through_strides_and_spares_the_rest(dtype):
    """grads given as head views of a larger (B, T, 4H, D) buffer
    prefilled with a sentinel: dq, dk, dv land in their heads bitwise as
    the plain version returns them, and every other element keeps the
    sentinel."""
    b, t, h, d = 2, 50, 2, 32
    q, k, v = (y.contiguous() for y in _views(_buf(b, t, h, d, 5, dtype), h))
    dout = torch.from_numpy(np.random.RandomState(6).randn(b, h, t, d)
                            .astype(np.float32)).to(dtype)
    out, lse = kernels.flash_attention(q, k, v, causal=True,
                                       return_lse=True)
    want = kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                            causal=True)
    big = torch.full((b, t, 4 * h, d), SENTINEL, dtype=dtype)
    heads = big.transpose(1, 2)
    grads = (heads[:, 3 * h:], heads[:, :h], heads[:, 2 * h:3 * h])
    got = kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                           causal=True, grads=grads)
    assert all(g is x for g, x in zip(got, grads))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    assert (heads[:, h:2 * h] == SENTINEL).all()


@pytest.mark.parametrize("bad", ["shape", "dtype", "d_stride", "count"])
def test_backward_rejects_grads_it_cannot_write(bad):
    q = torch.zeros(1, 2, 8, 16)
    lse = torch.zeros(1, 2, 8, 1)
    grads = [torch.zeros(1, 2, 8, 16) for _ in range(3)]
    if bad == "shape":
        grads[1] = torch.zeros(1, 2, 9, 16)
    elif bad == "dtype":
        grads[2] = grads[2].half()
    elif bad == "d_stride":
        grads[0] = torch.zeros(1, 2, 16, 8).transpose(2, 3)
    else:
        grads = grads[:2]
    with pytest.raises(ValueError):
        kernels.flash_attention_backward(q, q, q, q, lse, q, grads=grads)


@pytest.mark.parametrize("t", [24, 130])
def test_multi_head_attention_gradients_match_mxnet_tpu(t):
    """MultiHeadAttention(impl='flash') forward and backward (the packed
    Function on the plain K1 and K2) against mxnet_tpu's from the same
    numpy weights and inputs: outputs, the input's gradient and every
    parameter's gradient within 1e-5 of max(1, their largest value)."""
    units, heads = 64, 2
    jb = jcontrib.MultiHeadAttention(units, heads, impl="flash",
                                     causal=True, prefix="mha_")
    jb.initialize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX flash: CPU fallback warning
        jb(mx.nd.array(np.zeros((1, 4, units), np.float32)))
    rng = np.random.RandomState(t)
    values = {}
    for name, p in jb.collect_params().items():
        values[name] = (rng.randn(*p.shape) * 0.2).astype(np.float32)
        p.set_data(mx.nd.array(values[name]))
    tb = tcontrib.nn.MultiHeadAttention(units, heads, impl="flash",
                                        causal=True, prefix="mha_")
    tb.initialize(ctx=mt.cpu())
    tb.load_numpy_params(values)
    x = rng.randn(2, t, units).astype(np.float32)
    w = rng.randn(2, t, units).astype(np.float32)

    jx = mx.nd.array(x)
    jx.attach_grad()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with mx.autograd.record():
            jy = jb(jx)
            jloss = (jy * mx.nd.array(w)).sum()
        jloss.backward()
    tx = torch.from_numpy(x).requires_grad_(True)
    with mt.autograd.record():
        ty = tb(tx)
        tloss = (ty * torch.from_numpy(w)).sum()
    tloss.backward()

    def close(got, want, name):
        # f32 sums of up to 2 T products in other orders
        np.testing.assert_allclose(got, want, rtol=0, err_msg=name,
                                   atol=TOL * max(1.0, np.abs(want).max()))

    close(ty.detach().numpy(), jy.asnumpy(), "out")
    close(tx.grad.numpy(), jx.grad.asnumpy(), "d(x)")
    tparams = tb._param_objects()
    for name, p in jb.collect_params().items():
        close(tparams[name].grad().numpy(), p.grad().asnumpy(), name)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_packed_gradient_on_card_matches_plain(dtype):
    """On the card: the packed Function's d(qkv), written by the
    tensor-core K2 through the (B, T, 3H, D) strides, within 4 output ulps
    of the plain version's three gradients, and its second run bitwise
    equal; one K2 launch on the tensor-core route per backward."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    b, t, h, d = 2, 300, 4, 64
    x = _buf(b, t, h, d, seed=8, dtype=dt).cuda()
    w = torch.randn(b, h, t, d, generator=torch.Generator().manual_seed(2)
                    ).to(dt).cuda()
    grads = []
    for _ in range(2):
        leaf = x.clone().requires_grad_(True)
        before = kernels.flash_attention_backward.launches_by_route["tc"]
        (kernels.flash_attention_qkv(leaf, h, causal=True).float()
         * w.float()).sum().backward()
        torch.cuda.synchronize()
        assert kernels.flash_attention_backward.launches_by_route["tc"] == \
            before + 1
        grads.append(leaf.grad)
    assert torch.equal(grads[0], grads[1])
    q, k, v = _views(x, h)
    out, lse = kernels.flash_attention(q, k, v, causal=True,
                                       return_lse=True)
    ref = kernels.flash_attention_backward_reference(q, k, v, out, lse, w,
                                                     causal=True)
    mant = 7 if dt == torch.bfloat16 else 10
    for g, r in zip(_views(grads[0], h), ref):
        rf = r.float().abs()
        mag = torch.maximum(rf, rf.max() * 2.0 ** -6)
        ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
        assert ((g.float() - r.float()).abs() / ulp).max().item() <= 4
