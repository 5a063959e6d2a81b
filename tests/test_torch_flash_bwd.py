"""Kernel K2 of the PyTorch port (flash-attention backward), CPU side.

On the CPU ``mxnet_tpu_torch.ops.kernels.flash_attention_backward`` runs
its plain version. It must compute what ``mxnet_tpu``'s blockwise backward
(``_flash_bwd_blockwise``) computes on the same f32 inputs, within 1e-5
absolute (f32 sums in another order), and the K1 + K2 autograd Function
must give the gradients ``jax.vjp`` gives through ``mxnet_tpu``'s
``flash_attention_with_grad`` / ``_with_lse`` in Pallas interpret mode.
Where a row sees no key, the port's gradient is zero (``mxnet_tpu``'s is
not: ROADMAP Queue 3), so those rows are compared with the port's own
definition only. The CUDA kernel is held to the same plain version on the
card by chip_smoke.py and the ``cuda``-marked test below.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch.ops import _build, kernels  # noqa: E402
from mxnet_tpu_torch.ops import nn as tnn  # noqa: E402

TOL = 1e-5


def _arrays(shape, seed, n=4):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * 0.3).astype(np.float32) for _ in range(n)]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# name, (B, H, T, D), causal, q_offset, k_offset, with dlse; every row sees
# at least one key
CASES = [
    ("causal_d64", (2, 2, 256, 64), True, 0, 0, False),
    ("non_causal_d64", (2, 2, 256, 64), False, 0, 0, False),
    ("causal_d128", (1, 2, 256, 128), True, 0, 0, False),
    ("causal_d32", (1, 2, 256, 32), True, 0, 0, False),
    ("causal_ragged_t200", (1, 2, 200, 64), True, 0, 0, False),
    ("non_causal_ragged_t200_d32", (1, 1, 200, 32), False, 0, 0, False),
    ("causal_dlse", (1, 2, 256, 64), True, 0, 0, True),
    ("non_causal_dlse_ragged", (1, 2, 200, 64), False, 0, 0, True),
    ("q_offset_96", (1, 2, 256, 64), True, 96, 0, False),
    ("k_offset_64_under_q_offset_128", (1, 2, 256, 64), True, 128, 64,
     True),
]


@pytest.mark.parametrize("name,shape,causal,qo,ko,with_dlse", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_jax_blockwise(name, shape, causal, qo, ko, with_dlse):
    q, k, v, dout = _arrays(shape, seed=len(name))
    out, lse = kernels.flash_attention(*_t(q, k, v), causal=causal,
                                       return_lse=True, q_offset=qo,
                                       k_offset=ko)
    dlse = _arrays(shape[:3] + (1,), seed=7, n=1)[0] if with_dlse else None
    scale = 1.0 / np.sqrt(shape[-1])
    want = jpk._flash_bwd_blockwise(
        *map(jnp.asarray, (q, k, v, out.numpy(), lse.numpy(), dout)), scale,
        causal, 64, dlse=None if dlse is None else jnp.asarray(dlse),
        q_offset=qo, k_offset=ko)
    got = kernels.flash_attention_backward(
        *_t(q, k, v), out, lse, torch.from_numpy(dout), causal=causal,
        dlse=None if dlse is None else torch.from_numpy(dlse), q_offset=qo,
        k_offset=ko)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and tuple(g.shape) == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def _jax_grads(fn, q, k, v, wo, wl=None):
    def loss(q, k, v):
        res = fn(q, k, v)
        if wl is None:
            return jnp.sum(res * wo)
        return jnp.sum(res[0] * wo) + jnp.sum(res[1] * wl)

    return jax.grad(loss, argnums=(0, 1, 2))(q, k, v)


def _port_grads(fn, q, k, v, wo, wl=None):
    leaves = [x.clone().requires_grad_(True) for x in _t(q, k, v)]
    res = fn(*leaves)
    if wl is None:
        loss = (res * torch.from_numpy(wo)).sum()
    else:
        loss = (res[0] * torch.from_numpy(wo)).sum() + \
            (res[1] * torch.from_numpy(wl)).sum()
    loss.backward()
    return [x.grad for x in leaves]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_with_grad_matches_jax_vjp_interpret(causal):
    """flash_attention_with_grad through torch.autograd against jax.grad of
    mxnet_tpu's (Pallas forward in interpret mode, blockwise backward), as
    tests/test_attention_block.py runs it."""
    shape = (1, 2, 128, 64)
    q, k, v, wo = _arrays(shape, seed=11)
    want = _jax_grads(lambda *a: jpk.flash_attention_with_grad(
        *a, causal=causal, interpret=True), q, k, v, wo)
    got = _port_grads(lambda *a: kernels.flash_attention_with_grad(
        *a, causal=causal), q, k, v, wo)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


@pytest.mark.parametrize("qo,ko", [(0, 0), (64, 0), (128, 32)],
                         ids=["no_offset", "q_offset", "both_offsets"])
def test_with_lse_matches_jax_vjp_interpret(qo, ko):
    """A loss on O and lse: the lse cotangent reaches K2's plain version as
    dlse (ring attention's merge), as mxnet_tpu's custom_vjp passes it."""
    shape = (1, 2, 128, 64)
    q, k, v, wo = _arrays(shape, seed=12 + qo)
    wl = _arrays(shape[:3] + (1,), seed=3, n=1)[0]
    want = _jax_grads(lambda *a: jpk.flash_attention_with_lse(
        *a, causal=True, interpret=True, q_offset=qo, k_offset=ko),
        q, k, v, wo, wl)
    got = _port_grads(lambda *a: kernels.flash_attention_with_lse(
        *a, causal=True, q_offset=qo, k_offset=ko), q, k, v, wo, wl)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=TOL)


def test_function_matches_dense_autograd():
    """The K1 + K2 Function gives the gradients autograd takes through
    the dense attention composition (impl='xla')."""
    q, k, v, wo = _arrays((2, 3, 100, 16), seed=9)
    flash = _port_grads(lambda *a: tnn.scaled_dot_product_attention(
        *a, causal=True, impl="flash"), q, k, v, wo)
    dense = _port_grads(lambda *a: tnn.scaled_dot_product_attention(
        *a, causal=True), q, k, v, wo)
    for a, b in zip(flash, dense):
        torch.testing.assert_close(a, b, rtol=0, atol=TOL)


def test_rows_that_see_no_key_get_zero_gradient():
    """Under k_offset=64 rows 0..63 see no key (O = 0, a constant): their
    dq is exactly 0 and their dO adds nothing to dk or dv, bitwise."""
    shape = (1, 2, 128, 64)
    q, k, v, dout = _t(*_arrays(shape, seed=5))
    kw = dict(causal=True, k_offset=64)
    out, lse = kernels.flash_attention(q, k, v, return_lse=True, **kw)
    dq, dk, dv = kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                                  **kw)
    assert (dq[:, :, :64] == 0).all() and (dq[:, :, 64:] != 0).any()
    blind = dout.clone()
    blind[:, :, :64] = 0
    _, dk2, dv2 = kernels.flash_attention_backward(q, k, v, out, lse, blind,
                                                   **kw)
    assert torch.equal(dk, dk2) and torch.equal(dv, dv2)
    # the same through the autograd Function, with a nonzero lse cotangent
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o, l = kernels.flash_attention_with_lse(*leaves, **kw)
    ((o * dout).sum() + l[:, :, 64:].sum()).backward()
    assert (leaves[0].grad[:, :, :64] == 0).all()
    assert all(torch.isfinite(x.grad).all() for x in leaves)


def test_unused_lse_cotangent_is_no_term():
    """dlse=None (an unused lse) is the same as a zero dlse, and 16-bit
    inputs give gradients in their own dtype."""
    shape = (1, 2, 64, 32)
    q, k, v, dout = _t(*_arrays(shape, seed=8))
    out, lse = kernels.flash_attention(q, k, v, causal=True, return_lse=True)
    a = kernels.flash_attention_backward(q, k, v, out, lse, dout, causal=True)
    b = kernels.flash_attention_backward(q, k, v, out, lse, dout, causal=True,
                                         dlse=torch.zeros_like(lse))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    for dtype in (torch.bfloat16, torch.float16):
        args = [x.to(dtype) for x in (q, k, v, out)]
        grads = kernels.flash_attention_backward(
            *args, lse, dout.to(dtype), causal=True, scale=0.5)
        assert all(g.dtype == dtype for g in grads)


@pytest.mark.parametrize("bad", ["out_shape", "dout_dtype", "lse_shape",
                                 "lse_dtype", "dlse_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 2, 8, 16)
    out, dout = q.clone(), q.clone()
    lse, dlse = torch.zeros(1, 2, 8, 1), None
    if bad == "out_shape":
        out = torch.zeros(1, 2, 9, 16)
    elif bad == "dout_dtype":
        dout = dout.double()
    elif bad == "lse_shape":
        lse = torch.zeros(1, 2, 8)
    elif bad == "lse_dtype":
        lse = lse.half()
    else:
        dlse = torch.zeros(1, 2, 8, 2)
    with pytest.raises(ValueError):
        kernels.flash_attention_backward(q, q, q, out, lse, dout, dlse=dlse)


def test_cpu_backward_counts_no_launch_and_builds_nothing():
    before = kernels.flash_attention_backward.launches
    q = torch.randn(1, 2, 40, 16, requires_grad=True)
    kernels.flash_attention_with_grad(q, q, q, causal=True).sum().backward()
    assert q.grad is not None
    assert kernels.flash_attention_backward.launches == before
    assert set(kernels.flash_attention_backward.launches_by_route) == {
        "tc", "tf32x3", "simt"}
    assert "flash_attn_bwd" not in _build._libs
    assert "flash_attn_bwd_tc" not in _build._libs
    assert "flash_attn_bwd_tf32x3" not in _build._libs
    assert {"flash_attn_bwd", "flash_attn_bwd_tc",
            "flash_attn_bwd_tf32x3"} <= set(_build.SOURCES)


def _edit_header(tmp_path, monkeypatch, header):
    """(sources that include csrc/``header``, sources whose library name
    changes when it is edited), on a copy of csrc/."""
    import shutil

    for f in _build.CSRC.iterdir():
        shutil.copy(f, tmp_path / f.name)
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = {n: _build._paths(n)[1].name for n in _build.SOURCES}
    users = {n for n in _build.SOURCES
             if header in [h.name
                           for h in _build._headers(tmp_path / f"{n}.cu")]}
    path = tmp_path / header
    path.write_text(path.read_text() + "// edited\n")
    after = {n: _build._paths(n)[1].name for n in _build.SOURCES}
    return users, {n for n in _build.SOURCES if before[n] != after[n]}


def test_build_digest_covers_included_headers(tmp_path, monkeypatch):
    """Editing csrc/hopper.cuh changes the library name of every source
    that includes it (so each is rebuilt) and of no other source."""
    users, changed = _edit_header(tmp_path, monkeypatch, "hopper.cuh")
    assert users == {"flash_attn_fwd_tc", "flash_attn_bwd_tc",
                     "flash_attn_fwd_tf32x3", "flash_attn_bwd_tf32x3",
                     "conv3x3_bn_stats_tc", "conv3x3_bn_stats_tf32x3",
                     "paged_decode_attn_int8", "s8_gemm_wgmma"}
    assert changed == users


def test_build_digest_covers_the_shared_statistics_header(tmp_path,
                                                          monkeypatch):
    """csrc/bn_stats.cuh (K3's fixed-order statistics reduction) is
    included by K3's three sources, and editing it rebuilds those three
    alone."""
    users, changed = _edit_header(tmp_path, monkeypatch, "bn_stats.cuh")
    assert users == {"conv3x3_bn_stats", "conv3x3_bn_stats_tc",
                     "conv3x3_bn_stats_tf32x3"}
    assert changed == users


def test_build_digest_covers_the_decode_combine_header(tmp_path,
                                                       monkeypatch):
    """csrc/decode_combine.cuh (K4's fixed-order combine) is included by
    K4's two split sources, and editing it rebuilds those two alone."""
    users, changed = _edit_header(tmp_path, monkeypatch,
                                  "decode_combine.cuh")
    assert users == {"paged_decode_attn", "paged_decode_attn_int8"}
    assert changed == users


def test_build_digest_covers_the_requantize_header(tmp_path, monkeypatch):
    """csrc/requant.cuh (K5's requantize arithmetic) is included by the
    standalone requantize and by the int8 conv, whose fused epilogue uses
    it, and editing it rebuilds those two alone."""
    users, changed = _edit_header(tmp_path, monkeypatch, "requant.cuh")
    assert users == {"requant_int8", "s8_gemm_wgmma"}
    assert changed == users


def _lm_strides(b, h, t, d):
    """(B, H, T, D) strides of the LM's q/k/v views of one (B, T, 3 H D)
    buffer, and of K1's (B, T, H, D)-memory O and the matching dO."""
    return [(t * 3 * h * d, d, 3 * h * d, 1)] * 3 + [(t * h * d, d, h * d,
                                                      1)] * 2


BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32


@pytest.mark.parametrize("dtype,d,strides,ptrs,t,want", [
    (BF16, 64, _lm_strides(8, 12, 1024, 64), [0, 128, 256, 0, 0], 1024,
     "tc"),
    (F16, 128, _lm_strides(2, 4, 300, 128), [16] * 5, 300, "tc"),
    (F32, 64, _lm_strides(2, 4, 256, 64), [0] * 5, 256, "tf32x3"),
    (BF16, 80, _lm_strides(1, 2, 300, 80), [0] * 5, 300, "simt"),
    (BF16, 256, _lm_strides(1, 2, 256, 256), [0] * 5, 256, "simt"),
    (BF16, 64, _lm_strides(2, 4, 256, 64), [0, 0, 0, 0, 8], 256, "simt"),
    (BF16, 64, [(64 * 3, 64 * 3, 3, 1)] * 5, [0] * 5, 64, "simt"),
    (BF16, 64, _lm_strides(1, 1, 65535 * 64, 64), [0] * 5, 65535 * 64,
     "tc"),
    (BF16, 64, _lm_strides(1, 1, 65535 * 64 + 1, 64), [0] * 5,
     65535 * 64 + 1, "simt"),
], ids=["lm_bf16", "fp16_d128", "fp32", "d80", "d256", "misaligned_dout",
        "row_stride_not_8", "t_at_grid_edge", "t_past_grid"])
def test_backward_route_rule(dtype, d, strides, ptrs, t, want):
    """The tensor-core K2 takes 16-bit ("tc") and fp32 ("tf32x3") D 64/128
    operands whose rows are 16-byte aligned (the LM's strided layout among
    them) and T up to its grids' 65535 tiles of (at least) 64 rows; the
    CUDA-core kernel everything else."""
    assert kernels._BWD_TC_MAX_T == 65535 * 64
    assert kernels._flash_bwd_route(dtype, d, strides, ptrs, t) == want


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [("float32", 64), ("bfloat16", 64),
                                     ("float16", 128)])
def test_kernel_matches_plain_on_card(dtype, d):
    """On the card: K2 on the LM's strided q/k/v, K1's O and a strided dO
    (fp32 as 3xTF32 and bf16 and fp16 D=128 on the tensor cores, wgmma +
    TMA), against its plain version (fp32 within 1e-4 of max|ref|;
    16-bit within 4 output ulps); a second launch is bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    dt = getattr(torch, dtype)
    b, h, t = 2, 4, 300
    gen = torch.Generator().manual_seed(4)
    buf = torch.randn(b, t, 3 * h * d, generator=gen).to(dt).cuda()
    x = buf.reshape(b, t, 3 * h, d).transpose(1, 2)
    q, k, v = x[:, :h], x[:, h:2 * h], x[:, 2 * h:]
    dout = torch.randn(b, t, h, d, generator=gen).to(dt).cuda().transpose(1, 2)
    out, lse = kernels.flash_attention(q, k, v, causal=True, return_lse=True)
    route = "tf32x3" if dt == torch.float32 else "tc"
    before = kernels.flash_attention_backward.launches_by_route[route]
    got = kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                           causal=True)
    again = kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                             causal=True)
    torch.cuda.synchronize()
    assert kernels.flash_attention_backward.launches_by_route[route] == \
        before + 2
    ref = kernels.flash_attention_backward_reference(q, k, v, out, lse, dout,
                                                     causal=True)
    for g, r, a in zip(got, ref, again):
        assert torch.equal(g, a)
        if dt == torch.float32:
            err = (g - r).abs().max() / r.abs().max()
            assert err.item() <= 1e-4
        else:
            rf = r.float().abs()
            mag = torch.maximum(rf, rf.max() * 2.0 ** -6)
            mant = 7 if dt == torch.bfloat16 else 10
            ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
            assert ((g.float() - r.float()).abs() / ulp).max().item() <= 4
