"""Kernels K1 and K2 on their fp32 route "tf32x3", CPU side.

fp32 attention that meets the tensor-core layout rule runs on the tensor
cores as 3xTF32 (``csrc/flash_attn_fwd_tf32x3.cu``,
``csrc/flash_attn_bwd_tf32x3.cu``): each f32 operand is split into a TF32
hi part (``cvt.rna``: nearest, ties away from zero) and a TF32 lo part,
and a product a b is taken as lo_a hi_b + hi_a lo_b + hi_a hi_b with f32
accumulation. Here the split's plain version
(``kernels.tf32_split_reference``) is checked bit by bit, K1's and K2's
plain math with every product so emulated is held to ``mxnet_tpu``'s fp32
flash attention (Pallas forward in interpret mode, its blockwise backward
through ``jax.grad``) within chip_smoke.py phase b's fp32 tolerances (1e-4
absolute on O and lse, 1e-4 of max|grad| on dq, dk, dv) -- which one TF32
pass would miss -- and the route rule is checked as a rule. The kernels
themselves are held to their plain versions on the card (the ``cuda``
tests below, and chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch.ops import _build, kernels  # noqa: E402

O_TOL = 1e-4      # K1: O and lse, absolute (phase b's tol32)
GRAD_TOL = 1e-4   # K2: dq, dk, dv, of max|ref| (phase b's tol32)
F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
NEG = -1e30


def _bits(x):
    return x.contiguous().view(torch.int32)


def _rna_numpy(x):
    """Round f32 values to TF32 (11 significant bits), nearest with ties
    away from zero, by frexp in float64: an independent statement of what
    cvt.rna.tf32.f32 computes."""
    x = x.astype(np.float64)
    m, e = np.frexp(x)                 # |m| in [0.5, 1)
    scaled = np.abs(m) * 2.0 ** 11     # [1024, 2048)
    r = np.sign(m) * np.floor(scaled + 0.5) / 2.0 ** 11
    return np.ldexp(r, e).astype(np.float32)


def _samples(seed=0, n=4096):
    rng = np.random.RandomState(seed)
    mag = 10.0 ** rng.uniform(-30, 30, n)
    return (rng.choice([-1.0, 1.0], n) * mag).astype(np.float32)


def test_split_hi_and_lo_keep_ten_mantissa_bits():
    x = torch.from_numpy(_samples())
    hi, lo = kernels.tf32_split_reference(x)
    assert hi.dtype == lo.dtype == F32
    assert int((_bits(hi) & 0x1FFF).abs().max()) == 0
    assert int((_bits(lo) & 0x1FFF).abs().max()) == 0


def test_split_reconstructs_to_two_to_minus_22():
    x = torch.from_numpy(_samples(seed=1))
    hi, lo = kernels.tf32_split_reference(x)
    rel = ((hi.double() + lo.double() - x.double()).abs()
           / x.double().abs()).max().item()
    assert rel <= 2.0 ** -22, f"hi + lo off by {rel:.3e} of |x|"
    # one TF32 part alone keeps ~2^-11
    rel_hi = ((hi.double() - x.double()).abs() / x.double().abs()).max()
    assert 2.0 ** -13 < rel_hi.item() <= 2.0 ** -11


def test_split_rounds_as_cvt_rna():
    ties = np.array([1 + 2 ** -11, 1 + 3 * 2 ** -11, -(1 + 2 ** -11),
                     -(1 + 3 * 2 ** -11), 2 ** -20 * (1 + 2 ** -11)],
                    np.float32)
    want = np.array([1 + 2 ** -10, 1 + 2 ** -9, -(1 + 2 ** -10),
                     -(1 + 2 ** -9), 2 ** -20 * (1 + 2 ** -10)],
                    np.float32)
    hi, _ = kernels.tf32_split_reference(torch.from_numpy(ties))
    np.testing.assert_array_equal(hi.numpy(), want)   # ties away from zero
    below = np.nextafter(np.float32(1 + 2 ** -11), np.float32(0))
    hi, _ = kernels.tf32_split_reference(torch.tensor([below]))
    assert hi.item() == 1.0
    x = _samples(seed=2)
    hi, lo = kernels.tf32_split_reference(torch.from_numpy(x))
    np.testing.assert_array_equal(hi.numpy(), _rna_numpy(x))
    np.testing.assert_array_equal(lo.numpy(),
                                  _rna_numpy(x - hi.numpy()))


def test_split_keeps_inf_and_nan():
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, -0.0])
    hi, _ = kernels.tf32_split_reference(x)
    assert torch.equal(_bits(hi[[0, 1, 3, 4]]), _bits(x[[0, 1, 3, 4]]))
    assert torch.isnan(hi[2])


# --------------------------------------------------- 3xTF32-emulated math
def _mm(a, b, passes):
    """a @ b as the kernels take it: 3 passes lo_a hi_b + hi_a lo_b +
    hi_a hi_b of TF32 parts in f32 (each product of two TF32 values is
    exact in f32), or 1 pass hi_a hi_b."""
    ah, al = kernels.tf32_split_reference(a)
    bh, bl = kernels.tf32_split_reference(b)
    if passes == 1:
        return ah @ bh
    return (al @ bh + ah @ bl) + ah @ bh


def _visible(t, causal, qo, ko):
    pos = torch.arange(t)
    if not causal:
        return torch.ones(t, t, dtype=torch.bool)
    return (qo + pos)[:, None] >= (ko + pos)[None, :]


def _fwd(q, k, v, causal, qo, ko, passes):
    t, d = q.shape[-2:]
    s = _mm(q, k.transpose(-1, -2), passes) * (1.0 / np.sqrt(d))
    s = s.masked_fill(~_visible(t, causal, qo, ko), float("-inf"))
    m = s.amax(-1, keepdim=True).clamp_min(NEG)
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-20)
    return _mm(p, v, passes) / l, m + torch.log(l)


def _bwd(q, k, v, out, lse, dout, dlse, causal, qo, ko, passes):
    t, d = q.shape[-2:]
    scale = 1.0 / np.sqrt(d)
    delta = (dout * out).sum(-1, keepdim=True) - dlse
    s = _mm(q, k.transpose(-1, -2), passes) * scale
    s = s.masked_fill(~_visible(t, causal, qo, ko), float("-inf"))
    p = torch.exp(s - lse)
    ds = p * (_mm(dout, v.transpose(-1, -2), passes) - delta)
    return (_mm(ds, k, passes) * scale,
            _mm(ds.transpose(-1, -2), q, passes) * scale,
            _mm(p.transpose(-1, -2), dout, passes))


def _arrays(shape, seed, n):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) for _ in range(n)]


# (B, H, T, D), causal, q_offset, k_offset; every row sees a key (rows
# that see none follow the port's definition, not Pallas's: ROADMAP
# Queue 3)
CASES = [
    ("causal_d64", (1, 2, 128, 64), True, 0, 0),
    ("non_causal_ragged_t100_d64", (1, 2, 100, 64), False, 0, 0),
    ("causal_d128", (1, 1, 128, 128), True, 0, 0),
    ("q_offset_64", (1, 2, 128, 64), True, 64, 0),
    ("k_offset_32_under_q_offset_96", (1, 1, 128, 64), True, 96, 32),
]


@pytest.mark.parametrize("name,shape,causal,qo,ko", CASES,
                         ids=[c[0] for c in CASES])
def test_tf32x3_math_holds_phase_b_tolerance(name, shape, causal, qo, ko):
    """K1 and K2 with every product taken as the kernels take it, against
    mxnet_tpu's fp32 flash attention (Pallas in interpret mode, and
    jax.grad through its custom_vjp for the gradients of a loss on O and
    lse), on N(0, 1) inputs as chip_smoke.py phase b draws them."""
    q, k, v, wo = _arrays(shape, seed=len(name), n=4)
    wl = _arrays(shape[:3] + (1,), seed=5, n=1)[0]
    o_ref, lse_ref = jpk.flash_attention(
        *map(jnp.asarray, (q, k, v)), causal=causal, interpret=True,
        return_lse=True, q_offset=qo, k_offset=ko)
    o_ref, lse_ref = np.asarray(o_ref), np.asarray(lse_ref)

    def loss(q, k, v):
        o, lse = jpk.flash_attention_with_lse(
            q, k, v, causal=causal, interpret=True, q_offset=qo, k_offset=ko)
        return jnp.sum(o * wo) + jnp.sum(lse * wl)

    g_ref = [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))]

    tq, tk, tv, two, twl = map(torch.from_numpy, (q, k, v, wo, wl))
    errs = {}
    for passes in (3, 1):
        out, lse = _fwd(tq, tk, tv, causal, qo, ko, passes)
        grads = _bwd(tq, tk, tv, out, lse, two, twl, causal, qo, ko, passes)
        errs[passes] = (
            np.abs(out.numpy() - o_ref).max(),
            np.abs(lse.numpy() - lse_ref).max(),
            max(np.abs(g.numpy() - r).max() / np.abs(r).max()
                for g, r in zip(grads, g_ref)))
    (o3, l3, g3), (o1, l1, g1) = errs[3], errs[1]
    msg = (f"3xTF32: O {o3:.3e}, lse {l3:.3e}, grads {g3:.3e} of max|grad| "
           f"(tol {O_TOL:g}, {O_TOL:g}, {GRAD_TOL:g}); one TF32 pass: O "
           f"{o1:.3e}, lse {l1:.3e}, grads {g1:.3e}")
    assert o3 <= O_TOL and l3 <= O_TOL and g3 <= GRAD_TOL, msg
    # the tolerance has teeth: one TF32 pass misses it
    assert max(o1 / O_TOL, l1 / O_TOL, g1 / GRAD_TOL) > 1.0, msg


# ------------------------------------------------------------ the route rule
def _strides(b, h, t, d):
    return (h * t * d, t * d, d, 1)


def _lm(b, h, t, d):
    """The LM's q/k/v views of one (B, T, 3 H D) buffer."""
    return (t * 3 * h * d, d, 3 * h * d, 1)


# name, dtype, d, strides of each operand, base addresses, t, route
ROUTES = [
    ("fp32_d64", F32, 64, _strides(2, 4, 8, 64), 0, 8, "tf32x3"),
    ("fp32_d128", F32, 128, _strides(2, 4, 8, 128), 16, 8, "tf32x3"),
    ("fp32_lm_views", F32, 64, _lm(8, 12, 1024, 64), 0, 1024, "tf32x3"),
    ("fp32_d80", F32, 80, _strides(2, 4, 8, 80), 0, 8, "simt"),
    ("fp32_d256", F32, 256, _strides(2, 4, 8, 256), 0, 8, "simt"),
    ("fp32_d32", F32, 32, _strides(2, 4, 8, 32), 0, 8, "simt"),
    ("fp32_base_4_bytes", F32, 64, _strides(2, 4, 8, 64), 4, 8, "simt"),
    ("fp32_row_stride_2", F32, 64, (8 * 66, 66, 66 * 4 + 2, 1), 0, 8,
     "simt"),
    ("fp32_d_not_unit_stride", F32, 64, (4096, 1, 64, 512), 0, 8, "simt"),
    ("fp32_t_at_grid_edge", F32, 64, _strides(1, 1, 8, 64), 0, 65535 * 64,
     "tf32x3"),
    ("fp32_t_past_grid", F32, 64, _strides(1, 1, 8, 64), 0,
     65535 * 64 + 1, "simt"),
    ("fp32_d128_t_at_grid_edge", F32, 128, _strides(1, 1, 8, 128), 0,
     65535 * 64, "tf32x3"),
    ("fp32_d128_t_past_grid", F32, 128, _strides(1, 1, 8, 128), 0,
     65535 * 64 + 1, "simt"),
    ("bf16_stride_4_elements", BF16, 64, (8 * 68, 68, 68 * 4 + 4, 1), 0, 8,
     "simt"),
    ("bf16_d64", BF16, 64, _strides(2, 4, 8, 64), 0, 8, "tc"),
    ("fp16_d128", F16, 128, _strides(2, 4, 8, 128), 0, 8, "tc"),
    ("float64", torch.float64, 64, _strides(2, 4, 8, 64), 0, 8, "simt"),
]


@pytest.mark.parametrize("name,dtype,d,st,ptr,t,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_rule(name, dtype, d, st, ptr, t, want):
    """fp32 takes "tf32x3" where the tensor-core layout rule holds (D 64
    or 128, unit stride in D, the other strides positive multiples of 16
    bytes, 16-byte-aligned bases, T within the grid), the CUDA cores
    elsewhere; K1 and K2 share the rule."""
    assert kernels._TF32_MAX_T == 65535 * 64
    assert kernels._flash_route(dtype, d, [st] * 3, [ptr] * 3, t) == want
    assert kernels._flash_bwd_route(dtype, d, [st] * 5, [ptr] * 5,
                                    t) == want


def test_cpu_fp32_runs_plain_and_builds_nothing():
    """fp32 CPU tensors that the tf32x3 route would take run the plain
    versions: no launch counted on any route, no library built."""
    q = torch.randn(1, 2, 64, 64, requires_grad=True)
    k1 = dict(kernels.flash_attention.launches_by_route)
    k2 = dict(kernels.flash_attention_backward.launches_by_route)
    out = kernels.flash_attention_with_grad(q, q, q, causal=True)
    out.sum().backward()
    torch.testing.assert_close(
        out, kernels.flash_attention_reference(q, q, q, causal=True),
        rtol=0, atol=0)
    assert kernels.flash_attention.launches_by_route == k1
    assert kernels.flash_attention_backward.launches_by_route == k2
    assert set(k1) == set(k2) == {"tc", "tf32x3", "simt"}
    for name in ("flash_attn_fwd_tf32x3", "flash_attn_bwd_tf32x3"):
        assert name in _build.SOURCES and name not in _build._libs


# ------------------------------------------------------------------ the card
def _card_inputs(d, seed):
    b, h, t = 2, 4, 300
    gen = torch.Generator().manual_seed(seed)
    buf = torch.randn(b, t, 3 * h * d, generator=gen).cuda()
    x = buf.reshape(b, t, 3 * h, d).transpose(1, 2)
    dout = torch.randn(b, t, h, d, generator=gen).cuda().transpose(1, 2)
    return x[:, :h], x[:, h:2 * h], x[:, 2 * h:], dout


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_tf32x3_kernels_match_plain_on_card(d):
    """On the card: K1 and K2 on the LM's strided fp32 q/k/v take route
    "tf32x3" and hold their plain versions (O and lse within 1e-4; dq, dk,
    dv within 1e-4 of max|ref|); a second launch is bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, k, v, dout = _card_inputs(d, seed=d)
    k1 = kernels.flash_attention.launches_by_route["tf32x3"]
    k2 = kernels.flash_attention_backward.launches_by_route["tf32x3"]
    out, lse = kernels.flash_attention(q, k, v, causal=True, return_lse=True)
    again = kernels.flash_attention(q, k, v, causal=True, return_lse=True)
    got = kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                           causal=True)
    got2 = kernels.flash_attention_backward(q, k, v, out, lse, dout,
                                            causal=True)
    torch.cuda.synchronize()
    assert kernels.flash_attention.launches_by_route["tf32x3"] == k1 + 2
    assert kernels.flash_attention_backward.launches_by_route["tf32x3"] == \
        k2 + 2
    ref, ref_lse = kernels.flash_attention_reference(q, k, v, causal=True,
                                                     return_lse=True)
    assert (out - ref).abs().max().item() <= O_TOL
    assert (lse - ref_lse).abs().max().item() <= O_TOL
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    want = kernels.flash_attention_backward_reference(q, k, v, out, lse,
                                                      dout, causal=True)
    for g, g2, r in zip(got, got2, want):
        assert torch.equal(g, g2)
        assert ((g - r).abs().max() / r.abs().max()).item() <= GRAD_TOL
