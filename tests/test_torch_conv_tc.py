"""Kernel K3's tensor-core route in the PyTorch port, CPU side.

K3 has three CUDA kernels, chosen by ``ops/kernels.py:_conv_route``: the
tensor-core one (``csrc/conv3x3_bn_stats_tc.cu``: bf16/fp16, Cin and Cout
multiples of 64, contiguous, 16-byte aligned) with tiles from
``_conv_tiles``, the fp32 3xTF32 one (``csrc/conv3x3_bn_stats_tf32x3.cu``,
tests/test_torch_conv_tf32x3.py) and the CUDA-core one
(``csrc/conv3x3_bn_stats.cu``) for everything else. Here the route and
the tile rule are checked as rules; the plain version, which the wrapper
runs for CPU tensors, is held to
``mxnet_tpu``'s Pallas K3 in interpret mode at 64-channel shapes within the
tolerances of tests/test_torch_conv_bn.py (y 1e-5, sum 1e-4, sumsq 1e-3
absolute: f32 sums in other orders). The kernel itself is held to its plain
version on the card (the ``cuda`` tests below, and chip_smoke.py's phase b).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import _build, kernels  # noqa: E402

BF16, F16, F32 = torch.bfloat16, torch.float16, torch.float32
RESNET_3X3 = ((56, 64), (28, 128), (14, 256), (7, 512))
SMS = 132                    # the H100 SXM's streaming multiprocessors
# 16-bit sum and sumsq on the card, max|a - b| / max|ref| (chip_smoke.py's
# CONV_STATS_TOL_16): below what statistics of the rounded y would read
STATS_TOL_16 = 5e-5

# name, dtype, cin, cout, contiguous, (x, w) base addresses, route
ROUTES = [
    ("bf16_64", BF16, 64, 64, True, (0, 4096), "tc"),
    ("fp16_128_512", F16, 128, 512, True, (256, 16), "tc"),
    ("fp32", F32, 64, 64, True, (0, 0), "tf32x3"),
    ("float64", torch.float64, 64, 64, True, (0, 0), "simt"),
    ("cin_5", BF16, 5, 64, True, (0, 0), "simt"),
    ("cin_96", BF16, 96, 64, True, (0, 0), "simt"),
    ("cout_13", F16, 64, 13, True, (0, 0), "simt"),
    ("cout_32", BF16, 64, 32, True, (0, 0), "simt"),
    ("not_contiguous", BF16, 64, 64, False, (0, 0), "simt"),
    ("x_base_not_16_bytes", BF16, 64, 64, True, (2, 0), "simt"),
    ("w_base_not_16_bytes", BF16, 64, 64, True, (0, 8), "simt"),
]


@pytest.mark.parametrize("name,dtype,cin,cout,contiguous,ptrs,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_conv_route(name, dtype, cin, cout, contiguous, ptrs, want):
    assert kernels._conv_route(dtype, cin, cout, contiguous, ptrs) == want


def _grid(m_total, cout, bm, bn):
    return -(-m_total // bm) * (cout // bn)


@pytest.mark.parametrize("hw,c", RESNET_3X3,
                         ids=[f"{hw}x{hw}x{c}" for hw, c in RESNET_3X3])
def test_tile_rule_fills_the_card_at_resnet_shapes(hw, c):
    """At N=32 every ResNet-50 3x3 shape gets at least one CTA for each
    of the H100's 132 SMs."""
    m = 32 * hw * hw
    bm, bn = kernels._conv_tiles(m, c, SMS)
    assert c % bn == 0
    assert _grid(m, c, bm, bn) >= SMS
    # the largest tile that does so, in the rule's (measured) order
    want = {(56, 64): (128, 64), (28, 128): (128, 128),
            (14, 256): (64, 128), (7, 512): (64, 64)}[(hw, c)]
    assert (bm, bn) == want


@pytest.mark.parametrize("n,h,w,cout", [
    (4, 7, 7, 512), (1, 28, 28, 128), (3, 7, 7, 64), (2, 9, 11, 128),
    (8, 14, 14, 64), (4, 14, 14, 256), (1, 56, 56, 64), (2, 3, 3, 1024)])
def test_tile_rule_takes_64x64_where_no_tiling_fills_the_card(n, h, w, cout):
    """A grid that no tiling fills takes the smallest tiles; otherwise the
    first tiling in the rule's order that gives every SM a CTA."""
    m = n * h * w
    bm, bn = kernels._conv_tiles(m, cout, SMS)
    fills = [(a, b) for a, b in kernels._CONV_TILES
             if cout % b == 0 and _grid(m, cout, a, b) >= SMS]
    assert (bm, bn) == (fills[0] if fills else (64, 64))


@pytest.mark.parametrize("sms", [114, 132])
def test_tile_rule_over_many_shapes(sms):
    """Every choice divides Cout, and a tiling other than 64 x 64 fills the
    card it was chosen for (an H100 PCIe has 114 SMs, an SXM 132)."""
    rng = np.random.RandomState(0)
    for _ in range(500):
        m = int(rng.randint(1, 200000))
        cout = 64 * int(rng.randint(1, 17))
        bm, bn = kernels._conv_tiles(m, cout, sms)
        assert bm in (64, 128) and bn in (64, 128) and cout % bn == 0
        if (bm, bn) != (64, 64):
            assert _grid(m, cout, bm, bn) >= sms


def _inputs(n, h, w, cin, cout, seed):
    """x ~ N(0, 1) and w scaled by 1/sqrt(9 Cin), so y ~ N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    return x, wt


def test_cpu_call_counts_no_launch_and_builds_nothing():
    """Inputs the tensor-core route would take, on the CPU: the plain
    version, no launch counted on either route, no library built."""
    before = kernels.conv3x3_bn_stats.launches
    by_route = dict(kernels.conv3x3_bn_stats.launches_by_route)
    x, w = (torch.from_numpy(t).bfloat16() for t in _inputs(1, 5, 6, 64, 128,
                                                            seed=1))
    assert kernels._conv_route(x.dtype, 64, 128, True,
                               (x.data_ptr(), w.data_ptr())) == "tc"
    y, s, q = kernels.conv3x3_bn_stats(x, w)
    assert y.shape == (1, 5, 6, 128) and y.dtype == BF16
    assert s.dtype == q.dtype == F32 and s.shape == (128,)
    assert kernels.conv3x3_bn_stats.launches == before
    assert kernels.conv3x3_bn_stats.launches_by_route == by_route
    assert set(by_route) == {"tc", "tf32x3", "simt"}
    assert "conv3x3_bn_stats_tc" not in _build._libs
    assert "conv3x3_bn_stats_tc" in _build.SOURCES


@pytest.mark.parametrize("dtype,route", [(BF16, "tc"), (F32, "simt"),
                                         (F32, "tf32x3")])
def test_build_failure_raises_and_takes_no_other_path(monkeypatch, dtype,
                                                      route):
    """A failed build of the chosen kernel is an MXNetError: no move to the
    other route or to the plain version, and no launch counted."""
    def broken():
        raise MXNetError("nvcc failed to build")

    monkeypatch.setattr(kernels, "_conv_tc_library", broken)
    monkeypatch.setattr(kernels, "_conv_tf32x3_library", broken)
    monkeypatch.setattr(kernels, "_conv_library", broken)
    monkeypatch.setattr(kernels, "conv3x3_bn_stats_reference", broken)
    cin, cout = (5, 13) if route == "simt" else (64, 64)
    x, w = (torch.from_numpy(t).to(dtype) for t in _inputs(1, 4, 4, cin,
                                                           cout, seed=2))
    assert kernels._conv_route(dtype, cin, cout, True, (0, 0)) == route
    before = dict(kernels.conv3x3_bn_stats.launches_by_route)
    with pytest.raises(MXNetError, match="nvcc"):
        kernels._launch_conv(x, w)
    assert kernels.conv3x3_bn_stats.launches_by_route == before


@pytest.mark.parametrize("n,h,w,cin,cout", [(2, 7, 7, 64, 64),
                                            (1, 5, 9, 64, 128),
                                            (1, 4, 4, 128, 64)])
def test_plain_matches_pallas_interpret_at_64_channels(n, h, w, cin, cout):
    x, wt = _inputs(n, h, w, cin, cout, seed=n * h + cout)
    y_j, s_j, q_j = jpk.conv3x3_bn_stats(jnp.asarray(x), jnp.asarray(wt),
                                         interpret=True)
    y, s, q = kernels.conv3x3_bn_stats(torch.from_numpy(x),
                                       torch.from_numpy(wt))
    assert y.shape == (n, h, w, cout)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=0, atol=1e-3)


def _ulps(got, ref):
    """Largest |got - ref| in bf16/fp16 output ulps, the floor at 2^-6 of
    max|ref| (chip_smoke.ulp_err)."""
    mant = 7 if ref.dtype == BF16 else 10
    r = ref.float().abs()
    mag = torch.maximum(r, r.max() * 2.0 ** -6)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - mant)
    return ((got.float() - ref.float()).abs() / ulp).max().item()


def _rel(a, b):
    return ((a - b).abs().max() / b.abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c", RESNET_3X3,
                         ids=[f"{hw}x{hw}x{c}" for hw, c in RESNET_3X3])
def test_tensor_core_route_matches_plain_on_card(hw, c):
    """On the card, N=2: the tensor-core route (tiles by the rule) gives y
    within 2 output ulps of the plain version (1 measured on the H100),
    sums within STATS_TOL_16 relative, and a second launch bitwise equal;
    one launch counted on "tc" per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, w = (torch.from_numpy(t).cuda().bfloat16()
            for t in _inputs(2, hw, hw, c, c, seed=hw))
    before = dict(kernels.conv3x3_bn_stats.launches_by_route)
    y, s, q = kernels.conv3x3_bn_stats(x, w)
    again = kernels.conv3x3_bn_stats(x, w)
    torch.cuda.synchronize()
    after = kernels.conv3x3_bn_stats.launches_by_route
    assert after["tc"] == before["tc"] + 2
    assert after["simt"] == before["simt"]
    yr, sr, qr = kernels.conv3x3_bn_stats_reference(x, w)
    assert _ulps(y, yr) <= 2
    assert _rel(s, sr) <= STATS_TOL_16 and _rel(q, qr) <= STATS_TOL_16
    assert all(torch.equal(a, b) for a, b in zip((y, s, q), again))
