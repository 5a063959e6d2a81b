"""Kernel K3 on its fp32 route "tf32x3", CPU side.

fp32 convolutions that meet the route rule (Cin a multiple of 32, Cout of
64, x and w contiguous with 16-byte-aligned bases) run on the tensor cores
as 3xTF32 (``csrc/conv3x3_bn_stats_tf32x3.cu``): each f32 operand is split
into a TF32 hi part (``cvt.rna``) and a TF32 lo part, and a product a b is
taken as lo_a hi_b + hi_a lo_b + hi_a hi_b with f32 accumulation; a
pre-pass packs w into TF32 hi and lo panels in (9, Cout, Cin) K-major
order. Here the route rule is checked as a rule, the pre-pass's
plain version (``kernels.conv_weight_tf32x3_pack_reference``) bit by bit,
and the conv with every product so emulated against ``mxnet_tpu``'s Pallas
K3 in interpret mode within chip_smoke.py phase b's tf32x3 tolerance,
TF32X3_TOL = 1e-5 of max|ref| on y, sum and sumsq. On these cases the
emulation reads at most 1.1e-6 (y), 4.1e-7 (sum) and 3.8e-7 (sumsq); one
TF32 pass (hi_a hi_b alone) reads at least 2.5e-4, 2.0e-4 and 1.4e-4 and
misses it on each by more than 10x, so the tolerance has teeth. The
kernel itself is held to its plain version on the card (the ``cuda`` tests
below, and chip_smoke.py).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.ops import _build, kernels  # noqa: E402

F32, BF16, F16 = torch.float32, torch.bfloat16, torch.float16
RESNET_3X3 = ((56, 64), (28, 128), (14, 256), (7, 512))
TF32X3_TOL = 1e-5            # chip_smoke.py's CONV_TF32X3_TOL

# name, dtype, cin, cout, contiguous, (x, w) base addresses, route
ROUTES = [
    ("fp32_64", F32, 64, 64, True, (0, 4096), "tf32x3"),
    ("fp32_cin_32", F32, 32, 64, True, (16, 32), "tf32x3"),
    ("fp32_512_to_64", F32, 512, 64, True, (0, 0), "tf32x3"),
    ("fp32_64_to_512", F32, 64, 512, True, (0, 0), "tf32x3"),
    ("fp32_cin_96", F32, 96, 128, True, (0, 0), "tf32x3"),
    ("fp32_cin_5", F32, 5, 64, True, (0, 0), "simt"),
    ("fp32_cin_48", F32, 48, 64, True, (0, 0), "simt"),
    ("fp32_cout_13", F32, 64, 13, True, (0, 0), "simt"),
    ("fp32_cout_96", F32, 64, 96, True, (0, 0), "simt"),
    ("fp32_not_contiguous", F32, 64, 64, False, (0, 0), "simt"),
    ("fp32_x_base_not_16_bytes", F32, 64, 64, True, (4, 0), "simt"),
    ("fp32_w_base_not_16_bytes", F32, 64, 64, True, (0, 8), "simt"),
    ("bf16_64", BF16, 64, 64, True, (0, 0), "tc"),
    ("fp16_128_512", F16, 128, 512, True, (0, 0), "tc"),
    ("bf16_cin_32", BF16, 32, 64, True, (0, 0), "simt"),
]


@pytest.mark.parametrize("name,dtype,cin,cout,contiguous,ptrs,want", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_conv_route(name, dtype, cin, cout, contiguous, ptrs, want):
    assert kernels._conv_route(dtype, cin, cout, contiguous, ptrs) == want


def _bits(t):
    return t.contiguous().view(torch.int32)


def test_weight_pack_is_the_split_in_k_major_order():
    """wpack[p, 3 kh + kw, co, ci] is part p (0 hi, 1 lo) of
    tf32_split_reference(w)[kh, kw, ci, co], bit for bit."""
    rng = np.random.RandomState(3)
    cin, cout = 32, 64
    w = torch.from_numpy((rng.randn(3, 3, cin, cout) * 0.05)
                         .astype(np.float32))
    pack = kernels.conv_weight_tf32x3_pack_reference(w)
    assert pack.shape == (2, 9, cout, cin) and pack.dtype == F32
    assert pack.is_contiguous()
    hi, lo = kernels.tf32_split_reference(w)
    assert int((_bits(pack) & 0x1FFF).abs().max()) == 0
    for p, part in enumerate((hi, lo)):
        for kh in range(3):
            for kw in range(3):
                want = part[kh, kw].transpose(0, 1)          # (cout, cin)
                assert torch.equal(_bits(pack[p, 3 * kh + kw]), _bits(want))
    # hi + lo holds w to ~2^-22 of |w|
    rebuilt = (pack[0].double() + pack[1].double()).reshape(3, 3, cout, cin)
    err = (rebuilt.permute(0, 1, 3, 2) - w.double()).abs() / w.double().abs()
    assert err.max().item() <= 2.0 ** -22


def _inputs(n, h, w, cin, cout, seed):
    """x ~ N(0, 1) and w scaled by 1/sqrt(9 Cin), so y ~ N(0, 1), as
    chip_smoke.py phase b draws them."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) / np.sqrt(9 * cin)).astype(np.float32)
    return x, wt


def _conv(x, w):
    """The 3x3 SAME conv of NHWC x and HWIO w in f32 on the CPU."""
    return F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                    padding=1).permute(0, 2, 3, 1)


def _emulated(x, w, passes):
    """y, sum, sumsq with every product as the kernel takes it: 3 passes
    conv(x_lo, w_hi) + conv(x_hi, w_lo) + conv(x_hi, w_hi) of TF32 parts
    (each product of two TF32 values is exact in f32; the sums are f32), or
    1 pass conv(x_hi, w_hi)."""
    xh, xl = kernels.tf32_split_reference(x)
    wh, wl = kernels.tf32_split_reference(w)
    acc = _conv(xh, wh)
    if passes == 3:
        acc = (_conv(xl, wh) + _conv(xh, wl)) + acc
    return acc, acc.sum(dim=(0, 1, 2)), (acc * acc).sum(dim=(0, 1, 2))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / np.abs(b).max()


# N, H, W, Cin, Cout: 32 and 64 channels, M = N H W not a multiple of a
# tile's 64 or 128 rows, N = 1, H != W, Cin != Cout
CASES = [(2, 7, 7, 32, 64), (1, 5, 9, 64, 64), (3, 6, 6, 64, 128),
         (1, 8, 8, 32, 128)]


@pytest.mark.parametrize("n,h,w,cin,cout", CASES,
                         ids=["x".join(map(str, c)) for c in CASES])
def test_tf32x3_math_holds_phase_b_tolerance(n, h, w, cin, cout):
    """The conv with 3xTF32-emulated products against mxnet_tpu's Pallas
    K3 (interpret mode) in fp32: y, sum and sumsq within TF32X3_TOL of
    max|ref|; one TF32 pass misses it on each."""
    x, wt = _inputs(n, h, w, cin, cout, seed=n * h * w + cout)
    y_j, s_j, q_j = (np.asarray(t) for t in jpk.conv3x3_bn_stats(
        jnp.asarray(x), jnp.asarray(wt), interpret=True))
    tx, tw = torch.from_numpy(x), torch.from_numpy(wt)
    errs = {}
    for passes in (3, 1):
        y, s, q = _emulated(tx, tw, passes)
        errs[passes] = (_rel(y, y_j), _rel(s, s_j), _rel(q, q_j))
    msg = (f"3xTF32 y, sum, sumsq {['%.2e' % e for e in errs[3]]}; one "
           f"TF32 pass {['%.2e' % e for e in errs[1]]} (tol {TF32X3_TOL:g})")
    assert max(errs[3]) <= TF32X3_TOL, msg
    assert min(errs[1]) > TF32X3_TOL, msg


def test_cpu_call_counts_no_launch_and_builds_nothing():
    """Inputs the 3xTF32 route would take, on the CPU: the plain version,
    no launch counted, no library built."""
    before = dict(kernels.conv3x3_bn_stats.launches_by_route)
    x, w = (torch.from_numpy(t) for t in _inputs(1, 5, 6, 32, 64, seed=4))
    assert kernels._conv_route(x.dtype, 32, 64, True,
                               (x.data_ptr(), w.data_ptr())) == "tf32x3"
    y, s, q = kernels.conv3x3_bn_stats(x, w)
    yr, sr, qr = kernels.conv3x3_bn_stats_reference(x, w)
    assert all(torch.equal(a, b) for a, b in ((y, yr), (s, sr), (q, qr)))
    assert kernels.conv3x3_bn_stats.launches_by_route == before
    assert set(before) == {"tc", "tf32x3", "simt"}
    assert "conv3x3_bn_stats_tf32x3" not in _build._libs
    assert "conv3x3_bn_stats_tf32x3" in _build.SOURCES


def test_build_failure_raises_and_takes_no_other_path(monkeypatch):
    """A failed build of the 3xTF32 kernel is an MXNetError: no move to
    the CUDA-core route or to the plain version, and no launch counted."""
    def broken():
        raise MXNetError("nvcc failed to build")

    monkeypatch.setattr(kernels, "_conv_tf32x3_library", broken)
    monkeypatch.setattr(kernels, "_conv_library", broken)
    monkeypatch.setattr(kernels, "conv3x3_bn_stats_reference", broken)
    x, w = (torch.from_numpy(t) for t in _inputs(1, 4, 4, 64, 64, seed=2))
    before = dict(kernels.conv3x3_bn_stats.launches_by_route)
    with pytest.raises(MXNetError, match="nvcc"):
        kernels._launch_conv(x, w)
    assert kernels.conv3x3_bn_stats.launches_by_route == before


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the kernel has no CPU mode "
                    "(chip_smoke.py runs it on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("hw,c", RESNET_3X3,
                         ids=[f"{hw}x{hw}x{c}" for hw, c in RESNET_3X3])
def test_tf32x3_route_matches_plain_on_card(hw, c):
    """On the card, N=2: the 3xTF32 route gives y, sum and sumsq within
    TF32X3_TOL of max|ref| of the plain version (TF32 off), one launch
    counted on "tf32x3" per call, and a second launch bitwise equal."""
    _need_card()
    x, w = (torch.from_numpy(t).cuda()
            for t in _inputs(2, hw, hw, c, c, seed=hw))
    before = dict(kernels.conv3x3_bn_stats.launches_by_route)
    got = kernels.conv3x3_bn_stats(x, w)
    again = kernels.conv3x3_bn_stats(x, w)
    torch.cuda.synchronize()
    after = kernels.conv3x3_bn_stats.launches_by_route
    assert after["tf32x3"] == before["tf32x3"] + 2
    assert after["simt"] == before["simt"]
    ref = kernels.conv3x3_bn_stats_reference(x, w)
    for a, b in zip(got, ref):
        assert _rel(a.cpu().numpy(), b.cpu().numpy()) <= TF32X3_TOL
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_weight_pack_matches_plain_on_card():
    """The pre-pass kernel writes the plain version's packed weight, bit
    for bit."""
    _need_card()
    rng = np.random.RandomState(6)
    w = torch.from_numpy(rng.randn(3, 3, 96, 128).astype(np.float32)).cuda()
    got = kernels._launch_pack_w_tf32x3(w)
    want = kernels.conv_weight_tf32x3_pack_reference(w)
    assert torch.equal(_bits(got), _bits(want))
