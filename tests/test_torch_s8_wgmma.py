"""K5's s8 wgmma route: its fixed route rule and the layout its pre-pass
makes, on the CPU.

``ops.quantization._s8_route`` names the kernel of each int8 conv and GEMM
on CUDA: "wgmma" (``csrc/s8_gemm_wgmma.cu``) or "mma_s8"
(``csrc/s8_gemm.cu``). It is held here to ResNet-18 v1's 11 conv shapes,
its FC and the ragged and misaligned cases ``chip_smoke.py`` checks on the
card, pointers passed in as integers. ``s8_conv_pack_reference`` (the
pre-pass's plain version: NHWC data with padded channels, or the KW taps
folded into the channels for a few-channel input such as the stem's, and
the (Cout, KH, KW', cp) weight) is held exactly to ``mxnet_tpu``'s
``_s8_conv``: a float64 channels-last conv over the laid-out operands
against ``_s8_conv`` under ("NCHW", "OIHW", "NCHW"), inputs from numpy
seeds. The ``cuda`` tests hold both routes, and the conv's fused
requantize epilogues (``s8_conv_requant``) with the batch-range
requantize, to their plain versions on the card.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch.ops import quantization as tops  # noqa: E402

# ResNet-18 v1 at 224^2: (Cin, Cout, H = W in, kernel, stride, pad), as
# chip_smoke.R18_CONVS without the counts
R18_CONVS = ((3, 64, 224, 7, 2, 3), (64, 64, 56, 3, 1, 1),
             (64, 128, 56, 3, 2, 1), (128, 128, 28, 3, 1, 1),
             (64, 128, 56, 1, 2, 0), (128, 256, 28, 3, 2, 1),
             (256, 256, 14, 3, 1, 1), (128, 256, 28, 1, 2, 0),
             (256, 512, 14, 3, 2, 1), (512, 512, 7, 3, 1, 1),
             (256, 512, 14, 1, 2, 0))
# the convs of tests/test_torch_quantization.py:CONV_CASES with one group:
# (N, Cin, H, W, Cout, k, stride, pad, dilate)
CONV_CASES = [
    (2, 8, 9, 9, 16, 3, 1, 1, 1),
    (2, 8, 10, 11, 16, 3, 2, 1, 1),
    (1, 3, 23, 23, 16, 7, 2, 3, 1),          # the stem: K = 147
    (2, 16, 8, 8, 32, 1, 2, 0, 1),           # a 1x1 downsample
    (2, 5, 12, 9, 8, 3, 1, 0, 2),            # dilation 2, K = 45
    (1, 64, 7, 7, 64, 3, 1, 1, 1),           # K = 576
]


def _conv(kernel, stride, pad, dilate=1):
    return tops._s8_route("conv", kernel=(kernel,) * 2, stride=(stride,) * 2,
                          pad=(pad,) * 2, dilate=(dilate,) * 2)


@pytest.mark.parametrize("shape", R18_CONVS, ids=str)
def test_route_takes_every_resnet18_conv_on_wgmma(shape):
    _, _, _, k, s, p = shape
    assert _conv(k, s, p) == "wgmma"


@pytest.mark.parametrize("m, k, n, off, want", [
    (128, 512, 1000, 0, "wgmma"),        # the FC at bucket 128
    (8, 512, 1000, 0, "wgmma"),          # phase b's FC
    (77, 45, 70, 0, "mma_s8"),           # ragged: K off a multiple of 16
    (33, 64, 96, 5, "mma_s8"),           # misaligned bases
    (33, 64, 96, 16, "wgmma"),           # the same, 16 bytes in
])
def test_route_of_gemms(m, k, n, off, want):
    base = 1 << 20   # a 256-byte-aligned address, as the allocator's
    x_ptr = base + off
    w_ptr = base + 4096 + off
    assert tops._s8_route("matmul", k=k, ptrs=(x_ptr, w_ptr)) == want
    assert tops._s8_route("matmul", k=k, ptrs=(base, w_ptr)) == want


@pytest.mark.parametrize("kernel, stride, pad, dilate, want", [
    (3, 1, 1, 1, "wgmma"),       # Cin 5, odd 13 x 11 (the pre-pass pads)
    (3, 1, 2, 2, "wgmma"),       # dilation 2
    (3, 2, 0, 1, "wgmma"),       # ragged M: 1 x 9 x 7, stride 2, no pad
    (1, 1, 0, 1, "wgmma"),       # misaligned bases (the pre-pass copies)
    (3, 8, 1, 1, "wgmma"),       # TMA's largest element stride
    (3, 9, 1, 1, "mma_s8"),      # past it
    (3, 1, 128, 1, "wgmma"),     # the box's lower corner at -128
    (3, 1, 129, 1, "mma_s8"),    # past it
    (3, 1, 1, 63, "wgmma"),      # the last tap's offset at 126
    (3, 1, 1, 64, "mma_s8"),     # at 128: past 127
])
def test_route_of_conv_geometry(kernel, stride, pad, dilate, want):
    assert _conv(kernel, stride, pad, dilate) == want


@pytest.mark.parametrize("c, kernel, stride, pad, dilate, want", [
    (3, 7, 2, 3, 1, (7, 32, 224, 1)),     # the stem: 7 taps x 3 -> 32
    (64, 3, 1, 1, 1, (1, 64, 576, 3)),
    (64, 1, 2, 0, 1, (1, 64, 64, 1)),
    (128, 3, 2, 1, 1, (1, 128, 1152, 3)),
    (512, 3, 1, 1, 1, (1, 512, 4608, 3)),
    (5, 3, 1, 1, 1, (3, 16, 64, 1)),      # K = 48 -> whole 32-byte stages
    (16, 3, 1, 2, 2, (1, 16, 160, 3)),    # folding would not shrink K
    (48, 1, 1, 0, 1, (1, 48, 64, 1)),
])
def test_pack_layout(c, kernel, stride, pad, dilate, want):
    pk = tops._s8_pack(c, (kernel,) * 2, (stride,) * 2, (pad,) * 2,
                       (dilate,) * 2)
    assert (pk.fold, pk.cp, pk.kpad, pk.kw) == want
    assert pk.kpad % 32 == 0 and pk.kpad >= kernel * pk.kw * pk.cp
    if pk.fold > 1:
        assert (pk.stride_w, pk.pad_w, pk.dilate_w) == (1, 0, 1)


PACK_CASES = [
    # (N, Cin, H, W, Cout, k, stride, pad, dilate)
    (2, 3, 30, 30, 16, 7, 2, 3, 1),      # the stem's geometry, Cin 3
    (2, 64, 9, 9, 64, 3, 1, 1, 1),       # 64 channels
    (2, 64, 11, 11, 32, 3, 2, 1, 1),
    (2, 5, 13, 11, 24, 3, 1, 1, 1),      # odd sizes, folded
    (2, 16, 15, 17, 8, 3, 1, 2, 2),      # dilation 2
    (1, 48, 10, 10, 16, 1, 1, 0, 1),
    (2, 3, 11, 13, 8, 3, 2, 1, 2),       # folded with stride and dilation
]


@pytest.mark.parametrize("case", PACK_CASES, ids=str)
def test_packed_operands_give_mxnet_tpu_s8_conv(case):
    import jax
    import jax.numpy as jnp

    from mxnet_tpu.ops import quantization as jops

    n, cin, h, w, cout, k, s, p, d = case
    rng = np.random.RandomState(sum(case))
    x = rng.randint(-127, 128, (n, cin, h, w)).astype(np.int8)
    wt = rng.randint(-127, 128, (cout, cin, k, k)).astype(np.int8)
    dn = jax.lax.conv_dimension_numbers(x.shape, wt.shape,
                                        ("NCHW", "OIHW", "NCHW"))
    want = np.asarray(jops._s8_conv(jnp.asarray(x), jnp.asarray(wt), (s, s),
                                    [(p, p)] * 2, (d, d), dn, 1))
    st, pd, dl = (s, s), (p, p), (d, d)
    xp, wp = tops.s8_conv_pack_reference(torch.from_numpy(x),
                                         torch.from_numpy(wt), st, pd, dl)
    pk = tops._s8_pack(cin, (k, k), st, pd, dl)
    assert xp.dtype == wp.dtype == torch.int8
    assert wp.shape == (cout, pk.kpad) and xp.shape[3] == pk.cp
    kk = k * pk.kw * pk.cp
    assert not wp[:, kk:].any()                # zeros past the last tap
    # the kernel's conv, channels-last in float64, over the laid-out
    # operands: KH x KW' taps, the W axis's stride, pad and dilation
    w4 = wp[:, :kk].reshape(cout, k, pk.kw, pk.cp).permute(0, 3, 1, 2)
    got = F.conv2d(xp.permute(0, 3, 1, 2).double(), w4.double(), None,
                   (s, pk.stride_w), (p, pk.pad_w), (d, pk.dilate_w))
    np.testing.assert_array_equal(got.to(torch.int32).numpy(), want)


@pytest.mark.parametrize("case", PACK_CASES[:4], ids=str)
def test_pack_of_channels_last_equals_channels_first(case):
    n, cin, h, w, cout, k, s, p, d = case
    rng = np.random.RandomState(sum(case) + 1)
    x = torch.from_numpy(rng.randint(-127, 128, (n, cin, h, w))
                         .astype(np.int8))
    wt = torch.from_numpy(rng.randint(-127, 128, (cout, cin, k, k))
                          .astype(np.int8))
    args = ((s, s), (p, p), (d, d))
    first = tops.s8_conv_pack_reference(x, wt, *args)
    last = tops.s8_conv_pack_reference(x.permute(0, 2, 3, 1),
                                       wt.permute(0, 2, 3, 1), *args,
                                       layout="NHWC")
    assert all(torch.equal(a, b) for a, b in zip(first, last))


def test_warpgroup_rule():
    assert [tops._s8_warpgroups(c) for c in (24, 64, 65, 128, 512)] == \
        [1, 1, 2, 2, 2]


# ------------------------------------------------------ on the card
@pytest.mark.cuda
@pytest.mark.parametrize("case", CONV_CASES, ids=str)
def test_both_routes_equal_the_plain_version_on_the_card(case, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    n, cin, h, w, cout, k, s, p, d = case
    gen = torch.Generator(device="cuda").manual_seed(sum(case))
    x = torch.randint(-127, 128, (n, cin, h, w), generator=gen,
                      device="cuda", dtype=torch.int8)
    wt = torch.randint(-127, 128, (cout, cin, k, k), generator=gen,
                       device="cuda", dtype=torch.int8)
    bias = torch.randint(-2 ** 20, 2 ** 20, (cout,), generator=gen,
                         device="cuda", dtype=torch.int32)
    args = ((s, s), (p, p), (d, d))
    with torch.backends.cudnn.flags(enabled=False):
        want = tops.s8_conv_reference(x, wt, *args, bias=bias)
        want_last = tops.s8_conv_reference(
            x.permute(0, 2, 3, 1).contiguous(),
            wt.permute(0, 2, 3, 1).contiguous(), *args, layout="NHWC",
            bias=bias)
    for route in ("wgmma", "mma_s8"):
        monkeypatch.setattr(tops, "_s8_route", lambda *a, r=route, **kw: r)
        before = tops.s8_conv.launches_by_route[route]
        assert torch.equal(tops.s8_conv(x, wt, *args, bias=bias), want)
        assert tops.s8_conv.launches_by_route[route] == before + 1
    monkeypatch.setattr(tops, "_s8_route", lambda *a, **kw: "wgmma")
    got = tops.s8_conv(x.permute(0, 2, 3, 1).contiguous(),
                       wt.permute(0, 2, 3, 1).contiguous(), *args,
                       layout="NHWC", bias=bias)
    assert torch.equal(got, want_last)
    with pytest.raises(mt.MXNetError, match="ROADMAP"):
        tops.s8_conv(x, wt, *args, num_group=2)


@pytest.mark.cuda
def test_fused_conv_and_batch_range_on_the_card():
    """The conv's fused epilogues (relu, then a calibrated requantize or
    the batch range) and the requantize computing its own range, bitwise
    equal to their plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    rng = np.random.RandomState(16)
    x = torch.from_numpy(rng.randint(-127, 128, (4, 64, 14, 14))
                         .astype(np.int8)).cuda()
    w = torch.from_numpy(rng.randint(-127, 128, (128, 64, 3, 3))
                         .astype(np.int8)).cuda()
    bias = torch.from_numpy(rng.randint(-2 ** 16, 2 ** 16, (128,))
                            .astype(np.int32)).cuda()
    args = (x, w, (1, 1), (1, 1), (1, 1), None, bias)
    rin = torch.tensor(2.0 ** 31 * 2.0 / (5376.0 * 24.0), device="cuda")
    lo, hi = (torch.tensor(v, device="cuda") for v in (-3.0, 2.5))
    with torch.backends.cudnn.flags(enabled=False):
        for scal in ({"out_min": lo, "out_max": hi}, {}):
            got = tops.s8_conv_requant(*args, real_in=rin, relu=True,
                                       **scal)
            want = tops.s8_conv_requant_reference(*args, real_in=rin,
                                                  relu=True, **scal)
            assert all(torch.equal(g, v) for g, v in zip(got, want))
    d = want[0]
    got = tops.requant_epilogue(d, rin)
    word = tops.requant_range_reference(d, rin)
    ref = tops.requant_epilogue_reference(d, rin, -word, word)
    assert all(torch.equal(g, v) for g, v in zip(got, ref))
