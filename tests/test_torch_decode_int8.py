"""K4's int8 route in the PyTorch port: the KV write and the route rule.

The int8 write (``ops/decode_attention.py:kv_quantize_write``) quantizes
one layer's K and V rows and scatters them, with their scales, into the
page pool. On the CPU it takes its plain version, which must be bitwise
``mxnet_tpu``'s ``kv_quantize`` plus ``.at[page_idx, slot_idx].set``
(``mxnet_tpu/gluon/model_zoo/transformer.py:_page_scatter``) for bf16, fp16
and fp32 rows, read through the strides of the qkv projection's views, with
all-zero rows, exact .5 ties and rows whose ends reach +-127. Page 0 (the
scratch page every inactive row writes) is left out of the comparison.

The read side's route rule (``_decode_route``) is checked as a rule. The
kernels themselves (``csrc/paged_decode_attn_int8.cu``,
``csrc/kv_quantize_write.cu``) are held to their plain versions on the card
by the ``cuda`` tests below and by chip_smoke.py's phase b.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402
from mxnet_tpu.ops import decode_attention as jda  # noqa: E402

from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402
from mxnet_tpu_torch.ops import decode_attention as tda  # noqa: E402

DTYPES = {"float32": (torch.float32, np.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16),
          "float16": (torch.float16, np.float16)}


def _top_amax(tdtype):
    """An amax whose scale, rounded in ``tdtype``, falls below amax / 127,
    so that amax / scale exceeds 127 (by less than half: a scale rounded
    to nearest never takes a row past +-127.5, and the clip keeps the
    rest)."""
    for a in np.linspace(1.0, 4.0, 3001):
        amax = torch.tensor(a, dtype=tdtype)
        scale = (amax / torch.tensor(127.0, dtype=tdtype)).float()
        if amax.float() / scale > 127:
            return float(amax)
    raise AssertionError("no amax in [1, 4] whose scale rounds down")


def _rows(n, h, d, tdtype, seed):
    """(N, 3 H D) qkv projection rows in ``tdtype``: seeded normals of
    varied magnitude, an all-zero row, a row of exact ties (amax 127, so
    the scale is 1) and, for 16-bit rows, a row from -amax to amax whose
    scale rounds down, so that its ends exceed +-127 before the clip."""
    rs = np.random.RandomState(seed)
    x = (rs.randn(n, 3 * h * d) * rs.rand(n, 1) * 4).astype(np.float32)
    u = h * d
    x[0, u:3 * u] = 0.0                               # K and V all zero
    ties = np.zeros(d, np.float32)
    ties[:6] = [127.0, 0.5, 1.5, -2.5, -126.5, 63.5]
    x[1, u:u + d] = ties                              # K, head 0
    if tdtype != torch.float32:
        amax = _top_amax(tdtype)
        x[2, 2 * u:2 * u + d] = np.linspace(-amax, amax, d)   # V, head 0
    return torch.from_numpy(x).to(tdtype)


def _pool(p, ps, h, d, seed):
    """A non-zero int8 pool and scales: bytes the write must leave alone."""
    rs = np.random.RandomState(seed)
    kp = torch.from_numpy(rs.randint(-127, 128, (p, ps, h, d)).astype(
        np.int8))
    vp = torch.from_numpy(rs.randint(-127, 128, (p, ps, h, d)).astype(
        np.int8))
    ks = torch.from_numpy((rs.rand(p, ps, h) + 0.5).astype(np.float32))
    vs = torch.from_numpy((rs.rand(p, ps, h) + 0.5).astype(np.float32))
    return kp, vp, ks, vs


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_write_plain_matches_mxnet_tpu_bitwise(dtype):
    tdtype, jdtype = DTYPES[dtype]
    n, h, d, p, ps = 9, 3, 32, 6, 4
    rows = _rows(n, h, d, tdtype, seed=3)
    q, k, v = tzoo._split_qkv(rows, h)                # (N, H, D) views
    assert not k.is_contiguous() and k.stride() == (3 * h * d, d, 1)
    # rows 7 and 8 are inactive: both write scratch page 0
    page_idx = torch.tensor([1, 1, 2, 3, 5, 5, 4, 0, 0], dtype=torch.int64)
    slot_idx = torch.tensor([0, 3, 1, 2, 0, 1, 3, 0, 0], dtype=torch.int64)
    kp, vp, ks, vs = _pool(p, ps, h, d, seed=4)
    jpool = [jnp.asarray(t.numpy()) for t in (kp, vp, ks, vs)]
    tpool = [t.clone() for t in (kp, vp, ks, vs)]
    tda.kv_quantize_write(*tpool, k, v, page_idx, slot_idx)

    jk, jv = (jnp.asarray(t.float().numpy()).astype(jdtype) for t in (k, v))
    jpi, jsi = jnp.asarray(page_idx.numpy()), jnp.asarray(slot_idx.numpy())
    jkp, jks = jzoo._page_scatter(jpool[0], jpool[2], jk, jpi, jsi, True)
    jvp, jvs = jzoo._page_scatter(jpool[1], jpool[3], jv, jpi, jsi, True)
    for got, want in zip(tpool, (jkp, jvp, jks, jvs)):
        want = np.asarray(want)
        assert got.numpy().dtype == want.dtype
        np.testing.assert_array_equal(got[1:].numpy(), want[1:])
    # the special rows landed where they should
    assert tpool[2][1, 0].tolist() == [1.0] * h       # zero K: scale 1
    assert not tpool[0][1, 0].any()
    assert tpool[0][1, 3, 0, :6].tolist() == [127, 0, 2, -2, -126, 64]
    if tdtype != torch.float32:
        assert tpool[1][2, 1, 0, 0] == -127 and tpool[1][2, 1, 0, -1] == 127
    # every byte outside the written (page, slot)s is untouched
    written = torch.zeros((p, ps), dtype=torch.bool)
    written[page_idx, slot_idx] = True
    for got, before in zip(tpool, (kp, vp, ks, vs)):
        assert torch.equal(got[~written], before[~written])


def test_write_plain_is_kv_quantize_then_index_put():
    rows = _rows(5, 2, 16, torch.bfloat16, seed=8)
    _, k, v = tzoo._split_qkv(rows, 2)
    page_idx = torch.tensor([1, 2, 3, 1, 2])
    slot_idx = torch.tensor([0, 0, 1, 1, 1])
    pool = _pool(4, 2, 2, 16, seed=9)
    got = [t.clone() for t in pool]
    want = [t.clone() for t in pool]
    tda.kv_quantize_write(*got, k, v, page_idx, slot_idx)
    for pages, scales, x in ((want[0], want[2], k), (want[1], want[3], v)):
        qv, sc = tda.kv_quantize(x)
        pages[page_idx, slot_idx] = qv
        scales[page_idx, slot_idx] = sc
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert tda.kv_quantize_write.launches == 0        # CPU: no kernel


def test_paged_step_writes_through_kv_quantize_write(monkeypatch):
    """The model's int8 page write is one kv_quantize_write call a layer
    (one launch on the card), with the qkv views as they are."""
    calls = []
    real = tda.kv_quantize_write

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(tda, "kv_quantize_write", spy)
    h, d, p, ps = 2, 8, 5, 4
    kv = (torch.zeros((3, p, ps, h, d), dtype=torch.int8),
          torch.zeros((3, p, ps, h, d), dtype=torch.int8),
          torch.ones((3, p, ps, h)), torch.ones((3, p, ps, h)))
    rows = _rows(4, h, d, torch.float32, seed=1)
    _, k, v = tzoo._split_qkv(rows, h)
    page_idx, slot_idx = torch.tensor([1, 2, 3, 0]), torch.tensor([0, 1, 2, 0])
    tzoo._page_scatter(kv, 1, k, v, page_idx, slot_idx)
    assert len(calls) == 1
    args = calls[0]
    assert args[0].data_ptr() == kv[0][1].data_ptr()
    assert args[4] is k and args[5] is v
    assert not kv[0][0].any() and not kv[0][2].any()  # other layers intact
    assert kv[0][1, 1:].any() and kv[1][1, 1:].any()


def test_write_checks_operands():
    rows = _rows(3, 2, 16, torch.float32, seed=2)
    _, k, v = tzoo._split_qkv(rows, 2)
    kp, vp, ks, vs = _pool(4, 2, 2, 16, seed=2)
    idx = torch.tensor([1, 2, 3])
    with pytest.raises(ValueError, match="must be int64"):
        tda.kv_quantize_write(kp, vp, ks, vs, k, v, idx.int(), idx % 2)
    with pytest.raises(ValueError, match="pages must both be int8"):
        tda.kv_quantize_write(kp.float(), vp, ks, vs, k, v, idx, idx % 2)
    with pytest.raises(ValueError, match="k_scales must be float32"):
        tda.kv_quantize_write(kp, vp, ks.double(), vs, k, v, idx, idx % 2)
    with pytest.raises(ValueError, match="k and v must both be"):
        tda.kv_quantize_write(kp, vp, ks, vs, k.double(), v, idx, idx % 2)


# name, pool dtype, D, heads, page size, base addresses, whether the
# kernel's geometry query takes the shape, route
ROUTES = [
    ("gpt2_small", torch.int8, 64, 12, 16, [0, 256, 512, 768], True,
     "int8_bulk"),
    ("d16", torch.int8, 16, 4, 4, [0] * 4, True, "int8_bulk"),
    ("d32_three_heads", torch.int8, 32, 3, 4, [0] * 4, True, "int8_bulk"),
    ("d48_padded_lanes", torch.int8, 48, 2, 2, [0] * 4, True, "int8_bulk"),
    ("d128", torch.int8, 128, 12, 16, [0] * 4, True, "int8_bulk"),
    ("float32_pool", torch.float32, 64, 12, 16, [0] * 4, True, "float32"),
    ("d65", torch.int8, 65, 3, 16, [0] * 4, False, "int8"),
    ("d8", torch.int8, 8, 4, 4, [0] * 4, False, "int8"),
    ("d256", torch.int8, 256, 4, 16, [0] * 4, False, "int8"),
    ("scales_not_16_bytes", torch.int8, 64, 3, 1, [0] * 4, False, "int8"),
    ("k_pages_misaligned", torch.int8, 64, 12, 16, [8, 0, 0, 0], True,
     "int8"),
    ("v_scales_misaligned", torch.int8, 64, 12, 16, [0, 0, 0, 4], True,
     "int8"),
    ("heads_beyond_warps", torch.int8, 64, 26, 16, [0] * 4, False, "int8"),
    ("ring_beyond_smem", torch.int8, 128, 8, 64, [0] * 4, False, "int8"),
]
ROUTE_IDS = [r[0] for r in ROUTES]


@pytest.mark.parametrize("name,dtype,d,heads,ps,ptrs,takes,want", ROUTES,
                         ids=ROUTE_IDS)
def test_decode_route(name, dtype, d, heads, ps, ptrs, takes, want):
    """The rule, given the kernel's answer on the shape (its geometry
    query needs the built kernel; test_decode_route_on_card asks it)."""
    def geometry(*shape):
        assert shape == (heads, d, ps)
        return {"head_warps": 1} if takes else None
    assert tda._decode_route(dtype, d, heads, ps, ptrs, geometry) == want


def test_decode_route_asks_the_kernel_only_for_aligned_int8_pools():
    asked = []

    def geometry(*shape):
        asked.append(shape)
        return {}
    assert tda._decode_route(torch.float32, 64, 12, 16, [0] * 4,
                             geometry) == "float32"
    assert tda._decode_route(torch.int8, 64, 12, 16, [0, 0, 4, 0],
                             geometry) == "int8"
    assert asked == []
    assert tda._decode_route(torch.int8, 64, 12, 16, [0] * 4,
                             geometry) == "int8_bulk"
    assert asked == [(12, 64, 16)]


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card and nvcc: the geometry comes from "
                    "the built kernel")


@pytest.mark.cuda
@pytest.mark.parametrize("name,dtype,d,heads,ps,ptrs,takes,want", ROUTES,
                         ids=ROUTE_IDS)
def test_decode_route_on_card(name, dtype, d, heads, ps, ptrs, takes, want):
    _needs_card()
    assert (tda._int8_geometry(heads, d, ps) is not None) == takes
    assert tda._decode_route(dtype, d, heads, ps, ptrs) == want


@pytest.mark.cuda
def test_int8_ring_sizes():
    # GPT-2 small: 6 head warps (2 heads a warp at D=64) x 2 token warps;
    # stages of 24,576 bytes of pages and 1,536 of scales, and the token
    # warps' merge buffer: two CTAs fit an SM's 227 KB with 3 stages too
    _needs_card()
    g = tda._int8_geometry(12, 64, 16)
    assert (g["head_warps"], g["token_warps"], g["stages"]) == (6, 2, 3)
    assert g["smem_bytes"] == 128 + 3 * 26112 + 2 * 12 * 66 * 4
    assert 2 * g["smem_bytes"] <= 227 * 1024
    for shape, warps in (((12, 128, 16), (12, 1)), ((2, 64, 16), (1, 4)),
                         ((3, 32, 4), (1, 1))):
        g = tda._int8_geometry(*shape)
        assert (g["head_warps"], g["token_warps"]) == warps


def test_int8_split_rule_fills_the_card_once_from_shapes_only():
    # one CTA an SM at most: 4 splits at the slice's shape (128 CTAs on
    # 132 SMs), where the other routes take 16 splits of 4 pages
    assert tda.int8_splits(32, 64, 132) == 4
    assert tda.decode_splits(32, 64, 132) == (16, 4)
    assert tda.int8_splits(1, 64, 132) == 64      # one split a table entry
    assert tda.int8_splits(1, 1, 132) == 1
    assert tda.int8_splits(300, 64, 132) == 1
    for b, pages in ((2, 12), (33, 64), (7, 300)):
        splits = tda.int8_splits(b, pages, 132)
        assert 1 <= splits <= pages and b * splits <= 132


def test_launch_counts_by_route_name_all_three():
    assert set(tda.paged_decode_attention.launches_by_route) == {
        "float32", "int8", "int8_bulk"}


def _int8_case(seed, b, h, d, ps, mp, lengths, junk, device):
    g = torch.Generator().manual_seed(seed)
    pages = sum(-(-n // ps) for n in lengths) + 1
    kf = torch.randn((pages, ps, h, d), generator=g)
    vf = torch.randn((pages, ps, h, d), generator=g)
    (kp, ks), (vp, vs) = tda.kv_quantize(kf), tda.kv_quantize(vf)
    table = torch.zeros((b, mp), dtype=torch.int32)
    if junk:
        table.random_(1, pages, generator=g)
    perm = torch.randperm(pages - 1, generator=g) + 1
    used = 0
    for i, n in enumerate(lengths):
        k = -(-n // ps)
        table[i, :k] = perm[used:used + k]
        used += k
    q = torch.randn((b, h, d), generator=g)
    lens = torch.tensor(lengths, dtype=torch.int32)
    return [t.to(device) for t in (q, kp, vp, table, lens, ks, vs)]


@pytest.mark.cuda
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("h,d,ps,lengths,junk", [
    (12, 64, 16, [0, 1, 15, 16, 17, 96, 37, 70], True),
    (3, 32, 4, [1, 20, 0, 7], False),
    (4, 128, 8, [32, 9, 0], True)], ids=["gpt2", "d32", "d128"])
def test_int8_bulk_kernel_matches_plain_on_card(qdtype, h, d, ps, lengths,
                                                junk):
    """On the card: route "int8_bulk" against the plain version (fp32 q
    within 1e-5 of max|ref|, 16-bit q within one output ulp), rows of
    length 0 exactly 0, a second launch bitwise equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, kp, vp, table, lens, ks, vs = _int8_case(
        31, len(lengths), h, d, ps, 96 // ps, lengths, junk, "cuda")
    q = q.to(DTYPES[qdtype][0])
    before = dict(tda.paged_decode_attention.launches_by_route)
    got = tda.paged_decode_attention(q, kp, vp, table, lens, k_scales=ks,
                                     v_scales=vs)
    again = tda.paged_decode_attention(q, kp, vp, table, lens, k_scales=ks,
                                       v_scales=vs)
    want = tda.paged_decode_attention_reference(q, kp, vp, table, lens,
                                                k_scales=ks, v_scales=vs)
    torch.cuda.synchronize()
    after = tda.paged_decode_attention.launches_by_route
    assert after["int8_bulk"] - before["int8_bulk"] == 2
    assert torch.equal(got, again)
    assert not got[lens == 0].any()
    if qdtype == "float32":
        assert (got - want).abs().max() <= 1e-5 * want.abs().max()
    else:
        ulp = (want.float().abs() * 2.0 ** (-7 if qdtype == "bfloat16"
                                            else -10)).clamp_min(1e-30)
        assert ((got.float() - want.float()).abs() <= ulp).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_write_kernel_bitwise_on_card(dtype):
    """On the card: one launch writes K and V of a layer bitwise equal to
    the plain version, through the qkv views' strides, and leaves every
    other byte of the pool as it was."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    tdtype = DTYPES[dtype][0]
    n, h, d, p, ps = 32, 12, 64, 40, 16
    rows = _rows(n, h, d, tdtype, seed=6).cuda()
    _, k, v = tzoo._split_qkv(rows, h)
    page_idx = torch.randperm(p - 1)[:n].cuda() + 1
    slot_idx = torch.randint(0, ps, (n,)).cuda()
    pool = [t.cuda() for t in _pool(p, ps, h, d, seed=7)]
    got = [t.clone() for t in pool]
    want = [t.clone() for t in pool]
    before = tda.kv_quantize_write.launches
    tda.kv_quantize_write(*got, k, v, page_idx, slot_idx)
    tda.kv_quantize_write_reference(*want, k, v, page_idx, slot_idx)
    torch.cuda.synchronize()
    assert tda.kv_quantize_write.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)

