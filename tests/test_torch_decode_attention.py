"""K4's plain version (the port's paged decode attention) against mxnet_tpu's.

The same seeded numpy inputs go through ``mxnet_tpu.ops.decode_attention``
and the port's ``paged_decode_attention`` on the CPU (where the wrapper
takes its plain version): fp32 and bf16 q, fp32 and int8 pages, several
``block_pages``, shuffled page tables and ragged lengths >= 1, held to
1e-5 of max|ref| (the two sum in other orders). ``kv_quantize`` is bitwise
for fp32 and bf16 inputs. Rows of length 0 give zeros in the port (a
deliberate difference: the reference returns the mean of the V pages the
row's table names), so they are tested alone. The block-width rule matches
the reference's with an empty schedule table.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from mxnet_tpu.ops import decode_attention as jda  # noqa: E402
from mxnet_tpu.tune import schedule as jschedule  # noqa: E402

from mxnet_tpu_torch.ops import decode_attention as tda  # noqa: E402

TOL = 1e-5


def _case(seed, b=4, h=2, d=16, page_size=4, max_pages=8, pool=40,
          int8=False, lengths=None):
    """Seeded inputs: q, pages (fp32 or int8 + scales), a shuffled page
    table (each row its own pages, unused entries on scratch page 0),
    lengths."""
    rs = np.random.RandomState(seed)
    q = rs.randn(b, h, d).astype(np.float32)
    if int8:
        kp = rs.randint(-127, 128, (pool, page_size, h, d)).astype(np.int8)
        vp = rs.randint(-127, 128, (pool, page_size, h, d)).astype(np.int8)
        ks = (rs.rand(pool, page_size, h) * 0.02 + 0.001).astype(np.float32)
        vs = (rs.rand(pool, page_size, h) * 0.02 + 0.001).astype(np.float32)
    else:
        kp = rs.randn(pool, page_size, h, d).astype(np.float32)
        vp = rs.randn(pool, page_size, h, d).astype(np.float32)
        ks = vs = None
    if lengths is None:
        full = max_pages * page_size
        lengths = [1, max(1, page_size - 1), page_size, page_size + 1,
                   full, rs.randint(1, full + 1)][:b]
    lengths = np.asarray(lengths, np.int32)
    perm = rs.permutation(np.arange(1, pool))
    table = np.zeros((b, max_pages), np.int32)
    used = 0
    for i, n in enumerate(lengths):
        k = -(-int(n) // page_size)
        table[i, :k] = perm[used:used + k]
        used += k
    return q, kp, vp, ks, vs, table, lengths


def _jax(q, kp, vp, ks, vs, table, lengths, dtype=np.float32, **kw):
    out = jda.paged_decode_attention(
        jnp.asarray(q).astype(dtype), jnp.asarray(kp), jnp.asarray(vp),
        jnp.asarray(table), jnp.asarray(lengths),
        k_scales=None if ks is None else jnp.asarray(ks),
        v_scales=None if vs is None else jnp.asarray(vs), **kw)
    return np.asarray(out.astype(jnp.float32))


def _torch(q, kp, vp, ks, vs, table, lengths, dtype=torch.float32, **kw):
    t = torch.from_numpy
    out = tda.paged_decode_attention(
        t(q).to(dtype), t(kp), t(vp), t(table), t(lengths),
        k_scales=None if ks is None else t(ks),
        v_scales=None if vs is None else t(vs), **kw)
    assert out.dtype == dtype and out.shape == q.shape
    return out.float().numpy()


@pytest.mark.parametrize("block_pages", [None, 1, 2, 4, 8, 3])
@pytest.mark.parametrize("int8", [False, True], ids=["fp32kv", "int8kv"])
@pytest.mark.parametrize("qdtype", ["float32", "bfloat16"])
def test_plain_matches_mxnet_tpu(qdtype, int8, block_pages):
    args = _case(seed=3 + block_pages if block_pages else 3, b=6,
                 int8=int8)
    jdt = jnp.bfloat16 if qdtype == "bfloat16" else np.float32
    tdt = getattr(torch, qdtype)
    want = _jax(*args, dtype=jdt, block_pages=block_pages)
    before = tda.paged_decode_attention.launches
    got = _torch(*args, dtype=tdt, block_pages=block_pages)
    assert tda.paged_decode_attention.launches == before   # CPU: no kernel
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= TOL, err


@pytest.mark.parametrize("d,page_size,max_pages", [(64, 16, 6), (65, 3, 5),
                                                   (8, 1, 7)])
def test_plain_matches_mxnet_tpu_other_shapes(d, page_size, max_pages):
    args = _case(seed=d, b=5, h=3, d=d, page_size=page_size,
                 max_pages=max_pages, pool=5 * max_pages + 1)
    want = _jax(*args)
    got = _torch(*args)
    assert np.abs(got - want).max() <= TOL * np.abs(want).max()


def test_zero_length_rows_give_zeros():
    q, kp, vp, ks, vs, table, _ = _case(seed=11, b=4)
    lengths = np.asarray([0, 5, 0, 32], np.int32)
    table[0, :] = 0
    table[2, :3] = [7, 8, 9]       # a table that names pages, length 0
    got = _torch(q, kp, vp, ks, vs, table, lengths)
    assert not got[0].any() and not got[2].any()
    want = _jax(q, kp, vp, ks, vs, table, lengths)
    live = [1, 3]
    np.testing.assert_allclose(got[live], want[live], rtol=0,
                               atol=TOL * np.abs(want[live]).max())
    # the reference's row of length 0 is the mean of its pages' V
    assert np.abs(want[0]).max() > 0


def test_int8_zero_length_and_bf16_q_give_zeros():
    q, kp, vp, ks, vs, table, _ = _case(seed=12, b=2, int8=True)
    got = _torch(q, kp, vp, ks, vs, table, np.asarray([0, 0], np.int32),
                 dtype=torch.bfloat16)
    assert not got.any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kv_quantize_bitwise(dtype):
    rs = np.random.RandomState(5)
    x = (rs.randn(7, 5, 3, 16) * rs.rand(7, 5, 3, 1) * 4).astype(np.float32)
    x[0, 0, 0] = 0.0                # an all-zero row: scale 1
    x[1, 1, 1, :4] = [0.5, -0.5, 1.5, 2.5]   # rounding ties, amax 2.5
    x[1, 1, 1, 4:] = 0.0
    jdt = jnp.bfloat16 if dtype == "bfloat16" else np.float32
    jq, js = jda.kv_quantize(jnp.asarray(x).astype(jdt))
    tq, ts = tda.kv_quantize(torch.from_numpy(x).to(getattr(torch, dtype)))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0].item() == 1.0
    back = tda.kv_dequantize(tq, ts)
    np.testing.assert_array_equal(
        back.numpy(), np.asarray(jda.kv_dequantize(jq, js)))


def test_kv_quantize_rounds_half_to_even_and_clips():
    x = torch.tensor([[127.0, 0.5, 1.5, -2.5, -127.0, 63.5]])
    q, s = tda.kv_quantize(x)
    assert s.item() == 1.0
    assert q.tolist() == [[127, 0, 2, -2, -127, 64]]


@pytest.mark.parametrize("pages", [1, 6, 7, 8, 12, 16, 64])
@pytest.mark.parametrize("block_pages", [None, 1, 3, 8, 32])
def test_block_pages_rule_matches_mxnet_tpu(pages, block_pages):
    # None: the port's fixed default against the reference's default
    # schedule (its measured table may hold other entries)
    default = jschedule.DEFAULT_SCHEDULES["decode_attn"]["block_pages"]
    want = jschedule.decode_attn_block_pages(
        4, pages, "float32", interpret=True,
        block_pages=default if block_pages is None else block_pages)
    assert tda.decode_attn_block_pages(pages, block_pages) == want


def test_split_rule_covers_the_table_from_shapes_only():
    for b, pages, sms in ((32, 64, 132), (2, 12, 132), (1, 1, 132),
                          (300, 64, 132), (32, 7, 8)):
        splits, per = tda.decode_splits(b, pages, sms)
        # every split holds table entries, and together they cover it
        assert splits * per >= pages > (splits - 1) * per
        want = min(pages, -(-4 * sms // b))
        assert per == -(-pages // want)
    assert tda.decode_splits(32, 64, 132) == (16, 4)


def test_wrapper_checks_operands():
    q, kp, vp, ks, vs, table, lengths = (torch.from_numpy(a) if a is not None
                                         else None for a in _case(seed=2))
    with pytest.raises(ValueError, match="page_table must be int32"):
        tda.paged_decode_attention(q, kp, vp, table.long(), lengths)
    with pytest.raises(ValueError, match="float32 or int8"):
        tda.paged_decode_attention(q, kp.half(), vp.half(), table, lengths)
    with pytest.raises(ValueError, match="scales go with an int8"):
        tda.paged_decode_attention(q, kp, vp, table, lengths,
                                   k_scales=torch.ones(kp.shape[:3]))
    with pytest.raises(ValueError, match="an int8 pool needs"):
        tda.paged_decode_attention(q, kp.to(torch.int8), vp.to(torch.int8),
                                   table, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True], ids=["fp32kv", "int8kv"])
def test_kernel_matches_plain_on_card(int8):
    """On the card: K4 against its plain version on the same inputs
    (within 1e-5 of max|ref| for fp32 q), rows of length 0 exactly 0, a
    second launch bitwise equal, one launch counted per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    q, kp, vp, ks, vs, table, lengths = _case(seed=21, b=6, int8=int8)
    lengths[2] = 0
    args = [torch.from_numpy(a).cuda() if a is not None else None
            for a in (q, kp, vp, table, lengths, ks, vs)]
    before = tda.paged_decode_attention.launches
    got = tda.paged_decode_attention(*args[:5], k_scales=args[5],
                                     v_scales=args[6])
    again = tda.paged_decode_attention(*args[:5], k_scales=args[5],
                                       v_scales=args[6])
    want = tda.paged_decode_attention_reference(*args[:5], k_scales=args[5],
                                                v_scales=args[6])
    torch.cuda.synchronize()
    assert tda.paged_decode_attention.launches == before + 2
    assert torch.equal(got, again)
    assert not got[2].any()
    assert (got - want).abs().max() <= TOL * want.abs().max()
