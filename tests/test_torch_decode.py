"""Generative decode in the port (paged KV cache, DecodePredictor,
DecodeBatcher) against mxnet_tpu's, on the CPU.

Weights are carried from a mxnet_tpu TransformerLM into the port's with
``Block.load_numpy_params``, at ``tests/test_decode.py``'s sizes (vocab 40,
24 units, 2 heads, 1 layer, max_len 48, pages of 4 tokens, 16 pages, 2
slots) and a 2-layer case. Greedy decode through the paged path matches
mxnet_tpu's ``DecodePredictor`` token for token, with fp32 and int8 KV, and
the port's own full forward; the page pool accounts exactly; the set of
executables is frozen after warm-up; ``swap_params`` writes into the
existing storage; and the DecodeBatcher keeps parity under concurrency,
cancellation and preemption.
"""
import threading
import time
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import serving as jserving  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import capture, serving  # noqa: E402
from mxnet_tpu_torch.base import MXNetError  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402
from mxnet_tpu_torch.serving.batcher import DecodeBatcher  # noqa: E402

VOCAB, MAX_LEN = 40, 48
GEOM = dict(page_size=4, num_pages=16, max_seqs=2)
PROMPTS = ([3, 17, 5, 29, 11], list(range(2, 26, 2)))   # buckets 8 and 16


def _pair(num_layers=1, seed=7):
    """(mxnet_tpu net, port net) with the same weights."""
    mx.random.seed(seed)
    jnet = jzoo.transformer_lm(vocab=VOCAB, units=24, num_heads=2,
                               num_layers=num_layers, max_len=MAX_LEN,
                               prefix="tlm_")
    jnet.initialize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        jnet(mx.nd.array(np.zeros((1, 8), np.int32), dtype="int32"))
    values = {n: p.data().asnumpy().copy()
              for n, p in jnet.collect_params().items()}
    tnet = tzoo.transformer_lm(vocab=VOCAB, units=24, num_heads=2,
                               num_layers=num_layers, max_len=MAX_LEN,
                               prefix="tlm_")
    tnet.initialize(ctx=mt.cpu())
    tnet.load_numpy_params(values)
    return jnet, tnet


@pytest.fixture(scope="module")
def nets():
    return _pair()


@pytest.fixture(scope="module")
def pred(nets):
    return serving.DecodePredictor(nets[1], ctx=mt.cpu(),
                                   prefill_buckets=(8, 16), **GEOM)


@pytest.fixture(scope="module")
def jpreds(nets):
    """mxnet_tpu's DecodePredictors over the same weights, by KV dtype."""
    return {kv: jserving.DecodePredictor(
        nets[0], prefill_buckets=(8, 16), kv_dtype=kv, **GEOM)
        for kv in ("float32", "int8")}


def _full_decode(net, prompt, n):
    """Greedy tokens from the port's full forward (no cache)."""
    seq, out = list(prompt), []
    for _ in range(n):
        logits = net(torch.tensor([seq]))
        out.append(int(logits[0, -1].argmax()))
        seq.append(out[-1])
    return out


@pytest.fixture(autouse=True)
def _clean_stats():
    serving.reset_stats()
    yield


# --------------------------------------------------------------- parity
@pytest.mark.parametrize("prompt", PROMPTS, ids=["bucket8", "bucket16"])
@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_greedy_matches_mxnet_tpu_token_for_token(nets, pred, jpreds, kv,
                                                  prompt):
    tpred = pred if kv == "float32" else serving.DecodePredictor(
        nets[1], ctx=mt.cpu(), prefill_buckets=(8, 16), kv_dtype=kv,
        **GEOM)
    assert {t.dtype for t in tpred._kv[:2]} == {getattr(torch, kv)}
    got = tpred.greedy_decode(prompt, 10)
    assert got == jpreds[kv].greedy_decode(prompt, 10)
    if kv == "float32":
        assert got == _full_decode(nets[1], prompt, 10)
    assert tpred.pool.in_use == 0


@pytest.mark.parametrize("kv", ["float32", "int8"])
def test_two_layer_greedy_matches_mxnet_tpu(kv):
    jnet, tnet = _pair(num_layers=2, seed=3)
    geom = dict(page_size=4, num_pages=12, max_seqs=2, prefill_buckets=(8,),
                kv_dtype=kv)
    prompt = [9, 1, 33, 4, 27, 8]
    got = serving.DecodePredictor(tnet, ctx=mt.cpu(), **geom).greedy_decode(
        prompt, 12)
    assert got == jserving.DecodePredictor(jnet, **geom).greedy_decode(
        prompt, 12)
    if kv == "float32":
        assert got == _full_decode(tnet, prompt, 12)


def test_flat_forward_and_paged_logits_match_mxnet_tpu(nets, pred):
    jnet, tnet = nets
    ids = np.random.RandomState(4).randint(0, VOCAB, (2, 11)).astype(
        np.int32)
    spec = tzoo.decode_spec(tnet)
    assert spec == jzoo.decode_spec(jnet)
    names = tzoo.decode_param_names(spec, tnet.collect_params())
    assert names == jzoo.decode_param_names(spec, jnet.collect_params())
    params = tuple(tnet.collect_params()[n] for n in names)
    with torch.no_grad():
        got = tzoo.flat_forward(params, spec, torch.from_numpy(ids))
        net_out = tnet(torch.from_numpy(ids))
    jparams = tuple(jnet.collect_params()[n].data()._data for n in names)
    want = np.asarray(jzoo.flat_forward(jparams, spec, ids))
    tol = 1e-5 * np.abs(want).max()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(got.numpy(), net_out.numpy(), rtol=0,
                               atol=tol)
    # the prefill's last-token logits are the flat forward's
    row = np.zeros((pred.max_pages,), np.int32)
    row[:3] = pred.pool.alloc(3)
    try:
        _, logits = pred.prefill(ids[0], row)
    finally:
        pred.pool.free(row[:3])
    np.testing.assert_allclose(logits.numpy(), want[0, -1], rtol=0,
                               atol=tol)


def test_eos_stops_generation(nets, pred):
    prompt = PROMPTS[0]
    ref = _full_decode(nets[1], prompt, 10)
    got = pred.greedy_decode(prompt, 10, eos_id=ref[3])
    assert got == ref[:ref.index(ref[3]) + 1]    # up to AND including eos
    assert pred.pool.in_use == 0


# --------------------------------------------------- pool + frozen graphs
def test_pool_backpressure_exact_accounting_and_double_free(nets):
    small = serving.DecodePredictor(nets[1], ctx=mt.cpu(), page_size=4,
                                    num_pages=3, max_seqs=2,
                                    prefill_buckets=(8,))
    held = small.pool.alloc(2)
    assert held is not None and small.pool.in_use == 2
    assert small.pool.alloc(1) is None
    with pytest.raises(MXNetError, match="backpressure"):
        small.greedy_decode([1, 2, 3], 12)   # needs 4 pages, 0 free
    assert serving.stats()["decode_backpressure"] == 2
    assert serving.stats()["decode_pages_inuse_peak"] == 2
    small.pool.free(held)
    assert small.pool.in_use == 0 and small.pool.free_count == 2
    with pytest.raises(MXNetError, match="double free"):
        small.pool.free(held[:1])
    with pytest.raises(MXNetError, match="never issued|double free"):
        small.pool.free([0])                 # the scratch page
    assert small.greedy_decode([1, 2, 3], 2) is not None
    assert small.pool.in_use == 0
    with pytest.raises(MXNetError, match="scratch"):
        serving.PagePool(1)


def test_signature_set_frozen_after_warmup(pred):
    keys = list(pred.compiled_keys)
    assert keys == [("full", 1, 8), ("prefill", 8), ("prefill", 16),
                    ("step",)]
    before = capture.stats()
    capture.clear_retrace_log()
    # churn through both buckets and the probe: replays only
    pred.greedy_decode([3, 1, 4, 1, 5], 8)
    pred.greedy_decode(list(range(12)), 8)
    pred.predict_raw(np.zeros((1, 8), np.int32))
    assert list(pred.compiled_keys) == keys
    after = capture.stats()
    assert after["capture_misses"] == before["capture_misses"]
    assert after["capture_hits"] > before["capture_hits"]
    assert capture.retrace_log() == []


def test_reset_cache_captures_again_with_rebound_state(nets):
    p = serving.DecodePredictor(nets[1], ctx=mt.cpu(), prefill_buckets=(8,),
                                **GEOM)
    capture.clear_retrace_log()
    p.reset_cache()
    p.greedy_decode([5, 6, 7], 3)
    reasons = {e["label"]: e["reason"] for e in capture.retrace_log()}
    assert set(reasons) == {"decode_prefill8", "decode_step"}
    assert all("rebound state" in r for r in reasons.values())


def test_predict_raw_probe_surface(nets, pred):
    ids = np.random.RandomState(6).randint(0, VOCAB, (2, 8)).astype(np.int32)
    outs, rows = pred.predict_raw({"data": ids})
    assert rows == 2 and tuple(outs[0].shape) == (2, 8, VOCAB)
    with torch.no_grad():
        want = nets[1](torch.from_numpy(ids))
    assert (outs[0] - want).abs().max() <= 1e-5 * want.abs().max()
    with pytest.raises(MXNetError, match="one token input"):
        pred.predict_raw({"a": ids, "b": ids})
    with pytest.raises(MXNetError, match=r"\(B, T\)"):
        pred.predict_raw(np.zeros((1, 2, 8), np.int32))
    assert pred.kv_hbm_bytes == 2 * (1 * 16 * 4 * 2 * 12 * 4) + 2 * 4


def test_settings_from_environment(nets, monkeypatch):
    monkeypatch.setenv("MXNET_TPU_TORCH_DECODE_PAGE_SIZE", "6")
    monkeypatch.setenv("MXNET_TPU_TORCH_DECODE_PAGES", "9")
    monkeypatch.setenv("MXNET_TPU_TORCH_DECODE_MAX_SEQS", "3")
    monkeypatch.setenv("MXNET_TPU_TORCH_DECODE_PREFILL_BUCKETS", "12,4")
    monkeypatch.setenv("MXNET_TPU_TORCH_DECODE_KV_DTYPE", "int8")
    p = serving.DecodePredictor(nets[1], ctx=mt.cpu(), warmup=False)
    assert (p.page_size, p.num_pages, p.max_seqs, p.max_pages) == \
        (6, 9, 3, 8)
    assert p.prefill_buckets == (4, 12) and p._kv[0].dtype == torch.int8
    assert p.prefill_bucket_for(5) == 12 and p.prefill_bucket_for(20) == 20
    with pytest.raises(MXNetError, match="kv_dtype"):
        serving.DecodePredictor(nets[1], ctx=mt.cpu(), kv_dtype="bfloat16")


def test_default_context_is_the_card(nets):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(MXNetError, match="CUDA is not available"):
        serving.DecodePredictor(nets[1])


def test_swap_params_keeps_storage_and_rolls_back(nets):
    tnet = _pair(seed=9)[1]
    p = serving.DecodePredictor(tnet, ctx=mt.cpu(), prefill_buckets=(8,),
                                **GEOM)
    names = list(tnet.collect_params())
    ptrs = [tnet.collect_params()[n].data_ptr() for n in names]
    prompt = [4, 8, 15, 16]
    base = p.greedy_decode(prompt, 6)
    misses = capture.stats()["capture_misses"]
    other = {n: t.detach().numpy().copy()
             for n, t in nets[1].collect_params().items()}
    with pytest.raises(MXNetError, match="not a parameter"):
        p.swap_params({"tlm_nope": np.zeros(3, np.float32)})
    bad = dict(other)
    bad["tlm_head_bias"] = np.zeros(VOCAB + 1, np.float32)
    with pytest.raises(MXNetError, match="changed architecture"):
        p.swap_params(bad)
    # nothing was written by the refused swaps
    assert p.greedy_decode(prompt, 6) == base
    prev = p.swap_params({f"arg:{n}": v for n, v in other.items()})
    assert [tnet.collect_params()[n].data_ptr() for n in names] == ptrs
    assert p.greedy_decode(prompt, 6) == _full_decode(nets[1], prompt, 6)
    p.swap_params(prev)
    assert p.greedy_decode(prompt, 6) == base
    assert capture.stats()["capture_misses"] == misses


# --------------------------------------------------- continuous batching
def test_batcher_concurrent_streams_keep_parity(nets, pred):
    rs = np.random.RandomState(3)
    prompts = [[int(t) for t in rs.randint(0, VOCAB, rs.randint(3, 12))]
               for _ in range(6)]
    results = {}
    bat = DecodeBatcher(pred, ttft_slo_ms=60000)
    try:
        def client(i):
            results[i] = bat.submit(prompts[i], 8).result(timeout=120)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(prompts))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(180)
    finally:
        bat.close()
    for i, p in enumerate(prompts):
        assert results[i] == _full_decode(nets[1], p, 8)
    assert pred.pool.in_use == 0
    st = serving.stats()
    assert st["decode_sequences"] == 6 and st["decode_evictions"] == 6
    assert st["decode_tokens"] == 48
    assert st["decode_p50_itl_us"] > 0 and st["decode_ttft_misses"] == 0


def test_cancellation_mid_stream_frees_pages(pred):
    bat = DecodeBatcher(pred, ttft_slo_ms=60000)
    try:
        s = bat.submit([5, 9, 2], 40)
        it = s.tokens(timeout=60)
        next(it)
        next(it)
        s.cancel()
        rest = list(it)
        assert s.reason == "cancelled" and len(rest) < 38
        deadline = time.time() + 10
        while pred.pool.in_use and time.time() < deadline:
            time.sleep(0.01)
        assert pred.pool.in_use == 0
    finally:
        bat.close()


def test_preemption_keeps_parity(nets):
    tiny = serving.DecodePredictor(nets[1], ctx=mt.cpu(), page_size=4,
                                   num_pages=8, max_seqs=3,
                                   prefill_buckets=(8,))
    prompts = [[2, 7, 1, 9], [4, 4, 8, 3], [1, 6, 6, 2]]
    bat = DecodeBatcher(tiny, ttft_slo_ms=60000)
    try:
        streams = [bat.submit(p, 16) for p in prompts]
        for p, s in zip(prompts, streams):
            assert s.result(timeout=120) == _full_decode(nets[1], p, 16)
    finally:
        bat.close()
    assert tiny.pool.in_use == 0
    assert serving.stats()["decode_preemptions"] >= 1


def test_ttft_slo_miss_counter(pred):
    bat = DecodeBatcher(pred, ttft_slo_ms=0.0)   # every first token late
    try:
        bat.submit([1, 2, 3], 2).result(timeout=60)
    finally:
        bat.close()
    st = serving.stats()
    assert st["decode_ttft_misses"] == 1
    assert st["decode_p99_ttft_us"] > 0 and st["decode_p99_itl_us"] > 0


def test_close_fails_pending_and_rejects_new(pred):
    bat = DecodeBatcher(pred, ttft_slo_ms=60000)
    bat.close()
    with pytest.raises(serving.ServerClosed):
        bat.submit([1, 2], 2)
    with pytest.raises(MXNetError, match="prompt length"):
        DecodeBatcher(pred).submit([], 2)
    assert pred.pool.in_use == 0
