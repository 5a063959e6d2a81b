"""Serving runtime of the PyTorch port (Predictor + BatchServer), CPU side.

Buckets pad and unpad as in mxnet_tpu; a request served inside a coalesced
batch equals, bitwise, predict of its row on the same bucket; and the
served logits agree with mxnet_tpu's TransformerLM within 1e-4.
"""
import threading
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import serving  # noqa: E402
from mxnet_tpu_torch.gluon.model_zoo import transformer as tzoo  # noqa: E402

CFG = dict(vocab=48, units=32, num_heads=2, num_layers=2, max_len=32)
T = 16


@pytest.fixture(autouse=True)
def _fresh_stats():
    serving.reset_stats()
    yield
    serving.reset_stats()


def _net(seed=0):
    net = tzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    net.initialize(mt.init.Xavier(), ctx=mt.cpu(),
                   generator=torch.Generator().manual_seed(seed))
    return net


def _ids(n, seed):
    return np.random.RandomState(seed).randint(0, CFG["vocab"], (n, T))


def _predictor(net, buckets, warmup=False):
    return serving.Predictor.from_block(
        net, input_shapes={"data": (T,)}, batch_sizes=buckets, ctx=mt.cpu(),
        warmup=warmup)


def test_predictor_pads_to_bucket_and_slices_back():
    net = _net()
    pred = _predictor(net, (1, 4, 8))
    assert [pred.bucket_for(n) for n in (1, 2, 4, 5, 8, 9)] == \
        [1, 4, 4, 8, 8, 9]
    ids = _ids(3, seed=1)
    (out,) = pred.predict(ids)
    assert out.shape == (3, T, CFG["vocab"])
    # the padded batch is what ran: same bucket, same rows -> bitwise
    padded = np.concatenate([ids, np.zeros((1, T), ids.dtype)])
    (full,) = pred.predict(padded)
    assert torch.equal(out, full[:3])
    with torch.inference_mode():
        direct = net(torch.from_numpy(ids))
    torch.testing.assert_close(out, direct, rtol=1e-5, atol=1e-5)
    st = serving.stats()
    assert st["serving_predict_calls"] == 2
    assert st["serving_padded_samples"] == 1
    assert st["serving_batch_samples"] == 8
    assert st["serving_bucket_misses"] == 1 and st["serving_bucket_hits"] == 1


def test_predictor_warmup_and_unbucketed_batch():
    pred = _predictor(_net(), (1, 2), warmup=True)
    assert serving.stats()["serving_bucket_misses"] == 2
    (out,) = pred.predict(_ids(3, seed=2))
    assert out.shape[0] == 3
    st = serving.stats()
    assert st["serving_unbucketed"] == 1 and st["serving_padded_samples"] == 0


def test_predictor_rejects_bad_blocks_and_batches():
    with pytest.raises(mt.MXNetError, match="not initialized"):
        serving.Predictor.from_block(
            tzoo.transformer_lm(prefix="raw_", **CFG), ctx=mt.cpu())
    pred = _predictor(_net(), (4,))
    with pytest.raises(mt.MXNetError, match="empty batch"):
        pred.predict(np.zeros((0, T), np.int64))
    with pytest.raises(mt.MXNetError, match="unknown input"):
        pred.predict({"tokens": _ids(1, seed=0)})


def test_batch_server_threads_get_their_rows_bitwise():
    """4 client threads; every result equals predict of its row on the
    same bucket (batch_sizes pinned to one bucket), bitwise."""
    pred = _predictor(_net(seed=3), (4,))
    per_thread = 5
    reqs = [[_ids(1, seed=100 * i + j) for j in range(per_thread)]
            for i in range(4)]
    results = [[None] * per_thread for _ in range(4)]
    with serving.BatchServer(pred, max_batch_size=4,
                             batch_timeout_ms=20) as server:
        def client(i):
            futs = [server.submit(r) for r in reqs[i]]
            for j, f in enumerate(futs):
                results[i][j] = f.result(timeout=60)

        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(4)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(60)
        assert not any(th.is_alive() for th in threads)
    st = serving.stats()
    assert st["serving_requests"] == 20
    assert st["serving_batches"] < 20       # requests did coalesce
    assert st["serving_p50_latency_us"] > 0
    for i in range(4):
        for j in range(per_thread):
            (got,) = results[i][j]
            (want,) = pred.predict(reqs[i][j])
            assert got.shape == (1, T, CFG["vocab"])
            assert torch.equal(got, want)


def test_batch_server_close_without_drain_and_after_close():
    pred = _predictor(_net(), (2,))
    server = serving.BatchServer(pred, max_batch_size=2,
                                 batch_timeout_ms=60000)
    fut = server.submit(_ids(1, seed=4))
    server.close(drain=False, timeout=30)
    with pytest.raises(serving.ServerClosed):
        fut.result(timeout=30)
    with pytest.raises(serving.ServerClosed):
        server.submit(_ids(1, seed=5))
    with pytest.raises(mt.MXNetError):
        serving.BatchServer(pred, max_batch_size=2).submit(_ids(3, seed=6))


def test_served_logits_match_jax_net():
    jnet = jzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
    jnet.initialize(mx.init.Xavier())
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # JAX flash: CPU fallback warning
        jnet(mx.nd.array(np.zeros((1, 4)), dtype="int32"))
        tnet = tzoo.transformer_lm(impl="flash", prefix="tlm_", **CFG)
        tnet.initialize(ctx=mt.cpu())
        tnet.load_numpy_params({k: p.data().asnumpy()
                                for k, p in jnet.collect_params().items()})
        ids = _ids(3, seed=7)
        want = jnet(mx.nd.array(ids, dtype="int32")).asnumpy()
    pred = _predictor(tnet, (1, 2, 4))
    with serving.BatchServer(pred, batch_timeout_ms=20) as server:
        futs = [server.submit(ids[i:i + 1]) for i in range(3)]
        got = np.concatenate([f.result(timeout=60)[0].numpy() for f in futs])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
