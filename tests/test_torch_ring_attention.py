"""The port's ring attention (``mxnet_tpu_torch.parallel.ring_attention``)
against ``mxnet_tpu.parallel.ring_attention`` on the CPU.

The port runs 4 rank processes over gloo (``tests/_torch_ranks.py``), each
holding its quarter of the sequence, K/V going round the ring by
send/receive; ``mxnet_tpu`` runs its ring on a 4-device CPU mesh in this
process, over the global arrays. Both get the same seeded numpy q, k, v and
output cotangent. Held in fp32: the output within 1e-5 of max|ref|, the
lse within 1e-5 of max|lse|, and dq, dk, dv (the gradients of
sum(out * dout)) within 1e-4 of max|ref|, causal and full, for the plain
ring ('dense') and the flash ring, whose hops on the CPU are K1's and
K2's plain versions (``mxnet_tpu`` runs its Pallas kernel in interpret
mode). Under causal masking the blocks of later ranks hold keys that the
earlier ranks' queries never see: those hops merge with weight 0.

Then ``TransformerLM(impl='ring')`` over {"sp": 4}: the loss and every
parameter's gradient through ``ShardedTrainer``'s forward and backward,
against ``mxnet_tpu``'s ``ShardedTrainer`` on a {"dp": 1, "sp": 4} mesh
(one SGD step at learning rate 1: the gradient is the weights' change),
with and without ``remat``.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import mxnet_tpu as mx  # noqa: E402
from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.gluon.model_zoo import transformer as jzoo  # noqa: E402

import _torch_ranks as ranks  # noqa: E402
from _torch_isolation import no_stale_preemption  # noqa: E402,F401

SP = 4
SHAPE = (2, 4, 64, 16)          # (B, H, T global, D): 16 rows a rank
OUT_TOL, GRAD_TOL = 1e-5, 1e-4
CASES = [(impl, causal) for impl in ("dense", "flash")
         for causal in (True, False)]

# the LM: 2 layers, 64 units, 4 heads, T = 32 (8 tokens a rank)
LM_DIMS = (2, 64, 4, 32, 32)    # layers, units, heads, vocab, max_len
LM_B, LM_T = 2, 32
REMATS = (None, True)


def _mesh(axes):
    n = int(np.prod(list(axes.values())))
    return jpar.create_mesh(axes, jax.devices()[:n])


def _rel(got, want):
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


@pytest.fixture(scope="module")
def ring_inputs():
    rng = np.random.RandomState(11)
    return [(rng.randn(*SHAPE) * 0.5).astype(np.float32) for _ in range(4)]


@pytest.fixture(scope="module")
def port_ring(ring_inputs, tmp_path_factory):
    """{(impl, causal): [rank results]} of the port's ring over 4 ranks,
    every case in one run of the ranks."""
    got = ranks.run_ranks(ranks.ring_rank, SP, (*ring_inputs, CASES),
                          tmp_path_factory.mktemp("ring"))
    return {case: [r[case] for r in got] for case in CASES}


def _jax_ring(inputs, causal, impl):
    q, k, v, dout = (jnp.asarray(a) for a in inputs)
    mesh = _mesh({"sp": SP})

    def f(q, k, v):
        return jpar.ring.ring_attention(q, k, v, mesh=mesh, causal=causal,
                                        impl=impl, interpret=True)

    out, vjp = jax.vjp(f, q, k, v)
    return np.asarray(out), [np.asarray(g) for g in vjp(dout)]


def _global_lse(q, k, causal):
    s = np.einsum("bhqd,bhkd->bhqk", q.astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(q.shape[-1])
    if causal:
        t = q.shape[2]
        s = np.where(np.tril(np.ones((t, t), bool)), s, -np.inf)
    m = s.max(-1, keepdims=True)
    return m + np.log(np.exp(s - m).sum(-1, keepdims=True))


@pytest.mark.parametrize("impl,causal", CASES)
def test_ring_matches_jax_ring(port_ring, ring_inputs, impl, causal):
    res = port_ring[(impl, causal)]
    out = np.concatenate([r["out"] for r in res], axis=2)
    grads = [np.concatenate([r["grads"][i] for r in res], axis=2)
             for i in range(3)]
    want, want_grads = _jax_ring(ring_inputs, causal, impl)
    assert _rel(out, want) <= OUT_TOL, _rel(out, want)
    for name, g, w in zip("qkv", grads, want_grads):
        assert _rel(g, w) <= GRAD_TOL, (name, _rel(g, w))
    lse = np.concatenate([r["lse"] for r in res], axis=2)
    assert _rel(lse, _global_lse(*ring_inputs[:2], causal)) <= OUT_TOL


@pytest.mark.parametrize("impl", ["dense", "flash"])
def test_every_rank_runs_a_hop_of_each_block(port_ring, impl):
    """Each rank makes 4 hops and, for the flash ring, one K1 and one K2
    call a hop, here all on the plain versions (CPU tensors: no launch);
    the causal hops that see no key are run too."""
    for causal in (True, False):
        for r in port_ring[(impl, causal)]:
            st = r["stats"]
            assert st["hops"] == SP
            assert st["k2"] == {"tc": 0, "tf32x3": 0, "simt": 0,
                                "plain": SP}
            want_k1 = SP if impl == "flash" else 0
            assert st["k1"] == {"tc": 0, "tf32x3": 0, "simt": 0,
                                "plain": want_k1}


def test_masked_hops_add_nothing(port_ring, ring_inputs):
    """Rank 0's queries see only its own block under causal masking: its
    output, lse and dq equal single-block attention over its own 16 rows,
    though three of its four hops held other ranks' keys."""
    q, k, v, dout = (a[:, :, :16] for a in ring_inputs)
    res = port_ring[("flash", True)][0]
    qt, kt, vt = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    s = (qt @ kt.transpose(-1, -2)) / np.sqrt(q.shape[-1])
    s = s.masked_fill(~torch.ones(16, 16, dtype=torch.bool).tril(),
                      float("-inf"))
    ref = torch.softmax(s, -1) @ vt
    (ref * torch.tensor(dout)).sum().backward()
    assert _rel(res["out"], ref.detach().numpy()) <= OUT_TOL
    assert _rel(res["grads"][0], qt.grad.numpy()) <= GRAD_TOL


# ------------------------------------------------------------ the LM
def _lm_values(seed=5):
    layers, units, heads, vocab, max_len = LM_DIMS
    mx.random.seed(seed)
    jnet = jzoo.transformer_lm(vocab=vocab, units=units, num_heads=heads,
                               num_layers=layers, max_len=max_len,
                               impl="ring", mesh=_mesh({"dp": 1, "sp": SP}),
                               prefix="tlm_")
    jnet.initialize(mx.initializer.Xavier())
    jnet(mx.nd.zeros((1, max_len)))
    rng = np.random.RandomState(seed)
    values = {}
    for name, p in jnet.collect_params().items():
        v = (rng.randn(*p.shape) * 0.1).astype(np.float32)
        if name.endswith("gamma"):
            v += 1.0
        values[name] = v
        p.set_data(mx.nd.array(v))
    return jnet, values


def _lm_batch(seed=6):
    rng = np.random.RandomState(seed)
    vocab = LM_DIMS[3]
    x = rng.randint(0, vocab, (LM_B, LM_T)).astype(np.int64)
    y = rng.randint(0, vocab, (LM_B, LM_T)).astype(np.float32)
    return x, y


@pytest.fixture(scope="module")
def port_lm(jax_lm_step, tmp_path_factory):
    """{remat: [rank results]} of the port's ring LM over 4 ranks, without
    and with remat in one run of the ranks."""
    values, x, y, _, _ = jax_lm_step
    got = ranks.run_ranks(ranks.lm_ring_rank, SP,
                          (values, x, y, LM_DIMS, REMATS),
                          tmp_path_factory.mktemp("ring_lm"))
    return {remat: [r[remat] for r in got] for remat in REMATS}


@pytest.fixture(scope="module")
def jax_lm_step():
    """mxnet_tpu's ring LM: the loss and the gradient (one SGD step at
    learning rate 1 from the seeded weights)."""
    jnet, values = _lm_values()
    x, y = _lm_batch()
    mesh = _mesh({"dp": 1, "sp": SP})
    tr = jpar.ShardedTrainer(jnet, mx.gluon.loss.SoftmaxCrossEntropyLoss(),
                             "sgd", {"learning_rate": 1.0}, mesh=mesh)
    loss = float(tr.step(x.astype(np.int32), y))
    grads = {k: values[k] - np.asarray(v) for k, v in tr.params.items()}
    return values, x, y, loss, grads


@pytest.mark.parametrize("remat", REMATS)
def test_ring_lm_loss_and_grads_match_jax(jax_lm_step, port_lm, remat):
    _, _, _, loss, grads = jax_lm_step
    res = port_lm[remat]
    for r in res:
        assert abs(r["loss"] - loss) <= OUT_TOL * abs(loss), (r["loss"], loss)
        assert set(r["grads"]) == set(grads)
        for k, want in grads.items():
            assert _rel(r["grads"][k], want) <= GRAD_TOL, (k, _rel(
                r["grads"][k], want))
        layers = LM_DIMS[0]
        # 'ring' picks the plain ring on the CPU ('auto' hops); remat runs
        # each block's forward, ring included, again in the backward
        assert r["stats"]["hops"] == SP * layers * (2 if remat else 1)
        assert r["stats"]["k2"]["plain"] == SP * layers
    # every rank holds the same mean gradients
    for r in res[1:]:
        for k in grads:
            np.testing.assert_array_equal(r["grads"][k], res[0]["grads"][k])
