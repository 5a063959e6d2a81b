"""Kernel K3 of the PyTorch port (fused conv3x3 + BN statistics), CPU side.

On the CPU ``mxnet_tpu_torch.ops.kernels.conv3x3_bn_stats`` runs its plain
version. It must compute what ``mxnet_tpu``'s Pallas kernel computes, run
here in interpret mode as tests/test_pallas_flash.py runs it: y within
1e-5, sum within 1e-4 and sumsq within 1e-3 (f32 sums in other orders).
The trainable wrapper's forward and every gradient, the statistics'
cotangents included, agree with ``jax.grad`` of ``mxnet_tpu``'s wrapper
within 1e-5 of each gradient's scale. The CUDA kernel itself is held to
the same plain version on the card by chip_smoke.py and by the test marked
``cuda`` here.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops import pallas_kernels as jpk  # noqa: E402
from mxnet_tpu_torch.ops import _build, kernels, nn as tops  # noqa: E402

# name, N, H, W, Cin, Cout
STATS_CASES = [("pallas_test_shape", 2, 8, 8, 16, 32),
               ("ragged", 3, 5, 7, 3, 5)]


def _inputs(n, h, w, cin, cout, seed):
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, w, cin).astype(np.float32)
    wt = (rng.randn(3, 3, cin, cout) * 0.1).astype(np.float32)
    return x, wt


@pytest.mark.parametrize("name,n,h,w,cin,cout", STATS_CASES,
                         ids=[c[0] for c in STATS_CASES])
def test_plain_matches_pallas_interpret(name, n, h, w, cin, cout):
    x, wt = _inputs(n, h, w, cin, cout, seed=len(name))
    y_j, s_j, q_j = jpk.conv3x3_bn_stats(jnp.asarray(x), jnp.asarray(wt),
                                         interpret=True)
    y, s, q = kernels.conv3x3_bn_stats(torch.from_numpy(x),
                                       torch.from_numpy(wt))
    assert y.shape == (n, h, w, cout) and y.dtype == torch.float32
    assert s.dtype == q.dtype == torch.float32 and s.shape == (cout,)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), rtol=0, atol=1e-5)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), rtol=0, atol=1e-4)
    np.testing.assert_allclose(q.numpy(), np.asarray(q_j), rtol=0, atol=1e-3)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() / (np.abs(b).max() + 1e-12)


def test_train_wrapper_forward_and_all_grads_match_jax():
    """Loss sum(out cos out) + a.mean + b.var: every gradient, the dmean and
    dvar cotangent terms included (pallas_kernels.py:525-526)."""
    rng = np.random.RandomState(0)
    c = 8
    x = rng.randn(2, 8, 8, c).astype(np.float32)
    w = (rng.randn(3, 3, c, c) * 0.2).astype(np.float32)
    gamma = (rng.rand(c) + 0.5).astype(np.float32)
    beta = rng.randn(c).astype(np.float32)
    a = rng.randn(c).astype(np.float32)
    b = rng.randn(c).astype(np.float32)

    def jloss(x, w, gamma, beta):
        out, mean, var = jpk.conv3x3_bn_relu_train(x, w, gamma, beta,
                                                   interpret=True)
        return (jnp.sum(out * jnp.cos(out)) + jnp.sum(mean * a)
                + jnp.sum(var * b))

    jargs = [jnp.asarray(t) for t in (x, w, gamma, beta)]
    j_out, j_mean, j_var = jpk.conv3x3_bn_relu_train(*jargs, interpret=True)
    j_grads = jax.grad(jloss, argnums=(0, 1, 2, 3))(*jargs)

    targs = [torch.from_numpy(t).requires_grad_(True)
             for t in (x, w, gamma, beta)]
    out, mean, var = kernels.conv3x3_bn_relu_train(*targs)
    loss = ((out * torch.cos(out)).sum() + (mean * torch.from_numpy(a)).sum()
            + (var * torch.from_numpy(b)).sum())
    loss.backward()
    for got, want in ((out, j_out), (mean, j_mean), (var, j_var)):
        assert _rel(got.detach().numpy(), want) < 1e-5
    for t, want, name in zip(targs, j_grads, ("dx", "dw", "dgamma",
                                              "dbeta")):
        assert t.grad.shape == t.shape
        assert _rel(t.grad.numpy(), want) < 1e-5, name


def test_statistics_come_from_the_f32_accumulator():
    """In bf16, K3's sums are of the f32 accumulator; the unfused path
    (conv, then BN statistics of the rounded y) agrees only within 1e-2."""
    x, w = _inputs(2, 6, 6, 8, 16, seed=3)
    xb, wb = torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16()
    y, s, q = kernels.conv3x3_bn_stats(xb, wb)
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    acc = torch.nn.functional.conv2d(xb.float().permute(0, 3, 1, 2),
                                     wb.float().permute(3, 2, 0, 1),
                                     padding=1)
    torch.testing.assert_close(s, acc.sum(dim=(0, 2, 3)), rtol=0,
                               atol=1e-4)
    torch.testing.assert_close(y, acc.permute(0, 2, 3, 1).bfloat16(),
                               rtol=0, atol=0)
    # the unfused path's single-pass statistics read the rounded bf16 y
    cnt = y.shape[0] * y.shape[1] * y.shape[2]
    c = y.shape[-1]
    ones, zeros = torch.ones(c), torch.zeros(c)
    _, mean_u, _ = tops.batch_norm(y, ones, zeros, zeros, ones, axis=3,
                                   momentum=0.0, _train=True)
    assert _rel(mean_u.numpy(), (s / cnt).numpy()) < 1e-2
    assert not torch.equal(mean_u, s / cnt)


def test_cpu_call_counts_no_launch_and_builds_nothing():
    before = kernels.conv3x3_bn_stats.launches
    x, w = _inputs(1, 4, 4, 2, 3, seed=4)
    kernels.conv3x3_bn_stats(torch.from_numpy(x), torch.from_numpy(w))
    out, _, _ = kernels.conv3x3_bn_relu_train(
        torch.from_numpy(x), torch.from_numpy(w), torch.ones(3),
        torch.zeros(3))
    assert out.shape == (1, 4, 4, 3)
    assert kernels.conv3x3_bn_stats.launches == before
    assert "conv3x3_bn_stats" not in _build._libs
    assert "conv3x3_bn_stats" in _build.SOURCES


@pytest.mark.parametrize("bad", ["kernel_5x5", "channels", "dtype",
                                 "float64", "rank", "device"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    x = torch.zeros(1, 4, 4, 2)
    w = torch.zeros(3, 3, 2, 3)
    if bad == "kernel_5x5":
        w = torch.zeros(5, 5, 2, 3)
    elif bad == "channels":
        w = torch.zeros(3, 3, 4, 3)
    elif bad == "dtype":
        w = w.bfloat16()
    elif bad == "float64":
        x, w = x.double(), w.double()
    elif bad == "rank":
        x = torch.zeros(4, 4, 2)
    else:
        w = torch.zeros(3, 3, 2, 3, device="meta")
    with pytest.raises(ValueError):
        kernels.conv3x3_bn_stats(x, w)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc: the CUDA kernel has no "
                    "CPU mode (chip_smoke.py runs it on the card)")
    x, w = (torch.from_numpy(t).cuda() for t in _inputs(3, 7, 9, 5, 13, 5))
    before = kernels.conv3x3_bn_stats.launches
    y, s, q = kernels.conv3x3_bn_stats(x, w)
    assert kernels.conv3x3_bn_stats.launches == before + 1
    yr, sr, qr = kernels.conv3x3_bn_stats_reference(x, w)
    for got, want in ((y, yr), (s, sr), (q, qr)):
        assert _rel(got.cpu().numpy(), want.cpu().numpy()) < 1e-4
    with pytest.raises(ValueError, match="contiguous"):
        kernels.conv3x3_bn_stats(x.transpose(1, 2), w)
