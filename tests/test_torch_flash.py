"""Kernel K1 of the PyTorch port (flash-attention forward), CPU side.

On the CPU ``mxnet_tpu_torch.ops.kernels.flash_attention`` runs its plain
version. It must compute what ``mxnet_tpu``'s Pallas kernel computes, run
here in interpret mode as tests/test_pallas_flash.py runs it: O and the
row log-sum-exp within 1e-5 absolute (f32 sums taken in another order).
The CUDA kernel itself is held to the same plain version on the card by
chip_smoke.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from mxnet_tpu.ops.pallas_kernels import flash_attention as jax_flash  # noqa: E402
from mxnet_tpu_torch.ops import kernels, nn as tnn  # noqa: E402

TOL = 1e-5


def _qkv(shape, seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*shape).astype(np.float32) * 0.3 for _ in range(3)]


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# name, shape, causal, q_offset, k_offset, JAX block overrides
CASES = [
    ("causal", (2, 2, 256, 64), True, 0, 0, {}),
    ("non_causal", (2, 2, 256, 64), False, 0, 0, {}),
    ("causal_d128_t512", (1, 1, 512, 128), True, 0, 0, {}),
    ("q_offset_128", (1, 2, 256, 64), True, 128, 0, {}),
    # every K block of Q block 0 is skipped: rows 0..127 see no key
    ("whole_skip", (1, 2, 256, 64), True, 0, 128,
     {"block_q": 128, "block_k": 128}),
    ("ragged_t200_d32", (1, 1, 200, 32), True, 0, 0, {}),
]


@pytest.mark.parametrize("name,shape,causal,qo,ko,blocks", CASES,
                         ids=[c[0] for c in CASES])
def test_plain_matches_pallas_interpret(name, shape, causal, qo, ko, blocks):
    q, k, v = _qkv(shape, seed=len(name))
    o_j, lse_j = jax_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, interpret=True, return_lse=True,
                           q_offset=qo, k_offset=ko, **blocks)
    o_t, lse_t = kernels.flash_attention(*_torch(q, k, v), causal=causal,
                                         return_lse=True, q_offset=qo,
                                         k_offset=ko)
    assert o_t.dtype == torch.float32 and lse_t.dtype == torch.float32
    assert tuple(lse_t.shape) == shape[:3] + (1,)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(lse_t.numpy(), np.asarray(lse_j), rtol=0,
                               atol=TOL)


def test_rows_without_a_visible_key():
    """O = 0 and lse = -1e30 + log(1e-20) (in f32), the port's definition."""
    q, k, v = _qkv((1, 2, 256, 64), seed=5)
    o, lse = kernels.flash_attention(*_torch(q, k, v), causal=True,
                                     return_lse=True, k_offset=128)
    want = np.float32(-1e30) + np.float32(np.log(np.float32(1e-20)))
    assert (o[:, :, :128] == 0).all()
    assert (lse[:, :, :128].numpy() == want).all()
    assert torch.isfinite(o[:, :, 128:]).all()


@pytest.mark.parametrize("causal", [False, True])
def test_plain_matches_dense_sdpa(causal):
    q, k, v = _torch(*_qkv((2, 3, 100, 16), seed=9))
    flash = tnn.scaled_dot_product_attention(q, k, v, causal=causal,
                                             impl="flash")
    dense = tnn.scaled_dot_product_attention(q, k, v, causal=causal)
    torch.testing.assert_close(flash, dense, rtol=0, atol=TOL)


def test_scale_and_16bit_dtypes():
    q, k, v = _torch(*_qkv((1, 2, 64, 32), seed=2))
    for dtype in (torch.bfloat16, torch.float16):
        out, lse = kernels.flash_attention(
            q.to(dtype), k.to(dtype), v.to(dtype), causal=True, scale=0.5,
            return_lse=True)
        assert out.dtype == dtype and lse.dtype == torch.float32
        ref = kernels.flash_attention_reference(
            q.to(dtype).float(), k.to(dtype).float(), v.to(dtype).float(),
            causal=True, scale=0.5)
        torch.testing.assert_close(out.float(), ref, rtol=0, atol=1e-2)


@pytest.mark.parametrize("bad", ["d_too_large", "kv_shape", "dtype",
                                 "rank", "offset"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q = torch.zeros(1, 1, 8, 16)
    k = v = q
    kw = {}
    if bad == "d_too_large":
        q = k = v = torch.zeros(1, 1, 8, 257)
    elif bad == "kv_shape":
        k = torch.zeros(1, 1, 9, 16)
    elif bad == "dtype":
        q = k = v = torch.zeros(1, 1, 8, 16, dtype=torch.float64)
    elif bad == "rank":
        q = k = v = torch.zeros(8, 16)
    else:
        kw["q_offset"] = 2 ** 31
    with pytest.raises(ValueError):
        kernels.flash_attention(q, k, v, **kw)


def test_flash_rejects_explicit_mask():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError):
        tnn.scaled_dot_product_attention(q, q, q, mask=torch.ones(8, 8),
                                         impl="flash")
