"""``mx.nd``'s NDArray on both packages: ``tests/test_ndarray.py``'s cases
run on ``mxnet_tpu`` and on the port (on the CPU), then what the port
adds: memory sharing as MXNet has it, autograd over NDArrays, ``out=``,
the default context, and the Reshape codes and view semantics where the
port follows MXNet rather than ``mxnet_tpu``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import mxnet_tpu as mx  # noqa: E402
import mxnet_tpu_torch as mt  # noqa: E402

LIBS = [pytest.param(mx, id="mxnet_tpu"), pytest.param(mt, id="port")]


# ---------------------------------------- tests/test_ndarray.py, both sides
@pytest.mark.parametrize("lib", LIBS)
def test_creation(lib):
    with lib.cpu():
        nd = lib.nd
        a = nd.zeros((2, 3))
        assert a.shape == (2, 3)
        assert a.dtype == np.float32
        assert (a.asnumpy() == 0).all()
        b = nd.ones((4,), dtype="float64")
        assert b.dtype in (np.float32, np.float64)
        assert (b.asnumpy() == 1).all()
        assert (nd.full((2, 2), 7).asnumpy() == 7).all()
        assert nd.array([[1, 2], [3, 4]]).shape == (2, 2)
        np.testing.assert_allclose(nd.arange(0, 10, 2).asnumpy(),
                                   [0, 2, 4, 6, 8])


@pytest.mark.parametrize("lib", LIBS)
def test_arithmetic(lib):
    with lib.cpu():
        nd = lib.nd
        a = nd.array([[1.0, 2.0], [3.0, 4.0]])
        b = nd.array([[10.0, 20.0], [30.0, 40.0]])
        np.testing.assert_allclose((a + b).asnumpy(), [[11, 22], [33, 44]])
        np.testing.assert_allclose((b - a).asnumpy(), [[9, 18], [27, 36]])
        np.testing.assert_allclose((a * b).asnumpy(), [[10, 40], [90, 160]])
        np.testing.assert_allclose((b / a).asnumpy(), [[10, 10], [10, 10]])
        np.testing.assert_allclose((a + 1).asnumpy(), [[2, 3], [4, 5]])
        np.testing.assert_allclose((1 - a).asnumpy(), [[0, -1], [-2, -3]])
        np.testing.assert_allclose((2 ** a).asnumpy(), [[2, 4], [8, 16]])
        np.testing.assert_allclose((-a).asnumpy(), [[-1, -2], [-3, -4]])
        np.testing.assert_allclose(abs(nd.array([-1.0, 2.0])).asnumpy(),
                                   [1, 2])


@pytest.mark.parametrize("lib", LIBS)
def test_inplace_and_views(lib):
    with lib.cpu():
        a = lib.nd.zeros((4, 4))
        a += 2
        assert (a.asnumpy() == 2).all()
        a[1:3] = 5
        assert (a.asnumpy()[1:3] == 5).all()
        assert (a.asnumpy()[0] == 2).all()
        v = a[0]
        v[:] = 9
        assert (a.asnumpy()[0] == 9).all()
        a[:] = 0
        assert (a.asnumpy() == 0).all()


@pytest.mark.parametrize("lib", LIBS)
def test_comparison_and_reduce(lib):
    with lib.cpu():
        a = lib.nd.array([[1.0, 5.0], [3.0, 2.0]])
        assert (a > 2).asnumpy().tolist() == [[0, 1], [1, 0]]
        assert float(a.sum()) == 11.0
        assert float(a.max()) == 5.0
        assert a.sum(axis=0).shape == (2,)
        assert a.mean(axis=1, keepdims=True).shape == (2, 1)
        assert int(a.argmax(axis=1)[0]) == 1


@pytest.mark.parametrize("lib", LIBS)
def test_reshape_transpose_concat(lib):
    with lib.cpu():
        nd = lib.nd
        a = nd.arange(0, 12).reshape((3, 4))
        assert a.T.shape == (4, 3)
        assert a.reshape((2, 6)).shape == (2, 6)
        assert a.reshape((0, 2, 2)).shape == (3, 2, 2)
        b = nd.concat(a, a, dim=0)
        assert b.shape == (6, 4)
        assert nd.stack(a, a, axis=0).shape == (2, 3, 4)
        assert nd.split(b, 2, axis=0)[0].shape == (3, 4)
        assert nd.expand_dims(a, 0).shape == (1, 3, 4)


@pytest.mark.parametrize("lib", LIBS)
def test_dot(lib):
    rng = np.random.RandomState(0)
    with lib.cpu():
        nd = lib.nd
        a = nd.array(rng.rand(3, 4).astype(np.float32))
        b = nd.array(rng.rand(4, 5).astype(np.float32))
        np.testing.assert_allclose(nd.dot(a, b).asnumpy(),
                                   a.asnumpy() @ b.asnumpy(), rtol=1e-5)
        np.testing.assert_allclose(
            nd.dot(a, nd.array(b.asnumpy().T), transpose_b=True).asnumpy(),
            a.asnumpy() @ b.asnumpy(), rtol=1e-5)


@pytest.mark.parametrize("lib", LIBS)
def test_astype_copy_context(lib):
    with lib.cpu():
        a = lib.nd.ones((2, 2))
        assert a.astype("float16").dtype == np.float16
        c = a.copy()
        c += 1
        assert (a.asnumpy() == 1).all()
        assert a.as_in_context(lib.cpu()).context.device_type == "cpu"


@pytest.mark.parametrize("lib", LIBS)
def test_indexing_advanced(lib):
    with lib.cpu():
        nd = lib.nd
        a = nd.arange(0, 12).reshape((3, 4))
        assert nd.take(a, nd.array([0, 2], dtype="int32"),
                       axis=0).shape == (2, 4)
        oh = nd.one_hot(nd.array([0, 2], dtype="int32"), 4)
        np.testing.assert_allclose(oh.asnumpy(),
                                   [[1, 0, 0, 0], [0, 0, 1, 0]])


@pytest.mark.parametrize("lib", LIBS)
def test_save_load(lib, tmp_path):
    fname = str(tmp_path / "params")
    with lib.cpu():
        nd = lib.nd
        nd.save(fname, {"w": nd.ones((2, 2)), "b": nd.zeros((3,))})
        loaded = nd.load(fname)
        assert set(loaded) == {"w", "b"}
        assert (loaded["w"].asnumpy() == 1).all()
        nd.save(fname, [nd.ones((2,)), nd.zeros((3,))])
        back = nd.load(fname)
        assert len(back) == 2 and back[0].shape == (2,)


@pytest.mark.parametrize("lib", LIBS)
def test_scalar_and_len(lib):
    with lib.cpu():
        a = lib.nd.array([3.5])
        assert a.asscalar() == pytest.approx(3.5)
        assert float(a) == pytest.approx(3.5)
        assert len(lib.nd.zeros((5, 2))) == 5


@pytest.mark.parametrize("lib", LIBS)
def test_wait_sync(lib):
    with lib.cpu():
        b = (lib.nd.ones((8, 8)) * 2).wait_to_read()
        assert (b.asnumpy() == 2).all()
        lib.nd.waitall()


@pytest.mark.parametrize("lib", LIBS)
def test_topk_sort(lib):
    with lib.cpu():
        nd = lib.nd
        a = nd.array([[3.0, 1.0, 2.0]])
        assert nd.topk(a, k=2).asnumpy().tolist() == [[0, 2]]
        assert nd.topk(a, k=2, ret_typ="both")[0].asnumpy().tolist() == \
            [[3, 2]]
        assert nd.sort(a).asnumpy().tolist() == [[1, 2, 3]]
        assert nd.argsort(a).asnumpy().tolist() == [[1, 2, 0]]


@pytest.mark.parametrize("lib", LIBS)
def test_where_clip_misc(lib):
    with lib.cpu():
        nd = lib.nd
        a = nd.array([-2.0, 0.5, 3.0])
        np.testing.assert_allclose(nd.clip(a, 0, 1).asnumpy(), [0, 0.5, 1])
        np.testing.assert_allclose(
            nd.where(nd.array([1.0, 0.0, 1.0]), a, nd.zeros((3,))).asnumpy(),
            [-2, 0, 3])


# ------------------------------------------------------------ port-only

def test_views_share_memory_as_mxnet():
    """A view sees in-place writes to its parent (``x += 1`` included), a
    write through a view reaches the parent, and an op's result shares
    nothing with its inputs. ``mxnet_tpu`` swaps buffers instead: there a
    view taken before ``x += 1`` keeps the old values (ROADMAP "Reference
    defects")."""
    with mt.cpu():
        x = mt.nd.zeros((4, 3))
        v = x[1:3]
        x += 1
        assert (v.asnumpy() == 1).all()
        v[:] = 7
        assert (x.asnumpy()[1:3] == 7).all() and (x.asnumpy()[0] == 1).all()
        t = mt.nd.transpose(x)
        r = x.reshape((3, 4))
        t[:] = -1
        r[:] = -2
        assert (x.asnumpy()[1:3] == 7).all()
        # a copy from advanced indexing
        c = x[mt.nd.array([0, 1], dtype="int64")]
        c[:] = 100
        assert (x.asnumpy() != 100).all()
    with mx.cpu():
        jx = mx.nd.zeros((4, 3))
        jv = jx[1:3]
        jx += 1
        assert (jv.asnumpy() == 0).all()     # the reference's swap


def test_reshape_codes_follow_mxnet():
    """0 copies, -1 infers (and consumes a dim), -2 copies the rest, -3
    merges two, -4 splits one (matrix_op-inl.h). ``mxnet_tpu`` agrees on
    (0, -3) and (4, -1) only (ROADMAP "Reference defects")."""
    with mt.cpu():
        x = mt.nd.zeros((2, 3, 4))
        for codes, shape in (((-1, 0), (8, 3)), ((0, -2), (2, 3, 4)),
                             ((-4, 1, 2, 0, 0), (1, 2, 3, 4)),
                             ((-4, -1, 2, -2), (1, 2, 3, 4)),
                             ((2, -3), (2, 12)), ((0, -1), (2, 12)),
                             ((-3, -1), (6, 4))):
            assert x.reshape(codes).shape == shape, codes
        assert x.reshape((-1, 6), reverse=True).shape == (4, 6)
    with mx.cpu():
        assert mx.nd.zeros((2, 3, 4)).reshape((-1, 0)).shape == (12, 2)


def test_autograd_over_ndarrays():
    with mt.cpu():
        x = mt.nd.array([1.0, 2.0, 3.0])
        w = mt.nd.array([0.5, -1.0, 2.0])
        x.attach_grad()
        w.attach_grad(grad_req="add")
        for _ in range(2):
            with mt.autograd.record():
                y = (x * x * w).sum()
            y.backward()
        np.testing.assert_allclose(x.grad.asnumpy(), 2 * np.array(
            [1.0, 2.0, 3.0]) * [0.5, -1.0, 2.0])   # 'write': the last one
        np.testing.assert_allclose(w.grad.asnumpy(), 2 * np.array(
            [1.0, 4.0, 9.0]))                        # 'add': both
        with mt.autograd.record():
            z = mt.nd.exp(x) * 2
        gx, = mt.autograd.grad(z, [x], head_grads=mt.nd.ones((3,)))
        assert isinstance(gx, mt.nd.NDArray)
        np.testing.assert_allclose(gx.asnumpy(), 2 * np.exp([1.0, 2.0, 3.0]),
                                   rtol=1e-6)
        # outside record() nothing is recorded, and in-place writes to a
        # leaf that takes a gradient stay off the tape
        y = x * 2
        assert y._data.grad_fn is None
        x += 1
        x[0] = 5.0
        assert x._data.is_leaf and x._data.requires_grad
        d = x.detach()
        assert not d._data.requires_grad


def test_out_and_wrappers():
    with mt.cpu():
        a = mt.nd.array([[1.0, 2.0], [3.0, 4.0]])
        out = mt.nd.zeros((2, 2))
        res = mt.nd.elemwise_add(a, a, out=out)
        assert res is out and (out.asnumpy() == 2 * a.asnumpy()).all()
        # positional params after the arrays fill the op's params in order
        np.testing.assert_allclose(mt.nd.clip(a, 1.5, 3.5).asnumpy(),
                                   [[1.5, 2], [3, 3.5]])
        np.testing.assert_allclose(mt.nd.sum_axis(a, axis=0).asnumpy(),
                                   [4, 6])
        bn_mean = mt.nd.zeros((2,))
        with mt.autograd.train_mode():
            mt.nd.BatchNorm(a, mt.nd.ones((2,)), mt.nd.zeros((2,)), bn_mean,
                            mt.nd.ones((2,)), momentum=0.5)
        np.testing.assert_allclose(bn_mean.asnumpy(), [1.0, 1.5])
        assert repr(a).endswith("<NDArray 2x2 @cpu(0)>")
        assert a.dtype == np.float32 and a.size == 4 and a.ndim == 2
        np.testing.assert_array_equal(np.asarray(a), a.asnumpy())
        b16 = a.astype("bfloat16")
        assert b16.asnumpy().dtype == np.float32


def test_default_context_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default context works")
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.nd.zeros((2,))
    with pytest.raises(mt.MXNetError, match="CUDA"):
        mt.nd.array([1.0])
    assert mt.nd.zeros((2,), ctx=mt.cpu()).context == mt.cpu()


def test_gluon_block_takes_and_returns_ndarrays():
    net = mt.gluon.nn.Dense(3, in_units=4)
    net.initialize(ctx=mt.cpu())
    x = torch.randn(2, 4)
    with mt.cpu():
        y = net(mt.nd.array(x))
    assert isinstance(y, mt.nd.NDArray)
    np.testing.assert_allclose(y.asnumpy(), net(x).numpy(), rtol=1e-6)
