"""The port's mesh arithmetic and SpecLayout against ``mxnet_tpu``'s, on
the CPU, in one process (no rank is spawned).

``parse_mesh_spec``, ``named_mesh`` and ``shrink_mesh`` are arithmetic on
axis dicts and device arrays: the port's ``shrink_mesh`` is given a
``Mesh`` whose devices are the ordinals 0..n-1 laid out as
``mxnet_tpu``'s 8 virtual CPU devices are, and must keep the same slots,
or raise ``MeshShrinkError`` with the same text. ``SpecLayout`` must give
the same rule table, batch axes and batch spec as ``mxnet_tpu``'s on
meshes of the same axis names (specs compared as tuples: the port's
``PartitionSpec`` is a tuple of the same entries).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from mxnet_tpu import parallel as jpar  # noqa: E402
from mxnet_tpu.parallel import mesh as jmesh  # noqa: E402

import mxnet_tpu_torch as mt  # noqa: E402
from mxnet_tpu_torch import parallel as tpar  # noqa: E402
from mxnet_tpu_torch.parallel import mesh as tmesh  # noqa: E402

SPECS = ["dp=2", "dp=2,fsdp=2,tp=2", " tp=4 , dp=-1", "sp=4", "dp=1,fsdp=8",
         "ep=2,pp=2,dp=2"]
BAD_SPECS = ["", "dp", "dq=2", "dp=2,dp=4", "dp=two"]


@pytest.mark.parametrize("spec", SPECS)
def test_parse_mesh_spec_matches_jax(spec):
    assert tmesh.parse_mesh_spec(spec) == jmesh.parse_mesh_spec(spec)
    assert list(tmesh.parse_mesh_spec(spec)) == list(
        jmesh.parse_mesh_spec(spec))


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_parse_mesh_spec_rejects_as_jax_does(spec):
    with pytest.raises(ValueError) as want:
        jmesh.parse_mesh_spec(spec)
    with pytest.raises(ValueError) as got:
        tmesh.parse_mesh_spec(spec)
    assert str(got.value) == str(want.value)


def test_named_mesh_keeps_axes_of_size_one(monkeypatch):
    m = tpar.named_mesh("dp=1,fsdp=1,tp=1", [mt.cpu()])
    j = jpar.named_mesh("dp=1,fsdp=1,tp=1", jax.devices()[:1])
    assert m.axis_names == tuple(j.axis_names) and m.shape == dict(j.shape)
    monkeypatch.setenv("MXNET_TPU_MESH_SHAPE", "sp=1,dp=1")
    assert tpar.named_mesh(devices=[mt.cpu()]).shape == {"sp": 1, "dp": 1}
    monkeypatch.delenv("MXNET_TPU_MESH_SHAPE")
    assert tpar.named_mesh(devices=[mt.cpu()]).shape == {"dp": 1}


def _pair(axes):
    """mxnet_tpu's mesh over the first n CPU devices and the port's Mesh
    of ordinals laid out the same way."""
    n = int(np.prod(list(axes.values())))
    j = jmesh.create_mesh(axes, jax.devices()[:n])
    arr = np.empty(list(axes.values()), dtype=object)
    arr.flat[:] = list(range(n))
    return j, tpar.Mesh(arr, list(axes))


SHRINKS = [({"dp": 8}, [1], "dp"), ({"dp": 8}, [0, 5], "dp"),
           ({"dp": 8}, [99], "dp"), ({"dp": 4, "tp": 2}, [1], "dp"),
           ({"dp": 2, "fsdp": 2, "tp": 2}, [7], ("dp", "fsdp")),
           ({"dp": 2}, [1], "dp"), ({"dp": 8}, [0, 1, 2, 3, 4], "dp")]
SHRINK_FAILS = [({"dp": 8}, [], "dp"), ({"dp": 1}, [0], "dp"),
                ({"dp": 4}, [1], "fsdp"),
                ({"dp": 2, "tp": 2}, [0, 1, 2, 3], "dp")]


@pytest.mark.parametrize("axes,dead,batch_axis", SHRINKS)
def test_shrink_mesh_matches_jax(axes, dead, batch_axis):
    j, t = _pair(axes)
    jm = jmesh.shrink_mesh(j, dead, batch_axis)
    tm = tmesh.shrink_mesh(t, dead, batch_axis)
    assert tm.axis_names == tuple(jm.axis_names)
    assert tm.devices.shape == jm.devices.shape
    assert [int(d) for d in tm.devices.flat] == [d.id for d in
                                                 jm.devices.flat]


@pytest.mark.parametrize("axes,dead,batch_axis", SHRINK_FAILS)
def test_shrink_mesh_raises_as_jax_does(axes, dead, batch_axis):
    j, t = _pair(axes)
    with pytest.raises(jmesh.MeshShrinkError) as want:
        jmesh.shrink_mesh(j, dead, batch_axis)
    with pytest.raises(tmesh.MeshShrinkError) as got:
        tmesh.shrink_mesh(t, dead, batch_axis)
    assert str(got.value) == str(want.value)
    assert got.value.axes == want.value.axes
    assert got.value.dead_ranks == want.value.dead_ranks
    assert got.value.batch_axis == want.value.batch_axis


LAYOUT_MESHES = [{"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 4}, {"dp": 2,
                                                           "fsdp": 2},
                 {"dp": 2, "tp": 2}, {"fsdp": 4}, {"sp": 4}, {"tp": 4}]


def _spec(p):
    return tuple(tuple(e) if isinstance(e, tuple) else e for e in p)


@pytest.mark.parametrize("axes", LAYOUT_MESHES)
def test_spec_layout_matches_jax(axes):
    j, t = _pair(axes)
    jl, tl = jpar.SpecLayout.for_mesh(j), tpar.SpecLayout.for_mesh(t)
    assert repr(tl) == repr(jl)
    jr, tr = jl.param_rules(), tl.param_rules()
    assert [p for p, _ in tr] == [p for p, _ in jr]
    assert [_spec(s) for _, s in tr] == [_spec(s) for _, s in jr]
    assert tl.batch_axes() == jl.batch_axes()
    assert _spec(tl.batch_spec()) == _spec(jl.batch_spec())
    assert _spec(tl.replicated()) == _spec(jl.replicated()) == ()


def test_spec_layout_named_axes_match_jax():
    jl = jpar.SpecLayout(data_axis="data", fsdp_axis=None, tp_axis="model")
    tl = tpar.SpecLayout(data_axis="data", fsdp_axis=None, tp_axis="model")
    assert [_spec(s) for _, s in tl.param_rules()] == [
        _spec(s) for _, s in jl.param_rules()]
    assert tl.batch_axes() == jl.batch_axes() == ("data",)


def test_one_rank_mesh_knows_its_coordinate():
    m = tpar.create_mesh({"dp": 1, "sp": 1}, [mt.cpu()])
    assert m.rank == 0 and m.coords == {"dp": 0, "sp": 0}
    assert m.device == torch.device("cpu")
    assert m.axis_size(("dp", "sp")) == 1 and m.group("dp") is None
    assert m.group_ranks(("dp", "sp")) == [0]
    assert tpar.local_devices("cpu") == [torch.device("cpu")]


def test_mesh_index_arithmetic_is_row_major():
    """Rank r of a {"dp": 2, "fsdp": 2, "sp": 2} mesh sits at
    np.unravel_index(r, (2, 2, 2)); its groups' ranks and its index along
    a tuple of axes follow from that, as lax.axis_index does."""
    arr = np.empty((2, 2, 2), dtype=object)
    arr.flat[:] = [torch.device("cpu")] * 8
    m = tpar.Mesh(arr, ("dp", "fsdp", "sp"), rank=5)      # (1, 0, 1)
    assert m.coords == {"dp": 1, "fsdp": 0, "sp": 1}
    assert m.axis_index("sp") == 1 and m.axis_index(("dp", "fsdp")) == 2
    assert m.group_ranks("dp") == [1, 5]
    assert m.group_ranks(("dp", "fsdp")) == [1, 3, 5, 7]
    assert m.group_ranks(("fsdp", "dp")) == [1, 3, 5, 7]
    assert m.group_ranks("sp") == [4, 5]
    assert m.axis_size(("dp", "sp")) == 4


def test_pod_topology_is_queued():
    for make in (lambda: tpar.PodTopology(2, 4), lambda: tpar.pod_mesh(),
                 lambda: tpar.shrink_mesh_hosts()):
        with pytest.raises(NotImplementedError, match="Queue 1 item 12"):
            make()
