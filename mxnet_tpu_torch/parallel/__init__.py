"""Training over a mesh of ranks (port of ``mxnet_tpu/parallel``).

One process per rank (``torch.distributed``), each with the same
:class:`Mesh` and its own coordinate in it. ``ShardedTrainer`` runs
``mxnet_tpu``'s fused training step (forward, backward, gradient mean over
the batch axes, optimizer update; fp32 masters with an optional 16-bit
compute dtype) over dp, dp x fsdp (``SpecLayout`` rules), tp (tensor
parallelism, :mod:`tensor_parallel`) and sp (ring attention), with
``remat``. The collectives GSPMD places in ``mxnet_tpu`` are written out
in :mod:`collectives`. 'pp', 'ep' and tp x sp are ROADMAP Queue 1 item 6,
pods and elastic recovery item 12.
"""
from .mesh import (Mesh, create_mesh, default_mesh, named_mesh,
                   parse_mesh_spec, local_devices, shrink_mesh,
                   MeshShrinkError, AXES, PodTopology, pod_mesh,
                   shrink_mesh_hosts)
from .layout import SpecLayout, PartitionSpec
from .functional import functional_call, param_arrays, aux_arrays
from .optim import make_update_fn
from .trainer import ShardedTrainer
from . import (mesh, layout, collectives, functional, optim, trainer,  # noqa
               tensor_parallel, ring_attention as ring)
# as in mxnet_tpu: ``parallel.ring`` is the module, ``parallel.ring_attention``
# and ``parallel.attention`` its functions
from .ring_attention import ring_attention, ring_attention_inner, attention

__all__ = ["ShardedTrainer", "create_mesh", "default_mesh", "named_mesh",
           "parse_mesh_spec", "local_devices", "shrink_mesh",
           "MeshShrinkError", "AXES", "PodTopology", "pod_mesh",
           "shrink_mesh_hosts", "Mesh", "SpecLayout", "PartitionSpec",
           "functional_call", "param_arrays", "aux_arrays", "make_update_fn",
           "ring_attention", "ring_attention_inner", "attention", "ring",
           "collectives", "tensor_parallel"]
