"""Training over a device mesh (the one-device subset of
``mxnet_tpu/parallel``).

``ShardedTrainer`` runs ``mxnet_tpu``'s fused training step (forward,
backward, optimizer update; fp32 masters with an optional 16-bit compute
dtype) on a mesh of one card. Meshes over several cards, tensor-parallel
rules and ring attention are ROADMAP Queue 1 item 6.
"""
from .mesh import Mesh, create_mesh
from .functional import functional_call, param_arrays, aux_arrays
from .optim import make_update_fn
from .trainer import ShardedTrainer
from . import mesh, functional, optim, trainer  # noqa: F401

__all__ = ["ShardedTrainer", "create_mesh", "Mesh",
           "functional_call", "param_arrays", "aux_arrays", "make_update_fn"]
